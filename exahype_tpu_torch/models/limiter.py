"""A-posteriori subcell FV limiter for ADER-DG (PyTorch, eager).

Port of ``exahype_tpu/models/limiter.py::LimitedADERDG`` on two families
of configurations:

- the gathered-row production path that ``bench.py::bench_limited`` runs:
  ``troubled_capacity`` rows with ``troubled_granularity="row"``, the
  first-order ``"subcell"`` fallback, the ``"means"`` overflow policy and
  the post-step admissibility guard, periodic or closed by reflective,
  outflow or farfield walls;
- the whole-grid fallbacks (``troubled_capacity=None``), ``"subcell"``
  (first order, or with ``fallback_order=2`` the MUSCL reconstruction with
  Heun's two stages and the ``fallback_slope`` limiter; with the guard) and
  ``"means"``, in every wall mode, Dirichlet included: the fallback runs on
  every cell and the troubled cells take it
  (``examples/limited_blast_walls.py``'s configuration).  Over a viscous
  solver each of them adds central-difference diffusive face fluxes, so
  mixed faces stay matched and the step conserves
  (``examples/viscous_shock.py``'s configuration); JAX refuses viscous
  solvers with Dirichlet walls and on the gathered path, and so does the
  port.

Every fallback carries the solver's non-conservative product, source and
dissipation mask as JAX does (the coupled Z4+GRHD system's
``tests/test_z4_matter.py`` configuration; CK solvers alike: the fallback
reads only the physics callbacks): the jump term is masked, the NCP adds
the central half-fluctuation ½·ncp(½(a + b), b − a) of each face (the
MUSCL stages also the in-cell term B(s)·σ), and the source a forward-Euler
term after the sweeps (on the gathered rows plain PyTorch, outside the
sweep kernel).  A solver with ``rhs_all_fn`` is limited through its
``ncp_fn`` and ``source_fn``.

One step:

1. the unlimited candidate and its per-axis high-face fluxes, from the base
   solver or, with ``accelerator=CudaADERDG(solver)``, its CUDA kernels;
2. detection (:meth:`LimitedADERDG.troubled_mask`): relaxed DMP on the
   nodal extremes of the 2·dim+1 neighbourhood (clamped at walls),
   finiteness, and the ``admissible`` hook;
3. the fallback: on the gathered path the troubled cells' last-axis rows
   gathered into a batch of at most ``troubled_capacity`` rows
   (:meth:`_gather_tables_row`), one (2N+1)^dim-subcell Rusanov step on it,
   one directional sweep per axis (:meth:`_row_sweep_math`, or with
   ``subcell_cuda=True`` the CUDA kernel of ``models/subcell_cuda.py``), and
   the rows scattered back; on the whole grid the same sweeps over every
   cell (:meth:`subcell_fv_step`; second order: :meth:`_muscl_sweep`
   twice) or the first-order cell-mean update (:meth:`fv_fallback`);
4. interface matching, so mixed DG/FV faces carry one flux and the step
   conserves (wall faces have one owner and are never mixed); on the
   gathered path the cell-mean update of rows beyond the capacity; the
   guard.

Walls (the solver's ``boundary`` on its ``wall_axes``): the ghosts of the
fallbacks come from the solver's reflect hook (mirror, outflow copy,
farfield state) or, on the whole grid, from the Dirichlet rows projected to
subcells and cell means once at construction (:meth:`_ghost_sub`,
:meth:`_ghost_mean`).  The gathered path refuses Dirichlet walls, as JAX
does.

Detection, tables, gathers, projections, ghosts, scatters, matching, the
whole-grid fallbacks and the guard are plain PyTorch on either device, as
they are XLA in the JAX package.  What the translation changes:

- JAX's ``mode="drop"`` scatters send an inactive slot's write out of
  bounds.  The table and face-flux scatters here write into a buffer one
  row (or slot) longer than the target, whose last entry takes the dropped
  writes and is sliced off; the state scatter, which would pay a copy of
  the state for that, sends an inactive slot's write to an active slot's
  row with that slot's data (:meth:`_scatter_fallback_row`).  Either way
  every entry's writes carry the same bits, so the result does not depend
  on their order.
- JAX's two ``lax.cond`` (the overflow update, the guard) are branches on
  the host: each reads one flag from the device, so a step synchronises
  with the host twice.
- The TPU's ``optimization_barrier`` around the ghosts (a v5e miscompile
  workaround) has no counterpart.

Options outside these configurations raise :class:`SemanticError` naming
``ROADMAP.md``, Queue 1 item 9 and its step (9.5: ``troubled_granularity=
"cell"`` and ``overflow_fallback="candidate"`` on the gathered path); the
JAX limiter's own refusals and errors are mirrored.  ``subcell_cuda=True``
on a card solver whose (dim, order, physics) the sweep kernel lacks raises
``LoweringError`` at construction (``models/subcell_cuda.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from exahype_tpu_torch.models.aderdg import (
    ADERDGSolver,
    _apply,
    _project,
    _replace_row,
)
from exahype_tpu_torch.models.dg import subcell_projection, subcell_reconstruction
from exahype_tpu_torch.utils.device import resolve_device
from exahype_tpu_torch.utils.errors import SemanticError


def euler_admissible(dim: int, gamma: float = 1.4):
    """Admissibility hook for Euler: finite, ρ>0, p>0 (var axis explicit)."""

    def ok(Q, var_axis):
        def v(k):
            return Q.select(var_axis, k)

        rho = v(0)
        kinetic = sum(v(k) * v(k) for k in range(1, dim + 1))
        p = (gamma - 1.0) * (v(dim + 1) - 0.5 * kinetic / rho)
        fine = torch.isfinite(Q).all(dim=var_axis)
        return fine & (rho > 0.0) & (p > 0.0)

    return ok


def _leading_all(x, n: int):
    """``all`` over the first ``n`` axes."""
    return x.flatten(0, n - 1).all(dim=0)


def _unported(what: str, step: str) -> SemanticError:
    return SemanticError(
        f"{what} is not ported to exahype_tpu_torch yet; see ROADMAP.md, Queue 1 item 9 "
        f"({step})"
    )


class LimitedADERDG(nn.Module):
    """ADER-DG with the subcell FV fallback, gathered by rows or on the
    whole grid.

    ``admissible(Q, var_axis) -> bool mask`` over the node axes (reduced
    with ``all`` per cell); omit to use only the DMP criterion.  The
    keyword options carry the JAX limiter's names and defaults; those
    outside the ported configurations raise :class:`SemanticError` (see the
    module's docstring).  ``accelerator``: a :class:`CudaADERDG` over the
    same solver, for the candidate step; ``subcell_cuda``: run the gathered
    path's directional sweeps through the CUDA kernel (the JAX limiter's
    ``subcell_pallas``).

    The subcell projection ``P`` and reconstruction ``R`` (and a Dirichlet
    solver's projected ghost rows) are float64 buffers on ``device`` — the
    card unless ``device="cpu"`` — which must be the solver's; they are
    cast to the state's dtype where applied.
    """

    def __init__(
        self,
        solver: ADERDGSolver,
        admissible: Optional[Callable] = None,
        *,
        dmp_delta0: float = 1e-4,
        dmp_eps: float = 1e-3,
        fallback: str = "subcell",
        fallback_order: int = 1,
        fallback_slope: str = "minmod",
        accelerator=None,
        troubled_capacity: Optional[int] = None,
        troubled_granularity: str = "cell",
        subcell_cuda: bool = False,
        overflow_fallback: str = "means",
        post_step_guard: bool = True,
        device=None,
    ):
        super().__init__()
        gathered = troubled_capacity is not None
        # The JAX limiter's own refusals and errors, in its order.
        if solver.boundary == "dirichlet" and gathered:
            raise SemanticError(
                "the gathered (troubled_capacity) fallback does not support dirichlet "
                "walls yet — use the whole-grid subcell fallback"
            )
        if solver.boundary == "dirichlet" and solver.visc_flux_fn is not None:
            raise SemanticError(
                "limited viscous solvers with dirichlet walls are not supported (ghost "
                "gradients at prescribed-state walls are unspecified)"
            )
        if solver.visc_flux_fn is not None and gathered:
            raise SemanticError(
                "viscous solvers are not supported on the gathered (troubled_capacity) "
                "fallback paths yet; see ROADMAP.md, Queue 1 item 9"
            )
        if fallback not in ("subcell", "means"):
            raise ValueError(f"unknown fallback {fallback!r}")
        if fallback_order not in (1, 2):
            raise ValueError(f"fallback_order must be 1 or 2, got {fallback_order}")
        if fallback_slope not in ("minmod", "mc", "central"):
            raise ValueError(f"unknown fallback_slope {fallback_slope!r}")
        if accelerator is not None and accelerator.solver is not solver:
            raise ValueError("accelerator must wrap the limiter's own base solver")
        if getattr(accelerator, "mesh", None) is not None:
            raise SemanticError(
                "LimitedADERDG over a sharded accelerator (parallel/shard.py "
                "ShardedCudaADERDG) is not ported to exahype_tpu_torch yet: each of the "
                "limiter's neighbour reads needs its own exchange; see ROADMAP.md, Queue 1 "
                "item 5.b"
            )
        if troubled_granularity not in ("cell", "row"):
            raise ValueError(f"unknown troubled_granularity {troubled_granularity!r}")
        if overflow_fallback not in ("means", "candidate"):
            raise ValueError(f"unknown overflow_fallback {overflow_fallback!r}")
        if gathered and (fallback != "subcell" or fallback_order != 1):
            raise ValueError(
                "troubled_capacity requires fallback='subcell' with fallback_order=1 "
                "(the gathered ghost exchange carries one subcell layer)"
            )
        if subcell_cuda and (not gathered or troubled_granularity != "row"):
            raise ValueError(
                "subcell_cuda accelerates the gathered ROW fallback: set "
                "troubled_capacity with troubled_granularity='row'"
            )
        # What the port does not carry yet.
        if gathered and troubled_granularity != "row":
            raise _unported(f"troubled_granularity={troubled_granularity!r} on the gathered "
                            "path (only 'row' is)", "9.5")
        if gathered and overflow_fallback != "means":
            raise _unported(f"overflow_fallback={overflow_fallback!r} (only 'means' is)", "9.5")
        device = resolve_device(device)
        if device != solver.weights.device:
            raise ValueError(
                f"device {device} is not the solver's ({solver.weights.device})"
            )
        self.solver = solver
        self.admissible = admissible
        self.dmp_delta0 = float(dmp_delta0)
        self.dmp_eps = float(dmp_eps)
        self.fallback = fallback
        self.fallback_order = int(fallback_order)
        self.fallback_slope = fallback_slope
        self.accelerator = accelerator
        self.subcell_cuda = bool(subcell_cuda)
        self.post_step_guard = bool(post_step_guard)
        self.n_sub = 2 * solver.order + 1
        self.troubled_capacity = None
        if gathered:
            n_rows = int(np.prod(solver.grid_shape[:-1]))
            self.troubled_capacity = min(int(troubled_capacity), n_rows)
        if self.subcell_cuda and device.type == "cuda":
            # The sweep kernels exist for a few (dim, order, physics) only:
            # refuse the others here rather than at the first troubled step.
            from exahype_tpu_torch.models.subcell_cuda import check_physics

            check_physics(self)
        P = subcell_projection(solver.order, self.n_sub, solver.basis)
        R = subcell_reconstruction(solver.order, self.n_sub, solver.basis)
        self._P_np = P
        self.register_buffer("P", torch.as_tensor(P, dtype=torch.float64, device=device))
        self.register_buffer("R", torch.as_tensor(R, dtype=torch.float64, device=device))
        self._dirichlet_sub, self._dirichlet_mean = {}, {}
        if solver.boundary == "dirichlet":
            self._build_dirichlet_rows(device)

    # ------------------------------------------------------- boundary helpers

    def _wall_on(self, d: int) -> bool:
        """Whether grid axis ``d`` carries a domain wall (any type)."""
        return self.solver.is_wall(d)

    def _build_dirichlet_rows(self, device):
        """The Dirichlet wall ghosts in the two layouts the fallbacks read,
        computed once in float64 NumPy as JAX does: subcell means
        (``_dirichlet_sub[(d, side)]``: the transverse node axes
        P-projected, a singleton node axis at ``d``) and cell means
        (``_dirichlet_mean[(d, side)]``: the transverse node axes
        weight-projected, ``[V, grid with d -> 1]``)."""
        sol = self.solver
        nn_ = sol.n_nodes
        w = np.asarray(sol.ops.weights)
        for d in range(sol.dim):
            if not sol.is_wall(d):
                continue
            for side in (0, 1):
                face_shape = (nn_,) * (sol.dim - 1) + (sol.n_vars,) + tuple(
                    1 if e == d else g for e, g in enumerate(sol.grid_shape))
                row = np.broadcast_to(np.asarray(sol.dirichlet_fn(d, side)), face_shape)
                sub = mean = row
                for t in range(sol.dim - 1):
                    sub = np.moveaxis(np.tensordot(self._P_np, sub, axes=([1], [t])), 0, t)
                    mean = np.tensordot(w, mean, axes=([0], [0]))
                self._dirichlet_sub[(d, side)] = torch.as_tensor(
                    np.expand_dims(sub, d), dtype=torch.float64, device=device)
                self._dirichlet_mean[(d, side)] = torch.as_tensor(
                    mean, dtype=torch.float64, device=device)

    @staticmethod
    def _set_row(x, row, pos, ax):
        """``x`` with its index ``pos`` (negative from the end) along ``ax``
        replaced by the size-1 slice ``row``, out of place."""
        return _replace_row(x, row, ax, pos % x.shape[ax])

    @staticmethod
    def _row(x, pos, ax):
        return x.narrow(ax, pos % x.shape[ax], 1)

    def _ghost_sub(self, row, d, side, va):
        """Ghost SUBCELL layer at the ``(axis d, side)`` wall given the
        wall-adjacent layer ``row``: the reflect hook (reflective walls
        mirror, outflow copies, farfield broadcasts the prescribed state)
        or the precomputed Dirichlet subcell row."""
        if self.solver.boundary == "dirichlet":
            return self._dirichlet_sub[(d, side)].to(row.dtype).expand(row.shape)
        return self.solver.reflect_fn(row, d, va)

    def _ghost_mean(self, row, d, side):
        """Ghost CELL-MEAN row (``[V, grid with d -> 1]``, var axis 0) at the
        ``(axis d, side)`` wall."""
        if self.solver.boundary == "dirichlet":
            return self._dirichlet_mean[(d, side)].to(row.dtype).expand(row.shape)
        return self.solver.reflect_fn(row, d, 0)

    def _shift_clamp(self, x, sh, ax, d):
        """Neighbour values along grid axis ``ax`` (direction ``d``) for the
        DMP neighbourhood; at reflective/outflow walls the missing
        neighbour is the cell's own value (the neighbourhood shrinks), at
        farfield/Dirichlet walls the prescribed ghost mean (the window
        admits the inflow state, so held boundary data never
        false-flags)."""
        out = torch.roll(x, sh, ax)
        if self._wall_on(d):
            pos = -1 if sh == -1 else 0
            row = self._row(x, pos, ax)
            if self.solver.boundary in ("farfield", "dirichlet"):
                row = self._ghost_mean(row, d, 1 if sh == -1 else 0)
            out = self._set_row(out, row, pos, ax)
        return out

    def _shift_reflect(self, x, sh, ax, d, negate_ghost=False, grad_field=False):
        """Neighbour STATE along grid axis ``ax`` for direction ``d`` of a
        cell-means array ``x`` (var axis 0); at walls the ghost comes from
        the boundary hook (mirror, copy, farfield state, Dirichlet mean).
        ``grad_field=True`` marks gradient arrays: their ghost is zero at
        farfield and Dirichlet walls and the mirror or copy otherwise,
        negated with ``negate_ghost`` (the wall-normal component)."""
        out = torch.roll(x, sh, ax)
        if self._wall_on(d):
            pos = -1 if sh == -1 else 0
            row = self._row(x, pos, ax)
            if grad_field:
                ghost = self._ghost_grad(row, d, 0, negate_ghost)
            else:
                ghost = self._ghost_mean(row, d, 1 if sh == -1 else 0)
            out = self._set_row(out, ghost, pos, ax)
        return out

    def _ghost_grad(self, row, d, va, negate):
        """Ghost of a gradient or slope layer at an axis ``d`` wall: zero at
        prescribed-state walls (farfield, Dirichlet: the ghost is a
        constant), else the reflect hook's mirror or copy, negated for the
        wall-normal component."""
        if self.solver.boundary in ("farfield", "dirichlet"):
            return torch.zeros_like(row)
        ghost = self.solver.reflect_fn(row, d, va)
        return -ghost if negate else ghost

    def _sub_shift(self, x, sh, d, va, negate_ghost=False, grad_field=False):
        """``x`` shifted by one along the GLOBAL subcell index of direction
        ``d`` (the subcell axis within a cell, then the grid axis across
        cells; periodic, or the wall ghost of :meth:`_ghost_sub`, or with
        ``grad_field`` of :meth:`_ghost_grad`): ``sh = -1`` gives each
        subcell its +d neighbour, ``sh = 1`` its -d neighbour."""
        sol = self.solver
        grid_ax = sol.grid_axis(d)
        n_sub = self.n_sub

        def ghost_of(row, side):
            if grad_field:
                return self._ghost_grad(row, d, va, negate_ghost)
            return self._ghost_sub(row, d, side, va)

        if sh == -1:
            nxt = torch.roll(x.narrow(d, 0, 1), -1, grid_ax)
            if self._wall_on(d):
                row = self._row(x.narrow(d, n_sub - 1, 1), -1, grid_ax)
                nxt = self._set_row(nxt, ghost_of(row, 1), -1, grid_ax)
            return torch.cat([x.narrow(d, 1, n_sub - 1), nxt], dim=d)
        if sh == 1:
            prv = torch.roll(x.narrow(d, n_sub - 1, 1), 1, grid_ax)
            if self._wall_on(d):
                row = self._row(x.narrow(d, 0, 1), 0, grid_ax)
                prv = self._set_row(prv, ghost_of(row, 0), 0, grid_ax)
            return torch.cat([prv, x.narrow(d, 0, n_sub - 1)], dim=d)
        raise ValueError(f"shift must be +-1, got {sh}")

    # ------------------------------------------------------- diagnostics

    def _stepper(self):
        return self.accelerator if self.accelerator is not None else self.solver

    def capacity_usage(self, u, dt):
        """``(rows_demanded, capacity)`` for one step from ``u``: the
        overflow monitor of the gathered path.  ``rows_demanded`` is a 0-d
        tensor on the state's device; it runs one candidate step of its
        own."""
        if self.troubled_capacity is None:
            raise ValueError("capacity_usage requires troubled_capacity")
        candidate = self._stepper().step(u, dt)
        t = self.troubled_mask(u, candidate)
        return t.any(dim=-1).sum(), self.troubled_capacity

    # ------------------------------------------------------------- means

    def cell_means(self, u):
        """Quadrature average per cell: ``[n_vars, *grid]``."""
        out = u
        for d in reversed(range(self.solver.dim)):
            out = _project(self.solver.weights, out, self.solver.node_axis(d))
        return out

    def _broadcast_means(self, means, like):
        """``[n_vars, *grid]`` -> full nodal state (constant per cell)."""
        shape = (1,) * self.solver.dim + tuple(means.shape)
        return means.reshape(shape).expand(like.shape)

    # --------------------------------------------------------- detection

    def troubled_mask(self, u_old, candidate):
        """Boolean ``[*grid]`` mask of cells needing the fallback."""
        sol = self.solver
        D = sol.dim
        node_axes = tuple(range(D))
        # Per-cell NODAL extremes: [V, *grid].
        cell_lo = torch.amin(u_old, dim=node_axes)
        cell_hi = torch.amax(u_old, dim=node_axes)
        new_lo = torch.amin(candidate, dim=node_axes)
        new_hi = torch.amax(candidate, dim=node_axes)
        lo, hi = cell_lo, cell_hi
        for d in range(D):
            for shift in (-1, 1):
                lo = torch.minimum(lo, self._shift_clamp(cell_lo, shift, 1 + d, d))
                hi = torch.maximum(hi, self._shift_clamp(cell_hi, shift, 1 + d, d))
        delta = torch.maximum(
            self.dmp_delta0 * (1.0 + torch.abs(hi)), self.dmp_eps * (hi - lo)
        )
        dmp_ok = ((new_lo >= lo - delta) & (new_hi <= hi + delta)).all(dim=0)
        ok = dmp_ok & _leading_all(torch.isfinite(candidate), D + 1)
        if self.admissible is not None:
            ok = ok & _leading_all(self.admissible(candidate, sol.var_axis), D)
        return ~ok

    # ---------------------------------------------------------- fallbacks

    def _masked_jump(self, dq, va):
        """The solver's ``dissipation_mask`` applied to a Rusanov jump term
        (var axis ``va``)."""
        m = self.solver.dmask
        if m is None:
            return dq
        shape = [1] * dq.dim()
        shape[va] = m.numel()
        return dq * m.to(dq.dtype).reshape(shape)

    def fv_fallback(self, u, dt):
        """First-order Rusanov update of the cell means, nodal-broadcast
        (the ``"means"`` fallback, and the overflow policy's update); with
        an NCP the central half-fluctuation of both faces, with a source
        its forward-Euler term on the old means."""
        sol = self.solver
        means = self.cell_means(u)  # [V, *grid]; var axis 0
        new = means
        visc = sol.visc_flux_fn
        if visc is not None:
            # Central differences of the cell means, once for every direction.
            G = [(self._shift_reflect(means, -1, 1 + e, e)
                  - self._shift_reflect(means, 1, 1 + e, e)) / (2.0 * sol._dxs[e])
                 for e in range(sol.dim)]
        for d in range(sol.dim):
            lam = dt / sol._dxs[d]
            ax = 1 + d
            up = self._shift_reflect(means, -1, ax, d)  # +d neighbour
            dn = self._shift_reflect(means, 1, ax, d)  # -d neighbour

            def flux(Q):
                return sol.flux_fn(Q, d, 0)

            def eig(Q):
                return sol.max_eigenvalue_fn(Q, d, 0)

            s_hi = torch.maximum(eig(means), eig(up))[None]
            s_lo = torch.maximum(eig(dn), eig(means))[None]
            fhat_hi = (0.5 * (flux(means) + flux(up))
                       - 0.5 * s_hi * self._masked_jump(up - means, 0))
            fhat_lo = (0.5 * (flux(dn) + flux(means))
                       - 0.5 * s_lo * self._masked_jump(means - dn, 0))
            if visc is not None:
                v_hi, v_lo = self._diffusive_fluxes(
                    means, up, dn, G, d, 0, sol._dxs[d],
                    lambda x, sh, e: self._shift_reflect(
                        x, sh, ax, d, negate_ghost=(e == d), grad_field=True))
                fhat_hi, fhat_lo = fhat_hi + v_hi, fhat_lo + v_lo
            new = new - lam * (fhat_hi - fhat_lo)
            if sol.ncp_fn is not None:
                # Piecewise-constant cells: no volume term, the central half
                # of each face (the dissipation is in fhat).
                half_hi = 0.5 * sol.ncp_fn(0.5 * (means + up), up - means, d, 0)
                half_lo = 0.5 * sol.ncp_fn(0.5 * (dn + means), means - dn, d, 0)
                new = new - lam * (half_hi + half_lo)
        if sol.source_fn is not None:
            new = new + dt * sol.source_fn(means, 0)
        return self._broadcast_means(new, u)

    def _diffusive_fluxes(self, s, up, dn, G, d, va, h, shift_grad):
        """The central-difference diffusive fluxes through the high and low
        faces along ``d`` of the cells (or subcells) ``s`` with neighbours
        ``up``/``dn`` and cell-centred gradients ``G`` (spacing ``h`` along
        ``d``): the two-point normal derivative and the face average of the
        transverse gradients (``shift_grad(G[e], sh, e)`` the neighbour
        gradient), fed to the solver's viscous flux at the face-mean state.
        ``fhat_hi`` of a cell is ``fhat_lo`` of the next, so the update
        telescopes."""
        sol = self.solver
        G_up = [shift_grad(G[e], -1, e) for e in range(sol.dim)]
        G_dn = [shift_grad(G[e], 1, e) for e in range(sol.dim)]
        grads_hi = tuple((up - s) / h if e == d else 0.5 * (G[e] + G_up[e])
                         for e in range(sol.dim))
        grads_lo = tuple((s - dn) / h if e == d else 0.5 * (G_dn[e] + G[e])
                         for e in range(sol.dim))
        return (sol.visc_flux_fn(0.5 * (s + up), grads_hi, d, va),
                sol.visc_flux_fn(0.5 * (dn + s), grads_lo, d, va))

    # ------------------------------------------------------------- subcell

    def project_subcells(self, u):
        """Nodal state -> subcell means: node axes become n_sub-sized."""
        out = u
        for d in range(self.solver.dim):
            out = _apply(self.P, out, self.solver.node_axis(d))
        return out

    def reconstruct_subcells(self, s):
        """Subcell means -> nodal, with the cell-mean conservation fix (the
        quadrature mean equals the subcell mean); any trailing axes (the
        grid, or the gathered path's slot batch)."""
        sol = self.solver
        out = s
        for d in range(sol.dim):
            out = _apply(self.R, out, d)
        mean_sub = torch.mean(s, dim=tuple(range(sol.dim)))
        mean_rec = out
        for d in reversed(range(sol.dim)):
            mean_rec = _project(sol.weights, mean_rec, d)
        shift = (mean_sub - mean_rec).reshape((1,) * sol.dim + tuple(mean_sub.shape))
        return out + shift

    def subcell_fv_step(self, u, dt, return_face_fluxes: bool = False):
        """One first-order Rusanov FV step on the (2N+1)^dim subcell grid
        of every cell (periodic across cells, or the wall ghosts of
        :meth:`_ghost_sub` fed the wall-adjacent subcell of the same
        cell), returned as reconstructed nodal state.  The sweeps are
        :meth:`_row_sweep_math` over the whole grid.

        ``return_face_fluxes=True`` also returns, per direction, the
        transverse-mean flux through each cell's HIGH face ``[V, *grid]``
        (on a wall axis the last row's is the high-wall flux), for
        interface matching."""
        sol = self.solver
        n_sub = self.n_sub
        va = sol.var_axis
        s = self.project_subcells(u)
        if self.fallback_order == 2:
            # MUSCL + Heun (SSP-RK2); the cell-boundary flux is the stages'
            # average.
            s1, fl1 = self._muscl_sweep(s, dt)
            s2, fl2 = self._muscl_sweep(s1, dt)
            recon = self.reconstruct_subcells(0.5 * (s + s2))
            if return_face_fluxes:
                return recon, [0.5 * (a + b) for a, b in zip(fl1, fl2)]
            return recon
        face_fluxes = []
        for d in range(sol.dim):
            grid_ax = sol.grid_axis(d)
            first = s.narrow(d, 0, 1)
            last = s.narrow(d, n_sub - 1, 1)
            from_right = torch.roll(first, -1, grid_ax)
            from_left = torch.roll(last, 1, grid_ax)
            if self._wall_on(d):
                ghost_hi = self._ghost_sub(self._row(last, -1, grid_ax), d, 1, va)
                from_right = self._set_row(from_right, ghost_hi, -1, grid_ax)
                ghost_lo = self._ghost_sub(self._row(first, 0, grid_ax), d, 0, va)
                from_left = self._set_row(from_left, ghost_lo, 0, grid_ax)
            extra = None
            if sol.visc_flux_fn is not None:
                # The diffusive face fluxes of the sweep's own state (JAX's
                # whole-grid step, limiter.py:678-713).
                G = self._sub_gradients(s)
                extra = self._diffusive_fluxes(
                    s, self._sub_shift(s, -1, d, va), self._sub_shift(s, 1, d, va), G, d, va,
                    sol._dxs[d] / n_sub,
                    lambda x, sh, e: self._sub_shift(x, sh, d, va, negate_ghost=(e == d),
                                                     grad_field=True))
            s, _, g_hi = self._row_sweep_math(s, from_left, from_right, d, dt, extra)
            face_fluxes.append(g_hi)
        if sol.source_fn is not None:
            # Forward Euler on the swept subcell means (first order in time,
            # as the fallback is).
            s = s + dt * sol.source_fn(s, va)
        recon = self.reconstruct_subcells(s)
        if return_face_fluxes:
            return recon, face_fluxes
        return recon

    # -------------------------------------------------- second-order subcell

    def _sub_gradients(self, s):
        """Cell-centred central differences of the subcell state along each
        axis (the ghosts of :meth:`_sub_shift`)."""
        sol = self.solver
        va = sol.var_axis
        return [(self._sub_shift(s, -1, e, va) - self._sub_shift(s, 1, e, va))
                / (2.0 * (sol._dxs[e] / self.n_sub)) for e in range(sol.dim)]

    def _slope(self, d_plus, d_minus):
        """The limited slope from the forward and backward differences."""
        if self.fallback_slope == "central":
            return 0.5 * (d_plus + d_minus)
        same = (d_plus * d_minus) > 0.0
        if self.fallback_slope == "minmod":
            lim = torch.where(torch.abs(d_plus) < torch.abs(d_minus), d_plus, d_minus)
        else:  # monotonized central
            lim = torch.sign(d_plus) * torch.minimum(
                torch.abs(0.5 * (d_plus + d_minus)),
                2.0 * torch.minimum(torch.abs(d_plus), torch.abs(d_minus)))
        return torch.where(same, lim, 0.0)

    def _muscl_sweep(self, s, dt):
        """One unsplit MUSCL Rusanov stage on the subcell grid: ``s +
        dt·L(s)`` and the per-direction transverse-mean cell-boundary fluxes
        (JAX's ``_muscl_sweep``).  With an NCP, the path-conservative
        fluctuations of the reconstructed interface states and the in-cell
        term B(s)·σ; with a source, its forward-Euler term on ``s``."""
        sol = self.solver
        va = sol.var_axis
        n_sub = self.n_sub
        out = s
        face_fluxes = []
        if sol.visc_flux_fn is not None:
            G = self._sub_gradients(s)  # of the stage state, once
        for d in range(sol.dim):
            lam = dt / (sol._dxs[d] / n_sub)
            u_plus = self._sub_shift(s, -1, d, va)
            u_minus = self._sub_shift(s, 1, d, va)
            sigma = self._slope(u_plus - s, s - u_minus)
            sigma_plus = self._sub_shift(sigma, -1, d, va, negate_ghost=True, grad_field=True)
            sigma_minus = self._sub_shift(sigma, 1, d, va, negate_ghost=True, grad_field=True)
            # The reconstructed interface states at my high and low faces.
            qL_hi = s + 0.5 * sigma
            qR_hi = u_plus - 0.5 * sigma_plus
            qL_lo = u_minus + 0.5 * sigma_minus
            qR_lo = s - 0.5 * sigma

            def rusanov(qL, qR):
                F = 0.5 * (sol.flux_fn(qL, d, va) + sol.flux_fn(qR, d, va))
                sp = torch.maximum(sol.max_eigenvalue_fn(qL, d, va),
                                   sol.max_eigenvalue_fn(qR, d, va)).unsqueeze(va)
                return F - 0.5 * sp * self._masked_jump(qR - qL, va)

            fhat_hi = rusanov(qL_hi, qR_hi)
            fhat_lo = rusanov(qL_lo, qR_lo)
            if sol.visc_flux_fn is not None:
                v_hi, v_lo = self._diffusive_fluxes(
                    s, u_plus, u_minus, G, d, va, sol._dxs[d] / n_sub,
                    lambda x, sh, e: self._sub_shift(x, sh, d, va, negate_ghost=(e == d),
                                                     grad_field=True))
                fhat_hi, fhat_lo = fhat_hi + v_hi, fhat_lo + v_lo
            out = out - lam * (fhat_hi - fhat_lo)
            if sol.ncp_fn is not None:
                half_hi = 0.5 * sol.ncp_fn(0.5 * (qL_hi + qR_hi), qR_hi - qL_hi, d, va)
                half_lo = 0.5 * sol.ncp_fn(0.5 * (qL_lo + qR_lo), qR_lo - qL_lo, d, va)
                # The in-cell reconstruction term B(s)·σ: what lifts the
                # path-conservative fallback to second order.
                vol = sol.ncp_fn(s, sigma, d, va)
                out = out - lam * (half_hi + half_lo + vol)
            other_sub = tuple(a if a < d else a - 1 for a in range(sol.dim) if a != d)
            face_fluxes.append(torch.mean(fhat_hi.select(d, n_sub - 1), dim=other_sub))
        if sol.source_fn is not None:
            out = out + dt * sol.source_fn(s, va)
        return out, face_fluxes

    # --------------------------------------------- row-granular gathered path

    def _gather_tables_row(self, troubled):
        """Row tables: one slot per LAST-axis row containing any troubled
        cell, lowest row first, at most ``troubled_capacity``.  Indices run
        over the flattened leading grid axes (``R_n`` rows); ``row`` holds
        the sentinel ``R_n`` in inactive slots.  The active slots are the
        prefix ``k < n_active``; ``n_active`` is a 0-d tensor, so no host
        synchronisation reads it.  ``wall[k, d, side]`` marks a slot whose
        neighbour row across ``side`` of table direction ``d`` lies beyond a
        wall; its ``nb_slot`` is then -1 (its ghost is the wall's).  All
        int64 (``wall`` bool), on the mask's device."""
        sol = self.solver
        K = self.troubled_capacity
        grid = sol.grid_shape
        L = grid[-1]
        lead_grid = grid[:-1]
        R_n = int(np.prod(lead_grid))
        dev = troubled.device
        cell_rows = troubled.reshape(R_n, L)
        flat = cell_rows.any(dim=-1)
        pos = torch.cumsum(flat.to(torch.int64), 0) - 1
        # Slot K of a (K+1)-long buffer takes the writes JAX drops.
        slot_target = torch.where(flat & (pos < K), pos, K)
        row = torch.full((K + 1,), R_n, dtype=torch.int64, device=dev).scatter_(
            0, slot_target, torch.arange(R_n, dtype=torch.int64, device=dev)
        )[:K]
        active = row < R_n
        row_safe = torch.clamp(row, max=R_n - 1)
        slot_of = torch.full((R_n + 1,), -1, dtype=torch.int64, device=dev).scatter_(
            0, row, torch.arange(K, dtype=torch.int64, device=dev)
        )[:R_n]
        strides = [int(np.prod(lead_grid[d + 1:])) for d in range(sol.dim - 1)]
        nb_slot, nb_row, wall = [], [], []
        for d in range(sol.dim - 1):
            coord = (row_safe // strides[d]) % lead_grid[d]
            span = lead_grid[d] * strides[d]
            per_nb, per_row, per_wall = [], [], []
            for sh in (-1, 1):
                moved = coord + sh
                crossed = (moved < 0) | (moved >= lead_grid[d])
                on_wall = crossed if self._wall_on(d) else torch.zeros_like(active)
                flat_nb = row_safe + sh * strides[d]
                flat_nb = torch.where(moved < 0, flat_nb + span, flat_nb)
                flat_nb = torch.where(moved >= lead_grid[d], flat_nb - span, flat_nb)
                per_nb.append(torch.where(on_wall, -1, slot_of[flat_nb]))
                per_row.append(flat_nb)
                per_wall.append(on_wall)
            nb_slot.append(torch.stack(per_nb, dim=-1))
            nb_row.append(torch.stack(per_row, dim=-1))
            wall.append(torch.stack(per_wall, dim=-1))
        row_gathered = torch.zeros(R_n + 1, dtype=torch.bool, device=dev).index_fill_(
            0, row, True
        )[:R_n]
        # Effective per-cell mask: troubled AND its row was gathered.
        mask = (cell_rows & row_gathered[:, None]).reshape(grid)
        return {
            "row": row,
            "row_safe": row_safe,
            "active": active,
            "n_active": torch.clamp(flat.sum(), max=K),
            "nb_slot": torch.stack(nb_slot, dim=1),  # [K, dim-1, 2]
            "nb_row": torch.stack(nb_row, dim=1),  # [K, dim-1, 2]
            "wall": torch.stack(wall, dim=1),  # [K, dim-1, 2]
            "mask": mask,
        }

    def _gather_rows(self, u, row_idx):
        """``[node.., V, *grid]`` -> ``[node.., V, K, L]``: one gather along
        the flattened leading grid axes."""
        sol = self.solver
        lead = tuple(u.shape[: sol.dim + 1])
        L = u.shape[-1]
        return u.reshape(lead + (-1, L)).index_select(sol.dim + 1, row_idx)

    def _gathered_subcell_step_row(self, u, dt, tables):
        """The (2N+1)^dim Rusanov FV step on the gathered ROW batch
        ``[.., K, L]``.  The last direction's ghosts are an in-row roll
        (rows span the whole axis), its walls the mirror of the row's edge
        layer; the other directions take the neighbour slot's edge layer
        where that row is gathered, the neighbour row's projected DG edge
        layer where it is not, and the mirror of the slot's own edge layer
        beyond a wall.  Returns the reconstructed nodal rows and the
        per-direction ``(g_lo, g_hi)`` transverse-mean cell-boundary fluxes
        ``[V, K, L]``."""
        sol = self.solver
        n_sub = self.n_sub
        va = sol.var_axis
        D = sol.dim
        K_ax = D + 1  # slot axis of gathered arrays
        L_ax = D + 2
        s = self._gather_rows(u, tables["row_safe"])
        for d in range(D):
            s = _apply(self.P, s, d)
        s = s.contiguous()  # the sweep kernel's layout

        # DG ghost layers of the table directions (d < D-1): the neighbour
        # row's subcell edge layer facing this row, projected along d first
        # so only the one-layer slice pays the transverse projections.
        dg_ghost = []
        for d in range(D - 1):
            per_side = []
            for side in (0, 1):
                Un = self._gather_rows(u, tables["nb_row"][:, d, side])
                edge = n_sub - 1 if side == 0 else 0
                edge_row = [float(v) for v in self._P_np[edge]]
                Sn = sum(
                    edge_row[j] * Un.narrow(d, j, 1) for j in range(sol.n_nodes)
                )
                for e in range(D):
                    if e != d:
                        Sn = _apply(self.P, Sn, e)
                per_side.append(Sn)
            dg_ghost.append(per_side)

        def kmask(m, ndim):
            return m.reshape((1,) * (ndim - 2) + (-1, 1))

        if self.subcell_cuda:
            from exahype_tpu_torch.models.subcell_cuda import row_sweep_call

            # In place, on the active slots only (the rest is never read).
            sweep = lambda d, s_, lo, hi: row_sweep_call(
                self, d, s_, lo, hi, dt, tables["n_active"])
        else:
            sweep = lambda d, s_, lo, hi: self._row_sweep_math(s_, lo, hi, d, dt)
        g_fluxes = []
        for d in range(D):
            first = s.narrow(d, 0, 1)
            last = s.narrow(d, n_sub - 1, 1)
            if d < D - 1:
                nb_lo = tables["nb_slot"][:, d, 0]
                nb_hi = tables["nb_slot"][:, d, 1]
                ghost_hi = torch.where(
                    kmask(nb_hi >= 0, s.dim()),
                    first.index_select(K_ax, torch.clamp(nb_hi, min=0)),
                    dg_ghost[d][1],
                )
                ghost_lo = torch.where(
                    kmask(nb_lo >= 0, s.dim()),
                    last.index_select(K_ax, torch.clamp(nb_lo, min=0)),
                    dg_ghost[d][0],
                )
                if self._wall_on(d):
                    ghost_hi = torch.where(kmask(tables["wall"][:, d, 1], s.dim()),
                                           sol.reflect_fn(last, d, va), ghost_hi)
                    ghost_lo = torch.where(kmask(tables["wall"][:, d, 0], s.dim()),
                                           sol.reflect_fn(first, d, va), ghost_lo)
            else:
                ghost_hi = torch.roll(first, -1, L_ax)
                ghost_lo = torch.roll(last, 1, L_ax)
                if self._wall_on(d):
                    mirror_hi = sol.reflect_fn(self._row(last, -1, L_ax), d, va)
                    mirror_lo = sol.reflect_fn(self._row(first, 0, L_ax), d, va)
                    ghost_hi = self._set_row(ghost_hi, mirror_hi, -1, L_ax)
                    ghost_lo = self._set_row(ghost_lo, mirror_lo, 0, L_ax)
            s, g_lo, g_hi = sweep(d, s, ghost_lo.contiguous(), ghost_hi.contiguous())
            g_fluxes.append((g_lo, g_hi))
        if sol.source_fn is not None:
            # Plain PyTorch on every slot (XLA around the sweeps in JAX).
            s = s + dt * sol.source_fn(s, va)
        return self.reconstruct_subcells(s), g_fluxes

    def _row_sweep_math(self, s, ghost_lo, ghost_hi, d, dt, extra=None):
        """One directional Rusanov sweep along subcell axis ``d`` of a batch
        ``[sub.., V, *rest]`` (the gathered rows ``[.., K, L]``, or the whole
        grid), with the ghost layers already built — the plain version of
        the sweep kernels (``csrc/subcell.cu``, ``csrc/subcell_ncp.cuh``).
        The jump term takes the solver's dissipation mask; with an NCP each
        subcell also takes the central half-fluctuation
        ½·ncp(½(s_j + s_{j+1}), s_{j+1} − s_j) of its two faces, evaluated
        once a face (the two subcells beside a face see the same operands
        in the same order).  ``extra``: fluxes added to the high and low
        face fluxes (the whole grid's viscous terms).  Returns ``(s_new,
        g_lo, g_hi)``, the ``g``'s the transverse-mean cell-boundary fluxes
        ``[V, *rest]``."""
        sol = self.solver
        n_sub = self.n_sub
        va = sol.var_axis
        D = sol.dim
        lam = dt / (sol._dxs[d] / n_sub)

        def cat(a, b):
            return torch.cat([a, b], dim=d)

        inner_hi = s.narrow(d, 1, n_sub - 1)
        inner_lo = s.narrow(d, 0, n_sub - 1)
        u_plus = cat(inner_hi, ghost_hi)
        u_minus = cat(ghost_lo, inner_lo)
        # One flux/eig sweep + shifted reuse (the physics is elementwise).
        F = sol.flux_fn(s, d, va)
        F_plus = cat(F.narrow(d, 1, n_sub - 1), sol.flux_fn(ghost_hi, d, va))
        F_minus = cat(sol.flux_fn(ghost_lo, d, va), F.narrow(d, 0, n_sub - 1))
        E = sol.max_eigenvalue_fn(s, d, va)
        E_plus = cat(E.narrow(d, 1, n_sub - 1), sol.max_eigenvalue_fn(ghost_hi, d, va))
        E_minus = cat(sol.max_eigenvalue_fn(ghost_lo, d, va), E.narrow(d, 0, n_sub - 1))
        s_hi = torch.maximum(E, E_plus).unsqueeze(va)
        s_lo = torch.maximum(E_minus, E).unsqueeze(va)
        fhat_hi = 0.5 * (F + F_plus) - 0.5 * s_hi * self._masked_jump(u_plus - s, va)
        fhat_lo = 0.5 * (F_minus + F) - 0.5 * s_lo * self._masked_jump(s - u_minus, va)
        if extra is not None:
            fhat_hi, fhat_lo = fhat_hi + extra[0], fhat_lo + extra[1]
        other_sub = tuple(a if a < d else a - 1 for a in range(D) if a != d)
        g_hi = torch.mean(fhat_hi.select(d, n_sub - 1), dim=other_sub)
        g_lo = torch.mean(fhat_lo.select(d, 0), dim=other_sub)
        out = s - lam * (fhat_hi - fhat_lo)
        if sol.ncp_fn is not None:
            # Face j lies between ext[j] and ext[j+1] of the pencil extended
            # by its ghosts: subcell j's low face is j, its high face j + 1.
            ext = cat(cat(ghost_lo, s), ghost_hi)
            left, right = ext.narrow(d, 0, n_sub + 1), ext.narrow(d, 1, n_sub + 1)
            half = 0.5 * sol.ncp_fn(0.5 * (left + right), right - left, d, va)
            out = out - lam * (half.narrow(d, 1, n_sub) + half.narrow(d, 0, n_sub))
        return out, g_lo, g_hi

    def _scatter_fallback_row(self, candidate, R, tables, troubled):
        """Merge the gathered rows back into ``candidate``, in place: the
        troubled CELLS of each gathered row take the FV values, the rest
        keep the candidate.  An inactive slot (JAX drops its write) writes
        the last active slot's merged row to that slot's row, so every
        write to a row carries the same bits (with no active slot, slot 0
        writes the candidate's own row back)."""
        sol = self.solver
        row_ax = sol.dim + 1
        L = candidate.shape[-1]
        flat = candidate.view(tuple(candidate.shape[:row_ax]) + (-1, L))
        active = tables["active"]
        slots = torch.arange(active.numel(), device=active.device)
        last = torch.clamp(tables["n_active"] - 1, min=0)
        src = torch.where(active, slots, last)
        rows = tables["row_safe"][src]
        cand_rows = flat.index_select(row_ax, rows)
        t_rows = troubled.reshape(-1, L).index_select(0, rows)
        merged = torch.where(
            t_rows.reshape((1,) * row_ax + (-1, L)), R.index_select(row_ax, src), cand_rows
        )
        flat.index_copy_(row_ax, rows, merged)
        return candidate

    def _scatter_face_fluxes_row(self, g_fluxes, tables, dtype):
        """Global high-face flux arrays ``[V, *grid]`` from the gathered
        row fluxes: each slot writes its high-face fluxes at its row, and
        in the table directions its low-face fluxes at the -d neighbour row
        (identical values where both rows are gathered), but not across a
        wall (the wall face has one owner).  Dropped writes go to a scratch
        row past the last."""
        sol = self.solver
        grid = sol.grid_shape
        L = grid[-1]
        R_n = int(np.prod(grid[:-1]))
        dev = tables["row"].device
        out = []
        for d in range(sol.dim):
            g_lo, g_hi = g_fluxes[d]
            G = torch.zeros((sol.n_vars, R_n + 1, L), dtype=dtype, device=dev)
            G.index_copy_(1, tables["row"], g_hi)
            if d < sol.dim - 1:
                keep = tables["active"] & ~tables["wall"][:, d, 0]
                tgt = torch.where(keep, tables["nb_row"][:, d, 0], R_n)
                G.index_copy_(1, tgt, g_lo)
            out.append(G[:, :R_n].reshape((sol.n_vars,) + grid))
        return out

    # --------------------------------------------------- interface matching

    def _admissibility_scale(self, out):
        """Post-step conservative admissibility guard: cells with an
        inadmissible node are contracted toward their own cell mean,
        ``mean + θ·(out − mean)`` with the largest admissible θ of
        (0.1, 0.25, 0.5, 1) — θ = 0, the mean, otherwise — which keeps
        every cell mean exactly.  The contraction runs only on a step with
        an inadmissible node (one flag read by the host)."""
        sol = self.solver
        D = sol.dim

        def cell_ok(Q):
            return _leading_all(self.admissible(Q, sol.var_axis), D)

        if bool(cell_ok(out).all()):
            return out
        mb = self._broadcast_means(self.cell_means(out), out)
        best = mb
        for th in (0.1, 0.25, 0.5, 1.0):
            cand = mb + th * (out - mb)
            okc = cell_ok(cand)
            best = torch.where(okc.reshape((1,) * (D + 1) + tuple(okc.shape)), cand, best)
        return best.contiguous()

    def _match_interface_fluxes(self, candidate, dg_fluxes, fv_fluxes, troubled, dt):
        """Make mixed DG/FV faces single-valued: untroubled cells beside a
        troubled neighbour replace their DG face flux with the (constant)
        transverse mean the troubled side used.  Wall faces have one owner
        and are never mixed (the wrapped mask rows are meaningless there);
        axes outside ``wall_axes`` stay periodic and their wrap faces are
        matched."""
        sol = self.solver
        nn_ = sol.n_nodes
        out = candidate
        for d in range(sol.dim):
            lam = dt / sol._dxs[d]
            node_ax = sol.node_axis(d)
            face_grid_ax = sol.grid_axis(d) - 1
            fhat_dg = dg_fluxes[d]  # [nodes^(dim-1), V, *grid]
            G = fv_fluxes[d].reshape((1,) * (sol.dim - 1) + tuple(fv_fluxes[d].shape))
            nbr_hi = torch.roll(troubled, -1, d)
            nbr_lo = torch.roll(troubled, 1, d)
            if self._wall_on(d):
                false_row = torch.zeros_like(self._row(nbr_hi, -1, d))
                nbr_hi = self._set_row(nbr_hi, false_row, -1, d)
                nbr_lo = self._set_row(nbr_lo, false_row, 0, d)
            mixed_hi = (~troubled) & nbr_hi
            mixed_lo = (~troubled) & nbr_lo

            def expand_mask(m, like):
                return m.reshape((1,) * (like.dim() - m.dim()) + tuple(m.shape))

            delta_hi = torch.where(expand_mask(mixed_hi, fhat_dg), G - fhat_dg, 0.0)
            fhat_dg_lo = torch.roll(fhat_dg, 1, face_grid_ax)
            G_lo = torch.roll(G, 1, face_grid_ax)
            delta_lo = torch.where(
                expand_mask(mixed_lo, fhat_dg_lo), G_lo - fhat_dg_lo, 0.0
            )
            shape_i = [1] * out.dim()
            shape_i[node_ax] = nn_
            phi1_w = sol.phi1_w.to(out.dtype).reshape(shape_i)
            phi0_w = sol.phi0_w.to(out.dtype).reshape(shape_i)
            out = out - lam * (
                phi1_w * delta_hi.unsqueeze(node_ax)
                - phi0_w * delta_lo.unsqueeze(node_ax)
            )
        return out

    # -------------------------------------------------------------- step

    def driver_observables(self, *args, **kwargs):
        """Not ported: the port has no ``TimeLoopDriver`` yet."""
        raise SemanticError(
            "driver_observables is not ported to exahype_tpu_torch yet (no "
            "TimeLoopDriver); see ROADMAP.md, Queue 1 item 6"
        )

    def _effective_fluxes(self, dg_fluxes, fv_fluxes, troubled):
        """The per-direction EFFECTIVE high-face fluxes of a limited step:
        the subcell FV transverse mean on every face touching a troubled
        cell, the nodal DG Rusanov flux elsewhere.  On a wall axis the last
        slot is the high-wall face, which has one owner: it takes the FV
        flux only if the last cell is troubled."""
        sol = self.solver
        eff = []
        for d in range(sol.dim):
            fhat_dg = dg_fluxes[d]
            G = fv_fluxes[d].reshape((1,) * (sol.dim - 1) + tuple(fv_fluxes[d].shape))
            either = troubled | torch.roll(troubled, -1, d)
            if self._wall_on(d):
                either = self._set_row(either, self._row(troubled, -1, d), -1, d)
            shape = (1,) * (fhat_dg.dim() - either.dim()) + tuple(either.shape)
            eff.append(torch.where(either.reshape(shape), G.expand(fhat_dg.shape), fhat_dg))
        return eff

    def step(self, u, dt, return_face_fluxes: bool = False, troubled_transform=None):
        """One limited step; a fresh tensor.

        ``return_face_fluxes=True`` also returns the per-direction
        EFFECTIVE high-face fluxes of the limited update
        (:meth:`_effective_fluxes`; the ``"means"`` fallback has none and
        raises, as in JAX).  Wall-face convention: ``eff[d][..., c]`` is the
        flux through cell ``c``'s HIGH face, so on a wall axis the last slot
        holds the HIGH-WALL flux (DG's if the last cell is untroubled, the
        subcell FV aggregate if it is troubled); the LOW-wall flux is not
        stored.  ``troubled_transform`` (the JAX AMR pool's hook) is not
        ported and raises unless None."""
        if troubled_transform is not None:
            raise SemanticError(
                "troubled_transform (the AMR pool's hook) is not ported to "
                "exahype_tpu_torch yet; see ROADMAP.md, Queue 1 item 11"
            )
        sol = self.solver
        candidate, dg_fluxes = self._stepper().step(u, dt, return_face_fluxes=True)
        troubled = self.troubled_mask(u, candidate)  # [*grid]
        if self.troubled_capacity is None:
            return self._step_whole_grid(u, dt, candidate, dg_fluxes, troubled,
                                         return_face_fluxes)
        tables = self._gather_tables_row(troubled)
        troubled_raw, troubled = troubled, tables["mask"]
        R, g_fluxes = self._gathered_subcell_step_row(u, dt, tables)
        fv_fluxes = self._scatter_face_fluxes_row(g_fluxes, tables, u.dtype)
        candidate = self._match_interface_fluxes(
            candidate, dg_fluxes, fv_fluxes, troubled, dt
        )
        out = self._scatter_fallback_row(candidate, R, tables, troubled)
        # Troubled rows beyond the capacity: the first-order cell-mean
        # update instead of the failed DG candidate (stable, so a sustained
        # overflow costs accuracy there instead of growing).
        over = troubled_raw & ~troubled
        if bool(over.any()):
            m = over.reshape((1,) * (sol.dim + 1) + tuple(over.shape))
            out = torch.where(m, self.fv_fallback(u, dt), out)
        if self.admissible is not None and self.post_step_guard:
            out = self._admissibility_scale(out)
        if not return_face_fluxes:
            return out
        return out, self._effective_fluxes(dg_fluxes, fv_fluxes, troubled)

    def _step_whole_grid(self, u, dt, candidate, dg_fluxes, troubled, return_face_fluxes):
        """The rest of :meth:`step` with the fallback on the whole grid:
        the subcell step (matched, then guarded) or the cell-mean update
        (neither matched nor guarded, as in JAX) taken by the troubled
        cells."""
        sol = self.solver
        if self.fallback == "subcell":
            fb, fv_fluxes = self.subcell_fv_step(u, dt, return_face_fluxes=True)
            candidate = self._match_interface_fluxes(
                candidate, dg_fluxes, fv_fluxes, troubled, dt
            )
        else:
            if return_face_fluxes:
                raise ValueError("return_face_fluxes requires the 'subcell' fallback")
            fb = self.fv_fallback(u, dt)
        mask = troubled.reshape((1,) * (sol.dim + 1) + tuple(troubled.shape))
        # Contiguous, as the kernels take a state: the reconstruction's
        # contractions leave its node axes permuted, and where() keeps that.
        out = torch.where(mask, fb, candidate).contiguous()
        if self.admissible is not None and self.fallback == "subcell" and self.post_step_guard:
            out = self._admissibility_scale(out)
        if not return_face_fluxes:
            return out
        return out, self._effective_fluxes(dg_fluxes, fv_fluxes, troubled)

    def run(self, u, n_steps: int, dt):
        for _ in range(n_steps):
            u = self.step(u, dt)
        return u
