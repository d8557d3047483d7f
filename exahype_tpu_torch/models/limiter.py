"""A-posteriori subcell FV limiter for ADER-DG, gathered-row production path
(PyTorch, eager).

Port of ``exahype_tpu/models/limiter.py::LimitedADERDG`` on the
configuration its benchmark runs (``bench.py::bench_limited``): periodic
grid, ``troubled_capacity`` rows with ``troubled_granularity="row"``, the
first-order ``"subcell"`` fallback, the ``"means"`` overflow policy and the
post-step admissibility guard.  One step:

1. the unlimited candidate and its per-axis high-face fluxes, from the base
   solver or, with ``accelerator=CudaADERDG(solver)``, its CUDA kernels;
2. detection (:meth:`LimitedADERDG.troubled_mask`): relaxed DMP on the
   nodal extremes of the 2·dim+1 neighbourhood, finiteness, and the
   ``admissible`` hook;
3. the troubled cells' last-axis rows gathered into a batch of at most
   ``troubled_capacity`` rows (:meth:`_gather_tables_row`), one
   (2N+1)^dim-subcell Rusanov step on it, one directional sweep per axis
   (:meth:`_row_sweep_math`, or with ``subcell_cuda=True`` the CUDA kernel
   of ``models/subcell_cuda.py``), and the rows scattered back;
4. interface matching, so mixed DG/FV faces carry one flux and the step
   conserves; the cell-mean update of rows beyond the capacity; the guard.

Detection, tables, gathers, projections, ghosts, scatters, matching and the
guard are plain PyTorch on either device, as they are XLA in the JAX
package.  What the translation changes:

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

Options outside that configuration raise :class:`SemanticError` (see
``ROADMAP.md``, Queue 1 item 9).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from exahype_tpu_torch.models.aderdg import (
    CALLBACK_OPTIONS,
    ADERDGSolver,
    _apply,
    _project,
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


#: Options of the JAX ``LimitedADERDG`` with the one value the port
#: carries; any other raises.
PORTED_VALUES = {
    "fallback": "subcell",
    "fallback_order": 1,
    "troubled_granularity": "row",
    "overflow_fallback": "means",
}


def _leading_all(x, n: int):
    """``all`` over the first ``n`` axes."""
    return x.flatten(0, n - 1).all(dim=0)


class LimitedADERDG(nn.Module):
    """ADER-DG with the gathered-row subcell FV fallback.

    ``admissible(Q, var_axis) -> bool mask`` over the node axes (reduced
    with ``all`` per cell); omit to use only the DMP criterion.  The
    keyword options carry the JAX limiter's names and defaults; those
    outside the production configuration raise :class:`SemanticError`
    (``troubled_capacity`` must be set, ``troubled_granularity`` must be
    ``"row"``).  ``accelerator``: a :class:`CudaADERDG` over the same
    solver, for the candidate step; ``subcell_cuda``: run the directional
    sweeps through the CUDA kernel (the JAX limiter's ``subcell_pallas``).

    The subcell projection ``P`` and reconstruction ``R`` are float64
    buffers on ``device`` — the card unless ``device="cpu"`` — which must
    be the solver's; they are cast to the state's dtype where applied.
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
        accelerator=None,
        troubled_capacity: Optional[int] = None,
        troubled_granularity: str = "cell",
        subcell_cuda: bool = False,
        overflow_fallback: str = "means",
        post_step_guard: bool = True,
        device=None,
    ):
        super().__init__()
        given = {
            "fallback": fallback,
            "fallback_order": fallback_order,
            "troubled_granularity": troubled_granularity,
            "overflow_fallback": overflow_fallback,
        }
        for name, value in given.items():
            if value != PORTED_VALUES[name]:
                raise SemanticError(
                    f"{name}={value!r} is not ported to exahype_tpu_torch yet "
                    "(only the gathered-row subcell fallback with the 'means' "
                    "overflow policy is); see ROADMAP.md, Queue 1 item 9"
                )
        if troubled_capacity is None:
            raise SemanticError(
                "troubled_capacity=None (the whole-grid fallback) is not "
                "ported to exahype_tpu_torch yet; see ROADMAP.md, Queue 1 "
                "item 9"
            )
        if (solver.predictor_mode != "picard" or solver.dissipation_mask is not None
                or any(getattr(solver, name) is not None for name in CALLBACK_OPTIONS)):
            raise SemanticError(
                "the limiter over a CK, dissipation-masked, source or NCP solver "
                "is not ported to exahype_tpu_torch yet; see ROADMAP.md, Queue 1 "
                "item 9"
            )
        if solver.visc_flux_fn is not None:
            # The fallback has no diffusive face fluxes: a viscous solver
            # would get a wrong answer, not an error.  JAX carries them on
            # its whole-grid paths only and refuses the gathered ones.
            raise SemanticError(
                "viscous solvers are not supported on the gathered "
                "(troubled_capacity) fallback paths yet; see ROADMAP.md, Queue 1 "
                "item 9"
            )
        if any(solver.is_wall(d) for d in range(solver.dim)):
            # The subcell fallback's ghosts are periodic: a walled solver
            # would get a wrong answer, not an error.
            raise SemanticError(
                f"the limiter over a walled solver (boundary={solver.boundary!r}) is "
                "not ported to exahype_tpu_torch yet; see ROADMAP.md, Queue 1 item 9"
            )
        if accelerator is not None and accelerator.solver is not solver:
            raise ValueError("accelerator must wrap the limiter's own base solver")
        device = resolve_device(device)
        if device != solver.weights.device:
            raise ValueError(
                f"device {device} is not the solver's ({solver.weights.device})"
            )
        self.solver = solver
        self.admissible = admissible
        self.dmp_delta0 = float(dmp_delta0)
        self.dmp_eps = float(dmp_eps)
        self.accelerator = accelerator
        self.subcell_cuda = bool(subcell_cuda)
        self.post_step_guard = bool(post_step_guard)
        self.n_sub = 2 * solver.order + 1
        n_rows = int(np.prod(solver.grid_shape[:-1]))
        self.troubled_capacity = min(int(troubled_capacity), n_rows)
        P = subcell_projection(solver.order, self.n_sub, solver.basis)
        R = subcell_reconstruction(solver.order, self.n_sub, solver.basis)
        self._P_np = P
        self.register_buffer("P", torch.as_tensor(P, dtype=torch.float64, device=device))
        self.register_buffer("R", torch.as_tensor(R, dtype=torch.float64, device=device))

    # ------------------------------------------------------- diagnostics

    def _stepper(self):
        return self.accelerator if self.accelerator is not None else self.solver

    def capacity_usage(self, u, dt):
        """``(rows_demanded, capacity)`` for one step from ``u``: the
        overflow monitor.  ``rows_demanded`` is a 0-d tensor on the state's
        device; it runs one candidate step of its own."""
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
                lo = torch.minimum(lo, torch.roll(cell_lo, shift, 1 + d))
                hi = torch.maximum(hi, torch.roll(cell_hi, shift, 1 + d))
        delta = torch.maximum(
            self.dmp_delta0 * (1.0 + torch.abs(hi)), self.dmp_eps * (hi - lo)
        )
        dmp_ok = ((new_lo >= lo - delta) & (new_hi <= hi + delta)).all(dim=0)
        ok = dmp_ok & _leading_all(torch.isfinite(candidate), D + 1)
        if self.admissible is not None:
            ok = ok & _leading_all(self.admissible(candidate, sol.var_axis), D)
        return ~ok

    # ---------------------------------------------------------- fallbacks

    def fv_fallback(self, u, dt):
        """First-order Rusanov update of the cell means, nodal-broadcast
        (the overflow policy's update)."""
        sol = self.solver
        means = self.cell_means(u)  # [V, *grid]; var axis 0
        new = means
        for d in range(sol.dim):
            lam = dt / sol._dxs[d]
            ax = 1 + d
            up = torch.roll(means, -1, ax)  # +d neighbour
            dn = torch.roll(means, 1, ax)  # -d neighbour

            def flux(Q):
                return sol.flux_fn(Q, d, 0)

            def eig(Q):
                return sol.max_eigenvalue_fn(Q, d, 0)

            s_hi = torch.maximum(eig(means), eig(up))[None]
            s_lo = torch.maximum(eig(dn), eig(means))[None]
            fhat_hi = 0.5 * (flux(means) + flux(up)) - 0.5 * s_hi * (up - means)
            fhat_lo = 0.5 * (flux(dn) + flux(means)) - 0.5 * s_lo * (means - dn)
            new = new - lam * (fhat_hi - fhat_lo)
        return self._broadcast_means(new, u)

    # --------------------------------------------- row-granular gathered path

    def _gather_tables_row(self, troubled):
        """Row tables: one slot per LAST-axis row containing any troubled
        cell, lowest row first, at most ``troubled_capacity``.  Indices run
        over the flattened leading grid axes (``R_n`` rows); ``row`` holds
        the sentinel ``R_n`` in inactive slots.  The active slots are the
        prefix ``k < n_active``; ``n_active`` is a 0-d tensor, so no host
        synchronisation reads it.  All int64, on the mask's device."""
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
        nb_slot, nb_row = [], []
        for d in range(sol.dim - 1):
            coord = (row_safe // strides[d]) % lead_grid[d]
            span = lead_grid[d] * strides[d]
            per_nb, per_row = [], []
            for sh in (-1, 1):
                moved = coord + sh
                flat_nb = row_safe + sh * strides[d]
                flat_nb = torch.where(moved < 0, flat_nb + span, flat_nb)
                flat_nb = torch.where(moved >= lead_grid[d], flat_nb - span, flat_nb)
                per_nb.append(slot_of[flat_nb])
                per_row.append(flat_nb)
            nb_slot.append(torch.stack(per_nb, dim=-1))
            nb_row.append(torch.stack(per_row, dim=-1))
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
        (rows span the whole periodic axis); the other directions take the
        neighbour slot's edge layer where that row is gathered and the
        neighbour row's projected DG edge layer where it is not.  Returns
        the reconstructed nodal rows and the per-direction ``(g_lo, g_hi)``
        transverse-mean cell-boundary fluxes ``[V, K, L]``."""
        sol = self.solver
        n_sub = self.n_sub
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
            else:
                ghost_hi = torch.roll(first, -1, L_ax)
                ghost_lo = torch.roll(last, 1, L_ax)
            s, g_lo, g_hi = sweep(d, s, ghost_lo.contiguous(), ghost_hi.contiguous())
            g_fluxes.append((g_lo, g_hi))
        return self._reconstruct_gathered(s), g_fluxes

    def _row_sweep_math(self, s, ghost_lo, ghost_hi, d, dt):
        """One directional Rusanov sweep on the gathered row batch
        ``[sub.., V, K, L]``, with the ghost layers already built — the
        plain version of the ``subcell_row_sweep`` kernel
        (``csrc/subcell.cu``).  Returns ``(s_new, g_lo, g_hi)``, the ``g``'s
        the transverse-mean cell-boundary fluxes ``[V, K, L]``."""
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
        fhat_hi = 0.5 * (F + F_plus) - 0.5 * s_hi * (u_plus - s)
        fhat_lo = 0.5 * (F_minus + F) - 0.5 * s_lo * (s - u_minus)
        other_sub = tuple(a if a < d else a - 1 for a in range(D) if a != d)
        g_hi = torch.mean(fhat_hi.select(d, n_sub - 1), dim=other_sub)
        g_lo = torch.mean(fhat_lo.select(d, 0), dim=other_sub)
        return s - lam * (fhat_hi - fhat_lo), g_lo, g_hi

    def _reconstruct_gathered(self, s):
        """Subcell means -> nodal on the slot batch, with the cell-mean
        conservation fix (the quadrature mean equals the subcell mean)."""
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
        (identical values where both rows are gathered).  Dropped writes go
        to a scratch row past the last."""
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
                tgt = torch.where(tables["active"], tables["nb_row"][:, d, 0], R_n)
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
        return best

    def _match_interface_fluxes(self, candidate, dg_fluxes, fv_fluxes, troubled, dt):
        """Make mixed DG/FV faces single-valued: untroubled cells beside a
        troubled neighbour replace their DG face flux with the (constant)
        transverse mean the troubled side used."""
        sol = self.solver
        nn_ = sol.n_nodes
        out = candidate
        for d in range(sol.dim):
            lam = dt / sol._dxs[d]
            node_ax = sol.node_axis(d)
            face_grid_ax = sol.grid_axis(d) - 1
            fhat_dg = dg_fluxes[d]  # [nodes^(dim-1), V, *grid]
            G = fv_fluxes[d].reshape((1,) * (sol.dim - 1) + tuple(fv_fluxes[d].shape))
            mixed_hi = (~troubled) & torch.roll(troubled, -1, d)
            mixed_lo = (~troubled) & torch.roll(troubled, 1, d)

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

    def step(self, u, dt, return_face_fluxes: bool = False, troubled_transform=None):
        """One limited step; a fresh tensor.

        ``return_face_fluxes=True`` also returns the per-direction
        EFFECTIVE high-face fluxes of the limited update: the subcell FV
        transverse mean on every face touching a troubled cell, the nodal
        DG Rusanov flux elsewhere.  ``troubled_transform`` (the JAX AMR
        pool's hook) is not ported and raises unless None."""
        if troubled_transform is not None:
            raise SemanticError(
                "troubled_transform (the AMR pool's hook) is not ported to "
                "exahype_tpu_torch yet; see ROADMAP.md, Queue 1 item 11"
            )
        sol = self.solver
        candidate, dg_fluxes = self._stepper().step(u, dt, return_face_fluxes=True)
        troubled_raw = self.troubled_mask(u, candidate)  # [*grid]
        tables = self._gather_tables_row(troubled_raw)
        troubled = tables["mask"]
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
        eff = []
        for d in range(sol.dim):
            fhat_dg = dg_fluxes[d]
            G = fv_fluxes[d].reshape((1,) * (sol.dim - 1) + tuple(fv_fluxes[d].shape))
            either = troubled | torch.roll(troubled, -1, d)
            shape = (1,) * (fhat_dg.dim() - either.dim()) + tuple(either.shape)
            eff.append(torch.where(either.reshape(shape), G.expand(fhat_dg.shape), fhat_dg))
        return out, eff

    def run(self, u, n_steps: int, dt):
        for _ in range(n_steps):
            u = self.step(u, dt)
        return u
