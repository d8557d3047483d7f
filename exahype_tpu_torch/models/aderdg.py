"""ADER-DG solver, periodic flux-form path (PyTorch, eager).

Port of ``exahype_tpu/models/aderdg.py::ADERDGSolver`` on the paths the
benchmarks take: the space-time Picard predictor (``bench.py::main``) or
the Cauchy–Kovalewski predictor with frozen material slots
(``predictor_mode="ck"``, ``bench.py::bench_ck``), the time-averaged
volume integral, the Rusanov face solve (with an optional
``dissipation_mask``) and the corrector on a periodic Cartesian grid.  On
the Picard path it also carries the algebraic source ``source_fn``, the
non-conservative product ``ncp_fn`` (strong-form volume term,
path-conservative face fluctuations) and the fused right-hand side
``rhs_all_fn`` of big NCP systems (the Z4 step, ``models/z4.py``).  It is
the plain version of the CUDA kernel path (``models/aderdg_cuda.py``) and
the path every CPU tensor takes.

Layout (SoA-P, the JAX package's): state ``[n_1..n_d (node axes), n_vars,
g_1..g_d (cell-grid axes)]``, so states pass between the two packages
unchanged.  The step is written as the two halves the CUDA kernels
compute — :meth:`ADERDGSolver.predictor_volume` (cell-local) and
:meth:`ADERDGSolver.face_surface` (neighbour faces) — and the face data
between them is one tensor ``[dim, 4, n^(dim-1), n_vars, *grid]`` holding
``(q_lo, q_hi, f_lo, f_hi)`` per axis, each in the JAX package's face
layout.

Options of the JAX solver that are not ported yet raise
:class:`SemanticError` (see ``ROADMAP.md``, Queue 1 item 2); so does any CK
combination with sources, non-conservative products or walls.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from exahype_tpu_torch.models import euler
from exahype_tpu_torch.models.dg import DGOperators
from exahype_tpu_torch.utils.device import resolve_device
from exahype_tpu_torch.utils.errors import SemanticError


def _apply(mat, x, axis):
    """Contract ``mat[i, j] x[..., j, ...]`` along ``axis``."""
    out = torch.tensordot(mat.to(x.dtype), x, dims=([1], [axis]))
    return torch.movedim(out, 0, axis)


def _project(vec, x, axis):
    """Contract a vector along ``axis`` (face extrapolation / time average)."""
    return torch.tensordot(vec.to(x.dtype), x, dims=([0], [axis]))


@dataclasses.dataclass(frozen=True)
class PhysicsTag:
    """What a physics callback computes, so a kernel wrapper can recognise
    the pair it has compiled in (``models/aderdg_cuda.py``): a name, the
    dimension, the variable count and the physics' parameters (Euler's
    ``(gamma,)``; none for ``elastic3d_het``)."""

    name: str
    dim: int
    n_real: int
    params: tuple = ()

    @property
    def gamma(self) -> float:
        """Euler's adiabatic index."""
        if self.name != "euler":
            raise AttributeError(f"{self.name} physics has no gamma")
        return self.params[0]


def euler_physics(dim: int, n_real: int = 5, gamma: float = euler.GAMMA):
    """(flux_fn, max_eigenvalue_fn) for compressible Euler in this layout,
    each tagged ``.physics = PhysicsTag("euler", dim, n_real, gamma)``."""

    def flux(Q, axis, var_axis):
        return euler.flux(
            Q, axis, dim=dim, n_real=n_real, gamma=gamma, var_axis=var_axis
        )

    def eig(Q, axis, var_axis):
        return euler.max_eigenvalue(
            Q, axis, dim=dim, gamma=gamma, var_axis=var_axis
        )

    tag = PhysicsTag("euler", int(dim), int(n_real), (float(gamma),))
    flux.physics = tag
    eig.physics = tag
    return flux, eig


#: Options of the JAX ``ADERDGSolver`` the port does not carry yet, with
#: the value that means "off".  Any other value raises.
UNPORTED_OPTIONS = {
    "boundary": "periodic",
    "farfield_state": None,
    "dirichlet_fn": None,
    "reflect_fn": None,
    "reflect_flux_fn": None,
    "wall_axes": None,
    "visc_flux_fn": None,
    "visc_eigenvalue_fn": None,
    "reuse_last_flux": False,
}
#: Options of the JAX ``ADERDGSolver`` the port carries, by name.
PORTED_OPTIONS = (
    "predictor_mode", "ck_material_slots", "dissipation_mask",
    "source_fn", "ncp_fn", "rhs_all_fn",
)
#: The ported options that are physics callbacks (a JAX solver's are JAX
#: functions, which the port cannot call).
CALLBACK_OPTIONS = ("source_fn", "ncp_fn", "rhs_all_fn")


class ADERDGSolver(nn.Module):
    """ADER-DG on a periodic Cartesian grid of cells (SoA-P layout).

    The DG operators are float64 NumPy at construction
    (:class:`DGOperators`) and live as buffers in ``dtype`` on ``device``
    (the CUDA card when ``device`` is None: ``device="cpu"`` asks for the
    CPU);
    they are cast to the state's dtype where applied, as the JAX package
    casts them.  The keyword options of the JAX solver that are not ported
    are accepted so a configuration carries over by name, and raise
    :class:`SemanticError` unless they hold their "off" value.

    ``predictor_mode="ck"`` takes the Cauchy–Kovalewski predictor, for
    linear systems; ``ck_material_slots`` names variables that are frozen
    in time (injected from the state, zero time derivative);
    ``dissipation_mask`` weighs the Rusanov jump term per variable.

    ``source_fn(Q, var_axis)``, ``ncp_fn(Q, gradQ_d, axis, var_axis)`` and
    ``rhs_all_fn(Q, grads, var_axis)`` keep the JAX solver's contract
    (periodic Picard path only): the source enters every Picard node and
    the corrector as ``dt·s̄``; the NCP enters the predictor per axis, the
    corrector as the strong-form volume term and the faces as the
    path-conservative half-fluctuations ``½·B(q̃)·Δq``; ``rhs_all_fn``
    (``S − Σ_d B_d·∂_d Q`` from the physical gradients) replaces the source
    and per-axis NCP evaluations of the predictor and, with ``ncp_fn``, the
    corrector's volume term.  It receives contiguous tensors.
    """

    def __init__(
        self,
        dim: int,
        order: int,
        n_vars: int,
        grid_shape: tuple,
        flux_fn: Callable,
        max_eigenvalue_fn: Callable,
        dx: float | tuple = 1.0,
        picard_iters: int | None = None,
        basis: str = "legendre",
        *,
        device=None,
        dtype: torch.dtype = torch.float64,
        predictor_mode: str = "picard",
        ck_material_slots: tuple | None = None,
        dissipation_mask: tuple | None = None,
        source_fn: Callable | None = None,
        ncp_fn: Callable | None = None,
        rhs_all_fn: Callable | None = None,
        **options,
    ):
        super().__init__()
        for name, value in options.items():
            if name not in UNPORTED_OPTIONS:
                raise TypeError(f"unexpected keyword argument {name!r}")
            off = UNPORTED_OPTIONS[name]
            if value is not None if off is None else value != off:
                raise SemanticError(
                    f"{name}={value!r} is not ported to exahype_tpu_torch yet "
                    "(only the periodic flux-form Picard and CK paths are); "
                    "see ROADMAP.md, Queue 1 item 2"
                )
        if predictor_mode not in ("picard", "ck"):
            raise SemanticError(
                f"predictor_mode must be 'picard' or 'ck', got {predictor_mode!r}"
            )
        hooks = {"source_fn": source_fn, "ncp_fn": ncp_fn, "rhs_all_fn": rhs_all_fn}
        for name, fn in hooks.items():
            if fn is not None and predictor_mode == "ck":
                raise SemanticError(
                    f"{name} with predictor_mode='ck' is not ported to "
                    "exahype_tpu_torch yet (only the Picard path carries it); "
                    "see ROADMAP.md, Queue 1 item 6"
                )
        if ck_material_slots is not None:
            if predictor_mode != "ck":
                raise SemanticError(
                    "ck_material_slots only applies to predictor_mode='ck'"
                )
            ck_material_slots = tuple(int(k) for k in ck_material_slots)
            if any(k < 0 or k >= n_vars for k in ck_material_slots):
                raise SemanticError(
                    f"ck_material_slots must be variable indices in [0, {n_vars})"
                )
        if dissipation_mask is not None:
            dissipation_mask = tuple(float(m) for m in dissipation_mask)
            if len(dissipation_mask) != n_vars:
                raise SemanticError(
                    f"dissipation_mask needs one entry per variable ({n_vars}), "
                    f"got {len(dissipation_mask)}"
                )
        if dim not in (2, 3):
            raise SemanticError(f"dim must be 2 or 3, got {dim}")
        grid_shape = tuple(int(g) for g in grid_shape)
        if len(grid_shape) != dim:
            raise SemanticError("grid_shape must have one entry per dim")
        if basis not in ("legendre", "lobatto"):
            raise SemanticError(
                f"basis must be 'legendre' or 'lobatto', got {basis!r}"
            )
        self.dim = int(dim)
        self.order = int(order)
        self.n_vars = int(n_vars)
        self.grid_shape = grid_shape
        self.flux_fn = flux_fn
        self.max_eigenvalue_fn = max_eigenvalue_fn
        self.dx = dx
        self.basis = basis
        self.predictor_mode = predictor_mode
        self.ck_material_slots = ck_material_slots
        self.dissipation_mask = dissipation_mask
        self.source_fn = source_fn
        self.ncp_fn = ncp_fn
        self.rhs_all_fn = rhs_all_fn
        self.ops = DGOperators(self.order, basis=basis)
        self.picard_iters = (
            self.order + 1 if picard_iters is None else int(picard_iters)
        )
        if isinstance(dx, (tuple, list)):
            if len(dx) != dim:
                raise SemanticError("dx tuple must have one entry per dim")
            self._dxs = tuple(float(v) for v in dx)
        else:
            self._dxs = (float(dx),) * dim
        device = resolve_device(device)
        ops = self.ops
        for name, arr in (
            ("D", ops.D),
            ("K1inv", ops.K1inv),
            ("Kvol", ops.Kvol),
            ("weights", ops.weights),
            ("phi0", ops.phi0),
            ("phi1", ops.phi1),
            ("phi0_w", ops.phi0 / ops.weights),
            ("phi1_w", ops.phi1 / ops.weights),
        ):
            self.register_buffer(
                name, torch.as_tensor(arr, dtype=dtype, device=device)
            )
        # The var-axis masks of the CK material slots (bool) and of the
        # dissipation (float64), shaped to broadcast over a state
        # (material) and over a face array (dissipation).
        ck_mask = dmask = None
        if ck_material_slots is not None:
            ck_mask = np.zeros(n_vars, bool)
            ck_mask[list(ck_material_slots)] = True
            shape = [1] * (2 * self.dim + 1)
            shape[self.var_axis] = n_vars
            ck_mask = torch.as_tensor(ck_mask, device=device).reshape(shape)
        if dissipation_mask is not None:
            shape = [1] * (2 * self.dim)
            shape[self.var_axis - 1] = n_vars
            dmask = torch.as_tensor(
                dissipation_mask, dtype=torch.float64, device=device
            ).reshape(shape)
        self.register_buffer("ck_mask", ck_mask)
        self.register_buffer("dmask", dmask)

    # ------------------------------------------------------------ structure

    @property
    def n_nodes(self) -> int:
        return self.order + 1

    @property
    def state_shape(self) -> tuple[int, ...]:
        return (self.n_nodes,) * self.dim + (self.n_vars,) + self.grid_shape

    @property
    def face_shape(self) -> tuple[int, ...]:
        """Shape of the face tensor between :meth:`predictor_volume` and
        :meth:`face_surface`: ``[dim, 4 (q_lo, q_hi, f_lo, f_hi),
        n^(dim-1), n_vars, *grid]``."""
        return (self.dim, 4, self.n_nodes ** (self.dim - 1), self.n_vars) + (
            self.grid_shape
        )

    @property
    def face_flux_shape(self) -> tuple[int, ...]:
        """Shape of one axis's face data and high-face fluxes: the node axes
        other than the face normal, then ``n_vars`` and the cell grid."""
        return (self.n_nodes,) * (self.dim - 1) + (self.n_vars,) + self.grid_shape

    def node_axis(self, d: int) -> int:
        return d

    @property
    def var_axis(self) -> int:
        return self.dim

    def grid_axis(self, d: int) -> int:
        return self.dim + 1 + d

    def dofs(self) -> int:
        return int(np.prod(self.grid_shape)) * self.n_nodes**self.dim * self.n_vars

    # ------------------------------------------------------------- predictor

    def predictor(self, u, dt):
        """The time-averaged state ``qbar`` and time-averaged fluxes
        ``fbar[d]`` — and, with ``source_fn``, the time-averaged source
        ``sbar`` as a third element, as the JAX solver returns them: the
        Picard iteration, or the Cauchy–Kovalewski recursion with
        ``predictor_mode="ck"``."""
        if self.predictor_mode == "ck":
            return self._predictor_ck(u, dt)
        return self._predictor_picard(u, dt)

    def _predictor_ck(self, u, dt):
        """Cauchy–Kovalewski predictor (the JAX ``_predictor_ck``, in its
        operation order): the Taylor terms ``q_k = (dt/k)·L(q_{k-1})`` of N
        applications of the spatial operator ``L(v) = −Σ_d D·F_d(v)/dx_d``
        on the spatial nodal array, with the material slots injected from
        ``u`` before and zeroed after each application; by linearity
        ``q̄ = Σ_k q_k/(k+1)`` and ``F̄_d = F_d(q̄)``."""
        va = self.var_axis
        mat = self.ck_mask

        def L(v):
            if mat is not None:
                v = torch.where(mat, u, v)
            rhs = None
            for d in range(self.dim):
                F = self.flux_fn(v, d, va)
                term = -_apply(self.D, F, axis=self.node_axis(d)) / self._dxs[d]
                rhs = term if rhs is None else rhs + term
            if mat is not None:
                # d/dt of a frozen material slot is identically zero.
                rhs = torch.where(mat, 0.0, rhs)
            return rhs

        qk = u
        qbar = u  # k = 0 term of Σ q_k/(k+1)
        for k in range(1, self.n_nodes):
            qk = (dt / k) * L(qk)
            qbar = qbar + qk / (k + 1)
        fbar = [self.flux_fn(qbar, d, va) for d in range(self.dim)]
        return qbar, fbar

    def _grads(self, x, base_axis: int):
        """Physical gradients ``(∂x/∂x_e)_e`` of the DG polynomial ``x``
        (node axes from ``base_axis``), each contiguous: the layout the
        ``rhs_all_fn`` kernel reads."""
        return tuple(
            (_apply(self.D, x, axis=base_axis + self.node_axis(e)) / self._dxs[e]).contiguous()
            for e in range(self.dim)
        )

    def _predictor_picard(self, u, dt):
        """Picard iteration; returns the time-averaged state ``qbar``,
        time-averaged fluxes ``fbar[d]`` and, with ``source_fn``, source
        ``sbar``.  Space-time arrays carry a leading time-node axis (all
        state axes shift by one)."""
        nn_ = self.n_nodes
        va = 1 + self.var_axis  # var axis inside space-time arrays
        tshape = (nn_,) + (1,) * u.dim()
        q = u.unsqueeze(0).expand((nn_,) + tuple(u.shape))
        # θ_σ(0)·u with a leading time-node axis, broadcast over cells.
        f0u = self.phi0.to(u.dtype).reshape(tshape) * u.unsqueeze(0)
        w_t = self.weights.to(u.dtype).reshape(tshape)
        K1inv = self.K1inv.to(u.dtype)
        per_axis_ncp = self.ncp_fn is not None and self.rhs_all_fn is None
        for _ in range(self.picard_iters):
            rhs = f0u
            for d in range(self.dim):
                lam = dt / self._dxs[d]
                F = self.flux_fn(q, d, va)
                dF = _apply(self.D, F, axis=1 + self.node_axis(d))
                rhs = rhs - lam * w_t * dF
                if per_axis_ncp:
                    dq = _apply(self.D, q, axis=1 + self.node_axis(d))
                    rhs = rhs - lam * w_t * self.ncp_fn(q, dq, d, va)
            if self.rhs_all_fn is not None:
                # One fused evaluation replaces the source and the dim NCP
                # products (q of the first iteration is a broadcast view).
                rhs = rhs + dt * w_t * self.rhs_all_fn(q.contiguous(), self._grads(q, 1), va)
            elif self.source_fn is not None:
                rhs = rhs + dt * w_t * self.source_fn(q, va)
            q = torch.tensordot(K1inv, rhs, dims=([1], [0]))
        qbar = _project(self.weights, q, 0)
        fbar = [
            _project(self.weights, self.flux_fn(q, d, va), 0)
            for d in range(self.dim)
        ]
        if self.source_fn is not None:
            return qbar, fbar, _project(self.weights, self.source_fn(q, va), 0)
        return qbar, fbar

    # ------------------------------------------------------------- corrector

    def predictor_volume(self, u, dt):
        """Cell-local half of the step (the plain version of the
        ``aderdg_predictor_volume`` kernel): predictor, volume terms
        ``new = u + dt·s̄ + Σ_d λ_d·Kvol·F̄_d`` (and the NCP's strong-form
        volume term), and the face projections of q̄ and F̄_d for every
        axis.  Returns ``(new, faces)`` (see :attr:`face_shape`)."""
        pred = self.predictor(u, dt)
        qbar, fbar = pred[:2]
        new = u + dt * pred[2] if self.source_fn is not None else u
        va = self.var_axis
        if self.ncp_fn is not None and self.rhs_all_fn is not None:
            # Strong-form NCP volume term, fused: −dt·Σ_d B_d(q̄)·∂_d q̄ =
            # dt·[rhs_all(q̄, ∇q̄) − rhs_all(q̄, 0)].
            zeros = (torch.zeros_like(qbar),) * self.dim
            new = new + dt * (
                self.rhs_all_fn(qbar, self._grads(qbar, 0), va)
                - self.rhs_all_fn(qbar, zeros, va)
            )
        faces = []
        for d in range(self.dim):
            lam = dt / self._dxs[d]
            na = self.node_axis(d)
            # Volume integral: (λ/w_i) Σ_j w_j D[j,i] F̄_j along axis d.
            new = new + lam * _apply(self.Kvol, fbar[d], axis=na)
            if self.ncp_fn is not None and self.rhs_all_fn is None:
                # Strong-form NCP volume term −λ·B(q̄)·∂_d q̄.
                new = new - lam * self.ncp_fn(qbar, _apply(self.D, qbar, axis=na), d, va)
            faces.append(torch.stack([
                _project(self.phi0, qbar, na),
                _project(self.phi1, qbar, na),
                _project(self.phi0, fbar[d], na),
                _project(self.phi1, fbar[d], na),
            ]))
        return new, torch.stack(faces).reshape(self.face_shape)

    def face_surface(self, new, faces, dt, return_face_fluxes: bool = False):
        """Neighbour half of the step (the plain version of the face stage,
        ``aderdg_face_flux`` + ``aderdg_surface_update``): the Rusanov flux
        of every face and the surface update, axis by axis.  Returns the
        updated state (a new tensor; ``new`` is not modified), and with
        ``return_face_fluxes`` also each axis's high-face fluxes (see
        :meth:`face_update`)."""
        fshape = self.face_flux_shape
        fluxes = []
        for d in range(self.dim):
            q_lo, q_hi, f_lo, f_hi = (
                faces[d, k].reshape(fshape) for k in range(4)
            )
            new, fhat_hi = self.face_update(new, q_lo, q_hi, f_lo, f_hi, d, dt)
            fluxes.append(fhat_hi)
        if return_face_fluxes:
            return new, fluxes
        return new

    def step(self, u, dt, return_face_fluxes: bool = False):
        """One ADER-DG time step (predictor + volume + Riemann + corrector).

        ``return_face_fluxes=True`` also returns the per-direction high-face
        Rusanov fluxes ``fhat_hi`` (:attr:`face_flux_shape` each), as the
        JAX solver does, for the limiter's interface matching.

        The JAX solver interleaves each axis's volume and surface terms;
        here all volume terms come first, as in the kernels, which moves
        the sum's rounding only."""
        new, faces = self.predictor_volume(u, dt)
        return self.face_surface(new, faces, dt, return_face_fluxes)

    def face_update(self, new, q_lo, q_hi, f_lo, f_hi, d, dt):
        """Riemann solve + surface (and NCP-fluctuation) corrector update
        for direction ``d`` from face-extrapolated time-averaged state/flux
        (periodic neighbours).  Returns ``(new, fhat_hi)``: the updated
        state and the Rusanov flux through each cell's high face, nodal
        over the transverse node axes (:attr:`face_flux_shape`)."""
        fhat_hi = self.interface_flux(q_lo, q_hi, f_lo, f_hi, d)
        new = self.surface_term(new, fhat_hi, d, dt)
        if self.ncp_fn is not None:
            # Path-conservative face fluctuations: the central parts
            # ½·B(q̃)·Δq at the segment midpoint q̃ go one to each side (the
            # ±½sΔq dissipation is already in the Rusanov f̂).
            lam = dt / self._dxs[d]
            node_ax = self.node_axis(d)
            face_grid_ax = self.grid_axis(d) - 1
            phi1_w, phi0_w = self._surface_weights(new, d)
            q_plus = torch.roll(q_lo, -1, face_grid_ax)
            mid = 0.5 * (q_hi + q_plus)
            half = 0.5 * self.ncp_fn(mid, q_plus - q_hi, d, self.var_axis - 1)
            half_lo = torch.roll(half, 1, face_grid_ax)
            new = new - lam * (
                phi1_w * half.unsqueeze(node_ax)
                + phi0_w * half_lo.unsqueeze(node_ax)
            )
        return new, fhat_hi

    def interface_flux(self, q_lo, q_hi, f_lo, f_hi, d):
        """The Rusanov flux through each cell's high face along ``d``
        (:attr:`face_flux_shape`; the plain version of the
        ``aderdg_face_flux`` kernel, one axis): left state my high face,
        right state the +d neighbour's low face."""
        face_grid_ax = self.grid_axis(d) - 1
        face_va = self.var_axis - 1
        q_plus = torch.roll(q_lo, -1, face_grid_ax)
        f_plus = torch.roll(f_lo, -1, face_grid_ax)
        s_hi = torch.maximum(
            self.max_eigenvalue_fn(q_hi, d, face_va),
            self.max_eigenvalue_fn(q_plus, d, face_va),
        ).unsqueeze(face_va)
        dq = q_plus - q_hi
        if self.dmask is not None:
            dq = dq * self.dmask.to(dq.dtype)
        return 0.5 * (f_hi + f_plus) - 0.5 * s_hi * dq

    def surface_term(self, new, fhat_hi, d, dt):
        """``new − (λ/w_i)(ℓ_i(1) F̂_hi − ℓ_i(0) F̂_lo)`` along ``d``, F̂_lo
        being the −d neighbour's F̂_hi (the plain version of the
        ``aderdg_surface_update`` kernel, one axis)."""
        lam = dt / self._dxs[d]
        node_ax = self.node_axis(d)
        fhat_lo = torch.roll(fhat_hi, 1, self.grid_axis(d) - 1)
        phi1_w, phi0_w = self._surface_weights(new, d)
        return new - lam * (
            phi1_w * fhat_hi.unsqueeze(node_ax)
            - phi0_w * fhat_lo.unsqueeze(node_ax)
        )

    def _surface_weights(self, new, d):
        """ℓ_i(1)/w_i and ℓ_i(0)/w_i along node axis ``d``, broadcastable
        against the state."""
        shape_i = [1] * new.dim()
        shape_i[self.node_axis(d)] = self.n_nodes
        return (self.phi1_w.to(new.dtype).reshape(shape_i),
                self.phi0_w.to(new.dtype).reshape(shape_i))

    # ------------------------------------------------------------- time loop

    def cfl_dt(self, u, cfl: float | None = None):
        """PNPM-style CFL: dt = cfl · dx / (λ_max · (2N+1)), with the JAX
        solver's order-aware default ``min(0.4, 1.5/(order+2))``.  Returns a
        0-d tensor on the state's device."""
        if cfl is None:
            cfl = min(0.4, 1.5 / (self.order + 2))
        r = None
        for d in range(self.dim):
            s_d = torch.max(self.max_eigenvalue_fn(u, d, self.var_axis))
            r_d = s_d / self._dxs[d]
            r = r_d if r is None else torch.maximum(r, r_d)
        return cfl / (r * (2 * self.order + 1))

    def run(self, u, n_steps: int, dt):
        for _ in range(n_steps):
            u = self.step(u, dt)
        return u

    # -------------------------------------------------------------- helpers

    def total_mass(self, u):
        """Quadrature integral of each variable (conservation check)."""
        out = u
        # Project node axes last-to-first so remaining axis indices stay valid.
        for d in reversed(range(self.dim)):
            out = _project(self.weights, out, self.node_axis(d))
        # out: [n_vars, *grid]
        vol = float(np.prod(self._dxs))
        return torch.sum(out, dim=tuple(range(1, 1 + self.dim))) * vol

    def nodes_meshgrid(self):
        """Physical node coordinates (float64 NumPy): one array per dim,
        broadcastable to the state shape (singleton var axis)."""
        full = []
        for d in range(self.dim):
            cell_idx = np.arange(self.grid_shape[d])
            coords = (self.ops.nodes[:, None] + cell_idx[None, :]) * self._dxs[d]
            shape = [1] * (2 * self.dim + 1)
            shape[self.node_axis(d)] = self.n_nodes
            shape[self.grid_axis(d)] = self.grid_shape[d]
            full.append(coords.reshape(shape))
        return full
