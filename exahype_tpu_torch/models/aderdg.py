"""ADER-DG solver, periodic flux-form Picard path (PyTorch, eager).

Port of ``exahype_tpu/models/aderdg.py::ADERDGSolver`` on the path the
benchmark takes: space-time Picard predictor, time-averaged volume
integral, Rusanov face solve and corrector on a periodic Cartesian grid.
It is the plain version of the CUDA kernel path
(``models/aderdg_cuda.py``) and the path every CPU tensor takes.

Layout (SoA-P, the JAX package's): state ``[n_1..n_d (node axes), n_vars,
g_1..g_d (cell-grid axes)]``, so states pass between the two packages
unchanged.  The step is written as the two halves the CUDA kernels
compute — :meth:`ADERDGSolver.predictor_volume` (cell-local) and
:meth:`ADERDGSolver.face_surface` (neighbour faces) — and the face data
between them is one tensor ``[dim, 4, n^(dim-1), n_vars, *grid]`` holding
``(q_lo, q_hi, f_lo, f_hi)`` per axis, each in the JAX package's face
layout.

Options of the JAX solver that are not ported yet raise
:class:`SemanticError` (see ``ROADMAP.md``, Queue 1 item 2).
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
    the pair it has compiled in (``models/aderdg_cuda.py``)."""

    name: str
    dim: int
    n_real: int
    gamma: float


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

    tag = PhysicsTag("euler", int(dim), int(n_real), float(gamma))
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
    "dissipation_mask": None,
    "source_fn": None,
    "ncp_fn": None,
    "rhs_all_fn": None,
    "visc_flux_fn": None,
    "visc_eigenvalue_fn": None,
    "reuse_last_flux": False,
    "predictor_mode": "picard",
    "ck_material_slots": None,
}


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
                    "(only the periodic flux-form Picard path is); see "
                    "ROADMAP.md, Queue 1 item 2"
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
        """Picard iteration; returns the time-averaged state ``qbar`` and
        time-averaged fluxes ``fbar[d]``.  Space-time arrays carry a
        leading time-node axis (all state axes shift by one)."""
        nn_ = self.n_nodes
        va = 1 + self.var_axis  # var axis inside space-time arrays
        tshape = (nn_,) + (1,) * u.dim()
        q = u.unsqueeze(0).expand((nn_,) + tuple(u.shape))
        # θ_σ(0)·u with a leading time-node axis, broadcast over cells.
        f0u = self.phi0.to(u.dtype).reshape(tshape) * u.unsqueeze(0)
        w_t = self.weights.to(u.dtype).reshape(tshape)
        K1inv = self.K1inv.to(u.dtype)
        for _ in range(self.picard_iters):
            rhs = f0u
            for d in range(self.dim):
                lam = dt / self._dxs[d]
                F = self.flux_fn(q, d, va)
                dF = _apply(self.D, F, axis=1 + self.node_axis(d))
                rhs = rhs - lam * w_t * dF
            q = torch.tensordot(K1inv, rhs, dims=([1], [0]))
        qbar = _project(self.weights, q, 0)
        fbar = [
            _project(self.weights, self.flux_fn(q, d, va), 0)
            for d in range(self.dim)
        ]
        return qbar, fbar

    # ------------------------------------------------------------- corrector

    def predictor_volume(self, u, dt):
        """Cell-local half of the step (the plain version of the
        ``aderdg_predictor_volume`` kernel): predictor, volume integral
        ``new = u + Σ_d λ_d·Kvol·F̄_d``, and the face projections of q̄ and
        F̄_d for every axis.  Returns ``(new, faces)`` (see
        :attr:`face_shape`)."""
        qbar, fbar = self.predictor(u, dt)
        new = u
        faces = []
        for d in range(self.dim):
            lam = dt / self._dxs[d]
            na = self.node_axis(d)
            # Volume integral: (λ/w_i) Σ_j w_j D[j,i] F̄_j along axis d.
            new = new + lam * _apply(self.Kvol, fbar[d], axis=na)
            faces.append(torch.stack([
                _project(self.phi0, qbar, na),
                _project(self.phi1, qbar, na),
                _project(self.phi0, fbar[d], na),
                _project(self.phi1, fbar[d], na),
            ]))
        return new, torch.stack(faces).reshape(self.face_shape)

    def face_surface(self, new, faces, dt):
        """Neighbour half of the step (the plain version of the
        ``aderdg_face_surface`` kernel): the Rusanov flux of every face and
        the surface update, axis by axis.  Returns the updated state (a new
        tensor; ``new`` is not modified)."""
        fshape = (
            (self.n_nodes,) * (self.dim - 1) + (self.n_vars,) + self.grid_shape
        )
        for d in range(self.dim):
            q_lo, q_hi, f_lo, f_hi = (
                faces[d, k].reshape(fshape) for k in range(4)
            )
            new = self.face_update(new, q_lo, q_hi, f_lo, f_hi, d, dt)
        return new

    def step(self, u, dt):
        """One ADER-DG time step (predictor + volume + Riemann + corrector).

        The JAX solver interleaves each axis's volume and surface terms;
        here all volume terms come first, as in the kernels, which moves
        the sum's rounding only."""
        new, faces = self.predictor_volume(u, dt)
        return self.face_surface(new, faces, dt)

    def face_update(self, new, q_lo, q_hi, f_lo, f_hi, d, dt):
        """Riemann solve + surface corrector update for direction ``d``
        from face-extrapolated time-averaged state/flux (periodic
        neighbours).  Returns the updated state (the JAX solver also
        returns ``fhat_hi``, for the limiter, which is not ported)."""
        lam = dt / self._dxs[d]
        node_ax = self.node_axis(d)
        face_grid_ax = self.grid_axis(d) - 1
        face_va = self.var_axis - 1

        # Face between me and my +d neighbour: left state = my high face,
        # right state = the neighbour's low face.
        q_plus = torch.roll(q_lo, -1, face_grid_ax)
        f_plus = torch.roll(f_lo, -1, face_grid_ax)
        s_hi = torch.maximum(
            self.max_eigenvalue_fn(q_hi, d, face_va),
            self.max_eigenvalue_fn(q_plus, d, face_va),
        ).unsqueeze(face_va)
        dq = q_plus - q_hi
        fhat_hi = 0.5 * (f_hi + f_plus) - 0.5 * s_hi * dq
        # Face between my -d neighbour and me: that neighbour's fhat_hi.
        fhat_lo = torch.roll(fhat_hi, 1, face_grid_ax)

        # Surface contribution: −(λ/w_i)(ℓ_i(1) F̂_hi − ℓ_i(0) F̂_lo).
        shape_i = [1] * new.dim()
        shape_i[node_ax] = self.n_nodes
        phi1_w = self.phi1_w.to(new.dtype).reshape(shape_i)
        phi0_w = self.phi0_w.to(new.dtype).reshape(shape_i)
        new = new - lam * (
            phi1_w * fhat_hi.unsqueeze(node_ax)
            - phi0_w * fhat_lo.unsqueeze(node_ax)
        )
        return new

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
