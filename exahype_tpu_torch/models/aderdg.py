"""ADER-DG solver, flux-form path (PyTorch, eager).

Port of ``exahype_tpu/models/aderdg.py::ADERDGSolver`` on the paths the
benchmarks take: the space-time Picard predictor (``bench.py::main``) or
the Cauchy–Kovalewski predictor with frozen material slots
(``predictor_mode="ck"``, ``bench.py::bench_ck``), the time-averaged
volume integral, the Rusanov face solve (with an optional
``dissipation_mask``) and the corrector on a Cartesian grid that is
periodic or closed by domain walls (``boundary``: reflective, outflow,
farfield or dirichlet, on every axis or on ``wall_axes``).  On
either predictor it also carries the algebraic source ``source_fn``, the
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

The viscous fluxes ``visc_flux_fn`` / ``visc_eigenvalue_fn`` (the
compressible Navier–Stokes class, ``models/navier_stokes.py``) ride the
Picard predictor and the time averages on the polynomial's own gradients,
add the Gassner penalty to the face dissipation speed and the parabolic
term to ``cfl_dt``; on a walled viscous solver the face stage also takes
the viscous-only time-averaged flux on the wall planes (a side tensor, see
:meth:`ADERDGSolver.predictor_volume`).  ``reuse_last_flux`` is not ported
and raises :class:`SemanticError` naming ``ROADMAP.md``.

Also the port's copies of the JAX wall hooks: :func:`euler_reflect`,
:func:`euler_reflect_flux` (sign tables, ``.signs``, so the CUDA face stage
can recognise them) and :func:`make_dirichlet_fn` (NumPy).
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


def _shift(shift, x, sh, axis):
    """``x`` shifted by ``sh`` along ``axis``: the periodic ``torch.roll``,
    or the caller's ``shift(x, sh, axis)`` (a rank's edge exchange)."""
    if shift is None:
        return torch.roll(x, sh, axis)
    return shift(x, sh, axis)


def _replace_row(x, row, axis, pos):
    """``x`` with its index ``pos`` along ``axis`` replaced by ``row`` (a
    size-1 slice), out of place."""
    g = x.shape[axis]
    parts = [x.narrow(axis, 0, pos), row, x.narrow(axis, pos + 1, g - pos - 1)]
    return torch.cat([t for t in parts if t.shape[axis]], dim=axis)


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


def sign_reflect(signs):
    """A wall hook ``fn(Q, axis, var_axis) -> Q · S[axis]`` that multiplies
    the var axis by row ``axis`` of the sign table ``signs`` (``[dim,
    n_vars]``; the JAX ``elastic._sign_reflect``).  The table rides along as
    ``fn.signs`` (float64 NumPy), which is how the CUDA face stage
    (``models/aderdg_cuda.py``) recognises a hook it can compile in."""
    table = np.array(signs, dtype=np.float64)
    if table.ndim != 2:
        raise SemanticError(f"a sign table is [dim, n_vars], got shape {table.shape}")

    def reflect(Q, axis, var_axis):
        shape = [1] * Q.dim()
        shape[var_axis] = table.shape[1]
        return Q * torch.as_tensor(table[int(axis)], dtype=Q.dtype,
                                   device=Q.device).reshape(shape)

    reflect.signs = table
    return reflect


def _euler_signs(dim: int, n_vars: int | None, normal: float, other: float):
    n_vars = dim + 2 if n_vars is None else int(n_vars)
    table = np.full((dim, n_vars), other)
    for d in range(dim):
        table[d, d + 1] = normal  # the normal momentum slot
    return table


def euler_reflect(dim: int, n_vars: int | None = None):
    """Mirror ghost STATE for Euler walls: negate the normal momentum (the
    JAX ``euler_reflect``; ``n_vars`` defaults to ``dim + 2``).  A sign
    table (:func:`sign_reflect`); multiplying by ±1 is exact, so it gives
    the JAX hook's bits."""
    return sign_reflect(_euler_signs(dim, n_vars, -1.0, 1.0))


def euler_reflect_flux(dim: int, n_vars: int | None = None):
    """Mirror ghost FLUX for Euler walls, ``F(reflect(q)) = S·F(q)``: −1
    everywhere but +1 on the normal momentum (the JAX
    ``euler_reflect_flux``).  Mirroring the time-averaged face flux keeps
    the wall fluxes of mass and energy exactly zero."""
    return sign_reflect(_euler_signs(dim, n_vars, 1.0, -1.0))


def make_dirichlet_fn(state_fn: Callable, *, dim: int, order: int,
                      grid_shape: tuple, dx, wall_axes: tuple | None = None,
                      basis: str = "legendre"):
    """``dirichlet_fn(axis, side)`` for ``boundary="dirichlet"`` from a
    coordinate function ``state_fn(*coords) -> var-last state`` (NumPy,
    evaluated once per wall at the wall-face node positions), the JAX
    ``make_dirichlet_fn``.  Each row is in face-row convention: the node
    axes other than ``axis``, the var axis, the grid with ``axis`` cut to
    1.  The function carries ``.basis`` so the solver refuses rows made
    for the other basis."""
    n_nodes = order + 1
    nodes = np.asarray(DGOperators(order, basis=basis).nodes)
    dxs = (tuple(float(v) for v in dx) if isinstance(dx, (tuple, list))
           else (float(dx),) * dim)
    axes = tuple(range(dim)) if wall_axes is None else tuple(wall_axes)
    rows = {}
    for d in axes:
        for side in (0, 1):
            no_var = [n_nodes] * (dim - 1) + [
                1 if e == d else grid_shape[e] for e in range(dim)
            ]
            coords = []
            for e in range(dim):
                if e == d:
                    x = np.full(no_var, side * grid_shape[d] * dxs[e])
                else:
                    node_pos = e if e < d else e - 1
                    grid_pos = (dim - 1) + e
                    c = (nodes[:, None]
                         + np.arange(grid_shape[e])[None, :]) * dxs[e]
                    shape = [1] * len(no_var)
                    shape[node_pos] = n_nodes
                    shape[grid_pos] = grid_shape[e]
                    x = np.broadcast_to(c.reshape(shape), no_var)
                coords.append(x)
            row = np.asarray(state_fn(*coords))
            rows[(d, side)] = np.moveaxis(row, -1, dim - 1)

    def dirichlet_fn(axis, side):
        return rows[(int(axis), int(side))]

    dirichlet_fn.basis = basis
    return dirichlet_fn


#: Options of the JAX ``ADERDGSolver`` the port does not carry yet, with
#: the value that means "off" and where ``ROADMAP.md`` lists them.  Any
#: other value raises.
UNPORTED_OPTIONS = {
    "reuse_last_flux": False,
}
_UNPORTED_WHERE = {
    "reuse_last_flux": "Queue 1 (not to be ported: measured as a loss)",
}
BOUNDARIES = ("periodic", "reflective", "outflow", "farfield", "dirichlet")
#: Options of the JAX ``ADERDGSolver`` the port carries, by name.
PORTED_OPTIONS = (
    "predictor_mode", "ck_material_slots", "dissipation_mask",
    "source_fn", "ncp_fn", "rhs_all_fn",
    "boundary", "farfield_state", "dirichlet_fn", "reflect_fn",
    "reflect_flux_fn", "wall_axes", "visc_flux_fn", "visc_eigenvalue_fn",
)
#: The wall options that are callbacks (a JAX solver's are JAX functions,
#: which the port cannot call).
WALL_HOOKS = ("dirichlet_fn", "reflect_fn", "reflect_flux_fn")
#: The ported options that are physics callbacks (a JAX solver's are JAX
#: functions, which the port cannot call).
CALLBACK_OPTIONS = ("source_fn", "ncp_fn", "rhs_all_fn")
#: The viscous callbacks (the kernels carry them for the tagged Navier–Stokes
#: callbacks only, ``models/aderdg_cuda.py``).
VISCOUS_OPTIONS = ("visc_flux_fn", "visc_eigenvalue_fn")


class ADERDGSolver(nn.Module):
    """ADER-DG on a Cartesian grid of cells (SoA-P layout), periodic or
    closed by domain walls.

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
    (Picard path only): the source enters every Picard node and
    the corrector as ``dt·s̄``; the NCP enters the predictor per axis, the
    corrector as the strong-form volume term and the faces as the
    path-conservative half-fluctuations ``½·B(q̃)·Δq``; ``rhs_all_fn``
    (``S − Σ_d B_d·∂_d Q`` from the physical gradients) replaces the source
    and per-axis NCP evaluations of the predictor and, with ``ncp_fn``, the
    corrector's volume term.  It receives contiguous tensors.

    ``boundary`` and its options keep the JAX solver's contract and checks:
    ``"periodic"`` (default), ``"reflective"`` (needs ``reflect_fn`` and
    ``reflect_flux_fn``, the mirror ghost state and flux, e.g.
    :func:`euler_reflect` / :func:`euler_reflect_flux`), ``"outflow"``
    (the ghost is the cell's own face state and flux), ``"farfield"`` (the
    ghost is the constant ``farfield_state``, its flux F(ghost)) or
    ``"dirichlet"`` (``dirichlet_fn(axis, side)`` gives the ghost row, see
    :func:`make_dirichlet_fn`; its flux F(ghost)).  ``wall_axes`` names
    the grid axes that carry walls (None: all); the others stay periodic.
    The predictor is boundary-independent: walls only change the face
    stage (:meth:`face_update`).

    ``visc_flux_fn(Q, grads, axis, var_axis)`` and ``visc_eigenvalue_fn(Q,
    axis, var_axis)`` keep the JAX solver's contract and checks (set
    together; Picard only): the viscous flux, from the physical gradients
    of the space-time polynomial, joins the flux in every Picard iteration
    and in the time averages; the face dissipation speed gains the penalty
    2(2N+1)/dx_d·max(κ⁻, κ⁺); on a wall the ghost flux hook takes the
    advective part only and the interior one-sided viscous flux is added
    back; ``cfl_dt`` gains the parabolic term.
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
        boundary: str = "periodic",
        farfield_state: tuple | None = None,
        dirichlet_fn: Callable | None = None,
        reflect_fn: Callable | None = None,
        reflect_flux_fn: Callable | None = None,
        wall_axes: tuple | None = None,
        visc_flux_fn: Callable | None = None,
        visc_eigenvalue_fn: Callable | None = None,
        **options,
    ):
        super().__init__()
        for name, value in options.items():
            if name not in UNPORTED_OPTIONS:
                raise TypeError(f"unexpected keyword argument {name!r}")
            off = UNPORTED_OPTIONS[name]
            if value is not None if off is None else value != off:
                raise SemanticError(
                    f"{name}={value!r} is not ported to exahype_tpu_torch yet; "
                    f"see ROADMAP.md, {_UNPORTED_WHERE[name]}"
                )
        for name, off in UNPORTED_OPTIONS.items():
            setattr(self, name, off)
        if predictor_mode not in ("picard", "ck"):
            raise SemanticError(
                f"predictor_mode must be 'picard' or 'ck', got {predictor_mode!r}"
            )
        if (visc_flux_fn is None) != (visc_eigenvalue_fn is None):
            raise SemanticError(
                "visc_flux_fn and visc_eigenvalue_fn must be set together"
            )
        if predictor_mode == "ck" and visc_flux_fn is not None:
            raise SemanticError(
                "the Cauchy–Kovalewski (linear) predictor does not support "
                "viscous fluxes — use predictor_mode='picard'"
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
        self.visc_flux_fn = visc_flux_fn
        self.visc_eigenvalue_fn = visc_eigenvalue_fn
        self._set_walls(boundary, farfield_state, dirichlet_fn, reflect_fn,
                        reflect_flux_fn, wall_axes)
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

    def _set_walls(self, boundary, farfield_state, dirichlet_fn, reflect_fn,
                   reflect_flux_fn, wall_axes):
        """The JAX constructor's boundary checks and hook installation
        (``exahype_tpu/models/aderdg.py:345-455``)."""
        if boundary not in BOUNDARIES:
            raise SemanticError(f"unknown boundary {boundary!r}")
        if boundary == "dirichlet" and dirichlet_fn is None:
            raise SemanticError(
                "boundary='dirichlet' requires dirichlet_fn(axis, side)"
            )
        if dirichlet_fn is not None:
            fn_basis = getattr(dirichlet_fn, "basis", None)
            if fn_basis is not None and fn_basis != self.basis:
                raise SemanticError(
                    f"dirichlet_fn was built for basis {fn_basis!r} but the "
                    f"solver uses {self.basis!r} — pass basis={self.basis!r} "
                    "to make_dirichlet_fn so wall rows are evaluated at the "
                    "solver's node positions"
                )
        if boundary == "reflective" and (reflect_fn is None or reflect_flux_fn is None):
            raise SemanticError(
                "reflective boundary requires reflect_fn and reflect_flux_fn"
            )
        if boundary == "outflow":
            # Zero-gradient ghosts: the ghost state/flux is the cell's own
            # face state/flux (an all-ones sign table: exact).
            ones = np.ones((self.dim, self.n_vars))
            reflect_fn, reflect_flux_fn = sign_reflect(ones), sign_reflect(ones)
        if boundary == "farfield":
            if farfield_state is None or len(farfield_state) != self.n_vars:
                raise SemanticError(
                    "boundary='farfield' requires farfield_state with one "
                    f"entry per variable ({self.n_vars})"
                )
            farfield_state = tuple(float(v) for v in farfield_state)
            reflect_fn = self._farfield_ghost
            reflect_flux_fn = self._farfield_ghost_flux
        if wall_axes is not None:
            if boundary == "periodic":
                raise SemanticError(
                    "wall_axes requires a wall boundary ('reflective', "
                    "'outflow', 'farfield', or 'dirichlet')"
                )
            wall_axes = tuple(int(d) for d in wall_axes)
            if not wall_axes or any(d < 0 or d >= self.dim for d in wall_axes):
                raise SemanticError(
                    f"wall_axes must be non-empty axes in [0, {self.dim}), "
                    f"got {wall_axes}"
                )
        self.boundary = boundary
        self.farfield_state = farfield_state
        self.dirichlet_fn = dirichlet_fn
        self.reflect_fn = reflect_fn
        self.reflect_flux_fn = reflect_flux_fn
        self.wall_axes = wall_axes

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

    def is_wall(self, d: int) -> bool:
        """Whether grid axis ``d`` carries a domain wall (axes outside
        ``wall_axes`` stay periodic)."""
        return self.boundary != "periodic" and (
            self.wall_axes is None or d in self.wall_axes
        )

    def dofs(self) -> int:
        return int(np.prod(self.grid_shape)) * self.n_nodes**self.dim * self.n_vars

    @property
    def splits_wall_viscosity(self) -> bool:
        """Whether the face stage needs the viscous-only wall fluxes (a
        viscous solver with a wall): then :meth:`predictor_volume` returns
        them as its ``fvwall`` (else None), and :meth:`face_surface` takes
        them."""
        return self.visc_flux_fn is not None and any(
            self.is_wall(d) for d in range(self.dim))

    def wall_planes(self) -> dict:
        """Each wall axis's face-row shape (the other node axes, the var
        axis, the grid with the axis cut to 1), by axis in order."""
        return {
            d: (self.n_nodes,) * (self.dim - 1) + (self.n_vars,)
            + tuple(1 if e == d else g for e, g in enumerate(self.grid_shape))
            for d in range(self.dim) if self.is_wall(d)
        }

    def visc_wall_rows(self, fvwall) -> dict:
        """``{d: (fv_lo, fv_hi)}``: views of the side tensor ``fvwall`` of
        :meth:`predictor_volume`, each shaped like one face row of wall axis
        ``d``.  The layout is ``[side][wall axis][face row]``: side 0 holds
        the first row's low-face projections, side 1 the last row's
        high-face projections, the wall axes in order within a side."""
        planes = self.wall_planes()
        half = sum(int(np.prod(shape)) for shape in planes.values())
        rows, off = {}, 0
        for d, shape in planes.items():
            n = int(np.prod(shape))
            rows[d] = tuple(fvwall[side * half + off:side * half + off + n].view(shape)
                            for side in (0, 1))
            off += n
        return rows

    # ----------------------------------------------------------- wall ghosts

    def _farfield_ghost(self, Q, axis, var_axis):
        """The constant farfield state, broadcast to ``Q``'s shape."""
        shape = [1] * Q.dim()
        shape[var_axis] = self.n_vars
        st = torch.as_tensor(self.farfield_state, dtype=Q.dtype, device=Q.device)
        return st.reshape(shape).expand(Q.shape)

    def _farfield_ghost_flux(self, F, axis, var_axis):
        return self.flux_fn(self._farfield_ghost(F, axis, var_axis), axis, var_axis)

    def dirichlet_row(self, d: int, side: int, like):
        """The Dirichlet ghost row of wall ``(d, side)``, in ``like``'s dtype
        and device, broadcast to ``like``'s face-row shape."""
        g = torch.as_tensor(np.asarray(self.dirichlet_fn(d, side)), dtype=like.dtype,
                            device=like.device)
        return g.expand(like.shape)

    def _wall_ghost(self, row, d: int, side: int, var_axis: int):
        """Ghost STATE of the wall Riemann problem at ``(axis d, side)``
        given the interior face row: the reflect hook, or the Dirichlet
        row."""
        if self.boundary == "dirichlet":
            return self.dirichlet_row(d, side, row)
        return self.reflect_fn(row, d, var_axis)

    def _wall_ghost_flux(self, frow, d: int, side: int, var_axis: int):
        """Ghost FLUX at the wall: the reflect flux hook on the interior
        flux, or the flux of the Dirichlet row."""
        if self.boundary == "dirichlet":
            return self.flux_fn(self.dirichlet_row(d, side, frow), d, var_axis)
        return self.reflect_flux_fn(frow, d, var_axis)

    # ------------------------------------------------------------- predictor

    def predictor(self, u, dt, return_visc: bool = False):
        """The time-averaged state ``qbar`` and time-averaged fluxes
        ``fbar[d]`` — and, with ``source_fn``, the time-averaged source
        ``sbar`` as a third element, as the JAX solver returns them: the
        Picard iteration, or the Cauchy–Kovalewski recursion with
        ``predictor_mode="ck"``.  ``return_visc=True`` (viscous solvers)
        appends the viscous-only part ``fvbar[d]`` of the time-averaged
        fluxes."""
        if self.predictor_mode == "ck":
            # Viscosity is refused with CK at construction.
            return self._predictor_ck(u, dt)
        if return_visc and self.visc_flux_fn is None:
            raise SemanticError("return_visc requires visc_flux_fn")
        return self._predictor_picard(u, dt, return_visc)

    def _predictor_ck(self, u, dt):
        """Cauchy–Kovalewski predictor (the JAX ``_predictor_ck``, in its
        operation order): the Taylor terms ``q_k = (dt/k)·L(q_{k-1})`` of N
        applications of the spatial operator ``L(v) = −Σ_d D·F_d(v)/dx_d``
        (minus each axis's ``ncp_fn(v, D·v)/dx_d``), plus ``rhs_all_fn(v,
        ∇v)`` or else ``source_fn(v)``, on the spatial nodal array, with the
        material slots injected from ``u`` before and zeroed after each
        application; by linearity ``q̄ = Σ_k q_k/(k+1)``, ``F̄_d = F_d(q̄)``
        and, with ``source_fn``, ``S̄ = S(q̄)`` as a third element."""
        va = self.var_axis
        mat = self.ck_mask
        per_axis_ncp = self.ncp_fn is not None and self.rhs_all_fn is None

        def L(v):
            if mat is not None:
                v = torch.where(mat, u, v)
            rhs = None
            for d in range(self.dim):
                F = self.flux_fn(v, d, va)
                term = -_apply(self.D, F, axis=self.node_axis(d)) / self._dxs[d]
                rhs = term if rhs is None else rhs + term
                if per_axis_ncp:
                    dq = _apply(self.D, v, axis=self.node_axis(d))
                    rhs = rhs - self.ncp_fn(v, dq, d, va) / self._dxs[d]
            if self.rhs_all_fn is not None:
                rhs = rhs + self.rhs_all_fn(v.contiguous(), self._grads(v, 0), va)
            elif self.source_fn is not None:
                rhs = rhs + self.source_fn(v, va)
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
        if self.source_fn is not None:
            return qbar, fbar, self.source_fn(qbar, va)
        return qbar, fbar

    def _grads(self, x, base_axis: int):
        """Physical gradients ``(∂x/∂x_e)_e`` of the DG polynomial ``x``
        (node axes from ``base_axis``), each contiguous: the layout the
        ``rhs_all_fn`` kernel reads."""
        return tuple(
            (_apply(self.D, x, axis=base_axis + self.node_axis(e)) / self._dxs[e]).contiguous()
            for e in range(self.dim)
        )

    def _predictor_picard(self, u, dt, return_visc: bool = False):
        """Picard iteration; returns the time-averaged state ``qbar``,
        time-averaged fluxes ``fbar[d]``, with ``source_fn`` the source
        ``sbar`` and with ``return_visc`` the viscous-only fluxes
        ``fvbar[d]``.  Space-time arrays carry a leading time-node axis (all
        state axes shift by one).  The viscous flux takes the gradients of
        the iterate (the time averages: of the final q)."""
        nn_ = self.n_nodes
        va = 1 + self.var_axis  # var axis inside space-time arrays
        tshape = (nn_,) + (1,) * u.dim()
        q = u.unsqueeze(0).expand((nn_,) + tuple(u.shape))
        # θ_σ(0)·u with a leading time-node axis, broadcast over cells.
        f0u = self.phi0.to(u.dtype).reshape(tshape) * u.unsqueeze(0)
        w_t = self.weights.to(u.dtype).reshape(tshape)
        K1inv = self.K1inv.to(u.dtype)
        per_axis_ncp = self.ncp_fn is not None and self.rhs_all_fn is None
        visc = self.visc_flux_fn
        for _ in range(self.picard_iters):
            rhs = f0u
            grads = self._grads(q, 1) if visc is not None else None
            for d in range(self.dim):
                lam = dt / self._dxs[d]
                F = self.flux_fn(q, d, va)
                if grads is not None:
                    F = F + visc(q, grads, d, va)
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
        grads = self._grads(q, 1) if visc is not None else None
        fbar, fvbar = [], []
        for d in range(self.dim):
            F = self.flux_fn(q, d, va)
            if grads is not None:
                Fv = visc(q, grads, d, va)
                F = F + Fv
                if return_visc:
                    fvbar.append(_project(self.weights, Fv, 0))
            fbar.append(_project(self.weights, F, 0))
        out = (qbar, fbar)
        if self.source_fn is not None:
            out += (_project(self.weights, self.source_fn(q, va), 0),)
        if return_visc:
            out += (fvbar,)
        return out

    # ------------------------------------------------------------- corrector

    def predictor_volume(self, u, dt):
        """Cell-local half of the step (the plain version of the
        ``aderdg_predictor_volume`` kernel, and for a viscous solver of
        ``aderdg_predictor_volume_visc``): predictor, volume terms
        ``new = u + dt·s̄ + Σ_d λ_d·Kvol·F̄_d`` (and the NCP's strong-form
        volume term), and the face projections of q̄ and F̄_d for every
        axis.  Returns ``(new, faces, fvwall)`` (see :attr:`face_shape`):
        ``fvwall`` is None unless :attr:`splits_wall_viscosity`, and then the
        viscous-only time-averaged flux of each wall axis projected to its
        wall planes only (the first row's low faces, the last row's high
        faces; layout :meth:`visc_wall_rows`)."""
        split = self.splits_wall_viscosity
        pred = self.predictor(u, dt, return_visc=split)
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
        faces = torch.stack(faces).reshape(self.face_shape)
        if not split:
            return new, faces, None
        fvbar, rows = pred[-1], {}
        for d in self.wall_planes():
            ga, g = self.grid_axis(d), self.grid_shape[d]
            rows[d] = (_project(self.phi0, fvbar[d].narrow(ga, 0, 1), self.node_axis(d)),
                       _project(self.phi1, fvbar[d].narrow(ga, g - 1, 1), self.node_axis(d)))
        fvwall = torch.cat([rows[d][side].reshape(-1) for side in (0, 1) for d in rows])
        return new, faces, fvwall

    def face_surface(self, new, faces, dt, return_face_fluxes: bool = False,
                     fvwall=None, shifts=None):
        """Neighbour half of the step (the plain version of the face stage,
        ``aderdg_face_flux`` + ``aderdg_surface_update``): the Rusanov flux
        of every face and the surface update, axis by axis.  Returns the
        updated state (a new tensor; ``new`` is not modified), and with
        ``return_face_fluxes`` also each axis's high-face fluxes (see
        :meth:`face_update`).  ``fvwall``: the viscous-only wall fluxes of
        :meth:`predictor_volume`, which a solver that
        :attr:`splits_wall_viscosity` needs and no other takes.
        ``shifts``: ``{d: (shift, holds_lo_wall, holds_hi_wall)}`` for the
        grid axes whose neighbours lie on other ranks (see
        :meth:`face_update`; the sharded steps of ``parallel/shard.py``)."""
        if (fvwall is not None) != self.splits_wall_viscosity:
            raise SemanticError(
                "fvwall (the viscous-only wall fluxes of predictor_volume) goes "
                "with a viscous solver with walls, and only with one"
            )
        visc_rows = self.visc_wall_rows(fvwall) if fvwall is not None else {}
        shifts = shifts or {}
        fshape = self.face_flux_shape
        fluxes = []
        for d in range(self.dim):
            q_lo, q_hi, f_lo, f_hi = (
                faces[d, k].reshape(fshape) for k in range(4)
            )
            fv_lo, fv_hi = visc_rows.get(d, (None, None))
            shift, holds_lo, holds_hi = shifts.get(d, (None, True, True))
            new, fhat_hi = self.face_update(new, q_lo, q_hi, f_lo, f_hi, d, dt,
                                            fv_lo=fv_lo, fv_hi=fv_hi, shift=shift,
                                            holds_lo_wall=holds_lo, holds_hi_wall=holds_hi)
            fluxes.append(fhat_hi)
        if return_face_fluxes:
            return new, fluxes
        return new

    def step(self, u, dt, return_face_fluxes: bool = False, axis0_shift=None,
             axis0_wall_gates=None):
        """One ADER-DG time step (predictor + volume + Riemann + corrector).

        ``return_face_fluxes=True`` also returns the per-direction high-face
        Rusanov fluxes ``fhat_hi`` (:attr:`face_flux_shape` each), as the
        JAX solver does, for the limiter's interface matching.

        ``axis0_shift`` / ``axis0_wall_gates``: the multi-rank hooks of the
        JAX solver (``parallel/shard.py::make_sharded_xla_aderdg_step``).
        When the grid's axis 0 is split over ranks, every stage of the step
        is rank-local except the axis-0 neighbour access of the face stage:
        pass the edge-exchange shift and whether this rank holds the low and
        the high domain wall, ``(holds_lo, holds_hi)``.

        The JAX solver interleaves each axis's volume and surface terms;
        here all volume terms come first, as in the kernels, which moves
        the sum's rounding only."""
        new, faces, fvwall = self.predictor_volume(u, dt)
        shifts = None
        if axis0_shift is not None:
            shifts = {0: (axis0_shift, *(axis0_wall_gates or (True, True)))}
        return self.face_surface(new, faces, dt, return_face_fluxes, fvwall, shifts)

    def face_update(self, new, q_lo, q_hi, f_lo, f_hi, d, dt, fv_lo=None, fv_hi=None,
                    shift=None, holds_lo_wall=True, holds_hi_wall=True):
        """Riemann solve + surface (and NCP-fluctuation) corrector update
        for direction ``d`` from face-extrapolated time-averaged state/flux
        (periodic neighbours, or the wall ghosts on a wall axis).  Returns
        ``(new, fhat_hi)``: the updated state and the Rusanov flux through
        each cell's high face, nodal over the transverse node axes
        (:attr:`face_flux_shape`; on a wall axis its last row is the
        high-wall flux).  ``fv_lo`` / ``fv_hi`` (a viscous solver's wall
        axis): the viscous-only flux of the first row's low faces and the
        last row's high faces, one face row each.

        ``shift(x, sh, axis)`` is the neighbour access along ``d`` (the
        periodic ``torch.roll`` when None; the sharded steps pass a local
        roll whose edge row comes from the neighbouring rank).
        ``holds_lo_wall`` / ``holds_hi_wall``: whether this rank owns the
        low and the high domain wall of a wall axis; where it does not, the
        first row's low flux and the last row's right state are the
        exchanged ones (the JAX solver's ``_gate``)."""
        fhat_hi = self.interface_flux(q_lo, q_hi, f_lo, f_hi, d, fv_hi, shift, holds_hi_wall)
        fhat_wall = self.low_wall_flux(q_lo, f_lo, d, fv_lo) if holds_lo_wall else None
        new = self.surface_term(new, fhat_hi, d, dt, fhat_wall, shift)
        if self.ncp_fn is not None:
            # Path-conservative face fluctuations: the central parts
            # ½·B(q̃)·Δq at the segment midpoint q̃ go one to each side (the
            # ±½sΔq dissipation is already in the Rusanov f̂).  At a high
            # wall q_plus is the ghost; the low wall has its own.
            half = self.ncp_half(q_lo, q_hi, f_lo, f_hi, d, shift, holds_hi_wall)
            half_w = None
            if self.is_wall(d) and holds_lo_wall:
                face_grid_ax = self.grid_axis(d) - 1
                face_va = self.var_axis - 1
                first = q_lo.narrow(face_grid_ax, 0, 1)
                ghost = self._wall_ghost(first, d, 0, face_va)
                half_w = 0.5 * self.ncp_fn(0.5 * (ghost + first), first - ghost, d, face_va)
            new = self.ncp_term(new, half, d, dt, half_w, shift)
        return new, fhat_hi

    def ncp_half(self, q_lo, q_hi, f_lo, f_hi, d, shift=None, holds_hi_wall=True):
        """The NCP half-fluctuation ``½·B(q̃)·(q⁺ − q_hi)`` at each cell's
        high face along ``d``, q̃ = ½(q_hi + q⁺) (:attr:`face_flux_shape`;
        q⁺ as :meth:`_plus` gives it): the plain version of the Z4 face flux
        kernel's second output."""
        face_va = self.var_axis - 1
        q_plus, _ = self._plus(q_lo, q_hi, f_lo, f_hi, d, shift=shift,
                               holds_hi_wall=holds_hi_wall)
        mid = 0.5 * (q_hi + q_plus)
        return 0.5 * self.ncp_fn(mid, q_plus - q_hi, d, face_va)

    def ncp_term(self, new, half, d, dt, half_wall=None, shift=None):
        """``new − λ(ℓ_i(1)/w_i h_hi + ℓ_i(0)/w_i h_lo)`` along ``d``, h_hi
        the high-face ``half`` (:meth:`ncp_half`), h_lo the −d neighbour's,
        or in the first row ``half_wall`` where given (the plain version of
        the Z4 update kernel's NCP term, one axis)."""
        lam = dt / self._dxs[d]
        node_ax = self.node_axis(d)
        face_grid_ax = self.grid_axis(d) - 1
        half_lo = _shift(shift, half, 1, face_grid_ax)
        if half_wall is not None:
            half_lo = _replace_row(half_lo, half_wall, face_grid_ax, 0)
        phi1_w, phi0_w = self._surface_weights(new, d)
        return new - lam * (
            phi1_w * half.unsqueeze(node_ax)
            + phi0_w * half_lo.unsqueeze(node_ax)
        )

    def _plus(self, q_lo, q_hi, f_lo, f_hi, d, fv_hi=None, shift=None, holds_hi_wall=True):
        """The right state and flux of each cell's high face: the +d
        neighbour's low face (periodic, or through ``shift``), and on a wall
        axis the high-wall ghost of my own high face in the last row (with
        ``fv_hi``, the ghost flux hook on the advective part only, the
        viscous part the interior one-sided value) where this rank
        ``holds_hi_wall``."""
        face_grid_ax = self.grid_axis(d) - 1
        q_plus = _shift(shift, q_lo, -1, face_grid_ax)
        f_plus = _shift(shift, f_lo, -1, face_grid_ax)
        if self.is_wall(d) and holds_hi_wall:
            face_va = self.var_axis - 1
            g = q_hi.shape[face_grid_ax]
            last = q_hi.narrow(face_grid_ax, g - 1, 1)
            f_last = f_hi.narrow(face_grid_ax, g - 1, 1)
            if fv_hi is not None:
                wall_f = self._wall_ghost_flux(f_last - fv_hi, d, 1, face_va) + fv_hi
            else:
                wall_f = self._wall_ghost_flux(f_last, d, 1, face_va)
            q_plus = _replace_row(q_plus, self._wall_ghost(last, d, 1, face_va),
                                  face_grid_ax, g - 1)
            f_plus = _replace_row(f_plus, wall_f, face_grid_ax, g - 1)
        return q_plus, f_plus

    def _masked(self, dq):
        if self.dmask is not None:
            return dq * self.dmask.to(dq.dtype)
        return dq

    def _speed(self, qa, qb, d):
        """The Rusanov dissipation speed of a face between ``qa`` and ``qb``
        (var axis reduced): the larger wave speed, plus with viscosity the
        Gassner penalty 2(2N+1)/dx_d·max(κ_a, κ_b)."""
        face_va = self.var_axis - 1
        s = torch.maximum(self.max_eigenvalue_fn(qa, d, face_va),
                          self.max_eigenvalue_fn(qb, d, face_va))
        if self.visc_eigenvalue_fn is not None:
            kappa = torch.maximum(self.visc_eigenvalue_fn(qa, d, face_va),
                                  self.visc_eigenvalue_fn(qb, d, face_va))
            s = s + 2.0 * (2 * self.order + 1) / self._dxs[d] * kappa
        return s.unsqueeze(face_va)

    def interface_flux(self, q_lo, q_hi, f_lo, f_hi, d, fv_hi=None, shift=None,
                       holds_hi_wall=True):
        """The Rusanov flux through each cell's high face along ``d``
        (:attr:`face_flux_shape`; the plain version of the
        ``aderdg_face_flux`` kernel, one axis): left state my high face,
        right state the +d neighbour's low face, or the high-wall ghost
        (``fv_hi``, ``shift``, ``holds_hi_wall``: see :meth:`_plus`)."""
        q_plus, f_plus = self._plus(q_lo, q_hi, f_lo, f_hi, d, fv_hi, shift, holds_hi_wall)
        return self.rusanov(q_hi, q_plus, f_hi, f_plus, d)

    def rusanov(self, q_left, q_right, f_left, f_right, d):
        """The Rusanov flux along ``d`` of faces with the left state and
        flux ``q_left``, ``f_left`` and the right ``q_right``, ``f_right``
        (face layout, the jump masked)."""
        s = self._speed(q_left, q_right, d)
        dq = self._masked(q_right - q_left)
        return 0.5 * (f_left + f_right) - 0.5 * s * dq

    def low_wall_flux(self, q_lo, f_lo, d, fv_lo=None):
        """The Rusanov flux through the low wall of axis ``d`` (the first
        row's low faces; ghost on the left, my own low face on the right,
        the jump masked like the interior's), shaped like one row of
        :attr:`face_flux_shape` (axis ``d`` of the grid cut to 1): the
        plain version of the face kernel's side output.  ``fv_lo`` (a
        viscous solver): the first row's viscous-only flux, which the ghost
        flux hook skips.  None if ``d`` carries no wall."""
        if not self.is_wall(d):
            return None
        face_grid_ax = self.grid_axis(d) - 1
        face_va = self.var_axis - 1
        first = q_lo.narrow(face_grid_ax, 0, 1)
        f_first = f_lo.narrow(face_grid_ax, 0, 1)
        ghost = self._wall_ghost(first, d, 0, face_va)
        s_w = self._speed(first, ghost, d)
        dq_w = self._masked(first - ghost)
        if fv_lo is not None:
            wall_gf = self._wall_ghost_flux(f_first - fv_lo, d, 0, face_va) + fv_lo
        else:
            wall_gf = self._wall_ghost_flux(f_first, d, 0, face_va)
        return 0.5 * (wall_gf + f_first) - 0.5 * s_w * dq_w

    def surface_term(self, new, fhat_hi, d, dt, fhat_wall=None, shift=None):
        """``new − (λ/w_i)(ℓ_i(1) F̂_hi − ℓ_i(0) F̂_lo)`` along ``d``, F̂_lo
        being the −d neighbour's F̂_hi (periodic, or through ``shift``), or
        in the first row ``fhat_wall``
        (:meth:`low_wall_flux`) where given (the plain version of the
        ``aderdg_surface_update`` kernel, one axis)."""
        lam = dt / self._dxs[d]
        node_ax = self.node_axis(d)
        face_grid_ax = self.grid_axis(d) - 1
        fhat_lo = _shift(shift, fhat_hi, 1, face_grid_ax)
        if fhat_wall is not None:
            fhat_lo = _replace_row(fhat_lo, fhat_wall, face_grid_ax, 0)
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
        solver's order-aware default ``min(0.4, 1.5/(order+2))``; with
        viscosity the parabolic limit joins it, dt = cfl / ((2N+1)·λ/dx +
        2(2N+1)²·κ/dx²).  Returns a 0-d tensor on the state's device."""
        if cfl is None:
            cfl = min(0.4, 1.5 / (self.order + 2))
        r = rv = None
        for d in range(self.dim):
            s_d = torch.max(self.max_eigenvalue_fn(u, d, self.var_axis))
            r_d = s_d / self._dxs[d]
            r = r_d if r is None else torch.maximum(r, r_d)
            if self.visc_eigenvalue_fn is not None:
                k_d = torch.max(self.visc_eigenvalue_fn(u, d, self.var_axis))
                rv_d = k_d / self._dxs[d] ** 2
                rv = rv_d if rv is None else torch.maximum(rv, rv_d)
        if rv is None:
            return cfl / (r * (2 * self.order + 1))
        return cfl / (r * (2 * self.order + 1) + 2.0 * rv * (2 * self.order + 1) ** 2)

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
