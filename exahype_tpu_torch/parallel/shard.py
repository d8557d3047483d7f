"""Sharded stepping over ``torch.distributed``: the per-rank steps with the
edge exchange written out.

Port of ``exahype_tpu/parallel/shard.py``.  There, a ``pallas_call`` cannot
be split by the compiler, so the fused kernel runs per shard under
``shard_map`` and the cross-chip halo exchange is explicit ``ppermute``;
here every rank is a process (:mod:`~exahype_tpu_torch.parallel.mesh`), runs
its window of the grid through the same kernels as the unsharded step, and
trades one-row edge slabs with its neighbours (:meth:`Mesh.shift`).  The
patch grid's axis 0 (and, on a 2-axis mesh, axis 1) is split over the mesh.

- FV (K4): :func:`make_sharded_cuda_step` and
  :func:`make_sharded_cuda_step_2axis` fill the halos with
  :func:`sharded_tpu_halo_fill` (reflective walls on the sharded axis on
  the ranks that own them) or :func:`sharded_tpu_halo_fill_2axis` (bulk
  round on both axes, then the corner round), then launch a
  ``CudaPrinter`` kernel built for the local patch count (``plain=True``:
  the ``TorchPrinter`` function instead, the twin of the JAX package's
  GSPMD step; with a global dt from ``GridSolver(mesh=...).compute_dt``).
- ADER-DG on the card (K1 e): :func:`make_sharded_aderdg_step` and
  :func:`make_sharded_aderdg_step_2axis` run ``CudaADERDG``'s predictor on
  the local cells, send each sharded axis's edge face rows to the
  neighbours (the first row's ``q_lo, f_lo`` down, the last row's ``q_hi,
  f_hi`` up: one exchange round a step), and solve every face of the local
  grid in ``aderdg_face_flux_exchanged`` (the shard-boundary ones from the
  received planes, the domain walls on the ranks that own them), then the
  walled update.  The boundary flux is the same expression on the same
  operands as in the unsharded kernel, so the gathered step is the
  unsharded ``CudaADERDG.step`` bit for bit.  Compiled for 3-D Euler at
  order 3 (``bench.py``'s solver); other physics and orders raise
  :class:`LoweringError`, and :func:`make_sharded_xla_aderdg_step` runs
  them.  On CPU tensors the step takes the pair's plain version,
  :func:`exchanged_face_surface`, on the same exchange.
- ADER-DG, plain per rank: :func:`make_sharded_xla_aderdg_step` runs the
  solver's own step (a ``with_cuda_rhs`` solver's K5 included) through the
  ``axis0_shift`` hook, on one or two sharded axes.

``wire_dtype`` (e.g. ``torch.bfloat16``) casts the cross-rank payload
before the send and back after the receive (:func:`_ppermute_wire`);
rank-local halo data never loses precision.  ``LimitedADERDG`` over a
sharded accelerator is still to port (ROADMAP.md, Queue 1 item 5.b): the
limiter's neighbour reads would each need an exchange.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch

from exahype_tpu_torch.models.aderdg import _replace_row
from exahype_tpu_torch.parallel.grid import TpuPatchGrid
from exahype_tpu_torch.parallel.mesh import PATCH_AXIS, Mesh, state_sharding
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError


def _ppermute_wire(slab, mesh: Mesh, axis_name: str, step: int, wire_dtype=None):
    """``mesh.shift`` with an optional reduced-precision WIRE format: the
    payload is cast to ``wire_dtype`` (e.g. bf16, halving the bytes of
    every halo exchange) and restored to the compute dtype on receipt."""
    if wire_dtype is None:
        return mesh.shift(axis_name, slab, step)
    return mesh.shift(axis_name, slab.to(wire_dtype), step).to(slab.dtype)


def _rows(x, axis: int, start: int, stop: int):
    sl = [slice(None)] * x.dim()
    sl[axis] = slice(start, stop)
    return x[tuple(sl)]


def _local_grid(grid: TpuPatchGrid, local_shape: tuple) -> TpuPatchGrid:
    return dataclasses.replace(
        grid, config=dataclasses.replace(grid.config, n_patches=math.prod(local_shape)),
        grid_shape=tuple(local_shape))


def _local_shape(shape: tuple, mesh: Mesh, names: tuple) -> tuple:
    """``shape`` with its leading axes cut to the windows of ``names``, or
    JAX's divisibility error."""
    sizes = tuple(mesh.axis_size(n) for n in names)
    if len(names) == 1 and shape[0] % sizes[0] != 0:
        raise SemanticError(
            f"grid axis 0 ({shape[0]}) must be divisible by the mesh size ({sizes[0]})")
    if len(names) == 2 and (shape[0] % sizes[0] or shape[1] % sizes[1]):
        raise SemanticError(
            f"grid axes ({shape[0]},{shape[1]}) must divide the mesh ({sizes[0]},{sizes[1]})")
    return tuple(g // n for g, n in zip(shape, sizes)) + tuple(shape[len(names):])


# --------------------------------------------------------------------- FV


def _ring_sends(Q, local_grid, d, mesh, axis_name, wire_dtype=None):
    """The two edge shifts of grid axis ``d`` over mesh axis ``axis_name``:
    ``(from_left, from_right)``, the low neighbour's last interior slab and
    the high neighbour's first (one grid row each).  Pure sends, no halo
    writes."""
    cfg = local_grid.config
    h, P = cfg.halo_size, cfg.patch_size
    s, g = d, cfg.dim + 1 + d
    n = Q.shape[g]
    send_last = _rows(_rows(Q, s, P, P + h), g, n - 1, n)
    send_first = _rows(_rows(Q, s, h, 2 * h), g, 0, 1)
    from_left = _ppermute_wire(send_last, mesh, axis_name, 1, wire_dtype)
    from_right = _ppermute_wire(send_first, mesh, axis_name, -1, wire_dtype)
    return from_left, from_right


def _apply_axis_halo(Q, local_grid, d, from_left, from_right):
    """Write grid axis ``d``'s halos, in place: the local roll for the
    rank-local neighbours, the received slabs in the shard-boundary rows."""
    cfg = local_grid.config
    h, P = cfg.halo_size, cfg.patch_size
    s, g = d, cfg.dim + 1 + d
    n = Q.shape[g]
    local_grid._roll_axis(Q, d)
    _rows(_rows(Q, s, 0, h), g, 0, 1).copy_(from_left)
    _rows(_rows(Q, s, P + h, P + 2 * h), g, n - 1, n).copy_(from_right)


def sharded_tpu_halo_fill(local_grid: TpuPatchGrid, Q, mesh: Mesh,
                          axis_name: str = PATCH_AXIS, wire_dtype=None):
    """Halo fill of a rank's window of a grid whose axis 0 is sharded over
    ``axis_name``, in place; returns ``Q``.

    Inner grid axes use the local exchange (periodic roll, plus the grid's
    wall mirror when ``boundary="reflective"``: those axes are whole on the
    rank); the sharded axis rolls locally and then repairs the
    shard-boundary rows with the neighbours' edge slabs.  With reflective
    boundaries the domain-face mirror on the sharded axis is applied only by
    the ranks owning the global first or last grid row (at full precision:
    the mirror is local, so ``wire_dtype`` never touches it)."""
    cfg = local_grid.config
    h, P = cfg.halo_size, cfg.patch_size
    if h == 0:
        return Q
    n_dev, idx = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    reflective = local_grid.boundary == "reflective"
    for d in range(cfg.dim):
        if d != 0:
            local_grid._roll_axis(Q, d)
            if reflective:
                local_grid._reflect(Q, d)
            continue
        s, g = d, cfg.dim + 1 + d
        n = Q.shape[g]
        from_left, from_right = _ring_sends(Q, local_grid, d, mesh, axis_name, wire_dtype)
        if reflective:
            # The domain walls live on the first and last rank only: their
            # outer-face halo is the mirror of their own interior edge, not
            # the (wrapped) exchanged slab.
            if idx == 0:
                from_left = TpuPatchGrid._mirror_slab(_rows(_rows(Q, s, h, 2 * h), g, 0, 1), s)
            if idx == n_dev - 1:
                from_right = TpuPatchGrid._mirror_slab(
                    _rows(_rows(Q, s, P, P + h), g, n - 1, n), s)
        _apply_axis_halo(Q, local_grid, d, from_left, from_right)
    return Q


def sharded_tpu_halo_fill_2axis(local_grid: TpuPatchGrid, Q, mesh: Mesh,
                                axis_names: tuple = ("ici", "dcn"), wire_dtype=None):
    """Hierarchical halo fill of a rank's window of a grid with axes 0 and 1
    sharded over a 2-axis mesh (grid axis 0 over ``axis_names[0]``, axis 1
    over ``axis_names[1]``), in place; returns ``Q``.

    The JAX package's schedule: (1) the bulk round, the one-row edge slabs
    of both sharded axes sent before any halo is written (axis 1 first);
    (2) axis 0's halos written; (3) axis 1's, whose bulk slabs were sent
    before axis 0's halos existed, so their corner strips are stale; (4)
    the corner round: only those ``h``-wide strips are sent again along
    axis 1 and spliced in; (5) the unsharded trailing axes locally.
    Periodic boundaries only (walled grids shard on one axis)."""
    cfg = local_grid.config
    h, P = cfg.halo_size, cfg.patch_size
    if h == 0:
        return Q
    if local_grid.boundary != "periodic":
        raise SemanticError("2-axis sharded halo exchange supports periodic boundaries")
    ici, dcn = axis_names
    dcn_left, dcn_right = _ring_sends(Q, local_grid, 1, mesh, dcn, wire_dtype)
    ici_left, ici_right = _ring_sends(Q, local_grid, 0, mesh, ici, wire_dtype)
    _apply_axis_halo(Q, local_grid, 0, ici_left, ici_right)
    _apply_axis_halo(Q, local_grid, 1, dcn_left, dcn_right)
    # Corner round along axis 1: the axis-0 halo strips of its edge rows.
    g1_ax, g1 = cfg.dim + 2, local_grid.grid_shape[1]

    def strips(x):
        return torch.cat([_rows(x, 0, 0, h), _rows(x, 0, P + h, P + 2 * h)], dim=0)

    send_last = strips(_rows(_rows(Q, 1, P, P + h), g1_ax, g1 - 1, g1))
    corner_left = _ppermute_wire(send_last, mesh, dcn, 1, wire_dtype)
    send_first = strips(_rows(_rows(Q, 1, h, 2 * h), g1_ax, 0, 1))
    corner_right = _ppermute_wire(send_first, mesh, dcn, -1, wire_dtype)
    for (s1_lo, s1_hi), row, corner in (((0, h), 0, corner_left),
                                        ((P + h, P + 2 * h), g1 - 1, corner_right)):
        for k, (s0_lo, s0_hi) in enumerate(((0, h), (P + h, P + 2 * h))):
            dst = _rows(_rows(_rows(Q, 0, s0_lo, s0_hi), 1, s1_lo, s1_hi), g1_ax, row, row + 1)
            dst.copy_(_rows(corner, 0, k * h, (k + 1) * h))
    for d in range(2, cfg.dim):
        local_grid._roll_axis(Q, d)
    return Q


def _spec_step(kernel, grid, mesh, names, wire_dtype, plain, fill):
    from exahype_tpu_torch.backends.cuda_backend import CudaPrinter
    from exahype_tpu_torch.backends.torch_backend import TorchPrinter

    local_grid = _local_grid(grid, _local_shape(grid.grid_shape, mesh, names))
    local_kernel = kernel.with_n_patches(local_grid.config.n_patches)
    local_fn = (TorchPrinter(local_kernel).build() if plain
                else CudaPrinter(local_kernel).build())
    axis = names[0] if len(names) == 1 else names

    def step(Q_local, dt):
        fill(local_grid, Q_local, mesh, axis, wire_dtype=wire_dtype)
        return local_fn(Q_local, dt)

    #: The per-rank kernel (``CudaSpecKernel``: ``.launches``) or function.
    step.kernel_fn = local_fn
    step.local_grid = local_grid
    return step, state_sharding(mesh, grid, axis)


def make_sharded_cuda_step(kernel, grid: TpuPatchGrid, mesh: Mesh,
                           axis_name: str = PATCH_AXIS, wire_dtype=None, plain: bool = False):
    """Per-rank FV step on a grid whose axis 0 is sharded over
    ``axis_name``: :func:`sharded_tpu_halo_fill`, then K4 (``CudaPrinter``'s
    kernel for the local patch count; ``plain=True``: the ``TorchPrinter``
    function).  Returns ``(step_fn, sharding)``: ``step_fn(Q_local, dt)``
    updates this rank's window in place (``sharding.shard`` /
    ``sharding.gather`` map between it and the global state)."""
    return _spec_step(kernel, grid, mesh, (axis_name,), wire_dtype, plain,
                      sharded_tpu_halo_fill)


def make_sharded_cuda_step_2axis(kernel, grid: TpuPatchGrid, mesh: Mesh,
                                 axis_names: tuple = ("ici", "dcn"), wire_dtype=None,
                                 plain: bool = False):
    """Per-rank FV step with grid axes 0 and 1 sharded over a 2-axis mesh:
    :func:`sharded_tpu_halo_fill_2axis`, then the local kernel.  Returns
    ``(step_fn, sharding)`` like :func:`make_sharded_cuda_step`."""
    return _spec_step(kernel, grid, mesh, tuple(axis_names), wire_dtype, plain,
                      sharded_tpu_halo_fill_2axis)


# ---------------------------------------------------------------- ADER-DG


def _localize_dirichlet(solver, windows: dict):
    """``solver.dirichlet_fn`` cut to a window: ``windows`` maps a sharded
    grid axis to ``(start, length)``; each wall row is sliced along every
    sharded transverse grid axis (the wall axis itself is the row's
    singleton, and broadcast rows are the same on every rank)."""
    base = solver.dirichlet_fn
    if base is None:
        return None
    dim = solver.dim

    def fn(axis, side):
        row = np.asarray(base(axis, side))
        for gax, (start, length) in windows.items():
            pos = dim + gax  # the grid axis's position in the face-row layout
            if gax == axis or pos >= row.ndim or row.shape[pos] <= 1:
                continue
            row = np.take(row, np.arange(start, start + length), axis=pos)
        return row

    fn.basis = getattr(base, "basis", None)
    return fn


def _edge_shift(x, sh, axis, mesh: Mesh, axis_name: str, wire_dtype=None):
    """Periodic shift by one along a grid axis of ``x`` that is sharded over
    ``axis_name``: the local roll, with the one edge row the neighbour rank
    owns received in its place."""
    n = x.shape[axis]
    rolled = torch.roll(x, sh, axis)
    if sh == -1:  # my last row's neighbour is the next rank's first row
        recv = _ppermute_wire(x.narrow(axis, 0, 1), mesh, axis_name, -1, wire_dtype)
        _rows(rolled, axis, n - 1, n).copy_(recv)
        return rolled
    if sh == 1:  # my first row's neighbour is the previous rank's last row
        recv = _ppermute_wire(x.narrow(axis, n - 1, 1), mesh, axis_name, 1, wire_dtype)
        _rows(rolled, axis, 0, 1).copy_(recv)
        return rolled
    raise SemanticError(f"edge shift supports +-1, got {sh}")


def window_solver(solver, windows: dict):
    """A copy of ``solver`` over a window of its grid (the DG operators
    shared): ``windows`` maps grid axis ``i`` to ``(start, length)``, and
    the Dirichlet rows are cut to the window."""
    out = copy.copy(solver)
    out.grid_shape = tuple(windows[i][1] if i in windows else g
                           for i, g in enumerate(solver.grid_shape))
    out.dirichlet_fn = _localize_dirichlet(solver, windows)
    return out


def _local_solver(solver, mesh: Mesh, names: tuple):
    """:func:`window_solver` over this rank's window."""
    local = _local_shape(solver.grid_shape, mesh, names)
    return window_solver(solver, {i: (mesh.axis_index(name) * local[i], local[i])
                                  for i, name in enumerate(names)})


def _shifts(local_solver, mesh: Mesh, names: tuple, wire_dtype) -> dict:
    """``face_surface``'s ``shifts``: each sharded axis's edge shift and
    whether this rank holds its low and high wall."""
    out = {}
    for d, name in enumerate(names):
        n, idx = mesh.axis_size(name), mesh.axis_index(name)

        def shift(x, sh, ax, _name=name):
            return _edge_shift(x, sh, ax, mesh, _name, wire_dtype)

        out[d] = (shift, idx == 0, idx == n - 1)
    return out


#: The physics, dimension and order K1 e (``aderdg_face_flux_exchanged``)
#: is compiled for.
K1E_INSTANCES = {("euler", 3, 3)}


def _k1e_check(solver) -> None:
    tag = getattr(solver.flux_fn, "physics", None)
    key = (getattr(tag, "name", None), solver.dim, solver.order)
    if key not in K1E_INSTANCES or any(
            getattr(solver, o) is not None for o in (
                "source_fn", "ncp_fn", "rhs_all_fn", "visc_flux_fn")):
        raise LoweringError(
            f"the sharded CUDA face stage (K1 e, aderdg_face_flux_exchanged) is compiled "
            f"for {sorted(K1E_INSTANCES)} (physics, dim, order) without callbacks, got "
            f"{key}: other physics and orders are still to port, see ROADMAP.md, Queue 2 "
            "K1 e; make_sharded_xla_aderdg_step runs the plain solver per rank"
        )


def exchanged_face_surface(solver, new, faces, dt, modes, planes,
                           return_face_fluxes: bool = False):
    """The plain version of K1 e's pair (``CudaADERDG.face_flux_exchanged``
    then ``surface_update_exchanged``): the face stage of a rank's window,
    ``solver`` over it, given each axis's side ``modes`` and the received
    ``planes`` (see there), through the plain solver's ``rusanov`` and
    ``surface_term`` on the right-hand states built from the planes
    (flux-form solvers: an NCP's half-fluctuations would need their own
    planes).  Returns what ``face_surface`` returns."""
    if solver.ncp_fn is not None:
        raise LoweringError("exchanged_face_surface takes a flux-form solver (K1 e's); "
                            "make_sharded_xla_aderdg_step runs an NCP solver per rank")
    fshape = solver.face_flux_shape
    fluxes = []
    for d in range(solver.dim):
        q_lo, q_hi, f_lo, f_hi = (faces[d, k].reshape(fshape) for k in range(4))
        lo, hi = modes[d]
        ga = solver.grid_axis(d) - 1
        row = fshape[:ga] + (1,) + fshape[ga + 1:]
        # The right state of each high face: the +d neighbour's low face (a
        # roll; its last row the received plane, or the wall ghost).
        q_plus, f_plus = solver._plus(q_lo, q_hi, f_lo, f_hi, d, holds_hi_wall=hi == "wall")
        if hi == "exchanged":  # the +d neighbour's first row's low faces
            pq, pf = planes[(d, 1)].reshape((2,) + row)
            q_plus = _replace_row(q_plus, pq, ga, fshape[ga] - 1)
            f_plus = _replace_row(f_plus, pf, ga, fshape[ga] - 1)
        fhat = solver.rusanov(q_hi, q_plus, f_hi, f_plus, d)
        # The first row's low flux: the wall's, or the interface with the
        # −d neighbour's last row (its high faces on the left).
        low = None
        if lo == "wall":
            low = solver.low_wall_flux(q_lo, f_lo, d)
        elif lo == "exchanged":
            pq, pf = planes[(d, 0)].reshape((2,) + row)
            low = solver.rusanov(pq, q_lo.narrow(ga, 0, 1), pf, f_lo.narrow(ga, 0, 1), d)
        new = solver.surface_term(new, fhat, d, dt, low)
        fluxes.append(fhat)
    return (new, fluxes) if return_face_fluxes else new


def window_faces(sol, faces, new, d: int, parts: int, p: int):
    """Window ``p`` of ``parts`` along grid axis ``d`` of a 3-D solver's
    face stage as a rank of a sharded step sees it, cut from the whole
    grid's ``faces`` and ``new``: ``(solver, faces, new, modes, planes)``
    for :func:`exchanged_face_surface` and K1 e (walls on the windows owning
    them; the neighbours' rows as the planes they would send).  For checks
    of the pair without ranks."""
    g = sol.grid_shape[d]
    length = g // parts
    start = p * length
    local = window_solver(sol, {d: (start, length)})

    def row(which, i):  # grid axis d of faces[d, which] is its axis 2 + d
        return faces[d, which].narrow(2 + d, i % g, 1)

    planes = {(d, 0): torch.stack([row(1, start - 1), row(3, start - 1)]).contiguous(),
              (d, 1): torch.stack([row(0, start + length), row(2, start + length)]).contiguous()}
    modes = []
    for e in range(sol.dim):
        wall = "wall" if sol.is_wall(e) else "periodic"
        if e != d:
            modes.append((wall, wall))
        else:
            modes.append(("wall" if wall == "wall" and p == 0 else "exchanged",
                          "wall" if wall == "wall" and p == parts - 1 else "exchanged"))
    return (local, faces.narrow(4 + d, start, length).contiguous(),
            new.narrow(sol.grid_axis(d), start, length).contiguous(), tuple(modes), planes)


def _sharded_aderdg(solver, mesh, names, return_face_fluxes, wire_dtype):
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

    _k1e_check(solver)
    local = _local_solver(solver, mesh, names)
    cu = CudaADERDG(local)
    axis = names[0] if len(names) == 1 else names
    sizes = {d: (mesh.axis_size(n), mesh.axis_index(n)) for d, n in enumerate(names)}

    def modes() -> tuple:
        """Each axis's (low, high) side: "exchanged" on a sharded axis but
        at a wall this rank owns, else "wall" or "periodic"."""
        out = []
        for d in range(local.dim):
            wall = "wall" if local.is_wall(d) else "periodic"
            if d not in sizes:
                out.append((wall, wall))
                continue
            n, idx = sizes[d]
            out.append(("wall" if wall == "wall" and idx == 0 else "exchanged",
                        "wall" if wall == "wall" and idx == n - 1 else "exchanged"))
        return tuple(out)

    side_modes = modes()

    def exchange_planes(faces) -> dict:
        """The received face rows of each sharded axis: side 0 the low
        neighbour's last row's (q_hi, f_hi), side 1 the high neighbour's
        first row's (q_lo, f_lo), each ``[2, n^(dim-1), n_vars, *plane]``."""
        fshape = local.face_flux_shape
        planes = {}
        for d, name in enumerate(names):
            ga = local.grid_axis(d) - 1
            g = local.grid_shape[d]
            q_lo, q_hi, f_lo, f_hi = (faces[d, k].view(fshape) for k in range(4))
            up = torch.stack([q_hi.narrow(ga, g - 1, 1), f_hi.narrow(ga, g - 1, 1)])
            down = torch.stack([q_lo.narrow(ga, 0, 1), f_lo.narrow(ga, 0, 1)])
            planes[(d, 0)] = _ppermute_wire(up, mesh, name, 1, wire_dtype)
            planes[(d, 1)] = _ppermute_wire(down, mesh, name, -1, wire_dtype)
        return planes

    def step(u, dt):
        if not u.is_cuda:  # the plain version, on the same exchange
            new, faces, _ = local.predictor_volume(u, dt)
            return exchanged_face_surface(local, new, faces, dt, side_modes,
                                          exchange_planes(faces), return_face_fluxes)
        new, faces, _ = cu.predictor_volume(u, dt)
        fhat, fside = cu.face_flux_exchanged(faces, side_modes, exchange_planes(faces))
        cu.surface_update_exchanged(new, fhat, dt, fside, side_modes)
        if return_face_fluxes:
            return new, [fhat[d].view(local.face_flux_shape) for d in range(local.dim)]
        return new

    #: The per-rank kernels' wrapper (``.launches``) and local solver.
    step.accelerator = cu
    step.local_solver = local
    step.side_modes = side_modes
    step.exchange_planes = exchange_planes
    return step, state_sharding(mesh, solver, axis)


def make_sharded_aderdg_step(solver, mesh: Mesh, axis_name: str = PATCH_AXIS,
                             return_face_fluxes: bool = False, wire_dtype=None):
    """Per-rank ADER-DG step on the card with the cell grid's axis 0
    sharded over ``axis_name``: ``CudaADERDG``'s predictor, one exchange of
    the edge face rows, then K1 e's face pair (see the module notes).
    Returns ``(step_fn, sharding)``: ``step_fn(u_local, dt)`` returns the
    rank's new window (a fresh tensor), and with ``return_face_fluxes``
    also its high-face fluxes per axis, as ``ADERDGSolver.step`` does."""
    return _sharded_aderdg(solver, mesh, (axis_name,), return_face_fluxes, wire_dtype)


def make_sharded_aderdg_step_2axis(solver, mesh: Mesh, axis_names: tuple = ("ici", "dcn"),
                                   return_face_fluxes: bool = False, wire_dtype=None):
    """The same with grid axes 0 and 1 sharded over a 2-axis mesh (axis 0
    over ``axis_names[0]``, axis 1 over ``axis_names[1]``); each sharded
    axis gates its walls to the ranks owning them and cuts Dirichlet rows
    to the rank's window along the other sharded axis."""
    return _sharded_aderdg(solver, mesh, tuple(axis_names), return_face_fluxes, wire_dtype)


def make_sharded_xla_aderdg_step(solver, mesh: Mesh, axis_name=PATCH_AXIS, wire_dtype=None):
    """Per-rank ADER-DG step of the plain solver (the JAX package's
    ``make_sharded_xla_aderdg_step``): every stage of ``solver.step`` is
    cell-local except the neighbour access of the face stage on a sharded
    axis, which goes through the one-row edge exchange, with wall ghosts
    gated to the ranks owning a domain wall and Dirichlet rows cut to each
    rank's window.  A solver from ``models.rhs_cuda.with_cuda_rhs`` runs its
    K5 kernel per rank (K5 f).  ``axis_name``: one mesh axis (grid axis 0
    sharded) or a pair (grid axes 0 and 1).  Returns ``(step_fn,
    sharding)``."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    local = _local_solver(solver, mesh, names)
    shifts = _shifts(local, mesh, names, wire_dtype)

    def step(u, dt):
        new, faces, fvwall = local.predictor_volume(u, dt)
        return local.face_surface(new, faces, dt, False, fvwall, shifts)

    step.local_solver = local
    return step, state_sharding(mesh, solver, axis_name)


class ShardedCudaADERDG:
    """The sharded K1 e step with the solver protocol of ``CudaADERDG``
    (``.solver``, ``.step(u_local, dt, return_face_fluxes)``), over one
    mesh axis.  ``LimitedADERDG`` does not take it yet (ROADMAP.md, Queue 1
    item 5.b)."""

    def __init__(self, solver, mesh: Mesh, axis_name: str = PATCH_AXIS, wire_dtype=None):
        self.solver = solver
        self.mesh = mesh
        self._plain, self.sharding = make_sharded_aderdg_step(
            solver, mesh, axis_name, wire_dtype=wire_dtype)
        self._fluxed, _ = make_sharded_aderdg_step(
            solver, mesh, axis_name, return_face_fluxes=True, wire_dtype=wire_dtype)

    def step(self, u, dt, return_face_fluxes: bool = False):
        return (self._fluxed if return_face_fluxes else self._plain)(u, dt)


class ShardedCudaADERDG2Axis(ShardedCudaADERDG):
    """:class:`ShardedCudaADERDG` over a 2-axis mesh."""

    def __init__(self, solver, mesh: Mesh, axis_names: tuple = ("ici", "dcn"),
                 wire_dtype=None):
        self.solver = solver
        self.mesh = mesh
        self._plain, self.sharding = make_sharded_aderdg_step_2axis(
            solver, mesh, axis_names, wire_dtype=wire_dtype)
        self._fluxed, _ = make_sharded_aderdg_step_2axis(
            solver, mesh, axis_names, return_face_fluxes=True, wire_dtype=wire_dtype)
