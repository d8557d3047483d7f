"""Rank layouts for sharded stepping over ``torch.distributed``.

Port of ``exahype_tpu/parallel/mesh.py``.  JAX's ``Mesh`` is a grid of
devices that one program spans; here every rank is a process of one
``torch.distributed`` process group, and :class:`Mesh` is the layout of
those ranks as a 1-axis or 2-axis grid: each rank's coordinates and its
neighbours along each mesh axis.  The patch grid's leading axes are split
over the mesh axes (:func:`state_sharding`); a rank holds its window of the
global state and exchanges edge slabs with its neighbours
(:meth:`Mesh.shift`, the counterpart of ``lax.ppermute`` by ±1), and a
global scalar is an all-reduce (:meth:`Mesh.all_min`).

The backend is the caller's choice (:func:`init_group`): NCCL when the
ranks work on the card, gloo on the CPU.  NCCL takes one rank a card, so
on a machine with one card it runs at world size 1.  To run several ranks
on one card, gloo is allowed there too: the state, the faces and every
kernel stay on the card, and because gloo's point-to-point and reductions
take host tensors, :meth:`Mesh.shift` and the reductions stage their
payloads through host memory explicitly.  Nothing chooses a backend on what
it finds, and a failed initialisation raises.

Along a mesh axis of size 1 a rank is its own neighbour and the exchange
is a local copy, as ``ppermute`` on one device is the identity.  Torch
refuses a send to one's own rank.

:func:`run_ranks` spawns the ranks of one group (``file://`` rendezvous in
a fresh directory, no network) with a limit on each, so that a rank that
hangs fails the run instead of hanging the caller.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from exahype_tpu_torch.utils.device import resolve_device
from exahype_tpu_torch.utils.errors import SemanticError

PATCH_AXIS = "patches"
#: Every process group's timeout: a collective that waits longer raises.
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
BACKENDS = ("nccl", "gloo")


def init_group(rank: int, world_size: int, init_method: str, backend: Optional[str] = None,
               device=None) -> tuple[str, torch.device]:
    """Join the default process group as ``rank`` of ``world_size`` and
    return ``(backend, device)``.  ``device``: the card when None (a rank's
    tensors live there), or ``"cpu"``.  ``backend=None`` means NCCL for the
    card and gloo for the CPU; ``"gloo"`` on the card stages exchanges
    through host memory; NCCL on the CPU raises."""
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise SemanticError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise SemanticError("the NCCL backend exchanges CUDA tensors: pass a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=GROUP_TIMEOUT)
    return backend, device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the default process group as a grid of ``shape``
    (C order: rank = ravel of its coordinates), with named axes.
    ``device`` is where this rank's tensors live; ``backend`` the group's
    (gloo stages CUDA payloads through host memory)."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    rank: int
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(self.rank, self.shape))

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise SemanticError(f"mesh has axes {self.axis_names}, not {name!r}")
        return self.axis_names.index(name)

    def axis_size(self, name: str) -> int:
        return self.shape[self._axis(name)]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along mesh axis ``name``."""
        return self.coords[self._axis(name)]

    def neighbour(self, name: str, step: int) -> int:
        """The rank ``step`` places along mesh axis ``name``, periodic."""
        a = self._axis(name)
        c = list(self.coords)
        c[a] = (c[a] + step) % self.shape[a]
        return int(np.ravel_multi_index(c, self.shape))

    @property
    def _staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _wire(self, x):
        x = x.contiguous()
        return x.cpu() if self._staged else x

    def shift(self, name: str, x, step: int):
        """Send ``x`` to the neighbour ``step`` places along mesh axis
        ``name`` and return what the neighbour ``-step`` places sent (JAX's
        ``ppermute`` by ``step``; ``x``'s shape and dtype on every rank).
        Along an axis of size 1 a local copy."""
        if self.axis_size(name) == 1:
            return x.clone()
        send = self._wire(x)
        recv = torch.empty_like(send)
        for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self.neighbour(name, step)),
            dist.P2POp(dist.irecv, recv, self.neighbour(name, -step)),
        ]):
            req.wait()
        return recv.to(self.device) if self._staged else recv

    def all_min(self, x):
        """The elementwise minimum of ``x`` over every rank (a MIN
        all-reduce), on ``x``'s device."""
        y = x.detach().clone()
        if self._staged:
            y = y.cpu()
        dist.all_reduce(y, op=dist.ReduceOp.MIN)
        return y.to(x.device)

    def all_gather(self, x, dst: Optional[int] = None):
        """Every rank's ``x`` (equal shapes), by rank, on ``x``'s device; with
        ``dst``, on rank ``dst`` only (the others get None)."""
        y = self._wire(x)
        if dst is None:
            out = [torch.empty_like(y) for _ in range(self.size)]
            dist.all_gather(out, y)
        else:
            out = [torch.empty_like(y) for _ in range(self.size)] if self.rank == dst else None
            dist.gather(y, out, dst=dst)
            if out is None:
                return None
        return [t.to(x.device) for t in out]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = PATCH_AXIS,
    shape: Optional[Sequence[int]] = None,
    axis_names: Optional[Sequence[str]] = None,
    device=None,
) -> Mesh:
    """This rank's :class:`Mesh` over the default process group (which
    :func:`init_group` or the caller has initialised).

    Default: 1-D over ``n_devices`` ranks (all of the group when None).
    Multi-axis: ``make_mesh(shape=(2, 2), axis_names=("ici", "dcn"))``;
    shard successive grid axes over the mesh axes with
    ``state_sharding(..., axis_name=("ici", "dcn"))``.  The mesh must span
    the whole group.  ``device``: where this rank's tensors live (the card
    when None)."""
    if not dist.is_initialized():
        raise SemanticError("make_mesh needs an initialised process group (init_group)")
    world = dist.get_world_size()
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names or (f"axis{i}" for i in range(len(shape))))
    else:
        shape = (world if n_devices is None else int(n_devices),)
        names = (axis_name,)
    if len(names) != len(shape) or len(shape) not in (1, 2):
        raise SemanticError(f"a mesh has 1 or 2 named axes, got shape {shape}, names {names}")
    if math.prod(shape) != world:
        raise SemanticError(
            f"mesh shape {shape} needs {math.prod(shape)} ranks; the process group has "
            f"{world}"
        )
    return Mesh(shape, names, dist.get_rank(), resolve_device(device),
                dist.get_backend())


@dataclasses.dataclass(frozen=True)
class StateSharding:
    """Where a global state's grid axes are split: grid axis ``i`` over
    mesh axis ``names[i]``, at tensor axis ``tensor_axes[i]``, into windows
    of ``local[i]`` rows."""

    mesh: Mesh
    names: tuple[str, ...]
    tensor_axes: tuple[int, ...]
    local: tuple[int, ...]

    def window(self) -> tuple[tuple[int, int, int], ...]:
        """``(tensor axis, start, length)`` of this rank's window on each
        split axis."""
        return tuple((ax, self.mesh.axis_index(name) * n, n)
                     for name, ax, n in zip(self.names, self.tensor_axes, self.local))

    def shard(self, Q):
        """This rank's window of the global tensor ``Q`` (a contiguous
        copy, also where the window is all of ``Q``)."""
        for ax, start, n in self.window():
            Q = Q.narrow(ax, start, n)
        return Q.clone(memory_format=torch.contiguous_format)

    def gather(self, Q_local, dst: Optional[int] = None):
        """The global tensor from every rank's window, on every rank (on
        rank ``dst`` only where given; None on the others)."""
        parts = self.mesh.all_gather(Q_local, dst)
        if parts is None:
            return None
        mesh = self.mesh
        axes = {mesh.axis_names.index(name): ax for name, ax in zip(self.names, self.tensor_axes)}

        def assemble(ranks, m):
            # A mesh axis no grid axis is split over holds identical copies.
            if m == len(mesh.shape):
                return parts[int(ranks)]
            if m not in axes:
                return assemble(ranks[0], m + 1)
            return torch.cat([assemble(r, m + 1) for r in ranks], dim=axes[m])

        return assemble(np.arange(mesh.size).reshape(mesh.shape), 0)


def _grid_tensor_axis(grid, i: int) -> int:
    """The tensor axis of grid axis ``i``: after the extent and variable
    axes in the SoA-P patch layout, ``grid_axis(i)`` for an ADER-DG
    solver."""
    if hasattr(grid, "grid_axis"):
        return grid.grid_axis(i)
    return grid.config.dim + 1 + i


def state_sharding(mesh: Mesh, grid, axis_name=PATCH_AXIS) -> StateSharding:
    """Shard the state of ``grid`` (a ``TpuPatchGrid`` or an
    ``ADERDGSolver``) over ``mesh`` along its leading grid axes.

    ``axis_name`` may be a single mesh-axis name (grid axis 0 sharded) or a
    tuple of names (successive grid axes over successive mesh axes)."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    local = []
    for i, name in enumerate(names):
        n_dev = mesh.axis_size(name)
        if grid.grid_shape[i] % n_dev != 0:
            raise SemanticError(
                f"grid axis {i} ({grid.grid_shape[i]}) must be divisible by "
                f"mesh axis {name!r} ({n_dev})"
            )
        local.append(grid.grid_shape[i] // n_dev)
    axes = tuple(_grid_tensor_axis(grid, i) for i in range(len(names)))
    return StateSharding(mesh, names, axes, tuple(local))


def replicated(mesh: Mesh):
    """No counterpart: JAX's replicated sharding places one array on every
    device of the mesh; here each rank holds its own tensors, so a value
    every rank needs is computed or received by each (the dt by
    :meth:`Mesh.all_min`).  Raises."""
    raise SemanticError(
        "replicated(mesh) has no counterpart in the port: every rank holds its own "
        "tensors; reduce a global scalar with Mesh.all_min"
    )


def shard_state(Q, mesh: Mesh, grid, axis_name=PATCH_AXIS):
    """This rank's window of the global state ``Q``."""
    return state_sharding(mesh, grid, axis_name).shard(Q)


def gather_state(Q_local, mesh: Mesh, grid, axis_name=PATCH_AXIS):
    """The global state from every rank's window (the inverse of
    :func:`shard_state`; JAX gathers implicitly)."""
    return state_sharding(mesh, grid, axis_name).gather(Q_local)


# ------------------------------------------------------------------ spawning


def _rank_main(fn, rank, world_size, init_method, backend, device, args, results):
    try:
        init_group(rank, world_size, init_method, backend, device)
        try:
            # Every rank has joined before any runs ``fn``: a rank that
            # finished and closed its connections while another was still
            # connecting would fail that one's join.
            dist.barrier()
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, *args, backend: Optional[str] = None,
              device=None, join_timeout: float = 120.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes that form one process group (see :func:`init_group` for
    ``backend`` and ``device``; the group meets through a file in a fresh
    temporary directory).  Returns each rank's result, by rank.  Raises if a
    rank raises, or if the ranks have not all finished within
    ``join_timeout`` seconds (the stragglers are killed).  ``fn`` and
    ``args`` must pickle (``fn`` defined at the top level of a module)."""
    if device is None:
        device = str(resolve_device(None))
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, init_method, backend, str(device), args,
                                   results), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + join_timeout
        try:
            while len(got) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"run_ranks: {world_size - len(got)} of {world_size} ranks did not "
                        f"finish within {join_timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"run_ranks: rank {dead[0]} died with exit code "
                                           f"{procs[dead[0]].exitcode}")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n{payload}")
                got[rank] = pickle.loads(payload)
        finally:
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world_size)]
