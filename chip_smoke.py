#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the root of a checkout; one card, nvcc

It drives five paths, each through ``exahype_tpu_torch``'s entry points
with its kernels' launch counters set to 0 just before and read just
after (the two forms of the main path, ADER-DG and FV, and the limited,
CK and dynamic-GR slices), in this order:

- **ADER-DG**: ``bench.py::main``'s step — order 3, 3-D compressible
  Euler, a ``(256, 8, 128)`` periodic cell grid in float32, ``bench.py``'s
  initial state — through ``CudaADERDG`` (kernels of ``csrc/aderdg.cu``).
  The time step is the solver's own ``cfl_dt`` of the initial state
  (6.26e-5), not ``bench.py``'s fixed 1e-4: that is 1.6x over the CFL limit
  at dx = 1/256, and on this rough state the step then amplifies until the
  state overflows.  The JAX solver does the same on cut grids
  (``tests/test_torch_slice.py::test_bench_dt_blows_up_in_both_packages``);
  the script records the step at which the port overflows at the bench
  grid.
- **limited**: ``bench.py::bench_limited``'s production step — the same
  solver, grid and dtype, ``LimitedADERDG(admissible=euler_admissible(3),
  troubled_capacity=128, troubled_granularity="row", dmp_delta0=5e-4,
  accelerator=CudaADERDG(solver), subcell_cuda=True)`` with the "means"
  overflow policy and the post-step guard, from the bench's Sod shock along
  axis 0 at the bench's dt = 1.5e-4 (``bench.py:326-356``): 5 warm-up steps
  (the bench's first chunk), then 10 checked ones.  Its kernels are three
  of ``csrc/aderdg.cu`` (the predictor and the face stage's two launches,
  which also return the face fluxes) and the subcell sweep (K3) of
  ``csrc/subcell.cu``, six launches a step.
- **CK**: ``bench.py::bench_ck``'s step — order 3, 3-D heterogeneous
  elasticity (12 variables: velocity–stress and frozen per-node ρ, λ, μ),
  ``predictor_mode="ck"``, ``ck_material_slots=(9, 10, 11)``,
  ``dissipation_mask=(1,)*9 + (0, 0, 0)``, dx = 1/g0, the plane P wave in a
  two-layer medium (``bench.py:167-204``), float32 — through ``CudaADERDG``
  (the CK predictor K2 and the face stage's two kernels of
  ``csrc/aderdg.cu``), three launches a step.  Two grids: the bench's ``(64, 4, 32)`` at its dt = 2e-4
  over its window (5 warm-up steps, then 40) with its integrity checks
  (finite, slots 9–11 bitwise frozen, seismic energy ratio below 1.02),
  and ``(256, 8, 128)``, the same problem at 4x the resolution, 10 steps at
  ``cfl_dt`` (2e-4 is over the CFL limit at dx = 1/256).
- **FV**: the spec-DSL Rusanov patch update of ``__graft_entry__.py`` —
  ``build_fv_rusanov_kernel`` (3-D Euler, patch 4, halo 1, 5 vars) →
  ``TpuPatchGrid`` → ``GridSolver(kernel_dt="lambda")`` with ``compute_dt``
  every step (cfl 0.45, dx = 1/(4·g0)), float32, at ``(8, 8, 128)`` (the
  JAX package's own FV measurement size) and ``(32, 16, 128)`` patches,
  from ``__graft_entry__._example_state``'s recipe.  Its kernel (K4) is
  generated from the spec's statement list (``backends/cuda_backend.py``).
- **Z4**: ``scripts/z4_probe.py --large --pallas``'s step — the 38-variable
  vacuum Z4 system, order 2, 3-D, ``make_z4_solver(impl="soa",
  fused_rhs="soa")`` (harmonic slicing f = 1, m = 2, κ₁ = κ₂ = 0) on a
  ``(16, 16, 128)`` grid at dx = 1/128, the exact gauge wave of amplitude
  0.1, float32, dt = 1e-4 (0.18x ``cfl_dt``) — through ``with_cuda_rhs``,
  which puts the fused right-hand side on K5 (``csrc/rhs.cu``): 3 Picard
  and 2 corrector launches a step; the source and the face NCP
  evaluations stay eager PyTorch, as the JAX solver keeps them in XLA.

Phases:

1. card: name, and ``nvidia-smi``'s name and power limit;
2. build: ``csrc/aderdg.cu``, ``csrc/subcell.cu``, ``csrc/rhs.cu`` and the
   K4 sources of the ``fv`` and the canonical ``rusanov`` spec, one
   ``nvcc`` each, all started together (time, source hash, nvcc seconds
   per source, and ptxas's registers/shared memory/spills);
3. each kernel against its plain PyTorch version on the card: float64 at
   atol=1e-12 (ADER-DG, its face fluxes and the CK kernels ``(8, 4, 32)``;
   K3 a batch of ``K=8, L=16`` rows per direction; K4 ``(2, 2, 2)``, both
   specs), float32 at each path's full shape (K3 on the gathered batch of
   the limited path after its warm-up; CK at both grids, the evolved and
   the material rows each against their own largest value; K5 on the
   first Picard call and the corrector's, also against the float64 plain
   result) at the bound stated in ``F32_ULPS``, K3 bitwise repeatable; K5
   in float64 on every call of one step at ``(8, 4, 16)``, at 1e-12 of
   the largest value (``Z4_F64_RTOL``), with the path's parameters and
   with those of the kernel's other branches (``Z4_PARAMS``);
4. each main path: 10 steps (CK: the bench's window at its grid), with the
   launch counters, finiteness, mass drift (CK: materials bitwise frozen
   and the seismic energy ratio, also per half of the window), bitwise
   repeatability and the plain path as checks (the limited path also:
   admissibility, the rows demanded against the capacity, and one step's
   troubled mask against the plain path's; Z4: K5's launches, (picard_iters
   + 2) a step, and the plain path after 1 and 10 steps, with the error
   against the exact gauge wave and the ADM constraints of both paths as
   readings);
5. times: step ms over 3 host-clock windows, DOF-updates/s, per-kernel (and
   for FV ``halo_fill`` / ``compute_dt``, for the limited step the rest of
   the step, for Z4 the eager stages) times with CUDA events, device idle
   share, peak memory, host synchronisations per limited step, the plain
   path beside them, and the seconds each path took; for each kernel of
   ``csrc/aderdg.cu`` a path launches, a ``[kernel]`` line with its
   registers and resident blocks per SM (the library's occupancy query) and
   its achieved TB/s and TFLOP/s beside its bound (the face stage's pair of
   launches also as one, against the stage's bound);
6. a reading, not a check: the step at which ``bench.py``'s dt = 1e-4
   makes the ADER-DG state non-finite, on both paths.

It prints a JSON line of the kernels (with each one's bound, from this
run's shapes), the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
those lines; so does a machine without a CUDA card, and a directory that
holds this script without the package.  Imports no JAX.
"""

from __future__ import annotations

import copy
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = pathlib.Path(__file__).resolve().parent

GRID = (256, 8, 128)   # bench.py:43
ORDER = 3
DX = 1.0 / GRID[0]     # bench.py:55
STEPS = 10
#: float32 kernel-vs-plain bound, in units of the float32 spacing (2⁻²³
#: relative) at the largest magnitude of the compared array.  The kernel
#: and the plain version are two float32 evaluation orders of the same
#: arithmetic, a few hundred dependent operations deep (Picard iterations,
#: contractions, Rusanov), with fused multiply-adds on one side only; each
#: is within ~1.4e-6 (~3 spacings at |u| ≈ 6) of the float64 step on this
#: state on a CPU.  64 spacings leaves a wide margin over that and stays
#: far below any real fault (a wrong coefficient moves values by ≥1e-3).
F32_ULPS = 64
F64_ATOL = 1e-12
#: Relative bound on the change of each conserved integral over the 10
#: steps.  The periodic flux form conserves them exactly; float32 rounding
#: of each update (≤ 2⁻²⁴ relative, 10 steps) bounds the drift by ~1e-6.
MASS_RTOL = 1e-5

#: The limited path (``bench.py:326-356``).
LIMITED_DT = 1.5e-4
CAPACITY = 128
DMP_DELTA0 = 5e-4
WARMUP = 5

#: The FV path (``__graft_entry__.py:16-36``): 3-D Euler, patch 4, halo 1.
FV_WIDTH = dict(dim=3, patch_size=4, halo_size=1, n_real=5, n_aux=0)
FV_GRIDS = ((8, 8, 128), (32, 16, 128))
FV_CFL = 0.45

#: The CK path (``bench.py:151-294``).
CK_GRIDS = ((64, 4, 32), (256, 8, 128))
CK_DT = 2e-4           # bench.py:204, at the bench's grid
CK_WARMUP = 5          # the bench's first chunk
CK_WINDOW = 40         # its 8 chunks of 5 steps
CK_ENERGY_GATE = 1.02  # bench.py:280
CK_EVOLVED = 9

#: The Z4 path (``scripts/z4_probe.py --large --pallas``: ``:53-57, 81-82,
#: 198-202, 225-229``): the 38-variable vacuum Z4 system, order 2, 3-D,
#: harmonic slicing f = 1, m = 2, κ₁ = κ₂ = 0, the gauge wave of amplitude
#: 0.1 along axis 0, dt = 1e-4.
Z4_GRID = (16, 16, 128)
Z4_DX = 1.0 / 128
Z4_ORDER = 2
Z4_DT = 1e-4
Z4_AMPLITUDE = 0.1
#: The f64 kernel-vs-plain grid (same dx and amplitude).
Z4_CUT = (8, 4, 16)
#: The parameters of K5's f64 checks: the path's own, then the kernel's
#: other branches, 1+log slicing (g = 2/α, d(αg)/dα = 0) and harmonic
#: slicing with f ≠ 1, each with m ≠ 2 and both κ damping terms.
Z4_PARAMS = (
    {},
    dict(slicing="1+log", f=0.7, m=1.5, kappa1=0.1, kappa2=0.3),
    dict(f=0.7, m=1.5, kappa1=0.1, kappa2=0.3),
)
#: f64 K5 bound, relative to max(1, max|plain|): the right-hand side reaches
#: ~580 on the cut grid (its wavelength is 8 cells), so an absolute 1e-12 is
#: too tight for two evaluation orders of a ~3,900-operation algebra (fused
#: multiply-adds on the card's side only); they differ by a few float64
#: spacings of the largest intermediate, far below 1e-12 of it.
Z4_F64_RTOL = 1e-12
#: K5's float32 bound is ``F32_ULPS`` spacings of max|plain|, as for the
#: other kernels: on this state the plain float32 evaluation of each of a
#: step's five calls is within 1.2-2.3 spacings of max|plain| of the float64
#: one (measured on a CPU at (16, 2, 2), dx = 1/128, where the values are
#: those of the full grid), and the kernel's fused multiply-adds change
#: rounding, not its size.  A wrong term moves values by whole units.

#: H100 SXM data-sheet peaks at 700 W:
#: HBM bytes/s, and float32 flop/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
#: Flops of one Euler flux (1 division, pressure 9, coefficient 1, 4
#: advective products, the pressure term 1, energy 3; rounded up) and one
#: largest wave speed (division, pressure, 3 products, root, 2 sums, 3
#: absolute values, max) in ``csrc/euler.cuh``.
FLUX_OPS = 20
EIG_OPS = 17
#: Flops of one elastic flux of the 9 evolved rows (3 velocity products, 5
#: for the normal stress, 2 for the other normal stresses, 2 shear products
#: and their 3 "+ 0" terms; rounded up) and of one P-wave speed (product,
#: sum, division, root) in ``csrc/elastic.cuh``.
ELASTIC_FLUX_OPS = 16
ELASTIC_EIG_OPS = 4


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def bench_state(solver, torch, device, dtype):
    """``bench.py:69-76``: numpy default_rng(0), five fixed components."""
    import numpy as np

    rng = np.random.default_rng(0)
    va = solver.var_axis
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    rho = (1.0 + 0.2 * rng.random(no_var)).astype(np.float32)
    comps = [rho, rho, 0.5 * rho, 0.25 * rho, 5.0 + 0.5 * rho * 1.3125]
    q = np.stack(comps, axis=va)
    return torch.from_numpy(q).to(device=device, dtype=dtype).contiguous()


def max_err(torch, a, b) -> float:
    return (a.double() - b.double()).abs().max().item()


def f32_bound(torch, ref) -> float:
    return F32_ULPS * 2.0**-23 * ref.abs().max().item()


def event_ms(torch, fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def idle_share(torch, fn) -> tuple[float, float, float]:
    """``(idle share, device busy ms, wall ms)`` of one call of ``fn``.

    Busy is the union of the device intervals of every kernel, copy and
    set that ``torch.profiler`` records (overlaps counted once; no nested
    rows are summed); wall is the host clock from the synchronize before
    ``fn`` to the synchronize after.  The profiler's own launch overhead
    falls into the wall time, so the share is an upper bound.  Returns
    NaNs if the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return float("nan"), float("nan"), wall_us / 1e3
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return 1.0 - busy / wall_us, busy / 1e3, wall_us / 1e3


def first_nonfinite(torch, solver, u0, dt, n: int):
    """The first of ``n`` steps from ``u0`` after which the state holds a
    non-finite value, or None."""
    u = u0
    for k in range(1, n + 1):
        u = solver.step(u, dt)
        if not bool(torch.isfinite(u).all()):
            return k
    return None


def windows(torch, solver, u0, dt, steps: int, n_windows: int = 3) -> list[float]:
    """Seconds per step in each window of ``steps`` chained steps from
    ``u0`` (host clock around work that ends in a synchronize)."""
    out = []
    for _ in range(n_windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.run(u0, steps, dt)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / steps)
    return out


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time of a kernel's work on the H100 at 700 W: the larger
    of its bytes over the memory rate and its flops over the f32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return {
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def predictor_ops(order: int, picard_iters: int, ncell: int, dim=3, nvar=5) -> float:
    """Flops of ``aderdg_predictor_volume`` (``csrc/aderdg.cu``), counted per
    (cell, node): each Picard iteration evaluates ``dim`` fluxes per time
    slice and contracts them with D (2n-1 flops per n-point contraction)
    into the right-hand side, then applies K1inv; then the time averages
    of q and the fluxes, the volume integral, and the face projections
    (``dim`` n^(dim-1) of the n^dim threads)."""
    n = order + 1
    contr = 2 * n - 1
    picard = n * (dim * FLUX_OPS + nvar * (1 + dim * (contr + 3))) + n * nvar * contr
    averages = n * (2 * nvar + dim * FLUX_OPS + 2 * dim * nvar)
    volume = nvar * dim * (contr + 2)
    faces = dim * n ** (dim - 1) / n**dim * nvar * 4 * contr
    per_node = picard_iters * picard + averages + volume + faces
    return per_node * n**dim * ncell


def ck_predictor_ops(order: int, ncell: int, dim=3, nvar=12, evolved=CK_EVOLVED) -> float:
    """Flops of ``aderdg_ck_predictor_volume`` (``csrc/aderdg.cu``), per
    (cell, node): 1/ρ once; each of the N levels evaluates ``dim`` elastic
    fluxes and, per evolved variable, ``dim`` D contractions (2n-1 flops)
    with their λ_d product and sum, the division by k and the q̄ update (2);
    then F̄_d = F_d(q̄), the volume integral and the face projections, as
    in :func:`predictor_ops`."""
    n = order + 1
    contr = 2 * n - 1
    level = dim * ELASTIC_FLUX_OPS + evolved * (dim * (contr + 2) + 3)
    volume = nvar * dim * (contr + 2)
    faces = dim * n ** (dim - 1) / n**dim * nvar * 4 * contr
    per_node = 1 + order * level + dim * ELASTIC_FLUX_OPS + volume + faces
    return per_node * n**dim * ncell


def ck_bytes(state_bytes: int, face_bytes: int) -> int:
    """Bytes of the CK predictor: the state read, the new state and the
    face tensor written."""
    return 2 * state_bytes + face_bytes


def face_surface_ops(order: int, ncell: int, dim=3, nvar=5, eig_ops=EIG_OPS,
                     masked=False) -> float:
    """Flops of the face stage: one Rusanov flux (two wave speeds, 6 flops
    per variable, 7 with a dissipation mask) per interface, that is per face
    node and axis of each cell (:func:`face_flux_ops`), and the surface
    update (:func:`surface_update_ops`)."""
    return (face_flux_ops(order, ncell, dim, nvar, eig_ops, masked)
            + surface_update_ops(order, ncell, dim, nvar))


def face_flux_ops(order: int, ncell: int, dim=3, nvar=5, eig_ops=EIG_OPS,
                  masked=False) -> float:
    """Flops of ``aderdg_face_flux``: one Rusanov flux per interface."""
    n = order + 1
    return ncell * dim * n ** (dim - 1) * (2 * eig_ops + (7 if masked else 6) * nvar)


def surface_update_ops(order: int, ncell: int, dim=3, nvar=5) -> float:
    """Flops of ``aderdg_surface_update``: 5 per node, variable and axis."""
    n = order + 1
    return ncell * n**dim * nvar * dim * 5


def face_stage_bytes(order: int, ncell: int, itemsize: int, dim=3, nvar=5, rows=5) -> int:
    """Bytes of the face stage (the pair of launches, F̂ intermediate): per
    face node of each axis, both faces' state (all ``nvar`` rows, which the
    wave speeds read) and flux (the ``rows`` that can be nonzero) read; the
    ``rows`` that move of the state read and written.  For Euler (``rows ==
    nvar``) that is the whole face tensor and the state read and written."""
    n = order + 1
    faces = dim * n ** (dim - 1) * 2 * (nvar + rows)
    return ncell * itemsize * (faces + 2 * rows * n**dim)


def face_fhat_bytes(face_bytes: int, state_bytes: int, fhat_bytes: int) -> int:
    """Bytes of the face stage with the face-flux output: the faces and the
    state read, the state and the face fluxes written."""
    return face_bytes + 2 * state_bytes + fhat_bytes


def face_flux_bytes(order: int, ncell: int, itemsize: int, dim=3, nvar=5, rows=5) -> int:
    """Bytes of ``aderdg_face_flux``: per interface, both sides' face state
    (all ``nvar`` rows, which the wave speeds read) and face flux (the
    ``rows`` that can be nonzero) read, the ``rows`` of F̂ written."""
    faces = dim * (order + 1) ** (dim - 1) * ncell
    return faces * itemsize * (2 * nvar + 3 * rows)


def surface_update_bytes(order: int, ncell: int, itemsize: int, dim=3, rows=5) -> int:
    """Bytes of ``aderdg_surface_update``: the ``rows`` that move of the
    state read and written, and F̂ (each interface once) read."""
    n = order + 1
    return ncell * itemsize * rows * (2 * n**dim + dim * n ** (dim - 1))


def kernel_report(cu, name: str, dtype, where: str, ms: float, n_bytes: float,
                  n_ops: float, card: str) -> dict:
    """Print a ``[kernel]`` line for one kernel of ``csrc/aderdg.cu``: how
    it launches (registers, resident blocks per SM, from the library's
    occupancy query; ``cu=None`` for the face stage's pair), its time, the
    rates it achieved and its bound.  Returns the bound."""
    bnd = bound(n_bytes, n_ops)
    shape = "the pair of launches"
    if cu is not None:
        info = cu.kernel_info(name, dtype)
        shape = (f"{info['registers']} registers, {info['blocks_per_sm']} resident blocks of "
                 f"{info['threads']} threads per SM "
                 f"({info['blocks_per_sm'] * info['threads'] // 32} of 64 warps), "
                 f"{info['smem']} B dynamic shared memory, {info['local']} B local memory "
                 "a thread")
    say(f"[kernel] {name} {where}: {shape}; {ms!r} ms, achieved {n_bytes / ms / 1e9!r} TB/s "
        f"(of {PEAK_BYTES / 1e12}) and {n_ops / ms / 1e9!r} TFLOP/s (of {PEAK_F32 / 1e12}); "
        f"bound {bnd['bound_ms']!r} ms by {bnd['bound_by']} ({n_bytes} B, {n_ops!r} flops), "
        f"{ms / bnd['bound_ms']:.2f}x it ({card})")
    return bnd


def plain_face_flux(torch, sol, faces):
    """The plain version of ``aderdg_face_flux``: ``interface_flux`` of
    every axis, in the kernel's layout ``[dim, n^(dim-1), n_vars, *grid]``."""
    fshape = sol.face_flux_shape
    return torch.stack([
        sol.interface_flux(*(faces[d, k].reshape(fshape) for k in range(4)), d)
        for d in range(sol.dim)
    ]).reshape((sol.dim, -1) + tuple(fshape[-4:]))


def plain_surface_update(sol, new, fhat, dt):
    """The plain version of ``aderdg_surface_update`` (a new tensor)."""
    for d in range(sol.dim):
        new = sol.surface_term(new, fhat[d].view(sol.face_flux_shape), d, dt)
    return new


def kernel_line(name: str, replaces: str, launches: int, err: float, ms: float,
                plain_ms: float, bnd: dict) -> dict:
    """One entry of the kernels JSON for a kernel of ``csrc/aderdg.cu``."""
    return {
        "name": name,
        "route": "cuda",
        "source": "exahype_tpu_torch/csrc/aderdg.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        **bnd,
        "library_ms": None,  # no single PyTorch call computes it
    }


def sweep_bytes(n_pencils: int, itemsize: int, n_sub=7, nvar=5) -> int:
    """Bytes one K3 sweep needs: every pencil's ``n_sub`` subcells and two
    ghosts read, its ``n_sub`` subcells written, and each (k, l) cell's two
    transverse-mean edge fluxes written (``n_pencils / n_sub^2`` cells)."""
    cells = n_pencils // n_sub**2
    return (2 * n_sub + 2) * nvar * itemsize * n_pencils + 2 * nvar * itemsize * cells


def sweep_ops(n_pencils: int, n_sub=7, nvar=5) -> float:
    """Flops of one K3 sweep (``csrc/subcell.cu``): per pencil, a flux and
    a wave speed of its ``n_sub + 2`` states, ``n_sub + 1`` Rusanov faces
    (6 flops per variable and a max), the update of ``n_sub`` subcells (3
    per variable), and its share of the two transverse means (1 add per
    variable each)."""
    per_pencil = ((n_sub + 2) * (FLUX_OPS + EIG_OPS) + (n_sub + 1) * (6 * nvar + 1)
                  + n_sub * 3 * nvar + 2 * nvar)
    return per_pencil * n_pencils


def fv_ops(n_patches: int, dim=3, patch=4, halo=1, nvar=5) -> float:
    """Flops the ``fv`` spec's output needs: per axis a flux and a wave
    speed on the cells its face stencil reaches (the interior and the two
    face halos along the axis), then the flux difference (4 flops) and the
    dissipation (10 flops) per variable on the interior."""
    reached = (patch + 2 * halo) * patch ** (dim - 1)
    per_patch = dim * reached * (FLUX_OPS + EIG_OPS) + dim * patch**dim * nvar * (4 + 10)
    return per_patch * n_patches


def fv_bytes(n_patches: int, itemsize: int, dim=3, patch=4, halo=1, nvar=5) -> int:
    """Bytes the ``fv`` spec's output needs: the state on the cells its
    face stencils reach (the interior and the 2·dim face halos) read once,
    and the interior written once.  The edge and corner halos feed nothing,
    and the halos are not written.  (The kernel itself reads and writes the
    whole padded state.)"""
    reached = patch**dim + 2 * dim * halo * patch ** (dim - 1)
    return (reached + patch**dim) * nvar * itemsize * n_patches


def fv_state(torch, grid, device, dtype, seed=0):
    """``__graft_entry__._example_state``'s recipe (``:31-36``) on the
    SoA-P grid state ``[6, 6, 6, 5, *grid]``: uniform(0.1, 1) from numpy
    ``default_rng(seed)``, +1 on the density, +5 on the energy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q = rng.uniform(0.1, 1.0, size=(6, 6, 6, 5) + tuple(grid)).astype(np.float32)
    q[:, :, :, 0] += 1.0
    q[:, :, :, 4] += 5.0
    return torch.from_numpy(q).to(device=device, dtype=dtype).contiguous()


def interior_mass(torch, u):
    """Sum of each conserved variable over the patch interiors (float64)."""
    return u[1:5, 1:5, 1:5].double().sum(dim=(0, 1, 2, 4, 5, 6))


def sod_state(solver, torch, device, dtype):
    """``bench.py:348-356``: the Sod shock along axis 0, at rest."""
    import numpy as np

    grid = solver.grid_shape
    x = np.arange(grid[0]).reshape(-1, 1, 1) / grid[0]
    left = np.broadcast_to(x < 0.5, grid)
    va = solver.var_axis
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    rho = np.broadcast_to(np.where(left, 1.0, 0.125), no_var).astype(np.float32)
    p = np.broadcast_to(np.where(left, 1.0, 0.1), no_var).astype(np.float32)
    zeros = np.zeros(no_var, np.float32)
    q = np.stack([rho, zeros, zeros, zeros, p / 0.4], axis=va)
    return torch.from_numpy(q).to(device=device, dtype=dtype).contiguous()


def limited_path(torch, dev, card) -> list[dict]:
    """The limited form of the main path; returns the kernel JSON lines of
    the face stage with its face-flux output and of K3."""
    import numpy as np

    from exahype_tpu_torch.models import subcell_cuda
    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible

    flux, eig = euler_physics(3, n_real=5)
    adm = euler_admissible(3)

    def make(grid, dtype, dx=DX):
        sol = ADERDGSolver(3, ORDER, 5, grid, flux, eig, dx=dx, device=dev, dtype=dtype)
        cu = CudaADERDG(sol)
        opts = dict(troubled_capacity=CAPACITY, troubled_granularity="row",
                    dmp_delta0=DMP_DELTA0, device=dev)
        kernel = LimitedADERDG(sol, adm, accelerator=cu, subcell_cuda=True, **opts)
        plain = LimitedADERDG(sol, adm, **opts)
        return sol, cu, kernel, plain

    # --------------------------------- the face stage's face fluxes vs plain
    fhat_err = 0.0
    for grid, dtype in (((8, 4, 32), torch.float64), (GRID, torch.float32)):
        sol, cu, _, _ = make(grid, dtype)
        u = bench_state(sol, torch, dev, dtype) if dtype == torch.float64 else (
            sod_state(sol, torch, dev, dtype))
        new, faces = sol.predictor_volume(u, LIMITED_DT)
        out_k, fl_k = cu.face_surface(new.clone(), faces, LIMITED_DT, return_face_fluxes=True)
        out_p, fl_p = sol.face_surface(new, faces, LIMITED_DT, return_face_fluxes=True)
        torch.cuda.synchronize()
        f64 = dtype == torch.float64
        for what, got, ref in [("new", out_k, out_p)] + [
                (f"fhat[{d}]", a, b) for d, (a, b) in enumerate(zip(fl_k, fl_p))]:
            err = max_err(torch, got, ref)
            limit = F64_ATOL if f64 else f32_bound(torch, ref)
            say(f"[parity] face stage with face fluxes ({what}) "
                f"{str(dtype)[6:]} {grid}: max_abs_err {err:.3e} limit {limit:.3e}")
            if not err <= limit:
                fail(f"the face stage's {what} disagrees with its plain version")
            if not f64:
                fhat_err = max(fhat_err, err)
        del sol, cu, u, new, faces, out_k, fl_k, out_p, fl_p

    # --------------------------------- K3 vs plain, float64, small batch
    _, _, lim64, _ = make((4, 2, 8), torch.float64)
    rng = np.random.default_rng(0)

    def pencils(shape):
        lead = shape[:3] + shape[4:]
        q = np.stack([1.0 + 0.3 * rng.random(lead)]
                     + [0.4 * rng.standard_normal(lead) for _ in range(3)]
                     + [2.5 + rng.random(lead)], axis=3)
        return torch.from_numpy(q).to(dev).contiguous()

    for d in range(3):
        gshape = [7, 7, 7, 5, 8, 16]
        gshape[d] = 1
        s, lo, hi = pencils((7, 7, 7, 5, 8, 16)), pencils(tuple(gshape)), pencils(tuple(gshape))
        got = subcell_cuda.row_sweep_call(lim64, d, s, lo, hi, LIMITED_DT)
        again = subcell_cuda.row_sweep_call(lim64, d, s, lo, hi, LIMITED_DT)
        ref = lim64._row_sweep_math(s, lo, hi, d, LIMITED_DT)
        torch.cuda.synchronize()
        for what, a, b, c in zip(("s_new", "g_lo", "g_hi"), got, again, ref):
            err = max_err(torch, a, c)
            say(f"[parity] subcell_row_sweep d={d} ({what}) float64 K=8 L=16: max_abs_err "
                f"{err:.3e} limit {F64_ATOL:.1e}; repeat bitwise {torch.equal(a, b)}")
            if not (err <= F64_ATOL and torch.equal(a, b)):
                fail(f"K3 (d={d}, {what}, float64) disagrees with its plain version")
    del lim64, s, lo, hi, got, again, ref

    # --------------------------------- the limited main path
    sol, cu, lim, plain = make(GRID, torch.float32)
    u0 = sod_state(sol, torch, dev, torch.float32)
    say(f"[limited] dt = {LIMITED_DT!r} (bench.py:356); cfl_dt(initial state) = "
        f"{float(sol.cfl_dt(u0))!r}; capacity {CAPACITY} rows of {GRID[-1]} cells, "
        f"dmp_delta0 {DMP_DELTA0}")
    u5 = lim.run(u0, WARMUP, LIMITED_DT)
    torch.cuda.synchronize()
    if not torch.isfinite(u5).all():
        fail("the limited state is not finite after the warm-up")

    # K3 on the gathered batch of this state, float32: record the sweeps'
    # inputs of one plain step.
    candidate = cu.step(u5, LIMITED_DT)
    tables = plain._gather_tables_row(plain.troubled_mask(u5, candidate))
    n_active = int(tables["active"].sum())
    recorded = []

    def record(s_, lo_, hi_, d_, dt_):
        recorded.append((d_, s_, lo_, hi_))
        return LimitedADERDG._row_sweep_math(plain, s_, lo_, hi_, d_, dt_)

    plain._row_sweep_math = record
    try:
        plain._gathered_subcell_step_row(u5, LIMITED_DT, tables)
    finally:
        del plain._row_sweep_math
    del candidate
    k3_err, k3_ms, k3_plain_ms = 0.0, {}, {}
    for d, s, lo, hi in recorded:
        got = subcell_cuda.row_sweep_call(lim, d, s, lo, hi, LIMITED_DT)
        again = subcell_cuda.row_sweep_call(lim, d, s, lo, hi, LIMITED_DT)
        ref = plain._row_sweep_math(s, lo, hi, d, LIMITED_DT)
        torch.cuda.synchronize()
        for what, a, b, c in zip(("s_new", "g_lo", "g_hi"), got, again, ref):
            err, limit = max_err(torch, a, c), f32_bound(torch, c)
            say(f"[parity] subcell_row_sweep d={d} ({what}) float32 {tuple(s.shape)} "
                f"(gathered batch after {WARMUP} steps, {n_active} active rows): "
                f"max_abs_err {err:.3e} limit {limit:.3e}; repeat bitwise {torch.equal(a, b)}")
            if not (err <= limit and torch.equal(a, b)):
                fail(f"K3 (d={d}, {what}, float32) disagrees with its plain version")
            k3_err = max(k3_err, err)
        k3_ms[d] = event_ms(torch, lambda: subcell_cuda.row_sweep_call(
            lim, d, s, lo, hi, LIMITED_DT), 20)
        k3_plain_ms[d] = event_ms(torch, lambda: plain._row_sweep_math(
            s, lo, hi, d, LIMITED_DT), 3)
        del got, again, ref
    sweep_shape = tuple(recorded[0][1].shape)
    del recorded, s, lo, hi

    gib = 2.0**-30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cu.reset_launches()
    subcell_cuda.reset_launches()
    u = lim.run(u5, STEPS, LIMITED_DT)
    torch.cuda.synchronize()
    launches = {**cu.launches, **subcell_cuda.launches}
    say(f"[limited main] {STEPS} steps of {GRID} f32 through LimitedADERDG after "
        f"{WARMUP} warm-up steps: launches {launches}; peak "
        f"{torch.cuda.max_memory_allocated() * gib:.4f} GiB allocated ({card})")
    want = {**{name: STEPS for name in cu.kernels}, "subcell_row_sweep": 3 * STEPS}
    if launches != want:
        fail(f"limited main path launches {launches}, expected {want}")
    finite = bool(torch.isfinite(u).all())
    admissible = bool(adm(u, sol.var_axis).all())
    rho_min = u.select(sol.var_axis, 0).min().item()
    say(f"[limited main] full state finite {finite}, admissible {admissible}, "
        f"rho_min {rho_min!r}")
    if tuple(u.shape) != sol.state_shape or not (finite and admissible):
        fail("the limited main-path state is not finite and admissible")

    # Rows demanded at each checked step, from a second run from the same
    # state (which must give the same bits).
    demand, v = [], u5
    for _ in range(STEPS):
        demand.append(int(lim.capacity_usage(v, LIMITED_DT)[0]))
        v = lim.step(v, LIMITED_DT)
    overflow = max(demand) > CAPACITY
    say(f"[limited main] troubled rows demanded per step {demand} against capacity "
        f"{CAPACITY}: overflow engaged {overflow}")
    if not torch.equal(u, v):
        fail("two limited runs from the same state differ")
    say("[limited main] two runs from the same state: bitwise equal")
    del v
    m0, m1 = sol.total_mass(u5.double()), sol.total_mass(u.double())
    rel = ((m1 - m0).abs() / m0.abs()).tolist()
    say(f"[limited main] relative drift over {STEPS} steps: mass {rel[0]:.3e}, energy "
        f"{rel[4]:.3e}; momenta absolute {[(m1 - m0)[k].item() for k in (1, 2, 3)]} "
        f"(limit {MASS_RTOL:.1e} on the mass when no overflow engaged)")
    if not overflow and not rel[0] <= MASS_RTOL:
        fail("limited mass drift beyond its bound")

    # One step of the kernel path against the plain path from this state.
    mask_k = lim.troubled_mask(u, cu.step(u, LIMITED_DT))
    mask_p = plain.troubled_mask(u, sol.step(u, LIMITED_DT))
    step_k, step_p = lim.step(u, LIMITED_DT), plain.step(u, LIMITED_DT)
    torch.cuda.synchronize()
    err, limit = max_err(torch, step_k, step_p), f32_bound(torch, step_p)
    say(f"[limited main] one step, kernel path vs plain path: troubled cells "
        f"{int(mask_k.sum())} (kernel candidate) / {int(mask_p.sum())} (plain), masks "
        f"equal {torch.equal(mask_k, mask_p)}; state max_abs_err {err:.3e} limit {limit:.3e}")
    if not (torch.equal(mask_k, mask_p) and err <= limit):
        fail("the limited kernel path disagrees with the plain path")
    del mask_k, mask_p, step_k, step_p

    # ------------------------------------------------ times
    dofs = sol.dofs()
    k_win = windows(torch, lim, u5, LIMITED_DT, steps=STEPS)
    p_win = windows(torch, plain, u5, LIMITED_DT, steps=2, n_windows=1)
    for label, win in (("kernel path", k_win), ("plain path", p_win)):
        ms = [1e3 * w for w in win]
        say(f"[limited time] {label}: step ms per window {ms!r}; median "
            f"{statistics.median(ms)!r} ms, {dofs / statistics.median(win)!r} "
            f"DOF-updates/s ({dofs} DOF per step; {card})")
    new, faces = cu.predictor_volume(u5, LIMITED_DT)
    fhat = cu.face_flux(faces)
    parts = {
        "aderdg_predictor_volume": event_ms(
            torch, lambda: cu.predictor_volume(u5, LIMITED_DT), 10),
        "face stage (no face fluxes)": event_ms(
            torch, lambda: cu.face_surface(new, faces, LIMITED_DT), 10),
        "face stage (face fluxes)": event_ms(
            torch, lambda: cu.face_surface(new, faces, LIMITED_DT, True), 10),
        **{f"subcell_row_sweep d={d}": k3_ms[d] for d in range(3)},
    }
    # The face stage's launches alone, as the limited step makes them.
    launch_ms = {
        "aderdg_predictor_volume": parts["aderdg_predictor_volume"],
        "aderdg_face_flux": event_ms(torch, lambda: cu.face_flux(faces), 10),
        "aderdg_surface_update": event_ms(
            torch, lambda: cu.surface_update(new, fhat, LIMITED_DT), 10),
    }
    face_plain_ms = event_ms(torch, lambda: sol.face_surface(new, faces, LIMITED_DT, True), 3)
    step_ms = event_ms(torch, lambda: lim.step(u5, LIMITED_DT), 10)
    rest = step_ms - sum(v for k, v in parts.items() if "no face" not in k)
    say(f"[limited time] per call (CUDA events): " + ", ".join(
        f"{k} {v!r} ms" for k, v in parts.items()) + f"; whole step {step_ms!r} ms, "
        f"of which the rest of the step (detection, tables, gathers, projections, "
        f"ghosts, scatters, matching, guard) {rest!r} ms ({card})")
    say(f"[limited time] plain versions (CUDA events): face_surface with face fluxes "
        f"{face_plain_ms!r} ms; sweeps " + ", ".join(
            f"d={d} {k3_plain_ms[d]!r} ms" for d in range(3)) + f" ({card})")
    del new, faces, fhat

    # The step's stages one by one on this state (CUDA events); the
    # fallback scatter is idempotent, so it is timed in place.
    cand, dg_fl = cu.step(u5, LIMITED_DT, return_face_fluxes=True)
    raw = lim.troubled_mask(u5, cand)
    tab = lim._gather_tables_row(raw)
    R, g = lim._gathered_subcell_step_row(u5, LIMITED_DT, tab)
    fv = lim._scatter_face_fluxes_row(g, tab, u5.dtype)
    matched = lim._match_interface_fluxes(cand, dg_fl, fv, tab["mask"], LIMITED_DT)
    stages = {
        "troubled_mask": lambda: lim.troubled_mask(u5, cand),
        "_gather_tables_row": lambda: lim._gather_tables_row(raw),
        "_gathered_subcell_step_row (3 sweeps included)":
            lambda: lim._gathered_subcell_step_row(u5, LIMITED_DT, tab),
        "_scatter_face_fluxes_row": lambda: lim._scatter_face_fluxes_row(g, tab, u5.dtype),
        "_match_interface_fluxes": lambda: lim._match_interface_fluxes(
            cand, dg_fl, fv, tab["mask"], LIMITED_DT),
        "_scatter_fallback_row": lambda: lim._scatter_fallback_row(
            matched, R, tab, tab["mask"]),
        "overflow flag": lambda: bool((raw & ~tab["mask"]).any()),
        "_admissibility_scale": lambda: lim._admissibility_scale(matched),
    }
    stage_ms = {k: event_ms(torch, fn, 5) for k, fn in stages.items()}
    say(f"[limited time] the step's stages alone (CUDA events, 5 calls each): " + ", ".join(
        f"{k} {v!r} ms" for k, v in stage_ms.items()) + f"; sweeps {sum(k3_ms.values())!r} "
        f"ms of the gathered step ({card})")
    del cand, dg_fl, raw, tab, R, g, fv, matched

    # Host synchronisations of one step, and where the port's code makes
    # them (torch.cuda's sync debug mode warns at each; switching it on
    # warns once itself, which is not counted).
    import traceback
    import warnings

    sites = []

    def where_synced(message, *args, **kwargs):
        if "synchroniz" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1]
                    if pathlib.Path(f.filename).resolve().is_relative_to(HERE)]
            sites.append(f"{pathlib.Path(ours[-1].filename).resolve().relative_to(HERE)}:"
                         f"{ours[-1].lineno}" if ours else "no frame of this repository")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = where_synced
        torch.cuda.set_sync_debug_mode("warn")
        sites.clear()
        try:
            lim.step(u5, LIMITED_DT)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for label, solver, n in (("kernel path", lim, STEPS), ("plain path", plain, 2)):
        idle, busy, wall = idle_share(torch, lambda: solver.run(u5, n, LIMITED_DT))
        say(f"[limited idle] {label}, {n} steps under torch.profiler: device busy "
            f"{busy!r} ms of wall {wall!r} ms; idle share {idle!r} ({card})")
    say(f"[limited time] host synchronisations per kernel-path step "
        f"(torch.cuda sync debug mode): {len(sites)}, at {sites}")

    # ------------------------------------------------ bounds
    itemsize = u5.element_size()
    ncell = math.prod(GRID)
    face_bytes = torch.empty(sol.face_shape, dtype=u5.dtype, device="meta").nbytes
    fhat_bytes = 3 * sol.n_nodes**2 * sol.n_vars * ncell * itemsize
    state_bytes = u5.nbytes
    work = {
        "aderdg_predictor_volume": (2 * state_bytes + face_bytes,
                                    predictor_ops(ORDER, sol.picard_iters, ncell)),
        "aderdg_face_flux": (face_flux_bytes(ORDER, ncell, itemsize),
                             face_flux_ops(ORDER, ncell)),
        "aderdg_surface_update": (surface_update_bytes(ORDER, ncell, itemsize),
                                  surface_update_ops(ORDER, ncell)),
    }
    for name in cu.kernels:
        kernel_report(cu, name, torch.float32, f"(Euler, limited path) {GRID} f32",
                      launch_ms[name], *work[name], card)
    face_bnd = kernel_report(
        None, "face stage with face fluxes", torch.float32, f"(Euler, limited path) {GRID} f32",
        parts["face stage (face fluxes)"], face_fhat_bytes(face_bytes, u5.nbytes, fhat_bytes),
        face_surface_ops(ORDER, ncell), card)
    pencils_needed = 49 * n_active * GRID[-1]
    pencils_run = 49 * sweep_shape[4] * sweep_shape[5]
    k3_bnd = bound(sweep_bytes(pencils_needed, itemsize), sweep_ops(pencils_needed))
    k3_bnd_full = bound(sweep_bytes(pencils_run, itemsize), sweep_ops(pencils_run))
    say(f"[bound] subcell_row_sweep f32, one sweep: bound {k3_bnd['bound_ms']!r} ms by "
        f"{k3_bnd['bound_by']} for the {n_active} active rows "
        f"({sweep_bytes(pencils_needed, itemsize)} B, {sweep_ops(pencils_needed)!r} "
        f"flops); {k3_bnd_full['bound_ms']!r} ms for all {sweep_shape[4]} slots "
        f"({sweep_bytes(pencils_run, itemsize)} B); kernel mean "
        f"{statistics.mean(k3_ms.values())!r} ms ({card})")
    return [
        kernel_line("aderdg_face_flux + aderdg_surface_update (face stage with face fluxes, "
                    "limited path)", "exahype_tpu/models/aderdg_pallas.py:156",
                    launches["aderdg_surface_update"], fhat_err,
                    parts["face stage (face fluxes)"], face_plain_ms, face_bnd),
        {
            "name": "subcell_row_sweep",
            "route": "cuda",
            "source": "exahype_tpu_torch/csrc/subcell.cu",
            "replaces": "exahype_tpu/models/subcell_pallas.py:47",
            "launches": launches["subcell_row_sweep"],
            "max_abs_err": k3_err,
            "ms": statistics.mean(k3_ms.values()),
            "plain_ms": statistics.mean(k3_plain_ms.values()),
            **k3_bnd,
            "library_ms": None,  # no single PyTorch call computes it
        },
    ]


def ck_path(torch, dev, card) -> list[dict]:
    """The CK form of the main path; returns the kernel JSON lines of K2,
    of the face stage's elastic variant and of its two kernels (at
    ``(256, 8, 128)``)."""
    import numpy as np

    from exahype_tpu_torch.models.aderdg import ADERDGSolver
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.elastic import (
        DISSIPATION_MASK,
        MATERIAL_SLOTS,
        N_VARS_3D_HET,
        elastic3d_heterogeneous,
        seismic_energy,
        two_layer_state,
    )

    flux, eig = elastic3d_heterogeneous()
    E = CK_EVOLVED

    def make(grid, dtype):
        sol = ADERDGSolver(3, ORDER, N_VARS_3D_HET, grid, flux, eig, dx=1.0 / grid[0],
                           device=dev, dtype=dtype, predictor_mode="ck",
                           ck_material_slots=MATERIAL_SLOTS,
                           dissipation_mask=DISSIPATION_MASK)
        return sol, CudaADERDG(sol)

    def initial(sol, dtype):
        q, mat = two_layer_state(sol)
        return (torch.from_numpy(q).to(dev, dtype).contiguous(),
                torch.from_numpy(np.ascontiguousarray(mat)).to(dev, dtype))

    def mats(q, va=3):
        return q.narrow(va, E, N_VARS_3D_HET - E)

    def frozen(q, mat):
        return torch.equal(mats(q), mat)  # values: -0.0 == 0.0

    # ------------------------------- K2 and the elastic face stage vs plain
    errs = {name: 0.0 for name in ("aderdg_ck_predictor_volume", "face stage",
                                   "aderdg_face_flux", "aderdg_surface_update")}
    for grid, dtype in (((8, 4, 32), torch.float64),) + tuple(
            (g, torch.float32) for g in CK_GRIDS):
        sol, cu = make(grid, dtype)
        u, mat = initial(sol, dtype)
        dt = CK_DT if grid[0] <= 64 else float(sol.cfl_dt(u))
        u_in = u.clone()
        new_k, faces_k = cu.predictor_volume(u, dt)
        new_p, faces_p = sol.predictor_volume(u, dt)
        surf_k = cu.face_surface(new_p.clone(), faces_p, dt)
        surf_p = sol.face_surface(new_p, faces_p, dt)
        # F̂ as the face stage returns it: aderdg_face_flux leaves the
        # material rows unwritten, and the wrapper zeroes them.
        surf_f, fl_k = cu.face_surface(new_p.clone(), faces_p, dt, return_face_fluxes=True)
        fhat_p = plain_face_flux(torch, sol, faces_p)
        fhat_k = torch.stack(fl_k).view(fhat_p.shape)
        upd_k = cu.surface_update(new_p.clone(), fhat_p, dt)
        upd_p = plain_surface_update(sol, new_p, fhat_p, dt)
        step_k = cu.step(u, dt)
        step_p = sol.step(u, dt)
        torch.cuda.synchronize()
        if not torch.equal(u, u_in):
            fail("the CK step modified its input")
        f64 = dtype == torch.float64
        for name, what, got, ref, va in (
            ("aderdg_ck_predictor_volume", "new", new_k, new_p, 3),
            ("aderdg_ck_predictor_volume", "faces", faces_k, faces_p, 3),
            ("face stage", "new", surf_k, surf_p, 3),
            ("aderdg_face_flux", "fhat", fhat_k, fhat_p, 2),
            ("aderdg_surface_update", "new", upd_k, upd_p, 3),
            ("step", "new", step_k, step_p, 3),
        ):
            # The evolved rows against the bound of their own largest value,
            # the material rows against theirs (the wave is ~1e-3, the
            # materials up to 3; their face fluxes are zero).
            for rows, lo, n in (("evolved", 0, E), ("material", E, N_VARS_3D_HET - E)):
                g, r = got.narrow(va, lo, n), ref.narrow(va, lo, n)
                err = max_err(torch, g, r)
                limit = F64_ATOL if f64 else f32_bound(torch, r)
                ok = err <= limit
                say(f"[ck parity] {name} ({what}, {rows} rows) {str(dtype)[6:]} {grid}: "
                    f"max_abs_err {err:.3e} limit {limit:.3e} "
                    f"({'atol' if f64 else f'{F32_ULPS} f32 spacings of max|plain|'}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"CK {name} ({what}, {rows} rows) disagrees with its plain "
                         f"version ({dtype}, {grid})")
                if name in errs and not f64 and grid == CK_GRIDS[-1]:
                    errs[name] = max(errs[name], err)
        exact = {
            "predictor new": frozen(new_k, mat), "face-stage new": frozen(surf_k, mat),
            "surface-update new": frozen(upd_k, mat), "step": frozen(step_k, mat),
            "material flux rows of the faces zero": not bool(mats(faces_k[:, 2:], 3).any()),
            "material rows of the returned face fluxes zero": not bool(mats(fhat_k, 2).any()),
            "face-stage new with face fluxes bitwise equal": torch.equal(surf_f, surf_k),
        }
        say(f"[ck parity] kernel materials {str(dtype)[6:]} {grid}: {exact}")
        if not all(exact.values()):
            fail(f"the CK kernels moved the material slots, wrote nonzero material fluxes or "
                 f"changed bits with the face-flux output ({dtype}, {grid})")
        del sol, cu, u, u_in, mat, new_k, faces_k, new_p, faces_p, surf_k, surf_p
        del surf_f, fl_k, fhat_k, fhat_p, upd_k, upd_p, step_k, step_p, got, ref, g, r
        torch.cuda.empty_cache()

    # ------------------------------- the main path at both grids
    lines = None
    for grid in CK_GRIDS:
        sol, cu = make(grid, torch.float32)
        u0, mat = initial(sol, torch.float32)
        e = lambda q: float(seismic_energy(q.double(), 3, mat.double()))  # noqa: E731
        bench_grid = grid == CK_GRIDS[0]
        cfl = float(sol.cfl_dt(u0))
        dt = CK_DT if bench_grid else cfl
        warm, steps = (CK_WARMUP, CK_WINDOW) if bench_grid else (0, STEPS)
        say(f"[ck] {grid}: dt = {dt!r} ({'bench.py:204' if bench_grid else 'cfl_dt'}); "
            f"cfl_dt(initial state) = {cfl!r}; {warm} warm-up steps, then {steps}")
        ustart = cu.run(u0, warm, dt)
        torch.cuda.synchronize()
        half = steps // 2
        cu.reset_launches()
        mid = cu.run(ustart, half, dt)
        u = cu.run(mid, steps - half, dt)
        torch.cuda.synchronize()
        launches = dict(cu.launches)
        say(f"[ck main] {steps} steps of {grid} f32 through CudaADERDG: launches {launches}")
        want = {name: steps for name in cu.kernels}
        if launches != want:
            fail(f"CK main path launches {launches}, expected {want}")
        finite, is_frozen = bool(torch.isfinite(u).all()), frozen(u, mat)
        e0, em, e1 = e(ustart), e(mid), e(u)
        say(f"[ck main] full state finite {finite}; slots 9-11 bitwise equal to the "
            f"initial materials {is_frozen}; seismic energy ratio {e1 / e0!r} over the "
            f"{steps} steps (first half {em / e0!r}, second half {e1 / em!r}); gate "
            f"{CK_ENERGY_GATE} (bench.py:280){' applied' if bench_grid else ', read only'}")
        if tuple(u.shape) != sol.state_shape or not (finite and is_frozen):
            fail("the CK main-path state is not finite or its materials moved")
        if bench_grid and not e1 / e0 < CK_ENERGY_GATE:
            fail(f"the CK seismic energy grew by {e1 / e0} over the bench's window")
        again = cu.run(ustart, steps, dt)
        if not torch.equal(u, again):
            fail("two CK runs from the same state differ")
        say("[ck main] two runs from the same state: bitwise equal")
        del again, mid
        plain_u = sol.run(ustart, steps, dt)
        run_err = max_err(torch, u.narrow(3, 0, E), plain_u.narrow(3, 0, E))
        run_bound = steps * f32_bound(torch, plain_u.narrow(3, 0, E))
        plain_frozen = frozen(plain_u, mat)
        say(f"[ck main] {steps}-step kernel path vs plain path (evolved rows): max_abs_err "
            f"{run_err:.3e} limit {run_bound:.3e}; plain path's materials frozen "
            f"{plain_frozen}; plain energy ratio {e(plain_u) / e0!r}")
        if not (run_err <= run_bound and plain_frozen):
            fail("the CK main path disagrees with the plain path")
        del plain_u

        # ------------------------------------------------ times
        ncell = math.prod(grid)
        evolved_dofs = ncell * sol.n_nodes**3 * E
        k_win = windows(torch, cu, ustart, dt, steps=20)
        p_win = windows(torch, sol, ustart, dt, steps=2, n_windows=1)
        for label, win in (("kernel path", k_win), ("plain path", p_win)):
            ms = [1e3 * w for w in win]
            say(f"[ck time] {grid} {label}: step ms per window {ms!r}; median "
                f"{statistics.median(ms)!r} ms, {evolved_dofs / statistics.median(win)!r} "
                f"evolved-DOF-updates/s ({evolved_dofs} evolved DOF per step; {card})")
        new, faces = cu.predictor_volume(ustart, dt)
        fhat = cu.face_flux(faces)
        times = {
            "aderdg_ck_predictor_volume": (
                event_ms(torch, lambda: cu.predictor_volume(ustart, dt), 20),
                event_ms(torch, lambda: sol.predictor_volume(ustart, dt), 3),
            ),
            "face stage": (
                event_ms(torch, lambda: cu.face_surface(new, faces, dt), 20),
                event_ms(torch, lambda: sol.face_surface(new, faces, dt), 3),
            ),
            "aderdg_face_flux": (
                event_ms(torch, lambda: cu.face_flux(faces), 20),
                event_ms(torch, lambda: plain_face_flux(torch, sol, faces), 3),
            ),
            "aderdg_surface_update": (
                event_ms(torch, lambda: cu.surface_update(new, fhat, dt), 20),
                event_ms(torch, lambda: plain_surface_update(sol, new, fhat, dt), 3),
            ),
        }
        for name, (ms, plain_ms) in times.items():
            say(f"[ck time] {grid} {name}: kernel {ms!r} ms, plain {plain_ms!r} ms "
                f"(CUDA events; {card})")
        del new, fhat
        for label, solver, n in (("kernel path", cu, 20), ("plain path", sol, 2)):
            idle, busy, wall = idle_share(torch, lambda: solver.run(ustart, n, dt))
            say(f"[ck idle] {grid} {label}, {n} steps under torch.profiler: device busy "
                f"{busy!r} ms of wall {wall!r} ms; idle share {idle!r} ({card})")
        # The face stage's bound is the pair's; it and its kernels' count
        # only the rows their work needs (no flux and no update of the
        # frozen materials).
        state_bytes = ustart.nbytes
        face_bytes = faces.nbytes
        itemsize = ustart.element_size()
        elastic = dict(nvar=N_VARS_3D_HET, eig_ops=ELASTIC_EIG_OPS, masked=True)
        work = {
            "aderdg_ck_predictor_volume": (ck_bytes(state_bytes, face_bytes),
                                           ck_predictor_ops(ORDER, ncell)),
            "aderdg_face_flux": (
                face_flux_bytes(ORDER, ncell, itemsize, nvar=N_VARS_3D_HET, rows=E),
                face_flux_ops(ORDER, ncell, **elastic)),
            "aderdg_surface_update": (surface_update_bytes(ORDER, ncell, itemsize, rows=E),
                                      surface_update_ops(ORDER, ncell, nvar=E)),
            "face stage": (
                face_stage_bytes(ORDER, ncell, itemsize, nvar=N_VARS_3D_HET, rows=E),
                face_surface_ops(ORDER, ncell, **elastic)),
        }
        del faces
        bounds = {
            name: kernel_report(None if name == "face stage" else cu, name, torch.float32,
                                f"(CK, elastic) {grid} f32", times[name][0], *work[name], card)
            for name in (*cu.kernels, "face stage")
        }
        if grid != CK_GRIDS[-1]:
            continue
        # The kernels at the grid where the card is the limit.
        replaces = {"aderdg_ck_predictor_volume": "exahype_tpu/models/aderdg_pallas.py:358"}
        lines = [
            kernel_line(name, replaces.get(name, "exahype_tpu/models/aderdg_pallas.py:156"),
                        launches[name], errs[name], *times[name], bounds[name])
            for name in cu.kernels
        ]
        lines.append(kernel_line(
            "aderdg_face_flux + aderdg_surface_update (face stage, 12-var elastic, "
            "dissipation mask, CK path)", "exahype_tpu/models/aderdg_pallas.py:156",
            launches["aderdg_surface_update"], errs["face stage"], *times["face stage"],
            bounds["face stage"]))
    return lines


def fv_path(torch, dev, card, spec_printers) -> dict:
    """The FV form of the main path; returns K4's line of the kernel JSON."""
    from exahype_tpu_torch.models import euler
    from exahype_tpu_torch.models.fv import build_fv_rusanov_kernel
    from exahype_tpu_torch.parallel.grid import TpuPatchGrid
    from exahype_tpu_torch.parallel.solver import GridSolver

    for name, pr in spec_printers.items():
        say(f"[fv] K4 {name} spec: {pr.bytes_per_patch(torch.float32)} B of shared "
            f"memory per patch in f32; tiles {pr.tiles[torch.float32]} (f32) and "
            f"{pr.tiles[torch.float64]} (f64) patches per block")

    def solver(grid, dtype=torch.float32):
        kb = build_fv_rusanov_kernel(**FV_WIDTH, n_patches=math.prod(grid))
        return GridSolver(
            TpuPatchGrid(kb.config, grid), kb, dx=1.0 / (4 * grid[0]), cfl=FV_CFL,
            eigenvalue_fn=euler.wave_speed_fn(3), kernel_dt="lambda",
            device=dev, dtype=dtype,
        )

    # ------------------------------------------------ K4 vs plain
    big = FV_GRIDS[-1]
    k4_err = None
    for name, grid, dtype in (("fv", (2, 2, 2), torch.float64),
                              ("rusanov", (2, 2, 2), torch.float64),
                              ("fv", big, torch.float32)):
        fn = spec_printers[name].build()
        q = fv_state(torch, grid, dev, dtype)
        lam = 0.05  # λ = dt/dx, inside the CFL limit of this state (~0.19)
        got = fn(q.clone(), lam)
        by_ptr = fn(q.clone(), torch.tensor(lam, device=dev, dtype=dtype))
        ref = fn.plain(q.clone(), lam)
        torch.cuda.synchronize()
        err = max_err(torch, got, ref)
        f64 = dtype == torch.float64
        limit = F64_ATOL if f64 else f32_bound(torch, ref)
        ok = err <= limit and torch.equal(got, by_ptr) and fn.launches == 2
        say(f"[parity] K4 {name} spec {str(dtype)[6:]} {grid}: max_abs_err {err:.3e} "
            f"limit {limit:.3e} ({'atol' if f64 else f'{F32_ULPS} f32 spacings'}); "
            f"λ by pointer == by value: {torch.equal(got, by_ptr)}; "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K4 ({name} spec, {dtype}, {grid}) disagrees with its plain version")
        if grid == big:
            k4_err = err
        del q, got, by_ptr, ref

    # ------------------------------------------------ main path, both sizes
    record = None
    for grid in FV_GRIDS:
        sv = solver(grid)
        u0 = fv_state(torch, grid, dev, torch.float32)
        n_patches = sv.grid.config.n_patches
        sv.kernel_fn.launches = 0
        u, t = sv.run(u0, STEPS)
        torch.cuda.synchronize()
        launches = sv.kernel_fn.launches
        say(f"[fv main] {STEPS} CFL steps of {grid} ({n_patches} patches) f32 "
            f"through GridSolver: K4 launches {launches}; t = {float(t)!r}")
        if launches != STEPS:
            fail(f"K4 launched {launches} times in {STEPS} FV main-path steps")
        if tuple(u.shape) != sv.grid.state_shape or not torch.isfinite(u).all():
            fail("FV main-path state is not finite or has the wrong shape")
        m0, m1 = interior_mass(torch, u0), interior_mass(torch, u)
        drift = ((m1 - m0).abs() / m0.abs()).max().item()
        say(f"[fv main] mass drift over {STEPS} steps (max rel over 5 vars): "
            f"{drift:.3e} limit {MASS_RTOL:.1e}")
        if not drift <= MASS_RTOL:
            fail("FV mass drift beyond its bound")
        again, _ = sv.run(u0, STEPS)
        if not torch.equal(u, again):
            fail("two FV runs from the same state differ")
        say("[fv main] two runs from the same state: bitwise equal")
        plain = copy.copy(sv)
        plain.kernel_fn = sv.kernel_fn.plain
        plain_u, _ = plain.run(u0, STEPS)
        run_err = max_err(torch, u, plain_u)
        run_bound = STEPS * f32_bound(torch, plain_u)
        say(f"[fv main] {STEPS}-step kernel path vs plain path: max_abs_err "
            f"{run_err:.3e} limit {run_bound:.3e}")
        if not run_err <= run_bound:
            fail("FV main path disagrees with the plain path")
        del again, plain_u, u

        # -------------------------------------------- times
        dofs = sv.dofs()
        steps = 20
        k_win = windows(torch, sv, u0, None, steps=steps)
        p_win = windows(torch, plain, u0, None, steps=3)
        for label, win in (("kernel path", k_win), ("plain path", p_win)):
            ms = [1e3 * w for w in win]
            say(f"[fv time] {grid} {label}: step ms per window {ms!r}; median "
                f"{statistics.median(ms)!r} ms, {dofs / statistics.median(win)!r} "
                f"DOF-updates/s ({dofs} DOF per step; {card})")
        q = u0.clone()
        lam = sv.compute_dt(q) / sv.dx
        parts = {
            "K4 kernel": event_ms(torch, lambda: sv.kernel_fn(q, lam), steps),
            "K4 plain": event_ms(torch, lambda: sv.kernel_fn.plain(q, lam), 3),
            "halo_fill": event_ms(torch, lambda: sv.grid.halo_fill(q), steps),
            "compute_dt": event_ms(torch, lambda: sv.compute_dt(q), steps),
        }
        say(f"[fv time] {grid} per call (CUDA events): " + ", ".join(
            f"{k} {v!r} ms" for k, v in parts.items()) + f" ({card})")
        for label, solv, n in (("kernel path", sv, steps), ("plain path", plain, 3)):
            idle, busy, wall = idle_share(torch, lambda: solv.run(u0, n))
            say(f"[fv idle] {grid} {label}, {n} steps under torch.profiler: device "
                f"busy {busy!r} ms of wall {wall!r} ms; idle share {idle!r} ({card})")
        needed = fv_bytes(n_patches, u0.element_size())
        bnd = bound(needed, fv_ops(n_patches))
        say(f"[bound] K4 fv {grid} f32: bound {bnd['bound_ms']!r} ms by "
            f"{bnd['bound_by']} ({needed} B needed, {fv_ops(n_patches)!r} flops); "
            f"kernel {parts['K4 kernel']!r} ms, moving {2 * u0.nbytes} B (the whole "
            f"padded state read and written: {1e3 * 2 * u0.nbytes / PEAK_BYTES!r} ms "
            f"at the memory rate) ({card})")
        if grid == big:
            record = {
                "name": "spec_kernel (fv Rusanov spec, generated)",
                "route": "cuda",
                "source": "exahype_tpu_torch/backends/cuda_backend.py",
                "replaces": "exahype_tpu/backends/pallas_backend.py:202",
                "launches": launches,
                "max_abs_err": k4_err,
                "ms": parts["K4 kernel"],
                "plain_ms": parts["K4 plain"],
                **bnd,
                "library_ms": None,  # no single PyTorch call computes it
            }
        del sv, plain, u0, q
        torch.cuda.empty_cache()
    return record


def aderdg_path(torch, dev, card) -> list[dict]:
    """The ADER-DG form of the main path; returns the kernel JSON lines of
    its three kernels and of the face stage (the pair of launches)."""
    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

    flux, eig = euler_physics(3, n_real=5)

    def make(grid, dtype):
        sol = ADERDGSolver(3, ORDER, 5, grid, flux, eig, dx=DX,
                           device=dev, dtype=dtype)
        return sol, CudaADERDG(sol)

    sol, cu = make(GRID, torch.float32)
    u0 = bench_state(sol, torch, dev, torch.float32)
    dt = float(cu.cfl_dt(u0))  # once, at set-up
    say(f"[main] dt = cfl_dt(initial state) = {dt!r} (bench.py's 1e-4 "
        "exceeds the CFL limit)")

    # ------------------------------------------- 3. kernel vs plain
    errs = {}
    for grid, dtype in (((8, 4, 32), torch.float64), (GRID, torch.float32)):
        psol, pcu = make(grid, dtype)
        u = bench_state(psol, torch, dev, dtype)
        u_in = u.clone()
        new_k, faces_k = pcu.predictor_volume(u, dt)
        new_p, faces_p = psol.predictor_volume(u, dt)
        surf_k = pcu.face_surface(new_p.clone(), faces_p, dt)
        surf_p = psol.face_surface(new_p, faces_p, dt)
        fhat_k, fhat_p = pcu.face_flux(faces_p), plain_face_flux(torch, psol, faces_p)
        upd_k = pcu.surface_update(new_p.clone(), fhat_p, dt)
        upd_p = plain_surface_update(psol, new_p, fhat_p, dt)
        step_k = pcu.step(u, dt)
        step_p = psol.step(u, dt)
        torch.cuda.synchronize()
        if not torch.equal(u, u_in):
            fail("the step modified its input")
        f64 = dtype == torch.float64
        rule = "atol" if f64 else f"{F32_ULPS} f32 spacings of max|plain|"
        for name, what, got, ref in (
            ("aderdg_predictor_volume", "new", new_k, new_p),
            ("aderdg_predictor_volume", "faces", faces_k, faces_p),
            ("face stage", "new", surf_k, surf_p),
            ("aderdg_face_flux", "fhat", fhat_k, fhat_p),
            ("aderdg_surface_update", "new", upd_k, upd_p),
            ("step", "new", step_k, step_p),
        ):
            err = max_err(torch, got, ref)
            limit = F64_ATOL if f64 else f32_bound(torch, ref)
            ok = err <= limit
            say(f"[parity] {name} ({what}) {str(dtype)[6:]} {grid}: "
                f"max_abs_err {err:.3e} limit {limit:.3e} ({rule}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} disagrees with its plain version ({dtype}, {grid})")
            if grid == GRID:
                errs[name] = max(errs.get(name, 0.0), err)
        if grid == GRID:
            # Both float32 paths against the float64 plain step.
            sol64, _ = make(GRID, torch.float64)
            ref64 = sol64.step(u.double(), dt)
            say(f"[parity] float32 step vs float64 plain step {grid}: kernel "
                f"{max_err(torch, step_k, ref64):.3e}, plain "
                f"{max_err(torch, step_p, ref64):.3e}")
            del sol64, ref64
        del psol, pcu, u, u_in, new_k, faces_k, new_p, faces_p, surf_k, surf_p
        del fhat_k, fhat_p, upd_k, upd_p, step_k, step_p, got, ref

    # --------------------------------------------------- 4. main path
    gib = 2.0**-30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cu.reset_launches()
    u = cu.run(u0, STEPS, dt)
    torch.cuda.synchronize()
    launches = dict(cu.launches)
    say(f"[mem] kernel path, {STEPS} steps: peak {torch.cuda.max_memory_allocated() * gib:.4f} "
        f"GiB allocated ({held * gib:.4f} GiB held before: initial state, "
        f"operators) ({card})")
    say(f"[main] {STEPS} steps of {GRID} f32 through CudaADERDG: launches "
        f"{launches}")
    for name, n in launches.items():
        if n != STEPS:
            fail(f"{name} launched {n} times in {STEPS} main-path steps")
    if tuple(u.shape) != sol.state_shape or not torch.isfinite(u).all():
        fail("main-path state is not finite or has the wrong shape")
    m0 = cu.total_mass(u0.double())
    m1 = cu.total_mass(u.double())
    drift = ((m1 - m0).abs() / m0.abs()).max().item()
    say(f"[main] mass drift over {STEPS} steps (max rel over 5 vars): "
        f"{drift:.3e} limit {MASS_RTOL:.1e}")
    if not drift <= MASS_RTOL:
        fail("mass drift beyond its bound")
    again = cu.run(u0, STEPS, dt)
    if not torch.equal(u, again):
        fail("two runs from the same state differ")
    say("[main] two runs from the same state: bitwise equal")
    del again
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    plain_u = sol.run(u0, STEPS, dt)
    torch.cuda.synchronize()
    say(f"[mem] plain path, {STEPS} steps: peak {torch.cuda.max_memory_allocated() * gib:.4f} "
        f"GiB allocated ({held * gib:.4f} GiB held before: initial state, "
        f"kernel-path result, operators) ({card})")
    run_err = max_err(torch, u, plain_u)
    run_bound = STEPS * f32_bound(torch, plain_u)
    say(f"[main] {STEPS}-step kernel path vs plain path: max_abs_err "
        f"{run_err:.3e} limit {run_bound:.3e}")
    if not run_err <= run_bound:
        fail("main path disagrees with the plain path")
    del plain_u

    # --------------------------------------------------------- 5. times
    dofs = cu.dofs()
    k_win = windows(torch, cu, u0, dt, steps=20)
    p_win = windows(torch, sol, u0, dt, steps=3)
    for label, win in (("kernel path", k_win), ("plain path", p_win)):
        ms = [1e3 * s for s in win]
        say(f"[time] {label}: step ms per window {ms!r}; "
            f"median {statistics.median(ms)!r} ms, "
            f"{dofs / statistics.median(win)!r} DOF-updates/s "
            f"({card})")
    new, faces = cu.predictor_volume(u0, dt)
    fhat = cu.face_flux(faces)
    times = {
        "aderdg_predictor_volume": (
            event_ms(torch, lambda: cu.predictor_volume(u0, dt), 20),
            event_ms(torch, lambda: sol.predictor_volume(u0, dt), 3),
        ),
        "face stage": (
            event_ms(torch, lambda: cu.face_surface(new, faces, dt), 20),
            event_ms(torch, lambda: sol.face_surface(new, faces, dt), 3),
        ),
        "aderdg_face_flux": (
            event_ms(torch, lambda: cu.face_flux(faces), 20),
            event_ms(torch, lambda: plain_face_flux(torch, sol, faces), 3),
        ),
        "aderdg_surface_update": (
            event_ms(torch, lambda: cu.surface_update(new, fhat, dt), 20),
            event_ms(torch, lambda: plain_surface_update(sol, new, fhat, dt), 3),
        ),
    }
    for name, (ms, plain_ms) in times.items():
        say(f"[time] {name}: kernel {ms!r} ms, plain {plain_ms!r} ms "
            f"(CUDA events; {card})")
    del new, faces, fhat
    for label, solver, steps in (("kernel path", cu, 20), ("plain path", sol, 3)):
        idle, busy, wall = idle_share(torch, lambda: solver.run(u0, steps, dt))
        say(f"[idle] {label}, {steps} steps under torch.profiler: device busy "
            f"{busy!r} ms (union of device intervals) of wall {wall!r} ms; "
            f"idle share {idle!r} ({card})")

    # ------------------------------------------ bench.py's own dt, for the record
    kernel_k = first_nonfinite(torch, cu, u0, 1e-4, 30)
    plain_k = first_nonfinite(torch, sol, u0, 1e-4, 30)
    say(f"[dt] bench.py's dt = 1e-4 from the initial state: first non-finite "
        f"state after step {kernel_k} (kernel path), {plain_k} (plain path); "
        "None = finite for 30 steps")

    # Least times of each kernel's work at the bench shape (this run's
    # tensors): the bytes it must move (inputs read once, outputs written
    # once) and the flops of its arithmetic (analytic count).  The face
    # stage's bound is the pair's: the faces and the state read, the state
    # written (F̂ is an intermediate; :func:`face_stage_bytes`).
    ncell = sol.dofs() // (sol.n_nodes**3 * sol.n_vars)
    face_bytes = torch.empty(sol.face_shape, dtype=u0.dtype, device="meta").nbytes
    state_bytes = u0.nbytes
    itemsize = u0.element_size()
    work = {
        "aderdg_predictor_volume": (2 * state_bytes + face_bytes,
                                    predictor_ops(ORDER, sol.picard_iters, ncell)),
        "aderdg_face_flux": (face_flux_bytes(ORDER, ncell, itemsize),
                             face_flux_ops(ORDER, ncell)),
        "aderdg_surface_update": (surface_update_bytes(ORDER, ncell, itemsize),
                                  surface_update_ops(ORDER, ncell)),
        "face stage": (face_stage_bytes(ORDER, ncell, itemsize), face_surface_ops(ORDER, ncell)),
    }
    bounds = {
        name: kernel_report(None if name == "face stage" else cu, name, torch.float32,
                            f"(Euler) {GRID} f32", times[name][0], *work[name], card)
        for name in (*cu.kernels, "face stage")
    }
    replaces = "exahype_tpu/models/aderdg_pallas.py:156"
    kernels = [
        kernel_line(name, replaces, launches[name], errs[name], *times[name], bounds[name])
        for name in cu.kernels
    ]
    kernels.append(kernel_line(
        "aderdg_face_flux + aderdg_surface_update (face stage, Euler)", replaces,
        launches["aderdg_surface_update"], errs["face stage"], *times["face stage"],
        bounds["face stage"]))
    del cu, sol, u0, u
    torch.cuda.empty_cache()
    return kernels


def z4_point_ops(torch, rhs_all) -> dict:
    """The arithmetic of K5's plain version at one point, by kind: the plain
    algebra run once on one-point float64 CPU tensors under a dispatch mode
    that tallies every elementwise arithmetic op (+, −, ×, ÷, negation,
    reciprocal, √).  The algebra has no branch, so the count holds for
    every point."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "sqrt"}
    counts = {}

    class Tally(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in arith:
                counts[name] = counts.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    q = torch.zeros(38, 1, dtype=torch.float64)
    q[[0, 1, 4, 6]] = 1.0  # flat space: α = 1, γ = identity
    grads = tuple(torch.zeros(38, 1, dtype=torch.float64) for _ in range(3))
    with Tally():
        rhs_all(q, grads, 0)
    return counts


def z4_slots_read(torch, rhs_all) -> tuple[int, int]:
    """``(state slots, gradient slots of the three directions together)``
    that K5's plain version reads: one evaluation of the plain algebra on
    float64 CPU points of flat space, point p holding NaN in one input slot
    (state slot p, then each direction's 38 gradient slots).  A slot is
    read when its NaN reaches the output: the algebra has no branch, and
    NaN·0 is NaN."""
    n = 38
    q = torch.zeros(n, 4 * n, dtype=torch.float64)
    q[[0, 1, 4, 6]] = 1.0  # α = 1, γ = identity
    grads = tuple(torch.zeros(n, 4 * n, dtype=torch.float64) for _ in range(3))
    for slot in range(n):
        q[slot, slot] = math.nan
        for k, gq in enumerate(grads):
            gq[slot, (k + 1) * n + slot] = math.nan
    reached = torch.isnan(rhs_all(q, grads, 0)).any(dim=0)
    return int(reached[:n].sum()), int(reached[n:].sum())


def z4_path(torch, dev, card) -> dict:
    """The dynamic-GR form of the main path; returns K5's line of the
    kernel JSON."""
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4 import (
        gauge_wave_state,
        make_z4_solver,
        solver_constraints,
    )

    def make(grid, dtype, **params):
        plain = make_z4_solver(3, Z4_ORDER, grid, dx=Z4_DX, impl="soa", fused_rhs="soa",
                               device=dev, dtype=dtype, **params)
        return plain, with_cuda_rhs(plain)

    def k5_inputs(sol, u):
        """The inputs of each ``rhs_all_fn`` call of one plain step from
        ``u``: the Picard iterations' and the corrector's two."""
        calls = []
        rec = copy.copy(sol)

        def record(Q, grads, va):
            calls.append((Q, tuple(grads), va))
            return sol.rhs_all_fn(Q, grads, va)

        rec.rhs_all_fn = record
        rec.step(u, Z4_DT)
        return calls

    def call_name(i, iters):
        return (f"Picard iteration {i + 1}" if i < iters
                else ("corrector rhs_all(q̄, ∇q̄)" if i == iters else "corrector rhs_all(q̄, 0)"))

    # ------------------------------------------- K5 vs plain, float64, cut grid
    for params in Z4_PARAMS:
        plain64, kern64 = make(Z4_CUT, torch.float64, **params)
        k5_64 = kern64.rhs_all_fn
        which = f"{k5_64.inner.physics.params}"
        u = gauge_wave_state(plain64, amplitude=Z4_AMPLITUDE)
        for i, (Q, grads, va) in enumerate(k5_inputs(plain64, u)):
            got, again = k5_64(Q, grads, va), k5_64(Q, grads, va)
            ref = plain64.rhs_all_fn(Q, grads, va)
            torch.cuda.synchronize()
            err = max_err(torch, got, ref)
            limit = Z4_F64_RTOL * max(1.0, ref.abs().max().item())
            ok = err <= limit and torch.equal(got, again)
            say(f"[z4 parity] rhs_all_z4 float64 {Z4_CUT} (slicing, f, m, κ₁, κ₂) = {which} "
                f"{call_name(i, plain64.picard_iters)} {tuple(Q.shape)}: max_abs_err "
                f"{err:.3e} limit {limit:.3e} ({Z4_F64_RTOL:.0e} x max(1, max|plain| = "
                f"{ref.abs().max().item():.4g})); repeat bitwise {torch.equal(got, again)} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"K5 (float64, {which}, {call_name(i, plain64.picard_iters)}) disagrees "
                     "with its plain version")
        if not params:  # the path's own parameters: a whole step too
            step_k, step_p = kern64.step(u, Z4_DT), plain64.step(u, Z4_DT)
            err = max_err(torch, step_k, step_p)
            limit = Z4_F64_RTOL * max(1.0, step_p.abs().max().item())
            say(f"[z4 parity] one float64 step {Z4_CUT}, kernel path vs plain path: "
                f"max_abs_err {err:.3e} limit {limit:.3e}; K5 launches {k5_64.launches}")
            if not err <= limit:
                fail("the float64 Z4 step through K5 disagrees with the plain step")
            del step_k, step_p
        del plain64, kern64, k5_64, u, got, again, ref

    # ------------------------------------------- K5 vs plain, float32, full width
    plain, kern = make(Z4_GRID, torch.float32)
    k5 = kern.rhs_all_fn
    iters = plain.picard_iters
    u0 = gauge_wave_state(plain, amplitude=Z4_AMPLITUDE)
    ncell = math.prod(Z4_GRID)
    dofs = plain.dofs()
    cfl = float(plain.cfl_dt(u0))
    say(f"[z4] {Z4_GRID} cells, order {Z4_ORDER}, 38 vars: {dofs} DOF, state {u0.nbytes} B "
        f"f32; dt = {Z4_DT!r} (scripts/z4_probe.py:57); cfl_dt(initial state) = {cfl!r} "
        f"(dt = {Z4_DT / cfl:.3f} x cfl_dt); picard_iters {iters}")
    calls = k5_inputs(plain, u0)
    k5_err = 0.0
    for i in (0, iters):  # the first Picard call, the corrector's ∇q̄ call
        Q, grads, va = calls[i]
        got = k5(Q, grads, va)
        ref = plain.rhs_all_fn(Q, grads, va)
        ref64 = plain.rhs_all_fn(Q.double(), tuple(g.double() for g in grads), va)
        torch.cuda.synchronize()
        err, limit = max_err(torch, got, ref), f32_bound(torch, ref)
        to64_k, to64_p = max_err(torch, got, ref64), max_err(torch, ref, ref64)
        ok = err <= limit
        say(f"[z4 parity] rhs_all_z4 float32 {Z4_GRID} {call_name(i, iters)} {tuple(Q.shape)}: "
            f"max_abs_err {err:.3e} limit {limit:.3e} ({F32_ULPS} f32 spacings of max|plain| = "
            f"{ref.abs().max().item():.4g}) {'ok' if ok else 'FAIL'}; against the float64 "
            f"plain result: kernel {to64_k:.3e}, plain float32 {to64_p:.3e}"
            f"{' (the kernel is farther)' if to64_k > to64_p else ''}")
        if not ok:
            fail(f"K5 (float32, {call_name(i, iters)}) disagrees with its plain version")
        k5_err = max(k5_err, err)
        del got, ref, ref64
    pic, cor = calls[0], calls[iters]
    del calls
    torch.cuda.empty_cache()

    # ------------------------------------------- the main path
    gib = 2.0**-30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    k5.reset_launches()
    u = kern.run(u0, STEPS, Z4_DT)
    torch.cuda.synchronize()
    launches = k5.launches
    peak = torch.cuda.max_memory_allocated()
    want = (iters + 2) * STEPS
    say(f"[z4 main] {STEPS} steps of {Z4_GRID} f32 through make_z4_solver + with_cuda_rhs: "
        f"K5 launches {launches} (expected (picard_iters + 2) x steps = {want}); peak "
        f"{peak * gib:.4f} GiB allocated ({held * gib:.4f} GiB held before: the first "
        f"Picard and corrector inputs, the initial state, operators) ({card})")
    if launches != want:
        fail(f"K5 launched {launches} times in {STEPS} Z4 main-path steps, expected {want}")
    if tuple(u.shape) != plain.state_shape or not torch.isfinite(u).all():
        fail("the Z4 main-path state is not finite or has the wrong shape")
    again = kern.run(u0, STEPS, Z4_DT)
    if not torch.equal(u, again):
        fail("two Z4 runs from the same state differ")
    say("[z4 main] two runs from the same state: bitwise equal")
    del again
    k1, p1 = kern.step(u0, Z4_DT), plain.step(u0, Z4_DT)
    torch.cuda.reset_peak_memory_stats()
    p10 = plain.run(u0, STEPS, Z4_DT)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    for n, a, b in ((1, k1, p1), (STEPS, u, p10)):
        err, limit = max_err(torch, a, b), n * f32_bound(torch, b)
        say(f"[z4 main] {n} step(s), kernel path vs plain path: max_abs_err {err:.3e} "
            f"limit {limit:.3e}")
        if not err <= limit:
            fail(f"the Z4 kernel path disagrees with the plain path after {n} step(s)")
    del k1, p1

    # Readings: the error against the exact gauge wave, the ADM constraints
    # (in float64, from a float64 solver's operators).
    sol64, _ = make(Z4_GRID, torch.float64)
    exact = gauge_wave_state(sol64, t=STEPS * Z4_DT, amplitude=Z4_AMPLITUDE)
    for label, x, ex in (("initial state", u0, gauge_wave_state(sol64, amplitude=Z4_AMPLITUDE)),
                         ("kernel path", u, exact), ("plain path", p10, exact)):
        diff = x.double() - ex
        H, M = solver_constraints(sol64, x.double())
        say(f"[z4 reading] {label} at t = {0 if x is u0 else STEPS * Z4_DT!r}: error against "
            f"the exact gauge wave: L2 (nodal RMS over all DOF) {diff.pow(2).mean().sqrt().item()!r}"
            f", max {diff.abs().max().item()!r}; ADM constraints max|H| "
            f"{H.abs().max().item()!r}, max|M| {M.abs().max().item()!r}")
        del diff, H, M
    del sol64, exact, p10, u

    # ------------------------------------------- times
    k_win = windows(torch, kern, u0, Z4_DT, steps=5)
    p_win = windows(torch, plain, u0, Z4_DT, steps=1, n_windows=1)
    for label, win in (("kernel path", k_win), ("plain path", p_win)):
        ms = [1e3 * w for w in win]
        say(f"[z4 time] {label}: step ms per window {ms!r}; median {statistics.median(ms)!r} "
            f"ms, {dofs / statistics.median(win)!r} DOF-updates/s ({dofs} DOF per step; {card})")
    new, faces = kern.predictor_volume(u0, Z4_DT)
    q_st = pic[0]
    k5_ms = {
        "Picard": event_ms(torch, lambda: k5(*pic), 20),
        "corrector": event_ms(torch, lambda: k5(*cor), 20),
    }
    k5_plain_ms = {
        "Picard": event_ms(torch, lambda: plain.rhs_all_fn(*pic), 2),
        "corrector": event_ms(torch, lambda: plain.rhs_all_fn(*cor), 2),
    }
    parts = {
        "step": event_ms(torch, lambda: kern.step(u0, Z4_DT), 2),
        "predictor_volume": event_ms(torch, lambda: kern.predictor_volume(u0, Z4_DT), 2),
        "face_surface (6 ncp_fn evaluations, 6 wave speeds)": event_ms(
            torch, lambda: kern.face_surface(new, faces, Z4_DT), 2),
        "source_fn on the space-time array (s̄)": event_ms(
            torch, lambda: kern.source_fn(q_st, pic[2]), 2),
        "one Picard gradient triple (tensordot, /dx, contiguous)": event_ms(
            torch, lambda: kern._grads(q_st, 1), 3),
    }
    k5_in_step = iters * k5_ms["Picard"] + 2 * k5_ms["corrector"]
    say(f"[z4 time] K5 per launch (CUDA events, 20 launches): Picard shape "
        f"{tuple(pic[0].shape)} {k5_ms['Picard']!r} ms, corrector shape {tuple(cor[0].shape)} "
        f"{k5_ms['corrector']!r} ms; plain rhs_all_fn {k5_plain_ms['Picard']!r} / "
        f"{k5_plain_ms['corrector']!r} ms ({card})")
    say(f"[z4 time] per call (CUDA events; the device timeline of eager work, gaps "
        f"included): " + ", ".join(f"{k} {v!r} ms" for k, v in parts.items())
        + f"; K5's {iters + 2} launches {k5_in_step!r} ms of the step, the rest "
        f"{parts['step'] - k5_in_step!r} ms ({card})")
    del new, faces
    idle, busy, wall = idle_share(torch, lambda: kern.step(u0, Z4_DT))
    say(f"[z4 idle] kernel path, 1 step under torch.profiler: device busy {busy!r} ms of "
        f"wall {wall!r} ms; idle share {idle!r} ({card})")
    say(f"[z4 mem] peak allocated over {STEPS} steps: kernel path {peak * gib:.4f} GiB, "
        f"plain path {plain_peak * gib:.4f} GiB ({card})")

    # ------------------------------------------- bound
    counts = z4_point_ops(torch, plain.rhs_all_fn)
    per_point = sum(counts.values())
    q_slots, grad_slots = z4_slots_read(torch, plain.rhs_all_fn)
    bounds = {}
    for name, (Q, _, va) in (("Picard", pic), ("corrector", cor)):
        points = Q.numel() // Q.shape[va]
        n_bytes = Q.element_size() * points * (q_slots + grad_slots + Q.shape[va])
        bounds[name] = bound(n_bytes, per_point * points)
        say(f"[bound] rhs_all_z4 {name} shape {tuple(Q.shape)} f32: {per_point} operations a "
            f"point ({counts}, counted on the plain algebra), {points} points, "
            f"{n_bytes} B ({q_slots} state slots and {grad_slots} gradient slots read, as "
            f"the plain algebra reads them, {Q.shape[va]} written): bound "
            f"{bounds[name]['bound_ms']!r} ms by {bounds[name]['bound_by']}; kernel "
            f"{k5_ms[name]!r} ms ({card})")
    del kern, plain, u0, pic, cor, q_st
    torch.cuda.empty_cache()
    return {
        "name": "rhs_all_z4",
        "route": "cuda",
        "source": "exahype_tpu_torch/csrc/rhs.cu",
        "replaces": "exahype_tpu/models/rhs_pallas.py:104",
        "launches": launches,
        "max_abs_err": k5_err,
        "ms": k5_ms["Picard"],
        "plain_ms": k5_plain_ms["Picard"],
        **bounds["Picard"],
        "library_ms": None,  # no single PyTorch call computes it
    }


def main():
    import torch

    # ---------------------------------------------------------- 1. card
    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is False (this script "
             "runs the port's kernels on one NVIDIA GPU)")
    if not (HERE / "exahype_tpu_torch" / "__init__.py").is_file():
        fail(f"exahype_tpu_torch/ not found beside {__file__}; run the script "
             "from a checkout of the repository")
    sys.path.insert(0, str(HERE))
    import exahype_tpu_torch

    if pathlib.Path(exahype_tpu_torch.__file__).resolve().parent.parent != HERE:
        fail(f"imported exahype_tpu_torch from {exahype_tpu_torch.__file__}, "
             f"not from {HERE}")
    from exahype_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain path: full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    import sympy

    say(f"[card] torch.cuda.get_device_name(0) = {kind}; "
        f"device_count = {torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, sympy {sympy.__version__}")
    say(f"[card] nvidia-smi name, power.limit: {card}")

    # --------------------------------------------------------- 2. build
    from exahype_tpu_torch.backends.cuda_backend import CudaPrinter
    from exahype_tpu_torch.models.fv import build_fv_rusanov_kernel
    from exahype_tpu_torch.models.rusanov import build_rusanov_kernel

    # The K4 source depends on the spec's widths, not on its patch count.
    spec_printers = {
        name: CudaPrinter(build(**FV_WIDTH, n_patches=1))
        for name, build in (("fv", build_fv_rusanov_kernel),
                            ("rusanov", build_rusanov_kernel))
    }
    jobs = {"csrc/*.cu (one library)": _build.compile_library}
    jobs.update({f"K4 {name} spec (generated)": pr.compile
                 for name, pr in spec_printers.items()})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {what: pool.submit(job) for what, job in jobs.items()}
        builds = {what: f.result() for what, f in futures.items()}
    say(f"[build] {len(jobs)} nvcc builds in parallel: {time.perf_counter() - t0:.2f} s "
        f"wall; flags {' '.join(_build.NVCC_FLAGS)}")
    for what, info in builds.items():
        say(f"[build] {what}: {info['seconds']:.2f} s -> "
            f"{pathlib.Path(info['path']).relative_to(HERE)} (name carries the "
            "source hash); nvcc seconds per source " + ", ".join(
                f"{name} {sec:.2f}" for name, sec in info["sources"].items()))
        for line in info["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                say(f"[build]   {line.strip()}")
    _build.library()
    for pr in spec_printers.values():
        pr.library()

    paths = {
        "ADER-DG": lambda: aderdg_path(torch, dev, card),
        "limited": lambda: limited_path(torch, dev, card),
        "CK": lambda: ck_path(torch, dev, card),
        "FV": lambda: [fv_path(torch, dev, card, spec_printers)],
        "Z4": lambda: [z4_path(torch, dev, card)],
    }
    kernels, seconds = [], {"build": time.perf_counter() - t0}
    for name, run in paths.items():
        t1 = time.perf_counter()
        kernels.extend(run())
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t1
    say("[paths] seconds per phase (host clock): " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": kind,
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
