#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the root of a checkout; one card, nvcc

The main path has two forms, each driven through ``exahype_tpu_torch``'s
entry points with its kernels' launch counters set to 0 just before and
read just after:

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
- **FV**: the spec-DSL Rusanov patch update of ``__graft_entry__.py`` —
  ``build_fv_rusanov_kernel`` (3-D Euler, patch 4, halo 1, 5 vars) →
  ``TpuPatchGrid`` → ``GridSolver(kernel_dt="lambda")`` with ``compute_dt``
  every step (cfl 0.45, dx = 1/(4·g0)), float32, at ``(8, 8, 128)`` (the
  JAX package's own FV measurement size) and ``(32, 16, 128)`` patches,
  from ``__graft_entry__._example_state``'s recipe.  Its kernel (K4) is
  generated from the spec's statement list (``backends/cuda_backend.py``).

Phases:

1. card: name, and ``nvidia-smi``'s name and power limit;
2. build: ``csrc/aderdg.cu`` and the K4 sources of the ``fv`` and the
   canonical ``rusanov`` spec, one ``nvcc`` each, all started together
   (time, source hash, and ptxas's registers/shared memory/spills);
3. each kernel against its plain PyTorch version on the card: float64 at
   atol=1e-12 (ADER-DG ``(8, 4, 32)``; K4 ``(2, 2, 2)``, both specs),
   float32 at each path's full shape at the bound stated in ``F32_ULPS``;
4. each main path: 10 steps, with the launch counters, finiteness, mass
   drift, bitwise repeatability and the plain path's 10 steps as checks;
5. times: step ms over 3 host-clock windows, DOF-updates/s, per-kernel (and
   for FV ``halo_fill`` / ``compute_dt``) times with CUDA events, device
   idle share, the plain path beside them;
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

#: The FV path (``__graft_entry__.py:16-36``): 3-D Euler, patch 4, halo 1.
FV_WIDTH = dict(dim=3, patch_size=4, halo_size=1, n_real=5, n_aux=0)
FV_GRIDS = ((8, 8, 128), (32, 16, 128))
FV_CFL = 0.45

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


def face_surface_ops(order: int, ncell: int, dim=3, nvar=5) -> float:
    """Flops of ``aderdg_face_surface``: two Rusanov fluxes (two wave
    speeds, 6 flops per variable) per face node and axis of each cell, and
    the surface update (5 flops per node, variable and axis)."""
    n = order + 1
    rusanov = 2 * EIG_OPS + 6 * nvar
    return ncell * (dim * n ** (dim - 1) * 2 * rusanov + n**dim * nvar * dim * 5)


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
    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

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
    jobs = {"csrc/aderdg.cu": _build.compile_library}
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
            "source hash)")
        for line in info["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                say(f"[build]   {line.strip()}")
    _build.library()
    for pr in spec_printers.values():
        pr.library()

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
            ("aderdg_face_surface", "new", surf_k, surf_p),
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
        del step_k, step_p, got, ref

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
    times = {
        "aderdg_predictor_volume": (
            event_ms(torch, lambda: cu.predictor_volume(u0, dt), 20),
            event_ms(torch, lambda: sol.predictor_volume(u0, dt), 3),
        ),
        "aderdg_face_surface": (
            event_ms(torch, lambda: cu.face_surface(new, faces, dt), 20),
            event_ms(torch, lambda: sol.face_surface(new, faces, dt), 3),
        ),
    }
    for name, (ms, plain_ms) in times.items():
        say(f"[time] {name}: kernel {ms!r} ms, plain {plain_ms!r} ms "
            f"(CUDA events; {card})")
    del new, faces
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
    # once) and the flops of its arithmetic (analytic count).
    ncell = sol.dofs() // (sol.n_nodes**3 * sol.n_vars)
    face_bytes = torch.empty(sol.face_shape, dtype=u0.dtype, device="meta").nbytes
    state_bytes = u0.nbytes
    bounds = {
        "aderdg_predictor_volume": bound(
            2 * state_bytes + face_bytes,
            predictor_ops(ORDER, sol.picard_iters, ncell),
        ),
        "aderdg_face_surface": bound(
            face_bytes + 2 * state_bytes, face_surface_ops(ORDER, ncell),
        ),
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": "exahype_tpu_torch/csrc/aderdg.cu",
            "replaces": "exahype_tpu/models/aderdg_pallas.py:156",
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            **bounds[name],
            "library_ms": None,  # no single PyTorch call computes it
        }
        for name in CudaADERDG.KERNELS
    ]
    for k in kernels:
        say(f"[bound] {k['name']} {GRID} f32: bound {k['bound_ms']!r} ms by "
            f"{k['bound_by']}; kernel {k['ms']!r} ms ({card})")
    del cu, sol, u0, u
    torch.cuda.empty_cache()

    kernels.append(fv_path(torch, dev, card, spec_printers))
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
