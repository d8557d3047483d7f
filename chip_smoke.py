#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; one card, nvcc

The main path is ``bench.py::main``'s step — ADER-DG order 3, 3-D
compressible Euler, a ``(256, 8, 128)`` periodic cell grid in float32,
``bench.py``'s initial state — driven through ``exahype_tpu_torch``'s
``CudaADERDG``.  The time step is the solver's own ``cfl_dt`` of the
initial state (6.26e-5), not ``bench.py``'s fixed 1e-4: that is 1.6x over
the CFL limit at dx = 1/256, and on this rough state the step then
amplifies until the state overflows.  The JAX solver does the same on cut
grids (``tests/test_torch_slice.py::test_bench_dt_blows_up_in_both_packages``);
the script records the step at which the port overflows at the bench
grid.  Phases:

1. card: name, and ``nvidia-smi``'s name and power limit;
2. build: the kernels from ``exahype_tpu_torch/csrc/`` with ``nvcc``
   (time, and ptxas's registers/spills per kernel);
3. each kernel against its plain PyTorch version on the card: float64 on
   ``(8, 4, 32)`` at atol=1e-12, float32 at the bench shape at the bound
   stated in ``F32_ULPS`` below;
4. the main path: 10 steps from ``bench.py``'s initial state, with the
   launch counters, finiteness, mass drift, bitwise repeatability and the
   plain path's 10 steps as checks, and each path's peak device memory;
5. times: kernel path and plain path over 3 windows each, per-kernel times
   with CUDA events, and each path's device idle share;
6. a reading, not a check: the step at which ``bench.py``'s dt = 1e-4
   makes the state non-finite, on both paths.

It prints a JSON line of the kernels, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before those lines; so does a machine without a CUDA card, and a
directory that holds this script without the package.  Imports no JAX.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

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
    say(f"[card] torch.cuda.get_device_name(0) = {kind}; "
        f"device_count = {torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(f"[card] nvidia-smi name, power.limit: {card}")

    # --------------------------------------------------------- 2. build
    info = _build.compile_library()
    say(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {info['seconds']:.2f} s "
        f"-> {pathlib.Path(info['path']).relative_to(HERE)}")
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            say(f"[build] {line.strip()}")
    _build.library()

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
        }
        for name in CudaADERDG.KERNELS
    ]
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
