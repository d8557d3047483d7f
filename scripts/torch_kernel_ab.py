#!/usr/bin/env python3
"""Time versions of ``csrc/aderdg.cu`` against each other in one process (GPU).

    python3 scripts/torch_kernel_ab.py LABEL=SOURCE[:FLAG,FLAG...] ... [--out DIR] [--sass]

Each argument names a copy of ``exahype_tpu_torch/csrc/aderdg.cu`` (an
older version, or a file built with other ``-D`` flags).  The script
builds each into a library of its own with the port's nvcc flags (``csrc/``
on the include path), prints
ptxas's registers and spills of the two predictors, checks each library's
``aderdg_predictor_volume``, Euler face stage and CK predictor
(``aderdg_ck_predictor_volume``, K2, on ``bench.py::bench_ck``'s problem)
against the plain PyTorch versions (f32 at ``(256, 8, 128)``, f64 at
``(3, 5, 7)``), and times the three with CUDA events, the versions in turns
(A B ... B A) at ``(256, 8, 128)``, so that every version sees the same card
in the same state.  Needs a CUDA card and nvcc; imports no JAX.
With ``--sass`` it instead counts, in ``cuobjdump -sass`` of each version,
the instructions of each f32 kernel of the file by kind (reciprocals,
square roots, FP32 adds/multiplies/FMAs, shuffles, shared loads and stores,
barriers, local spills, all) and exits: that needs nvcc and cuobjdump, no
card, and takes any version of the file (an include of the version's own
directory comes first), and also ``csrc/aderdg_visc.cu`` (the viscous
predictor, with and without its wall planes).

Example (the current kernels against a file kept from an earlier commit):

    git show HEAD~1:exahype_tpu_torch/csrc/aderdg.cu > build/old_aderdg.cu
    python3 scripts/torch_kernel_ab.py old=build/old_aderdg.cu \\
        new=exahype_tpu_torch/csrc/aderdg.cu

A version must export the current C interface of the face stage and the
two predictors (``_build._SIGNATURES``' ``aderdg`` entries).

With ``--k3`` the versions are copies of ``csrc/subcell.cu`` (the
limiter's subcell sweep, K3) instead.  The script runs the limited path's
plain step (``chip_smoke.py``'s: ``(256, 8, 128)`` f32, the Sod shock,
capacity 128 rows, 5 warm-up steps) and records one step's three sweep
inputs, then checks each version against the plain sweep (the active slots
within 64 f32 spacings, the inactive slots untouched and their edge fluxes
zero) and times it at the batch's ``n_active`` and with every slot active
(the kernel's device spans from ``torch.profiler``, 30 launches, the
versions in turns A B ... B A; at ``n_active`` also CUDA events around
the back-to-back calls, which time the host when the kernel is shorter).  Two
pseudo-flags say how a version is called: ``first`` for the first kernel's interface
(``s`` to a new ``s_new``, every slot), ``out`` for a fresh ``s_out`` each
launch (out of place); without either the sweep runs in place.  The
levers of the K3 redesign (``scripts/k3_levers/`` holds the versions
between the first kernel and the current one):

    git show 50bcef4:exahype_tpu_torch/csrc/subcell.cu > build/k3_first.cu
    L=scripts/k3_levers
    python3 scripts/torch_kernel_ab.py --k3 a=build/k3_first.cu:first \\
        b=$L/subcell_first_prefix.cu:out,-DK3_RESTRICT c=$L/subcell_first_prefix.cu \\
        d=$L/subcell_warp_per_a.cu e=exahype_tpu_torch/csrc/subcell.cu

(the cluster kernel at other resident-block counts: a copy of
``csrc/subcell.cu`` with another ``min_blocks``).
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = pathlib.Path(__file__).resolve().parent.parent
GRID = (256, 8, 128)
SMALL = (3, 5, 7)


#: ``--k3`` pseudo-flags: how a version is called, not nvcc flags.
K3_MODES = ("first", "out")


def _parse(arg: str):
    label, _, rest = arg.partition("=")
    src, _, flags = rest.partition(":")
    if not label or not src:
        raise SystemExit(f"torch_kernel_ab: expected LABEL=SOURCE[:FLAGS], got {arg!r}")
    return label, pathlib.Path(src).resolve(), [f for f in flags.split(",") if f]


def _build_one(build, out_dir, item):
    label, src, flags = item
    flags = [f for f in flags if f not in K3_MODES]
    out = out_dir / f"lib_{label}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-I", str(src.parent), "-I",
           str(build.CSRC), "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"torch_kernel_ab: nvcc failed for {label}:\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    ptxas = []
    for i, line in enumerate(log):
        for kernel in ("23aderdg_predictor_volume", "26aderdg_ck_predictor_volume",
                       "17subcell_row_sweep"):
            if "Compiling entry" in line and kernel in line:
                # The entry's spill line and its "Used N registers" line.
                info = [x.strip() for x in log[i + 1:i + 5] if "spill" in x or "Used" in x]
                dtype = "f64" if "IdLi" in line else "f32"
                ptxas.append((kernel[2:], dtype, "; ".join(info)))
    return label, out, ptxas


#: SASS opcodes counted by ``--sass`` (a prefix match on the opcode).
SASS_KINDS = {
    "MUFU.RCP": ("MUFU.RCP",), "MUFU.RSQ/SQRT": ("MUFU.RSQ", "MUFU.SQRT"),
    "FFMA": ("FFMA",), "FMUL": ("FMUL",), "FADD": ("FADD",), "SHFL": ("SHFL",),
    "LDS": ("LDS",), "STS": ("STS",), "BAR": ("BAR",), "LDL/STL": ("LDL", "STL"),
}


def sass_counts(build, path: pathlib.Path) -> dict:
    """``{kernel: {kind: count}}`` of the f32 kernels in a library."""
    cuobjdump = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = None
            for kernel in ("ck_predictor_volume", "predictor_volume_visc", "predictor_volume",
                           "face_flux", "surface_update", "face_surface"):
                if f"aderdg_{kernel}If" in fn:
                    name = "aderdg_" + kernel + (" (elastic)" if "Elastic" in fn else "")
                    name += " (Navier–Stokes)" if "NavierStokes" in fn else ""
                    name += " (wall planes)" if kernel.endswith("visc") and "Lb1E" in fn else ""
                    break
            if name:
                counts[name] = {k: 0 for k in (*SASS_KINDS, "all")}
            continue
        if name is None or "/*" not in line or ";" not in line:
            continue
        op = line.split("*/", 1)[1].strip().lstrip("@!P0123456789T ").split(" ")[0]
        if not op or op.startswith("."):
            continue
        counts[name]["all"] += 1
        for kind, prefixes in SASS_KINDS.items():
            if op.startswith(prefixes):
                counts[name][kind] += 1
    return counts


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("versions", nargs="+", help="LABEL=SOURCE[:FLAG,FLAG...]")
    parser.add_argument("--out", type=pathlib.Path, help="where to keep the libraries")
    parser.add_argument("--sass", action="store_true", help="count SASS instructions only")
    parser.add_argument("--k3", action="store_true", help="versions of csrc/subcell.cu")
    args = parser.parse_args()
    if args.k3:
        return k3_main(args)
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    from exahype_tpu_torch import _build
    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.elastic import (
        DISSIPATION_MASK,
        MATERIAL_SLOTS,
        elastic3d_heterogeneous,
        two_layer_state,
    )

    if not (args.sass or torch.cuda.is_available()):
        sys.exit("torch_kernel_ab: no CUDA card")
    items = [_parse(a) for a in args.versions]
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out or pathlib.Path(tmp)
        out_dir.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(len(items)) as pool:
            built = list(pool.map(lambda it: _build_one(_build, out_dir, it), items))
        if args.sass:
            for label, path, _ in built:
                for kernel, kinds in sass_counts(_build, path).items():
                    print(f"[sass] {label} {kernel} f32: " + ", ".join(
                        f"{k} {n}" for k, n in kinds.items()))
            return
        signatures = [(k, v) for k, v in _build._SIGNATURES.items()
                      if "aderdg" in k and "visc" not in k]
        libs = {label: _build._load(path, signatures) for label, path, _ in built}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[ab] card: {card}")

    dev = torch.device("cuda")
    flux, eig = euler_physics(3)

    def setup(grid, dtype):
        sol = ADERDGSolver(3, 3, 5, grid, flux, eig, dx=1 / 256, device=dev, dtype=dtype)
        rng = np.random.default_rng(0)
        rho = 1.0 + 0.2 * rng.random((4, 4, 4) + grid)
        q = np.stack([rho, rho, 0.5 * rho, 0.25 * rho, 5.0 + 0.5 * rho * 1.3125], axis=3)
        return sol, torch.from_numpy(q).to(dev, dtype).contiguous()

    def event_ms(fn, n=30):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    def ck_setup(grid, dtype):
        ck_flux, ck_eig = elastic3d_heterogeneous()
        sol = ADERDGSolver(3, 3, 12, grid, ck_flux, ck_eig, dx=1.0 / grid[0], device=dev,
                           dtype=dtype, predictor_mode="ck", ck_material_slots=MATERIAL_SLOTS,
                           dissipation_mask=DISSIPATION_MASK)
        q, _ = two_layer_state(sol)
        return sol, torch.from_numpy(q).to(dev, dtype).contiguous()

    big, u = setup(GRID, torch.float32)
    dt = float(big.cfl_dt(u))
    small, us = setup(SMALL, torch.float64)
    ref = big.predictor_volume(u, dt)
    ref_surf = big.face_surface(ref[0], ref[1], dt)
    ref64 = small.predictor_volume(us, 5e-5)
    bound32 = 64 * 2.0**-23 * ref[1].abs().max().item()
    ck_big, ck_u = ck_setup(GRID, torch.float32)
    ck_dt = float(ck_big.cfl_dt(ck_u))
    ck_small, ck_us = ck_setup(SMALL, torch.float64)
    ck_ref = ck_big.predictor_volume(ck_u, ck_dt)
    ck_ref64 = ck_small.predictor_volume(ck_us, 2e-4)

    def ck_ok(got, want, f64):
        """The evolved and the material rows (var axis 3) each within the
        bound of their own largest value (f32), or 1e-12 (f64)."""
        worst = 0.0
        for lo, n in ((0, 9), (9, 3)):
            g, r = got.narrow(3, lo, n), want.narrow(3, lo, n)
            err = (g.double() - r.double()).abs().max().item()
            limit = 1e-12 if f64 else 64 * 2.0**-23 * r.abs().max().item()
            if err > limit:
                return False, err
            worst = max(worst, err)
        return True, worst

    def use(label):
        _build.library = lambda lib=libs[label]: lib

    for label, _, ptxas in built:
        use(label)
        cu, cs = CudaADERDG(big), CudaADERDG(small)
        new, faces, _ = cu.predictor_volume(u, dt)
        surf = cu.face_surface(ref[0].clone(), ref[1], dt)
        new64, faces64, _ = cs.predictor_volume(us, 5e-5)
        ck_got = CudaADERDG(ck_big).predictor_volume(ck_u, ck_dt)
        ck_got64 = CudaADERDG(ck_small).predictor_volume(ck_us, 2e-4)
        torch.cuda.synchronize()
        errs = [
            (new - ref[0]).abs().max().item(), (faces - ref[1]).abs().max().item(),
            (surf - ref_surf).abs().max().item(),
            (new64 - ref64[0]).abs().max().item(), (faces64 - ref64[1]).abs().max().item(),
        ]
        ck = [ck_ok(g, r, f64) for g, r, f64 in zip((*ck_got[:2], *ck_got64[:2]),
                                                     (*ck_ref[:2], *ck_ref64[:2]), (0, 0, 1, 1))]
        ok = (max(errs[:3]) <= bound32 and max(errs[3:]) <= 1e-12
              and all(good for good, _ in ck))
        print(f"[ab] {label}: ptxas {ptxas}")
        print(f"[ab] {label}: max_abs_err f32 {GRID} new {errs[0]:.3e} faces {errs[1]:.3e} "
              f"face stage {errs[2]:.3e} (bound {bound32:.3e}); f64 {SMALL} new {errs[3]:.3e} "
              f"faces {errs[4]:.3e} (bound 1e-12); K2 f32 new, faces, f64 new, faces "
              f"{[f'{e:.3e}' for _, e in ck]}: {'ok' if ok else 'FAIL'}")
        if not ok:
            sys.exit(f"torch_kernel_ab: {label} disagrees with the plain version")

    order = [label for label, _, _ in built]
    kinds = ("predictor", "face stage", "K2")
    times = {label: {k: [] for k in kinds} for label in order}
    for label in order + order[::-1]:
        use(label)
        cu, ck = CudaADERDG(big), CudaADERDG(ck_big)
        new, faces, _ = cu.predictor_volume(u, dt)
        times[label]["predictor"].append(event_ms(lambda: cu.predictor_volume(u, dt)))
        times[label]["face stage"].append(event_ms(lambda: cu.face_surface(new, faces, dt)))
        times[label]["K2"].append(event_ms(lambda: ck.predictor_volume(ck_u, ck_dt)))
    for label in order:
        print(f"[ab] {label}: aderdg_predictor_volume ms {times[label]['predictor']!r}, "
              f"face stage ms {times[label]['face stage']!r}, aderdg_ck_predictor_volume ms "
              f"{times[label]['K2']!r} (CUDA events, 30 launches each, {GRID} f32; {card})")


def k3_main(args):
    """The ``--k3`` mode (see the module's docstring)."""
    import ctypes
    import statistics

    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    from exahype_tpu_torch import _build
    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible

    if not torch.cuda.is_available():
        sys.exit("torch_kernel_ab: no CUDA card")
    items = [_parse(a) for a in args.versions]
    mode = {label: next((f for f in flags if f in K3_MODES), "in place")
            for label, _, flags in items}
    P, D, INT, LL = ctypes.c_void_p, ctypes.c_double, ctypes.c_int, ctypes.c_longlong
    argtypes = {
        # s, ghost_lo, ghost_hi, s_new, g_lo, g_hi, dt_ptr, dt_val, h, gamma, dim,
        # n_sub, n_vars, d, n_kl, stream
        "first": [P] * 7 + [D, D, D, INT, INT, INT, INT, LL, P],
        # s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr, dt_val, h, gamma, dim,
        # n_sub, n_vars, d, n_active, n_slots, L, stream
        "new": [P] * 7 + [D, D, D, INT, INT, INT, INT, P, LL, LL, P],
    }
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out or pathlib.Path(tmp)
        out_dir.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(len(items)) as pool:
            built = list(pool.map(lambda it: _build_one(_build, out_dir, it), items))
        fns = {}
        for label, path, _ in built:
            fn = ctypes.CDLL(str(path)).exahype_subcell_row_sweep_f32
            fn.argtypes = argtypes["first" if mode[label] == "first" else "new"]
            fn.restype = ctypes.c_int
            fns[label] = fn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[ab] card: {card}")

    # The limited path's plain step on the Sod shock (chip_smoke.py's).
    dev, grid, capacity, dt = torch.device("cuda"), (256, 8, 128), 128, 1.5e-4
    flux, eig = euler_physics(3)
    sol = ADERDGSolver(3, 3, 5, grid, flux, eig, dx=1 / 256, device=dev, dtype=torch.float32)
    lim = LimitedADERDG(sol, euler_admissible(3), troubled_capacity=capacity,
                        troubled_granularity="row", dmp_delta0=5e-4, device=dev)
    x = np.arange(grid[0]).reshape(-1, 1, 1) / grid[0]
    left = np.broadcast_to(x < 0.5, grid)
    shape = (4, 4, 4) + grid
    rho = np.broadcast_to(np.where(left, 1.0, 0.125), shape)
    p = np.broadcast_to(np.where(left, 1.0, 0.1), shape)
    q = np.stack([rho, 0 * rho, 0 * rho, 0 * rho, p / 0.4], axis=3)
    u = lim.run(torch.from_numpy(q).to(dev, torch.float32).contiguous(), 5, dt)
    tables = lim._gather_tables_row(lim.troubled_mask(u, sol.step(u, dt)))
    recorded = []

    def record(s_, lo_, hi_, d_, dt_):
        recorded.append((d_, s_, lo_, hi_))
        return LimitedADERDG._row_sweep_math(lim, s_, lo_, hi_, d_, dt_)

    lim._row_sweep_math = record
    lim._gathered_subcell_step_row(u, dt, tables)
    del lim._row_sweep_math
    n_active = int(tables["n_active"])
    counts = {"active": tables["n_active"], "all": torch.tensor(capacity, device=dev)}
    K, L = recorded[0][1].shape[-2:]

    def sweep(label, d, s, lo, hi, n_dev):
        """One launch of ``label``'s kernel; its ``(s_out, g_lo, g_hi)``."""
        g_lo = torch.empty((5, K, L), device=dev)
        g_hi = torch.empty_like(g_lo)
        h = 1 / 256 / 7
        stream = torch.cuda.current_stream().cuda_stream
        if mode[label] == "first":
            s_out = torch.empty_like(s)
            err = fns[label](s.data_ptr(), lo.data_ptr(), hi.data_ptr(), s_out.data_ptr(),
                             g_lo.data_ptr(), g_hi.data_ptr(), None, dt, h, 1.4, 3, 7, 5, d,
                             K * L, stream)
        else:
            s_out = torch.empty_like(s) if mode[label] == "out" else s
            err = fns[label](s.data_ptr(), s_out.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                             g_lo.data_ptr(), g_hi.data_ptr(), None, dt, h, 1.4, 3, 7, 5, d,
                             n_dev.data_ptr(), K, L, stream)
        if err:
            sys.exit(f"torch_kernel_ab: {label} launch failed with CUDA error {err}")
        return s_out, g_lo, g_hi

    def event_ms(fn, n=30):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    refs = {d: lim._row_sweep_math(s, lo, hi, d, dt) for d, s, lo, hi in recorded}
    for label, _, ptxas in built:
        worst, ok = 0.0, True
        for d, s, lo, hi in recorded:
            for which, n in (("active", n_active), ("all", K)):
                if mode[label] == "first":
                    n = K  # it sweeps every slot
                got = sweep(label, d, s.clone(), lo, hi, counts[which])
                torch.cuda.synchronize()
                for a, c in zip(got, refs[d]):
                    err = (a[..., :n, :].double() - c[..., :n, :].double()).abs().max().item()
                    worst = max(worst, err)
                    ok &= err <= 64 * 2.0**-23 * c[..., :n, :].abs().max().item()
                rest = got[0][..., n:, :]
                ok &= mode[label] == "out" or torch.equal(rest, s[..., n:, :])
                ok &= not got[1][:, n:].any() and not got[2][:, n:].any()
        print(f"[ab] {label} ({mode[label]}): ptxas {ptxas}")
        print(f"[ab] {label}: max_abs_err of the active slots {worst:.3e} (f32 bound 64 "
              f"spacings), inactive slots untouched and zero edge fluxes: "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            sys.exit(f"torch_kernel_ab: {label} breaks the sweep's contract")

    def device_ms(fn, n=30):
        """Mean span of the kernel over ``n`` launches (torch.profiler), so
        host time between launches is not counted; the profiler may drop a
        span."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):  # a process's first window
            fn()                                            # may record nothing
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "subcell_row_sweep" in e.name]
        if not n / 2 <= len(spans) <= n:
            sys.exit(f"torch_kernel_ab: the profiler saw {len(spans)} sweeps, not {n}")
        return sum(spans) / len(spans) / 1e3

    order = [label for label, _, _ in built]
    times = {label: {w: [] for w in (*counts, "events")} for label in order}
    for label in order + order[::-1]:
        for which, n_dev in counts.items():
            per_dir, per_call = [], []
            for d, s, lo, hi in recorded:
                work = s.clone()
                per_dir.append(device_ms(lambda: sweep(label, d, work, lo, hi, n_dev)))
                if which == "active":
                    per_call.append(event_ms(lambda: sweep(label, d, work, lo, hi, n_dev)))
                del work
            times[label][which].append(statistics.mean(per_dir))
            if per_call:
                times[label]["events"].append(statistics.mean(per_call))
    for label in order:
        print(f"[ab] {label} ({mode[label]}): subcell_row_sweep device ms (torch.profiler), "
              f"mean of 3 directions, per turn: {n_active} active slots "
              f"{times[label]['active']!r}, all {K} slots {times[label]['all']!r}; per call "
              f"at {n_active} active slots (CUDA events, back to back, host time included) "
              f"{times[label]['events']!r} (30 launches each, {tuple(recorded[0][1].shape)} "
              f"f32; {card})")


if __name__ == "__main__":
    main()
