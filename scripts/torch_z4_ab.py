#!/usr/bin/env python3
"""Time versions of the Z4 step's kernels against each other in one process (GPU).

    python3 scripts/torch_z4_ab.py LABEL=SOURCE[:FLAG,FLAG...] ... [--grid G0,G1,G2]
                                   [--iters 0,1,2,3]

Each argument names a copy of ``exahype_tpu_torch/csrc/aderdg_z4.cu`` (the
float32 instances; its own directory first on the include path, so a copy
of ``aderdg_z4.cuh`` beside it is the one it includes; ``-D`` flags are
levers).  The script builds each into a library of its own with the port's
nvcc flags, prints ptxas's registers and spills of its kernels and their
SASS instruction counts (``cuobjdump -sass``: all, and the divisions'
reciprocals, shared loads and barriers), checks each
version's three kernels against their plain versions (the predictor's new
state and faces, the face flux's F̂ and the update within 64 float32
spacings of the largest plain value; the NCP halves against the plain
halves in float64 from the same faces, to 4 times the plain float32 halves'
own distance, as ``chip_smoke.py`` holds them), and times each kernel with
CUDA events on ``chip_smoke.py``'s Z4 problem (the gauge wave of amplitude
0.1, ``(16, 16, 128)`` p2, dx = 1/128, dt = 1e-4, float32), the versions in
turns (A B ... B A), so that every version sees the same card in the same
state.  The predictor is timed on the exact gauge wave, whose zero slots
(Θ, Z, most of D) make exact zeros in its arithmetic, and on the state
after one plain step, where no value is exactly zero.  ``--iters`` also
times each version's predictor, after one step, at those Picard iteration
counts (the same launch, its ``picard_iters`` argument): the slope is one
iteration's cost, the rest the epilogue and the loads.
Needs a CUDA card and nvcc; imports no JAX.

Example (the kernels of an earlier commit, their sources unpacked beside
each other, against the ones the port runs):

    mkdir -p build/old && git archive COMMIT exahype_tpu_torch/csrc \\
        | tar -x -C build/old --strip-components=2
    python3 scripts/torch_z4_ab.py old=build/old/aderdg_z4.cu \\
        new=exahype_tpu_torch/csrc/aderdg_z4.cu
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = pathlib.Path(__file__).resolve().parent.parent
KERNELS = ("aderdg_predictor_volume_z4", "aderdg_face_flux_z4", "aderdg_surface_update_z4")


def _build_one(build, out_dir, item):
    label, src, flags = item
    out = out_dir / f"lib_{label}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-I", str(src.parent), "-I",
           str(build.CSRC), "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"torch_z4_ab: nvcc failed for {label}:\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    ptxas = [f"{log[i].split('entry function')[1].strip()[:90]}: " + "; ".join(
        x.strip() for x in log[i + 1:i + 4] if "spill" in x or "Used" in x)
        for i, line in enumerate(log) if "Compiling entry" in line]
    return label, out, ptxas


def sass_counts(build, path: pathlib.Path) -> dict:
    """``{kernel: {kind: count}}`` of a library's float32 Z4 kernels."""
    cuobjdump = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    kinds = {"MUFU.RCP": ("MUFU.RCP",), "LDS": ("LDS",), "BAR": ("BAR",),
             "LDL/STL": ("LDL", "STL")}
    counts, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = next((k for k in KERNELS if f"{k}If" in fn), None)
            if name:
                counts[name] = {k: 0 for k in (*kinds, "all")}
            continue
        if name is None or "/*" not in line or ";" not in line:
            continue
        op = line.split("*/", 1)[1].strip().lstrip("@!P0123456789T ").split(" ")[0]
        if not op or op.startswith("."):
            continue
        counts[name]["all"] += 1
        for kind, prefixes in kinds.items():
            if op.startswith(prefixes):
                counts[name][kind] += 1
    return counts


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("versions", nargs="+", help="LABEL=SOURCE[:FLAG,FLAG...]")
    parser.add_argument("--grid", default="16,16,128", help="the cell grid")
    parser.add_argument("--iters", default="", help="Picard iteration counts to time")
    args = parser.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs
    from exahype_tpu_torch import _build
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.z4 import gauge_wave_state, make_z4_solver

    if not torch.cuda.is_available():
        sys.exit("torch_z4_ab: no CUDA card")
    items = []
    for arg in args.versions:
        label, _, rest = arg.partition("=")
        src, _, flags = rest.partition(":")
        items.append((label, pathlib.Path(src).resolve(), [f for f in flags.split(",") if f]))
    grid = tuple(int(g) for g in args.grid.split(","))
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(items)) as pool:
            built = list(pool.map(lambda it: _build_one(_build, pathlib.Path(tmp), it), items))
        for label, path, _ in built:
            lib = ctypes.CDLL(str(path))
            fns = {}
            for kernel in KERNELS:
                fn = getattr(lib, f"exahype_{kernel}_f32")
                fn.argtypes = list(_build._SIGNATURES[f"exahype_{kernel}_f32"])
                fns[kernel] = fn
            libs[label] = fns
            for kernel, kinds in sass_counts(_build, path).items():
                print(f"[sass] {label} {kernel} f32: " + ", ".join(
                    f"{k} {n}" for k, n in kinds.items()))
    for label, _, ptxas in built:
        for line in ptxas:
            print(f"[ptxas] {label} {line}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[ab] card: {card}")
    dev = torch.device("cuda")
    dt = cs.Z4_DT
    sol = make_z4_solver(3, cs.Z4_ORDER, grid, dx=cs.Z4_DX, impl="soa", fused_rhs="soa",
                         device=dev, dtype=torch.float32)
    sol64 = make_z4_solver(3, cs.Z4_ORDER, grid, dx=cs.Z4_DX, impl="soa", fused_rhs="soa",
                           device=dev, dtype=torch.float64)
    cu = CudaADERDG(sol)
    u = gauge_wave_state(sol, amplitude=cs.Z4_AMPLITUDE)
    stream = torch.cuda.current_stream().cuda_stream
    common = (cu._ops.ctypes.data, cu._dx.ctypes.data, sol.order)

    def predictor(fns, iters=sol.picard_iters):
        new = torch.empty_like(u)
        faces = torch.empty(sol.face_shape, dtype=u.dtype, device=dev)
        err = fns[KERNELS[0]](u.data_ptr(), new.data_ptr(), faces.data_ptr(), None, dt, *common,
                              iters, cu._physics_id, cu._params.ctypes.data, *grid, stream)
        if err != 0:
            raise RuntimeError(f"{KERNELS[0]}: CUDA error {err}")
        return new, faces

    def face_flux(fns, faces):
        fhat = torch.empty((3, 9, 38) + grid, dtype=u.dtype, device=dev)
        fhalf = torch.empty_like(fhat)
        err = fns[KERNELS[1]](faces.data_ptr(), fhat.data_ptr(), fhalf.data_ptr(), *common,
                              cu._physics_id, cu._params.ctypes.data, *grid, stream)
        if err != 0:
            raise RuntimeError(f"{KERNELS[1]}: CUDA error {err}")
        return fhat, fhalf

    def update(fns, new, fhat, fhalf):
        err = fns[KERNELS[2]](new.data_ptr(), fhat.data_ptr(), fhalf.data_ptr(), None, dt,
                              *common, cu._physics_id, cu._params.ctypes.data, *grid, stream)
        if err != 0:
            raise RuntimeError(f"{KERNELS[2]}: CUDA error {err}")
        return new

    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    fhat_p, fhalf_p = cs.z4_plain_face_flux(torch, sol, faces_p)
    upd_p = cs.z4_plain_update(sol, new_p, fhat_p, fhalf_p, dt)
    half64 = cs.z4_plain_face_flux(torch, sol64, faces_p.double())[1]
    half_limit = max(cs.FVWALL_F32_FACTOR * cs.max_err(torch, fhalf_p, half64),
                     cs.f32_bound(torch, half64))
    for label, fns in libs.items():
        new, faces = predictor(fns)
        fhat, fhalf = face_flux(fns, faces_p)
        upd = update(fns, new_p.clone(), fhat_p, fhalf_p)
        torch.cuda.synchronize()
        checks = [("new", new, new_p, cs.f32_bound(torch, new_p)),
                  ("faces", faces, faces_p, cs.f32_bound(torch, faces_p)),
                  ("fhat", fhat, fhat_p, cs.f32_bound(torch, fhat_p)),
                  ("fhalf (against plain f64)", fhalf, half64, half_limit),
                  ("update", upd, upd_p, cs.f32_bound(torch, upd_p))]
        for what, a, b, limit in checks:
            err = cs.max_err(torch, a, b)
            print(f"[check] {label} {what}: max_abs_err {err:.3e} limit {limit:.3e}")
            if not err <= limit:
                sys.exit(f"torch_z4_ab: {label} disagrees with the plain version ({what})")
    new, faces = predictor(next(iter(libs.values())))
    fhat, fhalf = face_flux(next(iter(libs.values())), faces)
    u0, u1 = u, sol.step(u, dt)

    def on(state):
        def run(fns):
            nonlocal u
            u = state
            return predictor(fns)
        return run

    runs = {
        f"{KERNELS[0]} on the exact gauge wave": on(u0),
        f"{KERNELS[0]} after one step": on(u1),
        KERNELS[1]: lambda fns: face_flux(fns, faces),
        KERNELS[2]: lambda fns: update(fns, new, fhat, fhalf),
    }
    order = list(libs) + list(reversed(libs))
    for kernel, run in runs.items():
        times = {label: [] for label in libs}
        for label in order:
            times[label].append(cs.event_ms(torch, lambda: run(libs[label]), 20))
        for label, ms in times.items():
            print(f"[ab] {label} {grid} f32: {kernel} {statistics.mean(ms)!r} ms (turns {ms!r}) "
                  f"({card})")
    u = u1
    for iters in (int(i) for i in args.iters.split(",") if i):
        for label, fns in libs.items():
            ms = cs.event_ms(torch, lambda: predictor(fns, iters), 20)
            print(f"[ab] {label} {grid} f32: {KERNELS[0]} after one step at picard_iters "
                  f"{iters}: {ms!r} ms ({card})")


if __name__ == "__main__":
    main()
