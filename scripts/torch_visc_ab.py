#!/usr/bin/env python3
"""Time versions of the viscous predictor against each other in one process (GPU).

    python3 scripts/torch_visc_ab.py LABEL=SOURCE[:FLAG,FLAG...] ... [--grid G0,G1,G2]

Each argument names a copy of ``exahype_tpu_torch/csrc/aderdg_visc.cu`` (its
own directory first on the include path, so a copy of ``aderdg_visc.cuh``
beside it is the one it includes; ``-D`` flags are levers).  The script
builds each into a library of its own with the port's nvcc flags, prints
ptxas's registers and spills of its kernels, checks each version's
``aderdg_predictor_volume_visc`` against the plain
``ADERDGSolver.predictor_volume`` (the new state and the faces within 64
float32 spacings of the largest value; with walls the viscous-only wall
planes against the plain predictor in float64, as ``chip_smoke.py`` holds
them), and times it with CUDA
events on ``chip_smoke.py``'s Taylor–Green vortex (``(64, 64, 64)`` p3,
float32, periodic and with no-slip walls on axis 0), the versions in turns
(A B ... B A), so that every version sees the same card in the same state.
Needs a CUDA card and nvcc; imports no JAX.

Example (the viscous predictor of an earlier commit, its sources unpacked
beside each other, against the kernel the port runs):

    mkdir -p build/old && git archive COMMIT exahype_tpu_torch/csrc \\
        | tar -x -C build/old --strip-components=2
    python3 scripts/torch_visc_ab.py old=build/old/aderdg_visc.cu \\
        new=exahype_tpu_torch/csrc/aderdg_visc.cu
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


def _build_one(build, out_dir, item):
    label, src, flags = item
    out = out_dir / f"lib_{label}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-I", str(src.parent), "-I",
           str(build.CSRC), "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"torch_visc_ab: nvcc failed for {label}:\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    ptxas = [f"{log[i].split('entry function')[1].strip()[:90]}: " + "; ".join(
        x.strip() for x in log[i + 1:i + 4] if "spill" in x or "Used" in x)
        for i, line in enumerate(log) if "Compiling entry" in line]
    return label, out, ptxas


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("versions", nargs="+", help="LABEL=SOURCE[:FLAG,FLAG...]")
    parser.add_argument("--grid", default="64,64,64", help="the vortex's cell grid")
    args = parser.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs
    from exahype_tpu_torch import _build

    if not torch.cuda.is_available():
        sys.exit("torch_visc_ab: no CUDA card")
    items = []
    for arg in args.versions:
        label, _, rest = arg.partition("=")
        src, _, flags = rest.partition(":")
        items.append((label, pathlib.Path(src).resolve(), [f for f in flags.split(",") if f]))
    grid = tuple(int(g) for g in args.grid.split(","))
    name = "exahype_aderdg_predictor_volume_visc_f32"
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(items)) as pool:
            built = list(pool.map(lambda it: _build_one(_build, pathlib.Path(tmp), it), items))
        for label, path, _ in built:
            lib = ctypes.CDLL(str(path))
            getattr(lib, name).argtypes = list(_build._SIGNATURES[name])
            libs[label] = getattr(lib, name)
    for label, _, ptxas in built:
        for line in ptxas:
            print(f"[ptxas] {label} {line}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[ab] card: {card}")
    dev = torch.device("cuda")

    for walls in (False, "noslip"):
        sol, cu = cs.ns_solver(torch, dev, grid, torch.float32, mu=cs.TGV_MU,
                               prandtl=cs.TGV_PRANDTL, walls=walls)
        u = cs.ns_state(torch, sol, torch.float32, cs.tgv_fields(sol))
        dt = float(cu.cfl_dt(u))
        ref = sol.predictor_volume(u, dt)
        fv64 = cs.fvwall_f64(torch, sol, u, dt, cs.TGV_MU, cs.TGV_PRANDTL, walls) if walls else None

        def launch(lib):
            new = torch.empty_like(u)
            faces = torch.empty(sol.face_shape, dtype=u.dtype, device=dev)
            fvwall, planes = None, (0, None, None, 0)
            if walls:
                fvwall = torch.empty(2 * cu.walls["size"], dtype=u.dtype, device=dev)
                planes = (cu.walls["mask"], fvwall.data_ptr(), cu.walls["off"].ctypes.data,
                          cu.walls["size"])
            err = lib(
                u.data_ptr(), new.data_ptr(), faces.data_ptr(), None, dt, cu._ops.ctypes.data,
                cu._dx.ctypes.data, sol.order, sol.picard_iters, cu._physics_id,
                cu._params.ctypes.data, *sol.grid_shape, *planes,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"aderdg_predictor_volume_visc: CUDA error {err}")
            return new, faces, fvwall

        tag = "periodic" if not walls else "no-slip walls on axis 0"
        for label, lib in libs.items():
            got = launch(lib)
            torch.cuda.synchronize()
            for what, a, b in zip(("new", "faces", "fvwall"), got, ref):
                if b is None:
                    continue
                if what == "fvwall":
                    err, limit, _ = cs.fvwall_f32_check(torch, sol, a, b, fv64)
                else:
                    err, limit = cs.max_err(torch, a, b), cs.f32_bound(torch, b)
                print(f"[check] {label} {tag} {what}: max_abs_err {err:.3e} limit {limit:.3e}")
                if not err <= limit:
                    sys.exit(f"torch_visc_ab: {label} disagrees with the plain predictor")
        order = list(libs) + list(reversed(libs))
        times = {label: [] for label in libs}
        for label in order:
            times[label].append(cs.event_ms(torch, lambda: launch(libs[label]), 20))
        for label, ms in times.items():
            print(f"[ab] {label} {tag} {grid} f32: aderdg_predictor_volume_visc "
                  f"{statistics.mean(ms)!r} ms (turns {ms!r}) ({card})")
        del sol, cu, u, ref, fv64
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
