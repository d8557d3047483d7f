#!/usr/bin/env python3
"""Time versions of the order-5 predictor against each other in one process (GPU).

    python3 scripts/torch_p5_ab.py LABEL=SOURCE[:FLAG,FLAG...] ... [--grids G0,G1,G2;...]

Each argument names a copy of ``exahype_tpu_torch/csrc/aderdg_p5.cu`` (its
own directory first on the include path, so a copy of ``aderdg_st.cuh``
beside it is the one it includes; ``-D`` flags are levers).  The script
builds each into a library of its own with the port's nvcc flags, prints
ptxas's registers and spills of its predictor, checks each version's
``aderdg_predictor_volume_p5`` against the plain
``ADERDGSolver.predictor_volume`` (the new state and the faces within 64
float32 spacings of the largest value) and times it with CUDA events on
``chip_smoke.py``'s order-5 state (``examples/high_order_p5.py``'s wave,
float32, dt = 2e-5) at each grid, the versions in turns (A B ... B A), so
that every version sees the same card in the same state.  Needs a CUDA
card and nvcc; imports no JAX.

Example (the predictor with one block an SM in float32, against the kernel
the port runs):

    mkdir -p build/one && cp exahype_tpu_torch/csrc/aderdg_p5.cu \\
        exahype_tpu_torch/csrc/aderdg_st.cuh build/one/
    sed -i 's/sizeof(T) == 4 ? 2 : 1/1/' build/one/aderdg_st.cuh
    python3 scripts/torch_p5_ab.py one=build/one/aderdg_p5.cu \\
        port=exahype_tpu_torch/csrc/aderdg_p5.cu
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
        raise SystemExit(f"torch_p5_ab: nvcc failed for {label}:\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    ptxas = [f"{log[i].split('entry function')[1].strip()[:90]}: " + "; ".join(
        x.strip() for x in log[i + 1:i + 4] if "spill" in x or "Used" in x)
        for i, line in enumerate(log) if "Compiling entry" in line]
    return label, out, ptxas


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("versions", nargs="+", help="LABEL=SOURCE[:FLAG,FLAG...]")
    parser.add_argument("--grids", default="32,4,128;64,8,128", help="cell grids, ';' apart")
    args = parser.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs
    from exahype_tpu_torch import _build
    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

    if not torch.cuda.is_available():
        sys.exit("torch_p5_ab: no CUDA card")
    items = []
    for arg in args.versions:
        label, _, rest = arg.partition("=")
        src, _, flags = rest.partition(":")
        items.append((label, pathlib.Path(src).resolve(), [f for f in flags.split(",") if f]))
    name = "exahype_aderdg_predictor_volume_p5_f32"
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
    flux, eig = euler_physics(3, n_real=5, gamma=cs.WAVE_GAMMA)

    for text in args.grids.split(";"):
        grid = tuple(int(g) for g in text.split(","))
        sol = ADERDGSolver(3, 5, 5, grid, flux, eig, dx=1.0 / grid[0], device=dev,
                           dtype=torch.float32)
        cu = CudaADERDG(sol)
        u = cs.density_wave(torch, sol, 0.0, torch.float32)
        dt = cs.ST_DT[5]
        ref = sol.predictor_volume(u, dt)

        def launch(lib):
            new = torch.empty_like(u)
            faces = torch.empty(sol.face_shape, dtype=u.dtype, device=dev)
            err = lib(u.data_ptr(), new.data_ptr(), faces.data_ptr(), None, dt,
                      cu._ops.ctypes.data, cu._dx.ctypes.data, sol.order, sol.picard_iters,
                      cu._physics_id, cu._params.ctypes.data, *sol.grid_shape,
                      torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"aderdg_predictor_volume_p5: CUDA error {err}")
            return new, faces

        for label, lib in libs.items():
            got = launch(lib)
            torch.cuda.synchronize()
            for what, a, b in zip(("new", "faces"), got, ref):
                err, limit = cs.max_err(torch, a, b), cs.f32_bound(torch, b)
                print(f"[check] {label} {grid} {what}: max_abs_err {err:.3e} limit {limit:.3e}")
                if not err <= limit:
                    sys.exit(f"torch_p5_ab: {label} disagrees with the plain predictor")
        order = list(libs) + list(reversed(libs))
        times = {label: [] for label in libs}
        for label in order:
            times[label].append(cs.event_ms(torch, lambda: launch(libs[label]), 20))
        for label, ms in times.items():
            print(f"[ab] {label} {grid} f32: aderdg_predictor_volume_p5 "
                  f"{statistics.mean(ms)!r} ms (turns {ms!r}) ({card})")
        del sol, cu, u, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
