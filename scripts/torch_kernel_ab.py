#!/usr/bin/env python3
"""Time versions of ``csrc/aderdg.cu`` against each other in one process (GPU).

    python3 scripts/torch_kernel_ab.py LABEL=SOURCE[:FLAG,FLAG...] ... [--out DIR] [--sass]

Each argument names a copy of ``exahype_tpu_torch/csrc/aderdg.cu`` (an
older version, or the current file built with other ``-D`` flags).  The
script builds each into a library of its own with the port's nvcc flags
(``csrc/`` on the include path), prints ptxas's registers and spills of the
Picard predictor, checks each library's ``aderdg_predictor_volume`` and face
stage against the plain PyTorch versions (f32 at ``(256, 8, 128)``, f64 at
``(3, 5, 7)``), and times both with CUDA events, the versions in turns
(A B ... B A) at ``bench.py::main``'s shape, so that every version sees the
same card in the same state.  Needs a CUDA card and nvcc; imports no JAX.
With ``--sass`` it instead counts, in ``cuobjdump -sass`` of each version,
the instructions of each f32 kernel of the file by kind (reciprocals,
square roots, FP32 adds/multiplies/FMAs, shuffles, shared loads and stores,
barriers, local spills, all) and exits: that needs nvcc and cuobjdump, no
card, and takes any version of the file (an include of the version's own
directory comes first).

Example (the current kernels against a file kept from an earlier commit):

    git show HEAD~1:exahype_tpu_torch/csrc/aderdg.cu > build/old_aderdg.cu
    python3 scripts/torch_kernel_ab.py old=build/old_aderdg.cu \\
        new=exahype_tpu_torch/csrc/aderdg.cu

A version must export the current C interface of the face stage and the
predictor (``_build._SIGNATURES``' ``aderdg`` entries).
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


def _parse(arg: str):
    label, _, rest = arg.partition("=")
    src, _, flags = rest.partition(":")
    if not label or not src:
        raise SystemExit(f"torch_kernel_ab: expected LABEL=SOURCE[:FLAGS], got {arg!r}")
    return label, pathlib.Path(src).resolve(), [f for f in flags.split(",") if f]


def _build_one(build, out_dir, item):
    label, src, flags = item
    out = out_dir / f"lib_{label}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-I", str(src.parent), "-I",
           str(build.CSRC), "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"torch_kernel_ab: nvcc failed for {label}:\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    ptxas = []
    for i, line in enumerate(log):
        if "Compiling entry" in line and "23aderdg_predictor_volume" in line:
            # The entry's spill line and its "Used N registers" line.
            info = [x.strip() for x in log[i + 1:i + 5] if "spill" in x or "Used" in x]
            ptxas.append(("f64" if "IdLi4" in line else "f32", "; ".join(info)))
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
            for kernel in ("ck_predictor_volume", "predictor_volume", "face_flux",
                           "surface_update", "face_surface"):
                if f"aderdg_{kernel}If" in fn:
                    name = "aderdg_" + kernel + (" (elastic)" if "Elastic" in fn else "")
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
    args = parser.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    from exahype_tpu_torch import _build
    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

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
        signatures = [(k, v) for k, v in _build._SIGNATURES.items() if "aderdg" in k]
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

    big, u = setup(GRID, torch.float32)
    dt = float(big.cfl_dt(u))
    small, us = setup(SMALL, torch.float64)
    ref = big.predictor_volume(u, dt)
    ref_surf = big.face_surface(ref[0], ref[1], dt)
    ref64 = small.predictor_volume(us, 5e-5)
    bound32 = 64 * 2.0**-23 * ref[1].abs().max().item()

    def use(label):
        _build.library = lambda lib=libs[label]: lib

    for label, _, ptxas in built:
        use(label)
        cu, cs = CudaADERDG(big), CudaADERDG(small)
        new, faces = cu.predictor_volume(u, dt)
        surf = cu.face_surface(ref[0].clone(), ref[1], dt)
        new64, faces64 = cs.predictor_volume(us, 5e-5)
        torch.cuda.synchronize()
        errs = [
            (new - ref[0]).abs().max().item(), (faces - ref[1]).abs().max().item(),
            (surf - ref_surf).abs().max().item(),
            (new64 - ref64[0]).abs().max().item(), (faces64 - ref64[1]).abs().max().item(),
        ]
        ok = max(errs[:3]) <= bound32 and max(errs[3:]) <= 1e-12
        print(f"[ab] {label}: ptxas {ptxas}")
        print(f"[ab] {label}: max_abs_err f32 {GRID} new {errs[0]:.3e} faces {errs[1]:.3e} "
              f"face stage {errs[2]:.3e} (bound {bound32:.3e}); f64 {SMALL} new {errs[3]:.3e} "
              f"faces {errs[4]:.3e} (bound 1e-12): {'ok' if ok else 'FAIL'}")
        if not ok:
            sys.exit(f"torch_kernel_ab: {label} disagrees with the plain version")

    order = [label for label, _, _ in built]
    times = {label: {"predictor": [], "face stage": []} for label in order}
    for label in order + order[::-1]:
        use(label)
        cu = CudaADERDG(big)
        new, faces = cu.predictor_volume(u, dt)
        times[label]["predictor"].append(event_ms(lambda: cu.predictor_volume(u, dt)))
        times[label]["face stage"].append(event_ms(lambda: cu.face_surface(new, faces, dt)))
    for label in order:
        print(f"[ab] {label}: aderdg_predictor_volume ms {times[label]['predictor']!r}, "
              f"face stage ms {times[label]['face stage']!r} (CUDA events, 30 launches "
              f"each, {GRID} f32; {card})")


if __name__ == "__main__":
    main()
