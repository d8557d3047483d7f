#!/usr/bin/env python3
"""Whether two checkouts' Euler ADER-DG kernels give the same bits (GPU).

    python3 scripts/torch_same_bits.py OTHER_CHECKOUT [--out DIR]

Runs ``exahype_tpu_torch``'s ``CudaADERDG`` Euler kernels of this checkout
and of ``OTHER_CHECKOUT`` (each in a process of its own, importing the port
from its own root and building its own ``csrc/``) on the same inputs —
``bench.py``'s state recipe at ``(8, 4, 32)`` in float64 and float32 and at
``(256, 8, 128)`` in float32, dt under the CFL limit — and compares
``aderdg_predictor_volume``'s ``new`` and ``faces``, the face stage's
``new`` with its face fluxes, and three chained steps, bit for bit.  Prints
one line per output and exits non-zero if any differs.  Needs a CUDA card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parent.parent
CASES = (((8, 4, 32), "float64"), ((8, 4, 32), "float32"), ((256, 8, 128), "float32"))
DT = 5e-5  # under the CFL limit (6.26e-5) of this state at dx = 1/256

_CHILD = r"""
import sys
root, out = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np
import torch
from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
import exahype_tpu_torch
assert exahype_tpu_torch.__file__.startswith(root), exahype_tpu_torch.__file__
results = {}
for grid, dtype in CASES:
    dtype = getattr(torch, dtype)
    flux, eig = euler_physics(3)
    sol = ADERDGSolver(3, 3, 5, grid, flux, eig, dx=1.0 / 256, device="cuda", dtype=dtype)
    cu = CudaADERDG(sol)
    rng = np.random.default_rng(0)
    rho = 1.0 + 0.2 * rng.random((4, 4, 4) + grid)
    q = np.stack([rho, rho, 0.5 * rho, 0.25 * rho, 5.0 + 0.5 * rho * 1.3125], axis=3)
    u = torch.from_numpy(q).to("cuda", dtype).contiguous()
    new, faces = cu.predictor_volume(u, DT)[:2]  # older checkouts return two
    surf, fl = cu.face_surface(new.clone(), faces, DT, return_face_fluxes=True)
    key = f"{grid} {dtype}"
    results[key + " predictor new"] = new.cpu()
    results[key + " predictor faces"] = faces.cpu()
    results[key + " face_surface new"] = surf.cpu()
    results[key + " face fluxes"] = torch.stack(fl).cpu()
    results[key + " 3 steps"] = cu.run(u, 3, DT).cpu()
torch.save(results, out)
"""


def run(root: pathlib.Path, out: pathlib.Path) -> dict:
    import torch

    code = f"CASES = {CASES!r}\nDT = {DT!r}\n" + _CHILD
    subprocess.run([sys.executable, "-c", code, str(root), str(out)], check=True)
    return torch.load(out)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=pathlib.Path, help="root of the other checkout")
    parser.add_argument("--out", type=pathlib.Path, help="where to keep the outputs")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_same_bits: no CUDA card")
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or pathlib.Path(tmp)
        out.mkdir(parents=True, exist_ok=True)
        mine = run(HERE, out / "this.pt")
        theirs = run(args.other.resolve(), out / "other.pt")
    same = True
    for key, a in mine.items():
        b = theirs[key]
        # Bit patterns, so -0.0 against 0.0 counts as a difference.
        equal = a.shape == b.shape and torch.equal(
            a.view(torch.int64 if a.dtype == torch.float64 else torch.int32),
            b.view(torch.int64 if b.dtype == torch.float64 else torch.int32))
        same &= equal
        print(f"[same bits] {key}: {'identical' if equal else 'DIFFERENT'}"
              + ("" if equal else f" (max |diff| {(a.double() - b.double()).abs().max().item()!r})"))
    print(f"[same bits] {HERE} vs {args.other}: {'identical' if same else 'DIFFERENT'}")
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
