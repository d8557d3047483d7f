#!/usr/bin/env python3
"""Time the face stage's wall variant against the periodic face stage (GPU).

    python3 scripts/torch_walls_ab.py [--rounds N]

Builds ``csrc/`` (the port's nvcc flags), then, at ``chip_smoke.py``'s
``(256, 8, 128)`` in float32, times with CUDA events (30 launches each, the
two versions in turns: periodic, walls, walls, periodic, ...) the launches
``aderdg_face_flux[_walls]`` and ``aderdg_surface_update[_walls]`` and the
pair, for two configurations: 3-D Euler with reflective walls on every
axis (``bench.py``'s state) and the CK heterogeneous elasticity with the
free surface on axis 2 (``bench.py::bench_ck``'s state).  Prints each
kernel's registers and resident blocks per SM, the walled step against the
plain one, and the card's name and power limit.  Needs a CUDA card and
nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    import numpy as np
    import torch

    import chip_smoke as S
    from exahype_tpu_torch import _build
    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models import elastic

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2, help="pairs of turns per configuration")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    _build.library()
    dev = torch.device("cuda")

    def euler(walls):
        flux, eig = euler_physics(3)
        sol = ADERDGSolver(3, 3, 5, S.GRID, flux, eig, dx=S.DX, device=dev,
                           dtype=torch.float32, **walls)
        return sol, S.bench_state(sol, torch, dev, torch.float32)

    def ck(walls):
        flux, eig = elastic.elastic3d_heterogeneous()
        sol = ADERDGSolver(3, 3, 12, S.GRID, flux, eig, dx=1.0 / S.GRID[0], device=dev,
                           dtype=torch.float32, predictor_mode="ck",
                           ck_material_slots=elastic.MATERIAL_SLOTS,
                           dissipation_mask=elastic.DISSIPATION_MASK, **walls)
        q, _ = elastic.two_layer_state(sol)
        return sol, torch.from_numpy(np.ascontiguousarray(q)).to(dev, torch.float32)

    refl, refl_flux = elastic.elastic3d_free_surface_het()
    configs = {
        "Euler reflective box": (euler, S.euler_walls("reflective box", S.GRID)),
        "CK free surface": (ck, dict(boundary="reflective", reflect_fn=refl,
                                     reflect_flux_fn=refl_flux, wall_axes=(2,))),
    }
    for label, (make, walls) in configs.items():
        versions = {}
        for name, w in (("periodic", {}), ("walls", walls)):
            sol, u = make(w)
            cu = CudaADERDG(sol)
            dt = float(sol.cfl_dt(u))
            new, faces, _ = cu.predictor_volume(u, dt)
            fhat, fwall = cu.face_flux(faces)
            versions[name] = (sol, cu, u, dt, new, faces, fhat, fwall)
        times = {name: [] for name in versions}
        for turn in range(args.rounds):
            for name in (("periodic", "walls") if turn % 2 == 0 else ("walls", "periodic")):
                sol, cu, u, dt, new, faces, fhat, fwall = versions[name]
                times[name].append((
                    S.event_ms(torch, lambda: cu.face_flux(faces), 30),
                    S.event_ms(torch, lambda: cu.surface_update(new, fhat, dt, fwall), 30),
                    S.event_ms(torch, lambda: cu.face_surface(new, faces, dt), 30),
                ))
        for name, (sol, cu, u, dt, *_rest) in versions.items():
            shapes = {k: cu.kernel_info(k, torch.float32) for k in cu.kernels[1:]}
            print(f"[walls ab] {label}, {name}: " + ", ".join(
                f"{k} {v['registers']} registers, {v['blocks_per_sm']} blocks of "
                f"{v['threads']} an SM" for k, v in shapes.items()))
            for flux_ms, update_ms, stage_ms in times[name]:
                print(f"[walls ab] {label}, {name}: face flux {flux_ms!r} ms, update "
                      f"{update_ms!r} ms, the pair {stage_ms!r} ms (CUDA events; {card})")
        sol, cu, u, dt, *_rest = versions["walls"]
        ref = sol.step(u, dt)
        err, bound = S.max_err(torch, cu.step(u, dt), ref), S.f32_bound(torch, ref)
        print(f"[walls ab] {label}: walled step against plain, max_abs_err {err:.3e} "
              f"(bound {bound:.3e})")
        if not err <= bound:
            sys.exit(f"{label}: the walled step disagrees with plain")
        del versions
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
