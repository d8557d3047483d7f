#!/usr/bin/env python3
"""Peak device memory of the port's limited step (GPU).

    python3 scripts/torch_limited_mem.py [ROOT]

Imports ``exahype_tpu_torch`` from ROOT (default: this checkout; give a
``git archive`` copy of another commit to compare two), builds
``chip_smoke.py``'s limited kernel path (``(256, 8, 128)`` f32, the Sod
shock, capacity 128 rows, dt = 1.5e-4, 5 warm-up steps), and prints the
live memory before 10 steps, their peak, and the peak of one gathered
subcell stage (``_gathered_subcell_step_row``, its three sweeps included)
above the memory live before it (``torch.cuda.max_memory_allocated``).
Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

GRID, DT = (256, 8, 128), 1.5e-4


def main():
    root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else __file__).resolve()
    if root.is_file():
        root = root.parent.parent
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible

    if not torch.cuda.is_available():
        sys.exit("torch_limited_mem: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    flux, eig = euler_physics(3)
    sol = ADERDGSolver(3, 3, 5, GRID, flux, eig, dx=1 / GRID[0], device=dev,
                       dtype=torch.float32)
    cu = CudaADERDG(sol)
    lim = LimitedADERDG(sol, euler_admissible(3), troubled_capacity=128,
                        troubled_granularity="row", dmp_delta0=5e-4, accelerator=cu,
                        subcell_cuda=True, device=dev)
    left = np.broadcast_to(np.arange(GRID[0]).reshape(-1, 1, 1) < GRID[0] // 2, GRID)
    shape = (4, 4, 4) + GRID
    rho = np.broadcast_to(np.where(left, 1.0, 0.125), shape)
    p = np.broadcast_to(np.where(left, 1.0, 0.1), shape)
    zero = np.zeros(shape)
    q = np.stack([rho, zero, zero, zero, p / 0.4], axis=3).astype(np.float32)
    u = lim.run(torch.from_numpy(q).to(dev).contiguous(), 5, DT)
    gib = 2.0**-30

    def peak_above(fn):
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return live, torch.cuda.max_memory_allocated() - live

    live, step_peak = peak_above(lambda: lim.run(u, 10, DT))
    tables = lim._gather_tables_row(lim.troubled_mask(u, cu.step(u, DT)))
    _, gathered_peak = peak_above(lambda: lim._gathered_subcell_step_row(u, DT, tables))
    print(f"[mem] {root}: live before the steps {live * gib!r} GiB, peak of 10 limited "
          f"steps {(live + step_peak) * gib!r} GiB; one gathered subcell stage "
          f"({int(tables['active'].sum())} active slots) peaks {gathered_peak * gib!r} GiB "
          f"above the memory live before it ({card})")


if __name__ == "__main__":
    main()
