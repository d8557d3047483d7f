#!/usr/bin/env python3
"""Time K4, the generated FV spec kernel, with each of two print-time
choices switched off in turn, in one process (GPU).

    python3 scripts/torch_spec_ab.py

Prints the 3-D ``fv`` spec of the FV main path (patch 4, halo 1, 5
variables) three times: as ``CudaPrinter`` prints it; with
``backends/spec_plan.py``'s copy propagation off (``Q_copy = Q`` then runs
on the 160 cells the flux calls read, and ``Q_copy`` is kept over the whole
padded patch); and with the generator's hoisting off (a value that reads no
variable is then computed for every variable of a cell, not once a cell).
For each version it prints the shared memory a patch, the barriers and
``kernel_info`` (registers, resident blocks an SM), checks it against the
plain version (f32, within 64 spacings of the largest value), and times
the versions with CUDA events in turns (A B C C B A, 30 launches each) at
``(32, 16, 128)`` and ``(8, 8, 128)`` patches, so that all see the same
card in the same state.  Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import math
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
GRIDS = ((32, 16, 128), (8, 8, 128))


def main():
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    from exahype_tpu_torch.backends import cuda_backend, spec_plan
    from exahype_tpu_torch.models.fv import build_fv_rusanov_kernel

    if not torch.cuda.is_available():
        sys.exit("torch_spec_ab: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[spec ab] card: {card}")
    dev = torch.device("cuda")

    # label -> (function name, (owner, attribute, replacement) or None)
    versions = {
        "as printed": ("time_step", None),
        "no copy propagation": ("time_step_no_copy_propagation",
                                (spec_plan, "_propagate_copies", lambda kb, loops: loops)),
        "no hoisting": ("time_step_no_hoisting",
                        (cuda_backend._Generator, "_expr", cuda_backend._Generator._value)),
    }

    def printer(grid, label):
        kb = build_fv_rusanov_kernel(dim=3, patch_size=4, halo_size=1, n_real=5, n_aux=0,
                                     n_patches=math.prod(grid))
        name, switch = versions[label]
        if switch is None:
            return cuda_backend.CudaPrinter(kb, name)
        owner, attr, off = switch
        keep = getattr(owner, attr)
        setattr(owner, attr, off)
        try:
            return cuda_backend.CudaPrinter(kb, name)
        finally:
            setattr(owner, attr, keep)

    def state(grid):
        rng = np.random.default_rng(0)
        q = rng.uniform(0.1, 1.0, size=(6, 6, 6, 5) + grid)
        q[:, :, :, 0] += 1.0
        q[:, :, :, 4] += 5.0
        return torch.from_numpy(q).to(dev, torch.float32).contiguous()

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

    labels = tuple(versions)
    for grid in GRIDS:
        fns, q = {}, state(grid)
        for label in labels:
            pr = printer(grid, label)
            fn = fns[label] = pr.build()
            got = fn(q.clone(), 0.05)
            ref = fn.plain(q.clone(), 0.05)
            torch.cuda.synchronize()
            err = (got.double() - ref.double()).abs().max().item()
            bound = 64 * 2.0**-23 * ref.abs().max().item()
            print(f"[spec ab] {grid} {label}: {pr.plan.values_per_patch(pr.kernel())} values a "
                  f"patch, {pr.code.count('__syncthreads();')} barriers, "
                  f"{fn.kernel_info(torch.float32)}; max_abs_err {err!r} (bound {bound!r})")
            if not err <= bound:
                sys.exit(f"torch_spec_ab: {label} disagrees with the plain version")
        times = {label: [] for label in labels}
        for label in labels + labels[::-1]:
            u = q.clone()
            times[label].append(event_ms(lambda fn=fns[label]: fn(u, 1e-3)))
            if not torch.isfinite(u).all():
                sys.exit(f"torch_spec_ab: {label} left a non-finite state")
        for label in labels:
            print(f"[spec ab] {grid} {label}: K4 ms {times[label]!r} (CUDA events, 30 "
                  f"launches each, f32; {card})")


if __name__ == "__main__":
    main()
