#!/usr/bin/env python3
"""``examples/z4_gauge_wave.py``'s chip configuration in float32 and
float64, in the JAX package and in the port: the 2-D vacuum Z4 gauge wave
at order 3, per-axis NCP, harmonic slicing, amplitude 0.01, (64, 2) cells at
dx = 1/64, 256 steps to t = 0.1; the error against the exact wave and the
largest ADM constraint after each eighth of the run, beside the example's
chip gates (5e-4, 1e-3).

    python3 scripts/z4_gauge_wave_f32.py [--cells 64] [--card] [--no-jax]

JAX runs on the CPU (its einsum formulation, the example's CPU build,
jitted); the port runs its plain solver on the CPU, or with ``--card`` its
kernels (``CudaADERDG``) on the GPU, where JAX is not imported
(``--no-jax`` is implied).  Each float32 run starts from the float32
rounding of the exact state.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

T_END = 0.1
AMPLITUDE = 0.01
GATES = (5e-4, 1e-3)  # examples/z4_gauge_wave.py:75-76, the chip's


def port_run(cells: int, dtype_name: str, card: bool) -> list:
    import torch

    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.z4 import gauge_wave_state, make_z4_solver, solver_constraints

    device = "cuda" if card else "cpu"
    dtype = getattr(torch, dtype_name)

    def make(dt):
        return make_z4_solver(2, 3, (cells, 2), dx=1.0 / cells, slicing="harmonic", f=1.0,
                              impl="soa", device=device, dtype=dt)

    sol, sol64 = make(dtype), make(torch.float64)
    stepper = CudaADERDG(sol) if card else sol
    steps = 4 * cells
    dt = T_END / steps
    u, rows = gauge_wave_state(sol, amplitude=AMPLITUDE), []
    for k in range(1, 9):
        u = stepper.run(u, steps // 8, dt)
        exact = gauge_wave_state(sol64, t=k * steps // 8 * dt, amplitude=AMPLITUDE)
        H, M = solver_constraints(sol64, u.double())
        rows.append((k * steps // 8, (u.double() - exact).pow(2).mean().sqrt().item(),
                     max(H.abs().max().item(), M.abs().max().item())))
    return rows


def jax_run(cells: int, dtype_name: str) -> list:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from exahype_tpu.models.z4 import gauge_wave_state, make_z4_solver, solver_constraints

    js = make_z4_solver(dim=2, order=3, grid_shape=(cells, 2), dx=1.0 / cells,
                        slicing="harmonic", f=1.0, impl="einsum")
    dtype = getattr(jnp, dtype_name)
    steps = 4 * cells
    dt = T_END / steps
    step = jax.jit(js.step)
    q, rows = gauge_wave_state(js, t=0.0, amplitude=AMPLITUDE).astype(dtype), []
    for i in range(1, steps + 1):
        q = step(q, dtype(dt))
        if i % (steps // 8) == 0:
            qq = np.asarray(q, dtype=np.float64)
            exact = np.asarray(gauge_wave_state(js, t=i * dt, amplitude=AMPLITUDE))
            H, M = solver_constraints(js, jnp.asarray(qq))
            rows.append((i, float(np.sqrt(np.mean((qq - exact) ** 2))),
                         max(float(jnp.abs(H).max()), float(jnp.abs(M).max()))))
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cells", type=int, default=64)
    parser.add_argument("--card", action="store_true", help="the port's kernels on the GPU")
    parser.add_argument("--no-jax", action="store_true")
    args = parser.parse_args()
    runs = []
    for dtype_name in ("float32", "float64"):
        if not (args.no_jax or args.card):
            runs.append((f"JAX einsum, CPU, {dtype_name}", jax_run, (args.cells, dtype_name)))
        runs.append((f"port {'kernels, card' if args.card else 'plain, CPU'}, {dtype_name}",
                     port_run, (args.cells, dtype_name, args.card)))
    for label, fn, fargs in runs:
        t0 = time.perf_counter()
        rows = fn(*fargs)
        for step, err, cmax in rows:
            print(f"[gauge wave] {label}, ({args.cells}, 2): step {step}: error {err!r}, max ADM "
                  f"constraint {cmax!r}", flush=True)
        err, cmax = rows[-1][1:]
        over = err >= GATES[0] or cmax >= GATES[1]
        print(f"[gauge wave] {label}: at t = {T_END} {'over' if over else 'within'} the chip "
              f"gates {GATES} ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
