"""``examples/z4_gauge_wave.py``'s chip configuration in float32 in the
reference (ROADMAP.md Queue 3): the 2-D vacuum Z4 gauge wave at order 3,
per-axis, harmonic slicing, amplitude 0.01, (64, 2) cells at dx = 1/64, dt
= 0.1/256, through the JAX package's own step (the einsum formulation the
example builds on the CPU, jitted), from the float32 rounding of the exact
state.  The port's side of the pin is on the card
(``tests/test_torch_cuda.py::test_z4_example_chip_run_fails_in_float32``)
and in ``scripts/z4_gauge_wave_f32.py``.
"""

import jax
import numpy as np

from exahype_tpu.models import z4 as jz

ORDER = 3
T_END = 0.1


def test_example_chip_run_grows_in_float32_in_the_reference():
    """The example's chip configuration ((64, 2) cells, 256 steps) fails its
    chip gates in float32 in both packages: a mode that float32 rounding
    seeds grows ~8 % a step.  Here the largest ADM constraint rises more
    than twentyfold from step 64 to step 128 (it reaches ~40 by step 256);
    the port's plain path and kernels give the same trajectory."""
    cells = 64
    js = jz.make_z4_solver(dim=2, order=ORDER, grid_shape=(cells, 2), dx=1.0 / cells,
                           slicing="harmonic", f=1.0, impl="einsum")
    q = jz.gauge_wave_state(js, t=0.0, amplitude=0.01).astype(np.float32)
    dt = np.float32(T_END / (4 * cells))
    step = jax.jit(js.step)
    cmax = []
    for i in range(1, 129):
        q = step(q, dt)
        if i in (64, 128):
            H, M = jz.solver_constraints(js, np.asarray(q, dtype=np.float64))
            cmax.append(max(float(np.abs(H).max()), float(np.abs(M).max())))
    assert q.dtype == np.float32 and cmax[1] > 20 * cmax[0], cmax
