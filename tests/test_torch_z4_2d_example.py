"""``examples/z4_gauge_wave.py``'s CPU run, side by side in the two
packages: the 2-D vacuum Z4 gauge wave at order 3 on (8, 2) cells, dx =
1/8, harmonic slicing, 32 steps to t = 0.1, float64, through the port's
``CudaADERDG`` (on the CPU, its kernels' plain versions: the per-axis
predictor's and the 2-D face stage's) and through the JAX solver as the
example builds it on the CPU (the einsum formulation; the port's is the
SoA one, so the bar is 1e-12·max(1, max|ref|), ROADMAP Queue 3's converter
caveat).  Both meet the example's CPU gates: error against the exact wave
< 5e-5, largest ADM constraint < 1e-10.  The JAX steps are jitted (one
compile, ~20 s, against ~3 s an eager step).  Its chip configuration in
float32 is ``tests/test_torch_z4_2d_f32.py``.
"""

import jax
import numpy as np
import torch

from exahype_tpu.models import z4 as jz
from exahype_tpu_torch.convert import state_from_numpy, state_to_numpy, z4_solver_from_jax
from exahype_tpu_torch.models import z4 as tz
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

torch.set_num_threads(1)

CELLS = 8
ORDER = 3
T_END = 0.1
STEPS = 4 * CELLS


def test_example_cpu_run_matches_jax_and_its_gates():
    js = jz.make_z4_solver(dim=2, order=ORDER, grid_shape=(CELLS, 2), dx=1.0 / CELLS,
                           slicing="harmonic", f=1.0, impl="einsum")
    Q0 = np.asarray(jz.gauge_wave_state(js, t=0.0, amplitude=0.01))
    dt = T_END / STEPS
    step = jax.jit(js.step)
    q = Q0
    for _ in range(STEPS):
        q = step(q, dt)
    ref = np.asarray(q)
    cu = CudaADERDG(z4_solver_from_jax(js, device="cpu"))
    assert cu.per_axis and cu.kernels[0] == "aderdg_predictor_volume_per_axis_p3_2d_z4"
    got = cu.run(state_from_numpy(Q0, device="cpu"), STEPS, dt)
    assert cu.launches == {name: 0 for name in cu.kernels}
    np.testing.assert_allclose(state_to_numpy(got), ref, rtol=0,
                               atol=1e-12 * max(1.0, np.abs(ref).max()))
    sol = cu.solver
    exact = tz.gauge_wave_state(sol, t=T_END, amplitude=0.01)
    err = (got - exact).pow(2).mean().sqrt().item()
    H, M = tz.solver_constraints(sol, got)
    cmax = max(H.abs().max().item(), M.abs().max().item())
    assert err < 5e-5 and cmax < 1e-10, (err, cmax)
    exact_j = np.asarray(jz.gauge_wave_state(js, t=T_END, amplitude=0.01))
    assert np.sqrt(np.mean((ref - exact_j) ** 2)) < 5e-5
    Hj, Mj = jz.solver_constraints(js, ref)
    assert max(float(np.abs(Hj).max()), float(np.abs(Mj).max())) < 1e-10

