"""The 2-D per-axis Z4 step of the port against the TPU kernel it replaces:
one step of JAX's ``PallasADERDG(interpret=True)`` on
``tests/test_z4.py::test_z4_fused_pallas_parity``'s solver (vacuum Z4, 2-D,
order 2, (4, 2) cells at dx = 0.25, κ₁ = 0.5, κ₂ = 0.1, per-axis NCP: the
Pallas body's ``ncp_fn`` and ``source_fn`` branch) on its noisy gauge wave,
against the port's ``CudaADERDG`` over the per-axis ``impl="soa"`` solver
(on the CPU, its kernels' plain versions), in float64.

JAX's solver there is the einsum formulation; the port's is the SoA one,
the same algebra in another operation order, so the bar is
1e-12·max(1, max|ref|) (ROADMAP Queue 3's converter caveat).  Interpret mode
costs ~45 s a step here, so there is one.
"""

import jax.numpy as jnp
import numpy as np
import torch

from exahype_tpu.models import z4 as jz
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu_torch.convert import state_from_numpy, state_to_numpy, z4_solver_from_jax
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

torch.set_num_threads(1)


def test_per_axis_step_matches_pallas_interpret():
    js = jz.make_z4_solver(dim=2, order=2, grid_shape=(4, 2), dx=0.25, kappa1=0.5, kappa2=0.1)
    assert js.rhs_all_fn is None and js.ncp_fn is not None
    rng = np.random.default_rng(3)  # tests/test_z4.py::_noisy_gauge_wave
    Q = np.asarray(jz.gauge_wave_state(js, amplitude=0.01)) + 1e-4 * rng.standard_normal(
        js.state_shape)
    pallas = PallasADERDG(js, interpret=True)
    ref = np.asarray(pallas.step(jnp.asarray(Q), 1e-3))
    cu = z4_solver_from_jax(pallas, kappa1=0.5, kappa2=0.1, device="cpu")
    assert isinstance(cu, CudaADERDG) and cu.per_axis
    assert cu.kernels[0] == "aderdg_predictor_volume_per_axis_2d_z4"
    got = state_to_numpy(cu.step(state_from_numpy(Q, device="cpu"), 1e-3))
    assert np.isfinite(got).all() and np.abs(got - Q).max() > 1e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * max(1.0, np.abs(ref).max()))
