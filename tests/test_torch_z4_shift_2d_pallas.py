"""The 2-D per-axis shifted Z4 step of the port against the TPU kernel it
replaces: one step of JAX's ``PallasADERDG(interpret=True)`` on the JAX
package's default ``make_z4_shift_solver(dim=2, order=2, ...)`` (per-axis
NCP: the Pallas body's ``ncp_fn`` and ``source_fn`` branch,
``aderdg_pallas.py:441-463``) with the κ₁-damped Gamma-driver, (2, 2) cells
at dx = 0.5, on the moving gauge wave (v = 0.2, amplitude 0.01) with seeded
noise of 1e-4 on every slot, against the port's ``CudaADERDG`` over the
per-axis solver (on the CPU, its kernels' plain versions), in float64.
Depth is cut for interpret mode, which evaluates the kernel's body op by
op: one Picard iteration (``picard_iters=1``), the same kernel body, as
``tests/test_torch_z4_grmhd_2d_pallas.py`` cuts it.

JAX's solver is the einsum formulation and the port's the SoA one, so the
bar is 1e-12·max(1, max|ref|) (ROADMAP Queue 3's converter caveat).  There
is one step, on the smallest grid.
"""

import jax.numpy as jnp
import numpy as np
import torch

from exahype_tpu.models import z4 as jz
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu_torch.convert import state_from_numpy, state_to_numpy, z4_shift_solver_from_jax
from exahype_tpu_torch.models import z4 as tz
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

torch.set_num_threads(1)

DRIVER = dict(shift="gamma_driver", kappa1=0.2, eta=0.7)


def test_per_axis_step_matches_pallas_interpret():
    js = jz.make_z4_shift_solver(dim=2, order=2, grid_shape=(2, 2), dx=0.5, picard_iters=1,
                                 **DRIVER)
    assert js.rhs_all_fn is None and js.ncp_fn is not None and js.source_fn is not None
    sol = tz.make_z4_shift_solver(2, 2, (2, 2), dx=0.5, device="cpu", **DRIVER)
    Q = state_to_numpy(tz.moving_gauge_wave_state(sol, v=0.2, amplitude=0.01))
    Q = Q + 1e-4 * np.random.default_rng(3).standard_normal(Q.shape)
    pallas = PallasADERDG(js, interpret=True)
    ref = np.asarray(pallas.step(jnp.asarray(Q), 1e-3))
    cu = z4_shift_solver_from_jax(pallas, device="cpu", **DRIVER)
    assert isinstance(cu, CudaADERDG) and cu.per_axis and cu.solver.picard_iters == 1
    assert cu.kernels[0] == "aderdg_predictor_volume_per_axis_2d_z4_shift"
    got = state_to_numpy(cu.step(state_from_numpy(Q, device="cpu"), 1e-3))
    assert np.isfinite(got).all() and np.abs(got - Q).max() > 1e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * max(1.0, np.abs(ref).max()))
