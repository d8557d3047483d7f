"""The 2-D per-axis Z4+GRMHD step of the port against the TPU kernel it
replaces: one step of JAX's ``PallasADERDG(interpret=True)`` on the JAX
package's default ``make_z4_grmhd_solver(dim=2, order=2, ...)`` (per-axis
NCP with the matter flux: the Pallas body's ``flux_fn``, ``ncp_fn`` and
``source_fn`` branch, ``aderdg_pallas.py:441-463``), (2, 2) cells at dx =
0.5, on the magnetized wave of the JAX package's tests with seeded noise of
1e-4 on every slot, against the port's ``CudaADERDG`` over the per-axis
solver (on the CPU, its kernels' plain versions), in float64.  Depth is cut
for interpret mode, which evaluates the kernel's body op by op (~300 s a
step at the defaults): one Picard iteration and 5 Newton trips of the
recovery (``picard_iters=1``, ``iters=5``), the same kernel body.

The Pallas body does not trace the JAX package's Z4+GRMHD flux as it stands:
``exahype_tpu/models/z4_grmhd.py:266`` multiplies by
``jnp.asarray(np.eye(3)[axis], q.dtype)``, an array constant that a Pallas
kernel may not capture, so no JAX test steps ``PallasADERDG`` on this
system.  The test pins that constant in the flux's jaxpr, then steps the
kernel with the module's ``jnp.asarray`` building such a 3-vector from its
three scalars (the same values; scalars are literals in the kernel), the
JAX package's files unchanged.  JAX's solver is the einsum formulation and
the port's the SoA one, so the bar is 1e-12·max(1, max|ref|) (ROADMAP Queue
3's converter caveat).  There is one step, on the smallest grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from exahype_tpu.models import z4_grmhd as jg
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu_torch.convert import state_from_numpy, state_to_numpy, z4_grmhd_solver_from_jax
from exahype_tpu_torch.models import z4_grmhd as tg
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

torch.set_num_threads(1)

#: The JAX package's Z4+GRMHD tests' gauge and cleaning, with 5 Newton trips.
GAUGE = dict(slicing="harmonic", f=0.0, glm_kappa=0.5, iters=5)


class _ScalarVectors:
    """``jax.numpy`` with ``asarray`` of a 1-D NumPy array built from its
    entries as scalars (a traced value, not a captured constant)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(x, dtype=None):
        if isinstance(x, np.ndarray) and x.ndim == 1:
            return jnp.stack([jnp.asarray(float(e), dtype) for e in x])
        return jnp.asarray(x, dtype)


def test_per_axis_step_matches_pallas_interpret(monkeypatch):
    js = jg.make_z4_grmhd_solver(dim=2, order=2, grid_shape=(2, 2), dx=0.5, picard_iters=1,
                                 **GAUGE)
    assert js.rhs_all_fn is None and js.ncp_fn is not None and js.source_fn is not None
    sol = tg.make_z4_grmhd_solver(2, 2, (2, 2), dx=0.5, device="cpu", **GAUGE)
    Q = state_to_numpy(tg.magnetized_wave_state(sol))
    Q = Q + 1e-4 * np.random.default_rng(3).standard_normal(Q.shape)
    flux = jax.make_jaxpr(lambda q: js.flux_fn(q, 0, js.var_axis))(jnp.asarray(Q))
    assert any(np.shape(c) == (3,) for c in flux.consts)  # what a kernel may not capture
    monkeypatch.setattr(jg, "jnp", _ScalarVectors())
    flux = jax.make_jaxpr(lambda q: js.flux_fn(q, 0, js.var_axis))(jnp.asarray(Q))
    assert not any(np.shape(c) == (3,) for c in flux.consts)
    pallas = PallasADERDG(js, interpret=True)
    ref = np.asarray(pallas.step(jnp.asarray(Q), 1e-3))
    cu = z4_grmhd_solver_from_jax(pallas, device="cpu", **GAUGE)
    assert isinstance(cu, CudaADERDG) and cu.per_axis and cu.solver.picard_iters == 1
    assert cu.kernels[0] == "aderdg_predictor_volume_per_axis_2d_z4_grmhd"
    got = state_to_numpy(cu.step(state_from_numpy(Q, device="cpu"), 1e-3))
    assert np.isfinite(got).all() and np.abs(got - Q).max() > 1e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * max(1.0, np.abs(ref).max()))
