"""K2 b.1's 3-D instance: the 12-variable heterogeneous elasticity at order
2 on the CK node kernel, on the CPU.

The twin of ``tests/test_ck.py:317`` (``test_ck_fused_pallas_materials_
parity``): a JAX ``PallasADERDG(interpret=True)`` over the order-2
heterogeneous CK solver crosses with ``aderdg_from_jax(...,
physics="elastic3d_het")`` to a ``CudaADERDG`` on ``device="cpu"``, which
runs its plain version there; its step matches the Pallas interpret step
and JAX's XLA step at 1e-12 of max(1, max|ref|) in float64, with the
material slots bitwise frozen.  The kernels of the ``_p2`` entries are held
against the same plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import elastic as jel
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import wrap_var_last
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu_torch.convert import aderdg_from_jax
from exahype_tpu_torch.models import elastic
from exahype_tpu_torch.models.aderdg import ADERDGSolver
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.utils.errors import LoweringError

torch.set_num_threads(1)

CK = dict(predictor_mode="ck", ck_material_slots=(9, 10, 11),
          dissipation_mask=(1,) * 9 + (0, 0, 0))


def jax_solver(cells=4):
    flux, eig = jel.elastic3d_heterogeneous()
    return JaxSolver(dim=3, order=2, n_vars=12, grid_shape=(cells,) * 3,
                     flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
                     dx=1.0 / cells, **CK)


def layered_state(js):
    """``tests/test_ck.py:335-352``: the plane P wave in slots 0-8 and two
    layers of materials split at z = 0.5."""
    va = js.var_axis
    no_var = tuple(s for e, s in enumerate(js.state_shape) if e != va)
    coords = [np.broadcast_to(np.squeeze(np.asarray(c), va), no_var)
              for c in js.nodes_meshgrid()]
    X, Z = coords[0], coords[2]
    wave = np.moveaxis(jel.plane_p_wave_3d(X, 0.0), -1, va)
    mats = np.stack([np.where(Z < 0.5, 1.0, 1.5), np.where(Z < 0.5, 2.0, 4.0),
                     np.where(Z < 0.5, 1.0, 2.0)], axis=va)
    return np.concatenate([wave, mats], axis=va)


def test_pallas_materials_parity_crosses_to_the_node_kernel_wrapper():
    js = jax_solver()
    fused = PallasADERDG(js, interpret=True)
    cu = aderdg_from_jax(fused, physics="elastic3d_het", device="cpu")
    assert isinstance(cu, CudaADERDG)
    assert cu.kernels == ("aderdg_ck_predictor_volume_p2", "aderdg_face_flux_p2",
                          "aderdg_surface_update_p2")
    assert cu._physics_id == 1 and cu._flux_rows == 9
    u = layered_state(js)
    dt = 1e-3
    got = cu.step(torch.from_numpy(u), dt).numpy()
    ref = np.asarray(fused.step(jnp.asarray(u), dt))
    tol = 1e-12 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    np.testing.assert_allclose(got, np.asarray(js.step(jnp.asarray(u), dt)), rtol=0, atol=tol)
    np.testing.assert_array_equal(got[:, :, :, 9:], u[:, :, :, 9:])
    assert all(n == 0 for n in cu.launches.values())  # the plain path on the CPU


def test_two_steps_and_faces_match_xla():
    """Two steps at a ragged grid (3 cells an axis), and the predictor's
    face projections of the material rows: u's materials, zero fluxes."""
    js = jax_solver(3)
    ts = aderdg_from_jax(js, physics="elastic3d_het", device="cpu")
    u = layered_state(js)
    u[:, :, :, :9] += 1e-3 * np.random.default_rng(2).standard_normal(u[:, :, :, :9].shape)
    dt = 0.5 * float(js.cfl_dt(jnp.asarray(u), cfl=0.15))
    got = ts.run(torch.from_numpy(u), 2, dt).numpy()
    ref = np.asarray(js.run(jnp.asarray(u), 2, dt))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * max(1.0, np.abs(ref).max()))
    np.testing.assert_array_equal(got[:, :, :, 9:], u[:, :, :, 9:])
    _, faces, _ = CudaADERDG(ts).predictor_volume(torch.from_numpy(u), dt)
    assert torch.equal(faces[:, 2:, :, 9:], torch.zeros_like(faces[:, 2:, :, 9:]))


@pytest.mark.parametrize(
    "order,walls,match",
    [(1, False, "Queue 2 K2 b"), (4, False, "Queue 2 K2 b"), (2, True, "Queue 2 K2 b")],
    ids=["order1", "order4", "order2_walls"],
)
def test_other_orders_and_walls_raise_naming_k2b(order, walls, match):
    hooks = {}
    if walls:
        reflect, reflect_flux = elastic.elastic3d_free_surface_het()
        hooks = dict(boundary="reflective", wall_axes=(2,), reflect_fn=reflect,
                     reflect_flux_fn=reflect_flux)
    sol = ADERDGSolver(3, order, 12, (2, 2, 2), *elastic.elastic3d_heterogeneous(),
                       device="cpu", **CK, **hooks)
    with pytest.raises(LoweringError, match=match):
        CudaADERDG(sol)
