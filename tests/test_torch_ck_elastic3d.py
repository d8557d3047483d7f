"""The 3-D homogeneous elasticity (K2 b's 3-D system: ``elastic3d``, 9
variables) in the port against the JAX package, on the CPU.

- The port's ``elastic3d_flux``, ``elastic3d_eigenvalue``,
  ``elastic3d_free_surface``, ``plane_p_wave_3d`` and ``plane_s_wave_3d``
  against JAX's at several shapes and var axes, bit for bit (the inputs
  carry ±0.0; the flux's rows that do not involve the normal are
  −(0·v_x), whose sign follows v_x).
- The CK predictor's q̄/F̄ and one step at order 2 on ``(4, 4, 4)`` and on a
  non-cubic grid against JAX's XLA step, and one step against
  ``PallasADERDG(interpret=True)`` in ``tests/test_ck.py::
  test_ck_fused_pallas_parity``'s configuration (the plane P wave on 4³
  cells, dt = 1e-3); the solver crosses with ``aderdg_from_jax(...,
  physics="elastic3d", rho=, lam=, mu=)``.
- ``CudaADERDG`` admits the system at order 2, periodic, and takes the
  plain path on the CPU; what it refuses names its ROADMAP item.

f64 at atol = 1e-12·max(1, max|ref|), rtol = 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import elastic as jel
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import wrap_var_last
from exahype_tpu_torch.convert import aderdg_from_jax
from exahype_tpu_torch.models import elastic
from exahype_tpu_torch.models.aderdg import ADERDGSolver, PhysicsTag
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.utils.errors import LoweringError

torch.set_num_threads(1)

MAT = dict(rho=1.0, lam=2.0, mu=1.0)
ODD = dict(rho=1.3, lam=2.5, mu=0.7)


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view(np.int64 if x.dtype == np.float64 else np.int32)


def _signed(shape, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape)
    pick = rng.random(shape)
    q[pick < 0.1] = 0.0
    q[pick > 0.9] = -0.0
    return q


def _close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    tol = 1e-12 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol, err_msg=err_msg)


@pytest.mark.parametrize("shape,va", [((6, 9), 1), ((3, 3, 9, 4), 2), ((9, 5, 2), 0),
                                      ((3, 3, 3, 9, 2, 2, 2), 3)])
@pytest.mark.parametrize("mat", [MAT, ODD], ids=["unit", "odd"])
def test_flux_and_eigenvalue_match_jax_bitwise(shape, va, mat):
    q = _signed(shape, seed=len(shape) + va)
    q_last = np.moveaxis(q, va, -1)
    for d in range(3):
        ref = np.asarray(jel.elastic3d_flux(jnp.asarray(q_last), d, **mat))
        got = elastic.elastic3d_flux(torch.from_numpy(q), d, va, **mat).numpy()
        np.testing.assert_array_equal(_bits(np.moveaxis(got, va, -1)), _bits(ref))
        ref = np.asarray(jel.elastic3d_eigenvalue(jnp.asarray(q_last), d, **mat))
        got = elastic.elastic3d_eigenvalue(torch.from_numpy(q), d, va, **mat).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    flux, eig = elastic.elastic3d(**mat)
    assert flux.physics == eig.physics == PhysicsTag(
        "elastic3d", 3, 9, (mat["rho"], mat["lam"], mat["mu"]))


def test_flux_float32_matches_jax_bitwise():
    q = _signed((5, 9), seed=7).astype(np.float32)
    for d in range(3):
        ref = np.asarray(jel.elastic3d_flux(jnp.asarray(q), d, **ODD))
        got = elastic.elastic3d_flux(torch.from_numpy(q), d, 1, **ODD).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_free_surface_and_plane_waves_match_jax_bitwise():
    q = _signed((3, 3, 3, 9, 2, 2, 2), seed=11)
    for fj, ft in zip(jel.elastic3d_free_surface(), elastic.elastic3d_free_surface()):
        for d in range(3):
            np.testing.assert_array_equal(_bits(ft(torch.from_numpy(q), d, 3).numpy()),
                                          _bits(np.asarray(fj(jnp.asarray(q), d, 3))))
    x = np.linspace(0.0, 1.0, 11)
    for t in (0.0, 0.21):
        np.testing.assert_array_equal(elastic.plane_s_wave_3d(x, t, **ODD),
                                      jel.plane_s_wave_3d(x, t, **ODD))
        np.testing.assert_array_equal(elastic.plane_p_wave_3d(x, t, **ODD),
                                      jel.plane_p_wave_3d(x, t, **ODD))


def jax_solver(grid, order=2, mat=MAT):
    flux, eig = jel.elastic3d(**mat)
    return JaxSolver(dim=3, order=order, n_vars=9, grid_shape=grid,
                     flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
                     dx=1.0 / grid[0], predictor_mode="ck")


GRIDS = [(4, 4, 4), (4, 2, 6)]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("mat", [MAT, ODD], ids=["unit", "odd"])
def test_ck_predictor_and_step_match_xla(grid, mat):
    js = jax_solver(grid, mat=mat)
    ts = aderdg_from_jax(js, physics="elastic3d", device="cpu", **mat)
    assert ts.flux_fn.physics.name == "elastic3d" and ts.predictor_mode == "ck"
    q = 1e-3 * np.random.default_rng(grid[2]).standard_normal(tuple(js.state_shape))
    dt = 0.5 * float(js.cfl_dt(jnp.asarray(q)))
    qbar_j, fbar_j = js.predictor(jnp.asarray(q), dt)
    qbar_t, fbar_t = ts.predictor(torch.from_numpy(q), dt)
    _close(qbar_t.numpy(), qbar_j, "qbar")
    for d in range(3):
        _close(fbar_t[d].numpy(), fbar_j[d], f"fbar {d}")
    _close(ts.step(torch.from_numpy(q), dt).numpy(), js.step(jnp.asarray(q), dt), "step")


def test_ck_step_matches_pallas_interpret():
    """``tests/test_ck.py::test_ck_fused_pallas_parity``'s configuration."""
    from exahype_tpu.models.aderdg_pallas import PallasADERDG

    js = jax_solver((4, 4, 4))
    coords = js.nodes_meshgrid()
    no_var = tuple(s for e, s in enumerate(js.state_shape) if e != js.var_axis)
    X = np.broadcast_to(np.squeeze(np.asarray(coords[0]), js.var_axis), no_var)
    q = np.moveaxis(jel.plane_p_wave_3d(X, 0.0), -1, js.var_axis)
    fused = PallasADERDG(js, interpret=True)
    cu = aderdg_from_jax(fused, physics="elastic3d", device="cpu", **MAT)
    assert isinstance(cu, CudaADERDG)
    assert cu.kernels == ("aderdg_ck_predictor_volume_p2", "aderdg_face_flux_p2",
                          "aderdg_surface_update_p2")
    got = cu.step(torch.from_numpy(q), 1e-3).numpy()
    _close(got, fused.step(jnp.asarray(q), 1e-3), "Pallas interpret")
    _close(got, js.step(jnp.asarray(q), 1e-3), "XLA")
    assert all(n == 0 for n in cu.launches.values())  # the CPU takes the plain path


def test_cuda_wrapper_runs_plain_on_cpu():
    flux, eig = elastic.elastic3d(**ODD)
    sol = ADERDGSolver(3, 2, 9, (3, 2, 4), flux, eig, dx=0.25, predictor_mode="ck",
                       device="cpu")
    cu = CudaADERDG(sol)
    assert list(cu._params) == [ODD["rho"], ODD["lam"], ODD["mu"]]
    assert cu._flux_rows == 9 and cu.walls is None
    q = torch.from_numpy(1e-3 * np.random.default_rng(5).standard_normal(sol.state_shape))
    assert torch.equal(cu.run(q, 2, 1e-3), sol.run(q, 2, 1e-3))
    assert cu.dofs() == sol.dofs()


def _walled(order=2):
    reflect, reflect_flux = elastic.elastic3d_free_surface()
    return ADERDGSolver(3, order, 9, (2, 2, 2), *elastic.elastic3d(), device="cpu",
                        predictor_mode="ck", boundary="reflective", wall_axes=(2,),
                        reflect_fn=reflect, reflect_flux_fn=reflect_flux)


def _sponged():
    sol = ADERDGSolver(3, 2, 9, (2, 2, 2), *elastic.elastic3d(), device="cpu",
                       predictor_mode="ck")
    sol.source_fn = elastic.sponge_source(sol, width=0.2, rate=10.0)
    return sol


@pytest.mark.parametrize(
    "build,match",
    [
        (lambda: ADERDGSolver(3, 3, 9, (2, 2, 2), *elastic.elastic3d(), device="cpu",
                              predictor_mode="ck"), "Queue 2 K2 b"),
        (lambda: ADERDGSolver(3, 5, 9, (2, 2, 2), *elastic.elastic3d(), device="cpu",
                              predictor_mode="ck"), "Queue 2 K2 b"),
        (_walled, "Queue 2 K2 b"),
        (_sponged, "K2 a"),
        (lambda: ADERDGSolver(3, 2, 9, (2, 2, 2), *elastic.elastic3d(), device="cpu"),
         "predictor_mode='ck'"),
        (lambda: ADERDGSolver(3, 2, 9, (2, 2, 2), *elastic.elastic3d(), device="cpu",
                              predictor_mode="ck", dissipation_mask=(1,) * 8 + (0,)),
         "dissipation_mask"),
    ],
    ids=["order3", "order5", "walls", "sponge", "picard", "mask"],
)
def test_cuda_wrapper_refusals(build, match):
    with pytest.raises(LoweringError, match=match):
        CudaADERDG(build())
