"""The 2-D heterogeneous elasticity (K2 b.1's 8-variable system) in the
port against the JAX package, on the CPU.

- ``elastic_het_flux`` and ``elastic_free_surface_het`` against JAX's at
  several shapes and var axes, bit for bit (signed zeros included: the
  inputs carry ±0.0), and ``elastic_het_eigenvalue`` within one rounding
  (torch's CPU square root is not correctly rounded on long arrays).
- The twin of ``tests/test_ck.py:139``: with constant materials the CK step
  equals the homogeneous one on the wave rows, and the materials stay
  frozen; in the port and against JAX.
- One CK step (materials constant per cell) against JAX's XLA step,
  periodic and with the free surface on both axes, crossed with
  ``aderdg_from_jax(..., physics="elastic_het", walls=
  "elastic_free_surface_het")``; the material rows bitwise unchanged.
- ``CudaADERDG`` admits the system, periodic and walled, and takes the
  plain path on the CPU; its other orders raise naming ROADMAP Queue 2 K2 b.

f64 at atol = 1e-12·max(1, max|ref|), rtol = 0.  The kernels are held
against these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
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
from exahype_tpu_torch.models.aderdg import ADERDGSolver
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError

torch.set_num_threads(1)

CK = dict(predictor_mode="ck", ck_material_slots=(5, 6, 7),
          dissipation_mask=(1, 1, 1, 1, 1, 0, 0, 0))


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view(np.int64 if x.dtype == np.float64 else np.int32)


def _close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    tol = 1e-12 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol, err_msg=err_msg)


def _signed_het(shape, va, seed):
    """Seeded wave rows with some ±0.0 entries, and positive materials."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape)
    pick = rng.random(shape)
    q[pick < 0.1] = 0.0
    q[pick > 0.9] = -0.0
    mats = np.moveaxis(q, va, 0)[5:]
    mats[:] = 0.5 + 2.0 * rng.random(mats.shape)
    return q


@pytest.mark.parametrize("shape,va", [((7, 8), 1), ((3, 4, 8), 2), ((8, 4, 6), 0),
                                      ((4, 4, 8, 3, 2), 2)])
def test_flux_eigenvalue_and_free_surface_match_jax_bitwise(shape, va):
    q = _signed_het(shape, va, seed=len(shape) + va)
    q_last = np.moveaxis(q, va, -1)
    for d in (0, 1):
        ref = np.asarray(jel.elastic_het_flux(jnp.asarray(q_last), d))
        got = elastic.elastic_het_flux(torch.from_numpy(q), d, va).numpy()
        np.testing.assert_array_equal(_bits(np.moveaxis(got, va, -1)), _bits(ref))
        ref = np.asarray(jel.elastic_het_eigenvalue(jnp.asarray(q_last), d))
        got = elastic.elastic_het_eigenvalue(torch.from_numpy(q), d, va).numpy()
        # torch.sqrt on the CPU rounds ~1 % of a long array's values one
        # spacing off (XLA's and NumPy's are correctly rounded): one rounding.
        np.testing.assert_allclose(got, ref, rtol=np.finfo(np.float64).eps, atol=0)
    flux, eig = elastic.elastic_heterogeneous()
    assert flux.physics == eig.physics == elastic.PhysicsTag("elastic_het", 2, 8)
    for fj, ft in zip(jel.elastic_free_surface_het(), elastic.elastic_free_surface_het()):
        assert ft.signs.shape == (2, 8)
        for d in (0, 1):
            np.testing.assert_array_equal(_bits(ft(torch.from_numpy(q), d, va).numpy()),
                                          _bits(np.asarray(fj(jnp.asarray(q), d, va))))


def _coords(solver):
    va = solver.var_axis
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    return [np.broadcast_to(np.squeeze(c, va), no_var) for c in solver.nodes_meshgrid()]


def test_constant_materials_match_the_homogeneous_system():
    """``tests/test_ck.py:139``'s property: ρ, λ, μ = 1.2, 2.1, 0.9 in every
    cell, a plane P wave, 5 CK steps of 1e-3 at 4 cells: the wave rows equal
    the homogeneous solver's to 1e-13 (port and JAX alike, and the two
    packages to 1e-12), the material rows bitwise unchanged."""
    rho, lam, mu = 1.2, 2.1, 0.9
    het = ADERDGSolver(2, 3, 8, (4, 4), *elastic.elastic_heterogeneous(), dx=0.25,
                       device="cpu", **CK)
    hom = ADERDGSolver(2, 3, 5, (4, 4), *elastic.elastic(rho, lam, mu), dx=0.25,
                       predictor_mode="ck", device="cpu")
    X, Y = _coords(hom)
    wave = np.moveaxis(elastic.plane_p_wave(X, Y, 0.0, rho=rho, lam=lam, mu=mu), -1, 2)
    mats = np.stack([np.full(X.shape, v) for v in (rho, lam, mu)], axis=2)
    q_het = np.concatenate([wave, mats], axis=2)
    out_het = het.run(torch.from_numpy(q_het), 5, 1e-3).numpy()
    out_hom = hom.run(torch.from_numpy(wave), 5, 1e-3).numpy()
    np.testing.assert_allclose(out_het[:, :, :5], out_hom, rtol=0, atol=1e-13)
    np.testing.assert_array_equal(out_het[:, :, 5:], q_het[:, :, 5:])
    fh, eh = jel.elastic_heterogeneous()
    js = JaxSolver(dim=2, order=3, n_vars=8, grid_shape=(4, 4), flux_fn=wrap_var_last(fh),
                   max_eigenvalue_fn=wrap_var_last(eh), dx=0.25, **CK)
    _close(out_het, js.run(jnp.asarray(q_het), 5, 1e-3), "JAX het")


def jax_solver(cells, walls):
    fh, eh = jel.elastic_heterogeneous()
    hooks = {}
    if walls:
        reflect, reflect_flux = jel.elastic_free_surface_het()
        hooks = dict(boundary="reflective", reflect_fn=reflect, reflect_flux_fn=reflect_flux)
    return JaxSolver(dim=2, order=3, n_vars=8, grid_shape=cells, flux_fn=wrap_var_last(fh),
                     max_eigenvalue_fn=wrap_var_last(eh), dx=1.0 / cells[0], **CK, **hooks)


def port_solver(js, walls):
    return aderdg_from_jax(js, physics="elastic_het", device="cpu",
                           walls="elastic_free_surface_het" if walls else None)


def layered_state(js, seed):
    """Wave rows of ~1e-3 and materials constant in each cell, random
    across cells (ρ in [1, 2), λ in [1, 3), μ in [0.5, 1.5))."""
    rng = np.random.default_rng(seed)
    q = 1e-3 * rng.standard_normal(tuple(js.state_shape))
    cells = tuple(js.grid_shape)
    for k, (lo, span) in enumerate(((1.0, 1.0), (1.0, 2.0), (0.5, 1.0))):
        q[:, :, 5 + k] = lo + span * rng.random(cells)
    return q


@pytest.mark.parametrize("walls", [False, True], ids=["periodic", "free_surface"])
@pytest.mark.parametrize("cells", [(5, 5), (4, 6)])
def test_ck_step_matches_xla(walls, cells):
    js = jax_solver(cells, walls)
    ts = port_solver(js, walls)
    assert ts.flux_fn.physics.name == "elastic_het"
    q = layered_state(js, seed=cells[1] + walls)
    dt = 0.5 * float(js.cfl_dt(jnp.asarray(q)))
    assert float(ts.cfl_dt(torch.from_numpy(q))) == pytest.approx(2 * dt, rel=1e-15)
    got = ts.run(torch.from_numpy(q), 2, dt).numpy()
    _close(got, js.run(jnp.asarray(q), 2, dt), "XLA, 2 steps")
    np.testing.assert_array_equal(_bits(got[:, :, 5:]), _bits(q[:, :, 5:]))


@pytest.mark.parametrize("walls", [False, True], ids=["periodic", "free_surface"])
def test_cuda_wrapper_admits_the_system_and_runs_plain_on_cpu(walls):
    js = jax_solver((5, 5), walls)
    ts = port_solver(js, walls)
    cu = CudaADERDG(ts)
    suffix = "_walls_2d" if walls else "_2d"
    assert cu.kernels == ("aderdg_ck_predictor_volume_2d", f"aderdg_face_flux{suffix}",
                          f"aderdg_surface_update{suffix}")
    assert cu._physics_id == 9 and cu._flux_rows == 5
    q = torch.from_numpy(layered_state(js, seed=3))
    dt = 0.5 * float(ts.cfl_dt(q))
    assert torch.equal(cu.step(q, dt), ts.step(q, dt))
    assert all(n == 0 for n in cu.launches.values())


@pytest.mark.parametrize(
    "build,match",
    [
        (lambda: ADERDGSolver(2, 2, 8, (4, 4), *elastic.elastic_heterogeneous(), device="cpu",
                              **CK), "Queue 2 K2 b"),
        (lambda: ADERDGSolver(2, 3, 8, (4, 4), *elastic.elastic_heterogeneous(), device="cpu",
                              **{**CK, "dissipation_mask": None}), "dissipation_mask"),
        (lambda: ADERDGSolver(2, 3, 8, (4, 4), *elastic.elastic_heterogeneous(), device="cpu",
                              dissipation_mask=CK["dissipation_mask"]), "predictor_mode='ck'"),
    ],
    ids=["order2", "no_mask", "picard"],
)
def test_cuda_wrapper_refusals_name_their_item(build, match):
    with pytest.raises(LoweringError, match=match):
        CudaADERDG(build())


def test_convert_checks_the_system():
    """``physics="elastic_het"`` takes no constants, needs the 8-variable
    2-D system, and is probed against the JAX pair: a JAX 8-variable solver
    of another flux raises."""
    js = jax_solver((3, 3), walls=False)
    with pytest.raises(SemanticError, match="gamma applies"):
        aderdg_from_jax(js, physics="elastic_het", gamma=1.4, device="cpu")
    homogeneous = JaxSolver(dim=2, order=3, n_vars=5, grid_shape=(3, 3),
                            flux_fn=wrap_var_last(jel.elastic()[0]),
                            max_eigenvalue_fn=wrap_var_last(jel.elastic()[1]))
    with pytest.raises(SemanticError, match="2-D system of 8"):
        aderdg_from_jax(homogeneous, physics="elastic_het", device="cpu")
    fh, eh = jel.elastic_heterogeneous()
    other = JaxSolver(dim=2, order=3, n_vars=8, grid_shape=(3, 3),
                      flux_fn=wrap_var_last(lambda q, n: 2.0 * fh(q, n)),
                      max_eigenvalue_fn=wrap_var_last(eh), dx=1.0 / 3, **CK)
    with pytest.raises(SemanticError, match="does not reproduce the JAX solver's flux_fn"):
        aderdg_from_jax(other, physics="elastic_het", device="cpu")
