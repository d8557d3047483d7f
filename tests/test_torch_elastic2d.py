"""The 2-D homogeneous elasticity (K2 b's 2-D system) in the port against
the JAX package, on the CPU: ``examples/seismic_point_source.py --ck``.

- The port's ``elastic_flux``, ``elastic_eigenvalue``, ``plane_p_wave`` and
  ``elastic_free_surface`` against JAX's at several shapes and var axes,
  bit for bit (signed zeros included: the inputs carry ±0.0).
- One CK step, periodic and with the example's free surface on both axes,
  against JAX's XLA step and against ``PallasADERDG(interpret=True)``.
- The whole example at its CPU grid (9 cells, 110 steps of the Strang-split
  ``PointSources.step``, the receivers sampled after each), built as the
  example builds it and carried across with ``aderdg_from_jax`` and
  ``point_sources_from_jax``: the state and the seismogram side by side.
- The two faults of the example itself (the reference's, not the port's),
  pinned in both packages: on an even grid its source at x = 0.5 sits on a
  cell face and the mirror gate breaks (16 cells to t ≈ 0.2: 8.5e-3 of the
  field's maximum, against ~1e-15 on 17 cells), and at its chip grid
  (128, 128) its 400 steps end at t ≈ 0.067, before the P arrival time
  t_expect ≈ 0.156 that its second gate needs.
- ``CudaADERDG`` admits the system, periodic and walled, and takes the
  plain path on the CPU.

f64 at atol = 1e-12·max(1, max|ref|), rtol = 0.  The kernels themselves are
held against these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import elastic as jel
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import wrap_var_last
from exahype_tpu.models.point_source import PointSources as JaxPointSources
from exahype_tpu.models.point_source import ricker as jax_ricker
from exahype_tpu.models.tracers import TracerAdvector as JaxTracers
from exahype_tpu_torch.convert import aderdg_from_jax, point_sources_from_jax
from exahype_tpu_torch.models import elastic
from exahype_tpu_torch.models.aderdg import ADERDGSolver
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.tracers import TracerAdvector
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError

torch.set_num_threads(1)

MAT = dict(rho=1.0, lam=2.0, mu=1.0)  # the example's medium
ODD = dict(rho=1.3, lam=2.5, mu=0.7)  # constants whose products round
F0 = 8.0


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view(np.int64 if x.dtype == np.float64 else np.int32)


def _signed(shape, seed):
    """Seeded normal values with some entries set to +0.0 and -0.0."""
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


@pytest.mark.parametrize("shape,va", [((7, 5), 1), ((3, 4, 5), 2), ((5, 4, 6), 0),
                                      ((4, 4, 5, 3, 2), 2)])
@pytest.mark.parametrize("mat", [MAT, ODD], ids=["example", "odd"])
def test_flux_and_eigenvalue_match_jax_bitwise(shape, va, mat):
    q = _signed(shape, seed=len(shape) + va)
    q_last = np.moveaxis(q, va, -1)
    for d in (0, 1):
        ref = np.asarray(jel.elastic_flux(jnp.asarray(q_last), d, **mat))
        got = elastic.elastic_flux(torch.from_numpy(q), d, va, **mat).numpy()
        np.testing.assert_array_equal(_bits(np.moveaxis(got, va, -1)), _bits(ref))
        ref = np.asarray(jel.elastic_eigenvalue(jnp.asarray(q_last), d, **mat))
        got = elastic.elastic_eigenvalue(torch.from_numpy(q), d, va, **mat).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    flux, eig = elastic.elastic(**mat)
    assert flux.physics == eig.physics == elastic.PhysicsTag(
        "elastic", 2, 5, (mat["rho"], mat["lam"], mat["mu"]))
    np.testing.assert_array_equal(
        _bits(flux(torch.from_numpy(q), 1, va).numpy()),
        _bits(elastic.elastic_flux(torch.from_numpy(q), 1, va, **mat).numpy()))


@pytest.mark.parametrize("va", [0, 2])
def test_free_surface_and_plane_wave_match_jax_bitwise(va):
    q = _signed((4, 3, 5, 6) if va == 2 else (5, 4, 3, 6), seed=va)
    reflect_j, reflect_flux_j = jel.elastic_free_surface()
    reflect_t, reflect_flux_t = elastic.elastic_free_surface()
    for fj, ft in ((reflect_j, reflect_t), (reflect_flux_j, reflect_flux_t)):
        for d in (0, 1):
            ref = np.asarray(fj(jnp.asarray(q), d, va))
            np.testing.assert_array_equal(_bits(ft(torch.from_numpy(q), d, va).numpy()),
                                          _bits(ref))
    assert reflect_t.signs.shape == (2, 5)
    x, y = np.meshgrid(np.linspace(0, 1, 7), np.linspace(0, 1, 5), indexing="ij")
    for t in (0.0, 0.37):
        np.testing.assert_array_equal(elastic.plane_p_wave(x, y, t, **ODD),
                                      jel.plane_p_wave(x, y, t, **ODD))


def jax_solver(cells, walls, predictor_mode="ck", mat=MAT):
    flux, eig = jel.elastic(**mat)
    hooks = {}
    if walls:
        reflect, reflect_flux = jel.elastic_free_surface()
        hooks = dict(boundary="reflective", reflect_fn=reflect, reflect_flux_fn=reflect_flux)
    return JaxSolver(dim=2, order=3, n_vars=5, grid_shape=cells, flux_fn=wrap_var_last(flux),
                     max_eigenvalue_fn=wrap_var_last(eig), dx=1.0 / cells[0],
                     predictor_mode=predictor_mode, **hooks)


def port_solver(js, walls):
    return aderdg_from_jax(js, physics="elastic", walls="elastic_free_surface" if walls else None,
                           device="cpu", **MAT)


def random_state(js, seed):
    """A wave of ~1e-3 in every row (seeded normal values)."""
    return 1e-3 * np.random.default_rng(seed).standard_normal(tuple(js.state_shape))


@pytest.mark.parametrize("walls", [False, True], ids=["periodic", "free_surface"])
@pytest.mark.parametrize("cells", [(5, 5), (4, 6)])
def test_ck_step_matches_xla_and_pallas_interpret(walls, cells):
    from exahype_tpu.models.aderdg_pallas import PallasADERDG

    js = jax_solver(cells, walls)
    ts = port_solver(js, walls)
    q = random_state(js, seed=cells[1] + walls)
    dt = 0.5 * float(js.cfl_dt(jnp.asarray(q)))
    qbar_j, fbar_j = js.predictor(jnp.asarray(q), dt)
    qbar_t, fbar_t = ts.predictor(torch.from_numpy(q), dt)
    _close(qbar_t.numpy(), qbar_j, "qbar")
    for d in range(2):
        _close(fbar_t[d].numpy(), fbar_j[d], f"fbar {d}")
    got = ts.step(torch.from_numpy(q), dt).numpy()
    _close(got, js.step(jnp.asarray(q), dt), "XLA step")
    _close(got, PallasADERDG(js, interpret=True).step(jnp.asarray(q), dt), "Pallas interpret")
    assert float(ts.cfl_dt(torch.from_numpy(q))) == pytest.approx(2 * dt, rel=1e-15)


# ------------------------------------------------------- the example itself


def jax_example(cells):
    """``examples/seismic_point_source.py --ck``'s configuration (:36-66) at
    ``cells``: the JAX solver, the Ricker point force at (0.5, 0.5), the
    receivers (NumPy), the probe and the example's dt."""
    js = jax_solver((cells, cells), walls=True)
    amp = np.zeros((1, 5))
    amp[0, 1] = 1.0
    src = JaxPointSources(js, [[0.5, 0.5]], amp, wavelet=jax_ricker(F0))
    rx = np.asarray([0.3, 0.4, 0.6, 0.7])
    receivers = np.stack([rx, np.full_like(rx, 0.3)], -1)
    probe = JaxTracers(js, lambda v: v[:, :2])
    dt = float(js.cfl_dt(jnp.ones(js.state_shape)))
    return js, src, receivers, probe, dt


def jax_run(js, src, receivers, probe, dt, n):
    """The example's jitted scan of ``n`` forced steps from rest; the
    state, the time and the seismogram ``[n, 4, 2]``."""
    rec = jnp.asarray(receivers)

    def chunk(u, t):
        def body(carry, _):
            uu, tt = carry
            uu = src.step(uu, tt, dt)
            return (uu, tt + dt), probe.sample(uu, rec)

        return jax.lax.scan(body, (u, t), None, length=n)

    (u, t), seis = jax.jit(chunk)(jnp.zeros(js.state_shape), jnp.asarray(0.0, jnp.float64))
    return np.asarray(u), float(t), np.asarray(seis)


def port_run(ts, src, receivers, dt, n):
    probe = TracerAdvector(ts, lambda v: v[:, :2])
    rec = torch.from_numpy(receivers)
    u = torch.zeros(ts.state_shape, dtype=torch.float64)
    t = torch.tensor(0.0, dtype=torch.float64)
    seis = []
    for _ in range(n):
        u = src.step(u, t, dt)
        t = t + dt
        seis.append(probe.sample(u, rec))
    return u.numpy(), float(t), torch.stack(seis).numpy()


def mirror(seis):
    """The example's mirror gate (:79-86): |v_y(0.4) − v_y(0.6)| and
    |v_x(0.4) + v_x(0.6)| over the run, as fractions of the field's max."""
    scale = max(np.abs(seis).max(), 1e-30)
    return (np.abs(seis[:, 1, 1] - seis[:, 2, 1]).max() / scale,
            np.abs(seis[:, 1, 0] + seis[:, 2, 0]).max() / scale)


def t_expect(cp=2.0):
    return float(np.hypot(0.1, 0.2)) / cp + 0.35 / F0


def arrival(seis, dt):
    v_mag = np.abs(seis[:, 1, :]).max(axis=-1)
    return (int(np.argmax(v_mag > 0.01 * v_mag.max())) + 1) * dt


def both(cells, n):
    js, jsrc, receivers, jprobe, dt = jax_example(cells)
    ts = port_solver(js, walls=True)
    tsrc = point_sources_from_jax(jsrc, ts, f0=F0)
    return (jax_run(js, jsrc, receivers, jprobe, dt, n), port_run(ts, tsrc, receivers, dt, n),
            dt)


def test_example_cpu_run_matches_jax():
    """The example's CPU run (9 cells, 110 steps) side by side, and its
    gates in the port."""
    (u_j, t_j, seis_j), (u_t, t_t, seis_t), dt = both(9, 110)
    _close(u_t, u_j, "state")
    _close(seis_t, seis_j, "seismogram")
    assert t_t == pytest.approx(t_j, rel=1e-14)
    assert np.abs(seis_j).max() > 1e-2  # the P wave has reached the receivers
    assert max(mirror(seis_t)) < 1e-5
    assert t_t > t_expect()
    assert abs(arrival(seis_t, dt) - t_expect()) < 0.5 * t_expect()


@pytest.mark.parametrize("cells,steps,lo,hi,vx_hi",
                         [(16, 150, 8.4e-3, 8.6e-3, 4e-3), (17, 160, 0.0, 1e-13, 1e-13)],
                         ids=["even", "odd"])
def test_example_mirror_gate_needs_an_odd_grid(cells, steps, lo, hi, vx_hi):
    """Reference caveat: with an even number of cells the source at x = 0.5
    sits on a cell face and the radiated field is not mirror-symmetric at
    the receivers, in JAX as in the port (16 cells to t ≈ 0.2: v_y's
    asymmetry is 8.5e-3 of the field's maximum, the example's gate is
    1e-5); on an odd grid it is rounding."""
    (_, t_j, seis_j), (_, t_t, seis_t), _ = both(cells, steps)
    assert t_j > 0.2
    _close(seis_t, seis_j, "seismogram")
    for seis in (seis_j, seis_t):
        vy, vx = mirror(seis)
        assert lo <= vy <= hi, vy
        assert vx <= vx_hi, vx


def test_example_chip_grid_ends_before_the_p_arrival():
    """Reference caveat: at the example's chip grid (128, 128) its dt
    (cfl_dt on a state of ones, 1.674e-4) times its 400 steps is t ≈ 0.067,
    before t_expect ≈ 0.156, so its P-arrival gate never runs there; the
    port's cfl_dt is the reference's."""
    js = jax_solver((128, 128), walls=True)
    ts = port_solver(js, walls=True)
    dt_j = float(js.cfl_dt(jnp.ones(js.state_shape)))
    dt_t = float(ts.cfl_dt(torch.ones(ts.state_shape, dtype=torch.float64)))
    assert dt_t == pytest.approx(dt_j, rel=1e-15)
    assert dt_j == pytest.approx(0.3 / 128 / 14, rel=1e-12)  # cfl · dx / (c_p (2N + 1))
    assert 400 * dt_j == pytest.approx(0.067, abs=1e-3) and 400 * dt_j < t_expect()
    assert t_expect() == pytest.approx(0.156, abs=1e-3)
    assert 1200 * (0.3 / 129 / 14) > t_expect()  # the card's odd grid, 1,200 steps


# ------------------------------------------------------- the CUDA wrapper


@pytest.mark.parametrize("walls", [False, True], ids=["periodic", "free_surface"])
def test_cuda_wrapper_admits_the_system_and_runs_plain_on_cpu(walls):
    js = jax_solver((5, 5), walls)
    ts = port_solver(js, walls)
    cu = CudaADERDG(ts)
    suffix = "_walls_2d" if walls else "_2d"
    assert cu.kernels == ("aderdg_ck_predictor_volume_2d", f"aderdg_face_flux{suffix}",
                          f"aderdg_surface_update{suffix}")
    assert list(cu._params) == [1.0, 2.0, 1.0]
    if walls:
        np.testing.assert_array_equal(cu.walls["table"][:10],
                                      np.ravel(elastic.elastic_free_surface()[0].signs))
    q = torch.from_numpy(random_state(js, seed=3))
    dt = 0.5 * float(ts.cfl_dt(q))
    assert torch.equal(cu.step(q, dt), ts.step(q, dt))
    assert all(n == 0 for n in cu.launches.values())  # the CPU takes the plain path
    by_jax = aderdg_from_jax(_pallas(js), physics="elastic", device="cpu", **MAT,
                             walls="elastic_free_surface" if walls else None)
    assert isinstance(by_jax, CudaADERDG) and by_jax.kernels == cu.kernels


def _pallas(js):
    from exahype_tpu.models.aderdg_pallas import PallasADERDG

    return PallasADERDG(js, interpret=True)


@pytest.mark.parametrize(
    "build,error,match",
    [
        (lambda: ADERDGSolver(2, 2, 5, (4, 4), *elastic.elastic(), device="cpu",
                              predictor_mode="ck"), LoweringError, "Queue 2 K2 b"),
        (lambda: ADERDGSolver(2, 3, 5, (4, 4), *elastic.elastic(), device="cpu"),
         LoweringError, "predictor_mode='ck'"),
        (lambda: _with_source(ADERDGSolver(2, 3, 5, (4, 4), *elastic.elastic(), device="cpu",
                                           predictor_mode="ck")), LoweringError, "K2 a"),
        (lambda: _with_sponge(ADERDGSolver(2, 3, 5, (4, 4), *elastic.elastic(), device="cpu",
                                           predictor_mode="ck")), LoweringError, "K2 a"),
    ],
    ids=["order2", "picard", "source", "sponge"],
)
def test_cuda_wrapper_refusals_name_their_roadmap_item(build, error, match):
    with pytest.raises(error, match=match):
        CudaADERDG(build())


def _with_source(sol):
    sol.source_fn = lambda q, va: -q
    return sol


def _with_sponge(sol):
    sol.source_fn = elastic.sponge_source(sol, width=0.2, rate=10.0)
    return sol


def test_convert_takes_the_material_constants():
    """The constants the caller names are the JAX solver's: a JAX solver
    built with (1.5, 3.0, 0.5) crosses with them, and crossing it with the
    example's (1, 2, 1) raises (the probe of the two flux pairs)."""
    mat = dict(rho=1.5, lam=3.0, mu=0.5)
    js = jax_solver((3, 3), walls=False, mat=mat)
    ts = aderdg_from_jax(js, physics="elastic", device="cpu", **mat)
    assert ts.flux_fn.physics.params == (1.5, 3.0, 0.5)
    with pytest.raises(SemanticError, match="does not reproduce the JAX solver's flux_fn"):
        aderdg_from_jax(js, physics="elastic", device="cpu", **MAT)
    for kw, match in ((dict(rho=1.0, lam=2.0), "rho, lam and mu"),
                      (dict(rho=1.0, lam=2.0, mu=1.0, gamma=1.4), "no gamma"),
                      (dict(), "rho, lam and mu")):
        with pytest.raises(SemanticError, match=match):
            aderdg_from_jax(js, physics="elastic", device="cpu", **kw)
    with pytest.raises(SemanticError, match="3-D system of 9"):
        aderdg_from_jax(js, physics="elastic3d", device="cpu", **MAT)
    with pytest.raises(SemanticError, match="rho and lam apply"):
        aderdg_from_jax(js, physics="euler", gamma=1.4, rho=1.0, device="cpu")
