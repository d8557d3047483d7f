"""Curvilinear meshes in the port (``models/curvilinear.py``) against the JAX
package, on the CPU: the twins of ``tests/test_curvilinear.py`` (identity
reduction, free-stream convergence, deformed-mesh advection in both
predictor modes, densitized conservation, the elastic wave, the
orientation refusal, the curl-form identity and the Lobatto free stream,
2-D and 3-D) run on the port's solver; the metric slots, the lift and
``densitize``/``undensitize`` against JAX's on the same solver and mapping;
and ``examples/seismic_topography.py`` at its CPU grid (9, 9), 100 steps,
against JAX's XLA step, with the example's gates and the reference caveat
that its run ends before the P wave reaches a receiver.

The curvilinear Euler (``tests/test_curvilinear.py:375``, ROADMAP Queue 1
item 12) and the sharded step (``:415``, item 5) wait for their items.

f64 at atol = 1e-12·max(1, max|ref|), rtol = 0, unless a twin's own bound
is stated.  The CK kernels over the curvilinear lift are held against
these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import curvilinear as jc
from exahype_tpu.models import elastic as jel
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import wrap_var_last
from exahype_tpu.models.point_source import PointSources as JaxPointSources
from exahype_tpu.models.point_source import ricker as jax_ricker
from exahype_tpu.models.tracers import TracerAdvector as JaxTracers
from exahype_tpu_torch.convert import aderdg_from_jax, point_sources_from_jax
from exahype_tpu_torch.models import curvilinear as cv
from exahype_tpu_torch.models import elastic
from exahype_tpu_torch.models.aderdg import ADERDGSolver, PhysicsTag, _apply
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.tracers import TracerAdvector
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError

torch.set_num_threads(1)

A_DEF = 0.03  # the JAX tests' periodic deformation amplitude
TWO_PI = 2 * math.pi


def _close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    tol = 1e-12 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol, err_msg=err_msg)


def _mapping(sin):
    """The JAX tests' periodic-compatible deformation of the unit square,
    for ``sin`` = ``torch.sin`` (the port) or ``jnp.sin`` (JAX)."""
    def mp(p):
        return (p[0] + A_DEF * sin(TWO_PI * p[1]), p[1] + A_DEF * sin(TWO_PI * p[0]))

    return mp


def _mapping3(sin, cos):
    def mp(p):
        return (p[0] + A_DEF * sin(TWO_PI * p[1]) * cos(TWO_PI * p[2]),
                p[1] + A_DEF * sin(TWO_PI * p[2]) * cos(TWO_PI * p[0]),
                p[2] + A_DEF * sin(TWO_PI * p[0]) * cos(TWO_PI * p[1]))

    return mp


def _advection(v):
    """The port's scalar advection pair, speeds ``v``."""
    def flux(q, axis, var_axis):
        return v[int(axis)] * q

    def eig(q, axis, var_axis):
        return torch.full_like(q.sum(dim=var_axis), abs(v[int(axis)]))

    return flux, eig


def _solver(dim, cells, order, n_wave, pair, mode="picard", **kw):
    extra = {}
    if mode == "ck":
        extra["ck_material_slots"] = cv.curvilinear_material_slots(n_wave, dim)
    return ADERDGSolver(dim, order, cv.n_vars_curvilinear(n_wave, dim), (cells,) * dim,
                        *cv.curvilinear_physics(*pair, dim=dim, n_wave=n_wave),
                        dx=1.0 / cells, predictor_mode=mode, device="cpu",
                        dissipation_mask=cv.curvilinear_dissipation_mask(n_wave, dim), **extra,
                        **kw)


def _wave(sol, val):
    return torch.from_numpy(np.expand_dims(np.ascontiguousarray(val), sol.var_axis))


# ------------------------------------------------- twins of the JAX tests


def test_identity_mapping_reduces_to_cartesian():
    """``tests/test_curvilinear.py:60``: J = 1, a = I, equal axis speeds: the
    curvilinear step equals the Cartesian one on the wave slot to 1e-13."""
    v = (0.8, 0.8)
    cur = _solver(2, 6, 3, 1, _advection(v))
    metric, (X, Y) = cv.metric_fields(cur, lambda p: (p[0], p[1]))
    np.testing.assert_allclose(np.take(metric, 0, cur.var_axis), 1.0, atol=1e-15)
    plain = ADERDGSolver(2, 3, 1, (6, 6), *_advection(v), dx=1.0 / 6, device="cpu")
    q0 = _wave(cur, np.sin(TWO_PI * X) * np.cos(TWO_PI * Y))
    out_c = cv.undensitize(cur.step(cv.densitize(q0, metric, cur.var_axis), 1e-3), 1,
                           cur.var_axis)
    np.testing.assert_allclose(out_c.numpy(), plain.step(q0, 1e-3).numpy(), rtol=0, atol=1e-13)


def test_free_stream_preservation_converges():
    """``:92``: a constant state on the deformed mesh; the analytic metric's
    identity residual converges at scheme order."""
    res = []
    for cells in (4, 8):
        sol = _solver(2, cells, 3, 1, _advection((1.0, 0.5)))
        metric, _ = cv.metric_fields(sol, _mapping(torch.sin))
        ones = torch.ones(sol.state_shape[:2] + (1,) + sol.state_shape[3:], dtype=torch.float64)
        out = cv.undensitize(sol.step(cv.densitize(ones, metric, 2), 1e-3), 1, 2)
        res.append(float((out - 1.0).abs().max()))
    rate = np.log2(res[0] / res[1])
    assert res[1] < 1e-6 and rate > 3 - 0.5, (res, rate)


@pytest.mark.parametrize("mode", ["picard", "ck"])
def test_advection_on_deformed_mesh_converges(mode):
    """``:121``: advection through the deformed mesh converges at N + 1 to
    the translated solution, in both predictor modes."""
    v = (1.0, 0.5)
    errs = []
    for cells in (4, 8):
        sol = _solver(2, cells, 3, 1, _advection(v), mode=mode)
        metric, (X, Y) = cv.metric_fields(sol, _mapping(torch.sin))

        def exact(t):
            return _wave(sol, np.sin(TWO_PI * (X - v[0] * t)) * np.cos(TWO_PI * (Y - v[1] * t)))

        n = 10 * (cells // 4)
        out = sol.run(cv.densitize(exact(0.0), metric, 2), n, 0.1 / n)
        errs.append(float((cv.undensitize(out, 1, 2) - exact(0.1)).abs().max()))
    rate = np.log2(errs[0] / errs[1])
    assert rate > 3 + 0.5, (errs, rate)


def test_conservation_of_densitized_total():
    """``:151``: Σ w·Q̃ is conserved to 1e-13 and the metric slots stay
    bitwise frozen."""
    sol = _solver(2, 6, 3, 1, _advection((1.0, 0.5)))
    metric, (X, Y) = cv.metric_fields(sol, _mapping(torch.sin))
    Q0 = cv.densitize(_wave(sol, 1.0 + 0.4 * np.sin(TWO_PI * X)), metric, 2)
    out = sol.run(Q0, 10, 1e-3)
    np.testing.assert_allclose(sol.total_mass(out)[0].item(), sol.total_mass(Q0)[0].item(),
                               rtol=0, atol=1e-13)
    assert torch.equal(out[:, :, 1:], Q0[:, :, 1:])


def test_elastic_wave_on_deformed_mesh():
    """``:173``: the exact elastic P wave through the deformed mesh, CK and
    Picard each within 5e-5 of it and within 1e-9 of each other."""
    outs = {}
    for mode in ("picard", "ck"):
        sol = _solver(2, 8, 3, 5, elastic.elastic(), mode=mode)
        metric, (X, Y) = cv.metric_fields(sol, _mapping(torch.sin))

        def state(t):
            return torch.from_numpy(np.moveaxis(elastic.plane_p_wave(X, Y, t), -1, 2).copy())

        out = sol.run(cv.densitize(state(0.0), metric, 2), 40, 0.05 / 40)
        q = cv.undensitize(out, 5, 2)
        assert float((q - state(0.05)).abs().max()) < 0.05 * 1e-3, mode
        outs[mode] = q
    assert float((outs["ck"] - outs["picard"]).abs().max()) < 1e-9


def test_mapping_must_be_orientation_preserving():
    """``:201``."""
    sol = _solver(2, 4, 2, 1, _advection((1.0, 0.5)))
    with pytest.raises(ValueError, match="orientation"):
        cv.metric_fields(sol, lambda p: (-p[0], p[1]))
    with pytest.raises(ValueError, match="orientation"):
        cv.metric_fields_curl(sol, lambda p: (-p[0], p[1]))


@pytest.mark.parametrize("dim", [2, 3])
def test_curl_metric_in_cell_identity_exact(dim):
    """``:277``: Σ_k D_k(J a^k_i) = 0 to 1e-12 in each cell with the curl
    form; the analytic metric leaves a defect above 1e-4 in 3-D."""
    sol = ADERDGSolver(dim, 3, cv.n_vars_curvilinear(1, dim), (4,) * dim,
                       *cv.curvilinear_physics(*_advection((1.0, 0.5, 0.25)[:dim]), dim, 1),
                       dx=0.25, dissipation_mask=cv.curvilinear_dissipation_mask(1, dim),
                       device="cpu")
    mp = _mapping(torch.sin) if dim == 2 else _mapping3(torch.sin, torch.cos)
    D = torch.from_numpy(np.asarray(sol.ops.D))
    for mf in (cv.metric_fields_curl, cv.metric_fields):
        m = torch.from_numpy(np.moveaxis(mf(sol, mp)[0], sol.var_axis, -1).copy())
        defect = max(
            float(sum(_apply(D, m[..., 1 + k * dim + i], axis=k) / sol._dxs[k]
                      for k in range(dim)).abs().max())
            for i in range(dim))
        if mf is cv.metric_fields_curl:
            assert defect < 1e-12, defect
        elif dim == 3:
            assert defect > 1e-4, defect


@pytest.mark.parametrize("dim", [2, 3])
def test_free_stream_exact_with_curl_lobatto(dim):
    """``:313``: curl-form metrics on Lobatto nodes keep a constant state
    to 1e-12 on the deformed mesh."""
    cells = 6 if dim == 2 else 4
    sol = _solver(dim, cells, 3, 1, _advection((1.0, 0.5, 0.25)[:dim]), basis="lobatto")
    mp = _mapping(torch.sin) if dim == 2 else _mapping3(torch.sin, torch.cos)
    metric, _ = cv.metric_fields_curl(sol, mp)
    va = sol.var_axis
    ones = torch.ones(sol.state_shape[:va] + (1,) + sol.state_shape[va + 1:],
                      dtype=torch.float64)
    out = cv.undensitize(sol.run(cv.densitize(ones, metric, va), 5, 1e-3), 1, va)
    assert float((out - 1.0).abs().max()) < 1e-12


def test_advection_curl_lobatto_converges():
    """``:338``: on the curl-metric Lobatto configuration deformed-mesh
    advection still converges at ≥ N − 0.5."""
    v = (1.0, 0.5)
    errs = []
    for cells in (4, 8):
        sol = _solver(2, cells, 3, 1, _advection(v), basis="lobatto")
        metric, (X, Y) = cv.metric_fields_curl(sol, _mapping(torch.sin))

        def exact(t):
            return _wave(sol, np.sin(TWO_PI * (X - v[0] * t)) * np.cos(TWO_PI * (Y - v[1] * t)))

        n = 10 * (cells // 4)
        out = sol.run(cv.densitize(exact(0.0), metric, 2), n, 0.02 / n)
        errs.append(float((cv.undensitize(out, 1, 2) - exact(0.02)).abs().max()))
    rate = np.log2(errs[0] / errs[1])
    assert rate > 3 - 0.5, (errs, rate)


# --------------------------------------------------------- against JAX


def _jax_solver(dim, cells, n_wave, pair, **kw):
    cflux, ceig = jc.curvilinear_physics(*pair, dim=dim, n_wave=n_wave)
    return JaxSolver(dim=dim, order=3, n_vars=jc.n_vars_curvilinear(n_wave, dim),
                     grid_shape=(cells,) * dim, flux_fn=wrap_var_last(cflux),
                     max_eigenvalue_fn=wrap_var_last(ceig), dx=1.0 / cells,
                     dissipation_mask=jc.curvilinear_dissipation_mask(n_wave, dim), **kw)


@pytest.mark.parametrize("dim", [2, 3])
def test_metrics_densitize_and_lift_match_jax(dim):
    """``metric_fields``, ``metric_fields_curl`` (slots and physical nodes),
    ``densitize``/``undensitize`` and the lifted flux and wave speed of each
    axis against JAX's on the same solver and mapping: 2-D the elastic lift,
    3-D an advection lift."""
    cells = 5 if dim == 2 else 3
    if dim == 2:
        jpair, tpair, n_wave = jel.elastic(rho=1.3, lam=2.5, mu=0.7), elastic.elastic(
            1.3, 2.5, 0.7), 5
        jmp, tmp = _mapping(jnp.sin), _mapping(torch.sin)
    else:
        v = (1.0, 0.5, 0.25)
        jpair = (lambda q, n: v[int(n)] * q,
                 lambda q, n: jnp.full(q.shape[:-1], abs(v[int(n)])))
        tpair, n_wave = _advection(v), 1
        jmp, tmp = _mapping3(jnp.sin, jnp.cos), _mapping3(torch.sin, torch.cos)
    js = _jax_solver(dim, cells, n_wave, jpair)
    ts = _solver(dim, cells, 3, n_wave, tpair)
    for jf, tf in ((jc.metric_fields, cv.metric_fields),
                   (jc.metric_fields_curl, cv.metric_fields_curl)):
        (mj, xj), (mt, xt) = jf(js, jmp), tf(ts, tmp)
        _close(mt, mj, tf.__name__)
        for a, b in zip(xt, xj):
            _close(a, b, tf.__name__ + " nodes")
    va = ts.var_axis
    q = 0.1 * np.random.default_rng(dim).standard_normal(
        ts.state_shape[:va] + (n_wave,) + ts.state_shape[va + 1:])
    Qj = np.asarray(jc.densitize(jnp.asarray(q), mj, va))
    Qt = cv.densitize(torch.from_numpy(q), mj, va)
    np.testing.assert_array_equal(Qt.numpy(), Qj)
    np.testing.assert_array_equal(cv.undensitize(Qt, n_wave, va).numpy(),
                                  np.asarray(jc.undensitize(jnp.asarray(Qj), n_wave, va)))
    for d in range(dim):
        _close(ts.flux_fn(Qt, d, va).numpy(), js.flux_fn(jnp.asarray(Qj), d, va), f"flux {d}")
        _close(ts.max_eigenvalue_fn(Qt, d, va).numpy(),
               js.max_eigenvalue_fn(jnp.asarray(Qj), d, va), f"eig {d}")
    assert getattr(ts.flux_fn, "physics", None) == (
        PhysicsTag("curvilinear_elastic", 2, 10, (1.3, 2.5, 0.7)) if dim == 2 else None)


# ------------------------------------------- examples/seismic_topography.py

N_WAVE = 5
CPU_CELLS, CPU_DT, CPU_STEPS = 9, 4e-4, 100  # examples/seismic_topography.py:44,107-108
SOURCE, RX, RX_Y, F0 = (0.5, 0.35), (0.3, 0.4, 0.6, 0.7), 0.6, 8.0


def _receivers():
    rx = np.asarray(RX)
    return np.stack([rx, np.full_like(rx, RX_Y)], -1)


def _jax_scan(js, src, probe, u, n):
    rec = jnp.asarray(_receivers())

    def chunk(u, t):
        def body(carry, _):
            uu, tt = carry
            uu = src.step(uu, tt, CPU_DT)
            return (uu, tt + CPU_DT), probe.sample(uu, rec)

        return jax.lax.scan(body, (u, t), None, length=n)

    (u, _), seis = jax.jit(chunk)(u, jnp.asarray(0.0, jnp.float64))
    return np.asarray(u), np.asarray(seis)


def _port_scan(ts, src, u, n):
    probe = TracerAdvector(ts, lambda v: v[:, :2])
    rec = torch.from_numpy(_receivers())
    t = torch.tensor(0.0, dtype=torch.float64)
    seis = []
    for _ in range(n):
        u = src.step(u, t, CPU_DT)
        t = t + CPU_DT
        seis.append(probe.sample(u, rec))
    return u.numpy(), torch.stack(seis).numpy()


def _example_run(height):
    """The example's ``run(height, 100, 4e-4)`` at its CPU grid in both
    packages: JAX's jitted scan and the port crossed with
    ``aderdg_from_jax(..., physics="curvilinear_elastic")``; the state and
    the seismogram of each, and the metric."""
    js = _jax_solver(2, CPU_CELLS, N_WAVE, jel.elastic(), predictor_mode="ck",
                     ck_material_slots=jc.curvilinear_material_slots(N_WAVE, 2))
    ts = aderdg_from_jax(js, physics="curvilinear_elastic", rho=1.0, lam=2.0, mu=1.0,
                         device="cpu")
    metric, _ = jc.metric_fields(js, cv.hill_mapping(height, jnp.exp, jnp.sin))
    zeros = np.zeros(js.state_shape[:2] + (N_WAVE,) + js.state_shape[3:])
    u0 = np.asarray(jc.densitize(jnp.asarray(zeros), metric, 2))
    amp = np.zeros((1, 10))
    amp[0, 1] = 1.0
    jsrc = JaxPointSources(js, [list(SOURCE)], amp, wavelet=jax_ricker(F0))
    jout = _jax_scan(js, jsrc, JaxTracers(js, lambda v: v[:, :2]), jnp.asarray(u0), CPU_STEPS)
    tout = _port_scan(ts, point_sources_from_jax(jsrc, ts, f0=F0), torch.from_numpy(u0),
                      CPU_STEPS)
    return jout, tout, u0


@pytest.fixture(scope="module")
def example():
    runs = {h: _example_run(h) for h in (0.0, 0.04)}
    cart = JaxSolver(dim=2, order=3, n_vars=5, grid_shape=(CPU_CELLS,) * 2,
                     flux_fn=wrap_var_last(jel.elastic()[0]),
                     max_eigenvalue_fn=wrap_var_last(jel.elastic()[1]), dx=1.0 / CPU_CELLS,
                     predictor_mode="ck")
    amp = np.zeros((1, 5))
    amp[0, 1] = 1.0
    src = JaxPointSources(cart, [list(SOURCE)], amp, wavelet=jax_ricker(F0))
    ts = aderdg_from_jax(cart, physics="elastic", rho=1.0, lam=2.0, mu=1.0, device="cpu")
    tcart = _port_scan(ts, point_sources_from_jax(src, ts, f0=F0),
                       torch.zeros(ts.state_shape, dtype=torch.float64), CPU_STEPS)
    return runs, tcart


def test_example_cpu_run_matches_jax(example):
    """The example's flat and hill runs, 100 forced steps at (9, 9): the
    port's state and seismogram against JAX's XLA scan."""
    runs, _ = example
    for height, ((u_j, s_j), (u_t, s_t), u0) in runs.items():
        _close(u_t, u_j, f"state, height {height}")
        _close(s_t, s_j, f"seismogram, height {height}")
        np.testing.assert_array_equal(u_t[:, :, N_WAVE:], u0[:, :, N_WAVE:])


def test_example_gates_in_the_port(example):
    """``examples/seismic_topography.py:140-164`` on the port's runs: the
    flat limit against the Cartesian CK solver within 1e-5 of the field's
    maximum, and the hill moving the seismogram by more than 1e-3 of it."""
    runs, (_, s_cart) = example
    scale = max(np.abs(s_cart[..., :2]).max(), 1e-30)
    flat, hill = runs[0.0][1][1], runs[0.04][1][1]
    assert np.abs(flat[..., :2] - s_cart[..., :2]).max() < 1e-5 * scale
    assert np.abs(hill[..., :2] - flat[..., :2]).max() > 1e-3 * scale


def test_example_ends_before_the_p_arrival(example):
    """Reference caveat: the example's runs (CPU 100 steps of 4e-4, chip
    400 of 1e-4) end at t = 0.04, before the Ricker wavelet, centred at
    1/f0 = 0.125, has left the source, let alone crossed the 0.27 to the
    nearest receiver at c_p = 2 (t ≈ 0.26): the field it gates is ~1e-6 of
    the source's unit amplitude, and its "topography effect" exceeds its own
    field maximum.  The card's run (3,500 steps of 1e-4, t = 0.35) passes
    the arrival at every receiver."""
    runs, (_, s_cart) = example
    t_end = CPU_STEPS * CPU_DT
    assert t_end == pytest.approx(400 * 1e-4)
    cp = math.sqrt((2.0 + 2 * 1.0) / 1.0)
    arrivals = [1.0 / F0 + math.hypot(x - SOURCE[0], RX_Y - SOURCE[1]) / cp for x in RX]
    assert t_end < 1.0 / F0 < min(arrivals) == pytest.approx(0.2596, abs=1e-4)
    assert 3500 * 1e-4 > max(arrivals)
    scale = np.abs(s_cart[..., :2]).max()
    assert 1e-7 < scale < 1e-5
    hill, flat = runs[0.04][1][1], runs[0.0][1][1]
    assert np.abs(hill[..., :2] - flat[..., :2]).max() > scale


# ----------------------------------------------------- convert and the card


def test_convert_and_the_cuda_wrapper():
    """``aderdg_from_jax(..., physics="curvilinear_elastic")`` takes ρ, λ, μ,
    is probed against the JAX lift and refuses a lift of another wave-row
    count; ``CudaADERDG``
    admits the periodic lift, runs plain on the CPU, and refuses walls
    (Queue 2 K2 b) and other lifts (the curvilinear Euler: Queue 1 item
    12)."""
    js = _jax_solver(2, 4, N_WAVE, jel.elastic(rho=1.3, lam=2.5, mu=0.7), predictor_mode="ck",
                     ck_material_slots=jc.curvilinear_material_slots(N_WAVE, 2))
    ts = aderdg_from_jax(js, physics="curvilinear_elastic", rho=1.3, lam=2.5, mu=0.7,
                         device="cpu")
    with pytest.raises(SemanticError, match="does not reproduce the JAX solver's flux_fn"):
        aderdg_from_jax(js, physics="curvilinear_elastic", rho=1.3, lam=2.5, mu=1.7,
                        device="cpu")
    one_row = _jax_solver(2, 4, 1, (lambda q, n: q, lambda q, n: jnp.ones(q.shape[:-1])),
                          predictor_mode="ck",
                          ck_material_slots=jc.curvilinear_material_slots(1, 2))
    with pytest.raises(SemanticError, match="2-D system of 10 variables"):
        aderdg_from_jax(one_row, physics="curvilinear_elastic", rho=1.3, lam=2.5, mu=0.7,
                        device="cpu")
    cu = CudaADERDG(ts)
    assert cu.kernels == ("aderdg_ck_predictor_volume_2d", "aderdg_face_flux_2d",
                          "aderdg_surface_update_2d")
    assert cu._physics_id == 10 and cu._flux_rows == 5 and list(cu._params) == [1.3, 2.5, 0.7]
    metric, _ = cv.metric_fields(ts, cv.hill_mapping(0.04))
    q = cv.densitize(torch.from_numpy(1e-3 * np.random.default_rng(1).standard_normal(
        ts.state_shape[:2] + (5,) + ts.state_shape[3:])), metric, 2)
    assert torch.equal(cu.step(q, 1e-3), ts.step(q, 1e-3))
    assert all(n == 0 for n in cu.launches.values())
    reflect = elastic.sign_reflect(np.ones((2, 10)))
    walled = _solver(2, 4, 3, 5, elastic.elastic(), mode="ck", boundary="reflective",
                     reflect_fn=reflect, reflect_flux_fn=reflect)
    with pytest.raises(LoweringError, match="Queue 2 K2 b"):
        CudaADERDG(walled)
    flux, eig = cv.curvilinear_physics(*_advection((1.0, 0.5)), 2, 1)
    flux.physics = eig.physics = PhysicsTag("curvilinear_euler", 2, 10)
    euler_like = ADERDGSolver(2, 3, 10, (4, 4), flux, eig, device="cpu")
    with pytest.raises(LoweringError, match="Queue 1 item 12"):
        CudaADERDG(euler_like)
