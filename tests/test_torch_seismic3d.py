"""The layered seismic run (``examples/seismic3d_layered.py``) in the port
against the JAX package, on the CPU, at the example's CPU grid ``(9, 9,
6)`` in float64.

The JAX configuration is built as the example builds it and crosses to the
port through ``aderdg_from_jax`` (the sponge by its parameters, checked
against the JAX closure) and ``point_sources_from_jax``; the state and the
receivers cross as NumPy.  Then:

- 3 forced steps (Strang-split ``PointSources.step``, the receivers
  sampled through ``TracerAdvector.sample`` after each) against JAX's, the
  state and the seismogram at rtol=0, atol=1e-12;
- at the example's own dt (``cfl_dt`` at the solver's default cfl, 0.3)
  this step diverges, in JAX's XLA step as in the port: 120 forced steps
  of each reach max|wave| ~3e11 (the physical field stays O(100)), and the
  two agree to 1e-9 of it;
- so the port runs at half that dt: to the example's time (160 steps)
  with its gates (finite, materials bitwise frozen, mirror symmetry across
  the source axis below 1e-5 of the field's maximum), and on to 240 steps
  (t ≈ 0.143, past the kinematic P arrival t_expect ≈ 0.127), where the
  example's arrival gate |t_arrive − t_expect| < 0.5·t_expect applies.  The
  gates read the seismogram's velocity rows, the ``[n_steps, n_receivers,
  3]`` the example's comment gives it: its code keeps all 12 sampled rows,
  whose materials (λ = 2 at the receivers) set the arrival's 1 % threshold
  while the wave there stays under ~200, as it does on a stable run.

The JAX steps run jitted (a ``lax.scan`` of the 3 steps), as the example
runs them.
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
from exahype_tpu_torch.models.tracers import TracerAdvector

torch.set_num_threads(1)

CELLS = (9, 9, 6)
SPONGE = dict(width=0.12, rate=40.0, axes=(0, 1), n_wave=9)
F0 = 8.0
UP = dict(rho=1.0, lam=2.0, mu=1.0)
LO = dict(rho=1.2, lam=9.6, mu=4.8)
N_STEPS = 160        # at half the example's dt, its 80 steps' time (:114)
ARRIVAL_STEPS = 240  # t ≈ 0.143 > t_expect ≈ 0.127
DIVERGE_STEPS = 120  # at the example's dt
MAT = (slice(None),) * 3 + (slice(9, 12),)


def jax_example():
    """``examples/seismic3d_layered.py:51-112`` at the CPU grid: the JAX
    solver with its sponge, the layered state (NumPy), the Ricker point
    force, the receivers (NumPy), the probe and dt."""
    flux, eig = jel.elastic3d_heterogeneous()
    reflect, reflect_flux = jel.elastic3d_free_surface_het()
    js = JaxSolver(dim=3, order=3, n_vars=12, grid_shape=CELLS, flux_fn=wrap_var_last(flux),
                   max_eigenvalue_fn=wrap_var_last(eig), dx=1.0 / CELLS[0],
                   boundary="reflective", wall_axes=(2,), reflect_fn=reflect,
                   reflect_flux_fn=reflect_flux, dissipation_mask=(1,) * 9 + (0, 0, 0),
                   predictor_mode="ck", ck_material_slots=(9, 10, 11), source_fn=None)
    js.source_fn = jel.sponge_source(js, **SPONGE)
    coords = js.nodes_meshgrid()
    no_var = js.state_shape[:3] + js.state_shape[4:]
    zc = np.broadcast_to(np.squeeze(np.asarray(coords[2]), 3), no_var)
    zmax = CELLS[2] * js._dxs[2]
    upper = zc > 0.5 * zmax
    mats = np.stack([np.where(upper, UP[k], LO[k]) for k in ("rho", "lam", "mu")], axis=3)
    u = np.concatenate([np.zeros(js.state_shape[:3] + (9,) + js.state_shape[4:]), mats], axis=3)
    amp = np.zeros((1, 12))
    amp[0, 2] = 1.0
    src = JaxPointSources(js, [[0.5, 0.5, 0.75 * zmax]], amp, wavelet=jax_ricker(F0))
    rx = np.asarray([0.3, 0.4, 0.6, 0.7])
    receivers = np.stack([rx, np.full_like(rx, 0.5), np.full_like(rx, 0.95 * zmax)], -1)
    probe = JaxTracers(js, lambda v: v[:, :3])
    dt = float(js.cfl_dt(jnp.asarray(u)))
    return js, u, src, receivers, probe, dt, zmax


@pytest.fixture(scope="module")
def example():
    js, u, jsrc, receivers, jprobe, dt, zmax = jax_example()
    ts = aderdg_from_jax(js, physics="elastic3d_het", walls="elastic3d_het_free_surface",
                         sponge=SPONGE, device="cpu")
    return {
        "js": js, "u": u, "jsrc": jsrc, "receivers": receivers, "jprobe": jprobe, "dt": dt,
        "zmax": zmax, "ts": ts, "src": point_sources_from_jax(jsrc, ts, f0=F0),
        "probe": TracerAdvector(ts, lambda v: v[:, :3]),
    }


def port_run(ex, u, t, n, dt):
    """``n`` forced steps of the port from ``(u, t)``; the state, the time
    (a 0-d tensor of the state's dtype) and the seismogram ``[n, 4, 12]``."""
    rec = torch.from_numpy(ex["receivers"])
    seis = []
    for _ in range(n):
        u = ex["src"].step(u, t, dt)
        t = t + dt
        seis.append(ex["probe"].sample(u, rec))
    return u, t, torch.stack(seis)


def jax_run(ex, n, dt):
    """``n`` forced steps of JAX's, jitted as the example's scan."""
    jsrc, jprobe = ex["jsrc"], ex["jprobe"]
    rec = jnp.asarray(ex["receivers"])

    def chunk(u, t):
        def body(carry, _):
            uu, tt = carry
            uu = jsrc.step(uu, tt, dt)
            return (uu, tt + dt), jprobe.sample(uu, rec)

        return jax.lax.scan(body, (u, t), None, length=n)

    (u, t), seis = jax.jit(chunk)(jnp.asarray(ex["u"]), jnp.asarray(0.0, jnp.float64))
    return np.asarray(u), float(t), np.asarray(seis)


def test_seismic_example_steps_match_jax(example):
    ex = example
    u_j, t_j, seis_j = jax_run(ex, 3, ex["dt"])
    u0 = torch.from_numpy(ex["u"])
    u_t, t_t, seis_t = port_run(ex, u0, torch.tensor(0.0, dtype=torch.float64), 3, ex["dt"])
    for name, got, ref in (("state", u_t.numpy(), u_j), ("seismogram", seis_t.numpy(), seis_j)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12, err_msg=name)
    assert float(t_t) == t_j
    np.testing.assert_array_equal(u_t.numpy()[MAT], ex["u"][MAT])
    assert np.abs(u_j[:, :, :, :9]).max() > 1e-3  # the source has forced the field
    assert np.abs(seis_j[..., :3]).max() > 1e-7  # and it has reached the receivers


def test_seismic_example_dt_diverges_in_both_packages(example):
    ex = example
    u_j = jax_run(ex, DIVERGE_STEPS, ex["dt"])[0]
    u_t = port_run(ex, torch.from_numpy(ex["u"]), torch.tensor(0.0, dtype=torch.float64),
                   DIVERGE_STEPS, ex["dt"])[0].numpy()
    peak = np.abs(u_j[:, :, :, :9]).max()
    assert peak > 1e9 and np.abs(u_t[:, :, :, :9]).max() > 1e9
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=1e-9 * peak)


def test_seismic_example_gates_in_the_port(example):
    """The example's gates on the port alone at half its dt: its time, then
    on to where the P arrival at the nearest receiver applies."""
    ex = example
    dt = 0.5 * ex["dt"]
    u0 = torch.from_numpy(ex["u"])
    t0 = torch.tensor(0.0, dtype=torch.float64)
    u, t, seis = port_run(ex, u0, t0, N_STEPS, dt)
    u2, t2, seis2 = port_run(ex, u, t, ARRIVAL_STEPS - N_STEPS, dt)
    for uu, ss in ((u, seis), (u2, torch.cat([seis, seis2]))):
        s = ss.numpy()[..., :3]
        assert np.isfinite(uu.numpy()).all() and np.isfinite(s).all()
        assert torch.equal(uu[MAT], u0[MAT])
        scale = max(np.abs(s).max(), 1e-30)
        assert np.abs(s[:, 1, 2] - s[:, 2, 2]).max() < 1e-5 * scale  # v_z even
        assert np.abs(s[:, 1, 0] + s[:, 2, 0]).max() < 1e-5 * scale  # v_x odd
    zmax = ex["zmax"]
    assert np.abs(u2.numpy()[:, :, :, :9]).max() < 1e3  # bounded
    cp_up = np.sqrt((UP["lam"] + 2 * UP["mu"]) / UP["rho"])
    t_expect = float(np.hypot(0.1, 0.95 * zmax - 0.75 * zmax)) / cp_up + 0.35 / F0
    assert float(t) < t_expect < float(t2)  # the gate applies at 110, not at 80
    s = torch.cat([seis, seis2]).numpy()[..., :3]
    v_mag = np.abs(s[:, 1, :]).max(axis=-1)
    t_arrive = (int(np.argmax(v_mag > 0.01 * v_mag.max())) + 1) * dt
    assert abs(t_arrive - t_expect) < 0.5 * t_expect, (t_arrive, t_expect)
