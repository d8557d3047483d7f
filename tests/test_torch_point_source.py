"""The port's point sources and tracer probes (``models/point_source.py``,
``models/tracers.py``) against the JAX package's, on the CPU.

- ``ricker`` on a range of times;
- ``PointSources.delta_field`` in 2-D and 3-D, and its duality property
  (``tests/test_point_source.py:54``): the weak inner product of the
  deposit with any tensor polynomial up to the scheme's degree is the
  polynomial's value at the source;
- ``inject``, ``step`` and ``run`` on a 2-D advection solver with two
  sources;
- ``TracerAdvector.sample``, ``advect`` and ``trajectories``, periodic and
  clamped, in 2-D and 3-D, from positions inside and outside the domain;
  ``uniform_tracers``.

f64 at rtol=0, atol=1e-12 unless stated; inputs made with NumPy from a
seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.point_source import PointSources as JaxPointSources
from exahype_tpu.models.point_source import ricker as jax_ricker
from exahype_tpu.models.tracers import TracerAdvector as JaxTracers
from exahype_tpu.models.tracers import euler_velocity as jax_euler_velocity
from exahype_tpu.models.tracers import uniform_tracers as jax_uniform_tracers
from exahype_tpu_torch.convert import state_from_numpy, state_to_numpy
from exahype_tpu_torch.models.aderdg import ADERDGSolver
from exahype_tpu_torch.models.point_source import PointSources, ricker
from exahype_tpu_torch.models.tracers import TracerAdvector, euler_velocity, uniform_tracers

torch.set_num_threads(1)

VEL = (1.0, 0.5, 0.25)


def close(got, ref, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol)


def solvers(dim, cells=4, order=3, n_vars=1):
    """Scalar advection (``tests/test_aderdg.py::advection_physics``) in
    both packages."""
    v = VEL[:dim]
    js = JaxSolver(dim=dim, order=order, n_vars=n_vars, grid_shape=(cells,) * dim,
                   flux_fn=lambda Q, axis, va: v[axis] * Q,
                   max_eigenvalue_fn=lambda Q, axis, va: jnp.full_like(
                       Q.sum(axis=va), abs(v[axis])),
                   dx=1.0 / cells)
    ts = ADERDGSolver(dim, order, n_vars, (cells,) * dim, lambda Q, axis, va: v[axis] * Q,
                      lambda Q, axis, va: torch.full_like(Q.sum(va), abs(v[axis])),
                      dx=1.0 / cells, device="cpu")
    return js, ts


# ------------------------------------------------ the wavelet and the deposit


def test_ricker_matches_jax():
    t = np.linspace(-0.1, 0.6, 71)
    for f0, delay in ((8.0, None), (3.0, 0.2)):
        close(ricker(f0, delay)(torch.from_numpy(t)).numpy(),
              np.asarray(jax_ricker(f0, delay)(jnp.asarray(t))), atol=1e-15)


@pytest.mark.parametrize("dim", [2, 3])
def test_delta_field_matches_jax_and_is_dual_to_point_evaluation(dim):
    js, ts = solvers(dim, n_vars=2)
    x0 = np.asarray([[0.3173, 0.642, 0.109][:dim], [0.81, 0.05, 0.5][:dim]])
    amp = np.asarray([[1.0, -0.5], [0.25, 2.0]])
    jps = JaxPointSources(js, x0, amp, wavelet=lambda t: 1.0)
    tps = PointSources(ts, x0, amp, wavelet=lambda t: 1.0)
    scale = np.asarray([0.7, -1.3])
    for s in (None, scale):
        ref = np.asarray(jps.delta_field(jnp.float64, scale=s))
        got = tps.delta_field(torch.float64, scale=None if s is None else torch.from_numpy(s))
        close(state_to_numpy(got), ref, atol=1e-12 * np.abs(ref).max())

    # Duality: <delta, φ> = φ(x0) for a tensor cubic φ, one source alone.
    one = PointSources(ts, x0[:1], np.ones((1, 2)), wavelet=lambda t: 1.0)
    delta = np.take(state_to_numpy(one.delta_field(torch.float64)), 0, axis=dim)

    def poly(*xs):
        out = 1.0
        for x in xs:
            out = out * (0.7 - 1.3 * x + 2.2 * x**2 - 0.4 * x**3)
        return out

    coords = [np.squeeze(c, dim) for c in ts.nodes_meshgrid()]
    prod = delta * poly(*coords)
    w = ts.ops.weights
    for d in reversed(range(dim)):
        prod = np.tensordot(w, prod, axes=([0], [d]))
    got = float(prod.sum()) * float(np.prod(ts._dxs))
    np.testing.assert_allclose(got, float(poly(*x0[0])), rtol=1e-11)


# ------------------------------------------------ injection and forced steps


def test_inject_step_and_run_match_jax():
    js, ts = solvers(2, cells=4, n_vars=2)
    x0 = [[0.41, 0.77], [0.12, 0.3]]
    amp = np.asarray([[2.5, 0.0], [-1.0, 0.5]])
    jps = JaxPointSources(js, x0, amp, wavelet=jax_ricker(8.0))
    tps = PointSources(ts, x0, amp, wavelet=ricker(8.0))
    q = np.random.default_rng(1).standard_normal(ts.state_shape)
    u_j, u_t = jnp.asarray(q), state_from_numpy(q, device="cpu")
    t0, dt = 0.1, 0.01
    t0_t = torch.tensor(t0, dtype=torch.float64)
    close(state_to_numpy(tps.inject(u_t, t0_t, dt)), jps.inject(u_j, jnp.asarray(t0), dt))
    close(state_to_numpy(tps.step(u_t, t0_t, dt)), jps.step(u_j, jnp.asarray(t0), dt))
    got, t_got = tps.run(u_t, t0, dt, 3)
    ref, t_ref = jps.run(u_j, t0, dt, 3)
    close(state_to_numpy(got), ref)
    assert float(t_got) == float(t_ref)
    assert np.abs(state_to_numpy(got) - state_to_numpy(ts.run(u_t, 3, dt))).max() > 1e-6


# ------------------------------------------------ tracers


def euler_state(solver, seed):
    """ρ in [1, 2), momenta in [-0.5, 0.5), energy in [3, 4): a smooth
    enough field for the velocity m/ρ."""
    rng = np.random.default_rng(seed)
    no_var = solver.state_shape[:solver.dim] + solver.state_shape[solver.dim + 1:]
    rows = [1.0 + rng.random(no_var)]
    rows += [rng.random(no_var) - 0.5 for _ in range(solver.dim)]
    rows += [3.0 + rng.random(no_var)]
    return np.stack(rows, axis=solver.dim)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("boundary", ["periodic", "clamp"])
def test_tracers_sample_and_advect_match_jax(dim, boundary):
    js, ts = solvers(dim, cells=4, n_vars=dim + 2)
    jt = JaxTracers(js, jax_euler_velocity(dim), boundary)
    tt = TracerAdvector(ts, euler_velocity(dim), boundary)
    q = euler_state(ts, seed=dim)
    u_j, u_t = jnp.asarray(q), state_from_numpy(q, device="cpu")
    x = np.random.default_rng(10 + dim).uniform(-0.3, 1.3, size=(9, dim))
    x_j, x_t = jnp.asarray(x), torch.from_numpy(x)
    close(tt.sample(u_t, x_t).numpy(), jt.sample(u_j, x_j))
    close(tt.velocity(u_t, x_t).numpy(), jt.velocity(u_j, x_j))
    close(tt.advect(u_t, x_t, 0.05).numpy(), jt.advect(u_j, x_j, 0.05))
    decay = (lambda u, dt: 0.9 * u)
    out_t = tt.trajectories(decay, u_t, x_t, 0.05, 3)
    out_j = jt.trajectories(decay, u_j, x_j, 0.05, 3)
    for got, ref in zip(out_t, out_j):
        close(got.numpy(), ref)


def test_uniform_tracers_match_jax():
    got = uniform_tracers((1.0, 0.5, 2.0), (3, 2, 4), dtype=torch.float64, device="cpu")
    close(got.numpy(), jax_uniform_tracers((1.0, 0.5, 2.0), (3, 2, 4), dtype=jnp.float64))
