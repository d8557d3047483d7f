"""The port's Cauchy–Kovalewski predictor with a source, a non-conservative
product or a fused right-hand side, against the JAX package, on the CPU.

- An array-free masked source (S = −2·q on the 9 wave rows, zero on the
  materials) on the 12-variable heterogeneous elasticity at p3, ``(4, 4,
  4)``, periodic and with the free surface, one step against JAX's
  ``ADERDGSolver.step`` and against the fused kernel's CK branch
  (``PallasADERDG(interpret=True)``, K2 a).  JAX's fused kernel refuses a
  source that captures an array (the sponge's σ) in interpret mode, so this
  source captures none.
- ``tests/test_ck.py``'s constant-state decay (S = −a·Q, zero flux): the
  port against JAX and against exp(−a·dt).
- CK with ``ncp_fn``: ``tests/test_ck.py``'s advection as a pure-NCP
  system, and the same with ``rhs_all_fn`` (and a source) beside it.
- ``sponge_source`` at ``(6, 6, 4)`` with the free surface: the closure
  against JAX's, then steps against JAX's, the materials bitwise frozen.
- What ``CudaADERDG`` refuses on a CK solver (``LoweringError`` naming
  ROADMAP.md, Queue 2 K2 a), and what it admits: the sponge, whose CPU
  path is the plain step.

f64 at rtol=0, atol=1e-12 (the repo's JAX↔Pallas bar).  Inputs are made
with NumPy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import elastic as jel
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import wrap_var_last
from exahype_tpu_torch.convert import state_from_numpy, state_to_numpy
from exahype_tpu_torch.models import elastic
from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.utils.errors import LoweringError

torch.set_num_threads(1)

CK = dict(predictor_mode="ck", ck_material_slots=(9, 10, 11),
          dissipation_mask=(1,) * 9 + (0, 0, 0))
MAT = (slice(None),) * 3 + (slice(9, 12),)
DT = 1e-3  # under the CFL limit (~2e-3 at dx = 1/4 on these states)


def jax_wave_source(q, va):
    """S = −2·q on the wave rows, zero on the materials, with no captured
    array."""
    wave = jax.lax.slice_in_dim(q, 0, 9, axis=va)
    mats = jax.lax.slice_in_dim(q, 9, 12, axis=va)
    return jnp.concatenate([-2.0 * wave, jnp.zeros_like(mats)], axis=va)


def port_wave_source(q, va):
    return torch.cat([-2.0 * q.narrow(va, 0, 9), torch.zeros_like(q.narrow(va, 9, 3))], dim=va)


def walls_kw(walled, package):
    if not walled:
        return {}
    hooks = (jel.elastic3d_free_surface_het() if package == "jax"
             else elastic.elastic3d_free_surface_het())
    return dict(boundary="reflective", wall_axes=(2,), reflect_fn=hooks[0],
                reflect_flux_fn=hooks[1])


def jax_het(grid, walled=False, **kw):
    flux, eig = jel.elastic3d_heterogeneous()
    return JaxSolver(dim=3, order=3, n_vars=12, grid_shape=grid, flux_fn=wrap_var_last(flux),
                     max_eigenvalue_fn=wrap_var_last(eig), dx=1.0 / grid[0],
                     **{**CK, **walls_kw(walled, "jax"), **kw})


def port_het(grid, walled=False, **kw):
    flux, eig = elastic.elastic3d_heterogeneous()
    return ADERDGSolver(3, 3, 12, grid, flux, eig, dx=1.0 / grid[0], device="cpu",
                        **{**CK, **walls_kw(walled, "port"), **kw})


def het_state(solver, seed):
    """A wave of amplitude ~1e-3 in every evolved row and materials
    constant in each cell (ρ in [0.8, 1.6), λ and μ in [1, 3))."""
    rng = np.random.default_rng(seed)
    no_var = solver.state_shape[:3] + solver.state_shape[4:]
    grid = solver.grid_shape
    rows = [1e-3 * rng.standard_normal(no_var) for _ in range(9)]
    rows += [np.broadcast_to(m, no_var) for m in (
        0.8 + 0.8 * rng.random(grid), 1.0 + 2.0 * rng.random(grid),
        1.0 + 2.0 * rng.random(grid))]
    return np.stack(rows, axis=3)


def close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


# ------------------------------------------------ K2 a's function, array free


@pytest.fixture(scope="module", params=[False, True], ids=["periodic", "free_surface"])
def masked_source_case(request):
    walled = request.param
    js = jax_het((4, 4, 4), walled, source_fn=jax_wave_source)
    ts = port_het((4, 4, 4), walled, source_fn=port_wave_source)
    q = het_state(ts, seed=21 + walled)
    got = state_to_numpy(ts.step(state_from_numpy(q, device="cpu"), DT))
    return js, q, got


def test_ck_masked_source_matches_jax_step(masked_source_case):
    js, q, got = masked_source_case
    ref = np.asarray(js.step(jnp.asarray(q), DT))
    close(got, ref)
    np.testing.assert_array_equal(got[MAT], q[MAT])
    # The source moved the step: without it the result differs by ~dt·2·|q|.
    assert np.abs(ref - np.asarray(jax_het((4, 4, 4), js.boundary != "periodic").step(
        jnp.asarray(q), DT))).max() > 1e-7


def test_ck_masked_source_matches_pallas_interpret(masked_source_case):
    """The TPU kernel's CK branch with the source (K2 a) itself."""
    from exahype_tpu.models.aderdg_pallas import PallasADERDG

    js, q, got = masked_source_case
    ref = np.asarray(PallasADERDG(js, interpret=True).step(jnp.asarray(q), DT))
    close(got, ref)


def test_ck_predictor_returns_the_time_averaged_source():
    js = jax_het((4, 2, 4), source_fn=jax_wave_source)
    ts = port_het((4, 2, 4), source_fn=port_wave_source)
    q = het_state(ts, seed=3)
    ref = js.predictor(jnp.asarray(q), DT)
    out = ts.predictor(state_from_numpy(q, device="cpu"), DT)
    assert len(out) == len(ref) == 3
    close(state_to_numpy(out[0]), np.asarray(ref[0]))
    for d in range(3):
        close(state_to_numpy(out[1][d]), np.asarray(ref[1][d]))
    close(state_to_numpy(out[2]), np.asarray(ref[2]))


# ------------------------------------------------ tests/test_ck.py's cases


def test_ck_source_exponential_decay():
    """S = −a·Q on a constant state with zero flux: one CK step is the
    truncated exponential, within O(dt^{N+2}) of exp(−a·dt), as the JAX
    solver's."""
    a, dt = 3.0, 0.01

    def jflux(Q, axis, var_axis):
        return jnp.zeros_like(Q)

    def jeig(Q, axis, var_axis):
        return jnp.ones_like(Q.sum(axis=var_axis))  # the var axis reduced away

    js = JaxSolver(dim=2, order=3, n_vars=1, grid_shape=(2, 2), flux_fn=jflux,
                   max_eigenvalue_fn=jeig, dx=0.5, predictor_mode="ck",
                   source_fn=lambda Q, var_axis: -a * Q)
    ts = ADERDGSolver(2, 3, 1, (2, 2), lambda Q, axis, va: torch.zeros_like(Q),
                      lambda Q, axis, va: torch.ones_like(Q.sum(va)), dx=0.5,
                      predictor_mode="ck", source_fn=lambda Q, va: -a * Q, device="cpu")
    q0 = np.ones(ts.state_shape)
    got = state_to_numpy(ts.step(state_from_numpy(q0, device="cpu"), dt))
    close(got, np.asarray(js.step(jnp.asarray(q0), dt)))
    assert np.abs(got - np.exp(-a * dt)).max() < 10 * (a * dt) ** 5 / 120.0


V = (1.0, 0.5)


def advection(package, cells, fused=False):
    """``tests/test_ck.py``'s scalar advection as a pure-NCP system (B_d =
    v_d, zero flux) on the CK predictor; ``fused`` adds a decay source
    S = −Q and the fused right-hand side rhs_all = S − Σ_d v_d ∂_d Q
    beside the NCP, as the Z4 solvers carry all three."""
    if package == "jax":
        kw = dict(flux_fn=lambda Q, axis, va: jnp.zeros_like(Q),
                  max_eigenvalue_fn=lambda Q, axis, va: jnp.full_like(
                      Q.sum(axis=va), abs(V[axis])),
                  ncp_fn=lambda Q, dq, axis, va: V[axis] * dq)
        if fused:
            kw["source_fn"] = lambda Q, va: -Q
            kw["rhs_all_fn"] = lambda Q, grads, va: -Q - V[0] * grads[0] - V[1] * grads[1]
        return JaxSolver(dim=2, order=3, n_vars=1, grid_shape=(cells, cells),
                         dx=1.0 / cells, predictor_mode="ck", **kw)
    kw = dict(ncp_fn=lambda Q, dq, axis, va: V[axis] * dq)
    if fused:
        kw["source_fn"] = lambda Q, va: -Q
        kw["rhs_all_fn"] = lambda Q, grads, va: -Q - V[0] * grads[0] - V[1] * grads[1]
    return ADERDGSolver(2, 3, 1, (cells, cells), lambda Q, axis, va: torch.zeros_like(Q),
                        lambda Q, axis, va: torch.full_like(Q.sum(va), abs(V[axis])),
                        dx=1.0 / cells, predictor_mode="ck", device="cpu", **kw)


@pytest.mark.parametrize("fused", [False, True], ids=["ncp", "ncp_rhs_all"])
def test_ck_ncp_advection_matches_jax(fused):
    """Three CK steps of the advected sine (``tests/test_ck.py:68-80``) on
    the pure-NCP branch, and with the fused right-hand side."""
    cells, dt = 8, 0.02
    js, ts = advection("jax", cells, fused), advection("port", cells, fused)
    x, y = (np.squeeze(c, 2) for c in ts.nodes_meshgrid())
    q = (np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y))[:, :, None]
    q = np.broadcast_to(q, ts.state_shape).copy()
    ref = np.asarray(js.run(jnp.asarray(q), 3, dt))
    got = state_to_numpy(ts.run(state_from_numpy(q, device="cpu"), 3, dt))
    close(got, ref)
    assert np.abs(got - q).max() > 1e-2


# ------------------------------------------------ the sponge


def sponge_pair(grid, **kw):
    js = jax_het(grid, walled=True)
    js.source_fn = jel.sponge_source(js, **kw)
    ts = port_het(grid, walled=True)
    ts.source_fn = elastic.sponge_source(ts, **kw)
    return js, ts


SPONGE = dict(width=0.3, rate=40.0, axes=(0, 1), n_wave=9)


def test_sponge_source_matches_jax():
    js, ts = sponge_pair((6, 6, 4), **SPONGE)
    q = het_state(ts, seed=5)
    close(state_to_numpy(ts.source_fn(state_from_numpy(q, device="cpu"), 3)),
          np.asarray(js.source_fn(jnp.asarray(q), 3)))
    tag = ts.source_fn.sponge
    assert (tag.width, tag.rate, tag.axes, tag.n_wave) == (0.3, 40.0, (0, 1), 9)
    assert tag.sigma.shape == (6, 6, 4) and tag.sigma.max() > 0 and tag.sigma.min() == 0


def test_sponge_steps_match_jax_materials_frozen():
    js, ts = sponge_pair((6, 6, 4), **SPONGE)
    q = het_state(ts, seed=6)
    ref = np.asarray(js.run(jnp.asarray(q), 2, DT))
    got = state_to_numpy(ts.run(state_from_numpy(q, device="cpu"), 2, DT))
    close(got, ref)
    np.testing.assert_array_equal(got[MAT], q[MAT])
    # The sponge damps: its run differs from the sourceless one.
    bare = state_to_numpy(port_het((6, 6, 4), walled=True).run(
        state_from_numpy(q, device="cpu"), 2, DT))
    assert np.abs(got - bare).max() > 1e-7


# ------------------------------------------------ what the CUDA kernels take


def test_cuda_admits_the_sponge_and_runs_plain_on_the_cpu():
    ts = port_het((4, 2, 4), walled=True)
    ts.source_fn = elastic.sponge_source(ts, **SPONGE)
    cu = CudaADERDG(ts)
    assert cu.kernels == ("aderdg_ck_predictor_volume_sponge", "aderdg_face_flux_walls",
                          "aderdg_surface_update_walls")
    assert cu.sponge is ts.source_fn.sponge and not cu.ncp
    u = state_from_numpy(het_state(ts, seed=8), device="cpu")
    assert torch.equal(cu.step(u, DT), ts.step(u, DT))
    assert cu.launches == {name: 0 for name in cu.kernels}


def refused(case):
    if case == "ncp":
        return port_het((2, 2, 2), ncp_fn=lambda Q, dq, axis, va: 0.0 * dq)
    if case == "rhs_all":
        return port_het((2, 2, 2), rhs_all_fn=lambda Q, grads, va: 0.0 * Q)
    if case == "other_source":
        return port_het((2, 2, 2), source_fn=port_wave_source)
    if case == "sponge_all_rows":
        ts = port_het((2, 2, 2))
        ts.source_fn = elastic.sponge_source(ts, **{**SPONGE, "n_wave": 12})
        return ts
    flux, eig = euler_physics(3)
    ts = ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, dx=0.5, device="cpu")
    ts.source_fn = elastic.sponge_source(ts, **SPONGE)
    return ts


@pytest.mark.parametrize("case", ["ncp", "rhs_all", "other_source", "sponge_all_rows",
                                  "sponge_on_euler"])
def test_cuda_refusals_name_queue2_k2a(case):
    with pytest.raises(LoweringError, match=r"ROADMAP.md, Queue 2 K2 a"):
        CudaADERDG(refused(case))
