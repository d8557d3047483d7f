"""The port's 3-D heterogeneous elasticity against the JAX package's, on the
CPU: the flux and the wave speed of ``elastic3d_heterogeneous`` (the JAX pair
through ``wrap_var_last``, the port's in the var-axis layout), the plane P
wave, the physics tags, and ``bench.py::bench_ck``'s initial state and
energy reading.

Inputs are made with NumPy from a seed (ρ, λ, μ positive) and handed to
both packages.  f64 at rtol=0, atol=1e-14: the same arithmetic in the same
order on values of order 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import elastic as jel
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import wrap_var_last
from exahype_tpu_torch.models import elastic
from exahype_tpu_torch.models.aderdg import ADERDGSolver, PhysicsTag, euler_physics

torch.set_num_threads(1)

ATOL = 1e-14


def random_state(shape, var_axis, seed=0):
    """12 variables on ``var_axis``: the wave ~N(0, 1), ρ, λ, μ in
    [0.5, 3.5)."""
    rng = np.random.default_rng(seed)
    lead = shape[:var_axis] + shape[var_axis + 1:]
    rows = [rng.standard_normal(lead) for _ in range(9)]
    rows += [0.5 + 3.0 * rng.random(lead) for _ in range(3)]
    return np.stack(rows, axis=var_axis)


# (state shape, var axis): a cell state [n, n, n, V, *grid] and a face
# array [n, n, V, *grid] (the var axis one to the left), as the solver
# calls them.
LAYOUTS = [((4, 4, 4, 12, 3, 2, 2), 3), ((4, 4, 12, 3, 2, 2), 2)]


@pytest.mark.parametrize("normal", [0, 1, 2])
@pytest.mark.parametrize("shape,va", LAYOUTS)
def test_het_flux_matches_jax(shape, va, normal):
    Q = random_state(shape, va, seed=normal)
    ref = np.asarray(wrap_var_last(jel.elastic3d_het_flux)(jnp.asarray(Q), normal, va))
    flux, _ = elastic.elastic3d_heterogeneous()
    got = flux(torch.from_numpy(Q), normal, va).numpy()
    assert got.shape == ref.shape == Q.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    # The material rows are zero.
    assert not np.take(got, [9, 10, 11], axis=va).any()


@pytest.mark.parametrize("normal", [0, 1, 2])
@pytest.mark.parametrize("shape,va", LAYOUTS)
def test_het_eigenvalue_matches_jax(shape, va, normal):
    Q = random_state(shape, va, seed=3 + normal)
    ref = np.asarray(
        wrap_var_last(jel.elastic3d_het_eigenvalue)(jnp.asarray(Q), normal, va)
    )
    _, eig = elastic.elastic3d_heterogeneous()
    got = eig(torch.from_numpy(Q), normal, va).numpy()
    assert got.shape == ref.shape == shape[:va] + shape[va + 1:]
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_het_flux_signed_zeros_follow_the_reference():
    """The stress rows that do not involve the normal are ``-0.0``, as in
    the reference (values compare equal; the bits are checked here)."""
    Q = random_state((2, 12), 1)
    for normal in range(3):
        ref = np.asarray(wrap_var_last(jel.elastic3d_het_flux)(jnp.asarray(Q), normal, 1))
        got = elastic.elastic3d_het_flux(torch.from_numpy(Q), normal, 1).numpy()
        np.testing.assert_array_equal(np.signbit(got), np.signbit(ref))


def test_plane_p_wave_and_speeds_match_jax():
    x = np.linspace(-0.3, 1.7, 101).reshape(101, 1) + np.zeros((1, 3))
    for t in (0.0, 0.125):
        for mats in ({}, {"rho": 1.2, "lam": 3.0, "mu": 1.5}):
            ref = np.asarray(jel.plane_p_wave_3d(x, t, **mats))
            got = elastic.plane_p_wave_3d(x, t, **mats)
            assert got.shape == ref.shape == (101, 3, 9)
            np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert elastic._speeds(1.2, 3.0, 1.5) == jel._speeds(1.2, 3.0, 1.5)
    assert elastic.N_VARS_3D_HET == jel.N_VARS_3D_HET
    assert all(elastic._sig_idx(i, j) == jel._sig_idx(i, j)
               for i in range(3) for j in range(3))


def test_physics_tags():
    flux, eig = elastic.elastic3d_heterogeneous()
    assert flux.physics == eig.physics == PhysicsTag("elastic3d_het", 3, 12)
    with pytest.raises(AttributeError):
        flux.physics.gamma
    # Euler tags compare as they did: equal for one gamma, not across two.
    a, b, c = euler_physics(3)[0], euler_physics(3)[1], euler_physics(3, gamma=5 / 3)[0]
    assert a.physics == b.physics != c.physics
    assert a.physics.gamma == 1.4 and a.physics.params == (1.4,)
    assert a.physics != flux.physics


def _bench_solvers(grid):
    flux, eig = jel.elastic3d_heterogeneous()
    kw = dict(predictor_mode="ck", ck_material_slots=(9, 10, 11),
              dissipation_mask=(1,) * 9 + (0, 0, 0))
    js = JaxSolver(dim=3, order=3, n_vars=12, grid_shape=grid,
                   flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
                   dx=1.0 / grid[0], **kw)
    tf, te = elastic.elastic3d_heterogeneous()
    ts = ADERDGSolver(3, 3, 12, grid, tf, te, dx=1.0 / grid[0], device="cpu", **kw)
    return js, ts


def bench_recipe(js):
    """``bench.py:176-200``, verbatim, on the JAX solver."""
    grid = js.grid_shape
    coords = js.nodes_meshgrid()
    no_var = js.state_shape[: js.var_axis] + js.state_shape[js.var_axis + 1:]
    X = np.broadcast_to(np.squeeze(np.asarray(coords[0]), js.var_axis), no_var)
    Z = np.broadcast_to(np.squeeze(np.asarray(coords[2]), js.var_axis), no_var)
    wave = np.moveaxis(jel.plane_p_wave_3d(X, 0.0), -1, js.var_axis)
    lower = Z < 0.5 * grid[2] / grid[0]
    mat = np.stack([np.where(lower, 1.2, 1.0), np.where(lower, 3.0, 2.0),
                    np.where(lower, 1.5, 1.0)], axis=js.var_axis)
    return np.concatenate([wave, mat], axis=js.var_axis), mat


@pytest.mark.parametrize("grid", [(8, 2, 4), (64, 4, 32)])
def test_two_layer_state_is_the_bench_recipe(grid):
    js, ts = _bench_solvers(grid)
    ref, ref_mat = bench_recipe(js)
    got, mat = elastic.two_layer_state(ts)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(mat, ref_mat)
    # Both layers are present.
    assert set(np.unique(mat[:, :, :, 0])) == {1.0, 1.2}


def test_seismic_energy_is_the_bench_reading():
    """``bench.py:224-250``'s energy (the materials passed in) on a state
    the solver has stepped, so all 9 wave rows are non-zero."""
    js, ts = _bench_solvers((8, 2, 4))
    Q, mat = bench_recipe(js)
    Q = np.array(js.step(jnp.asarray(Q), 1e-3))
    va = js.var_axis

    def vslice(q, lo, hi):
        return q[tuple(slice(lo, hi) if e == va else slice(None) for e in range(q.ndim))]

    rho_m, lam_m, mu_m = (np.take(mat, k, axis=va) for k in range(3))
    v2 = np.sum(np.expand_dims(rho_m, va) * vslice(Q, 0, 3) ** 2, axis=va)
    diag, off = vslice(Q, 3, 6), vslice(Q, 6, 9)
    s_dd = np.sum(diag**2, axis=va) + 2.0 * np.sum(off**2, axis=va)
    trs = np.sum(diag, axis=va)
    ref = np.sum(v2 + (s_dd - lam_m / (3 * lam_m + 2 * mu_m) * trs**2) / (2.0 * mu_m))
    got = elastic.seismic_energy(torch.from_numpy(Q), va, torch.from_numpy(mat))
    own = elastic.seismic_energy(torch.from_numpy(Q), va)
    np.testing.assert_allclose(float(got), ref, rtol=1e-13, atol=0)
    assert float(got) == float(own)  # the state's own materials are the same
