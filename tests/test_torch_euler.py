"""Euler physics parity: the port's SoA-P flux and eigenvalue against the
JAX package's ``flux_tpu`` / ``max_eigenvalue_tpu``.

Every ``var_axis`` the solver uses is covered: ``dim - 1`` (face arrays),
``dim`` (states) and ``dim + 1`` (space-time arrays).  f64 at the repo's
JAX↔Pallas bar (rtol=0, atol=1e-12); f32 at atol=1e-5, since the fluxes
reach |F| ≈ 10 here and f32 rounds at 2⁻²⁴ ≈ 6e-8 relative, a few ulp of
which differ between the two frameworks' evaluation orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import euler as jeuler
from exahype_tpu_torch.models import euler as teuler

torch.set_num_threads(1)


def _state(dim, var_axis, seed, n_vars):
    """Random admissible Euler states with the var axis at ``var_axis``."""
    rng = np.random.default_rng(seed)
    shape = [3] * var_axis + [2, 5]  # nodes before the var axis, cells after
    rho = 0.5 + rng.random(shape)
    vel = [rng.standard_normal(shape) for _ in range(dim)]
    p = 0.5 + rng.random(shape)
    kin = sum(v * v for v in vel)
    comps = [rho] + [rho * v for v in vel] + [p / 0.4 + 0.5 * rho * kin]
    comps += [rng.random(shape) for _ in range(n_vars - dim - 2)]
    return np.stack(comps, axis=var_axis)


CASES = [
    (dim, va, n)
    for dim in (2, 3)
    for va in (dim - 1, dim, dim + 1)
    for n in range(dim)
]


@pytest.mark.parametrize("dim,var_axis,normal", CASES)
def test_flux_and_eigenvalue_f64(dim, var_axis, normal):
    n_real = dim + 3  # one passive slot: the zero-padding path
    Q = _state(dim, var_axis, seed=10 * dim + var_axis, n_vars=n_real)
    ref_f = jeuler.flux_tpu(
        jnp.asarray(Q), normal, dim=dim, n_real=n_real, var_axis=var_axis
    )
    got_f = teuler.flux(
        torch.from_numpy(Q), normal, dim=dim, n_real=n_real, var_axis=var_axis
    )
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f), rtol=0, atol=1e-12)
    ref_e = jeuler.max_eigenvalue_tpu(
        jnp.asarray(Q), normal, dim=dim, var_axis=var_axis
    )
    got_e = teuler.max_eigenvalue(
        torch.from_numpy(Q), normal, dim=dim, var_axis=var_axis
    )
    assert got_e.shape == ref_e.shape
    np.testing.assert_allclose(got_e.numpy(), np.asarray(ref_e), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_flux_and_eigenvalue_f32(dim):
    for var_axis in (dim - 1, dim, dim + 1):
        Q = _state(dim, var_axis, seed=dim, n_vars=dim + 2).astype(np.float32)
        for normal in range(dim):
            ref_f = np.asarray(jeuler.flux_tpu(
                jnp.asarray(Q), normal, dim=dim, n_real=dim + 2,
                var_axis=var_axis,
            ))
            got_f = teuler.flux(
                torch.from_numpy(Q), normal, dim=dim, n_real=dim + 2,
                var_axis=var_axis,
            ).numpy()
            assert got_f.dtype == np.float32
            np.testing.assert_allclose(got_f, ref_f, rtol=0, atol=1e-5)
            ref_e = np.asarray(jeuler.max_eigenvalue_tpu(
                jnp.asarray(Q), normal, dim=dim, var_axis=var_axis
            ))
            got_e = teuler.max_eigenvalue(
                torch.from_numpy(Q), normal, dim=dim, var_axis=var_axis
            ).numpy()
            np.testing.assert_allclose(got_e, ref_e, rtol=0, atol=1e-5)
