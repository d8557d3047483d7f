"""The port's Z4 algebra and system (``exahype_tpu_torch/models/z4.py``)
against the JAX package's (``exahype_tpu/models/z4.py``) on the same
seeded NumPy inputs, in f64.

The component-unrolled right-hand side is held to the JAX ``z4_rhs_soa``
and to the einsum ``z4_rhs`` (the validated oracle) at 1e-13, as
``tests/test_z4.py::test_soa_rhs_matches_einsum_rhs`` holds the two JAX
forms; the callbacks, states and constraint monitor at 1e-13 too (the same
arithmetic; only ``torch.einsum``'s contraction order may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import z4 as jz
from exahype_tpu_torch.models import z4 as tz
from exahype_tpu_torch.models.aderdg import PhysicsTag

torch.set_num_threads(1)

ATOL = 1e-13

#: The three parameter families of ``test_soa_rhs_matches_einsum_rhs``.
FAMILIES = [
    dict(),
    dict(slicing="1+log", kappa1=0.3, kappa2=0.2),
    dict(f=0.7, m=1.5, kappa1=0.1),
]


def _state(rng, lead):
    """A perturbed flat state, var-last ``[*lead, 38]`` (α, γ near 1)."""
    q = rng.standard_normal(lead + (tz.N_VARS,)) * 0.1
    q[..., 0] += 1.0
    q[..., 1] += 1.0
    q[..., 4] += 1.0
    q[..., 6] += 1.0
    return q


@pytest.mark.parametrize("kw", FAMILIES, ids=["harmonic", "1+log_damped", "f_m_kappa"])
def test_soa_rhs_matches_jax_soa_and_einsum(kw):
    rng = np.random.default_rng(12)
    q = _state(rng, (4, 5))
    dq3 = rng.standard_normal((4, 5, 3, tz.N_VARS)) * 0.1
    ref_einsum = np.asarray(jz.z4_rhs(jnp.asarray(q), jnp.asarray(dq3), **kw))
    ref_soa = np.asarray(jz.z4_rhs_soa(jnp.asarray(q), jnp.asarray(dq3), **kw))
    got = tz.z4_rhs_soa(torch.from_numpy(q), torch.from_numpy(dq3), **kw).numpy()
    np.testing.assert_allclose(got, ref_soa, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ref_einsum, rtol=0, atol=ATOL)


def test_soa_rhs_is_affine_in_the_derivatives():
    """The solver's split rests on it: rhs(q, a+b) − rhs(q, 0) = Σ parts."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_state(rng, (6,)))
    da = torch.from_numpy(rng.standard_normal((6, 3, tz.N_VARS)) * 0.1)
    db = torch.from_numpy(rng.standard_normal((6, 3, tz.N_VARS)) * 0.1)
    zero = torch.zeros_like(da)
    r = lambda d: tz.z4_rhs_soa(q, d)  # noqa: E731
    lhs = r(da + db) - r(zero)
    rhs = (r(da) - r(zero)) + (r(db) - r(zero))
    assert (lhs - rhs).abs().max().item() <= 1e-13


@pytest.mark.parametrize("kw", FAMILIES[:2], ids=["harmonic", "1+log_damped"])
def test_system_callbacks_match_jax_soa_system(kw):
    """Wave speed, source and NCP on a face-shaped SoA-P array (var axis 2)
    against the JAX ``z4_system(impl="soa")``."""
    rng = np.random.default_rng(5)
    q = np.moveaxis(_state(rng, (3, 3, 2, 2, 4)), -1, 2)  # [3, 3, V, 2, 2, 4]
    dq = np.moveaxis(rng.standard_normal((3, 3, 2, 2, 4, tz.N_VARS)) * 0.1, -1, 2)
    j_flux, j_eig, j_ncp, j_src = jz.z4_system(impl="soa", **kw)
    t_flux, t_eig, t_ncp, t_src = tz.z4_system(impl="soa", **kw)
    Q, dQ = torch.from_numpy(q), torch.from_numpy(dq)
    assert not t_flux(Q, 0, 2).any() and t_flux(Q, 0, 2).shape == Q.shape
    np.testing.assert_allclose(
        t_src(Q, 2).numpy(), np.asarray(j_src(jnp.asarray(q), 2)), rtol=0, atol=ATOL
    )
    for axis in range(3):
        np.testing.assert_allclose(
            t_eig(Q, axis, 2).numpy(), np.asarray(j_eig(jnp.asarray(q), axis, 2)),
            rtol=0, atol=ATOL,
        )
        np.testing.assert_allclose(
            t_ncp(Q, dQ, axis, 2).numpy(),
            np.asarray(j_ncp(jnp.asarray(q), jnp.asarray(dq), axis, 2)),
            rtol=0, atol=ATOL,
        )


def test_callbacks_carry_the_z4_tag():
    fns = tz.z4_system(slicing="1+log", f=1.0, m=1.5, kappa1=0.3, kappa2=0.2, impl="soa")
    tag = PhysicsTag("z4", 3, 38, ("1+log", 1.0, 1.5, 0.3, 0.2))
    assert all(fn.physics == tag for fn in fns)
    solver = tz.make_z4_solver(3, 2, (2, 2, 2), impl="soa", fused_rhs="soa",
                               slicing="1+log", m=1.5, kappa1=0.3, kappa2=0.2, device="cpu")
    assert solver.rhs_all_fn.physics == tag
    assert solver.n_vars == tz.N_VARS and solver.flux_fn.physics == tag


def test_inv3_matches_jax_and_numpy():
    rng = np.random.default_rng(7)
    m = rng.standard_normal((5, 4, 3, 3)) + 3.0 * np.eye(3)
    inv_t, det_t = tz.inv3(torch.from_numpy(m))
    inv_j, det_j = jz.inv3(jnp.asarray(m))
    np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv_j))
    np.testing.assert_array_equal(det_t.numpy(), np.asarray(det_j))
    np.testing.assert_allclose(inv_t.numpy(), np.linalg.inv(m), rtol=0, atol=1e-13)
    np.testing.assert_allclose(det_t.numpy(), np.linalg.det(m), rtol=1e-13, atol=0)


def test_sym_pack_roundtrip_matches_jax():
    rng = np.random.default_rng(8)
    s = rng.standard_normal((4, 6))
    np.testing.assert_array_equal(
        tz.sym_to_mat(torch.from_numpy(s)).numpy(), np.asarray(jz.sym_to_mat(jnp.asarray(s)))
    )
    m = rng.standard_normal((4, 3, 3))
    np.testing.assert_array_equal(
        tz.mat_to_sym(torch.from_numpy(m)).numpy(), np.asarray(jz.mat_to_sym(jnp.asarray(m)))
    )


def test_states_match_jax():
    x = np.linspace(0.0, 1.0, 17)
    np.testing.assert_array_equal(
        tz.gauge_wave_values(x, 0.3, 0.1, 0.5), jz.gauge_wave_values(x, 0.3, 0.1, 0.5)
    )
    np.testing.assert_array_equal(tz.flat_state_values(), jz.flat_state_values())
    js = jz.make_z4_solver(dim=3, order=2, grid_shape=(4, 2, 4), dx=0.25, impl="soa")
    ts = tz.make_z4_solver(3, 2, (4, 2, 4), dx=0.25, impl="soa", device="cpu")
    for t in (0.0, 0.37):
        got = tz.gauge_wave_state(ts, t=t, amplitude=0.1)
        assert got.dtype == torch.float64 and got.is_contiguous()
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jz.gauge_wave_state(js, t=t, amplitude=0.1))
        )
    np.testing.assert_array_equal(tz.z4_flat_state(ts).numpy(), np.asarray(jz.z4_flat_state(js)))
    f32 = tz.make_z4_solver(3, 2, (4, 2, 4), dx=0.25, impl="soa", device="cpu",
                            dtype=torch.float32)
    assert tz.gauge_wave_state(f32).dtype == torch.float32


def test_adm_constraints_match_jax():
    rng = np.random.default_rng(9)
    q = _state(rng, (4, 3))
    dq3 = rng.standard_normal((4, 3, 3, tz.N_VARS)) * 0.1
    H_t, M_t = tz.adm_constraints(torch.from_numpy(q), torch.from_numpy(dq3))
    H_j, M_j = jz.adm_constraints(jnp.asarray(q), jnp.asarray(dq3))
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("dim,grid", [(3, (4, 2, 4)), (2, (4, 2))])
def test_solver_constraints_match_jax(dim, grid):
    """On a perturbed gauge wave (the exact one satisfies both constraints
    to rounding), 3-D and 2-D (missing axis zero-filled)."""
    js = jz.make_z4_solver(dim=dim, order=2, grid_shape=grid, dx=0.25, impl="soa")
    ts = tz.make_z4_solver(dim, 2, grid, dx=0.25, impl="soa", device="cpu")
    Q = np.asarray(jz.gauge_wave_state(js, amplitude=0.1))
    Q = Q + 1e-3 * np.random.default_rng(10).standard_normal(Q.shape)
    H_t, M_t = tz.solver_constraints(ts, torch.from_numpy(Q))
    H_j, M_j = jz.solver_constraints(js, jnp.asarray(Q))
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), rtol=0, atol=1e-12)
    assert np.abs(np.asarray(H_j)).max() > 1e-3  # the perturbation shows
