"""The coupled Z4+GRMHD system (``exahype_tpu_torch/models/z4_grmhd.py`` and
its recovery ``models/rmhd.py``) against the JAX package's on the CPU in
f64: the recovery and its hand-written Newton derivative, the right-hand
side, the four callbacks and their tag, the states, one and two steps, the
crossings from JAX, the CUDA routes on CPU tensors, the refusals, the
zero-field reduction to Z4+GRHD, the conservation of D̃ and B̃, and the
float32 zero-field caveat of the reference.

Inputs are made from seeds with NumPy.  The bar is 1e-12·max(1, max|JAX|)
unless said: the algebra is held to the JAX ``z4_grmhd_rhs_soa`` (the same
operations in the same order) and to the einsum ``z4_grmhd_rhs`` (a
rounding apart: the vector Newton on the proxy state against the scalar
one).  The steps are ``make_z4_grmhd_solver(3, 2, (2, 2, 4), dx=0.25)`` on
a magnetized fluid with a velocity field over a noisy metric, with seeded
noise on every slot, so that every flux row, matter term and source is live.
The JAX steps run once per module.

The chain to the TPU kernels: ``tests/test_rhs_pallas.py:139`` holds the
JAX ``PallasRHS`` on this system to the same algebra; one fused step here
is held to ``with_pallas_rhs(interpret=True)``.  The CUDA kernels are held
to these plain stages on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import rmhd as jr
from exahype_tpu.models import z4_grmhd as jg
from exahype_tpu.models import z4_matter as jm
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu.models.rhs_pallas import with_pallas_rhs
from exahype_tpu.models.z4 import make_z4_shift_solver as j_make_z4_shift_solver
from exahype_tpu.models.z4 import make_z4_solver as j_make_z4_solver
from exahype_tpu_torch.convert import (
    state_from_numpy,
    state_to_numpy,
    z4_grmhd_solver_from_jax,
    z4_matter_solver_from_jax,
    z4_shift_solver_from_jax,
    z4_solver_from_jax,
)
from exahype_tpu_torch.models import rmhd as tr
from exahype_tpu_torch.models import z4_grmhd as tg
from exahype_tpu_torch.models import z4_matter as tm
from exahype_tpu_torch.models.aderdg import ADERDGSolver, PhysicsTag
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.rhs_cuda import CudaRHS, with_cuda_rhs
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError

torch.set_num_threads(1)

GRID = (2, 2, 4)
DX = 0.25
DT = 1e-3

#: The families: the chip path's gauge and cleaning (harmonic, f = 0, Γ =
#: 5/3, 20 Newton trips, c_h = 1, κ = 0.5), and the algebra's other
#: branches (1+log slicing, m ≠ 2, κ₁, κ₂ damping, Γ = 4/3, 7 Newton trips,
#: c_h = 0.8, κ = 2).
FAMILIES = [
    dict(slicing="harmonic", f=0.0, glm_kappa=0.5),
    dict(slicing="1+log", m=1.5, kappa1=0.1, kappa2=0.3, gamma=4.0 / 3.0, iters=7, c_h=0.8,
         glm_kappa=2.0),
]
FAMILY_IDS = ["path_gauge", "1+log_damped"]
#: The steps held to JAX: (family, fused_rhs, with the Pallas-interpret step).
STEP_CASES = [(0, "soa", True), (1, "soa", False), (0, False, False)]
STEP_IDS = ["path_gauge_fused", "1+log_fused", "path_gauge_per_axis"]
DEFAULTS = dict(slicing="harmonic", f=1.0, m=2.0, kappa1=0.0, kappa2=0.0, gamma=5.0 / 3.0,
                iters=20, c_h=1.0, glm_kappa=0.0)
#: The rhs's keywords of a family (the flux's c_h is not one of them).
RHS_KEYS = ("slicing", "f", "m", "kappa1", "kappa2", "gamma", "iters", "glm_kappa")


def _bar(ref):
    return 1e-12 * max(1.0, float(np.abs(ref).max()))


def _rhs_kw(kw):
    return {k: v for k, v in kw.items() if k in RHS_KEYS}


def _prims(rng, lead, vel=0.3, B_scale=0.3):
    """Seeded primitives ``(z4_vals [*lead, 38], rho, v_low, p, B_up)``: a
    metric with noise of 0.05 on every Z4 slot, ρ, p ~ 1, velocities up to
    ``vel`` a component and a field of ``B_scale`` (float64 NumPy)."""
    z4 = 0.05 * rng.standard_normal(lead + (38,))
    z4[..., [0, 1, 4, 6]] += 1.0
    rho = 1.0 + 0.1 * rng.random(lead)
    p = 1.0 + 0.1 * rng.random(lead)
    v = 2 * vel * (rng.random(lead + (3,)) - 0.5)
    B = B_scale * rng.standard_normal(lead + (3,))
    return z4, rho, v, p, B


def _state(rng, lead, **kw):
    """A var-last ``[*lead, 47]`` coupled state: :func:`_prims` packed by the
    JAX ``pack_matter_mhd``, with a GLM scalar of 0.1 (float64 NumPy)."""
    z4, rho, v, p, B = _prims(rng, lead, **kw)
    psi = 0.1 * rng.standard_normal(lead)
    return np.array(jg.pack_matter_mhd(*(jnp.asarray(x) for x in (z4, rho, v, p, B)),
                                       psi_glm=jnp.asarray(psi)))


def _port(fused_rhs="soa", grid=GRID, **kw):
    return tg.make_z4_grmhd_solver(3, 2, grid, dx=DX, fused_rhs=fused_rhs, device="cpu", **kw)


def _noisy(sol, seed=3, eps=1e-4):
    """A step state on ``sol``: :func:`_state` at every node, plus seeded
    noise of ``eps`` on every slot (float64 NumPy, SoA-P)."""
    rng = np.random.default_rng(seed)
    va = sol.var_axis
    q = _state(rng, sol.state_shape[:va] + sol.state_shape[va + 1:])
    q = np.moveaxis(q, -1, va)
    return q + eps * rng.standard_normal(q.shape)


def _flat_cases(rng, n=64):
    """Flat conserved RMHD states ``[n, 9]`` by regime: mild; a strong field
    (B² ≫ ρh, magnetization ~100); a high Lorentz factor (W up to ~10); the
    momentum along the field; across it (float64 NumPy, from the JAX
    ``prim_to_cons``)."""
    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    cases = {}
    rho, p = 1.0 + rng.random(n), 0.1 + rng.random(n)
    cases["mild"] = (rho, 0.5 * (rng.random((n, 3)) - 0.5), p, 0.3 * rng.standard_normal((n, 3)))
    cases["magnetized"] = (0.01 + 0.01 * rng.random(n), 0.3 * (rng.random((n, 3)) - 0.5),
                           0.01 + 0.01 * rng.random(n), 1.0 + rng.standard_normal((n, 3)))
    speed = np.sqrt(1.0 - 1.0 / (1.0 + 99.0 * rng.random(n)))  # W up to 10
    cases["high_W"] = (rho, unit(rng.standard_normal((n, 3))) * speed[:, None], p,
                       0.5 * rng.standard_normal((n, 3)))
    b = unit(rng.standard_normal((n, 3)))
    cases["S_parallel_B"] = (rho, 0.6 * rng.random(n)[:, None] * b, p,
                             (0.2 + rng.random(n))[:, None] * b)
    w = unit(np.cross(b, rng.standard_normal((n, 3))))
    cases["S_perp_B"] = (rho, 0.6 * rng.random(n)[:, None] * w, p,
                         (0.2 + rng.random(n))[:, None] * b)
    return cases


def _aligned(Q):
    """(D, S_∥, S_⊥, τ, |B|) of flat conserved states (float64 NumPy)."""
    S, B = Q[:, 1:4], Q[:, 5:8]
    Bmag = np.linalg.norm(B, axis=-1)
    S_par = (S * B).sum(-1) / Bmag
    S_perp = np.sqrt(np.maximum((S * S).sum(-1) - S_par**2, 0.0))
    return Q[:, 0], S_par, S_perp, Q[:, 4], Bmag


# ---------------------------------------------------------------- the recovery


@pytest.mark.parametrize("regime", ["mild", "magnetized", "high_W", "S_parallel_B",
                                    "S_perp_B"])
def test_con2prim_matches_jax_in_hard_and_mild_regimes(regime):
    """``prim_to_cons``, ``con2prim`` and ``con2prim_scalar`` against the
    JAX ``rmhd`` at 1e-12 of the largest value, at two (Γ, iters); with 40
    trips the recovery lands on the primitives it was built from."""
    rho, v, p, B = _flat_cases(np.random.default_rng(7))[regime]
    for gamma, iters in ((5.0 / 3.0, 20), (4.0 / 3.0, 40)):
        Qj = np.array(jr.prim_to_cons(*(jnp.asarray(x) for x in (rho, v, p, B)), gamma=gamma))
        Qt = tr.prim_to_cons(*(torch.from_numpy(x) for x in (rho, v, p, B)),
                             gamma=gamma).numpy()
        np.testing.assert_allclose(Qt, Qj, rtol=0, atol=_bar(Qj))
        ref = [np.asarray(x) for x in jr.con2prim(jnp.asarray(Qj), gamma=gamma, iters=iters)]
        got = [x.numpy() for x in tr.con2prim(torch.from_numpy(Qj), gamma=gamma, iters=iters)]
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=0, atol=_bar(b), err_msg=regime)
        parts = _aligned(Qj)
        ref = [np.asarray(x) for x in jr.con2prim_scalar(*(jnp.asarray(x) for x in parts),
                                                          gamma=gamma, iters=iters)]
        got = [x.numpy() for x in tr.con2prim_scalar(*(torch.from_numpy(x) for x in parts),
                                                      gamma=gamma, iters=iters)]
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=0, atol=_bar(b), err_msg=regime)
        if iters == 40:
            np.testing.assert_allclose(got[0], rho, rtol=1e-9, err_msg=regime)
            np.testing.assert_allclose(got[1], p, rtol=1e-9, err_msg=regime)


def test_con2prim_keeps_nan_and_the_floor():
    """A NaN input gives NaN out (``torch.maximum`` as ``jnp.maximum``), in
    both forms; a cold state (τ = 0, no field) and an empty one keep the
    floors as the JAX package does."""
    Q = np.array([[1.0, np.nan, 0.0, 0.0, 0.5, 0.1, 0.0, 0.0, 0.0],
                  [1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  [1.0, 0.1, 0.0, 0.0, 0.5, 0.2, 0.0, np.nan, 0.0]])
    ref = [np.asarray(x) for x in jr.con2prim(jnp.asarray(Q))]
    got = [x.numpy() for x in tr.con2prim(torch.from_numpy(Q))]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], rtol=0, atol=1e-15)
    assert np.isnan(got[2][0]).all() and np.isnan(got[2][3]).all()
    assert np.isfinite(got[2][1]) and abs(got[2][1]) < 1e-11  # the cold state: p ~ 0
    D, S_par, S_perp, tau, Bmag = (np.array([1.0, 1.0, np.nan]), np.array([np.nan, 0.0, 0.1]),
                                   np.zeros(3), np.array([0.5, 0.0, 0.5]), np.full(3, 0.1))
    ref = [np.asarray(x) for x in jr.con2prim_scalar(
        *(jnp.asarray(x) for x in (D, S_par, S_perp, tau, Bmag)))]
    got = [x.numpy() for x in tr.con2prim_scalar(
        *(torch.from_numpy(x) for x in (D, S_par, S_perp, tau, Bmag)))]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], rtol=0, atol=1e-15)
    assert np.isnan(got[1][[0, 2]]).all() and np.isfinite(got[1][1])


@pytest.mark.parametrize("where", ["interior", "clip_binds"])
def test_newton_derivative_matches_autograd(where):
    """The hand-written tangent of the residual (``rmhd._resid``, as
    ``csrc/rmhd.cuh`` writes it) against ``torch.func.jvp`` of its value
    at the same z: equal to rounding inside the clip, and zero-slope in
    v² where the clip binds (v² > 1 − 1e-12: the slope is then that of the
    other terms only)."""
    rng = np.random.default_rng(4)
    n = 256
    if where == "interior":
        rho, v, p, B = _flat_cases(rng, n)["high_W"]
    else:  # momentum beyond what any z near D carries: v²(z) clips at 1
        rho, v, p, B = _flat_cases(rng, n)["mild"]
    Q = np.array(jr.prim_to_cons(*(jnp.asarray(x) for x in (rho, v, p, B))))
    D, S_par, S_perp, tau, Bmag = (torch.from_numpy(x) for x in _aligned(Q))
    S2 = S_par * S_par + S_perp * S_perp
    B2 = Bmag * Bmag
    sB = S_par * Bmag
    E = tau + D
    if where == "interior":
        z = torch.from_numpy(np.asarray(Q[:, 4] + Q[:, 0])) * (1.0 + 0.1 * torch.rand(
            n, dtype=torch.float64, generator=torch.Generator().manual_seed(0)))
    else:
        S2 = S2 * 1e4  # |S| ≫ z: the ratio far above 1
        z = D * 1.01
    f, df, W, p_ = tr._resid(z, torch.ones_like(z), S2, B2, sB, D, E, 5.0 / 3.0)
    value, slope = torch.func.jvp(
        lambda zz: tr._resid(zz, torch.ones_like(zz), S2, B2, sB, D, E, 5.0 / 3.0)[0],
        (z,), (torch.ones_like(z),))
    assert torch.equal(value, f)
    assert torch.isfinite(df).all()
    np.testing.assert_allclose(df.numpy(), slope.numpy(), rtol=1e-12, atol=1e-14)
    if where == "clip_binds":
        assert (W > 1e5).all()  # v² at 1 − 1e-12


def test_recover_and_stress_energy_match_jax():
    q = _state(np.random.default_rng(2), (5, 3))
    for a, b in zip(tg.recover(torch.from_numpy(q), gamma=1.4, iters=12),
                    jg.recover(jnp.asarray(q), gamma=1.4, iters=12)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=_bar(np.asarray(b)))
    for a, b in zip(tg.stress_energy(torch.from_numpy(q)), jg.stress_energy(jnp.asarray(q))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=_bar(np.asarray(b)))


# ---------------------------------------------------------------- the algebra


@pytest.mark.parametrize("kw", FAMILIES, ids=FAMILY_IDS)
def test_grmhd_rhs_matches_jax_soa_and_einsum(kw):
    rng = np.random.default_rng(21)
    q = _state(rng, (3, 4))
    dq3 = rng.standard_normal((3, 4, 3, tg.N_VARS)) * 0.1
    rkw = _rhs_kw(kw)
    ref_soa = np.asarray(jg.z4_grmhd_rhs_soa(jnp.asarray(q), jnp.asarray(dq3), **rkw))
    ref_einsum = np.asarray(jg.z4_grmhd_rhs(jnp.asarray(q), jnp.asarray(dq3), **rkw))
    got = tg.z4_grmhd_rhs_soa(torch.from_numpy(q), torch.from_numpy(dq3), **rkw).numpy()
    assert got.shape == (3, 4, 47)
    np.testing.assert_allclose(got, ref_soa, rtol=0, atol=_bar(ref_soa))
    np.testing.assert_allclose(got, ref_einsum, rtol=0, atol=_bar(ref_einsum))
    assert not got[..., 38].any() and not got[..., 43:46].any()  # D̃, B̃: no source
    assert np.abs(got[..., 39:43]).min() > 0  # the momentum and energy sources are live
    np.testing.assert_array_equal(got[..., 46], -kw["glm_kappa"] * q[..., 0] * q[..., 46])


def test_grmhd_rhs_is_affine_and_reads_no_matter_gradient():
    """rhs(q, a+b) − rhs(q, 0) = Σ parts; the gradient slots the algebra
    reads are the core's 7-37 (the rows the CUDA predictor stages,
    ``csrc/aderdg_z4.cuh::Z4Grmhd``), never a matter slot's; every state
    slot is read."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_state(rng, (6,)))
    da, db = (torch.from_numpy(rng.standard_normal((6, 3, 47)) * 0.1) for _ in range(2))
    zero = torch.zeros_like(da)
    r = lambda d: tg.z4_grmhd_rhs_soa(q, d, **_rhs_kw(FAMILIES[1]))  # noqa: E731
    assert ((r(da + db) - r(zero)) - ((r(da) - r(zero)) + (r(db) - r(zero)))).abs().max() <= 1e-13
    dq3 = torch.zeros(47, 3, 47, dtype=torch.float64)
    for s in range(47):
        dq3[s, :, s] = float("nan")
    out = tg.z4_grmhd_rhs_soa(q[:1].expand(47, 47), dq3)
    assert torch.isnan(out).any(dim=-1).nonzero().flatten().tolist() == list(range(7, 38))
    qn = q[:1].expand(47, 47).clone()
    qn[range(47), range(47)] = float("nan")
    assert torch.isnan(tg.z4_grmhd_rhs_soa(qn, torch.zeros(47, 3, 47, dtype=torch.float64))
                       ).any(dim=-1).all()


@pytest.mark.parametrize("kw", FAMILIES, ids=FAMILY_IDS)
def test_system_callbacks_match_jax(kw):
    """Flux, wave speed, source and NCP on a face-shaped SoA-P array (var
    axis 2) against the JAX ``z4_grmhd_system(impl="soa")``."""
    rng = np.random.default_rng(5)
    q = np.moveaxis(_state(rng, (3, 3, 2, 2, 2)), -1, 2)
    dq = np.moveaxis(rng.standard_normal((3, 3, 2, 2, 2, 47)) * 0.1, -1, 2)
    j_flux, j_eig, j_ncp, j_src = jg.z4_grmhd_system(impl="soa", **kw)
    t_flux, t_eig, t_ncp, t_src = tg.z4_grmhd_system(**kw)
    Q, dQ = torch.from_numpy(q), torch.from_numpy(dq)
    ref = np.asarray(j_src(jnp.asarray(q), 2))
    np.testing.assert_allclose(t_src(Q, 2).numpy(), ref, rtol=0, atol=_bar(ref))
    for axis in range(3):
        for t_fn, j_fn in ((t_flux, j_flux), (t_eig, j_eig)):
            ref = np.asarray(j_fn(jnp.asarray(q), axis, 2))
            got = t_fn(Q, axis, 2).numpy()
            np.testing.assert_allclose(got, ref, rtol=0, atol=_bar(ref))
        F = t_flux(Q, axis, 2).numpy()
        assert not F[:, :, :38].any() and np.abs(F[:, :, 38:]).min() > 0
        cone = {k: kw[k] for k in ("slicing", "f", "c_h") if k in kw}
        np.testing.assert_array_equal(tg.z4_grmhd_eig(Q, axis, 2, **cone).numpy(),
                                      t_eig(Q, axis, 2).numpy())
        ref = np.asarray(j_ncp(jnp.asarray(q), jnp.asarray(dq), axis, 2))
        np.testing.assert_allclose(t_ncp(Q, dQ, axis, 2).numpy(), ref, rtol=0, atol=_bar(ref))


def test_wave_speed_takes_the_cleaning_speed():
    """α max(cone, c_h): a cleaning speed above the cone sets the bound."""
    q = torch.from_numpy(np.moveaxis(_state(np.random.default_rng(6), (4,)), -1, 0))
    cone = tg.z4_grmhd_eig(q, 0, 0, c_h=0.0)
    fast = tg.z4_grmhd_eig(q, 0, 0, c_h=5.0)
    assert torch.equal(fast, q[0] * 5.0) and (cone < fast).all()


def test_callbacks_carry_the_z4_grmhd_tag():
    kw = dict(slicing="1+log", f=1.0, m=1.5, kappa1=0.3, kappa2=0.2, gamma=1.4, iters=12,
              c_h=0.7, glm_kappa=0.4)
    tag = PhysicsTag("z4_grmhd", 3, 47, ("1+log", 1.0, 1.5, 0.3, 0.2, 1.4, 12, 0.7, 0.4))
    assert all(fn.physics == tag for fn in tg.z4_grmhd_system(**kw))
    sol = _port(grid=(2, 2, 2), **kw)
    assert sol.rhs_all_fn.physics == tag and sol.n_vars == tg.N_VARS
    assert _port(fused_rhs=False, grid=(2, 2, 2)).rhs_all_fn is None


def test_admissibility_matches_jax():
    rng = np.random.default_rng(8)
    q = _state(rng, (4, 6))
    q[0, 0, 0] = -0.1  # a negative lapse
    q[1, 1, 38] = -1e-3  # a negative density
    q[2, 2, 4] = -1.0  # γ_yy < 0: a metric that is not positive definite
    q[3, 3, 44] = np.nan
    Q = np.moveaxis(q, -1, 1)
    got = tg.z4_grmhd_admissible()(torch.from_numpy(Q), 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jg.z4_grmhd_admissible()(jnp.asarray(Q), 1)))
    assert got.sum() == 20


# ---------------------------------------------------------------- the states


def test_states_match_jax():
    """``pack_matter_mhd`` against JAX's, and ``magnetized_wave_state`` on a
    unit-length axis 0 against the JAX test's own wave
    (``tests/test_z4_grmhd.py::_magnetized_wave_state``)."""
    from test_z4_grmhd import _magnetized_wave_state

    rng = np.random.default_rng(4)
    z4, rho, v, p, B = _prims(rng, (2, 3))
    psi = rng.standard_normal((2, 3))
    ref = np.asarray(jg.pack_matter_mhd(*(jnp.asarray(x) for x in (z4, rho, v, p, B)),
                                        gamma=1.4, psi_glm=jnp.asarray(psi)))
    got = tg.pack_matter_mhd(*(torch.from_numpy(x) for x in (z4, rho, v, p, B)), gamma=1.4,
                             psi_glm=torch.from_numpy(psi)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_bar(ref))
    js = jg.make_z4_grmhd_solver(dim=3, order=2, grid_shape=(4, 2, 2), dx=0.25, impl="soa")
    ts = _port(fused_rhs=False, grid=(4, 2, 2))
    got = tg.magnetized_wave_state(ts)
    assert got.dtype == torch.float64 and got.is_contiguous() and got.shape == ts.state_shape
    ref = np.asarray(_magnetized_wave_state(js))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_bar(ref))
    assert bool(tg.z4_grmhd_admissible()(got, ts.var_axis).all())


# ------------------------------------------------------------- steps vs JAX


@pytest.fixture(scope="module", params=range(len(STEP_CASES)), ids=STEP_IDS)
def jax_steps(request):
    """For one case: the JAX solver, the state, one and two chained JAX
    steps, and (the path's fused case) one step through
    ``with_pallas_rhs(interpret=True)``."""
    family, fused, pallas_step = STEP_CASES[request.param]
    kw = FAMILIES[family]
    js = jg.make_z4_grmhd_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa",
                                 fused_rhs=fused, **kw)
    Q = _noisy(_port(fused_rhs=False))
    one = np.asarray(js.step(jnp.asarray(Q), DT))
    two = np.asarray(js.step(jnp.asarray(one), DT))
    pallas = None
    if pallas_step:
        pallas = np.asarray(with_pallas_rhs(js, interpret=True).step(jnp.asarray(Q), DT))
    return kw, fused, js, Q, one, two, pallas


def test_one_and_two_steps_match_jax(jax_steps):
    kw, fused, js, Q, one, two, pallas = jax_steps
    sol = _port(fused_rhs=fused, **kw)
    u = state_from_numpy(Q, device="cpu")
    a = sol.step(u, DT)
    got = state_to_numpy(a)
    assert got.shape == js.state_shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, one, rtol=0, atol=_bar(one))
    np.testing.assert_allclose(state_to_numpy(sol.step(a, DT)), two, rtol=0, atol=_bar(two))
    assert np.abs(got - Q)[:, :, :, 38:].max() > 1e-6  # the matter moved
    if pallas is not None:
        np.testing.assert_allclose(got, pallas, rtol=0, atol=_bar(pallas))


@pytest.mark.parametrize("kw", FAMILIES, ids=FAMILY_IDS)
def test_cuda_routes_on_the_cpu_are_the_plain_solver_bitwise(kw):
    """``CudaADERDG`` and ``with_cuda_rhs`` over the fused solver on CPU
    tensors: their stages compose to the plain step bit for bit, and
    nothing launches."""
    sol = _port(**kw)
    u = state_from_numpy(_noisy(sol), device="cpu")
    cu = CudaADERDG(sol)
    assert cu.kernels == ("aderdg_predictor_volume_z4_grmhd", "aderdg_face_flux_z4_grmhd",
                          "aderdg_surface_update_z4_grmhd")
    assert cu.ncp and cu.walls is None and cu._physics_id == 6
    params = {**DEFAULTS, **kw}
    assert list(cu._params) == [0.0 if params["slicing"] == "harmonic" else 1.0, params["f"],
                                params["m"], params["kappa1"], params["kappa2"],
                                params["gamma"], params["iters"], params["c_h"],
                                params["glm_kappa"]]
    new_k, faces_k, fv_k = cu.predictor_volume(u, DT)
    new_p, faces_p, fv_p = sol.predictor_volume(u, DT)
    assert fv_k is None and torch.equal(new_k, new_p) and torch.equal(faces_k, faces_p)
    assert not faces_k[:, 2:, :, :38].any() and faces_k[:, 2:, :, 38:].any()
    stage_p = sol.face_surface(new_p, faces_p, DT)
    assert cu.face_surface(new_k, faces_k, DT) is new_k and torch.equal(new_k, stage_p)
    step = sol.step(u, DT)
    assert torch.equal(cu.step(u, DT), step) and torch.equal(step, stage_p)
    assert torch.equal(cu.run(u, 2, DT), sol.run(u, 2, DT))
    accel = with_cuda_rhs(sol)
    assert isinstance(accel.rhs_all_fn, CudaRHS)
    assert accel.rhs_all_fn.kernel == "rhs_all_z4_grmhd"
    assert accel.rhs_all_fn._args[-4:] == (params["gamma"], params["iters"], params["c_h"],
                                           params["glm_kappa"])
    assert torch.equal(accel.step(u, DT), step)
    assert cu.launches == {name: 0 for name in cu.kernels} and accel.rhs_all_fn.launches == 0


def test_crossings_from_jax(jax_steps):
    """``z4_grmhd_solver_from_jax``: the plain solver, ``with_pallas_rhs``
    (to ``with_cuda_rhs``) and ``PallasADERDG`` (to ``CudaADERDG``), the
    parameters and the state carried."""
    kw, fused, js, Q, one, *_ = jax_steps
    port = z4_grmhd_solver_from_jax(js, device="cpu", **kw)
    assert isinstance(port, ADERDGSolver) and port.n_vars == 47
    assert (port.rhs_all_fn is not None) == bool(fused)
    assert port.flux_fn.physics == tg._grmhd_tag(**{**DEFAULTS, **kw})
    assert (port.dim, port.order, port.grid_shape, port._dxs, port.picard_iters) == (
        js.dim, js.order, js.grid_shape, js._dxs, js.picard_iters)
    u = state_from_numpy(Q, device="cpu")
    np.testing.assert_allclose(state_to_numpy(port.step(u, DT)), one, rtol=0, atol=_bar(one))
    if not fused:
        return
    accel = z4_grmhd_solver_from_jax(with_pallas_rhs(js, interpret=True), device="cpu", **kw)
    assert isinstance(accel.rhs_all_fn, CudaRHS)
    assert accel.rhs_all_fn.kernel == "rhs_all_z4_grmhd"
    cu = z4_grmhd_solver_from_jax(PallasADERDG(js, interpret=True), device="cpu", **kw)
    assert isinstance(cu, CudaADERDG) and cu.kernels[0] == "aderdg_predictor_volume_z4_grmhd"
    for other in (accel, cu):
        assert torch.equal(other.step(u, DT), port.step(u, DT))


def test_converters_refuse_the_other_systems():
    js = jg.make_z4_grmhd_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa",
                                 fused_rhs="soa")
    with pytest.raises(SemanticError, match="needs 38 variables.*z4_grmhd_solver_from_jax"):
        z4_solver_from_jax(js, device="cpu")
    with pytest.raises(SemanticError, match="needs 53 variables.*z4_grmhd_solver_from_jax"):
        z4_shift_solver_from_jax(PallasADERDG(js, interpret=True), device="cpu")
    with pytest.raises(SemanticError, match="needs 43 variables.*z4_grmhd_solver_from_jax"):
        z4_matter_solver_from_jax(js, device="cpu")
    j38 = j_make_z4_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa", fused_rhs="soa")
    j43 = jm.make_z4_matter_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa",
                                   fused_rhs="soa")
    j53 = j_make_z4_shift_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa",
                                 fused_rhs="soa")
    for other in (j38, j43, j53, PallasADERDG(j43, interpret=True)):
        with pytest.raises(SemanticError, match="needs 47 variables.*z4_solver_from_jax, "
                                                "z4_shift_solver_from_jax or "
                                                "z4_matter_solver_from_jax"):
            z4_grmhd_solver_from_jax(other, device="cpu")


# ------------------------------------------------------- reductions and gates


def test_zero_field_reduces_to_z4_matter():
    """B̃ = φ̃ = 0: the first 43 rows of the right-hand side and of the
    fluxes are the port's Z4+GRHD system's at the JAX test's bars
    (``tests/test_z4_grmhd.py::test_zero_field_reduces_to_coupled_hydro``:
    the two recover through different Newtons, z against p), the field
    rows zero."""
    rng = np.random.default_rng(3)
    z4, rho, v, p, _ = _prims(rng, (32,))
    B0 = np.zeros((32, 3))
    Qm = tg.pack_matter_mhd(*(torch.from_numpy(x) for x in (z4, rho, v, p, B0)))
    Qh = tm.pack_matter(*(torch.from_numpy(x) for x in (z4, rho, v, p)))
    np.testing.assert_allclose(Qm[:, :43].numpy(), Qh.numpy(), rtol=1e-12, atol=1e-14)
    dq3 = torch.from_numpy(np.random.default_rng(5).uniform(-0.1, 0.1, (32, 3, 47)))
    r_m = tg.z4_grmhd_rhs_soa(Qm, dq3).numpy()
    r_h = tm.z4_matter_rhs_soa(Qh, dq3[..., :43]).numpy()
    np.testing.assert_allclose(r_m[:, :43], r_h, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(r_m[:, 43:], 0.0, atol=1e-12)
    for ax in range(3):
        f_m = tg.z4_grmhd_flux(Qm, ax, -1).numpy()
        f_h = tm.z4_matter_flux(Qh, ax, -1).numpy()
        np.testing.assert_allclose(f_m[:, :43], f_h, rtol=1e-7, atol=1e-10)
        np.testing.assert_array_equal(f_m[:, 43:], 0.0)


def test_zero_field_is_nan_in_float32_as_in_the_reference():
    """The reference's guards max(|B|, 1e-300) and max(v², 1e-300) are 0
    in float32, so a point with B̃ = 0 exactly recovers NaN there (0/0 in
    S_∥): the JAX package and the port alike; float64 recovers it
    (``ROADMAP.md``, Queue 3's reference caveats)."""
    rng = np.random.default_rng(9)
    z4, rho, v, p, _ = _prims(rng, (4,))
    q64 = np.array(jg.pack_matter_mhd(*(jnp.asarray(x) for x in (z4, rho, v, p,
                                                                  np.zeros((4, 3))))))
    dq3 = np.zeros((4, 3, 47))
    for dtype, jdtype in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        q = q64.astype(np.float32) if dtype == torch.float32 else q64
        ref = np.asarray(jg.z4_grmhd_rhs_soa(jnp.asarray(q, jdtype), jnp.asarray(dq3, jdtype)))
        got = tg.z4_grmhd_rhs_soa(torch.from_numpy(q), torch.from_numpy(dq3).to(dtype)).numpy()
        rho_j = np.asarray(jg.recover(jnp.asarray(q, jdtype))[0])
        rho_t = tg.recover(torch.from_numpy(q))[0].numpy()
        if dtype == torch.float32:
            assert np.isnan(ref[:, 39:43]).all() and np.isnan(got[:, 39:43]).all()
            assert np.isnan(rho_j).all() and np.isnan(rho_t).all()
        else:
            assert np.isfinite(ref).all() and np.isfinite(got).all()
            np.testing.assert_allclose(rho_t, rho, rtol=1e-9)
            np.testing.assert_allclose(rho_j, rho, rtol=1e-9)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))


def test_steps_conserve_the_density_and_the_field():
    """Three periodic steps of the magnetized wave (the JAX test's state,
    ``magnetized_wave_state`` on a unit axis 0) through the port's fused
    solver: ∫D̃ dV and each ∫B̃^i dV (pure flux form) kept to 1e-10 of
    1 + |∫|, the JAX test's bar; finite and admissible; the field moved."""
    sol = tg.make_z4_grmhd_solver(3, 2, (4, 2, 2), dx=0.25, slicing="harmonic", f=1.0,
                                  glm_kappa=0.5, fused_rhs="soa", device="cpu")
    Q = tg.magnetized_wave_state(sol)
    out = sol.run(Q, 3, 5e-4)
    assert torch.isfinite(out).all()
    assert bool(tg.z4_grmhd_admissible()(out, sol.var_axis).all())
    w = sol.weights
    w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(3, 3, 3, 1, 1, 1)
    for var in (38, 43, 44, 45):
        tot0 = float((Q[:, :, :, var] * w3).sum())
        tot1 = float((out[:, :, :, var] * w3).sum())
        assert abs(tot1 - tot0) < 1e-10 * (1.0 + abs(tot0)), (var, tot0, tot1)
    assert (out[:, :, :, 44] - Q[:, :, :, 44]).abs().max() > 1e-6  # B̃^y: −∂_x(−α B̃^x v^y)


# ------------------------------------------------------------ refusals


def test_refusals_name_their_roadmap_items():
    with pytest.raises(SemanticError, match="impl='einsum'.*Queue 1 item 7.4"):
        tg.make_z4_grmhd_solver(3, 2, GRID, dx=DX, impl="einsum", device="cpu")
    with pytest.raises(SemanticError, match="impl='einsum'.*Queue 1 item 7.4"):
        tg.z4_grmhd_system(impl="einsum")
    with pytest.raises(SemanticError, match="fused_rhs=True.*Queue 1 item 7.4"):
        _port(fused_rhs=True)
    # The per-axis NCP branch and the 2-D order-2 step are ported (K1 d.1,
    # tests/test_torch_z4_grmhd_per_axis.py and test_torch_z4_grmhd_2d.py).
    cu = CudaADERDG(_port(fused_rhs=False, grid=(2, 2, 2)))
    assert cu.per_axis and cu.kernels[0] == "aderdg_predictor_volume_per_axis_z4_grmhd"
    sol = _port(grid=(2, 2, 2), boundary="outflow", wall_axes=(0,))
    with pytest.raises(LoweringError, match="periodic only.*Queue 2 K1 d"):
        CudaADERDG(sol)
    with pytest.raises(LoweringError, match="with_cuda_rhs.*make_z4_grmhd_solver"):
        CudaADERDG(with_cuda_rhs(_port(grid=(2, 2, 2))))
    for dim, order in ((3, 3), (2, 3)):
        sol = tg.make_z4_grmhd_solver(dim, order, (2,) * dim, dx=DX, fused_rhs="soa",
                                      device="cpu")
        with pytest.raises(LoweringError,
                           match=f"z4_grmhd, dim={dim}, order={order}.*Queue 1 item 4"):
            CudaADERDG(sol)
    sol = tg.make_z4_grmhd_solver(2, 2, (4, 2), dx=DX, fused_rhs="soa", device="cpu")
    assert CudaADERDG(sol).kernels[0] == "aderdg_predictor_volume_2d_z4_grmhd"
    assert with_cuda_rhs(sol).rhs_all_fn.kernel == "rhs_all_z4_grmhd_2d"  # K5 b
    with pytest.raises(LoweringError, match="47 z4_grmhd variables, got dim=3, n_vars=43"):
        CudaRHS(_port(grid=(2, 2, 2)).rhs_all_fn, 3, 43)
    with pytest.raises(LoweringError, match="47-variable Z4\\+GRMHD"):
        CudaRHS(lambda Q, grads, va: Q, 3, 47)  # untagged
    with pytest.raises(LoweringError, match="Queue 2 K1 d"):  # two systems' callbacks
        sol = _port(grid=(2, 2, 2))
        sol.ncp_fn = tm.z4_matter_system()[2]
        CudaADERDG(sol)


@pytest.mark.parametrize(
    "bad,match",
    [
        (lambda q, g: (q, g[:2]), "expected 3 gradient arrays"),
        (lambda q, g: (q, (g[0], g[1][..., :1], g[2])), r"grads\[1\]"),
        (lambda q, g: (q, (g[0].reshape(-1).reshape(q.shape[::-1]), g[1], g[2])),
         r"grads\[0\]"),
    ],
    ids=["count", "shape", "same_size_other_shape"],
)
def test_cuda_rhs_refuses_mismatched_gradients(bad, match):
    """The refusal of a gradient that is not Q's shape (``PallasRHS``
    reshapes it silently; ROADMAP Queue 3 caveat), in this instance too."""
    sol = _port(grid=(2, 2, 2))
    q = torch.from_numpy(_noisy(sol))
    rng = np.random.default_rng(2)
    grads = tuple(torch.from_numpy(rng.standard_normal(q.shape)) for _ in range(3))
    q, grads = bad(q, grads)
    with pytest.raises(LoweringError, match=match):
        with_cuda_rhs(sol).rhs_all_fn(q, grads, 3)
