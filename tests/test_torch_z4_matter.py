"""The coupled Z4+GRHD system (``exahype_tpu_torch/models/z4_matter.py`` and
its recovery ``models/srhd.py``) against the JAX package's on the CPU in
f64: the recovery, the right-hand side, the four callbacks and their tag,
the states and the Friedmann reference, one and two steps, the crossings
from JAX, the CUDA routes on CPU tensors and the refusals; and the FLRW
anchor of ``examples/flrw_cosmology.py`` run by the port.

Inputs are made from seeds with NumPy.  The bar is 1e-12·max(1, max|JAX|)
unless said: the algebra is held to the JAX ``z4_matter_rhs_soa`` (the same
operations in the same order) and to the einsum ``z4_matter_rhs`` (a
rounding apart).  The steps are ``make_z4_matter_solver(3, 2, (2, 2, 4),
dx=0.25)`` on a fluid with a velocity field over the FLRW metric, with
seeded noise on every slot, so that every flux row, matter term and hydro
source is live (on the FLRW slice itself the fluid is at rest).  The JAX
steps run once per module.

The chain to the TPU kernels: ``tests/test_rhs_pallas.py:115`` holds the
JAX ``PallasRHS`` on this system to the same algebra; one fused step here
is held to ``with_pallas_rhs(interpret=True)``.  The CUDA kernels are held
to these plain stages on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import srhd as jsr
from exahype_tpu.models import z4_matter as jm
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu.models.rhs_pallas import with_pallas_rhs
from exahype_tpu.models.z4 import make_z4_solver as j_make_z4_solver
from exahype_tpu_torch.convert import (
    state_from_numpy,
    state_to_numpy,
    z4_matter_solver_from_jax,
    z4_shift_solver_from_jax,
    z4_solver_from_jax,
)
from exahype_tpu_torch.models import srhd as tsr
from exahype_tpu_torch.models import z4_matter as tm
from exahype_tpu_torch.models.aderdg import ADERDGSolver, PhysicsTag
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.rhs_cuda import CudaRHS, with_cuda_rhs
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError

torch.set_num_threads(1)

GRID = (2, 2, 4)
DX = 0.25
DT = 1e-3
RHO0, EPS0, GAMMA = 0.02, 0.4, 5.0 / 3.0

#: The families: ``examples/flrw_cosmology.py``'s gauge (harmonic, f = 0)
#: and the algebra's other branches (1+log slicing, m ≠ 2, κ damping, Γ =
#: 4/3, 7 Newton trips).
FAMILIES = [
    dict(slicing="harmonic", f=0.0),
    dict(slicing="1+log", m=1.5, kappa1=0.1, kappa2=0.3, gamma=4.0 / 3.0, iters=7),
]
FAMILY_IDS = ["flrw_gauge", "1+log_damped"]
#: The steps held to JAX: (family, fused_rhs).
STEP_CASES = [(0, "soa"), (1, "soa"), (0, False)]
STEP_IDS = ["flrw_gauge_fused", "1+log_fused", "flrw_gauge_per_axis"]
DEFAULTS = dict(slicing="harmonic", f=1.0, m=2.0, kappa1=0.0, kappa2=0.0, gamma=5.0 / 3.0,
                iters=10)


def _bar(ref):
    return 1e-12 * max(1.0, float(np.abs(ref).max()))


def _adot(rho0=RHO0, eps0=EPS0):
    return float(np.sqrt(8.0 * np.pi * rho0 * (1.0 + eps0) / 3.0))


def _state(rng, lead, vel=0.15, noise=0.05):
    """A var-last ``[*lead, 43]`` coupled state: the FLRW metric with noise
    of ``noise`` on every Z4 slot, and a fluid (ρ ≈ 0.02, p ≈ 0.005) with
    velocities up to ``vel`` a component (float64 NumPy)."""
    z4 = noise * rng.standard_normal(lead + (38,))
    z4[..., [0, 1, 4, 6]] += 1.0
    z4[..., [7, 10, 12]] -= _adot()
    rho = RHO0 * (1.0 + 0.1 * rng.random(lead))
    p = 0.005 * (1.0 + 0.1 * rng.random(lead))
    v = 2 * vel * (rng.random(lead + (3,)) - 0.5)
    return np.array(jm.pack_matter(jnp.asarray(z4), jnp.asarray(rho), jnp.asarray(v),
                                     jnp.asarray(p)))


def _port(fused_rhs="soa", grid=GRID, **kw):
    return tm.make_z4_matter_solver(3, 2, grid, dx=DX, fused_rhs=fused_rhs, device="cpu", **kw)


def _noisy(sol, seed=3, eps=1e-4):
    """A step state on ``sol``: :func:`_state` at every node, plus seeded
    noise of ``eps`` on every slot (float64 NumPy, SoA-P)."""
    rng = np.random.default_rng(seed)
    va = sol.var_axis
    q = _state(rng, sol.state_shape[:va] + sol.state_shape[va + 1:])
    q = np.moveaxis(q, -1, va)
    return q + eps * rng.standard_normal(q.shape)


# ---------------------------------------------------------------- the recovery


def test_con2prim_matches_jax_in_hard_and_mild_regimes():
    """``con2prim``/``con2prim_smag`` (and ``prim_to_cons``) against the JAX
    ``srhd`` at rounding: a mild fluid, a high Lorentz factor (W up to ~25)
    and near vacuum (ρ ~ 1e-10), where the bracket's bisection runs."""
    rng = np.random.default_rng(7)
    cases = {
        "mild": (1.0 + rng.random(64), 0.5 * (rng.random((64, 3)) - 0.5), 0.1 + rng.random(64)),
        "high_W": (1.0 + rng.random(64), rng.standard_normal((64, 3)), 0.01 + rng.random(64)),
        "near_vacuum": (1e-10 * (1.0 + rng.random(64)), 0.3 * (rng.random((64, 3)) - 0.5),
                        1e-12 + 1e-11 * rng.random(64)),
    }
    for name, (rho, v, p) in cases.items():
        if name == "high_W":  # |v| up to 1 − 1/(2·25²)
            v = v / np.linalg.norm(v, axis=-1, keepdims=True) * np.sqrt(
                1.0 - 1.0 / (1.0 + 624.0 * rng.random(64)))[:, None]
        for gamma, iters in ((5.0 / 3.0, 10), (4.0 / 3.0, 25)):
            Qj = np.array(jsr.prim_to_cons(jnp.asarray(rho), jnp.asarray(v), jnp.asarray(p),
                                             gamma=gamma))
            Qt = tsr.prim_to_cons(torch.from_numpy(rho), torch.from_numpy(v),
                                  torch.from_numpy(p), gamma=gamma).numpy()
            np.testing.assert_allclose(Qt, Qj, rtol=1e-14, atol=0)
            ref = [np.asarray(x) for x in jsr.con2prim(jnp.asarray(Qj), gamma=gamma,
                                                       iters=iters)]
            got = [x.numpy() for x in tsr.con2prim(torch.from_numpy(Qj), gamma=gamma,
                                                   iters=iters)]
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a, b, rtol=0, atol=_bar(b), err_msg=name)
            D, Smag, tau = Qj[:, 0], np.linalg.norm(Qj[:, 1:4], axis=-1), Qj[:, 4]
            ref = [np.asarray(x) for x in jsr.con2prim_smag(
                jnp.asarray(D), jnp.asarray(Smag), jnp.asarray(tau), gamma=gamma, iters=iters)]
            got = [x.numpy() for x in tsr.con2prim_smag(
                torch.from_numpy(D), torch.from_numpy(Smag), torch.from_numpy(tau),
                gamma=gamma, iters=iters)]
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a, b, rtol=0, atol=_bar(b), err_msg=name)
            if iters == 25:  # the recovery lands on the primitives it was built from
                np.testing.assert_allclose(got[1], p, rtol=1e-9, err_msg=name)


def test_con2prim_keeps_nan_and_the_floor():
    """A NaN input gives NaN out (``torch.maximum`` as ``jnp.maximum``);
    a pressureless state recovers the floor, as in the JAX package."""
    Q = np.array([[1.0, np.nan, 0.0, 0.0, 0.5], [1.0, 0.0, 0.0, 0.0, 0.0]])
    ref = [np.asarray(x) for x in jsr.con2prim(jnp.asarray(Q))]
    got = [x.numpy() for x in tsr.con2prim(torch.from_numpy(Q))]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], rtol=0, atol=1e-15)
    assert np.isnan(got[2][0]) and got[2][1] == 1e-12


def test_recover_and_stress_energy_match_jax():
    q = _state(np.random.default_rng(2), (5, 3))
    for a, b in zip(tm.recover(torch.from_numpy(q), gamma=1.4, iters=12),
                    jm.recover(jnp.asarray(q), gamma=1.4, iters=12)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=_bar(np.asarray(b)))
    for a, b in zip(tm.stress_energy(torch.from_numpy(q)), jm.stress_energy(jnp.asarray(q))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=_bar(np.asarray(b)))


# ---------------------------------------------------------------- the algebra


@pytest.mark.parametrize("kw", FAMILIES, ids=FAMILY_IDS)
def test_matter_rhs_matches_jax_soa_and_einsum(kw):
    rng = np.random.default_rng(21)
    q = _state(rng, (3, 4))
    dq3 = rng.standard_normal((3, 4, 3, tm.N_VARS)) * 0.1
    ref_soa = np.asarray(jm.z4_matter_rhs_soa(jnp.asarray(q), jnp.asarray(dq3), **kw))
    ref_einsum = np.asarray(jm.z4_matter_rhs(jnp.asarray(q), jnp.asarray(dq3), **kw))
    got = tm.z4_matter_rhs_soa(torch.from_numpy(q), torch.from_numpy(dq3), **kw).numpy()
    assert got.shape == (3, 4, 43)
    np.testing.assert_allclose(got, ref_soa, rtol=0, atol=_bar(ref_soa))
    np.testing.assert_allclose(got, ref_einsum, rtol=0, atol=_bar(ref_einsum))
    assert not got[..., 38].any()  # ∂_t D̃ has no source
    assert np.abs(got[..., 39:]).min() > 0  # the momentum and energy sources are live


def test_matter_rhs_is_affine_and_reads_no_hydro_gradient():
    """rhs(q, a+b) − rhs(q, 0) = Σ parts; the gradient slots the algebra
    reads are the core's 7-37 (the rows the CUDA predictor stages,
    ``csrc/aderdg_z4.cuh::Z4Matter``), never a hydro slot's; without a fluid
    (D̃ = S̃ = τ̃ = 0, the pressure at its floor) slots 0-37 are the vacuum
    system's but for the floor pressure's ~1e-10."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_state(rng, (6,)))
    da, db = (torch.from_numpy(rng.standard_normal((6, 3, 43)) * 0.1) for _ in range(2))
    zero = torch.zeros_like(da)
    r = lambda d: tm.z4_matter_rhs_soa(q, d, **FAMILIES[1])  # noqa: E731
    assert ((r(da + db) - r(zero)) - ((r(da) - r(zero)) + (r(db) - r(zero)))).abs().max() <= 1e-13
    dq3 = torch.zeros(43, 3, 43, dtype=torch.float64)
    for s in range(43):
        dq3[s, :, s] = float("nan")
    out = tm.z4_matter_rhs_soa(q[:1].expand(43, 43), dq3)
    assert torch.isnan(out).any(dim=-1).nonzero().flatten().tolist() == list(range(7, 38))
    from exahype_tpu_torch.models.z4 import z4_rhs_soa

    q0 = q.clone()
    q0[:, 38:] = 0.0
    np.testing.assert_allclose(tm.z4_matter_rhs_soa(q0, da)[:, :38].numpy(),
                               z4_rhs_soa(q0[:, :38], da[..., :38]).numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("kw", FAMILIES, ids=FAMILY_IDS)
def test_system_callbacks_match_jax(kw):
    """Flux, wave speed, source and NCP on a face-shaped SoA-P array (var
    axis 2) against the JAX ``z4_matter_system(impl="soa")``."""
    rng = np.random.default_rng(5)
    q = np.moveaxis(_state(rng, (3, 3, 2, 2, 2)), -1, 2)
    dq = np.moveaxis(rng.standard_normal((3, 3, 2, 2, 2, 43)) * 0.1, -1, 2)
    j_flux, j_eig, j_ncp, j_src = jm.z4_matter_system(impl="soa", **kw)
    t_flux, t_eig, t_ncp, t_src = tm.z4_matter_system(**kw)
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
        cone = {k: kw[k] for k in ("slicing", "f") if k in kw}
        np.testing.assert_array_equal(tm.z4_matter_eig(Q, axis, 2, **cone).numpy(),
                                      t_eig(Q, axis, 2).numpy())
        ref = np.asarray(j_ncp(jnp.asarray(q), jnp.asarray(dq), axis, 2))
        np.testing.assert_allclose(t_ncp(Q, dQ, axis, 2).numpy(), ref, rtol=0, atol=_bar(ref))


def test_callbacks_carry_the_z4_matter_tag():
    kw = dict(slicing="1+log", f=1.0, m=1.5, kappa1=0.3, kappa2=0.2, gamma=1.4, iters=12)
    tag = PhysicsTag("z4_matter", 3, 43, ("1+log", 1.0, 1.5, 0.3, 0.2, 1.4, 12))
    assert all(fn.physics == tag for fn in tm.z4_matter_system(**kw))
    sol = _port(grid=(2, 2, 2), **kw)
    assert sol.rhs_all_fn.physics == tag and sol.n_vars == tm.N_VARS
    assert _port(fused_rhs=False, grid=(2, 2, 2)).rhs_all_fn is None


def test_admissibility_matches_jax():
    rng = np.random.default_rng(8)
    q = _state(rng, (4, 6))
    q[0, 0, 0] = -0.1  # a negative lapse
    q[1, 1, 38] = -1e-3  # a negative density
    q[2, 2, 4] = -1.0  # γ_yy < 0: a metric that is not positive definite
    q[3, 3, 5] = np.nan
    Q = np.moveaxis(q, -1, 1)
    got = tm.z4_matter_admissible()(torch.from_numpy(Q), 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.z4_matter_admissible()(jnp.asarray(Q), 1)))
    assert got.sum() == 20


# ---------------------------------------------------------------- the states


def test_states_and_the_friedmann_reference_match_jax():
    rng = np.random.default_rng(4)
    z4 = rng.standard_normal((2, 3, 38)) * 0.05
    z4[..., [0, 1, 4, 6]] += 1.0
    rho, p = 0.02 + 0.01 * rng.random((2, 3)), 0.005 + 0.001 * rng.random((2, 3))
    v = 0.2 * (rng.random((2, 3, 3)) - 0.5)
    ref = np.asarray(jm.pack_matter(jnp.asarray(z4), jnp.asarray(rho), jnp.asarray(v),
                                    jnp.asarray(p), gamma=1.4))
    got = tm.pack_matter(*(torch.from_numpy(x) for x in (z4, rho, v, p)), gamma=1.4).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
    for a, adot in ((1.0, _adot()), (1.3, 0.2)):
        np.testing.assert_array_equal(
            tm.flrw_values(a, adot, rho0=RHO0, eps0=EPS0, gamma=GAMMA),
            jm.flrw_values(a, adot, rho0=RHO0, eps0=EPS0, gamma=GAMMA))
    for kw in (dict(rho0=RHO0, eps0=EPS0), dict(rho0=0.05, expanding=False)):
        a_t = tm.flrw_reference(0.1, n_rk=2000, **kw)
        a_j = jm.flrw_reference(0.1, n_rk=2000, **kw)
        assert a_t == a_j
    js = jm.make_z4_matter_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa")
    ts = _port(fused_rhs=False)
    got = tm.flrw_state(ts, 1.0, _adot(), rho0=RHO0, eps0=EPS0)
    assert got.dtype == torch.float64 and got.is_contiguous() and got.shape == ts.state_shape
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jm.flrw_state(js, 1.0, _adot(), rho0=RHO0, eps0=EPS0)))


# ------------------------------------------------------------- steps vs JAX


@pytest.fixture(scope="module", params=range(len(STEP_CASES)), ids=STEP_IDS)
def jax_steps(request):
    """For one case: the JAX solver, the state, one and two chained JAX
    steps, and (fused only) one step through ``with_pallas_rhs(interpret=
    True)``."""
    family, fused = STEP_CASES[request.param]
    kw = FAMILIES[family]
    js = jm.make_z4_matter_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa",
                                  fused_rhs=fused, **kw)
    Q = _noisy(_port(fused_rhs=False))
    one = np.asarray(js.step(jnp.asarray(Q), DT))
    two = np.asarray(js.step(jnp.asarray(one), DT))
    pallas = None
    if fused:
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
    assert np.abs(got - Q)[:, :, :, 38:].max() > 1e-6  # the fluid moved
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
    assert cu.kernels == ("aderdg_predictor_volume_z4_matter", "aderdg_face_flux_z4_matter",
                          "aderdg_surface_update_z4_matter")
    assert cu.ncp and cu.walls is None and cu._physics_id == 5
    params = {**DEFAULTS, **kw}
    assert list(cu._params) == [0.0 if params["slicing"] == "harmonic" else 1.0, params["f"],
                                params["m"], params["kappa1"], params["kappa2"],
                                params["gamma"], params["iters"]]
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
    assert accel.rhs_all_fn.kernel == "rhs_all_z4_matter"
    assert accel.rhs_all_fn._args[-2:] == (params["gamma"], params["iters"])
    assert torch.equal(accel.step(u, DT), step)
    assert cu.launches == {name: 0 for name in cu.kernels} and accel.rhs_all_fn.launches == 0


def test_crossings_from_jax(jax_steps):
    """``z4_matter_solver_from_jax``: the plain solver, ``with_pallas_rhs``
    (to ``with_cuda_rhs``) and ``PallasADERDG`` (to ``CudaADERDG``), the
    parameters and the state carried."""
    kw, fused, js, Q, one, *_ = jax_steps
    port = z4_matter_solver_from_jax(js, device="cpu", **kw)
    assert isinstance(port, ADERDGSolver) and port.n_vars == 43
    assert (port.rhs_all_fn is not None) == bool(fused)
    assert port.flux_fn.physics == tm._matter_tag(**{**DEFAULTS, **kw})
    assert (port.dim, port.order, port.grid_shape, port._dxs, port.picard_iters) == (
        js.dim, js.order, js.grid_shape, js._dxs, js.picard_iters)
    u = state_from_numpy(Q, device="cpu")
    np.testing.assert_allclose(state_to_numpy(port.step(u, DT)), one, rtol=0, atol=_bar(one))
    if not fused:
        return
    accel = z4_matter_solver_from_jax(with_pallas_rhs(js, interpret=True), device="cpu", **kw)
    assert isinstance(accel.rhs_all_fn, CudaRHS)
    assert accel.rhs_all_fn.kernel == "rhs_all_z4_matter"
    cu = z4_matter_solver_from_jax(PallasADERDG(js, interpret=True), device="cpu", **kw)
    assert isinstance(cu, CudaADERDG) and cu.kernels[0] == "aderdg_predictor_volume_z4_matter"
    for other in (accel, cu):
        assert torch.equal(other.step(u, DT), port.step(u, DT))


def test_converters_refuse_the_other_systems():
    js = jm.make_z4_matter_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa",
                                  fused_rhs="soa")
    with pytest.raises(SemanticError, match="needs 38 variables.*z4_matter_solver_from_jax"):
        z4_solver_from_jax(js, device="cpu")
    with pytest.raises(SemanticError, match="needs 53 variables.*z4_matter_solver_from_jax"):
        z4_shift_solver_from_jax(PallasADERDG(js, interpret=True), device="cpu")
    j38 = j_make_z4_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa", fused_rhs="soa")
    with pytest.raises(SemanticError, match="needs 43 variables.*z4_solver_from_jax or "
                                            "z4_shift_solver_from_jax"):
        z4_matter_solver_from_jax(j38, device="cpu")
    with pytest.raises(SemanticError, match="needs 43 variables"):
        z4_matter_solver_from_jax(PallasADERDG(j38, interpret=True), device="cpu")


# ---------------------------------------------------------------- the anchor


def test_flrw_anchor_meets_the_example_bars():
    """``examples/flrw_cosmology.py`` run by the port: its configuration (2-D
    ``(4, 4)`` p2, dx = 0.25, geodesic slicing, Γ = 5/3, the per-axis NCP
    solver it builds), 100 steps to t = 0.5, held to its bars: a² = γ_xx
    within 1e-7 of the Friedmann reference, D̃ within 1e-9 of ρ₀, |Θ| and
    |Z| under 1e-9."""
    sol = tm.make_z4_matter_solver(dim=2, order=2, grid_shape=(4, 4), dx=0.25, gamma=GAMMA,
                                   slicing="harmonic", f=0.0, device="cpu")
    Q = tm.flrw_state(sol, 1.0, _adot(), rho0=RHO0, eps0=EPS0, gamma=GAMMA)
    Q = sol.run(Q, 100, 0.5 / 100)
    a_ref, adot_ref = tm.flrw_reference(0.5, rho0=RHO0, eps0=EPS0, gamma=GAMMA)
    q = torch.movedim(Q, sol.var_axis, -1).numpy()
    gxx, Kxx, Dt = q[..., 1].ravel()[0], q[..., 7].ravel()[0], q[..., 38].ravel()[0]
    assert abs(gxx - a_ref**2) / a_ref**2 < 1e-7
    assert abs(Kxx + a_ref * adot_ref) / abs(a_ref * adot_ref) < 1e-6
    assert abs(Dt - RHO0) / RHO0 < 1e-9
    assert np.abs(q[..., 13]).max() < 1e-9 and np.abs(q[..., 14:17]).max() < 1e-9
    assert np.ptp(q[..., 1]) == 0.0  # homogeneous: every node alike


# ------------------------------------------------------------ refusals


def test_refusals_name_their_roadmap_items():
    with pytest.raises(SemanticError, match="impl='einsum'.*Queue 1 item 7.4"):
        tm.make_z4_matter_solver(3, 2, GRID, dx=DX, impl="einsum", device="cpu")
    with pytest.raises(SemanticError, match="impl='einsum'.*Queue 1 item 7.4"):
        tm.z4_matter_system(impl="einsum")
    with pytest.raises(SemanticError, match="fused_rhs=True.*Queue 1 item 7.4"):
        _port(fused_rhs=True)
    # The per-axis NCP build (the JAX package's default) has kernels of its
    # own since K1 d's per-axis branch took the flux.
    per_axis = CudaADERDG(_port(fused_rhs=False, grid=(2, 2, 2)))
    assert per_axis.per_axis
    assert per_axis.kernels[0] == "aderdg_predictor_volume_per_axis_z4_matter"
    sol = _port(grid=(2, 2, 2), boundary="outflow", wall_axes=(0,))
    with pytest.raises(LoweringError, match="periodic only.*Queue 2 K1 d"):
        CudaADERDG(sol)
    with pytest.raises(LoweringError, match="with_cuda_rhs.*make_z4_matter_solver"):
        CudaADERDG(with_cuda_rhs(_port(grid=(2, 2, 2))))
    for dim, order in ((3, 3), (2, 2)):
        sol = tm.make_z4_matter_solver(dim, order, (2,) * dim, dx=DX, fused_rhs="soa",
                                       device="cpu")
        if (dim, order) == (2, 2):  # the 2-D step at order 2 has its kernels
            assert CudaADERDG(sol).kernels[0] == "aderdg_predictor_volume_2d_z4_matter"
            continue
        with pytest.raises(LoweringError,
                           match=f"z4_matter, dim={dim}, order={order}.*Queue 1 item 4"):
            CudaADERDG(sol)
    # K5 b's 2-D instance of this system.
    k5b = with_cuda_rhs(tm.make_z4_matter_solver(2, 2, (4, 2), dx=DX, fused_rhs="soa",
                                                 device="cpu"))
    assert k5b.rhs_all_fn.kernel == "rhs_all_z4_matter_2d"
    with pytest.raises(LoweringError, match="43 z4_matter variables, got dim=3, n_vars=38"):
        CudaRHS(_port(grid=(2, 2, 2)).rhs_all_fn, 3, 38)
    with pytest.raises(LoweringError, match="43-variable Z4\\+GRHD"):
        CudaRHS(lambda Q, grads, va: Q, 3, 43)  # untagged
    with pytest.raises(LoweringError, match="Queue 2 K1 d"):  # two systems' callbacks
        sol = _port(grid=(2, 2, 2))
        sol.ncp_fn = tm.z4_matter_system(gamma=1.4)[2]
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
