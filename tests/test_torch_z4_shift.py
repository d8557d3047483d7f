"""The shifted 53-variable Z4 system (``exahype_tpu_torch/models/z4.py``:
``z4_shift_rhs_soa``, ``z4_shift_system``, ``make_z4_shift_solver``, the
moving gauge wave) against the JAX package's on the CPU in f64, its routes
(``CudaADERDG`` and ``with_cuda_rhs``) on CPU tensors, the crossings from
JAX and the refusals.

Inputs are made from seeds with NumPy.  The bar is 1e-12·max(1, max|JAX|)
unless said: the algebra is held to the JAX ``z4_shift_rhs_soa`` (the same
operations in the same order) and to the einsum ``z4_shift_rhs`` (its
``jax.jvp`` Gamma-driver term against the explicit chain rule: a rounding
apart), in the three parameter families of
``tests/test_z4.py::test_shift_soa_rhs_matches_einsum_rhs``.  The steps are
``make_z4_shift_solver(3, 2, (4, 2, 4), dx=0.25)`` on the moving gauge
wave (v = 0.2, amplitude 0.01) with seeded noise of 1e-4 on every slot, so
that β, b and B all vary and every Lie and Gamma-driver term is live (on the
exact wave b = B = ∂b = ∂B = 0).  The JAX steps run once per module.

The chain to the TPU kernels: ``tests/test_rhs_pallas.py`` holds the JAX
``PallasRHS`` on this system at 1e-15 to the same algebra; one fused step
here is held to ``with_pallas_rhs(interpret=True)``.  The CUDA kernels are
held to these plain stages on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import z4 as jz
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu.models.rhs_pallas import with_pallas_rhs
from exahype_tpu_torch.convert import (
    state_from_numpy,
    state_to_numpy,
    z4_shift_solver_from_jax,
    z4_solver_from_jax,
)
from exahype_tpu_torch.models import z4 as tz
from exahype_tpu_torch.models.aderdg import ADERDGSolver, PhysicsTag
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.rhs_cuda import CudaRHS, with_cuda_rhs
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError

torch.set_num_threads(1)

GRID = (4, 2, 4)
DX = 0.25
DT = 1e-3
V = 0.2

#: The three families of ``tests/test_z4.py:936-940``.
FAMILIES = [
    dict(shift="frozen"),
    dict(shift="gamma_driver", kappa1=0.2, eta=0.7),
    dict(shift="gamma_driver", slicing="1+log", f_b=0.5, m=1.5),
]
FAMILY_IDS = ["frozen", "driver", "driver_1+log"]
#: The steps held to JAX: (family, fused_rhs), both shift modes both ways.
STEP_CASES = [(0, "soa"), (1, "soa"), (0, False), (1, False)]
STEP_IDS = ["frozen_fused", "driver_fused", "frozen_per_axis", "driver_per_axis"]
#: The parameters of a family with the defaults filled in.
DEFAULTS = dict(slicing="harmonic", f=1.0, m=2.0, kappa1=0.0, kappa2=0.0, shift="frozen",
                f_b=0.75, eta=1.0)


def _bar(ref):
    return 1e-12 * max(1.0, float(np.abs(ref).max()))


def _state(rng, lead):
    """A perturbed flat state, var-last ``[*lead, 53]`` (α, γ near 1)."""
    q = rng.standard_normal(lead + (tz.N_VARS_SHIFT,)) * 0.1
    q[..., [0, 1, 4, 6]] += 1.0
    return q


def _port(fused_rhs="soa", grid=GRID, **kw):
    return tz.make_z4_shift_solver(3, 2, grid, dx=DX, fused_rhs=fused_rhs, device="cpu", **kw)


def _noisy_moving_wave(sol, seed=3, eps=1e-4):
    """The moving gauge wave with seeded noise on every slot (float64 NumPy)."""
    Q = state_to_numpy(tz.moving_gauge_wave_state(sol, v=V, amplitude=0.01))
    return Q + eps * np.random.default_rng(seed).standard_normal(Q.shape)


# ---------------------------------------------------------------- the algebra


@pytest.mark.parametrize("kw", FAMILIES, ids=FAMILY_IDS)
def test_shift_rhs_matches_jax_soa_and_einsum(kw):
    rng = np.random.default_rng(21)
    q = _state(rng, (3, 4))
    dq3 = rng.standard_normal((3, 4, 3, tz.N_VARS_SHIFT)) * 0.1
    ref_soa = np.asarray(jz.z4_shift_rhs_soa(jnp.asarray(q), jnp.asarray(dq3), **kw))
    ref_einsum = np.asarray(jz.z4_shift_rhs(jnp.asarray(q), jnp.asarray(dq3), **kw))
    got = tz.z4_shift_rhs_soa(torch.from_numpy(q), torch.from_numpy(dq3), **kw).numpy()
    assert got.shape == (3, 4, 53)
    np.testing.assert_allclose(got, ref_soa, rtol=0, atol=_bar(ref_soa))
    np.testing.assert_allclose(got, ref_einsum, rtol=0, atol=_bar(ref_einsum))
    if kw["shift"] == "frozen":
        assert not got[..., 38:].any()  # the gauge sector does not evolve
    else:
        assert np.abs(got[..., 41:44]).min() > 0  # ∂_t b carries ∂_t Γ


def test_shift_rhs_is_affine_and_extends_the_zero_shift_one():
    """rhs(q, a+b) − rhs(q, 0) = Σ parts; with β = b = B = 0 and zero
    derivatives of b and B, slots 0-37 are the zero-shift system's."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_state(rng, (6,)))
    da, db = (torch.from_numpy(rng.standard_normal((6, 3, 53)) * 0.1) for _ in range(2))
    zero = torch.zeros_like(da)
    kw = FAMILIES[1]
    r = lambda d: tz.z4_shift_rhs_soa(q, d, **kw)  # noqa: E731
    assert ((r(da + db) - r(zero)) - ((r(da) - r(zero)) + (r(db) - r(zero)))).abs().max() <= 1e-13
    q0, d0 = q.clone(), da.clone()
    q0[:, 38:] = 0.0
    d0[..., 41:] = 0.0
    np.testing.assert_array_equal(tz.z4_shift_rhs_soa(q0, d0, **kw)[:, :38].numpy(),
                                  tz.z4_rhs_soa(q0[:, :38], d0[..., :38], kappa1=0.2).numpy())


def test_shift_rhs_reads_the_kernels_gradient_slots():
    """The gradient slots the algebra reads: ∂ of slots 7-37 and 41-52,
    never ∂α, ∂γ or ∂β (43 an axis; the rows the CUDA predictor stages,
    ``csrc/aderdg_z4.cuh::Z4Shift``); the frozen shift reads ∂B but not ∂b."""
    for kw, slots in ((FAMILIES[1], [*range(7, 38), *range(41, 53)]),
                      (FAMILIES[0], [*range(7, 38), *range(44, 53)])):
        q = torch.from_numpy(_state(np.random.default_rng(4), (53,)))
        dq3 = torch.zeros(53, 3, 53, dtype=torch.float64)
        for s in range(53):
            dq3[s, :, s] = float("nan")
        out = tz.z4_shift_rhs_soa(q, dq3, **kw)
        assert torch.isnan(out).any(dim=-1).nonzero().flatten().tolist() == slots


@pytest.mark.parametrize("kw", FAMILIES, ids=FAMILY_IDS)
def test_system_callbacks_match_jax(kw):
    """Wave speed (with |β^d|), source and NCP on a face-shaped SoA-P array
    (var axis 2) against the JAX ``z4_shift_system(impl="soa")``."""
    rng = np.random.default_rng(5)
    q = np.moveaxis(_state(rng, (3, 3, 2, 2, 2)), -1, 2)
    dq = np.moveaxis(rng.standard_normal((3, 3, 2, 2, 2, 53)) * 0.1, -1, 2)
    j_flux, j_eig, j_ncp, j_src = jz.z4_shift_system(impl="soa", **kw)
    t_flux, t_eig, t_ncp, t_src = tz.z4_shift_system(**kw)
    Q, dQ = torch.from_numpy(q), torch.from_numpy(dq)
    assert not t_flux(Q, 0, 2).any() and t_flux(Q, 0, 2).shape == Q.shape
    ref = np.asarray(j_src(jnp.asarray(q), 2))
    np.testing.assert_allclose(t_src(Q, 2).numpy(), ref, rtol=0, atol=_bar(ref))
    for axis in range(3):
        ref = np.asarray(j_eig(jnp.asarray(q), axis, 2))
        got = t_eig(Q, axis, 2).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=_bar(ref))
        cone = tz.z4_system(**{k: v for k, v in kw.items()
                               if k in ("slicing", "f", "m", "kappa1", "kappa2")})[1]
        np.testing.assert_allclose(got - cone(Q[:, :, :38], axis, 2).numpy(),
                                   np.abs(q[:, :, 38 + axis]), rtol=0, atol=1e-14)
        ref = np.asarray(j_ncp(jnp.asarray(q), jnp.asarray(dq), axis, 2))
        np.testing.assert_allclose(t_ncp(Q, dQ, axis, 2).numpy(), ref, rtol=0, atol=_bar(ref))


def test_callbacks_carry_the_z4_shift_tag():
    kw = dict(slicing="1+log", f=1.0, m=1.5, kappa1=0.3, kappa2=0.2, shift="gamma_driver",
              f_b=0.5, eta=0.7)
    tag = PhysicsTag("z4_shift", 3, 53, ("1+log", 1.0, 1.5, 0.3, 0.2, "gamma_driver", 0.5, 0.7))
    assert all(fn.physics == tag for fn in tz.z4_shift_system(**kw))
    sol = _port(grid=(2, 2, 2), **kw)
    assert sol.rhs_all_fn.physics == tag and sol.n_vars == tz.N_VARS_SHIFT
    assert _port(fused_rhs=False, grid=(2, 2, 2)).rhs_all_fn is None


def test_states_match_jax():
    x = np.linspace(0.0, 1.0, 17)
    for t in (0.0, 0.37):
        np.testing.assert_array_equal(tz.moving_gauge_wave_values(x, t, 0.3, 0.1, 0.5),
                                      jz.moving_gauge_wave_values(x, t, 0.3, 0.1, 0.5))
    js = jz.make_z4_shift_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa")
    ts = _port(fused_rhs=False)
    for t in (0.0, 0.37):
        got = tz.moving_gauge_wave_state(ts, t=t, v=V, amplitude=0.1)
        assert got.dtype == torch.float64 and got.is_contiguous()
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jz.moving_gauge_wave_state(js, t=t, v=V, amplitude=0.1)))
    np.testing.assert_array_equal(tz.flat_state_values(53),
                                  np.concatenate([jz.flat_state_values(), np.zeros(15)]))
    flat = tz.z4_flat_state(ts)
    assert flat.shape == ts.state_shape
    assert torch.equal(flat.movedim(ts.var_axis, -1)[..., :38],
                       tz.z4_flat_state(tz.make_z4_solver(3, 2, GRID, dx=DX, device="cpu"))
                       .movedim(ts.var_axis, -1))


def test_shifted_flat_space_is_stationary():
    """``tests/test_z4.py``'s stationarity check (atol 1e-13), on the
    53-variable flat state, both shift modes."""
    for kw in FAMILIES[:2]:
        sol = _port(grid=(2, 2, 2), **kw)
        u = tz.z4_flat_state(sol)
        np.testing.assert_allclose(sol.run(u, 3, 5e-3).numpy(), u.numpy(), rtol=0, atol=1e-13)


def test_constraints_take_the_53_variable_state():
    """``adm_constraints``/``solver_constraints`` read slots 0-37: the same
    numbers as JAX's on a 53-variable state, and as on its first 38 slots."""
    rng = np.random.default_rng(9)
    q = _state(rng, (4, 3))
    dq3 = rng.standard_normal((4, 3, 3, 53)) * 0.1
    H_t, M_t = tz.adm_constraints(torch.from_numpy(q), torch.from_numpy(dq3))
    H_j, M_j = jz.adm_constraints(jnp.asarray(q), jnp.asarray(dq3))
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=0, atol=1e-13)
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), rtol=0, atol=1e-13)
    sol = _port(fused_rhs=False)
    u = torch.from_numpy(_noisy_moving_wave(sol))
    H, M = tz.solver_constraints(sol, u)
    H38, M38 = tz.solver_constraints(tz.make_z4_solver(3, 2, GRID, dx=DX, device="cpu"),
                                     u.narrow(sol.var_axis, 0, 38))
    assert torch.equal(H, H38) and torch.equal(M, M38)


# ------------------------------------------------------------- steps vs JAX


@pytest.fixture(scope="module", params=range(len(STEP_CASES)), ids=STEP_IDS)
def jax_steps(request):
    """For one case: the JAX solver, the noisy moving wave, one and two
    chained JAX steps, and (fused Gamma-driver only) one step through
    ``with_pallas_rhs(interpret=True)``."""
    family, fused = STEP_CASES[request.param]
    kw = FAMILIES[family]
    js = jz.make_z4_shift_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa",
                                 fused_rhs=fused, **kw)
    Q = _noisy_moving_wave(_port(fused_rhs=False))
    one = np.asarray(js.step(jnp.asarray(Q), DT))
    two = np.asarray(js.step(jnp.asarray(one), DT))
    pallas = None
    if fused and kw["shift"] == "gamma_driver":
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
    assert np.abs(got - Q).max() > 1e-5  # the step moved the state
    if pallas is not None:
        np.testing.assert_allclose(got, pallas, rtol=0, atol=_bar(pallas))


@pytest.mark.parametrize("kw", FAMILIES, ids=FAMILY_IDS)
def test_cuda_routes_on_the_cpu_are_the_plain_solver_bitwise(kw):
    """``CudaADERDG`` and ``with_cuda_rhs`` over the fused solver on CPU
    tensors: their stages compose to the plain step bit for bit, and
    nothing launches."""
    sol = _port(**kw)
    u = state_from_numpy(_noisy_moving_wave(sol), device="cpu")
    cu = CudaADERDG(sol)
    assert cu.kernels == ("aderdg_predictor_volume_z4_shift", "aderdg_face_flux_z4_shift",
                          "aderdg_surface_update_z4_shift")
    assert cu.ncp and cu.walls is None and cu._physics_id == 4
    new_k, faces_k, fv_k = cu.predictor_volume(u, DT)
    new_p, faces_p, fv_p = sol.predictor_volume(u, DT)
    assert fv_k is None and torch.equal(new_k, new_p) and torch.equal(faces_k, faces_p)
    assert faces_k.shape == sol.face_shape and not faces_k[:, 2:].any()
    stage_p = sol.face_surface(new_p, faces_p, DT)
    assert cu.face_surface(new_k, faces_k, DT) is new_k and torch.equal(new_k, stage_p)
    step = sol.step(u, DT)
    assert torch.equal(cu.step(u, DT), step) and torch.equal(step, stage_p)
    assert torch.equal(cu.run(u, 2, DT), sol.run(u, 2, DT))
    accel = with_cuda_rhs(sol)
    assert isinstance(accel.rhs_all_fn, CudaRHS) and accel.rhs_all_fn.kernel == "rhs_all_z4_shift"
    assert torch.equal(accel.step(u, DT), step)
    assert cu.launches == {name: 0 for name in cu.kernels} and accel.rhs_all_fn.launches == 0


def test_crossings_from_jax(jax_steps):
    """``z4_shift_solver_from_jax``: the plain solver, ``with_pallas_rhs``
    (to ``with_cuda_rhs``) and ``PallasADERDG`` (to ``CudaADERDG``), the
    parameters and the state carried."""
    kw, fused, js, Q, one, *_ = jax_steps
    port = z4_shift_solver_from_jax(js, device="cpu", **kw)
    assert isinstance(port, ADERDGSolver) and port.n_vars == 53
    assert (port.rhs_all_fn is not None) == bool(fused)
    assert port.flux_fn.physics == tz._shift_tag(**{**DEFAULTS, **kw})
    assert (port.dim, port.order, port.grid_shape, port._dxs, port.picard_iters) == (
        js.dim, js.order, js.grid_shape, js._dxs, js.picard_iters)
    u = state_from_numpy(Q, device="cpu")
    got = state_to_numpy(port.step(u, DT))
    np.testing.assert_allclose(got, one, rtol=0, atol=_bar(one))
    if not fused:
        return
    accel = z4_shift_solver_from_jax(with_pallas_rhs(js, interpret=True), device="cpu", **kw)
    assert isinstance(accel.rhs_all_fn, CudaRHS) and accel.rhs_all_fn.kernel == "rhs_all_z4_shift"
    cu = z4_shift_solver_from_jax(PallasADERDG(js, interpret=True), device="cpu", **kw)
    assert isinstance(cu, CudaADERDG) and cu.kernels[0] == "aderdg_predictor_volume_z4_shift"
    for other in (accel, cu):
        assert torch.equal(other.step(u, DT), port.step(u, DT))


def test_converters_refuse_the_other_system():
    js = jz.make_z4_shift_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa",
                                 fused_rhs="soa")
    with pytest.raises(SemanticError, match="needs 38 variables.*z4_shift_solver_from_jax"):
        z4_solver_from_jax(js, device="cpu")
    with pytest.raises(SemanticError, match="needs 38 variables"):
        z4_solver_from_jax(PallasADERDG(js, interpret=True), device="cpu")
    j38 = jz.make_z4_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa",
                            fused_rhs="soa")
    with pytest.raises(SemanticError, match="needs 53 variables.*z4_solver_from_jax"):
        z4_shift_solver_from_jax(j38, device="cpu")
    with pytest.raises(SemanticError, match="needs 53 variables"):
        z4_shift_solver_from_jax(PallasADERDG(j38, interpret=True), device="cpu")


# ------------------------------------------------------------ convergence


def _l2_error(sol, u, exact):
    w = sol.weights.to(torch.float64)
    err2 = (u - exact) ** 2
    for d in reversed(range(sol.dim)):
        err2 = torch.tensordot(w, err2, dims=([0], [sol.node_axis(d)]))
    return float((err2.sum() * sol._dxs[0] ** sol.dim).sqrt())


def test_moving_gauge_wave_converges():
    """``tests/test_z4.py::test_moving_gauge_wave_convergence`` run by the
    port: 2-D p2, frozen shift β^x = 0.2, t = 0.08 on (4, 2) and (8, 2)
    cells, rate > 2.5.  The fused hook stands in for the per-axis NCP (the
    same algebra by affinity, ~2x faster on the CPU)."""
    t_end, errors = 0.08, []
    for cells in (4, 8):
        sol = tz.make_z4_shift_solver(2, 2, (cells, 2), dx=1.0 / cells, shift="frozen",
                                      fused_rhs="soa", device="cpu")
        n_steps = 4 * cells
        u = sol.run(tz.moving_gauge_wave_state(sol, v=V), n_steps, t_end / n_steps)
        errors.append(_l2_error(sol, u, tz.moving_gauge_wave_state(sol, t=t_end, v=V)))
    rate = np.log2(errors[0] / errors[1])
    assert rate > 2.5, f"moving gauge-wave rate {rate:.2f}, errors {errors}"


# ------------------------------------------------------------ refusals


def test_refusals_name_their_roadmap_items():
    with pytest.raises(SemanticError, match="impl='einsum'.*Queue 1 item 7.4"):
        tz.make_z4_shift_solver(3, 2, GRID, dx=DX, impl="einsum", device="cpu")
    with pytest.raises(SemanticError, match="impl='einsum'.*Queue 1 item 7.4"):
        tz.z4_shift_system(impl="einsum")
    with pytest.raises(SemanticError, match="fused_rhs=True.*Queue 1 item 7.4"):
        _port(fused_rhs=True)
    with pytest.raises(SemanticError, match="Queue 1 item 7.4"):
        tz.make_z4_solver(3, 2, GRID, dx=DX, impl="einsum", device="cpu")
    with pytest.raises(ValueError, match="shift mode"):
        _port(shift="harmonic")
    # The per-axis NCP branch, refused until its kernel existed, is accepted.
    assert CudaADERDG(_port(fused_rhs=False, grid=(2, 2, 2))).kernels[0] == (
        "aderdg_predictor_volume_per_axis_z4_shift")
    sol = _port(grid=(2, 2, 2), boundary="outflow", wall_axes=(0,))
    with pytest.raises(LoweringError, match="periodic only.*Queue 2 K1 d"):
        CudaADERDG(sol)
    with pytest.raises(LoweringError, match="with_cuda_rhs"):
        CudaADERDG(with_cuda_rhs(_port(grid=(2, 2, 2))))
    for dim, order in ((3, 3), (2, 3)):
        sol = tz.make_z4_shift_solver(dim, order, (2,) * dim, dx=DX, fused_rhs="soa",
                                      device="cpu")
        with pytest.raises(LoweringError,
                           match=f"z4_shift, dim={dim}, order={order}.*Queue 1 item 4"):
            CudaADERDG(sol)
    # The 2-D order-2 step and K5 b's 2-D instance, refused until their
    # kernels existed, are accepted.
    sol2 = tz.make_z4_shift_solver(2, 2, (4, 2), dx=DX, fused_rhs="soa", device="cpu")
    assert CudaADERDG(sol2).kernels[0] == "aderdg_predictor_volume_2d_z4_shift"
    assert with_cuda_rhs(sol2).rhs_all_fn.kernel == "rhs_all_z4_shift_2d"
    z4 = tz.make_z4_solver(3, 2, (2, 2, 2), dx=DX, fused_rhs="soa", device="cpu")
    with pytest.raises(LoweringError, match="53 z4_shift variables, got dim=3, n_vars=38"):
        CudaRHS(_port(grid=(2, 2, 2)).rhs_all_fn, 3, 38)
    with pytest.raises(LoweringError, match="38-variable vacuum Z4 .* 53-variable shifted"):
        CudaRHS(lambda Q, grads, va: Q, 3, 53)  # untagged
    with pytest.raises(LoweringError, match="Queue 2 K1 d"):  # two systems' callbacks
        sol = _port(grid=(2, 2, 2))
        sol.ncp_fn = z4.ncp_fn
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
    Q = state_to_numpy(tz.moving_gauge_wave_state(sol, v=V))
    rng = np.random.default_rng(2)
    q = torch.from_numpy(Q)
    grads = tuple(torch.from_numpy(rng.standard_normal(Q.shape)) for _ in range(3))
    q, grads = bad(q, grads)
    with pytest.raises(LoweringError, match=match):
        with_cuda_rhs(sol).rhs_all_fn(q, grads, 3)
