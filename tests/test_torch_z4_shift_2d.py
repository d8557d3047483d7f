"""The shifted 53-variable Z4 system in 2-D at order 2 on ``CudaADERDG``
(K1 d's 2-D shifted step, ``csrc/aderdg_z4_shift_2d.cu``: the per-axis NCP,
the JAX package's default build, and the fused right-hand side) and K5 b's
2-D shifted instance (``rhs_all_z4_shift_2d``) on the CPU: the wrapper's
stages against the plain solver, the steps and the right-hand side against
the JAX package's, the crossing of the JAX default build, and the per-axis
step against the fused one.

On CPU tensors ``CudaADERDG`` and ``CudaRHS`` run their kernels' plain
versions.  The bar against JAX is 1e-12·max(1, max|ref|) in float64 (the
per-axis build's default ``impl="einsum"`` against the port's SoA algebra:
ROADMAP Queue 3's converter caveat).  The solver is the one every shifted
test of the JAX package builds (``make_z4_shift_solver(dim=2, order=2,
grid_shape=(4, 2), dx=0.25)``, ``tests/test_z4.py:802-897``); the state the
moving gauge wave (v = 0.2, amplitude 0.01) with seeded noise of 1e-4 on
every slot, made with NumPy (on the exact wave b = B = ∂b = ∂B = 0), in the
frozen shift and the κ₁-damped Gamma-driver (``tests/test_z4.py:936-940``).
In 2-D the wave speed adds |β^d| of the grid's two axes while β^z still
evolves.  Each JAX step runs once per module, eagerly.  The Pallas kernel's
step is ``tests/test_torch_z4_shift_2d_pallas.py``; the CUDA kernels are
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
from exahype_tpu_torch.convert import state_from_numpy, state_to_numpy, z4_shift_solver_from_jax
from exahype_tpu_torch.models import z4 as tz
from exahype_tpu_torch.models.aderdg import ADERDGSolver
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs

torch.set_num_threads(1)

GRID = (4, 2)
DX = 0.25
DT = 1e-3
MODES = {"frozen": dict(shift="frozen"),
         "driver": dict(shift="gamma_driver", kappa1=0.2, eta=0.7)}
FORMS = {"per_axis": False, "fused": "soa"}
KERNELS = {
    False: ("aderdg_predictor_volume_per_axis_2d_z4_shift", "aderdg_face_flux_2d_z4_shift",
            "aderdg_surface_update_2d_z4_shift"),
    "soa": ("aderdg_predictor_volume_2d_z4_shift", "aderdg_face_flux_2d_z4_shift",
            "aderdg_surface_update_2d_z4_shift"),
}


def _bar(ref):
    return 1e-12 * max(1.0, float(np.abs(ref).max()))


def _port(fused, mode="driver"):
    return tz.make_z4_shift_solver(2, 2, GRID, dx=DX, fused_rhs=fused, device="cpu",
                                   **MODES[mode])


def _noisy(sol, seed=3):
    """The moving gauge wave on ``sol`` with seeded noise of 1e-4 on every
    slot (float64 NumPy, SoA-P)."""
    Q = state_to_numpy(tz.moving_gauge_wave_state(sol, v=0.2, amplitude=0.01))
    return Q + 1e-4 * np.random.default_rng(seed).standard_normal(Q.shape)


@pytest.fixture(scope="module")
def jax_steps():
    """``{(form, mode): (js, Q, one step)}``: the JAX package's default build
    (per-axis NCP, einsum algebra) and its fused build, in each shift mode,
    each with its eager XLA step from the state."""
    out = {}
    for form, fused in FORMS.items():
        for mode, params in MODES.items():
            js = jz.make_z4_shift_solver(dim=2, order=2, grid_shape=GRID, dx=DX,
                                         fused_rhs=fused, **params)
            Q = _noisy(_port(fused, mode))
            out[form, mode] = js, Q, np.asarray(js.step(jnp.asarray(Q), DT))
    return out


@pytest.mark.parametrize("form", list(FORMS))
def test_cpu_stages_are_the_plain_step_bitwise(form):
    """The wrapper's predictor and face stage on CPU tensors compose the
    plain step bit for bit (the face stage in place, as on the card), its
    kernels are the form's, and nothing launches."""
    fused = FORMS[form]
    sol = _port(fused)
    cu = CudaADERDG(sol)
    assert cu.kernels == KERNELS[fused] and cu.ncp and cu.walls is None
    assert cu.per_axis == (fused is False) and cu._physics_id == 4
    u = state_from_numpy(_noisy(sol), device="cpu")
    u0 = u.clone()
    new, faces, fvwall = cu.predictor_volume(u, DT)
    assert fvwall is None and faces.shape == sol.face_shape and not faces[:, 2:].any()
    out = cu.face_surface(new, faces, DT)
    ref = sol.step(u, DT)
    assert out is new and torch.equal(out, ref)
    assert torch.equal(u, u0)
    assert cu.launches == {name: 0 for name in cu.kernels}
    assert (ref - u).narrow(sol.var_axis, 38, 15).abs().max().item() > 1e-6  # β, b, B move


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("form", list(FORMS))
def test_step_matches_jax(jax_steps, form, mode):
    js, Q, one = jax_steps[form, mode]
    got = state_to_numpy(CudaADERDG(_port(FORMS[form], mode)).step(
        state_from_numpy(Q, device="cpu"), DT))
    assert got.shape == js.state_shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, one, rtol=0, atol=_bar(one))
    assert np.abs(one - Q).max() > 1e-5


def test_the_jax_default_build_crosses_to_the_per_axis_kernels(jax_steps):
    """``z4_shift_solver_from_jax`` maps the JAX default build to the port's
    per-axis solver, and ``PallasADERDG`` over it to ``CudaADERDG`` with
    ``per_axis`` true and the 2-D kernels' names; the crossed step is the
    JAX one's."""
    js, Q, one = jax_steps["per_axis", "driver"]
    assert js.rhs_all_fn is None and js.ncp_fn is not None
    cu = z4_shift_solver_from_jax(PallasADERDG(js, interpret=True), device="cpu",
                                  **MODES["driver"])
    port = cu.solver
    assert isinstance(port, ADERDGSolver) and port.rhs_all_fn is None
    assert (port.dim, port.order, port.grid_shape, port._dxs, port.picard_iters) == (
        js.dim, js.order, js.grid_shape, js._dxs, js.picard_iters)
    assert isinstance(cu, CudaADERDG) and cu.per_axis and cu.kernels == KERNELS[False]
    got = state_to_numpy(cu.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, one, rtol=0, atol=_bar(one))


@pytest.mark.parametrize("mode", list(MODES))
def test_per_axis_and_fused_steps_agree(mode):
    """The per-axis and fused builds split the same algebra differently:
    their steps agree to the JAX package's own bar
    (``tests/test_z4.py::test_fused_rhs_hook_matches_per_axis_path``, 1e-11),
    and both move."""
    u = state_from_numpy(_noisy(_port(False, mode)), device="cpu")
    a = CudaADERDG(_port(False, mode)).step(u, DT)
    b = CudaADERDG(_port("soa", mode)).step(u, DT)
    assert (a - b).abs().max().item() <= 1e-11
    assert (b - u).abs().max().item() > 1e-5


def test_k5b_shift_instance_matches_jax(jax_steps):
    """K5 b's shifted instance on the CPU (its plain version) against the
    JAX ``PallasRHS`` hook (interpret mode) and ``z4_shift_rhs_soa`` itself,
    given two gradient arrays (the third axis's derivatives zero); its
    route's step against the plain step, launching nothing."""
    js, Q, _ = jax_steps["fused", "driver"]
    sol = _port("soa")
    kern = with_cuda_rhs(sol)
    k5 = kern.rhs_all_fn
    assert k5.kernel == "rhs_all_z4_shift_2d" and k5.dim == 2
    assert k5._args[-3:] == (tz.SHIFTS["gamma_driver"], 0.75, MODES["driver"]["eta"])
    rng = np.random.default_rng(11)
    grads = tuple(0.1 * rng.standard_normal(Q.shape) for _ in range(2))
    va = sol.var_axis
    got = k5(torch.from_numpy(Q), tuple(torch.from_numpy(g) for g in grads), va).numpy()
    hook = np.asarray(with_pallas_rhs(js, interpret=True).rhs_all_fn(
        jnp.asarray(Q), tuple(map(jnp.asarray, grads)), va))
    q = np.moveaxis(Q, va, -1)
    dq3 = np.stack([np.moveaxis(g, va, -1) for g in grads] + [np.zeros(q.shape)], axis=-2)
    soa = np.moveaxis(np.asarray(jz.z4_shift_rhs_soa(jnp.asarray(q), jnp.asarray(dq3),
                                                     **MODES["driver"])), -1, va)
    for ref in (hook, soa):
        np.testing.assert_allclose(got, ref, rtol=0, atol=_bar(ref))
    assert np.abs(got[:, :, 41:]).max() > 1e-3  # ∂_t b and ∂_t B carry the gradients
    u = state_from_numpy(Q, device="cpu")
    assert torch.equal(kern.step(u, DT), sol.step(u, DT))
    assert k5.launches == 0  # CPU tensors take the plain route
