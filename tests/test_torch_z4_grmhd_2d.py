"""The coupled Z4+GRMHD system in 2-D at order 2 on ``CudaADERDG`` (K1 d's
2-D Z4+GRMHD step, ``csrc/aderdg_z4_grmhd_2d.cu``: the per-axis NCP, the
JAX package's default build, and the fused right-hand side) and K5 b's 2-D
Z4+GRMHD instance (``rhs_all_z4_grmhd_2d``) on the CPU: the wrapper's
stages against the plain solver, the steps and the right-hand side against
the JAX package's, the crossing of the JAX default build, and the per-axis
step against the fused one.

On CPU tensors ``CudaADERDG`` and ``CudaRHS`` run their kernels' plain
versions.  The bar against JAX is 1e-12·max(1, max|ref|) in float64 (its
default ``impl="einsum"`` against the port's SoA algebra: ROADMAP Queue 3's
converter caveat).  The state is the magnetized wave of the JAX package's
Z4+GRMHD tests (``tests/test_z4_grmhd.py::_magnetized_wave_state``, whose
solvers are this one: ``make_z4_grmhd_solver(dim=2, order=2, ...)``) on (4,
2) cells at dx = 0.25, a unit axis 0, with seeded noise of 1e-4 on every
slot, made with NumPy.  The per-axis step is held to the JAX default build
in those tests' gauge (harmonic, f = 0, Γ = 5/3, GLM κ = 0.5; 7 Newton
trips of the recovery, which the JAX einsum step unrolls); the fused
step to the JAX fused build in the damped 1+log family (m ≠ 2, κ damping,
Γ = 4/3, 7 Newton trips, c_h = 0.8, GLM κ = 2).  Each JAX step runs once
per module, eagerly.  The Pallas kernel's step is
``tests/test_torch_z4_grmhd_2d_pallas.py``; the CUDA kernels are held to
these plain stages on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import z4_grmhd as jg
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu.models.rhs_pallas import with_pallas_rhs
from exahype_tpu_torch.convert import state_from_numpy, state_to_numpy, z4_grmhd_solver_from_jax
from exahype_tpu_torch.models import z4_grmhd as tg
from exahype_tpu_torch.models.aderdg import ADERDGSolver
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs

torch.set_num_threads(1)

GRID = (4, 2)
DX = 0.25
DT = 1e-3
#: The JAX package's Z4+GRMHD tests' gauge and cleaning
#: (``tests/test_z4_grmhd.py:493-496``), with 7 Newton trips of the recovery.
GAUGE = dict(slicing="harmonic", f=0.0, glm_kappa=0.5, iters=7)
#: The algebra's other branches.
DAMPED = dict(slicing="1+log", m=1.5, kappa1=0.1, kappa2=0.3, gamma=4.0 / 3.0, iters=7,
              c_h=0.8, glm_kappa=2.0)
KERNELS = {
    False: ("aderdg_predictor_volume_per_axis_2d_z4_grmhd", "aderdg_face_flux_2d_z4_grmhd",
            "aderdg_surface_update_2d_z4_grmhd"),
    "soa": ("aderdg_predictor_volume_2d_z4_grmhd", "aderdg_face_flux_2d_z4_grmhd",
            "aderdg_surface_update_2d_z4_grmhd"),
}


def _bar(ref):
    return 1e-12 * max(1.0, float(np.abs(ref).max()))


def _port(fused, **params):
    return tg.make_z4_grmhd_solver(2, 2, GRID, dx=DX, fused_rhs=fused, device="cpu", **params)


def _noisy(sol, seed=3):
    """The magnetized wave on ``sol`` with seeded noise of 1e-4 on every
    slot (float64 NumPy, SoA-P)."""
    Q = state_to_numpy(tg.magnetized_wave_state(sol))
    return Q + 1e-4 * np.random.default_rng(seed).standard_normal(Q.shape)


@pytest.fixture(scope="module")
def jax_steps():
    """``{fused: (js, Q, one step)}``: the JAX package's default build
    (per-axis NCP, einsum algebra) in the tests' gauge and the fused build
    in the damped family, each with its eager XLA step from the state."""
    out = {}
    for fused, params in ((False, GAUGE), ("soa", DAMPED)):
        js = jg.make_z4_grmhd_solver(dim=2, order=2, grid_shape=GRID, dx=DX, fused_rhs=fused,
                                     **params)
        Q = _noisy(_port(fused, **params))
        out[fused] = js, Q, np.asarray(js.step(jnp.asarray(Q), DT))
    return out


@pytest.mark.parametrize("fused", [False, "soa"], ids=["per_axis", "fused"])
def test_cpu_stages_are_the_plain_step_bitwise(fused):
    """The wrapper's predictor and face stage on CPU tensors compose the
    plain step bit for bit (the face stage in place, as on the card), its
    kernels are the form's, and nothing launches."""
    sol = _port(fused, **DAMPED)
    cu = CudaADERDG(sol)
    assert cu.kernels == KERNELS[fused] and cu.ncp and cu.walls is None
    assert cu.per_axis == (fused is False)
    u = state_from_numpy(_noisy(sol), device="cpu")
    u0 = u.clone()
    new, faces, fvwall = cu.predictor_volume(u, DT)
    assert fvwall is None and faces.shape == sol.face_shape
    assert not faces[:, 2:, :, :38].any() and faces[:, 2:, :, 38:].any()  # F̄: matter rows only
    out = cu.face_surface(new, faces, DT)
    ref = sol.step(u, DT)
    assert out is new and torch.equal(out, ref)
    assert torch.equal(u, u0)
    assert cu.launches == {name: 0 for name in cu.kernels}
    assert (ref - u).narrow(sol.var_axis, 38, 9).abs().max().item() > 1e-6  # the matter moves


@pytest.mark.parametrize("fused", [False, "soa"], ids=["per_axis", "fused"])
def test_step_matches_jax(jax_steps, fused):
    js, Q, one = jax_steps[fused]
    params = GAUGE if fused is False else DAMPED
    got = state_to_numpy(CudaADERDG(_port(fused, **params)).step(
        state_from_numpy(Q, device="cpu"), DT))
    assert got.shape == js.state_shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, one, rtol=0, atol=_bar(one))
    assert np.abs(one - Q).max() > 1e-5


def test_the_jax_default_build_crosses_to_the_per_axis_kernels(jax_steps):
    """``z4_grmhd_solver_from_jax`` maps the JAX default build to the port's
    per-axis solver, and ``PallasADERDG`` over it to ``CudaADERDG`` with
    ``per_axis`` true and the 2-D kernels' names; the crossed step is the
    JAX one's."""
    js, Q, one = jax_steps[False]
    assert js.rhs_all_fn is None and js.ncp_fn is not None
    cu = z4_grmhd_solver_from_jax(PallasADERDG(js, interpret=True), device="cpu", **GAUGE)
    port = cu.solver
    assert isinstance(port, ADERDGSolver) and port.rhs_all_fn is None
    assert (port.dim, port.order, port.grid_shape, port._dxs, port.picard_iters) == (
        js.dim, js.order, js.grid_shape, js._dxs, js.picard_iters)
    assert isinstance(cu, CudaADERDG) and cu.per_axis and cu.kernels == KERNELS[False]
    got = state_to_numpy(cu.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, one, rtol=0, atol=_bar(one))


def test_per_axis_and_fused_steps_agree():
    """The per-axis and fused builds of one system split the same algebra
    differently: their steps agree to rounding, and both move."""
    u = state_from_numpy(_noisy(_port(False, **DAMPED)), device="cpu")
    a = CudaADERDG(_port(False, **DAMPED)).step(u, DT)
    b = CudaADERDG(_port("soa", **DAMPED)).step(u, DT)
    assert (a - b).abs().max().item() <= 1e-12 * max(1.0, b.abs().max().item())
    assert (b - u).abs().max().item() > 1e-5


def test_k5b_grmhd_instance_matches_jax(jax_steps):
    """K5 b's Z4+GRMHD instance on the CPU (its plain version) against the
    JAX ``PallasRHS`` hook (interpret mode) and ``z4_grmhd_rhs_soa`` itself,
    given two gradient arrays (the third axis's derivatives zero); its
    route's step against the plain step, launching nothing."""
    js, Q, _ = jax_steps["soa"]
    sol = _port("soa", **DAMPED)
    kern = with_cuda_rhs(sol)
    k5 = kern.rhs_all_fn
    assert k5.kernel == "rhs_all_z4_grmhd_2d" and k5.dim == 2
    assert k5._args[-4:] == (DAMPED["gamma"], DAMPED["iters"], DAMPED["c_h"],
                             DAMPED["glm_kappa"])
    rng = np.random.default_rng(11)
    grads = tuple(0.1 * rng.standard_normal(Q.shape) for _ in range(2))
    va = sol.var_axis
    got = k5(torch.from_numpy(Q), tuple(torch.from_numpy(g) for g in grads), va).numpy()
    hook = np.asarray(with_pallas_rhs(js, interpret=True).rhs_all_fn(
        jnp.asarray(Q), tuple(map(jnp.asarray, grads)), va))
    q = np.moveaxis(Q, va, -1)
    dq3 = np.stack([np.moveaxis(g, va, -1) for g in grads] + [np.zeros(q.shape)], axis=-2)
    rhs_kw = {k: v for k, v in DAMPED.items() if k != "c_h"}
    soa = np.moveaxis(np.asarray(jg.z4_grmhd_rhs_soa(jnp.asarray(q), jnp.asarray(dq3),
                                                     **rhs_kw)), -1, va)
    for ref in (hook, soa):
        np.testing.assert_allclose(got, ref, rtol=0, atol=_bar(ref))
    assert np.abs(got).max() > 1e-3
    u = state_from_numpy(Q, device="cpu")
    assert torch.equal(kern.step(u, DT), sol.step(u, DT))
    assert k5.launches == 0  # CPU tensors take the plain route
