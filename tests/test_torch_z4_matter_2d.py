"""The coupled Z4+GRHD system in 2-D at order 2 on ``CudaADERDG`` (K1 d's 2-D
Z4+GRHD step, ``csrc/aderdg_z4_matter_2d.cu``: the per-axis NCP, the JAX
package's default build, and the fused right-hand side) and K5 b's 2-D
Z4+GRHD instance (``rhs_all_z4_matter_2d``) on the CPU: the wrapper's stages
against the plain solver, the steps and the right-hand side against the JAX
package's, and ``examples/flrw_cosmology.py``'s configuration through
``CudaADERDG``.

On CPU tensors ``CudaADERDG`` and ``CudaRHS`` run their kernels' plain
versions.  The bar against JAX is 1e-12·max(1, max|ref|) in float64 (its
default ``impl="einsum"`` against the port's SoA algebra: ROADMAP Queue 3's
converter caveat), on a fluid with a velocity field over the FLRW metric
with seeded noise on every slot, made with NumPy.  The per-axis step is
held to the JAX solver of the example's own gauge (harmonic slicing, f = 0,
Γ = 5/3) on its grid, (4, 4) cells at dx = 0.25, jitted once per module: the
same compiled step then runs the example's first 10 steps; the fused step
to the JAX eager step in the damped 1+log family on (4, 2) cells.  The
example runs its 100 steps to t = 0.5 through ``CudaADERDG`` and meets its
bars (``examples/flrw_cosmology.py:66-68``).  The Pallas kernel's step is
``tests/test_torch_z4_matter_2d_pallas.py``; the CUDA kernels are held to
these plain stages on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import z4_matter as jm
from exahype_tpu_torch.convert import state_from_numpy, state_to_numpy
from exahype_tpu_torch.models import z4_matter as tm
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs

torch.set_num_threads(1)

DT = 1e-3
#: The example's configuration (``examples/flrw_cosmology.py:36-50``).
EXAMPLE = dict(gamma=5.0 / 3.0, slicing="harmonic", f=0.0)
EX_GRID, EX_DX, EX_T, EX_STEPS = (4, 4), 0.25, 0.5, 100
RHO0, EPS0 = 0.02, 0.4
#: The algebra's other branches (1+log slicing, m ≠ 2, κ damping, Γ = 4/3, 7
#: Newton trips).
DAMPED = dict(slicing="1+log", m=1.5, kappa1=0.1, kappa2=0.3, gamma=4.0 / 3.0, iters=7)
FUSED_GRID = (4, 2)
KERNELS = {
    False: ("aderdg_predictor_volume_per_axis_2d_z4_matter", "aderdg_face_flux_2d_z4_matter",
            "aderdg_surface_update_2d_z4_matter"),
    "soa": ("aderdg_predictor_volume_2d_z4_matter", "aderdg_face_flux_2d_z4_matter",
            "aderdg_surface_update_2d_z4_matter"),
}


def _bar(ref):
    return 1e-12 * max(1.0, float(np.abs(ref).max()))


def _adot():
    return float(np.sqrt(8.0 * np.pi * RHO0 * (1.0 + EPS0) / 3.0))


def _port(fused, grid, **params):
    return tm.make_z4_matter_solver(2, 2, grid, dx=EX_DX, fused_rhs=fused, device="cpu",
                                    **params)


def _noisy(sol, seed=3):
    """The FLRW metric with noise of 0.05 on every Z4 slot and a fluid with ρ
    ≈ 0.02, p ≈ 0.005 and velocities up to 0.15 a component, then noise of
    1e-4 on every slot (float64 NumPy, SoA-P)."""
    rng = np.random.default_rng(seed)
    va = sol.var_axis
    lead = sol.state_shape[:va] + sol.state_shape[va + 1:]
    z4 = 0.05 * rng.standard_normal(lead + (38,))
    z4[..., [0, 1, 4, 6]] += 1.0
    z4[..., [7, 10, 12]] -= _adot()
    rho = RHO0 * (1.0 + 0.1 * rng.random(lead))
    p = 0.005 * (1.0 + 0.1 * rng.random(lead))
    v = 0.3 * (rng.random(lead + (3,)) - 0.5)
    q = np.array(jm.pack_matter(jnp.asarray(z4), jnp.asarray(rho), jnp.asarray(v),
                                jnp.asarray(p)))
    q = np.moveaxis(q, -1, va)
    return q + 1e-4 * rng.standard_normal(q.shape)


@pytest.fixture(scope="module")
def example_jax():
    """``(js, step)``: the example's JAX solver (the default build: per-axis
    NCP, einsum algebra) and its step, jitted once (dt traced)."""
    js = jm.make_z4_matter_solver(dim=2, order=2, grid_shape=EX_GRID, dx=EX_DX, **EXAMPLE)
    return js, jax.jit(js.step)


@pytest.mark.parametrize("fused", [False, "soa"], ids=["per_axis", "fused"])
def test_cpu_stages_are_the_plain_step_bitwise(fused):
    """The wrapper's predictor and face stage on CPU tensors compose the
    plain step bit for bit (the face stage in place, as on the card), its
    kernels are the form's, and nothing launches."""
    sol = _port(fused, FUSED_GRID, **DAMPED)
    cu = CudaADERDG(sol)
    assert cu.kernels == KERNELS[fused] and cu.ncp and cu.walls is None
    assert cu.per_axis == (fused is False)
    u = state_from_numpy(_noisy(sol), device="cpu")
    u0 = u.clone()
    new, faces, fvwall = cu.predictor_volume(u, DT)
    assert fvwall is None and faces.shape == sol.face_shape
    assert not faces[:, 2:, :, :38].any() and faces[:, 2:, :, 38:].any()  # F̄: hydro rows only
    out = cu.face_surface(new, faces, DT)
    ref = sol.step(u, DT)
    assert out is new and torch.equal(out, ref)
    assert torch.equal(u, u0)
    assert cu.launches == {name: 0 for name in cu.kernels}
    assert (ref - u).narrow(sol.var_axis, 38, 5).abs().max().item() > 1e-6  # the fluid moves


def test_per_axis_step_matches_jax(example_jax):
    js, step = example_jax
    Q = _noisy(_port(False, EX_GRID, **EXAMPLE))
    ref = np.asarray(step(jnp.asarray(Q), DT))
    got = state_to_numpy(CudaADERDG(_port(False, EX_GRID, **EXAMPLE)).step(
        state_from_numpy(Q, device="cpu"), DT))
    assert got.shape == js.state_shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_bar(ref))
    assert np.abs(ref - Q).max() > 1e-5


def test_fused_step_matches_jax():
    js = jm.make_z4_matter_solver(dim=2, order=2, grid_shape=FUSED_GRID, dx=EX_DX,
                                  fused_rhs="soa", **DAMPED)
    Q = _noisy(_port("soa", FUSED_GRID, **DAMPED))
    ref = np.asarray(js.step(jnp.asarray(Q), DT))
    got = state_to_numpy(CudaADERDG(_port("soa", FUSED_GRID, **DAMPED)).step(
        state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, ref, rtol=0, atol=_bar(ref))
    assert np.abs(ref - Q).max() > 1e-5


def test_k5b_matter_instance_matches_jax():
    """K5 b's Z4+GRHD instance on the CPU (its plain version) against the
    JAX fused hook and ``z4_matter_rhs_soa`` itself, given two gradient
    arrays (the third axis's derivatives zero); its route's step against the
    plain step, launching nothing."""
    sol = _port("soa", FUSED_GRID, **DAMPED)
    kern = with_cuda_rhs(sol)
    k5 = kern.rhs_all_fn
    assert k5.kernel == "rhs_all_z4_matter_2d" and k5.dim == 2
    js = jm.make_z4_matter_solver(dim=2, order=2, grid_shape=FUSED_GRID, dx=EX_DX,
                                  fused_rhs="soa", **DAMPED)
    rng = np.random.default_rng(11)
    Q = _noisy(sol)
    grads = tuple(0.1 * rng.standard_normal(Q.shape) for _ in range(2))
    va = sol.var_axis
    got = k5(torch.from_numpy(Q), tuple(torch.from_numpy(g) for g in grads), va).numpy()
    hook = np.asarray(js.rhs_all_fn(jnp.asarray(Q), tuple(map(jnp.asarray, grads)), va))
    q = np.moveaxis(Q, va, -1)
    dq3 = np.stack([np.moveaxis(g, va, -1) for g in grads] + [np.zeros(q.shape)], axis=-2)
    soa = np.moveaxis(np.asarray(jm.z4_matter_rhs_soa(jnp.asarray(q), jnp.asarray(dq3),
                                                      **DAMPED)), -1, va)
    for ref in (hook, soa):
        np.testing.assert_allclose(got, ref, rtol=0, atol=_bar(ref))
    assert np.abs(got).max() > 1e-3
    u = state_from_numpy(Q, device="cpu")
    assert torch.equal(kern.step(u, DT), sol.step(u, DT))
    assert k5.launches == 0  # CPU tensors take the plain route


def test_example_through_cuda_aderdg_meets_its_bars(example_jax):
    """``examples/flrw_cosmology.py``'s configuration ((4, 4) p2, dx = 0.25,
    geodesic slicing, Γ = 5/3, the per-axis NCP solver it builds) through
    ``CudaADERDG``: its first 10 steps against the JAX solver's, then its 100
    steps to t = 0.5 held to its bars: a² = γ_xx within 1e-7 of the
    Friedmann reference, D̃ within 1e-9 of ρ₀, |Θ| and |Z| under 1e-9."""
    js, step = example_jax
    sol = _port(False, EX_GRID, **EXAMPLE)
    cu = CudaADERDG(sol)
    assert cu.per_axis and cu.kernels == KERNELS[False]
    dt = EX_T / EX_STEPS
    Q = tm.flrw_state(sol, 1.0, _adot(), rho0=RHO0, eps0=EPS0, gamma=EXAMPLE["gamma"])
    ref = jnp.asarray(state_to_numpy(Q))
    for _ in range(10):
        ref = step(ref, dt)
    Q = cu.run(Q, 10, dt)
    ref = np.asarray(ref)
    np.testing.assert_allclose(state_to_numpy(Q), ref, rtol=0, atol=_bar(ref))
    Q = cu.run(Q, EX_STEPS - 10, dt)
    a_ref, adot_ref = tm.flrw_reference(EX_T, rho0=RHO0, eps0=EPS0, gamma=EXAMPLE["gamma"])
    q = torch.movedim(Q, sol.var_axis, -1).numpy()
    gxx, Kxx, Dt = q[..., 1].ravel()[0], q[..., 7].ravel()[0], q[..., 38].ravel()[0]
    assert abs(gxx - a_ref**2) / a_ref**2 < 1e-7
    assert abs(Kxx + a_ref * adot_ref) / abs(a_ref * adot_ref) < 1e-6
    assert abs(Dt - RHO0) / RHO0 < 1e-9
    assert np.abs(q[..., 13]).max() < 1e-9 and np.abs(q[..., 14:17]).max() < 1e-9
    assert cu.launches == {name: 0 for name in cu.kernels}
