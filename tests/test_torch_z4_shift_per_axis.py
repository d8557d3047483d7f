"""The shifted 53-variable Z4 system as the JAX package builds it by default
(the per-axis NCP, ``make_z4_shift_solver(..., fused_rhs=False)``) in 3-D at
order 2, on ``CudaADERDG`` (K1 d's per-axis branch over the shifted system,
``csrc/aderdg_z4_shift_per_axis.cu``, and the fused shifted step's face
pair) on the CPU: the wrapper's stages against the plain solver, one step
against the JAX package's in both shift modes, the crossing of the JAX
default build, and the per-axis step against the fused one.

On CPU tensors ``CudaADERDG`` runs its kernels' plain versions
(``ADERDGSolver.predictor_volume`` / ``face_surface``), so its stages are
bitwise the plain solver's and launch nothing.  Against JAX's
``make_z4_shift_solver(dim=3, order=2, ...)`` (its default
``impl="einsum"`` against the port's SoA algebra: ROADMAP Queue 3's
converter caveat) the bar is 1e-12·max(1, max|ref|) in float64, on (2, 2,
2) cells at dx = 0.5, dt = 1e-3, from the moving gauge wave (v = 0.2,
amplitude 0.01) with seeded noise of 1e-4 on every slot, made with NumPy: on
the exact wave b = B = ∂b = ∂B = 0, so the gradient rows after β's (the
kernel skips slots 38-40) would not show there.  The shift modes are the
frozen shift and the κ₁-damped Gamma-driver of
``tests/test_z4.py:936-940``.  The JAX steps run once per module, eagerly.
The CUDA kernels are held to these plain stages on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import z4 as jz
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu_torch.convert import state_from_numpy, state_to_numpy, z4_shift_solver_from_jax
from exahype_tpu_torch.models import z4 as tz
from exahype_tpu_torch.models.aderdg import ADERDGSolver
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

torch.set_num_threads(1)

GRID = (2, 2, 2)
DX = 0.5
DT = 1e-3
#: The frozen shift and the κ₁-damped Gamma-driver (``tests/test_z4.py:936-940``).
MODES = {"frozen": dict(shift="frozen"),
         "driver": dict(shift="gamma_driver", kappa1=0.2, eta=0.7)}
KERNELS = ("aderdg_predictor_volume_per_axis_z4_shift", "aderdg_face_flux_z4_shift",
           "aderdg_surface_update_z4_shift")


def _bar(ref):
    return 1e-12 * max(1.0, float(np.abs(ref).max()))


def _port(fused_rhs=False, mode="driver"):
    return tz.make_z4_shift_solver(3, 2, GRID, dx=DX, fused_rhs=fused_rhs, device="cpu",
                                   **MODES[mode])


def _noisy(sol, seed=3):
    """The moving gauge wave on ``sol`` with seeded noise of 1e-4 on every
    slot (float64 NumPy, SoA-P)."""
    Q = state_to_numpy(tz.moving_gauge_wave_state(sol, v=0.2, amplitude=0.01))
    return Q + 1e-4 * np.random.default_rng(seed).standard_normal(Q.shape)


@pytest.fixture(scope="module")
def jax_steps():
    """``{mode: (js, Q, one step)}``: the JAX package's default shifted
    solver (per-axis NCP, einsum algebra) in each shift mode and its eager
    XLA step from the state."""
    out = {}
    for mode, params in MODES.items():
        js = jz.make_z4_shift_solver(dim=3, order=2, grid_shape=GRID, dx=DX, **params)
        Q = _noisy(_port(mode=mode))
        out[mode] = js, Q, np.asarray(js.step(jnp.asarray(Q), DT))
    return out


def test_cpu_stages_are_the_plain_step_bitwise():
    """The wrapper's predictor and face stage on CPU tensors compose the
    plain step bit for bit (the face stage in place, as on the card), its
    kernels are the per-axis branch's with the fused step's face pair, and
    nothing launches."""
    sol = _port()
    assert sol.rhs_all_fn is None and sol.ncp_fn is not None and sol.source_fn is not None
    cu = CudaADERDG(sol)
    assert cu.kernels == KERNELS and cu.per_axis and cu.ncp and cu.walls is None
    assert cu._physics_id == 4
    u = state_from_numpy(_noisy(sol), device="cpu")
    u0 = u.clone()
    new, faces, fvwall = cu.predictor_volume(u, DT)
    assert fvwall is None and faces.shape == sol.face_shape and not faces[:, 2:].any()
    out = cu.face_surface(new, faces, DT)
    ref = sol.step(u, DT)
    assert out is new and torch.equal(out, ref)
    assert torch.equal(u, u0)
    assert cu.launches == {name: 0 for name in cu.kernels}
    assert (ref - u).narrow(sol.var_axis, 41, 12).abs().max().item() > 1e-6  # b and B move


@pytest.mark.parametrize("mode", list(MODES))
def test_step_matches_jax(jax_steps, mode):
    js, Q, one = jax_steps[mode]
    got = state_to_numpy(CudaADERDG(_port(mode=mode)).step(state_from_numpy(Q, device="cpu"),
                                                            DT))
    assert got.shape == js.state_shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, one, rtol=0, atol=_bar(one))
    assert np.abs(one - Q).max() > 1e-5


def test_the_jax_default_build_crosses_to_the_per_axis_kernels(jax_steps):
    """``z4_shift_solver_from_jax`` maps the JAX default build (no
    ``rhs_all_fn``) to the port's per-axis solver, and ``PallasADERDG`` over
    it to ``CudaADERDG`` with ``per_axis`` true and the new kernel's name;
    the crossed step is the JAX one's."""
    js, Q, one = jax_steps["driver"]
    assert js.rhs_all_fn is None and js.ncp_fn is not None
    cu = z4_shift_solver_from_jax(PallasADERDG(js, interpret=True), device="cpu",
                                  **MODES["driver"])
    port = cu.solver
    assert isinstance(port, ADERDGSolver) and port.rhs_all_fn is None
    assert (port.dim, port.order, port.grid_shape, port._dxs, port.picard_iters) == (
        js.dim, js.order, js.grid_shape, js._dxs, js.picard_iters)
    assert isinstance(cu, CudaADERDG) and cu.per_axis and cu.kernels == KERNELS
    got = state_to_numpy(cu.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, one, rtol=0, atol=_bar(one))


@pytest.mark.parametrize("mode", list(MODES))
def test_per_axis_and_fused_steps_agree(mode):
    """The per-axis and fused builds split the same algebra differently:
    their steps agree to the JAX package's own bar
    (``tests/test_z4.py::test_fused_rhs_hook_matches_per_axis_path``, 1e-11),
    and both move."""
    u = state_from_numpy(_noisy(_port(mode=mode)), device="cpu")
    a = CudaADERDG(_port(mode=mode)).step(u, DT)
    b = CudaADERDG(_port("soa", mode)).step(u, DT)
    assert (a - b).abs().max().item() <= 1e-11
    assert (b - u).abs().max().item() > 1e-5
