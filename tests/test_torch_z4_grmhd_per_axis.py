"""The coupled Z4+GRMHD system as the JAX package builds it by default (the
per-axis NCP, ``make_z4_grmhd_solver(..., fused_rhs=False)``) in 3-D at
order 2, on ``CudaADERDG`` (K1 d's per-axis branch with a conservative flux,
``csrc/aderdg_z4_grmhd_per_axis.cu``, and the fused step's face pair) on
the CPU: the wrapper's stages against the plain solver, one step against
the JAX package's, the crossing of the JAX default build, and the per-axis
step against the fused one.

On CPU tensors ``CudaADERDG`` runs its kernels' plain versions
(``ADERDGSolver.predictor_volume`` / ``face_surface``), so its stages are
bitwise the plain solver's and launch nothing.  Against JAX's
``make_z4_grmhd_solver(dim=3, order=2, ...)`` (its default ``impl="einsum"``
against the port's SoA algebra: ROADMAP Queue 3's converter caveat) the bar
is 1e-12·max(1, max|ref|) in float64, on (2, 2, 2) cells at dx = 0.5 (a
unit axis 0), dt = 1e-3, on the magnetized wave of the JAX package's tests
(``tests/test_z4_grmhd.py::_magnetized_wave_state``: a field nowhere zero)
with seeded noise of 1e-4 on every slot, made with NumPy, in the algebra's
damped 1+log family (m ≠ 2, κ damping, Γ = 4/3, 7 Newton trips, c_h = 0.8,
GLM κ = 2).  The JAX step runs once per module, eagerly.  The CUDA kernels
are held to these plain stages on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import z4_grmhd as jg
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu_torch.convert import state_from_numpy, state_to_numpy, z4_grmhd_solver_from_jax
from exahype_tpu_torch.models import z4_grmhd as tg
from exahype_tpu_torch.models.aderdg import ADERDGSolver
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

torch.set_num_threads(1)

GRID = (2, 2, 2)
DX = 0.5
DT = 1e-3
FAMILY = dict(slicing="1+log", m=1.5, kappa1=0.1, kappa2=0.3, gamma=4.0 / 3.0, iters=7,
              c_h=0.8, glm_kappa=2.0)
KERNELS = ("aderdg_predictor_volume_per_axis_z4_grmhd", "aderdg_face_flux_z4_grmhd",
           "aderdg_surface_update_z4_grmhd")


def _bar(ref):
    return 1e-12 * max(1.0, float(np.abs(ref).max()))


def _port(fused_rhs=False, **kw):
    return tg.make_z4_grmhd_solver(3, 2, GRID, dx=DX, fused_rhs=fused_rhs, device="cpu",
                                   **{**FAMILY, **kw})


def _noisy(sol, seed=3):
    """The magnetized wave on ``sol`` with seeded noise of 1e-4 on every
    slot (float64 NumPy, SoA-P)."""
    Q = state_to_numpy(tg.magnetized_wave_state(sol))
    return Q + 1e-4 * np.random.default_rng(seed).standard_normal(Q.shape)


@pytest.fixture(scope="module")
def jax_step():
    """``(js, Q, one step)``: the JAX package's default Z4+GRMHD solver
    (per-axis NCP, einsum algebra) and its eager XLA step from the state."""
    js = jg.make_z4_grmhd_solver(dim=3, order=2, grid_shape=GRID, dx=DX, **FAMILY)
    Q = _noisy(_port())
    return js, Q, np.asarray(js.step(jnp.asarray(Q), DT))


def test_cpu_stages_are_the_plain_step_bitwise():
    """The wrapper's predictor and face stage on CPU tensors compose the
    plain step bit for bit (the face stage in place, as on the card), its
    kernels are the per-axis branch's with the fused step's face pair, and
    nothing launches."""
    sol = _port()
    assert sol.rhs_all_fn is None and sol.ncp_fn is not None and sol.source_fn is not None
    cu = CudaADERDG(sol)
    assert cu.kernels == KERNELS and cu.per_axis and cu.ncp and cu.walls is None
    assert cu._physics_id == 6
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


def test_step_matches_jax(jax_step):
    js, Q, one = jax_step
    cu = CudaADERDG(_port())
    got = state_to_numpy(cu.step(state_from_numpy(Q, device="cpu"), DT))
    assert got.shape == js.state_shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, one, rtol=0, atol=_bar(one))
    assert np.abs(one - Q).max() > 1e-5


def test_the_jax_default_build_crosses_to_the_per_axis_kernels(jax_step):
    """``z4_grmhd_solver_from_jax`` maps the JAX default build (no
    ``rhs_all_fn``) to the port's per-axis solver, and ``PallasADERDG`` over
    it to ``CudaADERDG`` with ``per_axis`` true, the new kernels' names; the
    crossed step is the JAX one's."""
    js, Q, one = jax_step
    assert js.rhs_all_fn is None and js.ncp_fn is not None
    cu = z4_grmhd_solver_from_jax(PallasADERDG(js, interpret=True), device="cpu", **FAMILY)
    port = cu.solver
    assert isinstance(port, ADERDGSolver) and port.rhs_all_fn is None
    assert (port.dim, port.order, port.grid_shape, port._dxs, port.picard_iters) == (
        js.dim, js.order, js.grid_shape, js._dxs, js.picard_iters)
    assert isinstance(cu, CudaADERDG) and cu.per_axis and cu.kernels == KERNELS
    got = state_to_numpy(cu.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, one, rtol=0, atol=_bar(one))


def test_per_axis_and_fused_steps_agree():
    """The per-axis and fused builds of one system split the same algebra
    differently: their steps agree to rounding, and both move."""
    u = state_from_numpy(_noisy(_port()), device="cpu")
    a = CudaADERDG(_port()).step(u, DT)
    b = CudaADERDG(_port(fused_rhs="soa")).step(u, DT)
    assert (a - b).abs().max().item() <= 1e-12 * max(1.0, b.abs().max().item())
    assert (b - u).abs().max().item() > 1e-5
