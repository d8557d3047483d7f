"""The port's dynamic-GR slice as a whole: the 38-variable vacuum Z4 step
of ``scripts/z4_probe.py``'s production path (``make_z4_solver(dim=3,
order=2, impl="soa", fused_rhs="soa")`` on the gauge wave), built on both
sides, in f64.

Depth is cut (``(4, 2, 4)`` cells at dx = 0.25 instead of ``(16, 16, 128)``
at 1/128); the order, the system, its parameters and the initial state's
recipe are the probe's, dt is under the CFL limit (5e-3 against 1.79e-2).
The bar is 1e-12·max(1, max|ref|) per step (the state is ~1): the
reference and the port add the same terms in orders that differ only in
the corrector's volume terms.  The JAX steps run once per module (each
costs seconds on a CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import z4 as jz
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.rhs_pallas import with_pallas_rhs
from exahype_tpu_torch.convert import (
    aderdg_from_jax,
    state_from_numpy,
    state_to_numpy,
    z4_solver_from_jax,
)
from exahype_tpu_torch.models import subcell_cuda
from exahype_tpu_torch.models import z4 as tz
from exahype_tpu_torch.models.aderdg import euler_physics
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.limiter import LimitedADERDG
from exahype_tpu_torch.models.rhs_cuda import CudaRHS, with_cuda_rhs
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError

torch.set_num_threads(1)

GRID = (4, 2, 4)
DX = 0.25
DT = 5e-3
AMPLITUDE = 0.1
STEPS = 3


def _bar(ref):
    return 1e-12 * max(1.0, float(np.abs(ref).max()))


def _port(**kw):
    kw.setdefault("fused_rhs", "soa")
    return tz.make_z4_solver(3, 2, GRID, dx=DX, impl="soa", device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX solver, its initial state, its states after 1..3 steps, and
    one step of ``with_pallas_rhs(interpret=True)``."""
    js = jz.make_z4_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa",
                           fused_rhs="soa")
    Q = np.asarray(jz.gauge_wave_state(js, amplitude=AMPLITUDE))
    states, q = [], jnp.asarray(Q)
    for _ in range(STEPS):
        q = js.step(q, DT)
        states.append(np.asarray(q))
    pallas = np.asarray(with_pallas_rhs(js, interpret=True).step(jnp.asarray(Q), DT))
    return js, Q, states, pallas


def test_one_step_matches_jax_and_pallas_interpret(jax_run):
    js, Q, states, pallas = jax_run
    got = state_to_numpy(_port().step(state_from_numpy(Q, device="cpu"), DT))
    assert got.shape == js.state_shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, states[0], rtol=0, atol=_bar(states[0]))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=_bar(pallas))
    assert np.abs(got - Q).max() > 1e-3  # the step moved the state


def test_three_steps_match_jax(jax_run):
    _, Q, states, _ = jax_run
    port = _port()
    u = state_from_numpy(Q, device="cpu")
    for k, ref in enumerate(states):
        u = port.step(u, DT)
        np.testing.assert_allclose(
            state_to_numpy(u), ref, rtol=0, atol=_bar(ref), err_msg=f"step {k + 1}"
        )
    np.testing.assert_array_equal(state_to_numpy(port.run(state_from_numpy(Q, device="cpu"),
                                                          STEPS, DT)), state_to_numpy(u))


def test_fused_step_matches_per_axis_step(jax_run):
    """``fused_rhs="soa"`` against the per-axis NCP/source path (2·dim + 1
    evaluations a Picard iteration): equal by the affinity of the RHS."""
    _, Q, states, _ = jax_run
    per_axis = _port(fused_rhs=False)
    assert per_axis.rhs_all_fn is None and per_axis.ncp_fn is not None
    u = state_from_numpy(Q, device="cpu")
    fused = state_to_numpy(_port().step(u, DT))
    unfused = state_to_numpy(per_axis.step(u, DT))
    np.testing.assert_allclose(unfused, fused, rtol=0, atol=_bar(fused))
    np.testing.assert_allclose(unfused, states[0], rtol=0, atol=_bar(states[0]))


def test_z4_solver_from_jax_carries_solver_and_state(jax_run):
    js, Q, states, _ = jax_run
    port = z4_solver_from_jax(js, device="cpu")
    assert port.rhs_all_fn is not None and not isinstance(port.rhs_all_fn, CudaRHS)
    assert (port.dim, port.order, port.grid_shape, port._dxs, port.picard_iters) == (
        js.dim, js.order, js.grid_shape, js._dxs, js.picard_iters)
    got = state_to_numpy(port.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, states[0], rtol=0, atol=_bar(states[0]))
    # A Pallas-accelerated JAX solver maps to the CUDA kernel's wrapper.
    accel = z4_solver_from_jax(with_pallas_rhs(js, interpret=True), device="cpu")
    assert isinstance(accel.rhs_all_fn, CudaRHS)
    np.testing.assert_array_equal(
        state_to_numpy(accel.step(state_from_numpy(Q, device="cpu"), DT)), got
    )
    assert accel.rhs_all_fn.launches == 0  # CPU tensors take the plain version
    # Without the fused hook the port takes the per-axis NCP path.
    unfused = jz.make_z4_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa")
    assert z4_solver_from_jax(unfused, device="cpu").rhs_all_fn is None


def test_parameters_cross_with_the_solver():
    """1+log slicing with κ damping, one step against JAX."""
    kw = dict(slicing="1+log", kappa1=0.3, kappa2=0.2)
    js = jz.make_z4_solver(dim=3, order=2, grid_shape=GRID, dx=DX, impl="soa",
                           fused_rhs="soa", **kw)
    Q = np.asarray(jz.gauge_wave_state(js, amplitude=AMPLITUDE))
    Q = Q + 1e-3 * np.random.default_rng(4).standard_normal(Q.shape)
    ref = np.asarray(js.step(jnp.asarray(Q), DT))
    port = z4_solver_from_jax(js, device="cpu", **kw)
    assert port.rhs_all_fn.physics.params == ("1+log", 1.0, 2.0, 0.3, 0.2)
    got = state_to_numpy(port.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, ref, rtol=0, atol=_bar(ref))


def test_cuda_rhs_on_cpu_tensors_is_the_plain_version(jax_run):
    _, Q, _, _ = jax_run
    plain = _port()
    accel = with_cuda_rhs(plain)
    assert accel is not plain and isinstance(accel.rhs_all_fn, CudaRHS)
    assert accel.rhs_all_fn.inner is plain.rhs_all_fn
    rng = np.random.default_rng(1)
    q = torch.from_numpy(Q.copy())
    grads = tuple(torch.from_numpy(rng.standard_normal(Q.shape) * 0.1) for _ in range(3))
    assert torch.equal(accel.rhs_all_fn(q, grads, 3), plain.rhs_all_fn(q, grads, 3))
    u = state_from_numpy(Q, device="cpu")
    assert torch.equal(accel.step(u, DT), plain.step(u, DT))
    assert accel.rhs_all_fn.launches == 0


def _rhs_inputs(Q):
    rng = np.random.default_rng(2)
    q = torch.from_numpy(Q.copy())
    return q, tuple(torch.from_numpy(rng.standard_normal(Q.shape)) for _ in range(3))


@pytest.mark.parametrize(
    "bad,match",
    [
        (lambda q, g: (q, g[:2]), "expected 3 gradient arrays"),
        (lambda q, g: (q, (g[0], g[1][..., :1], g[2])), r"grads\[1\]"),
        (lambda q, g: (q, (g[0], g[1], g[2].float())), r"grads\[2\]"),
        (lambda q, g: (q, (g[0].reshape(-1).reshape(q.shape[::-1]), g[1], g[2])), r"grads\[0\]"),
    ],
    ids=["count", "shape", "dtype", "same_size_other_shape"],
)
def test_cuda_rhs_refuses_mismatched_gradients(jax_run, bad, match):
    """The Pallas wrapper reshapes gradients silently; the port's refuses
    any that is not Q's shape, dtype and device, on either device."""
    q, grads = bad(*_rhs_inputs(jax_run[1]))
    with pytest.raises(LoweringError, match=match):
        with_cuda_rhs(_port()).rhs_all_fn(q, grads, 3)


def test_refusals():
    with pytest.raises(SemanticError, match="impl='einsum'"):
        tz.make_z4_solver(3, 2, GRID, dx=DX, impl="einsum", device="cpu")
    with pytest.raises(SemanticError, match="impl='einsum'"):
        tz.z4_system(impl="einsum")
    assert tz.make_z4_solver(3, 2, GRID, dx=DX, device="cpu").n_vars == 38  # impl="soa"
    with pytest.raises(SemanticError, match="fused_rhs=True"):
        tz.make_z4_solver(3, 2, GRID, dx=DX, impl="soa", fused_rhs=True, device="cpu")
    with pytest.raises(ValueError, match="slicing"):
        tz.make_z4_solver(3, 2, GRID, dx=DX, impl="soa", slicing="maximal", device="cpu")
    # On the CK path the plain solver carries the Z4 callbacks (ROADMAP Queue
    # 1 item 8); the CUDA kernels do not (Queue 2 K2 a).
    ck = tz.make_z4_solver(3, 2, GRID, dx=DX, impl="soa", predictor_mode="ck", device="cpu")
    with pytest.raises(LoweringError, match=r"ROADMAP.md, Queue 2 K2 a"):
        CudaADERDG(ck)
    with pytest.raises(LoweringError, match="rhs_all_fn set"):
        with_cuda_rhs(_port(fused_rhs=False))
    # K5 b: the 38-variable system at dim=2 is accepted (two gradient
    # arrays; on the CPU the plain route), and so is the shifted one, which
    # was refused until its 2-D instance existed.
    sol2 = tz.make_z4_solver(2, 2, (4, 2), dx=DX, impl="soa", fused_rhs="soa", device="cpu")
    k5b = with_cuda_rhs(sol2)
    assert k5b.rhs_all_fn.kernel == "rhs_all_z4_2d"
    u2 = tz.gauge_wave_state(sol2, amplitude=0.1)
    assert torch.equal(k5b.step(u2, 1e-4), sol2.step(u2, 1e-4))
    assert k5b.rhs_all_fn.launches == 0  # CPU tensors take the plain route
    shifted = with_cuda_rhs(tz.make_z4_shift_solver(2, 2, (4, 2), dx=DX, fused_rhs="soa",
                                                    device="cpu"))
    assert shifted.rhs_all_fn.kernel == "rhs_all_z4_shift_2d"
    flux, eig = euler_physics(3)
    for rhs_all in (lambda q, g, va: q, flux):  # untagged; tagged Euler
        with pytest.raises(LoweringError, match="38-variable vacuum Z4"):
            CudaRHS(rhs_all, 3, 38)
    # The limiter takes the NCP solver since ROADMAP Queue 1 item 9.4; the
    # sweep kernel has no vacuum Z4 instance: Queue 2 K3 a.
    lim = LimitedADERDG(_port(), troubled_capacity=8, troubled_granularity="row",
                        subcell_cuda=True, device="cpu")
    with pytest.raises(LoweringError, match=r"ROADMAP.md, Queue 2 K3 a"):
        subcell_cuda.check_physics(lim)


def test_jax_callbacks_do_not_cross_through_aderdg_from_jax(jax_run):
    with pytest.raises(SemanticError, match="z4_solver_from_jax"):
        aderdg_from_jax(jax_run[0], physics=euler_physics(3), device="cpu")
    flux, eig = jz.z4_system(impl="soa")[:2]
    euler_like = JaxSolver(dim=3, order=2, n_vars=5, grid_shape=GRID, flux_fn=flux,
                           max_eigenvalue_fn=eig)
    with pytest.raises(SemanticError, match="not a vacuum Z4 solver"):
        z4_solver_from_jax(euler_like, device="cpu")


def test_make_z4_solver_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tz.make_z4_solver(3, 2, GRID, dx=DX, impl="soa", fused_rhs="soa")
