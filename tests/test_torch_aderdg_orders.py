"""3-D Euler ADER-DG at orders 4 and 7 in the port against the JAX package,
on the CPU: the plain solver's operators, ``cfl_dt`` and steps against
JAX's ``ADERDGSolver``, one step against the fused TPU kernel
(``PallasADERDG(interpret=True)``, whose ``picard_loop`` tier is on at both
orders and ``slice_loop`` at order 7), the stability of ``cfl_dt`` on a
cut grid, and ``aderdg_from_jax``'s map onto ``CudaADERDG``'s order-4 and
order-7 kernels.

Inputs are made with NumPy from a seed: ``examples/high_order_p5.py``'s
exact density wave (γ = 1.4, p0 = 2, velocity (1, 0.5, 0.25)) with seeded
noise on the density (``tests/test_torch_aderdg_p5.py::wave_state``).
Tolerance: f64 at rtol=0, atol=1e-12 (the repo's JAX↔Pallas bar).  The
kernels themselves are held against these plain versions on the card in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import euler_physics as jax_euler_physics
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu_torch.convert import aderdg_from_jax, state_from_numpy, state_to_numpy
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from tests.test_torch_aderdg_p5 import GAMMA, wave_state

torch.set_num_threads(1)

#: The smallest grids of each order that keep every axis's neighbour
#: distinct from the cell (but axis 1 at order 7, one cell: periodic onto
#: itself), dx = 1/g0.
GRIDS = {4: (2, 2, 3), 7: (2, 1, 2)}
DT = 1e-3  # under cfl_dt of the noisy wave at both orders (checked below)


def jax_solver(order, grid=None):
    grid = grid or GRIDS[order]
    flux, eig = jax_euler_physics(dim=3, n_real=5)
    return JaxSolver(dim=3, order=order, n_vars=5, grid_shape=grid, flux_fn=flux,
                     max_eigenvalue_fn=eig, dx=1.0 / grid[0])


@pytest.fixture(scope="module", params=[4, 7], ids=["p4", "p7"])
def pair(request):
    js = jax_solver(request.param)
    return js, aderdg_from_jax(js, gamma=GAMMA, device="cpu"), wave_state(js, noise=0.05)


def test_plain_solver_keeps_the_jax_operators_and_defaults(pair):
    js, ts, _ = pair
    n = js.order + 1
    assert ts.picard_iters == js.picard_iters == n  # JAX aderdg.py:355-356
    assert ts.n_nodes == n and ts.state_shape == (n, n, n, 5) + js.grid_shape
    assert ts.face_shape == (3, 4, n * n, 5) + js.grid_shape
    for name in ("D", "K1inv", "Kvol", "weights", "phi0", "phi1"):
        np.testing.assert_allclose(np.asarray(getattr(ts.ops, name)),
                                   np.asarray(getattr(js.ops, name)), rtol=0, atol=1e-12,
                                   err_msg=name)


def test_cfl_dt_matches_jax(pair):
    js, ts, Q = pair
    ref = float(js.cfl_dt(jnp.asarray(Q)))
    got = float(ts.cfl_dt(state_from_numpy(Q, device="cpu")))
    assert got == pytest.approx(ref, rel=1e-14, abs=0)
    assert DT < got


def test_steps_match_jax_solver(pair):
    js, ts, Q = pair
    jstep = jax.jit(lambda q: js.step(q, DT))
    ref, u = jnp.asarray(Q), state_from_numpy(Q, device="cpu")
    for _ in range(3):
        ref, u = jstep(ref), ts.step(u, DT)
        np.testing.assert_allclose(state_to_numpy(u), np.asarray(ref), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(state_to_numpy(ts.run(state_from_numpy(Q, device="cpu"), 3,
                                                        DT)), state_to_numpy(u))


def test_step_matches_pallas_interpret(pair):
    """One step against the JAX package's fused TPU kernel in interpret
    mode (its streamed ``picard_loop`` tier; ``slice_loop`` too at order 7)."""
    js, ts, Q = pair
    fused = PallasADERDG(js, interpret=True, tile0=js.grid_shape[0], dtype=np.float64)
    assert fused.slice_loop is None  # auto: on from 7 nodes an axis
    got = np.asarray(fused.step(jnp.asarray(Q), DT))
    out = state_to_numpy(ts.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(out, got, rtol=0, atol=1e-12)


def test_aderdg_from_jax_maps_pallas_to_cuda_aderdg(pair):
    js, ts, Q = pair
    cu = aderdg_from_jax(PallasADERDG(js, tile0=1, dtype=np.float64), gamma=GAMMA, device="cpu")
    p = f"_p{js.order}"
    assert isinstance(cu, CudaADERDG)
    assert cu.kernels == ("aderdg_predictor_volume" + p, "aderdg_face_flux" + p,
                          "aderdg_surface_update" + p)
    # The occupancy query's indices (csrc/aderdg.cu, exahype_aderdg_kernel_info).
    first = {4: 36, 7: 41}[js.order]
    assert [CudaADERDG.KERNELS.index(name) for name in cu.kernels] == [first, first + 1,
                                                                       first + 2]
    assert cu.walls is None and not cu.ncp
    u = state_from_numpy(Q, device="cpu")
    out = cu.run(u, 2, DT)
    np.testing.assert_array_equal(state_to_numpy(out), state_to_numpy(ts.run(u, 2, DT)))
    assert cu.launches == {name: 0 for name in cu.kernels}
    new, faces, fvwall = cu.predictor_volume(u, DT)
    assert tuple(new.shape) == ts.state_shape and tuple(faces.shape) == ts.face_shape
    assert fvwall is None


@pytest.mark.parametrize("order", [4, 7])
def test_cfl_dt_steps_stay_bounded_in_both_packages(order):
    """The step at ``cfl_dt`` (factor min(0.4, 1.5/(N+2)): 0.25 at order 4,
    1/6 at order 7) on a cut grid in float64: 10 steps of the noisy wave in
    both packages agree at 1e-12, and neither the largest value nor the L2
    norm of the state's deviation from its mean grows (the scheme's
    stability at the step the card runs; 200 steps hold the same at orders
    4, 5 and 7)."""
    js = jax_solver(order, (2, 2, 2))  # dx = 1/2: the wave is periodic
    ts = aderdg_from_jax(js, gamma=GAMMA, device="cpu")
    Q = wave_state(js, noise=0.05, seed=order)
    u0 = state_from_numpy(Q, device="cpu")
    dt = float(ts.cfl_dt(u0))
    assert dt == pytest.approx(float(js.cfl_dt(jnp.asarray(Q))), rel=1e-14, abs=0)
    jrun = jax.jit(lambda q: js.run(q, 10, dt))
    ref = np.asarray(jrun(jnp.asarray(Q)))
    out = state_to_numpy(ts.run(u0, 10, dt))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)

    def deviation(x):  # per variable, over nodes and cells (var axis 3)
        return np.sqrt(((x - x.mean(axis=(0, 1, 2, 4, 5, 6), keepdims=True)) ** 2).sum())

    assert np.isfinite(out).all() and np.abs(out).max() <= np.abs(Q).max()
    assert deviation(out) <= deviation(Q)
