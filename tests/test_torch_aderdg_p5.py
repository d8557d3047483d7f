"""Order-5 3-D Euler (``examples/high_order_p5.py``'s step) in the port
against the JAX package, on the CPU.

Inputs are made with NumPy from a seed (the example's exact density wave,
γ = 1.4, p0 = 2, velocity (1, 0.5, 0.25), with seeded noise on the
density where the exact wave alone would leave terms untested) and handed
to both packages.  Tolerance: f64 at rtol=0, atol=1e-12 (the repo's
JAX↔Pallas bar; ``tests/test_aderdg.py``'s own order-5 Pallas tests hold
1e-13 and 1e-12).  The order-5 kernels themselves are held against these
plain versions on the card in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import euler_physics as jax_euler_physics
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu_torch.convert import aderdg_from_jax, state_from_numpy, state_to_numpy
from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics, euler_reflect
from exahype_tpu_torch.models.aderdg import euler_reflect_flux
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.navier_stokes import navier_stokes
from exahype_tpu_torch.utils.errors import LoweringError

torch.set_num_threads(1)

ORDER = 5
GRID = (2, 2, 4)
GAMMA, P0 = 1.4, 2.0
VEL = (1.0, 0.5, 0.25)


def jax_solver(grid=GRID):
    flux, eig = jax_euler_physics(dim=3, n_real=5)
    return JaxSolver(dim=3, order=ORDER, n_vars=5, grid_shape=grid, flux_fn=flux,
                     max_eigenvalue_fn=eig, dx=1.0 / grid[0])


def wave_state(solver, t=0.0, noise=0.0, seed=0):
    """``examples/high_order_p5.py:61-76``'s exact density wave at time
    ``t``, its density times 1 + ``noise`` · N(0, 1) from ``seed``."""
    coords = solver.nodes_meshgrid()
    phase = sum(np.asarray(c) - v * t for c, v in zip(coords, VEL))
    va = solver.var_axis
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    rho = np.broadcast_to(np.squeeze(1.0 + 0.2 * np.sin(2 * np.pi * phase), va), no_var)
    rho = rho * (1.0 + noise * np.random.default_rng(seed).standard_normal(no_var))
    E = P0 / (GAMMA - 1.0) + 0.5 * rho * sum(v * v for v in VEL)
    return np.stack([rho] + [rho * v for v in VEL] + [E], axis=va)


@pytest.fixture(scope="module")
def pair():
    js = jax_solver()
    return js, aderdg_from_jax(js, gamma=GAMMA, device="cpu"), wave_state(js, noise=0.05)


def test_plain_solver_keeps_the_jax_defaults(pair):
    js, ts, _ = pair
    assert ts.picard_iters == js.picard_iters == ORDER + 1
    assert ts.basis == js.basis == "legendre"
    assert ts.n_nodes == 6 and ts.state_shape == (6, 6, 6, 5) + GRID
    assert ts.face_shape == (3, 4, 36, 5) + GRID


def test_p5_steps_match_jax_solver(pair):
    js, ts, Q = pair
    ref, u = jnp.asarray(Q), state_from_numpy(Q, device="cpu")
    for _ in range(3):
        ref, u = js.step(ref, 2e-3), ts.step(u, 2e-3)
        np.testing.assert_allclose(state_to_numpy(u), np.asarray(ref), rtol=0, atol=1e-12)


def test_p5_step_matches_pallas_interpret(pair):
    """One step against the JAX package's fused TPU kernel in interpret
    mode (its streamed ``picard_loop`` tier, on at order 5)."""
    js, ts, Q = pair
    fused = PallasADERDG(js, interpret=True, tile0=2, dtype=np.float64)
    got = np.asarray(fused.step(jnp.asarray(Q), 2e-3))
    out = state_to_numpy(ts.step(state_from_numpy(Q, device="cpu"), 2e-3))
    np.testing.assert_allclose(out, got, rtol=0, atol=1e-12)


def test_aderdg_from_jax_maps_pallas_to_cuda_aderdg(pair):
    js, ts, Q = pair
    cu = aderdg_from_jax(PallasADERDG(js, tile0=1, dtype=np.float64), gamma=GAMMA, device="cpu")
    assert isinstance(cu, CudaADERDG)
    assert cu.kernels == ("aderdg_predictor_volume_p5", "aderdg_face_flux_p5",
                          "aderdg_surface_update_p5")
    u = state_from_numpy(Q, device="cpu")
    out = cu.run(u, 2, 2e-3)
    np.testing.assert_allclose(state_to_numpy(out), np.asarray(js.run(jnp.asarray(Q), 2, 2e-3)),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(state_to_numpy(out), state_to_numpy(ts.run(u, 2, 2e-3)))
    assert cu.launches == {name: 0 for name in cu.kernels}


def test_cuda_aderdg_takes_order_5_euler(pair):
    _, ts, _ = pair
    cu = CudaADERDG(ts)
    # The occupancy query's indices of the three kernels (csrc/aderdg.cu,
    # exahype_aderdg_kernel_info; the card's numbers are tests/test_torch_cuda.py's).
    assert [CudaADERDG.KERNELS.index(name) for name in cu.kernels] == [19, 20, 21]
    assert cu.walls is None and not cu.ncp
    new, faces, fvwall = cu.predictor_volume(state_from_numpy(wave_state(ts), device="cpu"), 1e-3)
    assert tuple(new.shape) == ts.state_shape and tuple(faces.shape) == ts.face_shape
    assert fvwall is None


@pytest.mark.parametrize("case", ["order4", "order7", "walls"])
def test_cuda_aderdg_takes_orders_4_and_7_and_walls_at_order_5(case):
    """What order 5 alone had before: 3-D Euler at orders 4 and 7, and the
    walled face pair at order 5 (in every mode: ``tests/
    test_torch_walls_orders.py``)."""
    f3, e3 = euler_physics(3)
    if case == "walls":
        sol = ADERDGSolver(3, 5, 5, (2, 2, 2), f3, e3, device="cpu", boundary="reflective",
                           reflect_fn=euler_reflect(3), reflect_flux_fn=euler_reflect_flux(3))
        names = ("aderdg_predictor_volume_p5", "aderdg_face_flux_walls_p5",
                 "aderdg_surface_update_walls_p5")
    else:
        order = int(case[-1])
        sol = ADERDGSolver(3, order, 5, (2, 2, 2), f3, e3, device="cpu")
        names = tuple(f"aderdg_{k}_p{order}" for k in ("predictor_volume", "face_flux",
                                                       "surface_update"))
    cu = CudaADERDG(sol)
    assert cu.kernels == names
    assert (cu.walls is not None) == (case == "walls")


@pytest.mark.parametrize("case", ["order6", "dim2", "navier_stokes", "ns_order4", "ns_order7",
                                  "k1e_order5"])
def test_cuda_aderdg_refuses_what_order_5_does_not_instantiate(case):
    """Still refused, each naming its ROADMAP item: Euler at order 6, the
    2-D Euler step at order 5, Navier–Stokes at orders 4, 5 and 7, and K1 e
    (the sharded face pair) at order 5."""
    from exahype_tpu_torch.parallel import shard
    from exahype_tpu_torch.parallel.mesh import Mesh

    f3, e3 = euler_physics(3)
    if case == "order6":
        sol = ADERDGSolver(3, 6, 5, (2, 2, 2), f3, e3, device="cpu")
    elif case == "dim2":
        f2, e2 = euler_physics(2, n_real=4)
        sol = ADERDGSolver(2, 5, 4, (2, 2), f2, e2, device="cpu")
    elif case == "k1e_order5":
        sol = ADERDGSolver(3, 5, 5, (2, 2, 2), f3, e3, device="cpu")
        mesh = Mesh((2,), ("patches",), 0, torch.device("cpu"), "gloo")
        with pytest.raises(LoweringError, match="Queue 2 K1 e"):
            shard.make_sharded_aderdg_step(sol, mesh)
        return
    else:
        order = {"navier_stokes": 5, "ns_order4": 4, "ns_order7": 7}[case]
        flux, eig, visc, visc_eig = navier_stokes(3, mu=0.02, prandtl=0.7, gamma=GAMMA)
        sol = ADERDGSolver(3, order, 5, (2, 2, 2), flux, eig, device="cpu", visc_flux_fn=visc,
                           visc_eigenvalue_fn=visc_eig)
    with pytest.raises(LoweringError, match="Queue 1 item 4"):
        CudaADERDG(sol)


def test_example_wave_error_and_mass_drift_match_jax():
    """``examples/high_order_p5.py --cpu``: 10 steps of dt = 2e-3 at (4, 4,
    4); the error against the exact wave and the mass drift, in the port and
    in JAX (its plain solver; the example's Pallas kernel equals it,
    ``tests/test_aderdg.py:925-936``)."""
    js = jax_solver((4, 4, 4))
    ts = aderdg_from_jax(js, gamma=GAMMA, device="cpu")
    Q0, exact = wave_state(js), wave_state(js, t=10 * 2e-3)
    ref = np.asarray(js.run(jnp.asarray(Q0), 10, 2e-3))
    u0 = state_from_numpy(Q0, device="cpu")
    out = state_to_numpy(ts.run(u0, 10, 2e-3))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    err, err_jax = np.abs(out - exact).max(), np.abs(ref - exact).max()
    assert err < 2e-5 and abs(err - err_jax) <= 1e-12, (err, err_jax)
    m0 = float(ts.total_mass(u0)[0])
    m1 = float(ts.total_mass(state_from_numpy(out, device="cpu"))[0])
    assert abs(m1 - m0) < 1e-12
    assert abs(float(np.asarray(js.total_mass(jnp.asarray(ref)))[0]) - m1) <= 1e-12
