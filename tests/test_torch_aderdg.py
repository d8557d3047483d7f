"""The port's ADER-DG solver against the JAX package's, on the CPU.

Inputs are made with NumPy from a seed and handed to both packages.
Tolerances: f64 at rtol=0, atol=1e-12 (the repo's JAX↔Pallas bar); f32 at
atol=2e-5 — the states reach |u| ≈ 6, f32 rounds at 2⁻²⁴ ≈ 6e-8 relative,
and one step is a few hundred dependent operations deep, so two f32
evaluation orders differ by up to ~1e-6 here (measured: the port's f32
step is within 1.4e-6 of the f64 step on these states).

The kernels themselves are held against these plain versions on the card
in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import euler_physics as jax_euler_physics
from exahype_tpu_torch.convert import (
    aderdg_from_jax,
    state_from_numpy,
    state_to_numpy,
)
from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError

torch.set_num_threads(1)

GAMMA = 1.4


def jax_euler_solver(dim, order, grid, basis="legendre"):
    flux, eig = jax_euler_physics(dim=dim, n_real=dim + 2)
    return JaxSolver(
        dim=dim, order=order, n_vars=dim + 2, grid_shape=grid, flux_fn=flux,
        max_eigenvalue_fn=eig, dx=1.0 / grid[0], basis=basis,
    )


def bench_state(solver, seed=0):
    """``bench.py``'s initial state: random density, fixed ratios."""
    rng = np.random.default_rng(seed)
    va = solver.var_axis
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    rho = 1.0 + 0.2 * rng.random(no_var)
    if solver.dim == 3:
        comps = [rho, rho, 0.5 * rho, 0.25 * rho, 5.0 + 0.5 * rho * 1.3125]
    else:
        comps = [rho, rho, 0.5 * rho, 5.0 + 0.5 * rho * 1.3125]
    return np.stack(comps, axis=va)


def density_wave_state(solver, vel=(1.0, 0.5), p=2.0):
    """Smooth 2-D Euler density wave (tests/test_aderdg.py's)."""
    coords = solver.nodes_meshgrid()
    phase = sum(c - v * 0.0 for c, v in zip(coords, vel))
    rho_b = 1.0 + 0.2 * np.sin(2 * np.pi * phase)
    va = solver.var_axis
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    rho = np.broadcast_to(np.squeeze(rho_b, axis=va), no_var)
    u, v = vel
    E = p / (GAMMA - 1.0) + 0.5 * rho * (u * u + v * v)
    return np.stack([rho, rho * u, rho * v, E], axis=va)


# (dim, order, grid, state) — the 3-D p3 bench-style case and the 2-D p2
# density wave.
CONFIGS = {
    "3d_p3": (3, 3, (4, 2, 4), bench_state),
    "2d_p2": (2, 2, (6, 6), density_wave_state),
}


def both(name, dtype=torch.float64, basis="legendre"):
    dim, order, grid, make = CONFIGS[name]
    js = jax_euler_solver(dim, order, grid, basis=basis)
    ts = aderdg_from_jax(js, gamma=GAMMA, device="cpu", dtype=dtype)
    return js, ts, make(js)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_predictor_parity(name):
    js, ts, Q = both(name)
    qbar_j, fbar_j = js.predictor(jnp.asarray(Q), 2e-3)
    qbar_t, fbar_t = ts.predictor(state_from_numpy(Q, device="cpu"), 2e-3)
    np.testing.assert_allclose(
        state_to_numpy(qbar_t), np.asarray(qbar_j), rtol=0, atol=1e-12
    )
    assert len(fbar_t) == js.dim
    for d in range(js.dim):
        np.testing.assert_allclose(
            state_to_numpy(fbar_t[d]), np.asarray(fbar_j[d]), rtol=0,
            atol=1e-12, err_msg=f"fbar[{d}]",
        )


@pytest.mark.parametrize("basis", ["legendre", "lobatto"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_parity_f64(name, basis):
    js, ts, Q = both(name, basis=basis)
    ref = np.asarray(js.step(jnp.asarray(Q), 2e-3))
    got = state_to_numpy(ts.step(state_from_numpy(Q, device="cpu"), 2e-3))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert np.abs(ref - Q).max() > 1e-4  # the step did something


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_parity_f32(name):
    js, ts, Q = both(name, dtype=torch.float32)
    ref = np.asarray(js.step(jnp.asarray(Q), 2e-3))  # f64 reference
    got = ts.step(state_from_numpy(Q, device="cpu", dtype=torch.float32), 2e-3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(state_to_numpy(got), ref, rtol=0, atol=2e-5)


def test_step_with_device_scalar_dt():
    js, ts, Q = both("3d_p3")
    a = ts.step(state_from_numpy(Q, device="cpu"), 2e-3)
    b = ts.step(state_from_numpy(Q, device="cpu"), torch.tensor(2e-3, dtype=torch.float64))
    np.testing.assert_allclose(state_to_numpy(b), state_to_numpy(a), rtol=0, atol=1e-15)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_cfl_and_mass(name):
    js, ts, Q = both(name)
    dt_j = float(js.cfl_dt(jnp.asarray(Q)))
    dt_t = ts.cfl_dt(state_from_numpy(Q, device="cpu"))
    assert dt_t.dim() == 0
    np.testing.assert_allclose(float(dt_t), dt_j, rtol=1e-14, atol=0)
    np.testing.assert_allclose(
        float(ts.cfl_dt(state_from_numpy(Q, device="cpu"), cfl=0.1)),
        float(js.cfl_dt(jnp.asarray(Q), cfl=0.1)), rtol=1e-14, atol=0,
    )
    ref = np.asarray(js.run(jnp.asarray(Q), 5, dt_j))
    u = ts.run(state_from_numpy(Q, device="cpu"), 5, dt_j)
    np.testing.assert_allclose(state_to_numpy(u), ref, rtol=0, atol=1e-12)
    m0 = ts.total_mass(state_from_numpy(Q, device="cpu"))
    np.testing.assert_allclose(
        state_to_numpy(m0), np.asarray(js.total_mass(jnp.asarray(Q))),
        rtol=0, atol=1e-12,
    )
    # Periodic flux form: every variable's integral is conserved.
    np.testing.assert_allclose(
        state_to_numpy(ts.total_mass(u)), state_to_numpy(m0), rtol=0, atol=1e-12
    )


def test_nodes_meshgrid_and_structure():
    js, ts, _ = both("3d_p3")
    for a, b in zip(ts.nodes_meshgrid(), js.nodes_meshgrid()):
        np.testing.assert_array_equal(a, b)
    assert ts.state_shape == js.state_shape
    assert ts.dofs() == js.dofs()
    assert ts.picard_iters == js.picard_iters
    assert ts.face_shape == (3, 4, 16, 5, 4, 2, 4)


def test_kernel_halves_compose_to_step():
    """The plain versions of the two kernels, chained, are the step, and
    the face tensor holds the JAX package's face projections."""
    js, ts, Q = both("3d_p3")
    u = state_from_numpy(Q, device="cpu")
    new, faces, fvwall = ts.predictor_volume(u, 2e-3)
    assert faces.shape == ts.face_shape
    assert fvwall is None  # the viscous wall planes of a walled viscous solver only
    out = ts.face_surface(new, faces, 2e-3)
    np.testing.assert_allclose(
        state_to_numpy(out), np.asarray(js.step(jnp.asarray(Q), 2e-3)),
        rtol=0, atol=1e-12,
    )
    qbar, fbar = js.predictor(jnp.asarray(Q), 2e-3)
    phi0 = js.ops.phi0
    q_lo_axis1 = np.tensordot(phi0, np.asarray(qbar), axes=([0], [1]))
    np.testing.assert_allclose(
        state_to_numpy(faces[1, 0]).reshape(q_lo_axis1.shape), q_lo_axis1,
        rtol=0, atol=1e-12,
    )


def test_step_does_not_mutate_input():
    _, ts, Q = both("3d_p3")
    u = state_from_numpy(Q, device="cpu")
    u0 = u.clone()
    ts.step(u, 2e-3)
    assert torch.equal(u, u0)


@pytest.mark.parametrize(
    "option,value",
    [
        ("boundary", "reflective"),
        ("boundary", "outflow"),
        ("wall_axes", (0,)),
        ("source_fn", lambda q, va: q),
        ("ncp_fn", lambda q, g, d, va: q),
        ("rhs_all_fn", lambda q, g, va: q),
        ("visc_flux_fn", lambda q, g, d, va: q),
        ("dissipation_mask", (1.0, 1.0, 1.0, 1.0, 0.0)),
        ("dissipation_mask", np.array([1.0, 1.0, 1.0, 1.0, 0.0])),
        ("predictor_mode", "ck"),
        ("reuse_last_flux", True),
    ],
)
def test_unported_options_raise(option, value):
    flux, eig = euler_physics(3)
    if option in ("boundary", "wall_axes"):
        # Ported with the walls: accepted, the JAX step, and the kernels.
        walls = {option: value} if option == "boundary" else {"boundary": "outflow", option: value}
        _assert_walls_match_jax(walls)
        return
    if option == "visc_flux_fn":
        # Ported with the viscous fluxes: alone it is refused as JAX refuses
        # it; with its eigenvalue the plain solver takes it, and the kernels
        # refuse a callback that is not the tagged Navier–Stokes one.
        with pytest.raises(SemanticError, match="must be set together"):
            ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu", **{option: value})
        solver = ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu", **{option: value},
                              visc_eigenvalue_fn=lambda q, d, va: 0.0 * q.select(va, 0))
        with pytest.raises(LoweringError, match="viscous"):
            CudaADERDG(solver)
        return
    if option in CARRIED_BY_THE_PLAIN_SOLVER:
        solver = ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu", **{option: value})
        assert getattr(solver, option) is not None
        with pytest.raises(LoweringError, match=option):
            CudaADERDG(solver)
        return
    with pytest.raises(SemanticError, match="ROADMAP.md"):
        ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu", **{option: value})


def _assert_walls_match_jax(walls):
    """A 3-D p3 Euler solver with ``walls`` crosses from JAX, matches its
    step at 1e-12 and lowers to the CUDA kernels."""
    from exahype_tpu.models.aderdg import euler_reflect, euler_reflect_flux

    jflux, jeig = jax_euler_physics(dim=3, n_real=5)
    hooks = {}
    if walls["boundary"] == "reflective":
        hooks = dict(reflect_fn=euler_reflect(3), reflect_flux_fn=euler_reflect_flux(3))
    js = JaxSolver(dim=3, order=3, n_vars=5, grid_shape=(4, 2, 4), flux_fn=jflux,
                   max_eigenvalue_fn=jeig, dx=0.25, **walls, **hooks)
    ts = aderdg_from_jax(js, gamma=GAMMA, device="cpu",
                         walls="euler" if hooks else None)
    assert [ts.is_wall(d) for d in range(3)] == [js.is_wall(d) for d in range(3)]
    Q = bench_state(js, seed=5)
    ref = np.asarray(jax.jit(lambda q: js.step(q, 2e-3))(jnp.asarray(Q)))
    got = state_to_numpy(ts.step(state_from_numpy(Q, device="cpu"), 2e-3))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert CudaADERDG(ts).walls["mask"] == sum(1 << d for d in range(3) if ts.is_wall(d))


#: Options the plain solver carries since the CK slice
#: (``tests/test_torch_ck.py``) and the Z4 slice (the source, NCP and fused
#: right-hand-side hooks, ``tests/test_torch_z4_slice.py``); the Euler
#: kernels do not, and refuse them.
CARRIED_BY_THE_PLAIN_SOLVER = (
    "dissipation_mask", "predictor_mode", "source_fn", "ncp_fn", "rhs_all_fn",
)


def test_convert_rejects_unported_jax_options():
    flux, eig = jax_euler_physics(dim=2, n_real=4)
    js = JaxSolver(
        dim=2, order=2, n_vars=4, grid_shape=(4, 4), flux_fn=flux,
        max_eigenvalue_fn=eig, source_fn=lambda q, va: 0.0 * q,
    )
    with pytest.raises(SemanticError, match="source_fn"):
        aderdg_from_jax(js, gamma=GAMMA, device="cpu")


def test_solver_config_errors():
    flux, eig = euler_physics(3)
    with pytest.raises(SemanticError):
        ADERDGSolver(4, 3, 5, (2, 2, 2, 2), flux, eig, device="cpu")
    with pytest.raises(SemanticError):
        ADERDGSolver(3, 3, 5, (2, 2), flux, eig, device="cpu")
    with pytest.raises(SemanticError):
        ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu", basis="chebyshev")
    with pytest.raises(TypeError):
        ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu", tile0=4)


# ----------------------------------------------------------- CudaADERDG


def test_cuda_wrapper_takes_plain_path_on_cpu():
    js, ts, Q = both("3d_p3")
    cu = CudaADERDG(ts)
    u = state_from_numpy(Q, device="cpu")
    out = cu.step(u, 2e-3)
    np.testing.assert_array_equal(state_to_numpy(out), state_to_numpy(ts.step(u, 2e-3)))
    run = cu.run(u, 2, 2e-3)
    np.testing.assert_array_equal(state_to_numpy(run), state_to_numpy(ts.run(u, 2, 2e-3)))
    new, faces, _ = cu.predictor_volume(u, 2e-3)
    # The same contract as the kernel: ``new`` is updated in place.
    assert cu.face_surface(new, faces, 2e-3) is new
    np.testing.assert_array_equal(state_to_numpy(new), state_to_numpy(out))
    assert cu.launches == {"aderdg_predictor_volume": 0, "aderdg_face_flux": 0,
                           "aderdg_surface_update": 0}
    assert cu.dofs() == ts.dofs()
    np.testing.assert_array_equal(
        state_to_numpy(cu.total_mass(u)), state_to_numpy(ts.total_mass(u))
    )
    assert float(cu.cfl_dt(u)) == float(ts.cfl_dt(u))


def test_cuda_wrapper_rejects_what_the_kernels_do_not_take():
    def flux(Q, axis, var_axis):
        return Q

    def eig(Q, axis, var_axis):
        return Q.abs().amax(dim=var_axis)

    with pytest.raises(LoweringError, match="Euler"):
        CudaADERDG(ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu"))
    f3, e3 = euler_physics(3)
    f2, e2 = euler_physics(2, n_real=4)
    with pytest.raises(LoweringError, match="Euler"):
        CudaADERDG(ADERDGSolver(3, 3, 5, (2, 2, 2), f3, e2, device="cpu"))
    with pytest.raises(LoweringError, match="order=2"):
        CudaADERDG(ADERDGSolver(3, 2, 5, (2, 2, 2), f3, e3, device="cpu"))
    # 2-D: order 3 is instantiated (csrc/aderdg_2d.cu), orders 2 and 5 are not.
    assert CudaADERDG(ADERDGSolver(2, 3, 4, (2, 2), f2, e2, device="cpu")).kernels == (
        "aderdg_predictor_volume_2d", "aderdg_face_flux_2d", "aderdg_surface_update_2d")
    for order in (2, 5):
        with pytest.raises(LoweringError, match=f"dim=2, order={order}.*Queue 1 item 4"):
            CudaADERDG(ADERDGSolver(2, order, 4, (2, 2), f2, e2, device="cpu"))
    f6, e6 = euler_physics(3, n_real=6)
    with pytest.raises(LoweringError, match="n_vars=6"):
        CudaADERDG(ADERDGSolver(3, 3, 6, (2, 2, 2), f6, e6, device="cpu"))
