"""2-D compressible Navier–Stokes with walls and at order 2 in the port
against the JAX package, on the CPU: the configurations the JAX package's
own viscous-wall and Pallas Navier–Stokes tests build.

- the no-slip channel at order 3 (``tests/test_navier_stokes.py:405-435``),
- the outflow walls at order 3 (``:477-503``),
- the closed no-slip box at order 2, μ = 0.05 (``:437-474``),
- the periodic order-2 solver of the fused Pallas parity test (``:237-253``),
- the order-2 no-slip box of ``tests/test_parallel.py:888-928`` (walls on
  both axes, μ = 1e-2, the seed-2 state, dt 1e-3), also as one
  ``PallasADERDG(interpret=True, tile0=2)`` step, the JAX kernel run as its
  own test runs it.

Each configuration's inputs are made with NumPy from the JAX test's recipe
and handed to both packages; the port's plain step is held to the JAX step
at rtol=0, atol=1e-12 in float64 (one step and three).  The channel's decay
rate and the box's mass and kinetic energy are held to the JAX tests' gates
on the port's plain path.  ``CudaADERDG`` names the kernels of each solver
(``csrc/aderdg_2d.cu``: the viscous predictor with the wall planes, the
walled face pair with the advective/viscous wall split, the order-2
instances); they run on the card only, against these plain versions, in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import euler as jeuler
from exahype_tpu.models import navier_stokes as jns
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import wrap_var_last
from exahype_tpu_torch.convert import aderdg_from_jax, state_from_numpy, state_to_numpy
from exahype_tpu_torch.models import navier_stokes as ns
from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.utils.errors import LoweringError

torch.set_num_threads(1)

GAMMA = jeuler.GAMMA
PRANDTL = 0.7
ATOL = 1e-12

#: name: (grid, order, mu, boundary, wall_axes, state, dt): the JAX tests'
#: solvers; dt None is the JAX solver's cfl_dt of the state.
CASES = {
    "channel_p3": ((8, 8), 3, 0.01, "reflective", (0,), "channel", None),
    "outflow_p3": ((16, 8), 3, 5e-3, "outflow", (0,), "bump", 5e-4),
    "box_p2": ((8, 8), 2, 0.05, "reflective", (0, 1), "vortex", None),
    "periodic_p2": ((4, 4), 2, 0.02, "periodic", None, "smooth", 5e-4),
    "noslip_box_p2": ((8, 8), 2, 1e-2, "reflective", None, "seed2", 1e-3),
}
#: The kernels CudaADERDG builds for each (csrc/aderdg_2d.cu).
KERNELS = {
    "channel_p3": ("aderdg_predictor_volume_visc_2d", "aderdg_face_flux_walls_2d",
                   "aderdg_surface_update_walls_2d"),
    "outflow_p3": ("aderdg_predictor_volume_visc_2d", "aderdg_face_flux_walls_2d",
                   "aderdg_surface_update_walls_2d"),
    "box_p2": ("aderdg_predictor_volume_visc_p2_2d", "aderdg_face_flux_walls_p2_2d",
               "aderdg_surface_update_walls_p2_2d"),
    "periodic_p2": ("aderdg_predictor_volume_visc_p2_2d", "aderdg_face_flux_p2_2d",
                    "aderdg_surface_update_p2_2d"),
    "noslip_box_p2": ("aderdg_predictor_volume_visc_p2_2d", "aderdg_face_flux_walls_p2_2d",
                      "aderdg_surface_update_walls_p2_2d"),
}


def jax_solver(grid, order, mu, boundary, wall_axes):
    """A JAX viscous solver as the JAX tests build it (dx = 1/g0)."""
    f, e, vf, ve = jns.navier_stokes(dim=2, mu=mu)
    kw = {}
    if boundary != "periodic":
        kw = dict(boundary=boundary, wall_axes=wall_axes)
    if boundary == "reflective":
        kw.update(reflect_fn=jns.noslip_reflect(2), reflect_flux_fn=jns.noslip_reflect_flux(2))
    return JaxSolver(
        dim=2, order=order, n_vars=4, grid_shape=grid,
        flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
        visc_flux_fn=jns.wrap_visc_var_last(vf), visc_eigenvalue_fn=wrap_var_last(ve),
        dx=1.0 / grid[0], **kw,
    )


def port_of(js, mu):
    walls = "noslip" if js.boundary == "reflective" else None
    return aderdg_from_jax(js, physics="navier_stokes", gamma=GAMMA, mu=mu, prandtl=PRANDTL,
                           walls=walls, device="cpu")


def state(solver, kind):
    """The JAX test's state of ``kind`` in the solver's layout (NumPy)."""
    va = solver.var_axis
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    X, Y = (np.broadcast_to(np.squeeze(c, va), no_var) for c in solver.nodes_meshgrid())
    one, zero = np.ones_like(X), np.zeros_like(X)
    if kind == "channel":  # tests/test_navier_stokes.py:418-424
        my = 1e-3 * np.sin(np.pi * X)
        q = [one, zero, my, 1.0 / (GAMMA - 1.0) + 0.5 * my**2]
    elif kind == "vortex":  # :445-455
        mx = 1e-3 * np.sin(np.pi * X) * np.cos(np.pi * Y)
        my = -1e-3 * np.cos(np.pi * X) * np.sin(np.pi * Y)
        q = [one, mx, my, 1.0 / (GAMMA - 1) + 0.5 * (mx**2 + my**2)]
    elif kind == "bump":  # :490-495
        q = [1.0 + 0.2 * np.exp(-(((X - 0.5) / 0.05) ** 2)), zero, zero,
             np.full_like(X, 1.0 / (GAMMA - 1.0))]
    elif kind == "smooth":  # :224-233
        rho = 1.0 + 0.2 * np.sin(2 * np.pi * (X + Y))
        mx = 0.2 * np.cos(2 * np.pi * X)
        my = -0.1 * np.sin(2 * np.pi * Y)
        p = 1.0 + 0.2 * np.cos(2 * np.pi * Y)
        q = [rho, mx, my, p / (GAMMA - 1) + 0.5 * (mx**2 + my**2) / rho]
    else:  # "seed2", tests/test_parallel.py:906-916
        rng = np.random.default_rng(2)
        rho = 1.0 + 0.2 * rng.random(no_var)
        m = 0.1 * rng.standard_normal(no_var + (2,))
        p = 1.0 + 0.2 * rng.random(no_var)
        e = p / 0.4 + 0.5 * (m**2).sum(-1) / rho
        q = [rho, m[..., 0], m[..., 1], e]
    return np.ascontiguousarray(np.stack(q, axis=va))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Each configuration once: the JAX solver, the port's, the state, dt,
    and the JAX package's state after one and after three steps."""
    name = request.param
    grid, order, mu, boundary, wall_axes, kind, dt = CASES[name]
    js = jax_solver(grid, order, mu, boundary, wall_axes)
    ts = port_of(js, mu)
    q = state(ts, kind)
    if dt is None:
        dt = float(js.cfl_dt(jnp.asarray(q)))
    step = jax.jit(lambda x: js.step(x, dt))
    one = step(jnp.asarray(q))
    three = step(step(one))
    return dict(name=name, js=js, ts=ts, q=q, dt=dt, one=np.asarray(one),
                three=np.asarray(three))


def test_plain_steps_match_jax(case):
    ts, dt = case["ts"], case["dt"]
    u = state_from_numpy(case["q"], device="cpu")
    assert ts.splits_wall_viscosity == (CASES[case["name"]][3] != "periodic")
    if CASES[case["name"]][6] is None:  # the JAX solver's cfl_dt: the port's is the same
        assert float(ts.cfl_dt(u)) == pytest.approx(dt, rel=1e-13)
    np.testing.assert_allclose(state_to_numpy(ts.step(u, dt)), case["one"], rtol=0, atol=ATOL)
    got = state_to_numpy(ts.run(u, 3, dt))
    np.testing.assert_allclose(got, case["three"], rtol=0, atol=ATOL)
    assert np.isfinite(got).all()


def test_cuda_wrapper_names_the_kernels(case):
    """The solver builds on CudaADERDG with three kernels (none runs here:
    on CPU tensors the wrapper is the plain path, the wall split
    included), and so does the JAX PallasADERDG over the same solver."""
    from exahype_tpu.models.aderdg_pallas import PallasADERDG

    ts, dt = case["ts"], case["dt"]
    cu = CudaADERDG(ts)
    assert cu.kernels == KERNELS[case["name"]]
    assert (cu.walls is None) == (CASES[case["name"]][3] == "periodic")
    u = state_from_numpy(case["q"], device="cpu")
    assert torch.equal(cu.step(u, dt), ts.step(u, dt))
    mu = CASES[case["name"]][2]
    walls = "noslip" if case["js"].boundary == "reflective" else None
    crossed = aderdg_from_jax(PallasADERDG(case["js"], interpret=True, tile0=2),
                              physics="navier_stokes", gamma=GAMMA, mu=mu, prandtl=PRANDTL,
                              walls=walls, device="cpu")
    assert isinstance(crossed, CudaADERDG) and crossed.kernels == cu.kernels
    if walls:
        np.testing.assert_array_equal(crossed.solver.reflect_fn.signs,
                                      ns.noslip_reflect(2).signs)


def test_pallas_interpret_step_of_the_noslip_box_matches_port():
    """tests/test_parallel.py:919-928 in the port: one step of the JAX
    Pallas kernel (interpret mode, tile0=2) on the order-2 no-slip box is
    the port's plain step to 1e-12."""
    from exahype_tpu.models.aderdg_pallas import PallasADERDG

    grid, order, mu, boundary, wall_axes, kind, dt = CASES["noslip_box_p2"]
    js = jax_solver(grid, order, mu, boundary, wall_axes)
    ts = port_of(js, mu)
    q = state(ts, kind)
    want = np.asarray(PallasADERDG(js, interpret=True, tile0=2).step(jnp.asarray(q), dt))
    got = state_to_numpy(ts.step(state_from_numpy(q, device="cpu"), dt))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_channel_decays_at_the_stokes_rate_on_the_port():
    """tests/test_navier_stokes.py:405-435's gate on the port's plain path:
    the no-slip channel's shear mode decays at ν π² within 2 %."""
    grid, order, mu, boundary, wall_axes, kind, _ = CASES["channel_p3"]
    ts = port_of(jax_solver(grid, order, mu, boundary, wall_axes), mu)
    u = state_from_numpy(state(ts, kind), device="cpu")
    dt = float(ts.cfl_dt(u))
    n = max(1, int(round(1.0 / dt)))
    out = ts.run(u, n, dt)

    def vy_norm(x):
        return float(torch.sqrt(torch.mean((x[:, :, 2] / x[:, :, 0]) ** 2)))

    rate = np.log(vy_norm(u) / vy_norm(out)) / (n * dt)
    assert abs(rate - mu * np.pi**2) / (mu * np.pi**2) < 2e-2, rate


def test_box_holds_mass_and_drains_kinetic_energy_on_the_port():
    """tests/test_navier_stokes.py:437-474's gates on the port's plain path:
    the closed order-2 no-slip box (μ = 0.05) keeps its mass to 1e-12 over
    160 steps and loses more than a fifth of its kinetic energy."""
    grid, order, mu, boundary, wall_axes, kind, _ = CASES["box_p2"]
    ts = port_of(jax_solver(grid, order, mu, boundary, wall_axes), mu)
    u = state_from_numpy(state(ts, kind), device="cpu")
    out = ts.run(u, 160, float(ts.cfl_dt(u)))
    assert torch.isfinite(out).all()
    m0, m1 = ts.total_mass(u), ts.total_mass(out)
    assert abs(float(m1[0] - m0[0])) <= 1e-12 * float(m0[0]) + 1e-14

    def ke(x):
        return float((0.5 * (x[:, :, 1] ** 2 + x[:, :, 2] ** 2) / x[:, :, 0]).mean())

    assert ke(out) < 0.8 * ke(u)


@pytest.mark.parametrize("physics,order", [("navier_stokes", 4), ("euler", 2)])
def test_other_2d_orders_still_raise(physics, order):
    """2-D Navier–Stokes at order 4 and 2-D Euler at order 2 have no
    kernels: CudaADERDG names the ROADMAP item."""
    if physics == "navier_stokes":
        flux, eig, visc, visc_eig = ns.navier_stokes(2)
        kw = dict(visc_flux_fn=visc, visc_eigenvalue_fn=visc_eig)
    else:
        flux, eig = euler_physics(2, n_real=4)
        kw = {}
    sol = ADERDGSolver(2, order, 4, (4, 4), flux, eig, dx=0.25, device="cpu", **kw)
    with pytest.raises(LoweringError, match="no CUDA kernel instantiated.*Queue 1 item 4"):
        CudaADERDG(sol)
