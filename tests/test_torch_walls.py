"""Domain walls on the port's ADER-DG solver against the JAX package's, on
the CPU: every boundary mode (reflective, outflow, farfield, dirichlet) on
the configurations of ``tests/test_aderdg.py``'s wall tests, the
``wall_axes`` subset of ``tests/test_models.py``, 3-D order 3 Euler walls,
the CK free surface of the heterogeneous elasticity, and the NCP with
outflow and farfield walls; then what the port refuses around walls.

Inputs are made with NumPy from a seed and handed to both packages; the
solvers cross with ``aderdg_from_jax`` (the reflect hooks named by
``walls=``).  f64 at rtol=0, atol=1e-12 (the repo's JAX↔Pallas bar), one
step and 3 steps.  The CUDA face stage's wall variant is held against these
plain versions on the card in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import euler_physics as jax_euler_physics
from exahype_tpu.models.aderdg import euler_reflect as jax_euler_reflect
from exahype_tpu.models.aderdg import euler_reflect_flux as jax_euler_reflect_flux
from exahype_tpu.models.aderdg import make_dirichlet_fn as jax_make_dirichlet_fn
from exahype_tpu.models import elastic as jel
from exahype_tpu_torch.convert import aderdg_from_jax, state_from_numpy, state_to_numpy
from exahype_tpu_torch.models import elastic
from exahype_tpu_torch.models.aderdg import (
    ADERDGSolver,
    euler_physics,
    euler_reflect,
    euler_reflect_flux,
    make_dirichlet_fn,
)
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError
from tests.test_torch_aderdg import bench_state
from tests.test_torch_ck import MAT, jax_ck_solver, random_state

torch.set_num_threads(1)

GAMMA = 1.4
DT = 1e-3  # under the CFL limit (~2.7e-3 at dx = 1/8, order 3) of these states


def _smooth_state(dim, order, grid, dx, basis="legendre"):
    """A smooth Euler state for the Dirichlet rows: density and velocity
    vary with position (var-last NumPy, the ``make_dirichlet_fn``
    contract)."""

    def state_fn(*x):
        rho = 1.0 + 0.2 * np.sin(2 * np.pi * x[0]) * np.cos(np.pi * x[-1])
        vel = [0.3 + 0.1 * np.cos(2 * np.pi * x[d]) for d in range(dim)]
        p = 2.0 + 0.1 * np.sin(np.pi * x[1])
        e = p / (GAMMA - 1.0) + 0.5 * rho * sum(v * v for v in vel)
        return np.stack([rho] + [rho * v for v in vel] + [e], axis=-1)

    kw = dict(dim=dim, order=order, grid_shape=grid, dx=dx, basis=basis)
    return state_fn, kw


def jax_euler(dim, order, grid, basis="legendre", **walls):
    flux, eig = jax_euler_physics(dim=dim, n_real=dim + 2)
    if walls.get("boundary") == "reflective":
        walls = dict(walls, reflect_fn=jax_euler_reflect(dim),
                     reflect_flux_fn=jax_euler_reflect_flux(dim))
    if walls.get("boundary") == "dirichlet":
        state_fn, kw = _smooth_state(dim, order, grid, 1.0 / grid[0], basis)
        walls = dict(walls, dirichlet_fn=jax_make_dirichlet_fn(
            state_fn, wall_axes=walls.get("wall_axes"), **kw))
    return JaxSolver(dim=dim, order=order, n_vars=dim + 2, grid_shape=grid,
                     flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / grid[0],
                     basis=basis, **walls)


def _ff(dim):
    """A supersonic farfield state along axis 0 (tests/test_aderdg.py:404)."""
    return (1.0, 2.0) + (0.0,) * (dim - 1) + (1.0 / (GAMMA - 1) + 0.5 * 2.0**2,)


def _port(js):
    walls = "euler" if js.boundary == "reflective" else None
    return aderdg_from_jax(js, gamma=GAMMA, walls=walls, device="cpu")


def assert_steps_match(js, ts, Q, dt=DT, n=3):
    """One step and ``n`` steps of both solvers from ``Q``, at 1e-12."""
    u = state_from_numpy(Q, device="cpu")
    jstep = jax.jit(lambda q: js.step(q, dt))
    ref = jstep(jnp.asarray(Q))
    one = state_to_numpy(ts.step(u, dt))
    np.testing.assert_allclose(one, np.asarray(ref), rtol=0, atol=1e-12)
    for _ in range(n - 1):
        ref = jstep(ref)
    ref = np.asarray(ref)
    got = state_to_numpy(ts.run(u, n, dt))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert np.isfinite(got).all()
    return got


# ---------------------------------------------------------------- Euler, 2-D

#: The wall configurations of tests/test_aderdg.py (the reflective box
#: :295, the outflow and farfield channels :335 and :396, order 3) and a
#: Dirichlet box, 2-D.
CASES_2D = {
    "reflective": ((6, 6), dict(boundary="reflective")),
    "outflow": ((8, 4), dict(boundary="outflow", wall_axes=(0,))),
    "farfield": ((8, 4), dict(boundary="farfield", farfield_state=_ff(2), wall_axes=(0,))),
    "dirichlet": ((8, 4), dict(boundary="dirichlet")),
}


@pytest.mark.parametrize("name", sorted(CASES_2D))
def test_euler_walls_2d_match_jax(name):
    grid, walls = CASES_2D[name]
    js = jax_euler(2, 3, grid, **walls)
    ts = _port(js)
    assert ts.boundary == js.boundary
    assert [ts.is_wall(d) for d in range(2)] == [js.is_wall(d) for d in range(2)]
    Q = bench_state(js, seed=1)
    assert_steps_match(js, ts, Q)


def test_reflective_box_conserves_mass_and_energy():
    """The port's reflective box (tests/test_aderdg.py:295): mass and
    energy are conserved through the walls, normal momentum is not."""
    js = jax_euler(2, 3, (6, 6), boundary="reflective")
    ts = _port(js)
    u0 = state_from_numpy(bench_state(js, seed=2), device="cpu")
    u = ts.run(u0, 10, DT)
    m0, m1 = ts.total_mass(u0), ts.total_mass(u)
    assert abs(float(m1[0] - m0[0])) < 1e-12
    assert abs(float(m1[3] - m0[3])) < 1e-11
    assert abs(float(m1[1] - m0[1])) > 1e-6


@pytest.mark.parametrize("boundary", ["outflow", "farfield"])
def test_uniform_supersonic_flow_is_steady(boundary):
    """tests/test_aderdg.py:347,413 in the port: a uniform supersonic flow
    (equal to the farfield state) is exactly steady under both walls."""
    grid, walls = CASES_2D[boundary]
    ts = _port(jax_euler(2, 3, grid, **walls))
    uni = np.zeros(ts.state_shape)
    for k, v in enumerate(_ff(2)):
        uni[(slice(None),) * ts.var_axis + (k,)] = v
    out = ts.run(state_from_numpy(uni, device="cpu"), 10, DT)
    np.testing.assert_allclose(state_to_numpy(out), uni, rtol=0, atol=1e-12)


def test_wall_axes_subset_is_bitwise_the_full_box():
    """tests/test_models.py:767 in the port: ``wall_axes=(0, 1)`` is the
    all-wall box bit for bit, and both match JAX."""
    flux, eig = euler_physics(2, n_real=4)
    kw = dict(dx=1.0 / 6, boundary="reflective", reflect_fn=euler_reflect(2),
              reflect_flux_fn=euler_reflect_flux(2), device="cpu")
    s_all = ADERDGSolver(2, 2, 4, (6, 6), flux, eig, **kw)
    s_01 = ADERDGSolver(2, 2, 4, (6, 6), flux, eig, wall_axes=(0, 1), **kw)
    js = jax_euler(2, 2, (6, 6), boundary="reflective", wall_axes=(0, 1))
    Q = bench_state(js, seed=3)
    u = state_from_numpy(Q, device="cpu")
    a = s_all.run(u, 3, DT)
    assert torch.equal(a, s_01.run(u, 3, DT))
    np.testing.assert_allclose(state_to_numpy(a), np.asarray(js.run(jnp.asarray(Q), 3, DT)),
                               rtol=0, atol=1e-12)


# ------------------------------------------------------------------ Dirichlet


@pytest.mark.parametrize("basis", ["legendre", "lobatto"])
def test_dirichlet_rows_match_jax_in_both_bases(basis):
    """The port's ``make_dirichlet_fn`` gives the JAX rows bit for bit
    (non-constant along every face), and a Dirichlet step through
    ``aderdg_from_jax`` matches the JAX step."""
    grid = (8, 4)
    state_fn, kw = _smooth_state(2, 3, grid, 1.0 / grid[0], basis)
    port_fn = make_dirichlet_fn(state_fn, **kw)
    jax_fn = jax_make_dirichlet_fn(state_fn, **kw)
    assert port_fn.basis == jax_fn.basis == basis
    for d in range(2):
        for side in (0, 1):
            row = port_fn(d, side)
            np.testing.assert_array_equal(row, jax_fn(d, side))
            by_var = np.moveaxis(row, 1, 0).reshape(row.shape[1], -1)
            assert np.ptp(by_var, axis=1).max() > 1e-3  # varies on the face
    js = jax_euler(2, 3, grid, basis=basis, boundary="dirichlet")
    ts = _port(js)
    assert ts.dirichlet_fn.basis == basis
    assert_steps_match(js, ts, bench_state(js, seed=4))


def test_dirichlet_basis_mismatch_raises():
    grid = (8, 4)
    state_fn, kw = _smooth_state(2, 3, grid, 1.0 / grid[0], "lobatto")
    flux, eig = euler_physics(2, n_real=4)
    with pytest.raises(SemanticError, match="lobatto"):
        ADERDGSolver(2, 3, 4, grid, flux, eig, dx=1.0 / grid[0], device="cpu",
                     boundary="dirichlet", dirichlet_fn=make_dirichlet_fn(state_fn, **kw))


# ---------------------------------------------------------------- Euler, 3-D

#: 3-D order 3 Euler walls at (4, 2, 8): each mode, and reflective walls
#: on a subset of the axes.
CASES_3D = {
    "reflective": dict(boundary="reflective"),
    "reflective_12": dict(boundary="reflective", wall_axes=(1, 2)),
    "outflow_0": dict(boundary="outflow", wall_axes=(0,)),
    "farfield_0": dict(boundary="farfield", farfield_state=_ff(3), wall_axes=(0,)),
    "dirichlet": dict(boundary="dirichlet"),
}


@pytest.mark.parametrize("name", sorted(CASES_3D))
def test_euler_walls_3d_match_jax(name):
    js = jax_euler(3, 3, (4, 2, 8), **CASES_3D[name])
    ts = _port(js)
    Q = bench_state(js, seed=5)
    new, faces, _ = ts.predictor_volume(state_from_numpy(Q, device="cpu"), DT)
    out, fluxes = ts.face_surface(new, faces, DT, return_face_fluxes=True)
    ref, jfluxes = jax.jit(lambda q: js.step(q, DT, return_face_fluxes=True))(jnp.asarray(Q))
    np.testing.assert_allclose(state_to_numpy(out), np.asarray(ref), rtol=0, atol=1e-12)
    for d in range(3):
        np.testing.assert_allclose(state_to_numpy(fluxes[d]), np.asarray(jfluxes[d]),
                                   rtol=0, atol=1e-12, err_msg=f"fhat_hi[{d}]")
    assert_steps_match(js, ts, Q)


# ----------------------------------------------------------- CK free surface


def test_ck_free_surface_matches_jax_and_freezes_materials():
    """The CK free surface of the heterogeneous elasticity (3-D, order 3,
    ``wall_axes=(2,)``, the layered-seismic configuration): 1 and 3 steps
    at 1e-12, the material slots bitwise frozen."""
    refl, refl_flux = jel.elastic3d_free_surface_het()
    js = jax_ck_solver(3, (4, 2, 8), boundary="reflective", reflect_fn=refl,
                       reflect_flux_fn=refl_flux, wall_axes=(2,))
    ts = aderdg_from_jax(js, physics="elastic3d_het", walls="elastic3d_het_free_surface",
                         device="cpu")
    assert ts.predictor_mode == "ck" and ts.is_wall(2) and not ts.is_wall(0)
    Q = random_state(ts, seed=6)
    got = assert_steps_match(js, ts, Q)
    np.testing.assert_array_equal(got[MAT], Q[MAT])
    # The free surface is not the periodic box: the walls did something.
    periodic = aderdg_from_jax(jax_ck_solver(3, (4, 2, 8)), physics="elastic3d_het",
                               device="cpu")
    per = state_to_numpy(periodic.run(state_from_numpy(Q, device="cpu"), 3, DT))
    assert np.abs(per - got).max() > 1e-7


def test_elastic_free_surface_signs_match_jax():
    refl, refl_flux = elastic.elastic3d_free_surface_het()
    jrefl, jrefl_flux = jel.elastic3d_free_surface_het()
    Q = np.random.default_rng(7).standard_normal((2, 12, 3))
    for d in range(3):
        np.testing.assert_array_equal(
            state_to_numpy(refl(torch.from_numpy(Q), d, 1)), np.asarray(jrefl(jnp.asarray(Q), d, 1)))
        np.testing.assert_array_equal(
            state_to_numpy(refl_flux(torch.from_numpy(Q), d, 1)),
            np.asarray(jrefl_flux(jnp.asarray(Q), d, 1)))


# ------------------------------------------------------------- NCP with walls

VELOCITY = (1.0, 0.5)


def _advection(jax_side):
    """Linear advection written as a flux and as a pure NCP, in either
    package (tests/test_aderdg.py:566)."""
    a = VELOCITY
    if jax_side:
        zeros, full = jnp.zeros_like, jnp.full
    else:
        zeros = torch.zeros_like

        def full(shape, v, dtype):
            return torch.full(shape, v, dtype=dtype)

    def flux(Q, axis, var_axis):
        return float(a[axis]) * Q

    def eig(Q, axis, var_axis):
        shape = Q.shape[:var_axis] + Q.shape[var_axis + 1:]
        return full(shape, float(abs(a[axis])), Q.dtype)

    def zero_flux(Q, axis, var_axis):
        return zeros(Q)

    def ncp(Q, dQ, axis, va):
        return float(a[axis]) * dQ

    return flux, eig, zero_flux, ncp


@pytest.mark.parametrize("boundary", ["outflow", "farfield"])
def test_ncp_walls_match_jax(boundary):
    kw = dict(dim=2, order=3, n_vars=1, grid_shape=(8, 8), dx=1.0 / 8,
              boundary=boundary, wall_axes=(0,))
    if boundary == "farfield":
        kw["farfield_state"] = (0.25,)
    jflux, jeig, jzero, jncp = _advection(jax_side=True)
    flux, eig, zero, ncp = _advection(jax_side=False)
    js = JaxSolver(flux_fn=jzero, max_eigenvalue_fn=jeig, ncp_fn=jncp, **kw)
    ts = ADERDGSolver(flux_fn=zero, max_eigenvalue_fn=eig, ncp_fn=ncp, device="cpu", **kw)
    cons = ADERDGSolver(flux_fn=flux, max_eigenvalue_fn=eig, device="cpu", **kw)
    rng = np.random.default_rng(8)
    Q = 0.5 + 0.2 * rng.standard_normal(ts.state_shape)
    got = assert_steps_match(js, ts, Q)
    # The NCP form through the walls is the flux form to rounding.
    ref = state_to_numpy(cons.run(state_from_numpy(Q, device="cpu"), 3, DT))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-11)


# ------------------------------------------------------------------ refusals


def test_wall_configuration_errors():
    flux, eig = euler_physics(2, n_real=4)

    def solver(**kw):
        return ADERDGSolver(2, 3, 4, (4, 4), flux, eig, device="cpu", **kw)

    for kw, match in (
        (dict(boundary="slip"), "unknown boundary"),
        (dict(boundary="dirichlet"), "requires dirichlet_fn"),
        (dict(boundary="reflective", reflect_fn=euler_reflect(2)), "reflect_flux_fn"),
        (dict(boundary="farfield", farfield_state=(1.0, 0.0)), "one entry per variable"),
        (dict(wall_axes=(0,)), "requires a wall boundary"),
        (dict(boundary="outflow", wall_axes=()), "non-empty"),
        (dict(boundary="outflow", wall_axes=(2,)), "non-empty"),
    ):
        with pytest.raises(SemanticError, match=match):
            solver(**kw)


def test_convert_needs_the_reflect_hooks_named():
    js = jax_euler(2, 3, (6, 6), boundary="reflective")
    with pytest.raises(SemanticError, match="walls="):
        aderdg_from_jax(js, gamma=GAMMA, device="cpu")
    with pytest.raises(SemanticError, match="walls must be"):
        aderdg_from_jax(js, gamma=GAMMA, walls="slip", device="cpu")
    with pytest.raises(SemanticError, match="reflective"):
        aderdg_from_jax(jax_euler(2, 3, (8, 4), **CASES_2D["outflow"][1]), gamma=GAMMA,
                        walls="euler", device="cpu")
    flux, eig = jax_euler_physics(dim=2, n_real=4)
    viscous = JaxSolver(dim=2, order=3, n_vars=4, grid_shape=(4, 4), flux_fn=flux,
                        max_eigenvalue_fn=eig, boundary="outflow",
                        visc_flux_fn=lambda q, g, d, va: 0.0 * q,
                        visc_eigenvalue_fn=lambda q, d, va: 0.0 * q[0])
    with pytest.raises(SemanticError, match="ROADMAP.md"):
        aderdg_from_jax(viscous, gamma=GAMMA, device="cpu")


def test_cuda_wrapper_refuses_unsigned_hooks_and_viscous_walls():
    """An arbitrary reflect callback has no sign table the face kernel can
    compile in: ``CudaADERDG`` refuses it (the plain path still runs it);
    so it does viscous walls."""
    flux, eig = euler_physics(3)

    def mirror(Q, axis, var_axis):
        return euler_reflect(3)(Q, axis, var_axis)

    sol = ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu", boundary="reflective",
                       reflect_fn=mirror, reflect_flux_fn=euler_reflect_flux(3))
    with pytest.raises(LoweringError, match="sign table"):
        CudaADERDG(sol)
    signed = ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu", boundary="reflective",
                          reflect_fn=euler_reflect(3), reflect_flux_fn=euler_reflect_flux(3))
    u = state_from_numpy(bench_state(signed), device="cpu")
    assert torch.equal(sol.step(u, DT), signed.step(u, DT))
    CudaADERDG(signed)
    signed.visc_flux_fn = lambda q, g, d, va: 0.0 * q
    with pytest.raises(LoweringError, match="viscous"):
        CudaADERDG(signed)


def test_limiter_refuses_a_walled_solver():
    """The limiter takes walls (tests/test_torch_limiter_walls.py, the
    MUSCL fallback's in tests/test_torch_limiter_muscl.py); what it still
    refuses around them: Dirichlet walls on the gathered path (JAX's own
    refusal, with its message)."""
    flux, eig = euler_physics(3)
    state_fn, kw = _smooth_state(3, 3, (2, 2, 4), 0.5)
    sol = ADERDGSolver(3, 3, 5, (2, 2, 4), flux, eig, device="cpu", boundary="dirichlet",
                       dirichlet_fn=make_dirichlet_fn(state_fn, **kw))
    with pytest.raises(SemanticError, match="does not support dirichlet walls"):
        LimitedADERDG(sol, euler_admissible(3), troubled_capacity=4,
                      troubled_granularity="row", device="cpu")
    LimitedADERDG(sol, euler_admissible(3), device="cpu")  # the whole grid takes them
    sol = ADERDGSolver(3, 3, 5, (2, 2, 4), flux, eig, device="cpu", boundary="outflow")
    LimitedADERDG(sol, euler_admissible(3), troubled_capacity=4, troubled_granularity="row",
                  device="cpu")
    muscl = LimitedADERDG(sol, euler_admissible(3), fallback_order=2, fallback_slope="mc",
                          device="cpu")
    u = state_from_numpy(bench_state(sol), device="cpu")
    assert torch.isfinite(muscl.step(u, DT)).all()


@pytest.mark.parametrize("name", sorted(CASES_3D))
def test_cuda_wrapper_wall_description(name):
    """What ``CudaADERDG`` hands the walled face kernels, read on the CPU:
    the wall variant's kernel names, the axis mask, the mode, the sign
    tables of the hooks, the farfield state, and the Dirichlet rows in the
    side tensor's layout (each wall axis's block a face row, side 1 after
    side 0)."""
    js = jax_euler(3, 3, (4, 2, 8), **CASES_3D[name])
    ts = _port(js)
    cu = CudaADERDG(ts)
    w = cu.walls
    axes = [d for d in range(3) if ts.is_wall(d)]
    assert cu.kernels == ("aderdg_predictor_volume", "aderdg_face_flux_walls",
                          "aderdg_surface_update_walls")
    assert w["mask"] == sum(1 << d for d in axes)
    assert w["mode"] == {"reflective": 0, "outflow": 0, "farfield": 1, "dirichlet": 2}[
        ts.boundary]
    sq, sf, far = w["table"][:15].reshape(3, 5), w["table"][15:30].reshape(3, 5), w["table"][30:]
    if ts.boundary == "reflective":
        np.testing.assert_array_equal(sq, ts.reflect_fn.signs)
        np.testing.assert_array_equal(sf, ts.reflect_flux_fn.signs)
    if ts.boundary == "outflow":
        assert (sq == 1).all() and (sf == 1).all()
    if ts.boundary == "farfield":
        np.testing.assert_array_equal(far, _ff(3))
    sizes = [16 * 5 * int(np.prod(ts.grid_shape)) // ts.grid_shape[d] for d in axes]
    assert w["size"] == sum(sizes)
    assert [int(w["off"][d]) for d in axes] == list(np.cumsum([0] + sizes[:-1]))
    side = torch.arange(w["size"], dtype=torch.float64)
    for d, view in cu.wall_fluxes(side).items():
        assert view.shape == (4, 4, 5) + tuple(1 if e == d else g
                                              for e, g in enumerate(ts.grid_shape))
        assert view.flatten()[0] == w["off"][d]
    if ts.boundary == "dirichlet":
        rows = w["rows"].reshape(2, -1)
        for s in (0, 1):
            for d, view in cu.wall_fluxes(rows[s]).items():
                np.testing.assert_array_equal(state_to_numpy(view), js.dirichlet_fn(d, s))
    else:
        assert w["rows"] is None
