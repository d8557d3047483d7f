"""Compressible Navier–Stokes in the port against the JAX package's, on the
CPU: the viscous flux and eigenvalue, the no-slip hooks, the viscous
ADER-DG step (periodic, no-slip walls, outflow walls; 2-D and 3-D), the
parabolic ``cfl_dt``, the μ → 0 reduction to Euler, ``aderdg_from_jax``
with ``physics="navier_stokes"``, and what the port refuses around viscous
solvers.

Inputs are made with NumPy from a seed and handed to both packages.  f64 at
rtol=0, atol=1e-12 (the repo's JAX↔Pallas bar), one step and 3 steps.  The
CUDA kernels of the viscous step (``aderdg_predictor_volume_visc`` and the
penalised face stage) are held against these plain versions on the card in
``tests/test_torch_cuda.py``.
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
from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError

torch.set_num_threads(1)

GAMMA = 1.4
MU = 0.02
PRANDTL = 0.7
DT = 1e-3  # under cfl_dt of every state below (≥ 1.3e-3)


def jax_ns(dim, grid, mu=MU, prandtl=PRANDTL, order=3, **walls):
    """A JAX viscous solver as tests/test_navier_stokes.py builds it."""
    f, e, vf, ve = jns.navier_stokes(dim=dim, mu=mu, prandtl=prandtl)
    if walls.get("boundary") == "reflective":
        walls = dict(walls, reflect_fn=jns.noslip_reflect(dim),
                     reflect_flux_fn=jns.noslip_reflect_flux(dim))
    return JaxSolver(
        dim=dim, order=order, n_vars=dim + 2, grid_shape=grid,
        flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
        visc_flux_fn=jns.wrap_visc_var_last(vf), visc_eigenvalue_fn=wrap_var_last(ve),
        dx=1.0 / grid[0], **walls,
    )


def port_of(js, mu=MU, prandtl=PRANDTL):
    walls = "noslip" if js.boundary == "reflective" else None
    return aderdg_from_jax(js, physics="navier_stokes", gamma=GAMMA, mu=mu,
                           prandtl=prandtl, walls=walls, device="cpu")


def random_state(solver, seed=0):
    """An admissible state with random density, momenta and pressure at
    every node (var axis in the solver's place)."""
    rng = np.random.default_rng(seed)
    va, dim = solver.var_axis, solver.dim
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    rho = 1.0 + 0.2 * rng.random(no_var)
    m = [0.3 * rng.standard_normal(no_var) for _ in range(dim)]
    p = 1.0 + 0.2 * rng.random(no_var)
    E = p / (GAMMA - 1.0) + 0.5 * sum(x * x for x in m) / rho
    return np.stack([rho] + m + [E], axis=va)


def vortex_state(solver, V0=1e-2):
    """``examples/navier_stokes_vortex.py``'s Taylor–Green vortex (2-D) or
    its 3-D form, at uniform (ρ, p) = (1, 1)."""
    coords = solver.nodes_meshgrid()
    va, dim = solver.var_axis, solver.dim
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    X = [np.broadcast_to(np.squeeze(c, va), no_var) for c in coords]
    k = 2 * np.pi
    if dim == 2:
        vel = [V0 * np.sin(k * X[0]) * np.cos(k * X[1]),
               -V0 * np.cos(k * X[0]) * np.sin(k * X[1])]
    else:
        vel = [V0 * np.sin(k * X[0]) * np.cos(k * X[1]) * np.cos(k * X[2]),
               -V0 * np.cos(k * X[0]) * np.sin(k * X[1]) * np.cos(k * X[2]),
               np.zeros(no_var)]
    rho = np.ones(no_var)
    E = 1.0 / (GAMMA - 1.0) + 0.5 * sum(v * v for v in vel)
    return np.stack([rho] + vel + [E], axis=va)


def channel_state(solver, V=1e-3):
    """The no-slip channel mode v_y = V sin(πx) at uniform (ρ, p)
    (tests/test_navier_stokes.py:405-435; in 3-D along the last axis)."""
    coords = solver.nodes_meshgrid()
    va, dim = solver.var_axis, solver.dim
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    X = np.broadcast_to(np.squeeze(coords[0], va), no_var)
    mt = V * np.sin(np.pi * X)
    zeros = np.zeros_like(X)
    E = 1.0 / (GAMMA - 1.0) + 0.5 * mt**2
    return np.stack([np.ones_like(X)] + [zeros] * (dim - 1) + [mt, E], axis=va)


def bump_state(solver):
    """A compact density bump at rest in the middle of axis 0
    (tests/test_navier_stokes.py:487-495)."""
    coords = solver.nodes_meshgrid()
    va, dim = solver.var_axis, solver.dim
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    X = np.broadcast_to(np.squeeze(coords[0], va), no_var)
    rho = 1.0 + 0.2 * np.exp(-(((X - 0.5) / 0.05) ** 2))
    zeros = np.zeros_like(X)
    return np.stack([rho] + [zeros] * dim + [np.full_like(X, 1.0 / (GAMMA - 1.0))], axis=va)


def assert_steps_match(js, ts, Q, dt=DT, n=3):
    """One step and ``n`` steps of both solvers from ``Q``, at 1e-12."""
    u = state_from_numpy(Q, device="cpu")
    jstep = jax.jit(lambda q: js.step(q, dt))
    ref = jstep(jnp.asarray(Q))
    one = state_to_numpy(ts.step(u, dt))
    np.testing.assert_allclose(one, np.asarray(ref), rtol=0, atol=1e-12)
    for _ in range(n - 1):
        ref = jstep(ref)
    got = state_to_numpy(ts.run(u, n, dt))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-12)
    assert np.isfinite(got).all()
    return got


# --------------------------------------------------------------- pointwise


@pytest.mark.parametrize("dim", [2, 3])
def test_viscous_flux_and_eigenvalue_match_jax(dim):
    """``viscous_flux`` along every axis and ``viscous_eigenvalue`` on
    random admissible var-last states and random gradients."""
    rng = np.random.default_rng(10 + dim)
    n = 64
    rho = 1.0 + 0.3 * rng.random(n)
    m = 0.4 * rng.standard_normal((n, dim))
    p = 1.0 + 0.3 * rng.random(n)
    E = p / (GAMMA - 1.0) + 0.5 * (m**2).sum(-1) / rho
    Q = np.concatenate([rho[:, None], m, E[:, None]], -1)
    grads = tuple(rng.standard_normal((n, dim + 2)) for _ in range(dim))
    kw = dict(dim=dim, mu=0.013, prandtl=0.71, gamma=GAMMA)
    tQ = torch.from_numpy(Q)
    tg = tuple(torch.from_numpy(g) for g in grads)
    for d in range(dim):
        ref = np.asarray(jns.viscous_flux(jnp.asarray(Q), tuple(map(jnp.asarray, grads)), d,
                                          **kw))
        np.testing.assert_allclose(state_to_numpy(ns.viscous_flux(tQ, tg, d, **kw)), ref,
                                   rtol=0, atol=1e-14)
        np.testing.assert_allclose(state_to_numpy(ns.viscous_eigenvalue(tQ, d, **kw)),
                                   np.asarray(jns.viscous_eigenvalue(jnp.asarray(Q), d, **kw)),
                                   rtol=0, atol=1e-15)
    # The solver-contract callbacks (var axis in the middle) give the same.
    _, _, visc, visc_eig = ns.navier_stokes(**kw)
    Qm, gm = tQ.movedim(-1, 0), tuple(g.movedim(-1, 0) for g in tg)
    for d in range(dim):
        np.testing.assert_array_equal(state_to_numpy(visc(Qm, gm, d, 0).movedim(0, -1)),
                                      state_to_numpy(ns.viscous_flux(tQ, tg, d, **kw)))
        np.testing.assert_array_equal(state_to_numpy(visc_eig(Qm, d, 0)),
                                      state_to_numpy(ns.viscous_eigenvalue(tQ, d, **kw)))
    # wrap_visc_var_last adapts a var-last callback to the same contract.
    wrapped = ns.wrap_visc_var_last(lambda Q_, g_, d_: ns.viscous_flux(Q_, g_, d_, **kw))
    np.testing.assert_array_equal(state_to_numpy(wrapped(Qm, gm, 1, 0)),
                                  state_to_numpy(visc(Qm, gm, 1, 0)))


@pytest.mark.parametrize("dim", [2, 3])
def test_noslip_hooks_match_jax(dim):
    """The no-slip pair are sign tables with the JAX hooks' bits."""
    refl, refl_flux = ns.noslip_reflect(dim), ns.noslip_reflect_flux(dim)
    np.testing.assert_array_equal(refl.signs, [[1.0] + [-1.0] * dim + [1.0]] * dim)
    np.testing.assert_array_equal(refl_flux.signs, [[-1.0] + [1.0] * dim + [-1.0]] * dim)
    Q = np.random.default_rng(20 + dim).standard_normal((3, dim + 2, 2))
    for d in range(dim):
        for port, ref in ((refl, jns.noslip_reflect(dim)),
                          (refl_flux, jns.noslip_reflect_flux(dim))):
            np.testing.assert_array_equal(state_to_numpy(port(torch.from_numpy(Q), d, 1)),
                                          np.asarray(ref(jnp.asarray(Q), d, 1)))


def test_callbacks_carry_one_physics_tag():
    cbs = ns.navier_stokes(3, mu=0.01, prandtl=0.71, gamma=1.3)
    tags = {fn.physics for fn in cbs}
    assert len(tags) == 1
    tag = tags.pop()
    assert (tag.name, tag.dim, tag.n_real, tag.params) == ("navier_stokes", 3, 5,
                                                           (1.3, 0.01, 0.71))
    # The flux and eigenvalue are euler_physics's.
    flux, eig = euler_physics(3, n_real=5, gamma=1.3)
    Q = torch.from_numpy(random_state(
        ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu"), seed=21))
    for d in range(3):
        assert torch.equal(cbs[0](Q, d, 3), flux(Q, d, 3))
        assert torch.equal(cbs[1](Q, d, 3), eig(Q, d, 3))


# -------------------------------------------------------------- the step


#: tests/test_navier_stokes.py's and the example's configurations: the
#: Taylor–Green vortex of examples/navier_stokes_vortex.py (2-D, 8 cells,
#: μ = 5e-3, V0 = 1e-2), a 3-D p3 solver on a random state, and the 3-D
#: vortex.
STEP_CASES = {
    "vortex_2d": (2, (8, 8), 5e-3, "vortex"),
    "random_2d": (2, (8, 8), MU, "random"),
    "random_3d": (3, (4, 2, 4), MU, "random"),
    "vortex_3d": (3, (4, 2, 4), MU, "vortex"),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_periodic_steps_match_jax(name):
    dim, grid, mu, kind = STEP_CASES[name]
    js = jax_ns(dim, grid, mu=mu)
    ts = port_of(js, mu=mu)
    assert ts.visc_flux_fn is not None and not ts.splits_wall_viscosity
    Q = random_state(ts, seed=1) if kind == "random" else vortex_state(ts)
    assert_steps_match(js, ts, Q)


def test_predictor_returns_the_viscous_split():
    """``predictor(return_visc=True)`` appends the viscous-only time-averaged
    fluxes, as the JAX predictor does."""
    js = jax_ns(3, (4, 2, 4))
    ts = port_of(js)
    Q = random_state(ts, seed=2)
    qbar, fbar, fvbar = ts.predictor(state_from_numpy(Q, device="cpu"), DT, return_visc=True)
    jq, jf, jfv = js.predictor(jnp.asarray(Q), DT, return_visc=True)
    np.testing.assert_allclose(state_to_numpy(qbar), np.asarray(jq), rtol=0, atol=1e-12)
    for d in range(3):
        np.testing.assert_allclose(state_to_numpy(fbar[d]), np.asarray(jf[d]), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(state_to_numpy(fvbar[d]), np.asarray(jfv[d]), rtol=0,
                                   atol=1e-12)
        assert float(np.abs(np.asarray(jfv[d])).max()) > 1e-4  # the split is not empty


@pytest.mark.parametrize("dim,grid", [(2, (8, 8)), (3, (4, 2, 4))])
def test_cfl_dt_has_the_parabolic_term(dim, grid):
    """``cfl_dt`` matches JAX's to rounding, and with a large μ the
    parabolic term sets it."""
    for mu in (MU, 0.5):
        js = jax_ns(dim, grid, mu=mu)
        ts = port_of(js, mu=mu)
        Q = random_state(ts, seed=3)
        got = float(ts.cfl_dt(state_from_numpy(Q, device="cpu")))
        ref = float(js.cfl_dt(jnp.asarray(Q)))
        assert got == pytest.approx(ref, rel=1e-14, abs=0)
        euler_only = float(aderdg_from_jax(js_euler(dim, grid), gamma=GAMMA,
                                           device="cpu").cfl_dt(
            state_from_numpy(Q, device="cpu")))
        assert got < euler_only
    assert got < 0.5 * euler_only  # μ = 0.5: the diffusion limit dominates


def js_euler(dim, grid):
    f, e = jeuler.flux_v_fn(dim=dim, n_real=dim + 2), jeuler.max_eigenvalue_v_fn(dim=dim)
    return JaxSolver(dim=dim, order=3, n_vars=dim + 2, grid_shape=grid,
                     flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
                     dx=1.0 / grid[0])


@pytest.mark.parametrize("dim,grid", [(2, (8, 8)), (3, (4, 2, 4))])
def test_zero_viscosity_is_the_euler_step_bitwise(dim, grid):
    """μ = 0 (tests/test_navier_stokes.py:43 in the port): the viscous
    solver's step, its faces and its cfl_dt are the Euler solver's bits."""
    visc = port_of(jax_ns(dim, grid, mu=0.0), mu=0.0)
    flux, eig = euler_physics(dim, n_real=dim + 2)
    plain = ADERDGSolver(dim, 3, dim + 2, grid, flux, eig, dx=1.0 / grid[0], device="cpu")
    u = state_from_numpy(random_state(plain, seed=4), device="cpu")
    assert torch.equal(visc.step(u, DT), plain.step(u, DT))
    assert torch.equal(visc.cfl_dt(u), plain.cfl_dt(u))


# ------------------------------------------------------------------ walls


#: tests/test_navier_stokes.py:387-503: the no-slip channel (walls on axis
#: 0, periodic across) and outflow walls on axis 0, in 2-D and 3-D, and a
#: closed no-slip box in 3-D.
WALL_CASES = {
    "noslip_channel_2d": (2, (8, 4), dict(boundary="reflective", wall_axes=(0,)), "channel"),
    "noslip_channel_3d": (3, (4, 2, 4), dict(boundary="reflective", wall_axes=(0,)),
                          "channel"),
    "noslip_box_3d": (3, (4, 2, 4), dict(boundary="reflective"), "random"),
    "outflow_2d": (2, (16, 8), dict(boundary="outflow", wall_axes=(0,)), "bump"),
    "outflow_3d": (3, (8, 2, 4), dict(boundary="outflow", wall_axes=(0,)), "random"),
}


@pytest.mark.parametrize("name", sorted(WALL_CASES))
def test_wall_steps_match_jax(name):
    dim, grid, walls, kind = WALL_CASES[name]
    js = jax_ns(dim, grid, **walls)
    ts = port_of(js)
    assert ts.splits_wall_viscosity
    Q = {"channel": channel_state, "bump": bump_state,
         "random": lambda s: random_state(s, seed=5)}[kind](ts)
    # The stage by stage contract: the side tensor holds the wall planes.
    new, faces, fvwall = ts.predictor_volume(state_from_numpy(Q, device="cpu"), DT)
    planes = ts.wall_planes()
    assert fvwall.numel() == 2 * sum(int(np.prod(s)) for s in planes.values())
    _, _, jfv = js.predictor(jnp.asarray(Q), DT, return_visc=True)
    for d, (fv_lo, fv_hi) in ts.visc_wall_rows(fvwall).items():
        na, ga = d, dim + d  # the node axis, and the grid axis of a face row
        lo = np.take(np.tensordot(ts.ops.phi0, np.asarray(jfv[d]), axes=([0], [na])), [0], ga)
        hi = np.take(np.tensordot(ts.ops.phi1, np.asarray(jfv[d]), axes=([0], [na])),
                     [grid[d] - 1], ga)
        np.testing.assert_allclose(state_to_numpy(fv_lo), lo, rtol=0, atol=1e-12)
        np.testing.assert_allclose(state_to_numpy(fv_hi), hi, rtol=0, atol=1e-12)
    with pytest.raises(SemanticError, match="fvwall"):
        ts.face_surface(new, faces, DT)
    assert_steps_match(js, ts, Q)


def test_outflow_walls_keep_the_periodic_answer_before_the_bump_arrives():
    """tests/test_navier_stokes.py:477-503 in the port: while the bump has
    not reached the outflow walls the walled run is the periodic run."""
    js = jax_ns(2, (16, 8), mu=5e-3, boundary="outflow", wall_axes=(0,))
    walled = port_of(js, mu=5e-3)
    periodic = port_of(jax_ns(2, (16, 8), mu=5e-3), mu=5e-3)
    u = state_from_numpy(bump_state(walled), device="cpu")
    np.testing.assert_allclose(state_to_numpy(walled.run(u, 3, 5e-4)),
                               state_to_numpy(periodic.run(u, 3, 5e-4)), rtol=0, atol=1e-12)


def test_noslip_box_conserves_mass():
    """A closed no-slip box (tests/test_navier_stokes.py:438): no mass
    crosses the walls, and the stirred fluid loses kinetic energy."""
    js = jax_ns(2, (8, 8), mu=0.05, order=2, boundary="reflective")
    ts = port_of(js, mu=0.05)
    u = state_from_numpy(vortex_state(ts, V0=1e-3), device="cpu")
    out = ts.run(u, 40, float(ts.cfl_dt(u)))
    m0, m1 = ts.total_mass(u), ts.total_mass(out)
    assert abs(float(m1[0] - m0[0])) <= 1e-12 * float(m0[0])

    def ke(q):
        return float((0.5 * (q[:, :, 1] ** 2 + q[:, :, 2] ** 2) / q[:, :, 0]).sum())

    assert ke(out) < 0.9 * ke(u)


# ---------------------------------------------------------------- convert


def test_convert_builds_the_tagged_callbacks_and_noslip_walls():
    js = jax_ns(3, (4, 2, 4), mu=0.011, prandtl=0.72, boundary="reflective", wall_axes=(0,))
    ts = aderdg_from_jax(js, physics="navier_stokes", gamma=GAMMA, mu=0.011, prandtl=0.72,
                         walls="noslip", device="cpu")
    tags = {fn.physics for fn in (ts.flux_fn, ts.max_eigenvalue_fn, ts.visc_flux_fn,
                                  ts.visc_eigenvalue_fn)}
    assert tags == {ns.navier_stokes(3, 0.011, 0.72, GAMMA)[0].physics}
    np.testing.assert_array_equal(ts.reflect_fn.signs, ns.noslip_reflect(3).signs)
    np.testing.assert_array_equal(ts.reflect_flux_fn.signs, ns.noslip_reflect_flux(3).signs)
    assert ts.wall_axes == (0,)
    assert_steps_match(js, ts, channel_state(ts), n=2)
    # A port 4-tuple crosses too.
    four = aderdg_from_jax(js, physics=ns.navier_stokes(3, 0.011, 0.72, GAMMA),
                           walls="noslip", device="cpu")
    assert four.visc_eigenvalue_fn.physics == ts.visc_eigenvalue_fn.physics


def test_convert_refuses_unnamed_or_mismatched_viscosity():
    js = jax_ns(2, (4, 4))
    for kw, match in (
        (dict(gamma=GAMMA), "viscous callbacks"),
        (dict(physics="navier_stokes", gamma=GAMMA), "needs mu and prandtl"),
        (dict(physics="navier_stokes", mu=MU, prandtl=PRANDTL), "needs gamma"),
        (dict(gamma=GAMMA, mu=MU), "apply to physics='navier_stokes' only"),
    ):
        with pytest.raises(SemanticError, match=match):
            aderdg_from_jax(js, device="cpu", **kw)
    with pytest.raises(SemanticError, match="only a viscous one"):
        aderdg_from_jax(js_euler(2, (4, 4)), physics="navier_stokes", gamma=GAMMA, mu=MU,
                        prandtl=PRANDTL, device="cpu")


# ------------------------------------------------------------------ guards


def _ns_kw(dim=2):
    flux, eig, visc, visc_eig = ns.navier_stokes(dim, mu=MU, prandtl=PRANDTL)
    return dict(dim=dim, order=2, n_vars=dim + 2, grid_shape=(4,) * dim, flux_fn=flux,
                max_eigenvalue_fn=eig, device="cpu"), visc, visc_eig


def test_viscous_options_must_be_set_together_and_refuse_ck():
    kw, visc, visc_eig = _ns_kw()
    with pytest.raises(SemanticError, match="must be set together"):
        ADERDGSolver(**kw, visc_flux_fn=visc)
    with pytest.raises(SemanticError, match="must be set together"):
        ADERDGSolver(**kw, visc_eigenvalue_fn=visc_eig)
    with pytest.raises(SemanticError, match="Cauchy–Kovalewski"):
        ADERDGSolver(**kw, visc_flux_fn=visc, visc_eigenvalue_fn=visc_eig,
                     predictor_mode="ck")
    with pytest.raises(SemanticError, match="return_visc requires"):
        ADERDGSolver(**kw).predictor(torch.zeros(ADERDGSolver(**kw).state_shape,
                                                 dtype=torch.float64), DT, return_visc=True)


def test_limiter_refuses_a_viscous_solver():
    """The gathered fallback carries no diffusive fluxes: a viscous solver
    is refused there with JAX's words, and so is one with Dirichlet walls
    (ghost gradients at prescribed states are unspecified); the whole-grid
    fallbacks take it (``test_limiter_over_a_viscous_solver_matches_jax``)."""
    kw, visc, visc_eig = _ns_kw(3)
    sol = ADERDGSolver(**dict(kw, order=3, grid_shape=(2, 2, 4)), visc_flux_fn=visc,
                       visc_eigenvalue_fn=visc_eig)
    with pytest.raises(SemanticError,
                       match=r"viscous solvers are not supported on the gathered "
                             r"\(troubled_capacity\) fallback paths yet; see ROADMAP.md, "
                             r"Queue 1 item 9"):
        LimitedADERDG(sol, euler_admissible(3), troubled_capacity=4,
                      troubled_granularity="row", device="cpu")
    LimitedADERDG(sol, euler_admissible(3), device="cpu")
    sol.boundary = "dirichlet"
    with pytest.raises(SemanticError, match=r"limited viscous solvers with dirichlet walls "
                                            r"are not supported"):
        LimitedADERDG(sol, euler_admissible(3), device="cpu")


def test_limiter_over_a_viscous_solver_matches_jax():
    """The whole-grid limited step over a 3-D viscous solver with no-slip
    walls on axis 0, every cell on the first-order fallback, against JAX
    (tests/test_torch_viscous_limited.py holds the other fallbacks)."""
    from exahype_tpu.models.limiter import LimitedADERDG as JaxLimited
    from exahype_tpu_torch.convert import limited_from_jax

    js = jax_ns(3, (2, 2, 4), boundary="reflective", wall_axes=(0,))
    jl = JaxLimited(js)
    port = limited_from_jax(jl, gamma=GAMMA, walls="noslip", physics="navier_stokes", mu=MU,
                            prandtl=PRANDTL, device="cpu")
    port.troubled_mask = lambda u, c: torch.ones(js.grid_shape, dtype=torch.bool)
    Q = random_state(js, seed=9)
    ref = jax.jit(lambda q: jl.step(q, DT, troubled_transform=jnp.ones_like))(jnp.asarray(Q))
    got = port.step(state_from_numpy(Q, device="cpu"), DT)
    np.testing.assert_allclose(state_to_numpy(got), np.asarray(ref), rtol=0, atol=1e-12)


def test_cuda_wrapper_takes_the_tagged_physics_only():
    """``CudaADERDG`` accepts a viscous solver whose four callbacks carry
    the Navier–Stokes tag (3-D, order 3), names its kernels, and refuses
    any other viscous callback, the tag on a solver without viscosity,
    and other orders; the plain solver runs them all."""
    flux, eig, visc, visc_eig = ns.navier_stokes(3, mu=MU, prandtl=PRANDTL)
    kw = dict(dx=0.25, device="cpu")
    sol = ADERDGSolver(3, 3, 5, (2, 2, 4), flux, eig, visc_flux_fn=visc,
                       visc_eigenvalue_fn=visc_eig, **kw)
    cu = CudaADERDG(sol)
    assert cu.kernels == ("aderdg_predictor_volume_visc", "aderdg_face_flux",
                          "aderdg_surface_update")
    walled = ADERDGSolver(3, 3, 5, (2, 2, 4), flux, eig, visc_flux_fn=visc,
                          visc_eigenvalue_fn=visc_eig, boundary="reflective",
                          reflect_fn=ns.noslip_reflect(3),
                          reflect_flux_fn=ns.noslip_reflect_flux(3), wall_axes=(0,), **kw)
    cw = CudaADERDG(walled)
    assert cw.kernels == ("aderdg_predictor_volume_visc", "aderdg_face_flux_walls",
                          "aderdg_surface_update_walls")
    # The kernels' parameters: γ, μ, max(4/3, γ/Pr), κ_T and the penalty of
    # each axis, as the plain solver computes them.
    np.testing.assert_array_equal(cw._params, [GAMMA, MU, max(4 / 3, GAMMA / PRANDTL),
                                               MU * GAMMA / ((GAMMA - 1) * PRANDTL),
                                               2.0 * 7 / 0.25, 2.0 * 7 / 0.25, 2.0 * 7 / 0.25])
    # On the CPU the wrapper is the plain path, the wall split included.
    u = state_from_numpy(random_state(walled, seed=6), device="cpu")
    assert torch.equal(cw.step(u, DT), walled.step(u, DT))
    new, faces, fvwall = cw.predictor_volume(u, DT)
    assert torch.equal(cw.face_surface(new.clone(), faces, DT, fvwall=fvwall),
                       walled.face_surface(new, faces, DT, fvwall=fvwall))

    euler_flux, euler_eig = euler_physics(3)
    for fns, match in (
        ((flux, eig, lambda q, g, d, va: 0.0 * q, visc_eig), "viscous"),
        ((euler_flux, euler_eig, visc, visc_eig), "viscous"),
        ((flux, eig, ns.wrap_visc_var_last(
            lambda q, g, d: ns.viscous_flux(q, g, d, dim=3)), visc_eig), "viscous"),
        ((flux, eig, None, None), "navier_stokes"),
    ):
        s = ADERDGSolver(3, 3, 5, (2, 2, 4), fns[0], fns[1], visc_flux_fn=fns[2],
                         visc_eigenvalue_fn=fns[3], **kw)
        with pytest.raises(LoweringError, match=match):
            CudaADERDG(s)
        s.step(u, DT)  # the plain solver runs it
    # 2-D at orders 3 and 2 has kernels of its own, periodic and walled;
    # other orders are refused.
    flux2, eig2, visc2, visc_eig2 = ns.navier_stokes(2)
    s2 = ADERDGSolver(2, 3, 4, (4, 4), flux2, eig2, visc_flux_fn=visc2,
                      visc_eigenvalue_fn=visc_eig2, **kw)
    assert CudaADERDG(s2).kernels == ("aderdg_predictor_volume_visc_2d",
                                      "aderdg_face_flux_2d", "aderdg_surface_update_2d")
    w2 = ADERDGSolver(2, 3, 4, (4, 4), flux2, eig2, visc_flux_fn=visc2,
                      visc_eigenvalue_fn=visc_eig2, boundary="outflow", **kw)
    assert CudaADERDG(w2).kernels == ("aderdg_predictor_volume_visc_2d",
                                      "aderdg_face_flux_walls_2d",
                                      "aderdg_surface_update_walls_2d")
    o2 = ADERDGSolver(2, 2, 4, (4, 4), flux2, eig2, visc_flux_fn=visc2,
                      visc_eigenvalue_fn=visc_eig2, **kw)
    assert CudaADERDG(o2).kernels == ("aderdg_predictor_volume_visc_p2_2d",
                                      "aderdg_face_flux_p2_2d", "aderdg_surface_update_p2_2d")
    o4 = ADERDGSolver(2, 4, 4, (4, 4), flux2, eig2, visc_flux_fn=visc2,
                      visc_eigenvalue_fn=visc_eig2, **kw)
    with pytest.raises(LoweringError, match="no CUDA kernel instantiated.*Queue 1 item 4"):
        CudaADERDG(o4)
