"""The limiter over a viscous (compressible Navier–Stokes) solver against
the JAX package's on the CPU.

The whole-grid fallbacks each add central-difference diffusive face
fluxes over a viscous solver: the first-order subcell sweeps, the MUSCL
stages (``fallback_order=2``) and the cell-mean ``"means"`` update.  Each
is held against the JAX limiter on the same NumPy state (seeded noise on
every node), periodic and with no-slip, outflow and farfield walls, in 2-D
and 3-D, the fallback alone with its face fluxes and forced limited steps;
then ``examples/viscous_shock.py`` at its CPU size, ``(16, 4)`` for 25
steps, both viscosities, through ``limited_from_jax``.  f64 at rtol=0,
atol=1e-12.  JAX forces every cell with ``troubled_transform``; the port's
``troubled_mask`` is replaced by an all-True one
(``tests/test_torch_limiter_walls.py``'s convention).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import euler as jeuler
from exahype_tpu.models import navier_stokes as jns
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import make_dirichlet_fn as jax_make_dirichlet_fn
from exahype_tpu.models.aderdg import wrap_var_last
from exahype_tpu.models.limiter import LimitedADERDG as JaxLimited
from exahype_tpu.models.limiter import euler_admissible as jax_admissible
from exahype_tpu.utils.errors import SemanticError as JaxSemanticError
from exahype_tpu_torch.convert import limited_from_jax, state_from_numpy, state_to_numpy
from exahype_tpu_torch.models import navier_stokes as ns
from exahype_tpu_torch.models.aderdg import ADERDGSolver, make_dirichlet_fn
from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible
from exahype_tpu_torch.utils.errors import SemanticError

torch.set_num_threads(1)

ATOL = 1e-12
MU, PRANDTL, GAMMA = 0.02, 0.7, 1.4
GRIDS = {2: (6, 4), 3: (4, 2, 4)}
ORDERS = {2: 3, 3: 2}
FF = {2: (1.0, 0.1, 0.0, 2.6), 3: (1.0, 0.1, 0.0, 0.05, 2.6)}


def walls_of(name, dim):
    return {
        "periodic": {},
        "noslip": dict(boundary="reflective", reflect_fn=jns.noslip_reflect(dim),
                       reflect_flux_fn=jns.noslip_reflect_flux(dim), wall_axes=(0,)),
        "outflow": dict(boundary="outflow", wall_axes=(dim - 1,)),
        "farfield": dict(boundary="farfield", farfield_state=FF[dim]),
    }[name]


def jax_ns(dim, walls="periodic", grid=None, mu=MU, order=None):
    grid = grid or GRIDS[dim]
    f, e, vf, ve = jns.navier_stokes(dim=dim, mu=mu, prandtl=PRANDTL)
    return JaxSolver(dim=dim, order=order or ORDERS[dim], n_vars=dim + 2, grid_shape=grid,
                     flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
                     visc_flux_fn=jns.wrap_visc_var_last(vf),
                     visc_eigenvalue_fn=wrap_var_last(ve), dx=1.0 / grid[0],
                     **walls_of(walls, dim))


def limiters(js, mu=MU, **opts):
    jl = JaxLimited(js, admissible=jax_admissible(js.dim), **opts)
    walls = "noslip" if js.boundary == "reflective" else None
    pl = limited_from_jax(jl, gamma=GAMMA, walls=walls, physics="navier_stokes", mu=mu,
                          prandtl=PRANDTL, device="cpu")
    return jl, pl


def noisy_state(js, seed=0):
    rng = np.random.default_rng(seed)
    va = js.var_axis
    shape = js.state_shape[:va] + js.state_shape[va + 1:]
    rho = 1.0 + 0.3 * rng.random(shape)
    vel = [0.3 * rng.standard_normal(shape) for _ in range(js.dim)]
    p = 1.0 + 0.3 * rng.random(shape)
    e = p / 0.4 + 0.5 * rho * sum(v * v for v in vel)
    return np.stack([rho] + [rho * v for v in vel] + [e], axis=va)


def close(got, ref, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=ATOL,
                               err_msg=msg)


FALLBACKS = {
    "first order": dict(),
    "MUSCL minmod": dict(fallback_order=2),
    "MUSCL mc": dict(fallback_order=2, fallback_slope="mc"),
    "means": dict(fallback="means"),
}


@pytest.mark.parametrize("walls", ["periodic", "noslip", "outflow", "farfield"])
@pytest.mark.parametrize("fallback", sorted(FALLBACKS))
def test_viscous_fallbacks_match_jax_2d(fallback, walls):
    check(2, fallback, walls)


@pytest.mark.parametrize("walls", ["periodic", "noslip"])
@pytest.mark.parametrize("fallback", ["first order", "MUSCL minmod", "means"])
def test_viscous_fallbacks_match_jax_3d(fallback, walls):
    check(3, fallback, walls)


def check(dim, fallback, walls):
    """The fallback alone (with its face fluxes, the subcell ones) and two
    forced limited steps, port against JAX."""
    js = jax_ns(dim, walls)
    opts = FALLBACKS[fallback]
    jl, pl = limiters(js, **opts)
    Q = noisy_state(js, seed=3 + dim)
    dt = 0.4 * float(js.cfl_dt(jnp.asarray(Q)))
    u = state_from_numpy(Q, device="cpu")
    subcell = opts.get("fallback") != "means"
    if subcell:
        ref, ref_fl = jax.jit(lambda q: jl.subcell_fv_step(q, dt, return_face_fluxes=True))(
            jnp.asarray(Q))
        got, got_fl = pl.subcell_fv_step(u, dt, return_face_fluxes=True)
        for d, (a, b) in enumerate(zip(got_fl, ref_fl)):
            close(state_to_numpy(a), b, f"subcell face fluxes[{d}]")
    else:
        ref, got = jax.jit(lambda q: jl.fv_fallback(q, dt))(jnp.asarray(Q)), pl.fv_fallback(u, dt)
    close(state_to_numpy(got), ref, "the fallback")
    # The diffusive fluxes move the fallback: the same limiter over the
    # inviscid solver gives another state.
    inviscid = LimitedADERDG(ADERDGSolver(dim, js.order, dim + 2, js.grid_shape,
                                          pl.solver.flux_fn, pl.solver.max_eigenvalue_fn,
                                          dx=js.dx, device="cpu", **_port_walls(pl.solver)),
                             device="cpu", **opts)
    other = inviscid.subcell_fv_step(u, dt) if subcell else inviscid.fv_fallback(u, dt)
    assert float((other - got).abs().max()) > 1e-6
    pl.troubled_mask = lambda u_, c: torch.ones(js.grid_shape, dtype=torch.bool)
    step = jax.jit(lambda q: jl.step(q, dt, return_face_fluxes=subcell,
                                     troubled_transform=jnp.ones_like))
    ref = jnp.asarray(Q)
    for k in range(2):
        out = step(ref)
        got = pl.step(u, dt, return_face_fluxes=subcell)
        if subcell:
            (ref, ref_fl), (u, fl) = out, got
            for d, (a, b) in enumerate(zip(fl, ref_fl)):
                close(state_to_numpy(a), b, f"step {k + 1}, face fluxes[{d}]")
        else:
            ref, u = out, got
        close(state_to_numpy(u), ref, f"step {k + 1}")


def _port_walls(sol):
    return {name: getattr(sol, name) for name in
            ("boundary", "reflect_fn", "reflect_flux_fn", "farfield_state", "wall_axes")}


def test_viscous_unforced_step_conserves_and_matches_jax():
    """A 2-D shock tube with the limiter's own detection: the masks and
    three MUSCL steps against JAX, and mass, momentum and energy kept to
    rounding while cells are limited."""
    js = jax_ns(2, grid=(12, 4), mu=5e-3)
    jl, pl = limiters(js, mu=5e-3, fallback_order=2)
    Q = shock_tube(js)
    dt = 0.5 * float(js.cfl_dt(jnp.asarray(Q)))
    step = jax.jit(lambda q: jl.step(q, dt))
    ref, u = jnp.asarray(Q), state_from_numpy(Q, device="cpu")
    m0 = pl.solver.total_mass(u)
    fired = 0
    for k in range(3):
        mask = np.asarray(jl.troubled_mask(ref, js.step(ref, dt)))
        np.testing.assert_array_equal(pl.troubled_mask(u, pl.solver.step(u, dt)).numpy(), mask)
        fired += int(mask.sum())
        ref, u = step(ref), pl.step(u, dt)
        close(state_to_numpy(u), ref, f"step {k + 1}")
    assert fired > 0
    assert float((pl.solver.total_mass(u) - m0).abs().max()) < 1e-12


def shock_tube(js):
    """``examples/viscous_shock.py:50-59``: the slab 0.25 < x < 0.75 at
    (ρ, p) = (1, 1), (0.125, 0.1) outside, at rest."""
    va = js.var_axis
    no_var = js.state_shape[:va] + js.state_shape[va + 1:]
    X = np.broadcast_to(np.squeeze(np.asarray(js.nodes_meshgrid()[0]), va), no_var)
    inside = (X > 0.25) & (X < 0.75)
    rho = np.where(inside, 1.0, 0.125)
    p = np.where(inside, 1.0, 0.1)
    z = np.zeros_like(X)
    return np.stack([rho, z, z, p / (jeuler.GAMMA - 1)], axis=va)


@pytest.fixture(scope="module")
def viscous_shock():
    """``examples/viscous_shock.py`` at its CPU size, ``(16, 4)``, 25
    steps at half the viscous solver's ``cfl_dt``, for μ = 0 and 5e-3: the
    JAX runs and the port's, through ``limited_from_jax``."""
    cells, n_steps, mu_v = 16, 25, 5e-3

    def build(mu):
        f, e, vf, ve = jns.navier_stokes(dim=2, mu=mu)
        kw = {}
        if mu > 0:
            kw = dict(visc_flux_fn=jns.wrap_visc_var_last(vf),
                      visc_eigenvalue_fn=wrap_var_last(ve))
        return JaxSolver(dim=2, order=3, n_vars=4, grid_shape=(cells, 4),
                         flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
                         dx=1.0 / cells, **kw)

    sv = build(mu_v)
    dt = float(sv.cfl_dt(jnp.asarray(shock_tube(sv)))) * 0.5
    runs = {}
    for mu in (0.0, mu_v):
        js = build(mu)
        jl = JaxLimited(js, admissible=jax_admissible(dim=2), fallback_order=2)
        physics = dict(physics="navier_stokes", mu=mu, prandtl=0.7) if mu > 0 else {}
        pl = limited_from_jax(jl, gamma=jeuler.GAMMA, device="cpu", **physics)
        Q = shock_tube(js)
        troubled = float(np.mean(np.asarray(jl.troubled_mask(jnp.asarray(Q),
                                                             js.step(jnp.asarray(Q), dt)))))
        ref = jax.jit(lambda q: jax.lax.scan(lambda c, _: (jl.step(c, dt), None), q, None,
                                             length=n_steps)[0])(jnp.asarray(Q))
        u = pl.run(state_from_numpy(Q, device="cpu"), n_steps, dt)
        runs[mu] = dict(ref=np.asarray(ref), got=u, port=pl, u0=state_from_numpy(Q, device="cpu"),
                        troubled=troubled)
    return runs


def test_viscous_shock_example_matches_jax(viscous_shock):
    for mu, r in viscous_shock.items():
        close(state_to_numpy(r["got"]), r["ref"], f"mu = {mu}")
        assert (r["port"].solver.visc_flux_fn is not None) == (mu > 0)


def test_viscous_shock_example_checks(viscous_shock):
    """The example's own checks (``:108-110``) on the port's runs: drift
    below 1e-12, admissible, the limiter fired, viscosity acted."""
    for r in viscous_shock.values():
        sol = r["port"].solver
        drift = float((sol.total_mass(r["got"]) - sol.total_mass(r["u0"])).abs().max())
        assert drift < 1e-12
        assert bool(euler_admissible(2)(r["got"], sol.var_axis).all())
    assert viscous_shock[0.0]["troubled"] > 0
    a, b = (r["got"] for r in viscous_shock.values())
    assert float((a - b).abs().max()) > 1e-5


def test_viscous_refusals_keep_jax_words():
    """Viscous solvers with Dirichlet walls (ghost gradients unspecified)
    and on the gathered path stay refused, in JAX's words."""
    def held(x, y):
        return np.stack([np.ones_like(x), 0.1 * np.ones_like(x), 0 * x, 2.5 + 0 * x], -1)

    js = jax_ns(2, grid=(4, 4))
    jd = JaxSolver(**{k: getattr(js, k) for k in (
        "dim", "order", "n_vars", "grid_shape", "flux_fn", "max_eigenvalue_fn", "visc_flux_fn",
        "visc_eigenvalue_fn", "dx")}, boundary="dirichlet", dirichlet_fn=jax_make_dirichlet_fn(
            held, dim=2, order=3, grid_shape=(4, 4), dx=0.25))
    with pytest.raises(JaxSemanticError, match="limited viscous solvers with dirichlet walls"):
        JaxLimited(jd)
    flux, eig, visc, visc_eig = ns.navier_stokes(2, mu=MU, prandtl=PRANDTL)
    sol = ADERDGSolver(2, 3, 4, (4, 4), flux, eig, visc_flux_fn=visc,
                       visc_eigenvalue_fn=visc_eig, dx=0.25, device="cpu",
                       boundary="dirichlet", dirichlet_fn=make_dirichlet_fn(
                           held, dim=2, order=3, grid_shape=(4, 4), dx=0.25))
    with pytest.raises(SemanticError,
                       match=r"limited viscous solvers with dirichlet walls are not supported "
                             r"\(ghost gradients at prescribed-state walls are unspecified\)"):
        LimitedADERDG(sol, euler_admissible(2), device="cpu")
    periodic = ADERDGSolver(2, 3, 4, (4, 4), flux, eig, visc_flux_fn=visc,
                            visc_eigenvalue_fn=visc_eig, dx=0.25, device="cpu")
    with pytest.raises(SemanticError, match=r"viscous solvers are not supported on the "
                                            r"gathered \(troubled_capacity\) fallback"):
        LimitedADERDG(periodic, troubled_capacity=2, troubled_granularity="row",
                      device="cpu")
    LimitedADERDG(periodic, fallback_order=2, fallback_slope="central", device="cpu")
