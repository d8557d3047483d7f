"""The second-order (MUSCL) subcell fallback against the JAX package's on
the CPU.

``LimitedADERDG(..., fallback_order=2, fallback_slope=...)``: the whole-grid
subcell step with a MUSCL reconstruction on the subcells and Heun's two
stages, and the limited step around it with its effective face fluxes.
Each case holds the port against the JAX limiter on the same NumPy state
(seeded noise on every node, so every slope limiter takes both branches):
the three slopes in 2-D and 3-D on a periodic grid, and reflective,
outflow, farfield and Dirichlet walls.  f64 at rtol=0, atol=1e-12.

JAX forces every cell onto the fallback with ``troubled_transform``; the
port's ``troubled_mask`` is replaced by one that flags every cell, which is
what that transform does to the JAX step
(``tests/test_torch_limiter_walls.py``'s convention).
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
from exahype_tpu.models.limiter import LimitedADERDG as JaxLimited
from exahype_tpu.models.limiter import euler_admissible as jax_admissible
from exahype_tpu_torch.convert import limited_from_jax, state_from_numpy, state_to_numpy
from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
from exahype_tpu_torch.models.limiter import LimitedADERDG

torch.set_num_threads(1)

ATOL = 1e-12
GRIDS = {2: (6, 4), 3: (4, 2, 4)}
ORDERS = {2: 3, 3: 2}
FF = {2: (1.0, 0.1, 0.0, 2.6), 3: (1.0, 0.1, 0.0, 0.05, 2.6)}


def held(*x):
    """A smooth state for the Dirichlet rows."""
    dim = len(x)
    rho = 1.0 + 0.1 * np.sin(2 * np.pi * x[0])
    vel = [0.2 * np.cos(np.pi * x[-1])] + [0.05 * np.ones_like(x[0])] * (dim - 1)
    e = 2.5 + 0.5 * rho * sum(v * v for v in vel)
    return np.stack([rho] + [rho * v for v in vel] + [e], axis=-1)


def walls_of(name, dim):
    grid = GRIDS[dim]
    return {
        "periodic": {},
        "reflective": dict(boundary="reflective", reflect_fn=jax_euler_reflect(dim),
                           reflect_flux_fn=jax_euler_reflect_flux(dim)),
        "outflow": dict(boundary="outflow", wall_axes=(0,)),
        "farfield": dict(boundary="farfield", farfield_state=FF[dim], wall_axes=(dim - 1,)),
        "dirichlet": dict(boundary="dirichlet", dirichlet_fn=jax_make_dirichlet_fn(
            held, dim=dim, order=ORDERS[dim], grid_shape=grid, dx=1.0 / grid[0])),
    }[name]


def jax_solver(dim, walls="periodic"):
    grid = GRIDS[dim]
    flux, eig = jax_euler_physics(dim=dim, n_real=dim + 2)
    return JaxSolver(dim=dim, order=ORDERS[dim], n_vars=dim + 2, grid_shape=grid,
                     flux_fn=flux, max_eigenvalue_fn=eig, dx=1.0 / grid[0],
                     **walls_of(walls, dim))


def noisy_state(js, seed=0):
    """Random admissible primitive values at every node."""
    rng = np.random.default_rng(seed)
    va = js.var_axis
    shape = js.state_shape[:va] + js.state_shape[va + 1:]
    rho = 1.0 + 0.3 * rng.random(shape)
    vel = [0.3 * rng.standard_normal(shape) for _ in range(js.dim)]
    p = 1.0 + 0.3 * rng.random(shape)
    e = p / 0.4 + 0.5 * rho * sum(v * v for v in vel)
    return np.stack([rho] + [rho * v for v in vel] + [e], axis=va)


def limiters(js, **opts):
    jl = JaxLimited(js, admissible=jax_admissible(js.dim), fallback_order=2, **opts)
    walls = "euler" if js.boundary == "reflective" else None
    pl = limited_from_jax(jl, gamma=1.4, walls=walls, device="cpu")
    return jl, pl


def force_all(pl):
    pl.troubled_mask = lambda u, c: torch.ones(pl.solver.grid_shape, dtype=torch.bool)
    return pl


def close(got, ref, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=ATOL,
                               err_msg=msg)


def check_fallback_and_steps(jl, pl, Q, dt, steps=2):
    """The MUSCL subcell step with its face fluxes, then ``steps`` forced
    limited steps with their effective face fluxes, port against JAX."""
    ref, ref_fl = jax.jit(lambda q: jl.subcell_fv_step(q, dt, return_face_fluxes=True))(
        jnp.asarray(Q))
    got, got_fl = pl.subcell_fv_step(state_from_numpy(Q, device="cpu"), dt,
                                     return_face_fluxes=True)
    close(state_to_numpy(got), ref, "subcell_fv_step")
    for d, (a, b) in enumerate(zip(got_fl, ref_fl)):
        close(state_to_numpy(a), b, f"subcell face fluxes[{d}]")
    force_all(pl)
    step = jax.jit(lambda q: jl.step(q, dt, return_face_fluxes=True,
                                     troubled_transform=jnp.ones_like))
    ref, u = jnp.asarray(Q), state_from_numpy(Q, device="cpu")
    for k in range(steps):
        ref, ref_fl = step(ref)
        u, fl = pl.step(u, dt, return_face_fluxes=True)
        close(state_to_numpy(u), ref, f"step {k + 1}")
        for d, (a, b) in enumerate(zip(fl, ref_fl)):
            close(state_to_numpy(a), b, f"step {k + 1}, face fluxes[{d}]")
    assert np.isfinite(np.asarray(ref)).all()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("slope", ["minmod", "mc", "central"])
def test_muscl_periodic_matches_jax(dim, slope):
    js = jax_solver(dim)
    jl, pl = limiters(js, fallback_slope=slope)
    assert (pl.fallback_order, pl.fallback_slope) == (2, slope)
    Q = noisy_state(js, seed=dim)
    check_fallback_and_steps(jl, pl, Q, 0.4 * float(js.cfl_dt(jnp.asarray(Q))))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("walls", ["reflective", "outflow", "farfield", "dirichlet"])
def test_muscl_walled_matches_jax(dim, walls):
    """Walls: the state's ghost from the hook (or the Dirichlet rows), the
    slope's ghost zero at prescribed-state walls and the mirror (negated)
    or the copy otherwise."""
    js = jax_solver(dim, walls)
    slope = {"reflective": "mc", "outflow": "minmod", "farfield": "central",
             "dirichlet": "minmod"}[walls]
    jl, pl = limiters(js, fallback_slope=slope)
    Q = noisy_state(js, seed=10 + dim)
    check_fallback_and_steps(jl, pl, Q, 0.4 * float(js.cfl_dt(jnp.asarray(Q))))


def test_muscl_unforced_blast_matches_jax():
    """A 2-D blast with the limiter's own detection (no forcing): the
    masks and four steps against JAX, with the guard."""
    js = jax_solver(2, "reflective")
    jl, pl = limiters(js)
    va = js.var_axis
    x, y = (np.squeeze(np.asarray(c), va) for c in js.nodes_meshgrid())
    shape = js.state_shape[:va] + js.state_shape[va + 1:]
    r2 = np.broadcast_to((x - 0.5) ** 2 + (y - 0.5) ** 2, shape)
    p = np.where(r2 < 0.05, 10.0, 0.1)
    z = np.zeros_like(p)
    Q = np.stack([np.ones_like(p), z, z, p / 0.4], axis=va)
    dt = 0.5 * float(js.cfl_dt(jnp.asarray(Q)))
    step = jax.jit(lambda q: jl.step(q, dt))
    ref, u = jnp.asarray(Q), state_from_numpy(Q, device="cpu")
    fired = 0
    for k in range(4):
        cand = js.step(ref, dt)
        mask = np.asarray(jl.troubled_mask(ref, cand))
        got_mask = pl.troubled_mask(u, pl.solver.step(u, dt)).numpy()
        np.testing.assert_array_equal(got_mask, mask, err_msg=f"mask, step {k + 1}")
        fired += int(mask.sum())
        ref, u = step(ref), pl.step(u, dt)
        close(state_to_numpy(u), ref, f"step {k + 1}")
    assert fired > 0


def test_fallback_slope_is_checked():
    flux, eig = euler_physics(2, n_real=4)
    sol = ADERDGSolver(2, 3, 4, (4, 4), flux, eig, device="cpu")
    with pytest.raises(ValueError, match="unknown fallback_slope 'superbee'"):
        LimitedADERDG(sol, fallback_order=2, fallback_slope="superbee", device="cpu")
    with pytest.raises(ValueError, match="troubled_capacity requires fallback='subcell' "
                                         "with fallback_order=1"):
        LimitedADERDG(sol, fallback_order=2, troubled_capacity=4,
                      troubled_granularity="row", device="cpu")
    assert LimitedADERDG(sol, fallback_order=2, device="cpu").fallback_slope == "minmod"
