"""The limiter with domain walls, and its whole-grid fallbacks, against the
JAX package's on the CPU.

The cases are ``tests/test_limiter_walls.py``'s, as far as the port takes
them (the first-order fallback; the gathered path by rows), each held
against the JAX limiter on the same NumPy inputs: 2-D order 2 Euler on an
8 x 8 (or 12 x 12) grid with outflow, farfield, Dirichlet and reflective
walls, on every axis or on ``wall_axes``.  Then each wall helper against its
JAX original, and a 3-D gathered reflective case at ``(8, 4, 8)``.  f64
at rtol=0, atol=1e-12; masks and tables exactly equal.  The flagship
configuration, ``examples/limited_blast_walls.py``, is
``tests/test_torch_limited_blast_walls.py``'s.

JAX forces every cell onto the fallback with ``troubled_transform``, which
the port does not carry (ROADMAP Queue 1 item 11): here the port's
``troubled_mask`` is replaced by one that flags every cell, which is what
that transform does to the JAX step.
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
from exahype_tpu.utils.errors import SemanticError as JaxSemanticError
from exahype_tpu_torch.convert import limited_from_jax, state_from_numpy, state_to_numpy
from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible
from exahype_tpu_torch.utils.errors import SemanticError

torch.set_num_threads(1)

ATOL = 1e-12
FF = (1.0, 0.1, 0.0, 2.6)  # rho, mx, my, E: tests/test_limiter_walls.py:76


def jax_solver(cells=8, order=2, dim=2, grid=None, **kw):
    """tests/test_limiter_walls.py:41's solver (reflective walls get the
    Euler mirror)."""
    flux, eig = jax_euler_physics(dim=dim, n_real=dim + 2)
    if kw.get("boundary") == "reflective":
        kw.update(reflect_fn=jax_euler_reflect(dim), reflect_flux_fn=jax_euler_reflect_flux(dim))
    grid = grid or (cells,) * dim
    return JaxSolver(dim=dim, order=order, n_vars=dim + 2, grid_shape=grid, flux_fn=flux,
                     max_eigenvalue_fn=eig, dx=1.0 / grid[0], **kw)


def limiters(js, **opts):
    """The JAX limiter over ``js`` and the port's, from it."""
    jl = JaxLimited(js, admissible=jax_admissible(js.dim), **opts)
    walls = "euler" if js.boundary == "reflective" else None
    return jl, limited_from_jax(jl, gamma=1.4, walls=walls, device="cpu")


def force_all(pl):
    """Flag every cell on the port's limiter (JAX's ``troubled_transform=
    lambda t: jnp.ones_like(t)``)."""
    pl.troubled_mask = lambda u, c: torch.ones(pl.solver.grid_shape, dtype=torch.bool)
    return pl


def ones(t):
    return jnp.ones_like(t)


def centered_blast(js, strong=True):
    """tests/test_limiter_walls.py:49: a pressure disc at the centre."""
    coords = js.nodes_meshgrid()
    va = js.var_axis
    no_var = js.state_shape[:va] + js.state_shape[va + 1:]
    x = np.broadcast_to(np.squeeze(np.asarray(coords[0]), va), no_var)
    y = np.broadcast_to(np.squeeze(np.asarray(coords[1]), va), no_var)
    r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2
    p = np.where(r2 < 0.01, 10.0 if strong else 1.5, 0.1)
    zeros = np.zeros_like(p)
    return np.stack([np.ones_like(p), zeros, zeros, p / 0.4], axis=va)


def uniform_state(js, vals):
    va = js.var_axis
    no_var = js.state_shape[:va] + js.state_shape[va + 1:]
    return np.stack([np.full(no_var, v) for v in vals], axis=va)


def run_both(jl, pl, Q, dt, n, forced=False):
    """``n`` steps of each limiter from ``Q``; the states after each step,
    JAX's and the port's, as NumPy."""
    ref, u = jnp.asarray(Q), state_from_numpy(Q, device="cpu")
    if forced:
        force_all(pl)
    step = jax.jit(lambda q: jl.step(q, dt, troubled_transform=ones if forced else None))
    out = []
    for _ in range(n):
        ref = step(ref)
        u = pl.step(u, dt)
        out.append((np.asarray(ref), state_to_numpy(u)))
    return out


def close(got, ref, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol, err_msg=msg)


def dirichlet_fn(value_fn, cells=8, order=2):
    return jax_make_dirichlet_fn(value_fn, dim=2, order=order, grid_shape=(cells, cells),
                                 dx=1.0 / cells)


def held_state(rho, mx, my, e):
    return lambda x, y: np.stack([rho * np.ones_like(x), mx * np.ones_like(x),
                                  my * np.ones_like(x), e * np.ones_like(x)], axis=-1)


# ------------------------------------------------------------------ outflow


def test_outflow_compact_parity():
    """tests/test_limiter_walls.py:83 at the first order: forced fallback
    with outflow walls on x, against JAX and (bitwise in JAX) against the
    periodic run while the blast is compact."""
    jl, pl = limiters(jax_solver(boundary="outflow", wall_axes=(0,)))
    jp, pp = limiters(jax_solver())
    Q = centered_blast(jl.solver)
    walled = run_both(jl, pl, Q, 1e-3, 3, forced=True)
    periodic = run_both(jp, pp, Q, 1e-3, 3, forced=True)
    for k, ((ref, got), (_, got_p)) in enumerate(zip(walled, periodic)):
        close(got, ref, msg=f"step {k + 1}")
        close(got, got_p, atol=1e-13, msg=f"walled vs periodic, step {k + 1}")


def test_outflow_blast():
    """tests/test_limiter_walls.py:105's configuration (12 x 12, order 3,
    outflow box, whole grid), its first 5 steps against JAX with the masks
    equal at each."""
    jl, pl = limiters(jax_solver(cells=12, order=3, boundary="outflow"))
    js, ps = jl.solver, pl.solver
    Q = centered_blast(js)
    ref, u = jnp.asarray(Q), state_from_numpy(Q, device="cpu")
    mask_of = jax.jit(lambda q: jl.troubled_mask(q, js.step(q, 5e-4)))
    step = jax.jit(lambda q: jl.step(q, 5e-4))
    for k in range(5):
        mask_ref = np.asarray(mask_of(ref))
        mask = pl.troubled_mask(u, ps.step(u, 5e-4)).numpy()
        np.testing.assert_array_equal(mask, mask_ref, err_msg=f"step {k + 1}")
        assert mask.any()
        ref, u = step(ref), pl.step(u, 5e-4)
        close(state_to_numpy(u), ref, msg=f"step {k + 1}")


@pytest.mark.parametrize("boundary", ["outflow", "farfield"])
def test_gathered_all_troubled_matches_whole_grid(boundary):
    """tests/test_limiter_walls.py:130 and :213 on the row path: every cell
    forced, the gathered step (every row gathered) equals the whole-grid
    step, and each equals JAX's."""
    kw = dict(boundary=boundary, farfield_state=FF if boundary == "farfield" else None)
    js = jax_solver(**kw)
    jw, pw = limiters(js)
    jg, pg = limiters(js, troubled_capacity=8, troubled_granularity="row")
    Q = centered_blast(js)
    (ref_w, got_w), = run_both(jw, pw, Q, 1e-3, 1, forced=True)
    (ref_g, got_g), = run_both(jg, pg, Q, 1e-3, 1, forced=True)
    close(got_w, ref_w)
    close(got_g, ref_g)
    close(got_g, got_w, atol=1e-13)


# ----------------------------------------------------------------- farfield


@pytest.mark.parametrize("fallback", ["subcell", "means"])
def test_farfield_free_stream_preserved(fallback):
    """tests/test_limiter_walls.py:168 (first order): the farfield state
    is steady through the forced fallback, as in JAX."""
    jl, pl = limiters(jax_solver(boundary="farfield", farfield_state=FF), fallback=fallback)
    Q = uniform_state(jl.solver, FF)
    (ref, got), = run_both(jl, pl, Q, 1e-3, 1, forced=True)
    close(got, ref)
    close(got, Q)


def test_farfield_no_false_flags_and_inflow_feeds():
    """tests/test_limiter_walls.py:187: no cell of the free stream is
    flagged; a lower-energy interior takes energy from the farfield (10
    steps, each against JAX)."""
    jl, pl = limiters(jax_solver(boundary="farfield", farfield_state=FF))
    u = state_from_numpy(uniform_state(jl.solver, FF), device="cpu")
    assert not pl.troubled_mask(u, pl.solver.step(u, 1e-3)).any()
    Q = uniform_state(jl.solver, (1.0, 0.1, 0.0, 2.0))
    states = run_both(jl, pl, Q, 1e-3, 10)
    for k, (ref, got) in enumerate(states):
        close(got, ref, msg=f"step {k + 1}")
    e0 = float(pl.solver.total_mass(torch.from_numpy(Q))[3])
    e1 = float(pl.solver.total_mass(torch.from_numpy(states[-1][1]))[3])
    assert e1 > e0


# ---------------------------------------------------------------- Dirichlet


def test_dirichlet_constant_steady():
    """tests/test_limiter_walls.py:229 (first order): rows holding the
    interior's constant are steady through the forced whole-grid subcell
    fallback."""
    jl, pl = limiters(jax_solver(boundary="dirichlet", dirichlet_fn=dirichlet_fn(
        held_state(*FF))))
    Q = uniform_state(jl.solver, FF)
    (ref, got), = run_both(jl, pl, Q, 1e-3, 1, forced=True)
    close(got, ref)
    close(got, Q)


@pytest.mark.parametrize("fallback", ["subcell", "means"])
def test_dirichlet_blast(fallback):
    """tests/test_limiter_walls.py:255's blast in a box of held rows (12 x
    12), 5 steps of each whole-grid fallback against JAX; admissible."""
    jl, pl = limiters(jax_solver(cells=12, boundary="dirichlet", dirichlet_fn=dirichlet_fn(
        held_state(1.0, 0.0, 0.0, 0.25), cells=12)), fallback=fallback)
    states = run_both(jl, pl, centered_blast(jl.solver), 5e-4, 5)
    for k, (ref, got) in enumerate(states):
        close(got, ref, msg=f"step {k + 1}")
    assert bool(euler_admissible(2)(torch.from_numpy(states[-1][1]), 2).all())
    # The state a step returns is contiguous, as the CUDA kernels take it.
    u = state_from_numpy(states[-1][1], device="cpu")
    assert pl.step(u, 5e-4).is_contiguous()
    assert pl._admissibility_scale(u.flip(0)).is_contiguous()


# ---------------------------------------------------------------- wall_axes


@pytest.mark.parametrize("boundary", ["reflective", "outflow"])
def test_wall_axes_periodic_axis_exact(boundary):
    """tests/test_limiter_walls.py:294: with walls on x only, the run of a
    state rolled by half the domain along y is the rolled run (axis 1 stays
    periodic), and both match JAX."""
    jl, pl = limiters(jax_solver(boundary=boundary, wall_axes=(0,)))
    Q = centered_blast(jl.solver)
    ga = jl.solver.grid_axis(1)
    rolled = np.roll(Q, 4, axis=ga)
    a = run_both(jl, pl, Q, 1e-3, 3, forced=True)
    b = run_both(jl, pl, rolled, 1e-3, 3, forced=True)
    for k, ((ref_a, got_a), (ref_b, got_b)) in enumerate(zip(a, b)):
        close(got_a, ref_a, msg=f"step {k + 1}")
        close(got_b, ref_b, msg=f"step {k + 1}")
        close(np.roll(got_a, 4, axis=ga), got_b, atol=1e-13)


def test_wall_axes_reflective_conserves_transverse_momentum():
    """tests/test_limiter_walls.py:318: slip walls on x only; mass, energy
    and the y-momentum conserved through the forced fallback, the
    x-momentum pushed, every step against JAX."""
    jl, pl = limiters(jax_solver(boundary="reflective", wall_axes=(0,)))
    rng = np.random.default_rng(7)
    js = jl.solver
    va = js.var_axis
    no_var = js.state_shape[:va] + js.state_shape[va + 1:]
    rho = 1.0 + 0.1 * rng.random(no_var)
    Q = np.stack([rho, 0.3 * rho, 0.1 * rho, 5.0 + 0.5 * rho], axis=va)
    states = run_both(jl, pl, Q, 5e-4, 3, forced=True)
    for k, (ref, got) in enumerate(states):
        close(got, ref, msg=f"step {k + 1}")
    m0 = pl.solver.total_mass(torch.from_numpy(Q)).numpy()
    m1 = pl.solver.total_mass(torch.from_numpy(states[-1][1])).numpy()
    np.testing.assert_allclose(m1[[0, 3]], m0[[0, 3]], rtol=1e-12)
    np.testing.assert_allclose(m1[2], m0[2], rtol=1e-10)
    assert abs(m1[1] - m0[1]) > 1e-9


# ------------------------------------------------------------- the helpers

HELPER_CASES = {
    "reflective": dict(boundary="reflective"),
    "outflow (0,)": dict(boundary="outflow", wall_axes=(0,)),
    "farfield": dict(boundary="farfield", farfield_state=FF),
    "dirichlet (1,)": dict(boundary="dirichlet", wall_axes=(1,)),
}


@pytest.fixture(scope="module", params=sorted(HELPER_CASES))
def helper_case(request):
    kw = dict(HELPER_CASES[request.param])
    if kw["boundary"] == "dirichlet":
        kw["dirichlet_fn"] = jax_make_dirichlet_fn(
            lambda x, y: np.stack([1.0 + 0.1 * np.sin(6 * x + 2 * y), 0.2 + 0 * x, 0.1 * y,
                                   2.5 + 0.2 * np.cos(5 * y)], axis=-1),
            dim=2, order=2, grid_shape=(8, 8), dx=1.0 / 8, wall_axes=(1,))
    jl, pl = limiters(jax_solver(**kw), troubled_capacity=8, troubled_granularity="row") \
        if kw["boundary"] != "dirichlet" else limiters(jax_solver(**kw))
    rng = np.random.default_rng(3)
    Q = centered_blast(jl.solver) * (1.0 + 0.05 * rng.random(jl.solver.state_shape))
    return {"name": request.param, "jl": jl, "pl": pl, "Q": Q}


def test_shift_helpers_match_jax(helper_case):
    """``_shift_clamp`` and ``_shift_reflect`` on the cell means, and
    ``_ghost_mean`` at each wall."""
    jl, pl, Q = helper_case["jl"], helper_case["pl"], helper_case["Q"]
    means_ref = jl.cell_means(jnp.asarray(Q))
    means = pl.cell_means(torch.from_numpy(Q))
    close(means, means_ref)
    for d in range(2):
        for sh in (-1, 1):
            close(pl._shift_clamp(means, sh, 1 + d, d), jl._shift_clamp(means_ref, sh, 1 + d, d))
            close(pl._shift_reflect(means, sh, 1 + d, d),
                  jl._shift_reflect(means_ref, sh, 1 + d, d, 0))
        if pl._wall_on(d):
            for side, pos in ((0, 0), (1, -1)):
                close(pl._ghost_mean(pl._row(means, pos, 1 + d), d, side),
                      jl._ghost_mean(jl._row(means_ref, pos, 1 + d), d, side))


def test_ghost_sub_and_subcell_step_match_jax(helper_case):
    """``_ghost_sub`` at each wall, and the whole-grid ``subcell_fv_step``
    with its face fluxes."""
    jl, pl, Q = helper_case["jl"], helper_case["pl"], helper_case["Q"]
    s_ref = jl.project_subcells(jnp.asarray(Q))
    s = pl.project_subcells(torch.from_numpy(Q))
    close(s, s_ref)
    va = pl.solver.var_axis
    for d in range(2):
        if not pl._wall_on(d):
            continue
        ga = pl.solver.grid_axis(d)
        for side, pos, sub in ((0, 0, 0), (1, -1, pl.n_sub - 1)):
            layer, layer_ref = s.narrow(d, sub, 1), s_ref[(slice(None),) * d + (slice(sub, sub + 1),)]
            close(pl._ghost_sub(pl._row(layer, pos, ga), d, side, va),
                  jl._ghost_sub(jl._row(layer_ref, pos, ga), d, side, va))
    recon_ref, fl_ref = jl.subcell_fv_step(jnp.asarray(Q), 1e-3, return_face_fluxes=True)
    recon, fl = pl.subcell_fv_step(torch.from_numpy(Q), 1e-3, return_face_fluxes=True)
    close(recon, recon_ref)
    for d in range(2):
        close(fl[d], fl_ref[d], msg=f"face fluxes d={d}")


def test_fv_fallback_and_troubled_mask_match_jax(helper_case):
    """``fv_fallback`` with wall ghosts, and the wall-clamped detection."""
    jl, pl, Q = helper_case["jl"], helper_case["pl"], helper_case["Q"]
    close(pl.fv_fallback(torch.from_numpy(Q), 1e-3), jl.fv_fallback(jnp.asarray(Q), 1e-3))
    cand = jl.solver.step(jnp.asarray(Q), 1e-3)
    np.testing.assert_array_equal(
        pl.troubled_mask(torch.from_numpy(Q), torch.from_numpy(np.asarray(cand))).numpy(),
        np.asarray(jl.troubled_mask(jnp.asarray(Q), cand)))


def test_matching_at_wall_rows_matches_jax(helper_case):
    """``_match_interface_fluxes`` with troubled cells on the wall rows
    (the wall faces are never mixed), and the effective face fluxes of a
    whole-grid step."""
    jl, pl, Q = helper_case["jl"], helper_case["pl"], helper_case["Q"]
    cand, dg = jl.solver.step(jnp.asarray(Q), 1e-3, return_face_fluxes=True)
    _, fv = jl.subcell_fv_step(jnp.asarray(Q), 1e-3, return_face_fluxes=True)
    troubled = np.zeros(jl.solver.grid_shape, bool)
    troubled[0, 2] = troubled[-1, 5] = troubled[3, 0] = troubled[6, -1] = troubled[4, 4] = True
    ref = jl._match_interface_fluxes(cand, dg, fv, jnp.asarray(troubled), 1e-3)
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    got = pl._match_interface_fluxes(t(cand), [t(f) for f in dg], [t(f) for f in fv],
                                     t(troubled), 1e-3)
    close(got, ref)
    if helper_case["name"] != "dirichlet (1,)":
        return
    ref, eff_ref = jl.step(jnp.asarray(Q), 1e-3, return_face_fluxes=True)
    got, eff = pl.step(torch.from_numpy(Q), 1e-3, return_face_fluxes=True)
    close(got, ref)
    for d in range(2):
        close(eff[d], eff_ref[d], msg=f"effective fluxes d={d}")


def test_gather_tables_wall_flags_match_jax(helper_case):
    """The row tables' wall flags and the gathered step (2-D: axis 0 is
    the table direction, axis 1 the in-row one), at a mask that flags rows
    on both walls."""
    jl, pl, Q = helper_case["jl"], helper_case["pl"], helper_case["Q"]
    if helper_case["name"] == "dirichlet (1,)":
        # The gathered path refuses Dirichlet walls, with JAX's message.
        for make, sol, error in ((JaxLimited, jl.solver, JaxSemanticError),
                                 (LimitedADERDG, pl.solver, SemanticError)):
            with pytest.raises(error, match="does not support dirichlet walls"):
                make(sol, troubled_capacity=8, troubled_granularity="row")
        return
    troubled = np.zeros(jl.solver.grid_shape, bool)
    troubled[0, 3] = troubled[-1, -1] = troubled[4, 0] = True
    ref = jl._gather_tables_row(jnp.asarray(troubled))
    got = pl._gather_tables_row(torch.from_numpy(troubled))
    for key in ("row", "active", "nb_slot", "nb_row", "wall", "mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert got["wall"].any() == pl._wall_on(0)
    R_ref, g_ref = jl._gathered_subcell_step_row(jnp.asarray(Q), 1e-3, ref)
    R, g = pl._gathered_subcell_step_row(torch.from_numpy(Q), 1e-3, got)
    n = int(got["n_active"])
    close(R[..., :n, :], np.asarray(R_ref)[..., :n, :])
    for d in range(2):
        for k in range(2):
            close(g[d][k][:, :n], np.asarray(g_ref[d][k])[:, :n], msg=f"g d={d} {k}")
    fv_ref = jl._scatter_face_fluxes_row(g_ref, ref, jnp.float64)
    fv = pl._scatter_face_fluxes_row(g, got, torch.float64)
    for d in range(2):
        close(fv[d], fv_ref[d], msg=f"scattered fluxes d={d}")


# ---------------------------------------------------------------- 3-D rows


def test_gathered_reflective_3d():
    """A 3-D gathered reflective box at ``(8, 4, 8)``, capacity 8 rows: a
    Sod shock along axis 0 with a flow into the high wall, 3 steps against
    JAX with the face fluxes, the masks equal and wall rows troubled."""
    js = jax_solver(order=3, dim=3, grid=(8, 4, 8), boundary="reflective")
    jl, pl = limiters(js, troubled_capacity=8, troubled_granularity="row", dmp_delta0=5e-4)
    va = js.var_axis
    no_var = js.state_shape[:va] + js.state_shape[va + 1:]
    x = np.broadcast_to((np.arange(8) / 8).reshape(8, 1, 1), js.grid_shape)
    rho = np.broadcast_to(np.where(x < 0.5, 1.0, 0.125), no_var)
    p = np.broadcast_to(np.where(x < 0.5, 1.0, 0.1), no_var)
    Q = np.stack([rho, 0.5 * rho, 0 * rho, 0 * rho, p / 0.4 + 0.125 * rho], axis=va)
    ref, u = jnp.asarray(Q), state_from_numpy(Q, device="cpu")
    mask_of = jax.jit(lambda q: jl.troubled_mask(q, js.step(q, 4.8e-3)))
    step = jax.jit(lambda q: jl.step(q, 4.8e-3, return_face_fluxes=True))
    walls = 0
    for k in range(3):
        mask_ref = np.asarray(mask_of(ref))
        mask = pl.troubled_mask(u, pl.solver.step(u, 4.8e-3)).numpy()
        np.testing.assert_array_equal(mask, mask_ref, err_msg=f"step {k + 1}")
        walls += int(mask[0].any() or mask[-1].any() or mask[:, 0].any() or mask[:, -1].any())
        ref, eff_ref = step(ref)
        u, eff = pl.step(u, 4.8e-3, return_face_fluxes=True)
        close(state_to_numpy(u), ref, msg=f"step {k + 1}")
        for d in range(3):
            close(eff[d], eff_ref[d], msg=f"step {k + 1} d={d}")
    assert walls > 0
