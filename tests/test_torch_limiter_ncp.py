"""The limiter over source, NCP, dissipation-masked and CK solvers against
the JAX package's on the CPU.

``LimitedADERDG`` carries the solver's non-conservative product, source and
dissipation mask through every fallback: the gathered rows (the sweeps of
``_row_sweep_math``, and with ``subcell_cuda=True`` the sweep wrapper, which
takes that plain version on CPU tensors), the whole-grid first-order subcell
step, the MUSCL stages and the cell-mean ``"means"`` update.  Each case holds
the port against the JAX limiter on the same NumPy state at rtol=0,
atol=1e-12 (f64), and the gathered path against the whole grid as JAX's own
tests do:

- twins of ``tests/test_limiter.py:203-265`` (source, NCP and anisotropic dx
  accepted; the sourced limited run decays) and ``:458-522`` (the MUSCL
  fallback's NCP convergence, at its cells);
- twins of ``tests/test_limiter_gathered.py:373-407`` (the ``"row"`` case;
  ``"cell"`` waits for ROADMAP Queue 1 item 9.5) and ``:646-663`` (against
  JAX's interpret-mode Pallas sweeps);
- a limited step of the CK heterogeneous elasticity (its dissipation mask)
  at the CK tests' small shape.

JAX forces every cell onto the fallback with ``troubled_transform``; the
port's ``troubled_mask`` is replaced by one that flags every cell
(``tests/test_torch_limiter_walls.py``'s convention).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import elastic as jel
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import wrap_var_last
from exahype_tpu.models.limiter import LimitedADERDG as JaxLimited
from exahype_tpu_torch.convert import state_from_numpy, state_to_numpy
from exahype_tpu_torch.models import elastic, subcell_cuda
from exahype_tpu_torch.models.aderdg import ADERDGSolver
from exahype_tpu_torch.models.limiter import LimitedADERDG
from exahype_tpu_torch.utils.errors import LoweringError

torch.set_num_threads(1)

ATOL = 1e-12


def close(got, ref, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol,
                               err_msg=msg)


def force_all(pl):
    pl.troubled_mask = lambda u, c: torch.ones(pl.solver.grid_shape, dtype=torch.bool)
    return pl


def jax_force(t):
    return jnp.ones_like(t)


# ------------------------------------------------------------ the toy physics


def toy(jax_side: bool):
    """``tests/test_limiter_gathered.py:373-395``'s toy: a Burgers-like flux
    per component, the largest |Q| as wave speed, NCP 0.1·ΔQ, source −0.2 Q
    (JAX or port callbacks)."""
    if jax_side:
        def eig(Q, axis, va):
            return jnp.max(jnp.abs(Q), axis=va)
    else:
        def eig(Q, axis, va):
            return torch.amax(torch.abs(Q), dim=va)
    return dict(flux_fn=lambda Q, axis, va: 0.5 * Q * Q, max_eigenvalue_fn=eig,
                ncp_fn=lambda Q, dQ, axis, va: 0.1 * dQ, source_fn=lambda Q, va: -0.2 * Q)


TOY = dict(dim=2, order=2, n_vars=2, grid_shape=(6, 8), dx=(0.2, 0.15),
           dissipation_mask=(1.0, 0.0))


def toy_pair(**kw):
    js = JaxSolver(**TOY, **toy(True))
    ps = ADERDGSolver(**TOY, **toy(False), device="cpu")
    return js, ps, JaxLimited(js, **kw), LimitedADERDG(ps, device="cpu", **kw)


def toy_state(seed=11):
    js = JaxSolver(**TOY, **toy(True))
    return 0.5 + np.random.default_rng(seed).random(js.state_shape)


@pytest.mark.parametrize("granularity", ["row"])
def test_gathered_source_ncp_mask_anisotropic_parity(granularity):
    """The gathered row fallback handles the source, the NCP, the
    dissipation mask and anisotropic dx like the whole-grid fallback (all
    cells troubled, one solver carrying all four), and both match JAX."""
    _, ps, jl_whole, pl_whole = toy_pair()
    _, _, jl_rows, pl_rows = toy_pair(troubled_capacity=6, troubled_granularity=granularity)
    u0 = toy_state()
    dt = 1e-3
    ref_whole = np.asarray(jl_whole.step(jnp.asarray(u0), dt, troubled_transform=jax_force))
    ref_rows = np.asarray(jl_rows.step(jnp.asarray(u0), dt, troubled_transform=jax_force))
    a = state_to_numpy(force_all(pl_whole).step(state_from_numpy(u0, device="cpu"), dt))
    b = state_to_numpy(force_all(pl_rows).step(state_from_numpy(u0, device="cpu"), dt))
    close(b, a, atol=1e-14, msg="gathered rows vs whole grid")
    close(a, ref_whole, msg="whole grid vs JAX")
    close(b, ref_rows, msg="gathered rows vs JAX")


def test_sweep_wrapper_physics_variants_match_pallas_interpret():
    """``subcell_cuda=True`` (the sweep wrapper, its plain version on the
    CPU) against JAX's ``subcell_pallas=True, subcell_interpret=True`` on
    the toy with source, NCP, mask and anisotropic dx
    (``tests/test_limiter_gathered.py:646-663``), and against the port's
    plain sweeps."""
    kw = dict(troubled_capacity=6, troubled_granularity="row")
    js = JaxSolver(**TOY, **toy(True))
    jl = JaxLimited(js, subcell_pallas=True, subcell_interpret=True, **kw)
    ps = ADERDGSolver(**TOY, **toy(False), device="cpu")
    fast = force_all(LimitedADERDG(ps, subcell_cuda=True, device="cpu", **kw))
    base = force_all(LimitedADERDG(ps, device="cpu", **kw))
    u0 = toy_state()
    dt = 1e-3
    ref = np.asarray(jl.step(jnp.asarray(u0), dt, troubled_transform=jax_force))
    before = dict(subcell_cuda.launches)
    a = state_to_numpy(base.step(state_from_numpy(u0, device="cpu"), dt))
    b = state_to_numpy(fast.step(state_from_numpy(u0, device="cpu"), dt))
    assert subcell_cuda.launches == before  # the plain version on CPU tensors
    close(b, a, atol=1e-13)
    close(b, ref, msg="the sweep wrapper vs JAX's Pallas-interpret sweeps")
    # On the card the toy has no kernel: a masked NCP solver is K3 a's.
    with pytest.raises(LoweringError, match="ROADMAP.md, Queue 2 K3 a"):
        subcell_cuda.check_physics(fast)


@pytest.mark.parametrize("fallback", ["subcell", "means"])
def test_whole_grid_fallbacks_match_jax(fallback):
    """The whole-grid first-order subcell and cell-mean fallbacks of the toy
    (source, NCP, mask, anisotropic dx) against JAX, method and step."""
    _, _, jl, pl = toy_pair(fallback=fallback)
    u0 = toy_state(seed=4)
    dt = 1e-3
    u = state_from_numpy(u0, device="cpu")
    close(state_to_numpy(pl.fv_fallback(u, dt)), jl.fv_fallback(jnp.asarray(u0), dt),
          msg="fv_fallback")
    close(state_to_numpy(pl.subcell_fv_step(u, dt)), jl.subcell_fv_step(jnp.asarray(u0), dt),
          msg="subcell_fv_step")
    ref = np.asarray(jl.step(jnp.asarray(u0), dt, troubled_transform=jax_force))
    close(state_to_numpy(force_all(pl).step(u, dt)), ref, msg=f"{fallback} step")


@pytest.mark.parametrize("slope", ["minmod", "central"])
def test_muscl_fallback_with_ncp_source_and_mask_matches_jax(slope):
    """The MUSCL stages' path-conservative NCP (face halves of the
    reconstructed states and the in-cell B(s)·σ), the source and the mask
    against JAX: the subcell step and one forced limited step."""
    _, _, jl, pl = toy_pair(fallback_order=2, fallback_slope=slope)
    u0 = toy_state(seed=6)
    dt = 1e-3
    u = state_from_numpy(u0, device="cpu")
    ref, ref_fl = jl.subcell_fv_step(jnp.asarray(u0), dt, return_face_fluxes=True)
    got, got_fl = pl.subcell_fv_step(u, dt, return_face_fluxes=True)
    close(state_to_numpy(got), ref, msg="subcell_fv_step")
    for d, (a, b) in enumerate(zip(got_fl, ref_fl)):
        close(state_to_numpy(a), b, msg=f"face fluxes[{d}]")
    ref = np.asarray(jl.step(jnp.asarray(u0), dt, troubled_transform=jax_force))
    close(state_to_numpy(force_all(pl).step(u, dt)), ref, msg="step")


# ------------------------------------------------- tests/test_limiter.py twins


def _linear(jax_side):
    if jax_side:
        return (lambda Q, axis, va: Q,
                lambda Q, axis, va: jnp.full(Q.shape[:va] + Q.shape[va + 1:], 1.0, Q.dtype))
    return (lambda Q, axis, va: Q,
            lambda Q, axis, va: torch.ones(Q.shape[:va] + Q.shape[va + 1:], dtype=Q.dtype))


def test_limiter_accepts_source_ncp_anisotropic():
    """Sourced, NCP and anisotropic-dx solvers are all accepted; a
    scalar-equal dx tuple gives the scalar path's bits; each limited step
    matches JAX."""
    base = dict(dim=2, order=2, n_vars=1, grid_shape=(4, 4), dx=0.25)
    jf, je = _linear(True)
    pf, pe = _linear(False)
    rng = np.random.default_rng(2)
    u0 = rng.random(JaxSolver(**base, flux_fn=jf, max_eigenvalue_fn=je).state_shape)
    for extra_j, extra_p in (
            (dict(source_fn=lambda Q, va: -Q), dict(source_fn=lambda Q, va: -Q)),
            (dict(ncp_fn=lambda Q, dQ, axis, va: dQ), dict(ncp_fn=lambda Q, dQ, axis, va: dQ))):
        jl = JaxLimited(JaxSolver(**base, flux_fn=jf, max_eigenvalue_fn=je, **extra_j))
        pl = LimitedADERDG(ADERDGSolver(**base, flux_fn=pf, max_eigenvalue_fn=pe, **extra_p,
                                        device="cpu"), device="cpu")
        close(state_to_numpy(pl.step(state_from_numpy(u0, device="cpu"), 1e-3)),
              jl.step(jnp.asarray(u0), 1e-3), msg=str(sorted(extra_p)))
    lim_t = LimitedADERDG(ADERDGSolver(**{**base, "dx": (0.25, 0.25)}, flux_fn=pf,
                                       max_eigenvalue_fn=pe, device="cpu"), device="cpu")
    lim_s = LimitedADERDG(ADERDGSolver(**base, flux_fn=pf, max_eigenvalue_fn=pe, device="cpu"),
                          device="cpu")
    u = state_from_numpy(u0, device="cpu")
    assert torch.equal(lim_t.step(u, 1e-3), lim_s.step(u, 1e-3))


def test_limited_solver_with_source_decays():
    """The limited step applies the source in both branches: a decay source
    shrinks a square pulse that trips the detector; 40 steps, and the state
    against JAX's after them."""
    k = 3.0

    def jflux(Q, axis, va):
        return (1.0 if axis == 0 else 0.5) * Q

    grid = dict(dim=2, order=2, n_vars=1, grid_shape=(8, 8), dx=1.0 / 8)
    js = JaxSolver(**grid, flux_fn=jflux, max_eigenvalue_fn=_linear(True)[1],
                   source_fn=lambda Q, va: -k * Q)
    ps = ADERDGSolver(**grid, flux_fn=jflux, max_eigenvalue_fn=_linear(False)[1],
                      source_fn=lambda Q, va: -k * Q, device="cpu")
    jl, pl = JaxLimited(solver=js), LimitedADERDG(ps, device="cpu")
    x = np.asarray(js.nodes_meshgrid()[0])
    u0 = np.ascontiguousarray(np.broadcast_to(np.where((x > 0.3) & (x < 0.6), 1.0, 0.1),
                                              js.state_shape))
    n, dt = 40, 2e-3
    u = state_from_numpy(u0, device="cpu")
    assert bool(pl.troubled_mask(u, ps.step(u, dt)).any())
    out = state_to_numpy(pl.run(u, n, dt))
    assert np.isfinite(out).all()
    expected = np.exp(-k * n * dt)
    assert np.max(out) < 1.5 * expected + 0.05
    assert np.max(out) > 0.2 * expected
    close(out, jax.jit(lambda q: jl.run(q, n, dt))(jnp.asarray(u0)), msg="40 steps")


def test_subcell_fallback_second_order_ncp_convergence():
    """A smooth pure-NCP problem (advection written as B·∇q) under forced
    limiting with the MUSCL and the first-order fallbacks, at the cells of
    ``tests/test_limiter.py:458-522``: every run's state matches JAX's
    after its steps, and the errors fall with the cells.

    The JAX test's own bars (a rate above 1.9 with the central slope, the
    MUSCL error under half the first-order one) fail in the JAX package
    itself (it is in the slow tier; rate 0.98 and 0.95, errors 0.1805 →
    0.0918 central, 0.1892 → 0.0977 minmod, 0.0979 first order at 16
    cells), and the port gives the same numbers to 1e-12.  So this twin
    holds the port to JAX and to what the reference shows: first-order
    convergence, the MUSCL error under the first-order one (ROADMAP.md,
    Queue 3)."""
    a = 1.0

    def run(cells, order_fb, slope, check_jax=False):
        common = dict(dim=2, order=2, n_vars=2, grid_shape=(cells, 2), dx=(1.0 / cells, 0.5))
        ps = ADERDGSolver(
            **common, flux_fn=lambda Q, axis, va: torch.zeros_like(Q),
            max_eigenvalue_fn=lambda Q, axis, va: torch.full(
                Q.shape[:va] + Q.shape[va + 1:], a, dtype=Q.dtype),
            ncp_fn=lambda Q, g, axis, va: a * g if axis == 0 else torch.zeros_like(g),
            device="cpu")
        never = lambda Q, va: torch.zeros(Q.shape[:va] + Q.shape[va + 1:], dtype=torch.bool)
        pl = LimitedADERDG(ps, admissible=never, fallback_order=order_fb,
                           fallback_slope=slope, device="cpu")
        js = JaxSolver(**common, flux_fn=lambda Q, axis, va: jnp.zeros_like(Q),
                       max_eigenvalue_fn=lambda Q, axis, va: jnp.full(
                           Q.shape[:va] + Q.shape[va + 1:], a, Q.dtype),
                       ncp_fn=lambda Q, g, axis, va: a * g if axis == 0 else jnp.zeros_like(g))
        x = np.asarray(js.nodes_meshgrid()[0])
        q0 = 2.0 + np.sin(2 * np.pi * x)
        u0 = np.ascontiguousarray(
            np.broadcast_to(q0, js.state_shape[:2] + (1,) + js.state_shape[3:])
            * np.ones((1, 1, 2, 1, 1)))
        steps, dt = cells, 0.3 / (cells * pl.n_sub)
        u = state_from_numpy(u0, device="cpu")
        for _ in range(steps):
            assert bool(pl.troubled_mask(u, ps.step(u, dt)).all())
            u = pl.step(u, dt)
        if check_jax:
            jl = JaxLimited(js, admissible=lambda Q, va: jnp.zeros(
                Q.shape[:va] + Q.shape[va + 1:], bool), fallback_order=order_fb,
                fallback_slope=slope)
            ref = jax.jit(lambda q: jl.run(q, steps, dt))(jnp.asarray(u0))
            close(state_to_numpy(u), ref, msg=f"{cells} cells, order {order_fb}, {slope}")
        exact = 2.0 + np.sin(2 * np.pi * (x - a * steps * dt))
        q = state_to_numpy(u)[:, :, 0]
        err = q - np.broadcast_to(np.squeeze(exact, axis=2), q.shape)
        return float(np.sqrt(np.mean(err**2)))

    e2_c = run(8, 2, "central", check_jax=True)
    e2_f = run(16, 2, "central", check_jax=True)
    e1_f = run(16, 1, "minmod", check_jax=True)
    e2m_c = run(8, 2, "minmod", check_jax=True)
    e2m_f = run(16, 2, "minmod", check_jax=True)
    for coarse, fine, what in ((e2_c, e2_f, "central"), (e2m_c, e2m_f, "minmod")):
        rate = np.log2(coarse / fine)
        assert rate > 0.9, f"MUSCL ({what}) rate {rate:.2f} ({coarse}, {fine})"
    assert e2_f < e1_f and e2m_f < e1_f, (e2_f, e2m_f, e1_f)


# --------------------------------------------------------------------- CK


CK = dict(predictor_mode="ck", ck_material_slots=(9, 10, 11),
          dissipation_mask=(1,) * 9 + (0, 0, 0))
CK_GRID = (4, 4, 4)  # tests/test_torch_ck.py's small shape


def ck_state(js, seed=0):
    """``tests/test_torch_ck.py::random_state``: a wave of ~1e-3 in every
    evolved row, materials constant in each cell and random across cells."""
    rng = np.random.default_rng(seed)
    va = js.var_axis
    no_var = js.state_shape[:va] + js.state_shape[va + 1:]
    grid = js.grid_shape
    rows = [1e-3 * rng.standard_normal(no_var) for _ in range(9)]
    rows += [np.broadcast_to(m, no_var) for m in (
        0.8 + 0.8 * rng.random(grid), 1.0 + 2.0 * rng.random(grid),
        1.0 + 2.0 * rng.random(grid))]
    return np.stack(rows, axis=va)


@pytest.mark.parametrize("capacity", [None, 16])
def test_limited_ck_elasticity_step_matches_jax(capacity):
    """One limited step of the CK heterogeneous elasticity (dissipation
    mask on the material rows) at ``(4, 4, 4)`` p2, every cell forced onto
    the fallback, whole grid and gathered rows, against JAX; and the sweep
    kernel's refusal for it on the card (ROADMAP Queue 2 K3 a)."""
    flux, eig = jel.elastic3d_heterogeneous()
    js = JaxSolver(dim=3, order=2, n_vars=12, grid_shape=CK_GRID,
                   flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
                   dx=1.0 / CK_GRID[0], **CK)
    pflux, peig = elastic.elastic3d_heterogeneous()
    ps = ADERDGSolver(3, 2, 12, CK_GRID, pflux, peig, dx=1.0 / CK_GRID[0], device="cpu", **CK)
    kw = {} if capacity is None else dict(troubled_capacity=capacity,
                                          troubled_granularity="row")
    jl, pl = JaxLimited(js, **kw), force_all(LimitedADERDG(ps, device="cpu", **kw))
    u0 = ck_state(js)
    dt = 1e-3
    ref, ref_fl = jl.step(jnp.asarray(u0), dt, return_face_fluxes=True,
                          troubled_transform=jax_force)
    got, got_fl = pl.step(state_from_numpy(u0, device="cpu"), dt, return_face_fluxes=True)
    close(state_to_numpy(got), ref, msg="state")
    for d, (a, b) in enumerate(zip(got_fl, ref_fl)):
        close(state_to_numpy(a), b, msg=f"effective face fluxes[{d}]")
    if capacity is not None:
        with pytest.raises(LoweringError, match="ROADMAP.md, Queue 2 K3 a"):
            subcell_cuda.check_physics(LimitedADERDG(ps, subcell_cuda=True, device="cpu", **kw))
