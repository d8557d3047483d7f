"""The port's limiter methods against the JAX package's, on the CPU.

The configuration is ``bench.py::bench_limited``'s at a cut grid: order 3,
3-D Euler, the Sod shock along axis 0, capacity 8 rows of the last axis,
``dmp_delta0=5e-4``, dx = 1/8 and dt = 4.8e-3 (the bench's dt scaled by
dx).  Each method gets the same NumPy inputs on both sides — the JAX
candidate step and its face fluxes where it needs them — so a difference
points at that method.  f64 at rtol=0, atol=1e-12; masks and index tables
exactly equal.

The sweep kernel itself is held against ``_row_sweep_math`` on the card in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import euler_physics as jax_euler_physics
from exahype_tpu.models.dg import subcell_projection as jax_projection
from exahype_tpu.models.dg import subcell_reconstruction as jax_reconstruction
from exahype_tpu.models.limiter import LimitedADERDG as JaxLimited
from exahype_tpu.models.limiter import euler_admissible as jax_admissible
from exahype_tpu_torch.convert import aderdg_from_jax, limited_from_jax
from exahype_tpu_torch.models import subcell_cuda
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.dg import subcell_projection, subcell_reconstruction
from exahype_tpu_torch.models.limiter import euler_admissible

torch.set_num_threads(1)

GRID = (8, 2, 16)
DT = 4.8e-3
ATOL = 1e-12


def sod_state(js):
    """``bench.py:348-356``: the Sod shock along axis 0."""
    grid = js.grid_shape
    x = np.arange(grid[0]).reshape(-1, 1, 1) / grid[0]
    left = np.broadcast_to(x < 0.5, grid)
    va = js.var_axis
    no_var = js.state_shape[:va] + js.state_shape[va + 1:]
    rho = np.broadcast_to(np.where(left, 1.0, 0.125), no_var)
    p = np.broadcast_to(np.where(left, 1.0, 0.1), no_var)
    zeros = np.zeros(no_var)
    return np.stack([rho, zeros, zeros, zeros, p / 0.4], axis=va)


@pytest.fixture(scope="module")
def case():
    flux, eig = jax_euler_physics(dim=3, n_real=5)
    js = JaxSolver(dim=3, order=3, n_vars=5, grid_shape=GRID, flux_fn=flux,
                   max_eigenvalue_fn=eig, dx=1.0 / GRID[0])
    jl = JaxLimited(js, admissible=jax_admissible(3, gamma=1.4), troubled_capacity=8,
                    troubled_granularity="row", dmp_delta0=5e-4)
    pl = limited_from_jax(jl, gamma=1.4, device="cpu")
    Q = sod_state(js)
    cand, fluxes = js.step(jnp.asarray(Q), DT, return_face_fluxes=True)
    return {
        "js": js, "jl": jl, "pl": pl, "Q": Q,
        "cand": np.asarray(cand), "fluxes": [np.asarray(f) for f in fluxes],
        "mask": np.asarray(jl.troubled_mask(jnp.asarray(Q), cand)),
    }


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol)


def test_subcell_operators_match_jax():
    for basis in ("legendre", "lobatto"):
        np.testing.assert_array_equal(subcell_projection(3, 7, basis),
                                      jax_projection(3, 7, basis))
        np.testing.assert_array_equal(subcell_reconstruction(3, 7, basis),
                                      jax_reconstruction(3, 7, basis))


@pytest.mark.parametrize("stepper", ["solver", "cuda_wrapper"])
def test_step_face_fluxes_match_jax(case, stepper):
    """``step(return_face_fluxes=True)`` on the CPU (the wrapper takes the
    plain path there) against the JAX ``step``; the default step is the
    same state."""
    sol = aderdg_from_jax(case["js"], gamma=1.4, device="cpu")
    st = sol if stepper == "solver" else CudaADERDG(sol)
    u = t(case["Q"])
    new, fluxes = st.step(u, DT, return_face_fluxes=True)
    close(new, case["cand"])
    assert len(fluxes) == 3
    for got, ref in zip(fluxes, case["fluxes"]):
        assert tuple(got.shape) == ref.shape == sol.face_flux_shape
        close(got, ref)
    assert torch.equal(st.step(u, DT), new)


def test_euler_admissible_matches_jax(case):
    Q = case["cand"].copy()
    Q[1, 2, 0, 0, 3, 1, 5] = -0.1  # negative density at one node
    Q[0, 0, 0, 4, 6, 0, 2] = 1e-6  # negative pressure at another
    Q[2, 1, 3, 1, 1, 1, 1] = np.nan
    got = euler_admissible(3)(t(Q), 3).numpy()
    ref = np.asarray(jax_admissible(3)(jnp.asarray(Q), 3))
    np.testing.assert_array_equal(got, ref)
    assert not ref.all()


def test_troubled_mask_matches_jax(case):
    got = case["pl"].troubled_mask(t(case["Q"]), t(case["cand"])).numpy()
    np.testing.assert_array_equal(got, case["mask"])
    assert 0 < case["mask"].sum() < case["mask"].size


def _masks():
    rng = np.random.default_rng(3)
    return {
        "none": np.zeros(GRID, bool),
        "sparse": rng.random(GRID) < 0.02,
        "overflow": rng.random(GRID) < 0.3,  # more troubled rows than 8
        "all": np.ones(GRID, bool),
    }


@pytest.mark.parametrize("kind", ["sod", "none", "sparse", "overflow", "all"])
def test_gather_tables_row_matches_jax(case, kind):
    mask = case["mask"] if kind == "sod" else _masks()[kind]
    ref = case["jl"]._gather_tables_row(jnp.asarray(mask))
    got = case["pl"]._gather_tables_row(t(mask))
    for key in ("row", "row_safe", "active", "nb_slot", "nb_row", "mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert not np.asarray(ref["wall"]).any()  # periodic: no wall flags


@pytest.mark.parametrize("kind", ["sod", "none", "sparse", "overflow", "all"])
def test_gather_tables_row_n_active_matches_jax(case, kind):
    """``n_active`` is JAX's count of active slots, a 0-d tensor, and the
    active slots are the prefix ``k < n_active``."""
    mask = case["mask"] if kind == "sod" else _masks()[kind]
    ref = case["jl"]._gather_tables_row(jnp.asarray(mask))
    got = case["pl"]._gather_tables_row(t(mask))
    n = got["n_active"]
    assert n.dim() == 0 and n.dtype == torch.int64
    assert int(n) == int(np.asarray(ref["active"]).sum())
    K = case["pl"].troubled_capacity
    assert torch.equal(got["active"], torch.arange(K) < n)


SWEEP_K = 4


def _sweep_inputs(d):
    """A random valid batch ``[7, 7, 7, 5, SWEEP_K, 16]`` and its ghosts."""
    rng = np.random.default_rng(d)
    shape = (7, 7, 7, 5, SWEEP_K, 16)
    gshape = list(shape)
    gshape[d] = 1

    def state(shp):
        rho = 1.0 + 0.3 * rng.random(shp[:3] + shp[4:])
        mom = [0.4 * rng.standard_normal(shp[:3] + shp[4:]) for _ in range(3)]
        E = 2.5 + rng.random(shp[:3] + shp[4:])
        return np.stack([rho, *mom, E], axis=3)

    return state(shape), state(tuple(gshape)), state(tuple(gshape))


@pytest.fixture(scope="module")
def sweep_refs(case):
    """Per direction: the inputs and JAX's ``_row_sweep_math`` of them."""
    out = {}
    for d in range(3):
        s, lo, hi = _sweep_inputs(d)
        ref = case["jl"]._row_sweep_math(jnp.asarray(s), jnp.asarray(lo), jnp.asarray(hi),
                                         d, DT)
        out[d] = (s, lo, hi, [np.asarray(r) for r in ref])
    return out


@pytest.mark.parametrize("d", [0, 1, 2])
def test_row_sweep_math_matches_jax(case, sweep_refs, d):
    s, lo, hi, ref = sweep_refs[d]
    got = case["pl"]._row_sweep_math(t(s), t(lo), t(hi), d, DT)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        close(g, r)
    before = subcell_cuda.launches["subcell_row_sweep"]
    s_in = t(s)
    wrapped = subcell_cuda.row_sweep_call(case["pl"], d, s_in, t(lo), t(hi), DT,
                                          torch.tensor(SWEEP_K))
    assert subcell_cuda.launches["subcell_row_sweep"] == before  # plain on the CPU
    assert wrapped[0] is s_in  # in place
    for g, w in zip(got, wrapped):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_active", [0, 1, SWEEP_K // 2, SWEEP_K])
@pytest.mark.parametrize("d", [0, 1, 2])
def test_row_sweep_call_sweeps_the_active_slots_in_place(case, sweep_refs, d, n_active):
    """The wrapper's CPU branch holds the kernel's contract: the active
    slots as JAX's sweep gives them, the others bitwise untouched with
    zero edge fluxes, the ghosts unchanged."""
    s, lo, hi, ref = sweep_refs[d]
    s_in, lo_in, hi_in = t(s), t(lo), t(hi)
    out, g_lo, g_hi = subcell_cuda.row_sweep_call(case["pl"], d, s_in, lo_in, hi_in, DT,
                                                  torch.tensor(n_active))
    assert out is s_in
    n = n_active
    close(out[..., :n, :], ref[0][..., :n, :])
    close(g_lo[:, :n], ref[1][:, :n])
    close(g_hi[:, :n], ref[2][:, :n])
    np.testing.assert_array_equal(out[..., n:, :].numpy(), s[..., n:, :])
    assert not g_lo[:, n:].any() and not g_hi[:, n:].any()
    assert g_lo.shape == g_hi.shape == (5, SWEEP_K, 16)
    np.testing.assert_array_equal(lo_in.numpy(), lo)
    np.testing.assert_array_equal(hi_in.numpy(), hi)


def _poison_inactive(monkeypatch):
    """Make every sweep see NaN in the inactive slots of the batch and its
    ghosts, and return NaN edge fluxes there; returns the list of
    ``(n_active, K)`` of each sweep."""
    real = subcell_cuda.row_sweep_call
    seen = []

    def poisoned(limiter, d, s, ghost_lo, ghost_hi, dt, n_active):
        n = int(n_active)
        seen.append((n, s.shape[-2]))
        for x in (s, ghost_lo, ghost_hi):
            x[..., n:, :] = float("nan")
        s, g_lo, g_hi = real(limiter, d, s, ghost_lo, ghost_hi, dt, n_active)
        g_lo[:, n:] = float("nan")
        g_hi[:, n:] = float("nan")
        return s, g_lo, g_hi

    monkeypatch.setattr(subcell_cuda, "row_sweep_call", poisoned)
    return seen


@pytest.mark.parametrize("kind", ["sod", "sparse", "overflow"])
def test_limited_step_reads_no_inactive_slot(case, kind, monkeypatch):
    """The limited step with the sweep wrapper (``subcell_cuda=True``, its
    plain branch here) is bitwise the same when every inactive slot of the
    gathered batch, its ghosts and its edge fluxes is NaN, and within 1e-12
    of JAX's step.  ``sod``: the step's own detection at capacity 12 (it
    flags 8 rows); ``sparse`` and ``overflow``: those masks forced at
    capacity 8 (the overflow fills every slot and runs the means update)."""
    capacity = 12 if kind == "sod" else 8
    js = case["js"]
    jl = JaxLimited(js, admissible=jax_admissible(3, gamma=1.4), troubled_capacity=capacity,
                    troubled_granularity="row", dmp_delta0=5e-4, subcell_pallas=True,
                    subcell_interpret=True)
    pl = limited_from_jax(jl, gamma=1.4, device="cpu")
    assert pl.subcell_cuda
    if kind != "sod":
        mask = _masks()[kind]
        jl.troubled_mask = lambda u, c: jnp.asarray(mask)
        pl.troubled_mask = lambda u, c: t(mask)
    u = t(case["Q"])
    out, eff = pl.step(u, DT, return_face_fluxes=True)
    seen = _poison_inactive(monkeypatch)
    out_p, eff_p = pl.step(u, DT, return_face_fluxes=True)
    assert len(seen) == 3
    n, K = seen[0]
    assert K == capacity and (n < K) == (kind != "overflow")
    assert torch.equal(out_p, out)
    for a, b in zip(eff_p, eff):
        assert torch.equal(a, b)
    ref, eff_ref = jl.step(jnp.asarray(case["Q"]), DT, return_face_fluxes=True)
    close(out, ref)
    for a, b in zip(eff, eff_ref):
        close(a, b)


@pytest.mark.parametrize("kind", ["sod", "overflow"])
def test_gathered_subcell_step_row_matches_jax(case, kind):
    mask = case["mask"] if kind == "sod" else _masks()[kind]
    jt = case["jl"]._gather_tables_row(jnp.asarray(mask))
    pt = case["pl"]._gather_tables_row(t(mask))
    R_ref, g_ref = case["jl"]._gathered_subcell_step_row(jnp.asarray(case["Q"]), DT, jt)
    R_got, g_got = case["pl"]._gathered_subcell_step_row(t(case["Q"]), DT, pt)
    close(R_got, R_ref)
    for (a, b), (c, e) in zip(g_got, g_ref):
        close(a, c)
        close(b, e)
    # The scatters that consume them.
    fv_ref = case["jl"]._scatter_face_fluxes_row(g_ref, jt, jnp.float64)
    fv_got = case["pl"]._scatter_face_fluxes_row(g_got, pt, torch.float64)
    for a, b in zip(fv_got, fv_ref):
        close(a, b)
    out_ref = case["jl"]._scatter_fallback_row(jnp.asarray(case["cand"]), R_ref, jt,
                                               jt["mask"])
    out_got = case["pl"]._scatter_fallback_row(t(case["cand"]), R_got, pt, pt["mask"])
    close(out_got, out_ref)


def test_match_interface_fluxes_matches_jax(case):
    """On a rough state (``bench.py``'s recipe), where the DG and FV face
    fluxes differ, with a sparse random mask."""
    js, jl, pl = case["js"], case["jl"], case["pl"]
    rng = np.random.default_rng(0)
    va = js.var_axis
    rho = 1.0 + 0.2 * rng.random(js.state_shape[:va] + js.state_shape[va + 1:])
    Q = np.stack([rho, rho, 0.5 * rho, 0.25 * rho, 5.0 + 0.5 * rho * 1.3125], axis=va)
    cand, fluxes = js.step(jnp.asarray(Q), DT, return_face_fluxes=True)
    jt = jl._gather_tables_row(jnp.asarray(_masks()["sparse"]))
    _, g = jl._gathered_subcell_step_row(jnp.asarray(Q), DT, jt)
    fv = [np.asarray(f) for f in jl._scatter_face_fluxes_row(g, jt, jnp.float64)]
    troubled = np.asarray(jt["mask"])
    ref = np.asarray(jl._match_interface_fluxes(
        cand, fluxes, [jnp.asarray(f) for f in fv], jnp.asarray(troubled), DT))
    got = pl._match_interface_fluxes(
        t(cand), [t(f) for f in fluxes], [t(f) for f in fv], t(troubled), DT)
    close(got, ref)
    assert np.abs(ref - np.asarray(cand)).max() > 1e-6  # faces were matched


def test_admissibility_scale_matches_jax(case):
    """A state with inadmissible nodes, so the contraction runs: one cell
    fixable at some θ, one whose mean is itself inadmissible."""
    Q = case["cand"].copy()
    Q[0, 1, 2, 0, 2, 0, 4] = -0.05  # one node of a cell with a good mean
    Q[:, :, :, 4, 5, 1, 9] = 1e-4  # a whole cell with negative pressure
    ref = np.asarray(case["jl"]._admissibility_scale(jnp.asarray(Q)))
    got = case["pl"]._admissibility_scale(t(Q))
    close(got, ref)
    assert not np.array_equal(ref, Q)
    # An admissible state passes through unchanged (same tensor).
    cand = t(case["cand"])
    assert case["pl"]._admissibility_scale(cand) is cand


def test_fv_fallback_and_means_match_jax(case):
    ref = case["jl"].fv_fallback(jnp.asarray(case["cand"]), DT)
    close(case["pl"].fv_fallback(t(case["cand"]), DT), ref)
    close(case["pl"].cell_means(t(case["cand"])), case["jl"].cell_means(jnp.asarray(case["cand"])))


def test_capacity_usage_matches_jax(case):
    d_ref, cap_ref = case["jl"].capacity_usage(jnp.asarray(case["Q"]), DT)
    d_got, cap_got = case["pl"].capacity_usage(t(case["Q"]), DT)
    assert int(d_got) == int(d_ref) == 8 and cap_got == cap_ref == 8
