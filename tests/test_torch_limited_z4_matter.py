"""The limited coupled Z4+GRHD step in 3-D (``LimitedADERDG`` over
``make_z4_matter_solver``, the NCP and source solver of ROADMAP Queue 1 item
9.4, the card path's gathered-row configuration) against the JAX package's
on the CPU in f64.

The bar is the Z4 family's, 1e-12·max(1, max|JAX|).  JAX's limiter runs
eagerly (its jit of the coupled step compiles for a minute) and is handed
the port's candidate step and face fluxes through a duck-typed accelerator
(:class:`PortCandidate`), so each comparison holds the limiter's own stages
(detection, the fallback with its NCP and source terms, matching, the
guard); the 3-D candidate is held to JAX by ``tests/test_torch_z4_matter.py``
(``test_one_and_two_steps_match_jax``).  The 2-D twin of
``tests/test_z4_matter.py:503-543``, candidate included, is
``tests/test_torch_limited_z4_matter_2d.py``.

- the 3-D gathered-row step of the card path's configuration
  (``fused_rhs="soa"``, geodesic slicing, Γ = 5/3) at a small grid with a
  one-cell clump: JAX's ``_row_sweep_math`` against the port's, direction
  by direction on a noisy gathered batch (every slot live), then one step;
- the crossing from JAX (``limited_from_jax(..., physics="z4_matter")``) and
  the sweep kernel's dispatch and refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import z4_matter as jm
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu.models.limiter import LimitedADERDG as JaxLimited
from exahype_tpu_torch.convert import limited_from_jax, state_from_numpy, state_to_numpy
from exahype_tpu_torch.models import subcell_cuda
from exahype_tpu_torch.models import z4_matter as tm
from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.limiter import LimitedADERDG
from exahype_tpu_torch.models.z4_grmhd import make_z4_grmhd_solver
from exahype_tpu_torch.utils.errors import LoweringError
from torch_z4m_batch import z4m_gathered_batch

torch.set_num_threads(1)

GAMMA = 5.0 / 3.0
GAUGE = dict(slicing="harmonic", f=0.0)
#: The 3-D gathered case: the card path's solver at a small grid, the clump
#: one cell wide (σ = dx, w = 2 dx²), a slot for each of the 16 rows (the
#: overflow's cell-mean update is held to JAX on the toy solver,
#: tests/test_torch_limiter_ncp.py).
GRID3 = (4, 4, 8)
DX3 = 1.0 / 8
CAPACITY3 = 16
DT3 = 1e-4  # the card path's; at 2e-3 the expansion alone moves every cell past the DMP window


def _bar(ref):
    return 1e-12 * max(1.0, float(np.abs(np.asarray(ref)).max()))


def close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max())
    assert err <= _bar(ref), f"{what}: max_abs_err {err} > {_bar(ref)}"


class PortCandidate:
    """A duck-typed accelerator for the JAX limiter: its ``step`` is the
    port solver's, so the JAX limiter limits the port's candidate."""

    def __init__(self, js, ps):
        self.solver, self.ps = js, ps

    def step(self, u, dt, return_face_fluxes=False):
        new, fl = self.ps.step(state_from_numpy(np.asarray(u), device="cpu"), dt,
                               return_face_fluxes=True)
        new = jnp.asarray(state_to_numpy(new))
        if not return_face_fluxes:
            return new
        return new, [jnp.asarray(state_to_numpy(f)) for f in fl]


def pair(js, **kw):
    """The port's limiter crossed from a JAX one, and the JAX limiter over
    the port's candidate."""
    pl = limited_from_jax(JaxLimited(js, admissible=jm.z4_matter_admissible(gamma=GAMMA), **kw),
                          gamma=GAMMA, physics="z4_matter", device="cpu", **GAUGE)
    jl = JaxLimited(js, admissible=jm.z4_matter_admissible(gamma=GAMMA),
                    accelerator=PortCandidate(js, pl.solver), **kw)
    return jl, pl


def with_clump(js, Q, amp, width):
    """D̃ and τ̃ (slots 38, 42) times 1 + amp·exp(−|x − c|²/width), c the box
    centre (``tests/test_z4_matter.py:523-532``'s profile)."""
    coords = js.nodes_meshgrid()
    r2 = 0.0
    for d in range(js.dim):
        x = np.squeeze(np.asarray(coords[d]), js.var_axis)
        r2 = r2 + (x - 0.5 * js.grid_shape[d] * js._dxs[d]) ** 2
    bump = 1.0 + amp * np.exp(-r2 / width)
    q = np.moveaxis(np.array(Q), js.var_axis, -1)
    q[..., 38] *= bump
    q[..., 42] *= bump
    return np.ascontiguousarray(np.moveaxis(q, -1, js.var_axis))


def _solver3():
    return jm.make_z4_matter_solver(dim=3, order=2, grid_shape=GRID3, dx=DX3, gamma=GAMMA,
                                    fused_rhs="soa", **GAUGE)


def test_row_sweep_math_matches_jax_direction_by_direction():
    """The gathered sweep with the NCP halves of every face (the plain version
    of the K3 a kernel, ``csrc/subcell_ncp.cuh``) against JAX's
    ``_row_sweep_math`` on a noisy batch, each direction; and the sweep
    wrapper on CPU tensors (the plain version on the active slots, in
    place, zero edge fluxes elsewhere) against it."""
    js = _solver3()
    jl, pl = pair(js, troubled_capacity=CAPACITY3, troubled_granularity="row")
    K, L = CAPACITY3, GRID3[2]  # the gathered step's batch (warm JAX caches)
    s = z4m_gathered_batch((5, 5, 5, 43, K, L), 1).numpy()
    for d in range(3):
        gshape = [5, 5, 5, 43, K, L]
        gshape[d] = 1
        lo, hi = (z4m_gathered_batch(tuple(gshape), seed + d).numpy() for seed in (10, 20))
        with jax.disable_jit():
            ref = jl._row_sweep_math(jnp.asarray(s), jnp.asarray(lo), jnp.asarray(hi), d, DT3)
        t = [torch.from_numpy(x) for x in (s, lo, hi)]
        got = pl._row_sweep_math(*t, d, DT3)
        for what, a, b in zip(("s", "g_lo", "g_hi"), got, ref):
            close(a.numpy(), b, f"d={d} {what}")
        n = 2
        work = t[0].clone()
        out = subcell_cuda.row_sweep_call(pl, d, work, t[1], t[2], DT3, torch.tensor(n))
        assert out[0] is work and torch.equal(work[..., n:, :], t[0][..., n:, :])
        for what, a, b in zip(("s", "g_lo", "g_hi"), out, got):
            close(a[..., :n, :].numpy(), b[..., :n, :].numpy(), f"d={d} wrapper {what}")
        assert not out[1][..., n:, :].any() and not out[2][..., n:, :].any()


def test_gathered_limited_step_matches_jax():
    """A gathered-row limited step of the card path's configuration at a
    small grid with a one-cell clump (the detector fires on 12 of the 16
    rows): the port against JAX's limiter on the port's candidate."""
    js = _solver3()
    jl, pl = pair(js, troubled_capacity=CAPACITY3, troubled_granularity="row")
    adot = np.sqrt(8 * np.pi * 0.02 * 1.4 / 3)
    Q = with_clump(js, jm.flrw_state(js, 1.0, adot, rho0=0.02, eps0=0.4, gamma=GAMMA), 4.0,
                   2 * DX3**2)
    u = state_from_numpy(Q, device="cpu")
    demand, capacity = pl.capacity_usage(u, DT3)
    assert 0 < int(demand) < capacity == GRID3[0] * GRID3[1], int(demand)
    with jax.disable_jit():
        ref = jl.step(jnp.asarray(Q), DT3)
    u = pl.step(u, DT3)
    close(state_to_numpy(u), ref, "step 1")
    assert bool(tm.z4_matter_admissible(gamma=GAMMA)(u, pl.solver.var_axis).all())


def test_crossing_and_the_sweep_kernels_dispatch():
    """``limited_from_jax(..., physics="z4_matter")``: the port's solver,
    admissibility hook (it agrees with JAX's), ``CudaADERDG`` for a
    ``PallasADERDG`` accelerator and ``subcell_cuda`` for
    ``subcell_pallas``; the sweep kernel is the Z4+GRHD p2 instance, and
    another order and Z4+GRMHD raise naming ROADMAP Queue 2 K3 a, 2-D Euler
    K3 b."""
    js = _solver3()
    jl = JaxLimited(js, admissible=jm.z4_matter_admissible(gamma=GAMMA),
                    accelerator=PallasADERDG(js), troubled_capacity=CAPACITY3,
                    troubled_granularity="row", subcell_pallas=True)
    pl = limited_from_jax(jl, gamma=GAMMA, physics="z4_matter", device="cpu", **GAUGE)
    assert isinstance(pl.accelerator, CudaADERDG) and pl.accelerator.solver is pl.solver
    assert pl.subcell_cuda and pl.troubled_capacity == CAPACITY3
    assert pl.solver.flux_fn.physics.params == ("harmonic", 0.0, 2.0, 0.0, 0.0, GAMMA, 10)
    Q = z4m_gathered_batch((3, 3, 3, 43, 2, 2), 3).numpy()
    assert np.array_equal(
        pl.admissible(torch.from_numpy(Q), 3).numpy(),
        np.asarray(jm.z4_matter_admissible(gamma=GAMMA)(jnp.asarray(Q), 3)))
    assert subcell_cuda.check_physics(pl) == "subcell_row_sweep_z4_matter"
    row = dict(troubled_capacity=4, troubled_granularity="row", subcell_cuda=True, device="cpu")
    others = {
        "K3 a": [tm.make_z4_matter_solver(3, 3, (2, 2, 2), fused_rhs="soa", device="cpu"),
                 make_z4_grmhd_solver(3, 2, (2, 2, 2), fused_rhs="soa", device="cpu")],
        "K3 b": [ADERDGSolver(2, 3, 4, (2, 2), *euler_physics(2, n_real=4), device="cpu")],
    }
    for item, solvers in others.items():
        for sol in solvers:
            with pytest.raises(LoweringError, match=f"ROADMAP.md, Queue 2 {item}"):
                subcell_cuda.check_physics(LimitedADERDG(sol, **row))
