"""The limited production step as a whole: ``bench.py::bench_limited``'s
configuration built on both sides from one JAX ``LimitedADERDG``.

Depth is cut: ``(8, 2, 16)`` cells instead of ``(256, 8, 128)``, capacity 8
rows instead of 128, dx = 1/8 and dt = 4.8e-3 (the bench's dt = 1.5e-4 at
dx = 1/256, scaled by dx).  Order, physics, the Sod state, ``dmp_delta0``,
the "means" overflow policy and the guard are the bench's.  The third step
flags 16 rows, so the overflow update runs.  f64 at rtol=0, atol=1e-12,
and the troubled masks exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import euler_physics as jax_euler_physics
from exahype_tpu.models.limiter import LimitedADERDG as JaxLimited
from exahype_tpu.models.limiter import euler_admissible as jax_admissible
from exahype_tpu_torch.convert import (
    aderdg_from_jax,
    limited_from_jax,
    state_from_numpy,
    state_to_numpy,
)
from exahype_tpu_torch.models import subcell_cuda
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible
from exahype_tpu_torch.utils.errors import SemanticError

torch.set_num_threads(1)

GRID = (8, 2, 16)
DT = 4.8e-3
CAPACITY = 8


def jax_config(accelerator=None, **kw):
    """The JAX solver and limiter; ``accelerator(solver)`` builds one over
    the solver."""
    flux, eig = jax_euler_physics(dim=3, n_real=5)
    js = JaxSolver(dim=3, order=3, n_vars=5, grid_shape=GRID, flux_fn=flux,
                   max_eigenvalue_fn=eig, dx=1.0 / GRID[0])
    opts = dict(admissible=jax_admissible(3, gamma=1.4), troubled_capacity=CAPACITY,
                troubled_granularity="row", dmp_delta0=5e-4)
    opts.update(kw)
    if accelerator is not None:
        opts["accelerator"] = accelerator(js)
    return js, JaxLimited(js, **opts)


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


def test_limited_three_steps_match_jax():
    js, jl = jax_config()
    port = limited_from_jax(jl, gamma=1.4, device="cpu")
    Q = sod_state(js)
    ref, u = jnp.asarray(Q), state_from_numpy(Q, device="cpu")
    demand = []
    for k in range(3):
        mask_ref = np.asarray(jl.troubled_mask(ref, js.step(ref, DT)))
        mask = port.troubled_mask(u, port.solver.step(u, DT)).numpy()
        np.testing.assert_array_equal(mask, mask_ref, err_msg=f"step {k + 1}")
        demand.append(int(mask.reshape(-1, GRID[-1]).any(axis=-1).sum()))
        ref, eff_ref = jl.step(ref, DT, return_face_fluxes=True)
        u, eff = port.step(u, DT, return_face_fluxes=True)
        np.testing.assert_allclose(state_to_numpy(u), np.asarray(ref), rtol=0,
                                   atol=1e-12, err_msg=f"step {k + 1}")
        for got, want in zip(eff, eff_ref):
            np.testing.assert_allclose(state_to_numpy(got), np.asarray(want),
                                       rtol=0, atol=1e-12, err_msg=f"step {k + 1}")
    assert demand == [8, 8, 16]  # the third step overflows the capacity
    np.testing.assert_allclose(state_to_numpy(port.solver.total_mass(u)),
                               np.asarray(js.total_mass(ref)), rtol=0, atol=1e-12)


def test_limited_step_matches_pallas_interpret():
    """One step against the TPU kernels themselves, in interpret mode: the
    candidate and face fluxes through ``PallasADERDG(boundary_faces_only=
    True)``, the sweeps through ``subcell_pallas``.  The port maps them to
    ``CudaADERDG`` and ``subcell_cuda``, which take their plain versions
    for CPU tensors."""
    from exahype_tpu.models.aderdg_pallas import PallasADERDG

    js, jl = jax_config(
        accelerator=lambda s: PallasADERDG(s, interpret=True, tile0=2,
                                           boundary_faces_only=True),
        subcell_pallas=True, subcell_interpret=True,
    )
    assert jl.accelerator.boundary_faces_only
    Q = sod_state(js)
    ref = np.asarray(jl.step(jnp.asarray(Q), DT))
    port = limited_from_jax(jl, gamma=1.4, device="cpu")
    assert isinstance(port.accelerator, CudaADERDG) and port.subcell_cuda
    before = subcell_cuda.launches["subcell_row_sweep"]
    got = state_to_numpy(port.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert port.accelerator.launches == {"aderdg_predictor_volume": 0,
                                         "aderdg_face_flux": 0,
                                         "aderdg_surface_update": 0}
    assert subcell_cuda.launches["subcell_row_sweep"] == before


def test_limited_from_jax_reads_the_configuration():
    _, jl = jax_config(dmp_delta0=3e-4, dmp_eps=2e-3, troubled_capacity=100,
                       post_step_guard=False)
    port = limited_from_jax(jl, gamma=1.4, device="cpu", dtype=torch.float32)
    assert (port.dmp_delta0, port.dmp_eps) == (3e-4, 2e-3)
    assert port.troubled_capacity == 16  # clamped to the 8 x 2 rows, as in JAX
    assert port.post_step_guard is False and port.subcell_cuda is False
    assert port.accelerator is None and port.admissible is not None
    assert port.solver.weights.dtype == torch.float32
    assert all(b.device.type == "cpu" for b in port.buffers())
    _, jl = jax_config(admissible=None)
    assert limited_from_jax(jl, gamma=1.4, device="cpu").admissible is None


REFUSED = {
    "cell granularity": dict(troubled_granularity="cell"),
    "candidate overflow": dict(overflow_fallback="candidate"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_options_outside_the_slice_raise(name):
    _, jl = jax_config(**REFUSED[name])
    with pytest.raises(SemanticError, match="ROADMAP"):
        limited_from_jax(jl, gamma=1.4, device="cpu")


#: The whole-grid fallbacks, which the port used to refuse.
WHOLE_GRID = {
    "no capacity": dict(troubled_capacity=None),
    "means fallback": dict(fallback="means", troubled_capacity=None),
    "MUSCL": dict(fallback_order=2, troubled_capacity=None),
}


@pytest.mark.parametrize("name", sorted(WHOLE_GRID))
def test_whole_grid_options_match_jax(name):
    """Two limited Sod steps of the whole-grid subcell (first and second
    order) and means fallbacks against JAX (tests/test_torch_limiter_walls.py
    and tests/test_torch_limiter_muscl.py hold them with walls)."""
    js, jl = jax_config(**WHOLE_GRID[name])
    port = limited_from_jax(jl, gamma=1.4, device="cpu")
    assert port.troubled_capacity is None
    ref, u = jnp.asarray(sod_state(js)), state_from_numpy(sod_state(js), device="cpu")
    for k in range(2):
        ref, u = jl.step(ref, DT), port.step(u, DT)
        np.testing.assert_allclose(state_to_numpy(u), np.asarray(ref), rtol=0, atol=1e-12,
                                   err_msg=f"step {k + 1}")
    if name == "means fallback":
        with pytest.raises(ValueError, match="requires the 'subcell' fallback"):
            port.step(u, DT, return_face_fluxes=True)
    with pytest.raises(ValueError, match="capacity_usage requires troubled_capacity"):
        port.capacity_usage(u, DT)


def test_walls_hooks_and_observables_raise():
    # A walled limiter crosses (tests/test_torch_limiter_walls.py), a walled
    # MUSCL one too, with its slope (tests/test_torch_limiter_muscl.py).
    flux, eig = jax_euler_physics(dim=3, n_real=5)
    js = JaxSolver(dim=3, order=3, n_vars=5, grid_shape=GRID, flux_fn=flux,
                   max_eigenvalue_fn=eig, dx=1.0 / GRID[0], boundary="outflow")
    jl = JaxLimited(js, troubled_capacity=CAPACITY, troubled_granularity="row")
    assert limited_from_jax(jl, gamma=1.4, device="cpu").solver.is_wall(0)
    jl = JaxLimited(js, fallback_order=2, fallback_slope="central")
    port = limited_from_jax(jl, gamma=1.4, device="cpu")
    assert (port.fallback_order, port.fallback_slope) == (2, "central")
    _, jl = jax_config()
    port = limited_from_jax(jl, gamma=1.4, device="cpu")
    with pytest.raises(SemanticError, match="ROADMAP"):
        port.driver_observables(DT)
    u = state_from_numpy(sod_state(jl.solver), device="cpu")
    with pytest.raises(SemanticError, match="ROADMAP"):
        port.step(u, DT, troubled_transform=lambda m: m)


def test_limiter_needs_the_solvers_device_and_solver():
    js, _ = jax_config()
    sol = aderdg_from_jax(js, gamma=1.4, device="cpu")
    other = CudaADERDG(aderdg_from_jax(js, gamma=1.4, device="cpu"))
    with pytest.raises(ValueError, match="own base solver"):
        LimitedADERDG(sol, troubled_capacity=8, troubled_granularity="row",
                      accelerator=other, device="cpu")
    with pytest.raises(ValueError, match="solver's"):
        LimitedADERDG(sol, troubled_capacity=8, troubled_granularity="row",
                      device="meta")


ENTRY_POINTS = ["LimitedADERDG", "limited_from_jax"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is the card")
    js, jl = jax_config()
    sol = aderdg_from_jax(js, gamma=1.4, device="cpu")
    make = {
        "LimitedADERDG": lambda **kw: LimitedADERDG(
            sol, euler_admissible(3), troubled_capacity=8,
            troubled_granularity="row", **kw),
        "limited_from_jax": lambda **kw: limited_from_jax(jl, gamma=1.4, **kw),
    }[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    made = make(device="cpu")
    assert all(b.device.type == "cpu" for b in made.buffers())
