"""The port's FV solver path as a whole, against the JAX package's, on the
CPU: the spec-DSL Rusanov patch update driven by ``GridSolver`` over a
``TpuPatchGrid``, built on both sides from one JAX configuration.

Depth is cut (a ``(2, 2, 2)`` patch grid instead of ``(32, 16, 128)``);
the width is the port's main path: 3-D Euler, ``patch_size=4``,
``halo_size=1``, ``n_real=5``, ``n_aux=0``.  The initial state is
``__graft_entry__._example_state``'s recipe, made with NumPy from a seed.
f64 at rtol=0, atol=1e-12 after 5 CFL steps (the bar the repo holds
multi-step runs to); halo exchange is plain copying, so it is held
bitwise.  The last tests check the card-default rule: with no card, an
entry point given no ``device`` raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import euler as jax_euler
from exahype_tpu.models.fv import build_fv_rusanov_kernel as jax_fv
from exahype_tpu.models.rusanov import build_rusanov_kernel as jax_rusanov
from exahype_tpu.parallel.grid import PatchGrid as JaxPatchGrid
from exahype_tpu.parallel.grid import TpuPatchGrid as JaxTpuPatchGrid
from exahype_tpu.parallel.solver import GridSolver as JaxGridSolver
from exahype_tpu_torch.convert import (
    grid_solver_from_jax,
    state_from_numpy,
    state_to_numpy,
)
from exahype_tpu_torch.models import euler
from exahype_tpu_torch.models.fv import build_fv_rusanov_kernel
from exahype_tpu_torch.parallel.grid import TpuPatchGrid
from exahype_tpu_torch.parallel.solver import GridSolver
from exahype_tpu_torch.utils.errors import SemanticError

torch.set_num_threads(1)

GRID = (2, 2, 2)
WIDTH = dict(dim=3, patch_size=4, halo_size=1, n_real=5, n_aux=0)


def jax_wave_speed(cells):
    out = jax_euler.max_eigenvalue_tpu(cells, 0, dim=3)
    for d in (1, 2):
        out = jnp.maximum(out, jax_euler.max_eigenvalue_tpu(cells, d, dim=3))
    return out


def jax_solver(spec="fv", boundary="periodic", grid=GRID, kernel_dt="lambda",
               eigenvalue_fn=jax_wave_speed):
    build = {"fv": jax_fv, "rusanov": jax_rusanov}[spec]
    kb = build(**WIDTH, n_patches=int(np.prod(grid)))
    return JaxGridSolver(
        JaxTpuPatchGrid(kb.config, grid, boundary=boundary), kb,
        dx=1.0 / (4 * grid[0]), cfl=0.45, eigenvalue_fn=eigenvalue_fn,
        backend="pallas", kernel_dt=kernel_dt, interpret=True,
    )


def example_state(shape, seed=0):
    """``__graft_entry__._example_state``'s recipe on the SoA-P grid state
    ``[*extent, V, *grid]`` (var axis 3)."""
    rng = np.random.default_rng(seed)
    Q = rng.uniform(0.1, 1.0, size=shape)
    Q[:, :, :, 0] += 1.0
    Q[:, :, :, 4] += 5.0
    return Q


def test_fv_solver_five_cfl_steps_match_jax():
    js = jax_solver()
    port = grid_solver_from_jax(js, spec="fv", gamma=1.4, device="cpu")
    Q = example_state(js.grid.state_shape)
    ref, t_ref = js.run(jnp.asarray(Q), 5)
    got, t = port.run(state_from_numpy(Q, device="cpu"), 5)
    np.testing.assert_allclose(state_to_numpy(got), np.asarray(ref), rtol=0, atol=1e-12)
    assert t.dim() == 0
    np.testing.assert_allclose(float(t), float(t_ref), rtol=1e-14, atol=0)
    assert port.kernel_fn.launches == 0  # CPU: the plain version
    # Each conserved integral over the interiors is kept (periodic, flux form).
    interior = (slice(1, 5),) * 3
    m0 = Q[interior].sum(axis=(0, 1, 2, 4, 5, 6))
    m1 = state_to_numpy(got)[interior].sum(axis=(0, 1, 2, 4, 5, 6))
    np.testing.assert_allclose(m1, m0, rtol=1e-13, atol=0)


def test_canonical_spec_steps_match_jax():
    """The canonical spec, physical dt, fixed step (it is no integrator, so
    two steps only)."""
    js = jax_solver("rusanov", kernel_dt="physical", eigenvalue_fn=None)
    port = grid_solver_from_jax(js, spec="rusanov", gamma=1.4, device="cpu")
    assert port.eigenvalue_fn is None and port.kernel_dt == "physical"
    Q = example_state(js.grid.state_shape, seed=1)
    ref, _ = js.run(jnp.asarray(Q), 2, dt=1e-3)
    got, t = port.run(state_from_numpy(Q, device="cpu"), 2, dt=1e-3)
    np.testing.assert_allclose(state_to_numpy(got), np.asarray(ref), rtol=0, atol=1e-12)
    assert float(t) == pytest.approx(2e-3, rel=1e-15)


@pytest.mark.parametrize("grid", [(2, 3, 1), (1, 2, 3)])
@pytest.mark.parametrize("boundary", ["periodic", "reflective"])
def test_halo_fill_matches_jax(boundary, grid):
    cfg = jax_fv(**WIDTH, n_patches=int(np.prod(grid))).config
    jgrid = JaxTpuPatchGrid(cfg, grid, boundary=boundary)
    kb = build_fv_rusanov_kernel(**WIDTH, n_patches=int(np.prod(grid)))
    pgrid = TpuPatchGrid(kb.config, grid, boundary=boundary)
    Q = np.random.default_rng(2).normal(size=jgrid.state_shape)
    want = np.asarray(jgrid.halo_fill(jnp.asarray(Q)))
    Qt = torch.from_numpy(Q.copy())
    assert pgrid.halo_fill(Qt) is Qt  # in place
    np.testing.assert_array_equal(Qt.numpy(), want)


def test_halo_fill_narrow_patch_matches_jax():
    """patch_size < halo_size: the slabs read overlap those written."""
    from exahype_tpu.utils.config import KernelConfig as JaxConfig
    from exahype_tpu_torch.utils.config import KernelConfig

    kw = dict(dim=2, patch_size=1, halo_size=2, n_real=2, n_aux=0, n_patches=6)
    jgrid = JaxTpuPatchGrid(JaxConfig(**kw), (3, 2), boundary="reflective")
    pgrid = TpuPatchGrid(KernelConfig(**kw), (3, 2), boundary="reflective")
    Q = np.random.default_rng(3).normal(size=jgrid.state_shape)
    want = np.asarray(jgrid.halo_fill(jnp.asarray(Q)))
    np.testing.assert_array_equal(pgrid.halo_fill(torch.from_numpy(Q.copy())).numpy(), want)


def test_grid_solver_from_jax_round_trip():
    js = jax_solver(boundary="reflective", grid=(2, 1, 3))
    port = grid_solver_from_jax(js, spec="fv", gamma=1.4, device="cpu",
                                dtype=torch.float32)
    assert dataclasses.astuple(port.kernel.config) == dataclasses.astuple(js.kernel.config)
    assert port.grid.grid_shape == js.grid.grid_shape
    assert port.grid.boundary == "reflective"
    assert port.grid.state_shape == js.grid.state_shape
    assert (port.dx, port.cfl, port.kernel_dt) == (js.dx, js.cfl, js.kernel_dt)
    assert port.dofs() == js.kernel.config.dofs()
    assert port.device == torch.device("cpu") and port.dtype == torch.float32
    # The state crosses unchanged, and so does the CFL step.
    Q = example_state(js.grid.state_shape)
    u = state_from_numpy(Q, device="cpu")
    assert state_to_numpy(u).tobytes() == Q.tobytes()
    port64 = grid_solver_from_jax(js, spec="fv", gamma=1.4, device="cpu")
    np.testing.assert_allclose(
        float(port64.compute_dt(u)), float(js.compute_dt(jnp.asarray(Q))),
        rtol=1e-15, atol=0,
    )
    with pytest.raises(SemanticError, match="float64"):
        port.step(u, 1e-3)  # the solver was built for float32


def test_grid_solver_from_jax_refuses_what_is_not_ported():
    js = jax_solver()
    with pytest.raises(SemanticError, match="spec"):
        grid_solver_from_jax(js, spec="muscl", gamma=1.4, device="cpu")
    kb = jax_fv(**WIDTH, n_patches=8)
    aos = JaxGridSolver(JaxPatchGrid(kb.config, GRID), kb, backend="jax")
    with pytest.raises(SemanticError, match="TpuPatchGrid"):
        grid_solver_from_jax(aos, spec="fv", gamma=1.4, device="cpu")
    walled = JaxGridSolver(
        JaxTpuPatchGrid(kb.config, GRID, boundary="reflective",
                        reflect_fn=lambda s, d, va: s),
        kb, backend="pallas", interpret=True,
    )
    with pytest.raises(SemanticError, match="reflect_fn"):
        grid_solver_from_jax(walled, spec="fv", gamma=1.4, device="cpu")


def test_wave_speed_matches_jax():
    """Within an f64 rounding: XLA may fuse the division and root
    differently from PyTorch's eager kernels."""
    Q = example_state((4, 4, 4, 5, 3, 2, 1))
    np.testing.assert_allclose(
        euler.wave_speed_fn(3)(torch.from_numpy(Q)).numpy(),
        np.asarray(jax_wave_speed(jnp.asarray(Q))), rtol=1e-15, atol=0,
    )


# -------------------------------------------------------- the card by default


def _entry_points():
    from exahype_tpu.models.aderdg import ADERDGSolver as JaxADERDG
    from exahype_tpu.models.aderdg import euler_physics as jax_euler_physics
    from exahype_tpu_torch.convert import aderdg_from_jax
    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics

    flux, eig = euler_physics(3)
    jflux, jeig = jax_euler_physics(dim=3, n_real=5)
    jaderdg = JaxADERDG(dim=3, order=3, n_vars=5, grid_shape=(2, 2, 2),
                        flux_fn=jflux, max_eigenvalue_fn=jeig)
    kb = build_fv_rusanov_kernel(**WIDTH, n_patches=8)
    return {
        "ADERDGSolver": lambda **kw: ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, **kw),
        "aderdg_from_jax": lambda **kw: aderdg_from_jax(jaderdg, gamma=1.4, **kw),
        "state_from_numpy": lambda **kw: state_from_numpy(np.zeros(3), **kw),
        "GridSolver": lambda **kw: GridSolver(TpuPatchGrid(kb.config, GRID), kb, **kw),
        "grid_solver_from_jax": lambda **kw: grid_solver_from_jax(
            jax_solver(), spec="fv", gamma=1.4, **kw),
    }


@pytest.mark.parametrize("name", ["ADERDGSolver", "aderdg_from_jax", "state_from_numpy",
                                  "GridSolver", "grid_solver_from_jax"])
def test_entry_point_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is the card")
    make = _entry_points()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    made = make(device="cpu")
    tensors = [made] if isinstance(made, torch.Tensor) else list(
        getattr(made, "buffers", lambda: [])())
    assert all(t.device.type == "cpu" for t in tensors)


def test_jax_solver_state_crosses_unchanged():
    """A JAX state array (not only NumPy) crosses through state_from_numpy,
    as a copy that the port's in-place steps may write."""
    Q = jnp.asarray(example_state((6, 6, 6, 5, 1, 1, 2)))
    t = state_from_numpy(Q, device="cpu")
    assert t.dtype == torch.float64 and t.is_contiguous()
    np.testing.assert_array_equal(state_to_numpy(t), np.asarray(Q))
    before = np.array(Q)
    t += 1.0
    np.testing.assert_array_equal(np.asarray(Q), before)
    assert jax.config.jax_enable_x64
