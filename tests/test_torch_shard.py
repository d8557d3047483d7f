"""The port's sharded steps (``exahype_tpu_torch/parallel/shard.py``) on the
CPU over gloo, against the port's unsharded steps and the JAX package's: the
twins of ``tests/test_parallel.py``'s sharded tests.

Each mesh layout, ``(2,)``, ``(4,)`` and ``(2, 2)``, is spawned once
(``run_ranks``, ``file://`` rendezvous, no network); its ranks run every
check of ``tests/torch_shard_ranks.py`` and report, per check, whether the
gathered sharded result is the port's unsharded step bit for bit.  Rank 0
returns the gathered result, which is held here against the JAX package's
unsharded step on the same numpy-seeded input at 1e-12 (f64).  The bf16
wire is held to the JAX package's 0.05.  The ADER-DG checks at order 3 go
through ``make_sharded_aderdg_step`` (K1 e's step; on the CPU its plain
version on the same exchange), the viscous walls and order 5 through
``make_sharded_xla_aderdg_step`` (the plain solver per rank; K1 e is
compiled for Euler at order 3).  JAX twin of each check:

- ``aderdg/periodic`` ``test_sharded_pallas_aderdg_matches_single_device``
  and the unfused one; ``aderdg/reflective``, ``outflow_0``, ``farfield_0``
  the walled ones; ``aderdg/dirichlet`` the Dirichlet transverse wall (2-axis:
  ``test_two_axis_sharded_aderdg_dirichlet_walls``); ``aderdg/outflow`` the
  2-axis walls; ``aderdg/viscous_walls`` the viscous walls (1 and 2 axes);
  ``aderdg/p5`` the order-5 one; ``aderdg/bf16_wire`` the bf16 ADER-DG wire
  tests; ``aderdg/face_fluxes`` the ``return_face_fluxes`` contract;
- ``fv/periodic`` ``test_shard_map_pallas_step_matches_unsharded`` (2-axis:
  the hierarchical halo); ``fv/full_step`` the GSPMD step with its dt
  all-reduce (``test_sharded_step_matches_single_device``, the 2-axis mesh
  tests); ``fv/reflective`` the reflective sharded step; ``fv/halo_fill_*``
  the halo fill with its corners; ``fv/bf16_wire`` the bf16 halo wire.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_ranks as R
from exahype_tpu.models import navier_stokes as jns
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import euler_physics as jax_euler_physics
from exahype_tpu.models.aderdg import euler_reflect as jax_euler_reflect
from exahype_tpu.models.aderdg import euler_reflect_flux as jax_euler_reflect_flux
from exahype_tpu.models.aderdg import make_dirichlet_fn as jax_make_dirichlet_fn
from exahype_tpu.models.aderdg import wrap_var_last
from exahype_tpu.models import euler as jax_euler
from exahype_tpu.models.fv import build_fv_rusanov_kernel as jax_fv
from exahype_tpu.parallel.grid import TpuPatchGrid as JaxTpuPatchGrid
from exahype_tpu.parallel.solver import GridSolver as JaxGridSolver
from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
from exahype_tpu_torch.models.limiter import LimitedADERDG
from exahype_tpu_torch.parallel import shard
from exahype_tpu_torch.parallel.mesh import (
    Mesh,
    init_group,
    make_mesh,
    replicated,
    run_ranks,
    state_sharding,
)
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError

torch.set_num_threads(1)

LAYOUTS = [(2,), (4,), (2, 2)]
ADERDG_1 = ["periodic", "reflective", "outflow_0", "farfield_0", "dirichlet", "viscous_walls",
            "p5"]
ADERDG_2 = ["periodic", "reflective", "outflow", "dirichlet", "viscous_walls"]
FV_1 = ["periodic", "full_step", "reflective", "halo_fill_periodic", "halo_fill_reflective"]
FV_2 = ["periodic", "full_step", "halo_fill_periodic"]
CASES = [(layout, f"aderdg/{n}") for layout in LAYOUTS[:2] for n in ADERDG_1 + ["face_fluxes"]]
CASES += [((2, 2), f"aderdg/{n}") for n in ADERDG_2 + ["face_fluxes"]]
CASES += [(layout, f"fv/{n}") for layout in LAYOUTS[:2] for n in FV_1]
CASES += [((2, 2), f"fv/{n}") for n in FV_2]
WIRE = [(layout, f"{kind}/bf16_wire") for layout in LAYOUTS for kind in ("aderdg", "fv")]
JOIN = 240.0  # seconds for a layout's ranks; a hung rank fails the fixture


@pytest.fixture(scope="module")
def ranks():
    """Each layout's per-rank results, spawned at first use."""

    @functools.lru_cache(maxsize=None)
    def run(layout):
        return run_ranks(R.rank_checks, int(np.prod(layout)), layout, device="cpu",
                         join_timeout=JOIN)

    return run


def _ids(cases):
    return [f"{'x'.join(map(str, layout))}-{name}" for layout, name in cases]


@pytest.mark.parametrize("layout,check", CASES, ids=_ids(CASES))
def test_sharded_step_is_the_unsharded_step_bitwise(ranks, layout, check):
    results = ranks(layout)
    assert len(results) == int(np.prod(layout))
    for rank, res in enumerate(results):
        assert res[check]["finite"], (rank, res[check])
        assert res[check]["bitwise"], (rank, res[check]["err"])


@pytest.mark.parametrize("layout,check", WIRE, ids=_ids(WIRE))
def test_bf16_wire_stays_within_its_bound(ranks, layout, check):
    """Only the cross-rank edge slabs are rounded to bf16: the result sits
    within bf16 rounding of the full-precision step (a wrong neighbour lands
    errors of the field's jumps), and moves off it."""
    res = ranks(layout)[0][check]
    assert res["finite"]
    assert 0 < res["err"] <= R.WIRE_ATOL


# ------------------------------------------------------------ against JAX


def jax_aderdg(name):
    cfg = R.ADERDG[name]
    grid, order, walls = R.aderdg_grid(name), cfg["order"], dict(cfg["walls"])
    if cfg.get("physics") == "navier_stokes":
        f, e, vf, ve = jns.navier_stokes(dim=3, mu=R.NS_MU, prandtl=R.NS_PRANDTL)
        walls.update(reflect_fn=jns.noslip_reflect(3), reflect_flux_fn=jns.noslip_reflect_flux(3))
        return JaxSolver(dim=3, order=order, n_vars=5, grid_shape=grid,
                         flux_fn=wrap_var_last(f), max_eigenvalue_fn=wrap_var_last(e),
                         visc_flux_fn=jns.wrap_visc_var_last(vf),
                         visc_eigenvalue_fn=wrap_var_last(ve), dx=1.0 / grid[0], **walls)
    flux, eig = jax_euler_physics(dim=3, n_real=5)
    if walls.get("boundary") == "reflective":
        walls.update(reflect_fn=jax_euler_reflect(3), reflect_flux_fn=jax_euler_reflect_flux(3))
    if walls.get("boundary") == "dirichlet":
        walls["dirichlet_fn"] = jax_make_dirichlet_fn(R.smooth_state, dim=3, order=order,
                                                      grid_shape=grid, dx=1.0 / grid[0])
    return JaxSolver(dim=3, order=order, n_vars=5, grid_shape=grid, flux_fn=flux,
                     max_eigenvalue_fn=eig, dx=1.0 / grid[0], **walls)


@functools.lru_cache(maxsize=None)
def jax_reference(check):
    """The JAX package's unsharded result of ``check`` on its input."""
    kind, name = check.split("/")
    if kind == "aderdg":
        js = jax_aderdg("periodic" if name in ("bf16_wire", "face_fluxes") else name)
        u = R.euler_state(js.state_shape, js.var_axis)
        return np.asarray(jax.jit(lambda q: js.step(q, R.DT))(jnp.asarray(u)))
    boundary = "reflective" if name.endswith("reflective") else "periodic"
    kb = jax_fv(**R.FV_WIDTH, n_patches=int(np.prod(R.FV_GRID)))

    def speed(cells):
        out = jax_euler.max_eigenvalue_tpu(cells, 0, dim=3)
        for d in (1, 2):
            out = jnp.maximum(out, jax_euler.max_eigenvalue_tpu(cells, d, dim=3))
        return out

    js = JaxGridSolver(JaxTpuPatchGrid(kb.config, R.FV_GRID, boundary=boundary), kb,
                       dx=1.0 / (4 * R.FV_GRID[0]), cfl=0.45, eigenvalue_fn=speed,
                       backend="pallas", kernel_dt="lambda", interpret=True)
    Q = jnp.asarray(R.fv_state(js.grid.state_shape))
    if name.startswith("halo_fill"):
        return np.asarray(js.grid.halo_fill(Q))
    dt = js.compute_dt(Q) if name == "full_step" else R.FV_DT
    return np.asarray(js.step(Q, dt))


JAX_CASES = [c for c in CASES if not c[1].endswith("face_fluxes")]


@pytest.mark.parametrize("layout,check", JAX_CASES, ids=_ids(JAX_CASES))
def test_sharded_step_matches_jax(ranks, layout, check):
    got = ranks(layout)[0][check]["out"]
    np.testing.assert_allclose(got, jax_reference(check), rtol=0, atol=1e-12)


@pytest.mark.parametrize("layout,check", WIRE, ids=_ids(WIRE))
def test_bf16_wire_matches_jax_within_its_bound(ranks, layout, check):
    got = ranks(layout)[0][check]["out"]
    assert np.abs(got - jax_reference(check)).max() <= R.WIRE_ATOL


def test_sharded_step_matches_jax_sharded_step(ranks):
    """The JAX package's own sharded step (its plain solver per shard under
    ``shard_map``, 4 virtual CPU devices) against the port's, gathered, on
    the same input."""
    from exahype_tpu.parallel import make_mesh as jax_make_mesh
    from exahype_tpu.parallel.shard import make_sharded_xla_aderdg_step

    js = jax_aderdg("reflective")
    u = R.euler_state(js.state_shape, js.var_axis)
    step, sharding = make_sharded_xla_aderdg_step(js, jax_make_mesh(4))
    ref = np.asarray(jax.jit(step)(jax.device_put(jnp.asarray(u), sharding), R.DT))
    got = ranks((4,))[0]["aderdg/reflective"]["out"]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


# ----------------------------------------------- K1 e's plain pair, no ranks


@pytest.mark.parametrize("name", ["periodic", "reflective", "outflow_0", "farfield_0",
                                  "outflow", "dirichlet"])
def test_exchanged_face_stage_on_windows_is_the_whole_grid(name):
    """K1 e's plain version on each window of two along each axis (walls
    gated to the windows that own them; the neighbours' rows as planes) is
    the whole grid's face stage on that window, bit for bit; with one window
    every exchange is a local copy."""
    sol = R.port_aderdg(name)
    u = torch.from_numpy(R.euler_state(sol.state_shape, sol.var_axis))
    new, faces, _ = sol.predictor_volume(u, R.DT)
    ref = sol.face_surface(new, faces, R.DT)
    for d in range(3):
        for parts in (1, 2):
            for p in range(parts):
                local, lf, ln, modes, planes = shard.window_faces(sol, faces, new, d, parts, p)
                got = shard.exchanged_face_surface(local, ln, lf, R.DT, modes, planes)
                length = sol.grid_shape[d] // parts
                assert torch.equal(got, ref.narrow(sol.grid_axis(d), p * length, length)), (
                    d, parts, p, modes)


# --------------------------------------------------------------- refusals


def _mesh(shape, names=("patches",)):
    """A rank's layout without a process group (building a step exchanges
    nothing)."""
    return Mesh(tuple(shape), tuple(names), 0, torch.device("cpu"), "gloo")


def test_refusals_name_their_reason():
    sol = R.port_aderdg("periodic")
    with pytest.raises(SemanticError, match=r"grid axis 0 \(8\) must be divisible by the mesh "
                                            r"size \(3\)"):
        shard.make_sharded_aderdg_step(sol, _mesh((3,)))
    with pytest.raises(SemanticError, match="must divide the mesh"):
        shard.make_sharded_aderdg_step_2axis(sol, _mesh((3, 2), ("ici", "dcn")), ("ici", "dcn"))
    with pytest.raises(SemanticError, match="must be divisible by mesh axis"):
        state_sharding(_mesh((3,)), sol)
    solver, kb = R.port_fv()
    with pytest.raises(SemanticError, match="divisible"):
        shard.make_sharded_cuda_step(kb, solver.grid, _mesh((3,)))
    # K1 e is compiled for 3-D Euler at order 3: other physics and orders
    # name the queue and the plain per-rank step.
    for name in ("viscous_walls", "p5"):
        with pytest.raises(LoweringError, match=r"ROADMAP.md, Queue 2 K1 e"):
            shard.make_sharded_aderdg_step(R.port_aderdg(name), _mesh((2,)))
    flux, eig = euler_physics(2, n_real=4)
    with pytest.raises(LoweringError, match="Queue 2 K1 e"):
        shard.make_sharded_aderdg_step(
            ADERDGSolver(2, 3, 4, (4, 4), flux, eig, device="cpu"), _mesh((2,)))
    # The limiter over a sharded accelerator waits on ROADMAP item 5.b.
    accel = shard.ShardedCudaADERDG(sol, _mesh((2,)))
    with pytest.raises(SemanticError, match=r"Queue 1 item 5.b"):
        LimitedADERDG(sol, troubled_capacity=4, troubled_granularity="row",
                      accelerator=accel, device="cpu")
    with pytest.raises(SemanticError, match="periodic"):
        reflective, _ = R.port_fv("reflective")
        shard.sharded_tpu_halo_fill_2axis(
            reflective.grid, torch.zeros(reflective.grid.state_shape, dtype=torch.float64),
            _mesh((1, 1), ("ici", "dcn")), ("ici", "dcn"))
    with pytest.raises(SemanticError, match="no counterpart"):
        replicated(_mesh((2,)))
    with pytest.raises(SemanticError, match="initialised process group"):
        make_mesh(2)
    with pytest.raises(SemanticError, match="NCCL backend exchanges CUDA tensors"):
        init_group(0, 1, "file:///nonexistent", backend="nccl", device="cpu")
    with pytest.raises(SemanticError, match="edge shift"):
        shard._edge_shift(torch.zeros(3), 2, 0, _mesh((1,)), "patches")


def test_a_hung_or_failing_rank_fails_the_run():
    with pytest.raises(TimeoutError, match="did not finish within"):
        run_ranks(R.hang, 2, device="cpu", join_timeout=8.0)
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        run_ranks(R.fail, 2, device="cpu", join_timeout=60.0)
