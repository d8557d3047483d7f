"""The sharded steps' checks as each rank runs them, and the configurations
they share with the tests that compare them with the JAX package.

JAX-free: the ranks are spawned processes (``parallel/mesh.py::run_ranks``)
that import this module and the port only.  :func:`rank_checks` runs every
check of one mesh layout on the CPU over gloo and returns, per check, whether
the gathered sharded result is the port's unsharded step bit for bit (or,
for the bf16 wire, its distance), and on rank 0 the gathered result itself,
which ``tests/test_torch_shard.py`` holds against the JAX package's
unsharded step.
"""

from __future__ import annotations

import numpy as np
import torch

from exahype_tpu_torch.models import euler
from exahype_tpu_torch.models.aderdg import (
    ADERDGSolver,
    euler_physics,
    euler_reflect,
    euler_reflect_flux,
    make_dirichlet_fn,
)
from exahype_tpu_torch.models.fv import build_fv_rusanov_kernel
from exahype_tpu_torch.models.navier_stokes import navier_stokes, noslip_reflect, noslip_reflect_flux
from exahype_tpu_torch.parallel import shard
from exahype_tpu_torch.parallel.grid import TpuPatchGrid
from exahype_tpu_torch.parallel.mesh import make_mesh
from exahype_tpu_torch.parallel.solver import GridSolver

GAMMA = 1.4
DT = 1e-3
#: The ADER-DG grid: axis 0 splits over 2 and 4 ranks, axes 0 and 1 over
#: (2, 2).
GRID = (8, 4, 4)
FARFIELD = (1.0, 2.0, 0.0, 0.0, 1.0 / (GAMMA - 1) + 0.5 * 2.0**2)
#: The FV patch grid and widths (``chip_smoke.py``'s main path, cut).
FV_GRID = (4, 2, 2)
FV_WIDTH = dict(dim=3, patch_size=4, halo_size=1, n_real=5, n_aux=0)
FV_DT = 1e-3
NS_MU, NS_PRANDTL = 0.02, 0.7
#: The bf16 wire's bound (the JAX package's).
WIRE_ATOL = 0.05


def smooth_state(*x):
    """A smooth Euler state for Dirichlet rows (var-last NumPy)."""
    rho = 1.0 + 0.2 * np.sin(2 * np.pi * x[0]) * np.cos(np.pi * x[-1])
    vel = [0.3 + 0.1 * np.cos(2 * np.pi * x[d]) for d in range(3)]
    p = 2.0 + 0.1 * np.sin(np.pi * x[1])
    e = p / (GAMMA - 1.0) + 0.5 * rho * sum(v * v for v in vel)
    return np.stack([rho] + [rho * v for v in vel] + [e], axis=-1)


#: The ADER-DG configurations: walls (the JAX solver's keywords, hooks
#: named), order, physics.  "sharded" runs through K1 e's step, "plain"
#: through ``make_sharded_xla_aderdg_step``.
ADERDG = {
    "periodic": dict(order=3, walls={}),
    "reflective": dict(order=3, walls=dict(boundary="reflective")),
    "outflow_0": dict(order=3, walls=dict(boundary="outflow", wall_axes=(0,))),
    "farfield_0": dict(order=3, walls=dict(boundary="farfield", farfield_state=FARFIELD,
                                           wall_axes=(0,))),
    "outflow": dict(order=3, walls=dict(boundary="outflow")),
    "dirichlet": dict(order=3, walls=dict(boundary="dirichlet")),
    "viscous_walls": dict(order=2, walls=dict(boundary="reflective", wall_axes=(0, 1)),
                          physics="navier_stokes"),
    "p5": dict(order=5, walls={}, grid=(4, 2, 2)),
}


def aderdg_grid(name: str) -> tuple:
    return ADERDG[name].get("grid", GRID)


def port_aderdg(name: str, device="cpu", dtype=torch.float64) -> ADERDGSolver:
    cfg = ADERDG[name]
    grid, order, walls = aderdg_grid(name), cfg["order"], dict(cfg["walls"])
    if cfg.get("physics") == "navier_stokes":
        flux, eig, visc, visc_eig = navier_stokes(3, mu=NS_MU, prandtl=NS_PRANDTL, gamma=GAMMA)
        extra = dict(visc_flux_fn=visc, visc_eigenvalue_fn=visc_eig)
        if walls.get("boundary") == "reflective":
            walls.update(reflect_fn=noslip_reflect(3), reflect_flux_fn=noslip_reflect_flux(3))
    else:
        flux, eig = euler_physics(3)
        extra = {}
        if walls.get("boundary") == "reflective":
            walls.update(reflect_fn=euler_reflect(3), reflect_flux_fn=euler_reflect_flux(3))
        if walls.get("boundary") == "dirichlet":
            walls["dirichlet_fn"] = make_dirichlet_fn(smooth_state, dim=3, order=order,
                                                      grid_shape=grid, dx=1.0 / grid[0])
    return ADERDGSolver(3, order, 5, grid, flux, eig, dx=1.0 / grid[0], device=device,
                        dtype=dtype, **extra, **walls)


def euler_state(state_shape, var_axis: int, seed: int = 4) -> np.ndarray:
    """A seeded admissible state (random density, velocity and pressure at
    every node), float64 NumPy."""
    rng = np.random.default_rng(seed)
    no_var = state_shape[:var_axis] + state_shape[var_axis + 1:]
    rho = 1.0 + 0.2 * rng.random(no_var)
    m = [0.3 * rng.standard_normal(no_var) for _ in range(3)]
    p = 1.0 + 0.2 * rng.random(no_var)
    E = p / (GAMMA - 1.0) + 0.5 * sum(x * x for x in m) / rho
    return np.stack([rho] + m + [E], axis=var_axis)


def fv_state(shape, seed: int = 0) -> np.ndarray:
    """``__graft_entry__._example_state``'s recipe on the SoA-P state."""
    rng = np.random.default_rng(seed)
    Q = rng.uniform(0.1, 1.0, size=shape)
    Q[:, :, :, 0] += 1.0
    Q[:, :, :, 4] += 5.0
    return Q


def port_fv(boundary="periodic", mesh=None, device="cpu"):
    """The FV solver (``fv`` spec, dt as λ = dt/dx) and its kernel spec."""
    kb = build_fv_rusanov_kernel(**FV_WIDTH, n_patches=int(np.prod(FV_GRID)))
    grid = TpuPatchGrid(kb.config, FV_GRID, boundary=boundary)
    return GridSolver(grid, kb, dx=1.0 / (4 * FV_GRID[0]), cfl=0.45, eigenvalue_fn=euler.wave_speed_fn(3),
                      kernel_dt="lambda", device=device, dtype=torch.float64, mesh=mesh), kb


# ------------------------------------------------------------------ ranks


def _result(got, ref, rank, wire=False) -> dict:
    out = {"bitwise": bool(torch.equal(got, ref)),
           "err": float((got - ref).abs().max()),
           "finite": bool(torch.isfinite(got).all())}
    if wire:
        out["bitwise"] = None  # the bf16 wire rounds the edge slabs
    if rank == 0:
        out["out"] = got.numpy()
    return out


def _aderdg_checks(mesh, names, rank) -> dict:
    two = len(names) == 2
    axis = names if two else names[0]
    make = shard.make_sharded_aderdg_step_2axis if two else shard.make_sharded_aderdg_step
    plain = ["viscous_walls"] + ([] if two else ["p5"])
    sharded = (["periodic", "reflective", "outflow", "dirichlet"] if two
               else ["periodic", "reflective", "outflow_0", "farfield_0", "dirichlet"])
    out = {}
    for name in sharded + plain:
        sol = port_aderdg(name)
        u = torch.from_numpy(euler_state(sol.state_shape, sol.var_axis))
        ref = sol.step(u, DT)
        if name in plain:
            step, sh = shard.make_sharded_xla_aderdg_step(sol, mesh, axis)
        else:
            step, sh = make(sol, mesh, axis)
        out[f"aderdg/{name}"] = _result(sh.gather(step(sh.shard(u), DT)), ref, rank)
        if name == "periodic":
            flux_step, _ = make(sol, mesh, axis, return_face_fluxes=True)
            got, fluxes = flux_step(sh.shard(u), DT)
            ref_new, ref_fluxes = sol.step(u, DT, return_face_fluxes=True)
            same = all(torch.equal(gather_fluxes(sh, f), r) for f, r in zip(fluxes, ref_fluxes))
            out["aderdg/face_fluxes"] = {"bitwise": same and bool(torch.equal(
                sh.gather(got), ref_new)), "err": 0.0, "finite": True}
            wire_step, _ = make(sol, mesh, axis, wire_dtype=torch.bfloat16)
            out["aderdg/bf16_wire"] = _result(sh.gather(wire_step(sh.shard(u), DT)), ref, rank,
                                              wire=True)
    return out


def gather_fluxes(sharding, flux):
    """Gather one axis's face fluxes (``face_flux_shape``: the grid axes one
    slot before the state's)."""
    import dataclasses

    moved = dataclasses.replace(sharding, tensor_axes=tuple(a - 1 for a in sharding.tensor_axes))
    return moved.gather(flux)


def _fv_checks(mesh, names, rank) -> dict:
    two = len(names) == 2
    axis = names if two else names[0]
    make = shard.make_sharded_cuda_step_2axis if two else shard.make_sharded_cuda_step
    out = {}
    fill = shard.sharded_tpu_halo_fill_2axis if two else shard.sharded_tpu_halo_fill
    for boundary in ("periodic",) if two else ("periodic", "reflective"):
        solver, kb = port_fv(boundary)
        Q = torch.from_numpy(fv_state(solver.grid.state_shape))
        # The halo fill alone, corners included (the spec reads no corner).
        step, sh = make(kb, solver.grid, mesh, axis)
        out[f"fv/halo_fill_{boundary}"] = _result(
            sh.gather(fill(step.local_grid, sh.shard(Q), mesh, axis)),
            solver.grid.halo_fill(Q.clone()), rank)
        ref = solver.step(Q.clone(), FV_DT)
        out[f"fv/{boundary}"] = _result(sh.gather(step(sh.shard(Q), FV_DT / solver.dx)), ref,
                                        rank)
        if boundary == "periodic":
            # The GSPMD full_step's twin: the plain function per rank and a
            # global dt (a MIN all-reduce).
            gsolver, _ = port_fv(boundary, mesh=mesh)
            pstep, _ = make(kb, solver.grid, mesh, axis, plain=True)
            q = sh.shard(Q)
            dt = gsolver.compute_dt(q)
            ref_dt = solver.compute_dt(Q)
            ref_full = solver.step(Q.clone(), ref_dt)
            res = _result(sh.gather(pstep(q, dt / solver.dx)), ref_full, rank)
            res["bitwise"] = res["bitwise"] and bool(torch.equal(dt, ref_dt))
            out["fv/full_step"] = res
            wstep, _ = make(kb, solver.grid, mesh, axis, wire_dtype=torch.bfloat16)
            out["fv/bf16_wire"] = _result(sh.gather(wstep(sh.shard(Q), FV_DT / solver.dx)),
                                          ref, rank, wire=True)
    return out


def rank_checks(rank: int, world: int, layout: tuple) -> dict:
    """Every check of one mesh layout, on this rank (CPU, gloo)."""
    torch.set_num_threads(1)
    names = ("patches",) if len(layout) == 1 else ("ici", "dcn")
    mesh = make_mesh(shape=layout, axis_names=names, device="cpu")
    out = _aderdg_checks(mesh, names, rank)
    out.update(_fv_checks(mesh, names, rank))
    return out


def hang(rank: int, world: int) -> int:
    """Rank 1 hangs (``run_ranks``'s join limit must end the run)."""
    if rank == 1:
        import time

        time.sleep(120)
    return rank


def fail(rank: int, world: int) -> int:
    """Rank 1 raises."""
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank
