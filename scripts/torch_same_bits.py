#!/usr/bin/env python3
"""Whether two checkouts' ADER-DG kernels give the same bits and the same
machine code (GPU).

    python3 scripts/torch_same_bits.py OTHER_CHECKOUT [--out DIR]

Runs ``exahype_tpu_torch``'s ``CudaADERDG`` kernels of this checkout and of
``OTHER_CHECKOUT`` (each in a process of its own, importing the port from
its own root and building its own ``csrc/``) on the same inputs and
compares their outputs bit for bit:

- the Euler kernels: ``bench.py``'s state recipe at ``(8, 4, 32)`` in
  float64 and float32 and at ``(256, 8, 128)`` in float32, dt under the CFL
  limit: ``aderdg_predictor_volume``'s ``new`` and ``faces``, the face
  stage's ``new`` with its face fluxes, and three chained steps, periodic
  and, with the order-3 wall pair, in a reflective box and a farfield
  channel on axis 0;
- K1 c's order-generic Euler instances (``csrc/aderdg_st.cuh`` and the face
  stage at n = 5, 6, 8) on the noisy density wave of ``tests/
  test_torch_cuda.py::_st_setup`` at a float64 and a float32 grid: the
  predictor's ``new`` and ``faces`` and three chained steps, periodic and
  in a reflective box; order 5 periodic is compared, orders 4 and 7 and
  the walled pairs are reported as new against a checkout without them;
- the 38-variable Z4 kernels (``aderdg_*_z4`` and K5's ``rhs_all_z4``):
  the gauge wave of amplitude 0.1 with seeded noise of 1e-3 on every slot
  at ``(8, 4, 16)`` in float64 and float32 and at ``(16, 16, 128)`` in
  float32, dx = 1/128, dt = 1e-4: the predictor's ``new`` and ``faces``,
  the face flux's F̂ and NCP halves, three chained steps, and K5 on the
  first Picard call of a step;
- the 53-variable shifted Z4 kernels (the Gamma-driver, f_b = 0.75, η = 1,
  and K5 c's ``rhs_all_z4_shift``) the same way on the moving gauge wave
  (v = 0.2, amplitude 0.1, the same noise);
- the 43-variable Z4+GRHD kernels (K1 d's conservative-flux variant over
  ``Z4Matter`` and K5 d's ``rhs_all_z4_matter``) on the perturbed FLRW
  state of ``chip_smoke.py``'s matter path with the same noise;
- the 47-variable Z4+GRMHD kernels (the same variant over ``Z4Grmhd`` and
  K5 e's ``rhs_all_z4_grmhd``), where the checkout has them, on the
  magnetized wave of ``chip_smoke.py``'s GRMHD path with the same noise:
  outputs a checkout without them lacks are reported as new, not as
  differences;
- the CK kernels (K2, ``aderdg_ck_predictor_volume``, and the face stage's
  elastic variant): ``bench_ck``'s two-layer state with seeded noise of
  1e-3 on the 9 wave rows at ``(8, 4, 32)`` in float64 and float32 and at
  ``(64, 4, 32)`` in float32, dt = 2e-4: the predictor's ``new`` and
  ``faces``, three chained steps periodic and with the free surface on
  axis 2, and, where the checkout has it, the same with the absorbing
  sponge of ``examples/seismic3d_layered.py`` (K2 a,
  ``aderdg_ck_predictor_volume_sponge``), reported as new against a
  checkout without it;
- where the checkout has them, K2 b.1's instances (the 2-D heterogeneous
  and curvilinear elasticity, the 12-variable heterogeneous one at order 2)
  on seeded states at a float64 and a float32 grid each: the predictor's
  ``new`` and ``faces`` and three chained steps, reported as new against a
  checkout without them;
- where the checkout has them, K1 e (``aderdg_face_flux_exchanged``, the
  sharded face flux, on the Euler cases' faces in two windows along axis 0:
  F̂ and the updated state) and K5 b (``rhs_all_z4_2d``, the first Picard
  call on the 2-D gauge wave with the same noise at ``(8, 6)`` in float64
  and ``(64, 32)`` in float32), reported as new against a checkout without
  them;
- where the checkout has them, K1 d's per-axis predictor (3-D p2) and the
  2-D vacuum Z4 steps at orders 2 and 3, fused and per-axis (``K1 d
  forms``: the noisy gauge wave at ``(8, 4, 16)`` and ``(8, 6)`` in float64
  and ``(16, 16, 128)`` and ``(64, 32)`` in float32: the predictor's
  ``new`` and ``faces``, the face flux's F̂ and NCP halves, three chained
  steps), reported as new against a checkout without them;
- where the checkout has them, the Z4+GRHD system's per-axis predictor (3-D
  p2) and its 2-D step at order 2, fused and per-axis (``K1 d matter
  forms``: the state of ``tests/test_torch_cuda.py::_z4m_form_setup`` at
  ``(8, 4, 16)`` and ``(8, 6)`` in float64 and ``(16, 16, 128)`` and ``(64,
  32)`` in float32, the same outputs), and K5 b's Z4+GRHD instance
  (``rhs_all_z4_matter_2d``, ``K5 b matter``: the first Picard call of the
  2-D fused step on that state), reported as new against a checkout
  without them;
- where the checkout has them, the Z4+GRMHD system's per-axis predictor (3-D
  p2) and its 2-D step at order 2, fused and per-axis (``K1 d grmhd
  forms``: the state of ``tests/test_torch_cuda.py::_z4g_form_setup`` at
  the same grids, the same outputs), and K5 b's Z4+GRMHD instance
  (``rhs_all_z4_grmhd_2d``, ``K5 b grmhd``: the first Picard call of the
  2-D fused step on that state), reported as new against a checkout
  without them;
- where the checkout has them, the shifted system's per-axis predictor
  (3-D p2) and its 2-D step at order 2, fused and per-axis (``K1 d shift
  forms``: the state of ``tests/test_torch_cuda.py::_z4s_form_setup``, the
  Gamma-driver, at the same grids, the same outputs), and K5 b's shifted
  instance (``rhs_all_z4_shift_2d``, ``K5 b shift``: the first Picard call
  of the 2-D fused step on that state), reported as new against a checkout
  without them;
- the limiter's subcell sweep K3 (``subcell_row_sweep``, 3-D p3 Euler) on
  a seeded gathered batch ``[7, 7, 7, 5, 8, 16]`` with 5 of 8 slots active,
  each direction, in float64 and float32, and where the checkout has it K3
  a's Z4+GRHD p2 instance (``subcell_row_sweep_z4_matter``) on the card
  tests' noisy batch (``tests/torch_z4m_batch.py``), reported as new
  against a checkout without it.

Then it disassembles both libraries (``cuobjdump -sass``) and compares the
instructions of every kernel the two have in common (matched by name, value
type, the first integer template argument, which is the node count of the
ADER-DG kernels of ``csrc/aderdg.cu``, and for the Z4 step's kernels the
system, ``Z4Vacuum``, ``Z4Shift``, ``Z4Matter`` or ``Z4Grmhd``, and their
cell and branch where it is not the 3-D fused one (``Z4Cell<2, N>``, the
per-axis predictor: those are new), whatever template arguments were added
since; K2 a, the CK predictor's
``SpongeSource`` instance, K2 b's ``Elastic3D``/``Elastic2D`` instances and
the heterogeneous elasticity's ``ElasticHetPhysics`` instances by that
argument), ignoring addresses and encodings; K2 b.1's instances (over
``ElasticHet2D`` and ``CurvilinearElastic``, and over
``ElasticHetPhysics`` at n = 3) are listed as new, and so are the
kernels of the Z4+GRMHD system and of the order-4, -5 and -7 Euler steps
(the face stage at n = 5, 6 and 8, periodic and walled, and
``aderdg_predictor_volume_st``) and of the 2-D Euler
step (``csrc/aderdg_2d.cu``, periodic and walled) and the 2-D kernels'
``NavierStokes2D`` instances (the viscous predictor, the face flux; at
order 2, n = 3, with the update) and ``NavierStokesWalls2D`` instances (the
walled viscous predictor and face flux) that only this checkout has are
listed as new.  Prints one line per output and per kernel
and exits non-zero if any differs.  Needs a CUDA card and nvcc; imports no
JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parent.parent
CASES = (((8, 4, 32), "float64"), ((8, 4, 32), "float32"), ((256, 8, 128), "float32"))
DT = 5e-5  # under the CFL limit (6.26e-5) of this state at dx = 1/256
Z4_CASES = (((8, 4, 16), "float64"), ((8, 4, 16), "float32"), ((16, 16, 128), "float32"))
CK_CASES = (((8, 4, 32), "float64"), ((8, 4, 32), "float32"), ((64, 4, 32), "float32"))
#: The kernels whose machine code is compared: the Euler ones, K5's four
#: instances and the Z4 steps' (``<length><name>If`` or ``...Id`` in the
#: mangled name, after the anonymous namespace's prefix).
SASS_KERNELS = (
    "aderdg_predictor_volume", "aderdg_face_flux", "aderdg_surface_update",
    "aderdg_predictor_volume_z4", "aderdg_face_flux_z4", "aderdg_surface_update_z4",
    "rhs_all_z4", "rhs_all_z4_shift", "rhs_all_z4_matter", "rhs_all_z4_grmhd",
    "aderdg_predictor_volume_st", "aderdg_predictor_volume_2d", "aderdg_face_flux_2d",
    "aderdg_surface_update_2d", "subcell_row_sweep", "subcell_row_sweep_ncp",
    "aderdg_ck_predictor_volume", "aderdg_ck_predictor_nodes", "aderdg_face_flux_exchanged",
    "rhs_all_z4_2d", "aderdg_face_flux_walls", "aderdg_surface_update_walls",
    "rhs_all_z4_matter_2d", "rhs_all_z4_grmhd_2d", "rhs_all_z4_shift_2d",
)
#: The Z4 step kernels' systems, the 2-D Navier–Stokes physics, the CK
#: predictor's sponge and K2 b's homogeneous elasticity (a template argument
#: of each instance).
SYSTEMS = ("Z4Vacuum", "Z4Shift", "Z4Matter", "Z4Grmhd", "NavierStokes2D", "SpongeSource",
           "Elastic3D", "Elastic2D", "ElasticHetPhysics", "ElasticHet2D", "CurvilinearElastic",
           "NavierStokesWalls2D")
#: What only this checkout may have: the Z4+GRMHD system's kernels, the
#: order-5 Euler step's (its predictor, and the face stage's kernels whose
#: node count is ``NEW_NODES``), the 2-D Euler step's and K2 b's (the CK
#: predictor a thread a node, the face stages over the homogeneous
#: elasticity).
NEW = ("Z4Grmhd", "rhs_all_z4_grmhd", "Z4+GRMHD", "aderdg_predictor_volume_st",
       "aderdg_predictor_volume_2d", "aderdg_face_flux_2d", "aderdg_surface_update_2d",
       "NavierStokes2D", "subcell_row_sweep_ncp", "K3 a Z4+GRHD", "SpongeSource",
       "CK sponge", "Elastic3D", "Elastic2D", "aderdg_ck_predictor_nodes", "ElasticHet2D",
       "CurvilinearElastic", "K2 b.1", "aderdg_face_flux_exchanged", "K1 e",
       "rhs_all_z4_2d", "K5 b", "K1 c order 4", "K1 c order 7", "K1 c walled",
       "K1 d forms", "rhs_all_z4_matter_2d", "K1 d matter forms", "K5 b matter",
       "rhs_all_z4_grmhd_2d", "K1 d grmhd forms", "K5 b grmhd", "rhs_all_z4_shift_2d",
       "K1 d shift forms", "K5 b shift", "NavierStokesWalls2D")
#: The node counts of the face stage's Euler-only instances (orders 4, 5,
#: 7); the walled pair was instantiated at order 3 only before.
NEW_NODES = ("5", "6", "8")
#: K2 b.1's instances over the 12-variable heterogeneous elasticity at n = 3
#: (the node kernel and the face stage; its n = 4 instances are compared):
#: (kernel, system, first integer template argument).
NEW_INSTANCES = {(name, "ElasticHetPhysics", "3") for name in (
    "aderdg_ck_predictor_nodes", "aderdg_face_flux", "aderdg_surface_update")}
#: The cell and branch of a Z4 step kernel (``csrc/aderdg_z4.cuh``'s ``Z4Cell<DIM,
#: N>`` and the predictor's ``kPerAxis``), where its name carries them.
_Z4_FORM = re.compile(r"Z4CellILi(\d+)ELi(\d+)EEE(Lb1E)?")
_KERNEL_NAME = re.compile(r"(\d+)(" + "|".join(sorted(SASS_KERNELS, key=len, reverse=True))
                          + r")I([fd])(?:Li(\d+)E)?")

_CHILD = r"""
import sys
root, out = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np
import torch
from exahype_tpu_torch import _build
from exahype_tpu_torch.models.aderdg import (
    ADERDGSolver,
    euler_physics,
    euler_reflect,
    euler_reflect_flux,
)
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
from exahype_tpu_torch.models.z4 import (
    gauge_wave_state,
    make_z4_shift_solver,
    make_z4_solver,
    moving_gauge_wave_state,
)
from exahype_tpu_torch.models import z4_matter
try:
    from exahype_tpu_torch.models import z4_grmhd
except ImportError:  # a checkout from before the Z4+GRMHD system
    z4_grmhd = None
import exahype_tpu_torch
assert exahype_tpu_torch.__file__.startswith(root), exahype_tpu_torch.__file__
results = {"library": str(_build.library_path())}
for grid, dtype in CASES:
    dtype = getattr(torch, dtype)
    flux, eig = euler_physics(3)
    sol = ADERDGSolver(3, 3, 5, grid, flux, eig, dx=1.0 / 256, device="cuda", dtype=dtype)
    cu = CudaADERDG(sol)
    rng = np.random.default_rng(0)
    rho = 1.0 + 0.2 * rng.random((4, 4, 4) + grid)
    q = np.stack([rho, rho, 0.5 * rho, 0.25 * rho, 5.0 + 0.5 * rho * 1.3125], axis=3)
    u = torch.from_numpy(q).to("cuda", dtype).contiguous()
    new, faces = cu.predictor_volume(u, DT)[:2]  # older checkouts return two
    surf, fl = cu.face_surface(new.clone(), faces, DT, return_face_fluxes=True)
    key = f"{grid} {dtype}"
    results[key + " predictor new"] = new.cpu()
    results[key + " predictor faces"] = faces.cpu()
    results[key + " face_surface new"] = surf.cpu()
    results[key + " face fluxes"] = torch.stack(fl).cpu()
    results[key + " 3 steps"] = cu.run(u, 3, DT).cpu()
    for label, walls in (("reflective box", dict(
            boundary="reflective", reflect_fn=euler_reflect(3),
            reflect_flux_fn=euler_reflect_flux(3))), ("farfield (0,)", dict(
            boundary="farfield", farfield_state=(1.0, 2.0, 0.0, 0.0, 1.0 / 0.4 + 2.0),
            wall_axes=(0,)))):
        wcu = CudaADERDG(ADERDGSolver(3, 3, 5, grid, flux, eig, dx=1.0 / 256, device="cuda",
                                      dtype=dtype, **walls))
        results[key + f" walls {label} 3 steps"] = wcu.run(u, 3, DT).cpu()
    if hasattr(cu, "face_flux_exchanged"):  # K1 e, the sharded face flux
        from exahype_tpu_torch.parallel import shard
        for p in range(2):
            local, lf, ln, modes, planes = shard.window_faces(sol, faces, new, 0, 2, p)
            lcu = CudaADERDG(local)
            fhat, fside = lcu.face_flux_exchanged(lf, modes, planes)
            results[key + f" K1 e window {p} fhat"] = fhat.cpu()
            results[key + f" K1 e window {p} new"] = lcu.surface_update_exchanged(
                ln.clone(), fhat, DT, fside, modes).cpu()
from exahype_tpu_torch.models.aderdg_cuda import INSTANTIATED
for order, grid, dtype in ((5, (4, 2, 8), "float64"), (5, (8, 4, 32), "float32"),
                           (4, (4, 2, 8), "float64"), (4, (8, 4, 32), "float32"),
                           (7, (2, 2, 3), "float64"), (7, (4, 2, 16), "float32")):
    if ("euler", 3, order) not in INSTANTIATED:
        continue
    dtype = getattr(torch, dtype)
    for label, walls in (("periodic", {}), ("reflective box", dict(
            boundary="reflective", reflect_fn=euler_reflect(3),
            reflect_flux_fn=euler_reflect_flux(3)))):
        if walls and f"exahype_aderdg_face_flux_walls_p{order}_f64" not in _build._SIGNATURES:
            continue  # a checkout without the walled pair at this order
        sol = ADERDGSolver(3, order, 5, grid, *euler_physics(3), dx=1.0 / grid[0],
                           device="cuda", dtype=dtype, **walls)
        cu = CudaADERDG(sol)
        phase = sum(np.asarray(c) for c in sol.nodes_meshgrid())
        no_var = sol.state_shape[:3] + sol.state_shape[4:]
        rho = np.broadcast_to(np.squeeze(1.0 + 0.2 * np.sin(2 * np.pi * phase), 3), no_var)
        rho = rho * (1.0 + 0.05 * np.random.default_rng(order).standard_normal(no_var))
        e = 2.0 / 0.4 + 0.5 * rho * (1.0 + 0.25 + 0.0625)
        q = np.stack([rho, rho, 0.5 * rho, 0.25 * rho, e], axis=3)
        u = torch.from_numpy(q).to("cuda", dtype).contiguous()
        key = f"K1 c {'walled ' if walls else ''}order {order} {label} {grid} {dtype}"
        new, faces = cu.predictor_volume(u, 2e-4)[:2]
        results[key + " predictor new"] = new.cpu()
        results[key + " predictor faces"] = faces.cpu()
        results[key + " 3 steps"] = cu.run(u, 3, 2e-4).cpu()
from exahype_tpu_torch.models import elastic
for grid, dtype in CK_CASES:
    dtype = getattr(torch, dtype)
    cases = [("periodic", {}), ("free surface", dict(
        boundary="reflective", wall_axes=(2,), reflect_fn=elastic.elastic3d_free_surface_het()[0],
        reflect_flux_fn=elastic.elastic3d_free_surface_het()[1]))]
    if hasattr(elastic, "sponge_source"):  # K2 a, this PR's checkouts on
        cases.append(("sponge", cases[1][1]))
    for label, walls in cases:
        flux, eig = elastic.elastic3d_heterogeneous()
        sol = ADERDGSolver(3, 3, 12, grid, flux, eig, dx=1.0 / grid[0], device="cuda",
                           dtype=dtype, predictor_mode="ck",
                           ck_material_slots=elastic.MATERIAL_SLOTS,
                           dissipation_mask=elastic.DISSIPATION_MASK, **walls)
        if label == "sponge":
            sol.source_fn = elastic.sponge_source(sol, width=0.3, rate=40.0, axes=(0, 1),
                                                  n_wave=9)
        cu = CudaADERDG(sol)
        q, _ = elastic.two_layer_state(sol)
        q[:, :, :, :9] += 1e-3 * np.random.default_rng(4).standard_normal(q[:, :, :, :9].shape)
        u = torch.from_numpy(q).to("cuda", dtype).contiguous()
        new, faces = cu.predictor_volume(u, 2e-4)[:2]
        key = f"CK {label} {grid} {dtype}"
        results[key + " predictor new"] = new.cpu()
        results[key + " predictor faces"] = faces.cpu()
        results[key + " 3 steps"] = cu.run(u, 3, 2e-4).cpu()
if hasattr(elastic, "elastic_heterogeneous"):  # K2 b.1, frozen slots on the node kernel
    from exahype_tpu_torch.models import curvilinear as cv
    for label, grid, dtype in (("het2d", (9, 9), "float64"), ("het2d", (64, 48), "float32"),
                               ("curvilinear", (9, 9), "float64"),
                               ("curvilinear", (64, 48), "float32"),
                               ("het3d p2", (4, 4, 8), "float64"),
                               ("het3d p2", (16, 8, 64), "float32")):
        dtype = getattr(torch, dtype)
        rng = np.random.default_rng(sum(grid))
        if label == "curvilinear":
            pair = cv.curvilinear_physics(*elastic.elastic(1.3, 2.5, 0.7), 2, 5)
            sol = ADERDGSolver(2, 3, 10, grid, *pair, dx=1.0 / grid[0], device="cuda",
                               dtype=dtype, predictor_mode="ck",
                               ck_material_slots=cv.curvilinear_material_slots(5, 2),
                               dissipation_mask=cv.curvilinear_dissipation_mask(5, 2))
            metric, _ = cv.metric_fields(sol, cv.hill_mapping(0.04))
            q = cv.densitize(torch.from_numpy(rng.standard_normal(
                sol.state_shape[:2] + (5,) + sol.state_shape[3:])), metric, 2).numpy()
        else:
            het3 = label == "het3d p2"
            sol = ADERDGSolver(
                3 if het3 else 2, 2 if het3 else 3, 12 if het3 else 8, grid,
                *(elastic.elastic3d_heterogeneous() if het3 else elastic.elastic_heterogeneous()),
                dx=1.0 / grid[0], device="cuda", dtype=dtype, predictor_mode="ck",
                ck_material_slots=elastic.MATERIAL_SLOTS if het3 else elastic.MATERIAL_SLOTS_HET,
                dissipation_mask=(elastic.DISSIPATION_MASK if het3
                                  else elastic.DISSIPATION_MASK_HET))
            q = rng.standard_normal(sol.state_shape)
            first = 9 if het3 else 5
            for k, lo in enumerate((1.0, 1.0, 0.5)):
                idx = [slice(None)] * q.ndim
                idx[sol.var_axis] = first + k
                q[tuple(idx)] = lo + rng.random(tuple(grid))
        cu = CudaADERDG(sol)
        u = torch.from_numpy(q).to("cuda", dtype).contiguous()
        dt = 0.5 * float(sol.cfl_dt(u, cfl=0.15))
        new, faces = cu.predictor_volume(u, dt)[:2]
        key = f"K2 b.1 {label} {grid} {dtype}"
        results[key + " predictor new"] = new.cpu()
        results[key + " predictor faces"] = faces.cpu()
        results[key + " 3 steps"] = cu.run(u, 3, dt).cpu()
def matter_state(sol):
    # The perturbed FLRW slice of chip_smoke.py's matter path (rho0 0.02,
    # eps0 0.4; slots 38 and 42 times 1 + 0.05 sin along axis 2).
    adot = float(np.sqrt(8 * np.pi * 0.02 * 1.4 / 3))
    u = z4_matter.flrw_state(sol, 1.0, adot, rho0=0.02, eps0=0.4)
    g2 = sol.grid_shape[2]
    pert = 1.0 + 0.05 * torch.sin(2 * np.pi * torch.arange(g2, dtype=torch.float64) / g2)
    u = u.clone()
    for slot in (38, 42):
        u[:, :, :, slot] *= pert.to(u)
    return u


systems = [("Z4", lambda grid, dtype: make_z4_solver(
               3, 2, grid, dx=1.0 / 128, impl="soa", fused_rhs="soa", device="cuda",
               dtype=dtype), lambda sol: gauge_wave_state(sol, amplitude=0.1)),
           ("shifted Z4", lambda grid, dtype: make_z4_shift_solver(
               3, 2, grid, dx=1.0 / 128, shift="gamma_driver", fused_rhs="soa", device="cuda",
               dtype=dtype), lambda sol: moving_gauge_wave_state(sol, v=0.2, amplitude=0.1))]
systems.append(("Z4+GRHD", lambda grid, dtype: z4_matter.make_z4_matter_solver(
    3, 2, grid, dx=1.0 / 128, slicing="harmonic", f=0.0, fused_rhs="soa", device="cuda",
    dtype=dtype), matter_state))
if z4_grmhd is not None:
    systems.append(("Z4+GRMHD", lambda grid, dtype: z4_grmhd.make_z4_grmhd_solver(
        3, 2, grid, dx=1.0 / 128, slicing="harmonic", f=0.0, glm_kappa=0.5, fused_rhs="soa",
        device="cuda", dtype=dtype), lambda sol: z4_grmhd.magnetized_wave_state(sol)))
for (grid, dtype), (system, make, state) in (
        (case, system) for system in systems for case in Z4_CASES):
    dtype = getattr(torch, dtype)
    sol = make(grid, dtype)
    cu = CudaADERDG(sol)
    u = state(sol)
    noise = torch.from_numpy(np.random.default_rng(5).standard_normal(u.shape)).to(u)
    u = (u + 1e-3 * noise).contiguous()
    new, faces = cu.predictor_volume(u, 1e-4)[:2]
    fhat, fhalf = cu.face_flux(faces)
    key = f"{system} {grid} {dtype}"
    results[key + " predictor new"] = new.cpu()
    results[key + " predictor faces"] = faces.cpu()
    results[key + " face flux fhat"] = fhat.cpu()
    results[key + " face flux fhalf"] = fhalf.cpu()
    results[key + " 3 steps"] = cu.run(u, 3, 1e-4).cpu()
    calls = []
    rec = with_cuda_rhs(sol)
    k5 = rec.rhs_all_fn
    def first(Q, grads, va):
        if not calls:
            calls.append(k5(Q, grads, va))
        return sol.rhs_all_fn(Q, grads, va)
    rec.rhs_all_fn = first
    rec.predictor_volume(u, 1e-4)
    results[key + f" {k5.kernel} Picard call 1"] = calls[0].cpu()
if "exahype_rhs_all_z4_2d_f64" in _build._SIGNATURES:  # K5 b, the 2-D vacuum Z4 instance
    for grid, dtype in (((8, 6), torch.float64), ((64, 32), torch.float32)):
        sol = make_z4_solver(2, 2, grid, dx=1.0 / grid[0], kappa1=0.5, kappa2=0.1,
                             impl="soa", fused_rhs="soa", device="cuda", dtype=dtype)
        k5 = with_cuda_rhs(sol).rhs_all_fn
        u = gauge_wave_state(sol, amplitude=0.1)
        noise = torch.from_numpy(np.random.default_rng(5).standard_normal(u.shape)).to(u)
        u = (u + 1e-3 * noise).contiguous()
        calls = []
        rec = with_cuda_rhs(sol)
        def first(Q, grads, va):
            if not calls:
                calls.append(k5(Q, grads, va))
            return sol.rhs_all_fn(Q, grads, va)
        rec.rhs_all_fn = first
        rec.predictor_volume(u, 1e-4)
        results[f"K5 b {grid} {dtype} {k5.kernel} Picard call 1"] = calls[0].cpu()
from exahype_tpu_torch.models.aderdg_cuda import INSTANTIATED
if ("z4", 2, 2) in INSTANTIATED:  # K1 d's per-axis branch and the 2-D vacuum steps
    for dim, order, fused, grid, dtype in (
            (3, 2, False, (8, 4, 16), torch.float64), (3, 2, False, (16, 16, 128), torch.float32),
            *((2, order, fused, grid, dtype) for order in (2, 3) for fused in (False, "soa")
              for grid, dtype in (((8, 6), torch.float64), ((64, 32), torch.float32)))):
        sol = make_z4_solver(dim, order, grid, dx=1.0 / 128, impl="soa", fused_rhs=fused,
                             device="cuda", dtype=dtype)
        cu = CudaADERDG(sol)
        u = gauge_wave_state(sol, amplitude=0.1)
        noise = torch.from_numpy(np.random.default_rng(5).standard_normal(u.shape)).to(u)
        u = (u + 1e-3 * noise).contiguous()
        new, faces = cu.predictor_volume(u, 1e-4)[:2]
        fhat, fhalf = cu.face_flux(faces)
        key = f"K1 d forms {dim}-D p{order} fused_rhs={fused} {grid} {dtype}"
        results[key + " predictor new"] = new.cpu()
        results[key + " predictor faces"] = faces.cpu()
        results[key + " face flux fhat"] = fhat.cpu()
        results[key + " face flux fhalf"] = fhalf.cpu()
        results[key + " 3 steps"] = cu.run(u, 3, 1e-4).cpu()
def matter_noisy(sol):
    # tests/test_torch_cuda.py::_z4m_form_setup's state.
    va = sol.var_axis
    shape = sol.state_shape[:va] + sol.state_shape[va + 1:]
    rng = np.random.default_rng(5)
    z4 = 1e-3 * rng.standard_normal(shape + (38,))
    z4[..., [0, 1, 4, 6]] += 1.0
    z4[..., [7, 10, 12]] -= 0.48
    rho = 0.02 * (1.0 + 0.1 * rng.random(shape))
    p = 0.008 * (1.0 + 0.1 * rng.random(shape))
    v = 0.3 * (rng.random(shape + (3,)) - 0.5)
    q = z4_matter.pack_matter(*(torch.from_numpy(x) for x in (z4, rho, v, p)))
    return q.movedim(-1, va).to(sol.weights.device, sol.weights.dtype).contiguous()
if ("z4_matter", 2, 2) in INSTANTIATED:  # the Z4+GRHD per-axis branch and 2-D step, K5 b
    for dim, fused, grid, dtype in (
            (3, False, (8, 4, 16), torch.float64), (3, False, (16, 16, 128), torch.float32),
            *((2, fused, grid, dtype) for fused in (False, "soa")
              for grid, dtype in (((8, 6), torch.float64), ((64, 32), torch.float32)))):
        sol = z4_matter.make_z4_matter_solver(dim, 2, grid, dx=1.0 / 128, fused_rhs=fused,
                                              device="cuda", dtype=dtype)
        cu = CudaADERDG(sol)
        u = matter_noisy(sol)
        new, faces = cu.predictor_volume(u, 1e-4)[:2]
        fhat, fhalf = cu.face_flux(faces)
        key = f"K1 d matter forms {dim}-D p2 fused_rhs={fused} {grid} {dtype}"
        results[key + " predictor new"] = new.cpu()
        results[key + " predictor faces"] = faces.cpu()
        results[key + " face flux fhat"] = fhat.cpu()
        results[key + " face flux fhalf"] = fhalf.cpu()
        results[key + " 3 steps"] = cu.run(u, 3, 1e-4).cpu()
        if dim == 2 and fused:
            calls = []
            rec = with_cuda_rhs(sol)
            k5 = rec.rhs_all_fn
            def first(Q, grads, va):
                if not calls:
                    calls.append(k5(Q, grads, va))
                return sol.rhs_all_fn(Q, grads, va)
            rec.rhs_all_fn = first
            rec.predictor_volume(u, 1e-4)
            results[f"K5 b matter {grid} {dtype} {k5.kernel} Picard call 1"] = calls[0].cpu()
def grmhd_noisy(sol):
    # tests/test_torch_cuda.py::_z4g_form_setup's state.
    va = sol.var_axis
    shape = sol.state_shape[:va] + sol.state_shape[va + 1:]
    rng = np.random.default_rng(5)
    z4 = 1e-3 * rng.standard_normal(shape + (38,))
    z4[..., [0, 1, 4, 6]] += 1.0
    rho = 1.0 + 0.1 * rng.random(shape)
    p = 1.0 + 0.1 * rng.random(shape)
    v = 0.3 * (rng.random(shape + (3,)) - 0.5)
    B = 0.05 * (1.0 + rng.random(shape + (3,)))
    psi = 0.01 * rng.standard_normal(shape)
    q = z4_grmhd.pack_matter_mhd(*(torch.from_numpy(x) for x in (z4, rho, v, p, B)),
                                 psi_glm=torch.from_numpy(psi))
    return q.movedim(-1, va).to(sol.weights.device, sol.weights.dtype).contiguous()
if ("z4_grmhd", 2, 2) in INSTANTIATED:  # the Z4+GRMHD per-axis branch and 2-D step, K5 b
    from exahype_tpu_torch.models import z4_grmhd
    for dim, fused, grid, dtype in (
            (3, False, (8, 4, 16), torch.float64), (3, False, (16, 16, 128), torch.float32),
            *((2, fused, grid, dtype) for fused in (False, "soa")
              for grid, dtype in (((8, 6), torch.float64), ((64, 32), torch.float32)))):
        sol = z4_grmhd.make_z4_grmhd_solver(dim, 2, grid, dx=1.0 / 128, fused_rhs=fused,
                                            slicing="harmonic", f=0.0, glm_kappa=0.5,
                                            device="cuda", dtype=dtype)
        cu = CudaADERDG(sol)
        u = grmhd_noisy(sol)
        new, faces = cu.predictor_volume(u, 1e-4)[:2]
        fhat, fhalf = cu.face_flux(faces)
        key = f"K1 d grmhd forms {dim}-D p2 fused_rhs={fused} {grid} {dtype}"
        results[key + " predictor new"] = new.cpu()
        results[key + " predictor faces"] = faces.cpu()
        results[key + " face flux fhat"] = fhat.cpu()
        results[key + " face flux fhalf"] = fhalf.cpu()
        results[key + " 3 steps"] = cu.run(u, 3, 1e-4).cpu()
        if dim == 2 and fused:
            calls = []
            rec = with_cuda_rhs(sol)
            k5 = rec.rhs_all_fn
            def first(Q, grads, va):
                if not calls:
                    calls.append(k5(Q, grads, va))
                return sol.rhs_all_fn(Q, grads, va)
            rec.rhs_all_fn = first
            rec.predictor_volume(u, 1e-4)
            results[f"K5 b grmhd {grid} {dtype} {k5.kernel} Picard call 1"] = calls[0].cpu()
if ("z4_shift", 2, 2) in INSTANTIATED:  # the shifted per-axis branch and 2-D step, K5 b
    for dim, fused, grid, dtype in (
            (3, False, (8, 4, 16), torch.float64), (3, False, (16, 16, 128), torch.float32),
            *((2, fused, grid, dtype) for fused in (False, "soa")
              for grid, dtype in (((8, 6), torch.float64), ((64, 32), torch.float32)))):
        sol = make_z4_shift_solver(dim, 2, grid, dx=1.0 / 128, fused_rhs=fused,
                                   shift="gamma_driver", device="cuda", dtype=dtype)
        cu = CudaADERDG(sol)
        # tests/test_torch_cuda.py::_z4s_form_setup's state.
        u = moving_gauge_wave_state(sol, v=0.2, amplitude=0.1)
        noise = np.random.default_rng(5).standard_normal(u.shape)
        u = (u + 1e-3 * torch.from_numpy(noise).to(u)).contiguous()
        new, faces = cu.predictor_volume(u, 1e-4)[:2]
        fhat, fhalf = cu.face_flux(faces)
        key = f"K1 d shift forms {dim}-D p2 fused_rhs={fused} {grid} {dtype}"
        results[key + " predictor new"] = new.cpu()
        results[key + " predictor faces"] = faces.cpu()
        results[key + " face flux fhat"] = fhat.cpu()
        results[key + " face flux fhalf"] = fhalf.cpu()
        results[key + " 3 steps"] = cu.run(u, 3, 1e-4).cpu()
        if dim == 2 and fused:
            calls = []
            rec = with_cuda_rhs(sol)
            k5 = rec.rhs_all_fn
            def first(Q, grads, va):
                if not calls:
                    calls.append(k5(Q, grads, va))
                return sol.rhs_all_fn(Q, grads, va)
            rec.rhs_all_fn = first
            rec.predictor_volume(u, 1e-4)
            results[f"K5 b shift {grid} {dtype} {k5.kernel} Picard call 1"] = calls[0].cpu()
from exahype_tpu_torch.models import subcell_cuda
from exahype_tpu_torch.models.limiter import LimitedADERDG
def batch(shape, seed, nvar):
    if nvar == 43:  # the Z4+GRHD batch of the card tests
        sys.path.insert(0, root + "/tests")
        from torch_z4m_batch import z4m_gathered_batch
        return z4m_gathered_batch(shape, seed)
    rng = np.random.default_rng(seed)
    lead = shape[:3] + shape[4:]
    q = np.stack([1.0 + 0.3 * rng.random(lead)]
                 + [0.4 * rng.standard_normal(lead) for _ in range(3)]
                 + [2.5 + rng.random(lead)], axis=3)
    return torch.from_numpy(q)
sweeps = [("K3 Euler sweep", 7, 5, lambda dtype: ADERDGSolver(
    3, 3, 5, (4, 2, 8), *euler_physics(3), dx=1.0 / 256, device="cuda", dtype=dtype))]
if "subcell_row_sweep_z4_matter" in getattr(subcell_cuda, "KERNELS", {}).values():
    sweeps.append(("K3 a Z4+GRHD sweep", 5, 43, lambda dtype: z4_matter.make_z4_matter_solver(
        3, 2, (4, 2, 8), dx=1.0 / 128, slicing="harmonic", f=0.0, fused_rhs="soa",
        device="cuda", dtype=dtype)))
for label, n_sub, nvar, make in sweeps:
    for dtype in (torch.float64, torch.float32):
        sol = make(dtype)
        lim = LimitedADERDG(sol, troubled_capacity=8, troubled_granularity="row",
                            device=sol.weights.device)
        shape = (n_sub, n_sub, n_sub, nvar, 8, 16)
        s = batch(shape, 7, nvar).to("cuda", dtype).contiguous()
        for d in range(3):
            gshape = list(shape)
            gshape[d] = 1
            lo, hi = (batch(tuple(gshape), 10 * k + d, nvar).to("cuda", dtype).contiguous()
                      for k in (1, 2))
            got = subcell_cuda.row_sweep_call(lim, d, s.clone(), lo, hi, 5e-5,
                                              torch.tensor(5, device="cuda"))
            for what, x in zip(("s", "g_lo", "g_hi"), got):
                results[f"{label} {dtype} d={d} {what}"] = x.cpu()
torch.save(results, out)
"""


def run(root: pathlib.Path, out: pathlib.Path) -> dict:
    import torch

    code = (f"CASES = {CASES!r}\nDT = {DT!r}\nZ4_CASES = {Z4_CASES!r}\n"
            f"CK_CASES = {CK_CASES!r}\n" + _CHILD)
    subprocess.run([sys.executable, "-c", code, str(root), str(out)], check=True)
    return torch.load(out)


def sass(library: str) -> dict:
    """``{(kernel, value type, system, first integer template argument,
    form, k): [instruction, ...]}`` of the kernels of :data:`SASS_KERNELS` in
    ``library`` (system: the Z4 step kernels' :data:`SYSTEMS` template
    argument, else ""; the integer "" if there is none; form: a Z4 step
    kernel's cell and branch other than the 3-D fused one, else ""; k
    numbers the instances of one kernel, value type, system, integer and
    form in the order of their mangled names): each instruction's text
    without its address and encoding."""
    sys.path.insert(0, str(HERE))
    from exahype_tpu_torch import _build

    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    found, code = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            m = _KERNEL_NAME.search(fn)
            code = None
            if m and m.group(1).endswith(str(len(m.group(2)))):
                system = next((s for s in SYSTEMS if s in fn), "")
                form = _Z4_FORM.search(fn)
                form = "" if form is None or form.groups() == ("3", "3", None) else (
                    f"{form.group(1)}-D n={form.group(2)}"
                    + (" per-axis" if form.group(3) else ""))
                key = (m.group(2), m.group(3), system, m.group(4) or "", form)
                code = found.setdefault(key, {}).setdefault(fn, [])
            continue
        if code is None or "/*" not in line or ";" not in line:
            continue
        code.append(line.split("*/", 1)[1].split(";")[0].strip())
    return {(*key, k): fns[fn] for key, fns in found.items() for k, fn in enumerate(sorted(fns))}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=pathlib.Path, help="root of the other checkout")
    parser.add_argument("--out", type=pathlib.Path, help="where to keep the outputs")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_same_bits: no CUDA card")
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or pathlib.Path(tmp)
        out.mkdir(parents=True, exist_ok=True)
        mine = run(HERE, out / "this.pt")
        theirs = run(args.other.resolve(), out / "other.pt")
    same = True
    for key, a in mine.items():
        if key == "library":
            continue
        if key not in theirs and any(n in key for n in NEW):
            print(f"[same bits] {key}: new in this checkout")
            continue
        b = theirs[key]
        # Bit patterns, so -0.0 against 0.0 counts as a difference.
        equal = a.shape == b.shape and torch.equal(
            a.view(torch.int64 if a.dtype == torch.float64 else torch.int32),
            b.view(torch.int64 if b.dtype == torch.float64 else torch.int32))
        same &= equal
        print(f"[same bits] {key}: {'identical' if equal else 'DIFFERENT'}"
              + ("" if equal else f" (max |diff| {(a.double() - b.double()).abs().max().item()!r})"))
    code_mine, code_theirs = sass(mine["library"]), sass(theirs["library"])
    for key in sorted(set(code_mine) | set(code_theirs)):
        a, b = code_mine.get(key), code_theirs.get(key)
        label = (f"{key[0]} ({'float' if key[1] == 'f' else 'double'}"
                 f"{', ' + key[2] if key[2] else ''}{', ' + key[3] if key[3] else ''}"
                 f"{', ' + key[4] if key[4] else ''}, instance {key[5]})")
        new_nodes = key[3] in NEW_NODES and key[0] in (
            "aderdg_face_flux", "aderdg_surface_update", "aderdg_face_flux_walls",
            "aderdg_surface_update_walls")
        new_nodes |= (key[0], key[2], key[3]) in NEW_INSTANCES
        new_nodes |= bool(key[4])  # a Z4 cell or branch beside the 3-D fused one
        if b is None and (new_nodes or any(n in key[0] or n == key[2] for n in NEW)):
            print(f"[same sass] {label}: {len(a)} instructions, new in this checkout")
            continue
        if a is None or b is None:
            same = False
            print(f"[same sass] {label}: only in {'this checkout' if b is None else 'the other'}")
            continue
        equal = a == b
        same &= equal
        print(f"[same sass] {label}: {len(a)} and {len(b)} instructions, "
              f"{'identical' if equal else 'DIFFERENT'}")
        if not equal:
            first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            for i in range(first, min(first + 6, max(len(a), len(b)))):
                print(f"[same sass]   {i}: this {a[i] if i < len(a) else '-'!r} | other "
                      f"{b[i] if i < len(b) else '-'!r}")
    print(f"[same bits] {HERE} vs {args.other}: {'identical' if same else 'DIFFERENT'}")
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
