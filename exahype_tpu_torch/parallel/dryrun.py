"""The twin of ``__graft_entry__.py::dryrun_multichip``: one step of each of
its sharded configurations on ``n_devices`` ranks, each gathered and held
against the same model's unsharded step in the port.

    python3 -m exahype_tpu_torch.parallel.dryrun 4 --device cpu

:func:`dryrun_multichip` spawns ``n_devices`` ranks (``parallel/mesh.py``
``run_ranks``; NCCL on the card, gloo on the CPU, or the caller's
``backend``) and runs the JAX function's checks in its order, under its
names.  Each rank computes the sharded step on its window and the unsharded
step of the whole grid; the gathered result must be within the JAX check's
tolerance of it (1e-6, the bf16 wire 0.05), and the report says whether it
is bit for bit.  Two checks wait and are reported as waiting, not passed:
the row-gathered limited step over the sharded accelerator (ROADMAP.md,
Queue 1 item 5.b) and the sharded pool step (item 11).

Where the port differs from the JAX function:

- the FV checks build their state directly in the SoA-P layout (the JAX
  function builds it on the AoS ``PatchGrid``, ROADMAP item 10, which the
  port does not carry), with the same recipe;
- the fused-Pallas ADER-DG checks run K1 e's step
  (``make_sharded_aderdg_step``), compiled for 3-D Euler at order 3: they
  run at order 3 (the JAX function's run at order 2);
- the GSPMD checks (viscous, Z4, Z4+GRHD, Z4+GRMHD, curvilinear) run the
  plain solver per rank (``make_sharded_xla_aderdg_step``), the fused Z4
  one with K5 (``with_cuda_rhs``; at ``dim = 2`` K5 b).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

#: The JAX function's checks, in its order, and the two that wait.
CHECKS = (
    "gspmd full_step",
    "sharded pallas FV",
    "sharded ADER-DG",
    "sharded reflective ADER-DG",
    "bf16-wire sharded FV",
    "sharded row-gathered limited step",
    "sharded pool step (coarse)",
    "sharded pool step (fine)",
    "2-axis sharded FV",
    "2-axis sharded ADER-DG",
    "2-axis sharded walled ADER-DG",
    "gspmd viscous NS",
    "gspmd Z4 (dynamic GR)",
    "sharded XLA+pallas-rhs Z4 (fused dynamic GR)",
    "gspmd coupled Z4+GRHD",
    "gspmd coupled Z4+GRMHD (magnetized)",
    "gspmd curvilinear CK",
)
WAITING = {
    "sharded row-gathered limited step": "ROADMAP.md, Queue 1 item 5.b",
    "sharded pool step (coarse)": "ROADMAP.md, Queue 1 item 11",
    "sharded pool step (fine)": "ROADMAP.md, Queue 1 item 11",
}
#: The checks that need a 2-axis mesh (n_devices >= 4 and even).
TWO_AXIS = ("2-axis sharded FV", "2-axis sharded ADER-DG", "2-axis sharded walled ADER-DG")


def _check(name, got, want, atol=1e-6) -> dict:
    """The JAX function's ``_check``: finite, and within ``atol`` of the
    unsharded reference."""
    got, want = got.double(), want.double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite sharded output")
    err = float((got - want).abs().max())
    if err > atol:
        raise AssertionError(
            f"{name}: sharded result deviates from the single-device reference (max abs "
            f"diff {err:.3e} > {atol:g})")
    return {"status": "passed", "err": err, "bitwise": bool(torch.equal(got, want))}


def _euler_dg_state(sol, seed, dtype):
    rng = np.random.default_rng(seed)
    no_var = sol.state_shape[:sol.var_axis] + sol.state_shape[sol.var_axis + 1:]
    rho = (1.0 + 0.2 * rng.random(no_var)).astype(np.float32)
    q = np.stack([rho, rho, 0.5 * rho, 0.25 * rho, 5.0 + 0.66 * rho], axis=sol.var_axis)
    return torch.as_tensor(q, dtype=dtype, device=sol.weights.device)


def _fv_state(shape, seed, device, dim=3):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(0.1, 1.0, size=shape).astype(np.float32)
    Q[(slice(None),) * dim + (0,)] += 1.0
    Q[(slice(None),) * dim + (dim + 1,)] += 5.0
    return torch.as_tensor(Q, device=device)


def _rank(rank: int, world: int, device: str) -> dict:
    from exahype_tpu_torch.models import euler
    from exahype_tpu_torch.models.aderdg import (
        ADERDGSolver,
        euler_physics,
        euler_reflect,
        euler_reflect_flux,
    )
    from exahype_tpu_torch.models.rusanov import build_rusanov_kernel
    from exahype_tpu_torch.parallel import shard
    from exahype_tpu_torch.parallel.grid import TpuPatchGrid
    from exahype_tpu_torch.parallel.mesh import make_mesh
    from exahype_tpu_torch.parallel.solver import GridSolver

    n = world
    out = {}
    mesh = make_mesh(n, device=device)
    dev = mesh.device
    f32 = torch.float32

    def run(name, fn):
        out[name] = fn()

    # FV: 3-D Rusanov patches over an (n, 2, 2) grid, axis 0 sharded.
    grid_shape = (n, 2, 2)
    kb = build_rusanov_kernel(dim=3, patch_size=4, halo_size=1, n_real=5, n_aux=0,
                              n_patches=math.prod(grid_shape))
    grid = TpuPatchGrid(kb.config, grid_shape)
    Q = _fv_state(grid.state_shape, 0, dev)
    whole = GridSolver(grid, kb, dx=0.1, eigenvalue_fn=euler.wave_speed_fn(3), device=dev,
                       dtype=f32)
    sharded = GridSolver(grid, kb, dx=0.1, eigenvalue_fn=euler.wave_speed_fn(3), device=dev,
                         dtype=f32, mesh=mesh)

    def full_step():
        step, sh = shard.make_sharded_cuda_step(kb, grid, mesh, plain=True)
        q = sh.shard(Q)
        got = sh.gather(step(q, sharded.compute_dt(q)))
        return _check("gspmd full_step", got, whole.step(Q.clone(), whole.compute_dt(Q)))

    run("gspmd full_step", full_step)
    step_fv, sh_fv = shard.make_sharded_cuda_step(kb, grid, mesh)
    fv_out = sh_fv.gather(step_fv(sh_fv.shard(Q), 1e-4))
    run("sharded pallas FV", lambda: _check("sharded pallas FV", fv_out,
                                            whole.step(Q.clone(), 1e-4)))

    # ADER-DG, 3-D Euler over an (n, 2, 2) cell grid at order 3 (K1 e).
    flux, eig = euler_physics(3)
    walls = dict(boundary="reflective", reflect_fn=euler_reflect(3),
                 reflect_flux_fn=euler_reflect_flux(3))
    for label, kw in (("sharded ADER-DG", {}), ("sharded reflective ADER-DG", walls)):
        dg = ADERDGSolver(3, 3, 5, (n, 2, 2), flux, eig, dx=0.25, device=dev, dtype=f32, **kw)
        u = _euler_dg_state(dg, 1, f32)
        step, sh = shard.make_sharded_aderdg_step(dg, mesh)
        got = sh.gather(step(sh.shard(u), 1e-4))
        run(label, lambda: _check(label, got, _whole_step(dg, u, 1e-4)))

    wstep, _ = shard.make_sharded_cuda_step(kb, grid, mesh, wire_dtype=torch.bfloat16)
    wire_out = sh_fv.gather(wstep(sh_fv.shard(Q), 1e-4))
    run("bf16-wire sharded FV", lambda: _check("bf16-wire sharded FV", wire_out, fv_out, 0.05))

    if n >= 4 and n % 2 == 0:
        mesh2 = make_mesh(shape=(n // 2, 2), axis_names=("ici", "dcn"), device=dev)
        kb2 = build_rusanov_kernel(dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=0,
                                   n_patches=n)
        grid2 = TpuPatchGrid(kb2.config, (n // 2, 2))
        Q2 = _fv_state(grid2.state_shape, 2, dev, dim=2)
        step2, sh2 = shard.make_sharded_cuda_step_2axis(kb2, grid2, mesh2)
        whole2 = GridSolver(grid2, kb2, device=dev, dtype=f32)
        got = sh2.gather(step2(sh2.shard(Q2), 1e-4))
        run("2-axis sharded FV", lambda: _check("2-axis sharded FV", got,
                                                whole2.step(Q2.clone(), 1e-4)))
        for label, kw in (("2-axis sharded ADER-DG", {}),
                          ("2-axis sharded walled ADER-DG", dict(boundary="outflow"))):
            dg2 = ADERDGSolver(3, 3, 5, (n // 2, 2, 2), flux, eig, dx=0.25, device=dev,
                               dtype=f32, **kw)
            u2 = _euler_dg_state(dg2, 5, f32)
            step, sh = shard.make_sharded_aderdg_step_2axis(dg2, mesh2)
            got = sh.gather(step(sh.shard(u2), 1e-4))
            run(label, lambda: _check(label, got, _whole_step(dg2, u2, 1e-4)))

    for label, sol, u, dt in _gspmd_models(n, dev):
        step, sh = shard.make_sharded_xla_aderdg_step(sol, mesh)
        got = sh.gather(step(sh.shard(u), dt))
        run(label, lambda: _check(label, got, sol.step(u, dt)))
    return out


def _whole_step(sol, u, dt):
    """The unsharded step: ``CudaADERDG`` (the plain solver for CPU
    tensors)."""
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

    return CudaADERDG(sol).step(u, dt)


def _gspmd_models(n: int, dev) -> list:
    """The JAX function's GSPMD models: ``(label, solver, state, dt)``."""
    from exahype_tpu_torch.models import curvilinear as cv
    from exahype_tpu_torch.models.aderdg import ADERDGSolver
    from exahype_tpu_torch.models.navier_stokes import navier_stokes
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4 import gauge_wave_state, make_z4_solver
    from exahype_tpu_torch.models.z4_grmhd import make_z4_grmhd_solver, pack_matter_mhd
    from exahype_tpu_torch.models.z4_matter import flrw_state, make_z4_matter_solver

    f32, f64 = torch.float32, torch.float64
    models = []
    f, e, vf, ve = navier_stokes(2, mu=0.02)
    ns = ADERDGSolver(2, 2, 4, (n, 4), f, e, dx=1.0 / n, visc_flux_fn=vf,
                      visc_eigenvalue_fn=ve, device=dev, dtype=f32)
    rng = np.random.default_rng(5)
    nv = ns.state_shape[:2] + ns.state_shape[3:]
    rho = 1.0 + 0.3 * rng.random(nv)
    m = 0.3 * rng.standard_normal(nv + (2,))
    p = 1.0 + 0.3 * rng.random(nv)
    E = p / 0.4 + 0.5 * (m**2).sum(-1) / rho
    q = np.moveaxis(np.concatenate([rho[..., None], m, E[..., None]], -1), -1, ns.var_axis)
    models.append(("gspmd viscous NS", ns, torch.as_tensor(q, dtype=f32, device=dev), 1e-4))

    z4kw = dict(dx=1.0 / n, kappa1=0.5, kappa2=0.1, impl="soa", device=dev, dtype=f64)
    z4 = make_z4_solver(2, 2, (n, 2), **z4kw)
    rngz = np.random.default_rng(7)
    qz = gauge_wave_state(z4, amplitude=0.01) + 1e-4 * torch.as_tensor(
        rngz.standard_normal(z4.state_shape), dtype=f64, device=dev)
    models.append(("gspmd Z4 (dynamic GR)", z4, qz, 1e-3))
    fused = with_cuda_rhs(make_z4_solver(2, 2, (n, 2), fused_rhs="soa", **z4kw))
    models.append(("sharded XLA+pallas-rhs Z4 (fused dynamic GR)", fused, qz, 1e-3))

    zm = make_z4_matter_solver(2, 2, (n, 2), dx=1.0 / n, slicing="harmonic", f=0.0,
                               device=dev, dtype=f64)
    qzm = flrw_state(zm, 1.0, float(np.sqrt(8 * np.pi * 0.02 / 3)), rho0=0.02)
    rngm = np.random.default_rng(9)
    pert = torch.as_tensor(1.0 + 0.02 * rngm.random(qzm.select(zm.var_axis, 38).shape),
                           dtype=f64, device=dev)
    qzm = qzm.clone()
    qzm.select(zm.var_axis, 38).mul_(pert)
    models.append(("gspmd coupled Z4+GRHD", zm, qzm, 1e-3))

    zg = make_z4_grmhd_solver(2, 2, (n, 2), dx=1.0 / n, slicing="harmonic", f=0.0,
                              glm_kappa=0.5, device=dev, dtype=f32)
    nvg = tuple(s for a, s in enumerate(zg.state_shape) if a != zg.var_axis)
    xg = np.broadcast_to(np.squeeze(np.asarray(zg.nodes_meshgrid()[0]), zg.var_axis), nvg)
    z4g = np.zeros(xg.shape + (38,))
    z4g[..., 0] = 1.0
    z4g[..., 1] = 1.0 + 0.05 * np.sin(2 * np.pi * xg)
    z4g[..., 4] = z4g[..., 6] = 1.0
    Bg = np.zeros(xg.shape + (3,))
    Bg[..., 0] = 0.05
    Bg[..., 2] = 0.02 * np.cos(2 * np.pi * xg)
    qg = pack_matter_mhd(*(torch.as_tensor(a) for a in (
        z4g, 1.0 + 0.1 * np.sin(2 * np.pi * xg), np.zeros(xg.shape + (3,)), np.ones_like(xg),
        Bg)))
    qg = torch.movedim(qg.to(device=dev, dtype=f32), -1, zg.var_axis)
    models.append(("gspmd coupled Z4+GRMHD (magnetized)", zg, qg.contiguous(), 1e-3))

    vadv = (1.0, 0.5)
    cflux, ceig = cv.curvilinear_physics(
        lambda q, normal, va: vadv[int(normal)] * q,
        lambda q, normal, va: torch.full(q.select(va, 0).shape, abs(vadv[int(normal)]),
                                         dtype=q.dtype, device=q.device),
        2, 1)
    cur = ADERDGSolver(2, 2, cv.n_vars_curvilinear(1, 2), (n, 4), cflux, ceig, dx=1.0 / n,
                       predictor_mode="ck", ck_material_slots=cv.curvilinear_material_slots(1, 2),
                       dissipation_mask=cv.curvilinear_dissipation_mask(1, 2), device=dev,
                       dtype=f32)
    metric, (Xc, Yc) = cv.metric_fields(
        cur, lambda p: (p[0] + 0.03 * torch.sin(2 * np.pi * p[1]),
                        p[1] + 0.03 * torch.sin(2 * np.pi * p[0])))
    qw = np.expand_dims(np.sin(2 * np.pi * Xc) * np.cos(2 * np.pi * Yc), cur.var_axis)
    qc = cv.densitize(torch.as_tensor(qw, device=dev), metric, cur.var_axis).to(f32)
    models.append(("gspmd curvilinear CK", cur, qc.contiguous(), 1e-3))
    return models


def dryrun_multichip(n_devices: int, device=None, backend=None, join_timeout: float = 600.0
                     ) -> dict:
    """Run the JAX ``dryrun_multichip``'s checks on ``n_devices`` ranks
    (on the card unless ``device="cpu"``), print one line per check, and
    return ``{check: {"status": "passed" | "waiting" | "skipped", ...}}``.
    Raises if a check fails or a rank does not finish within
    ``join_timeout`` seconds."""
    from exahype_tpu_torch.parallel.mesh import run_ranks
    from exahype_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(device))
    results = run_ranks(_rank, n_devices, device, backend=backend, device=device,
                        join_timeout=join_timeout)
    report = {}
    for name in CHECKS:
        if name in WAITING:
            report[name] = {"status": "waiting", "on": WAITING[name]}
        elif name in results[0]:
            per_rank = [r[name] for r in results]
            report[name] = dict(per_rank[0], bitwise=all(r["bitwise"] for r in per_rank))
        else:
            report[name] = {"status": "skipped", "why": "needs n_devices >= 4 and even"}
        line = report[name]
        detail = (f"max abs diff {line['err']:.3e}, bitwise {line['bitwise']}"
                  if line["status"] == "passed" else line.get("on", line.get("why")))
        print(f"[dryrun] {name}: {line['status']} ({detail})", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default=None, help="cpu, or the card when omitted")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device, backend=args.backend)


if __name__ == "__main__":
    main()
