"""The CUDA kernels against their plain PyTorch versions, on the card: the
Picard predictor and the two-launch face stage of ``csrc/aderdg.cu`` (with
its face-flux output), the order-5 Euler step (K1 c: the space-time
predictor of ``csrc/aderdg_st.cuh`` and the face stage at n = 6) and the
order-4 and order-7 ones (n = 5, 8), with the walled pair at n = 5, 6 and 8
in every mode, the CK
predictor (K2) and the face stage's elastic
variant, both at the edges of their tilings, the CK predictor's sponge
instance (K2 a) under the walled CK step, the face stage's wall variant
in every mode (Euler) and on the CK free surface, the viscous predictor
(``csrc/aderdg_visc.cu``) and the Navier–Stokes face stage, periodic and in
every wall mode, the
limiter's subcell sweep (K3, ``csrc/subcell.cu``) alone and under
``LimitedADERDG``, its Z4+GRHD p2 instance with the NCP halves (K3 a,
``csrc/subcell_ncp.cuh``) alone and under the limited Z4+GRHD step, the
spec kernel (K4) that ``CudaPrinter`` generates,
alone and under ``GridSolver``, the fused Z4 right-hand side (K5,
``csrc/rhs.cu``) alone and under the Z4 step, and the Z4 step's own three
kernels (K1 d, ``csrc/aderdg_z4.cu``), for the 38-variable system, the
53-variable shifted one (``csrc/aderdg_z4_shift.cu``, frozen shift and
Gamma-driver, on the moving gauge wave with seeded noise on every slot) and
the 43-variable Z4+GRHD one (K5 d and K1 d's conservative-flux variant,
``csrc/aderdg_z4_matter.cu``, on a fluid with a velocity field and seeded
noise on every Z4 slot; its per-axis branch in 3-D and its 2-D step, per-axis
and fused, ``csrc/aderdg_z4_matter_per_axis.cu`` and
``aderdg_z4_matter_2d.cu``, with K5 b's 2-D instance) and the 47-variable Z4+GRMHD one (K5 e and the
same variant over ``csrc/aderdg_z4_grmhd.cu``, on a magnetized fluid with a
GLM scalar and the same noise; its per-axis branch in 3-D and its 2-D step,
per-axis and fused, ``csrc/aderdg_z4_grmhd_per_axis.cu`` and
``aderdg_z4_grmhd_2d.cu``, with K5 b's 2-D instance) and the shifted one's
(``aderdg_z4_shift_per_axis.cu``, ``aderdg_z4_shift_2d.cu``, with K5 b's 2-D
instance); the 2-D Euler p3 step (K1 c,
``csrc/aderdg_2d.cu``) periodic and in every wall mode, and the limited
step with walls (gathered rows in 3-D, the whole grid in 2-D); the 2-D
Navier–Stokes step at orders 3 and 2, periodic and in every wall mode (the
viscous predictor, with the wall planes on a walled grid, and the
penalised face pairs with the advective/viscous wall split, of the same
file) and the limited step over viscous solvers in 2-D (the
MUSCL fallback) and 3-D; K2 b, the homogeneous elasticity on the CK
predictor of ``csrc/aderdg_ck_nodes.cuh`` (3-D ``elastic3d`` at order 2 with
the face stage's n = 3 instances, 2-D ``elastic`` at order 3 with the 2-D
face pairs over ``Elastic2D``, periodic and with the free surface); K2 b.1,
the same kernels over the systems with frozen slots (the 12-variable
heterogeneous elasticity at order 2, the 8-variable 2-D one periodic and
walled, the curvilinear lift of the 2-D elasticity), the frozen rows held
unchanged.

Every test here is marked ``cuda`` and skips without a card (the decision
is made inside each test, never at import).  This file imports no JAX, so
it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f64 at rtol=0, atol=1e-12 (K5: 1e-12 of max(1, the largest
value), which reaches ~420 at these resolutions); f32 at 64 float32
spacings (2⁻²³ relative) of the largest compared value — two f32
evaluation orders of a computation a few hundred (K5: ~3,900) operations
deep, fused multiply-adds on the card's side only (``chip_smoke.py`` states
the same bounds).
"""

import numpy as np
import pytest
import torch

from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.parallel import shard
from exahype_tpu_torch.utils.errors import LoweringError
from torch_z4m_batch import z4m_gathered_batch

torch.set_num_threads(1)

DX = 1.0 / 256
DT = 5e-5  # under the CFL limit (6.26e-5) of this state at DX


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def _bound(ref, dtype):
    if dtype == torch.float64:
        return 1e-12
    return 64 * 2.0**-23 * ref.abs().max().item()


def _err(a, b):
    return (a.double() - b.double()).abs().max().item()


def _setup(grid, dtype, dx=DX, **walls):
    dev = _card()
    flux, eig = euler_physics(3)
    sol = ADERDGSolver(3, 3, 5, grid, flux, eig, dx=dx, device=dev, dtype=dtype, **walls)
    rng = np.random.default_rng(0)
    rho = 1.0 + 0.2 * rng.random((4, 4, 4) + grid)
    q = np.stack([rho, rho, 0.5 * rho, 0.25 * rho, 5.0 + 0.5 * rho * 1.3125], axis=3)
    return sol, CudaADERDG(sol), torch.from_numpy(q).to(dev, dtype).contiguous()


CASES = [
    (torch.float64, (8, 4, 32)),
    (torch.float64, (3, 5, 7)),  # ragged last block, odd wraps
    (torch.float32, (8, 4, 32)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CASES)
def test_predictor_volume_kernel_matches_plain(dtype, grid):
    sol, cu, u = _setup(grid, dtype)
    u0 = u.clone()
    new_k, faces_k, _ = cu.predictor_volume(u, DT)
    new_p, faces_p, _ = sol.predictor_volume(u, DT)
    torch.cuda.synchronize()
    assert torch.equal(u, u0)
    assert _err(new_k, new_p) <= _bound(new_p, dtype)
    assert _err(faces_k, faces_p) <= _bound(faces_p, dtype)
    assert cu.launches["aderdg_predictor_volume"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CASES)
def test_face_surface_kernel_matches_plain(dtype, grid):
    sol, cu, u = _setup(grid, dtype)
    new, faces, _ = sol.predictor_volume(u, DT)
    new_k = new.clone()
    out_k = cu.face_surface(new_k, faces, DT)
    out_p = sol.face_surface(new, faces, DT)
    torch.cuda.synchronize()
    assert out_k is new_k
    assert _err(out_k, out_p) <= _bound(out_p, dtype)
    assert cu.launches["aderdg_face_flux"] == cu.launches["aderdg_surface_update"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CASES)
def test_step_kernels_match_plain_and_repeat_bitwise(dtype, grid):
    sol, cu, u = _setup(grid, dtype)
    ref = sol.step(u, DT)
    by_value = cu.step(u, DT)
    by_pointer = cu.step(u, torch.tensor(DT, dtype=dtype, device=u.device))
    torch.cuda.synchronize()
    assert _err(by_value, ref) <= _bound(ref, dtype)
    assert torch.equal(by_value, by_pointer)
    assert torch.equal(cu.run(u, 3, DT), cu.run(u, 3, DT))
    assert cu.launches == {"aderdg_predictor_volume": 8, "aderdg_face_flux": 8,
                           "aderdg_surface_update": 8}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CASES)
def test_face_kernel_face_fluxes_match_plain(dtype, grid):
    sol, cu, u = _setup(grid, dtype)
    new, faces, _ = sol.predictor_volume(u, DT)
    out_k, fl_k = cu.face_surface(new.clone(), faces, DT, return_face_fluxes=True)
    out_p, fl_p = sol.face_surface(new, faces, DT, return_face_fluxes=True)
    plain_only = cu.face_surface(new.clone(), faces, DT)
    torch.cuda.synchronize()
    assert torch.equal(out_k, plain_only)
    assert _err(out_k, out_p) <= _bound(out_p, dtype)
    for a, b in zip(fl_k, fl_p):
        assert a.shape == b.shape == sol.face_flux_shape
        assert _err(a, b) <= _bound(b, dtype)
    step_k, step_fl = cu.step(u, DT, return_face_fluxes=True)
    assert torch.equal(step_k, cu.step(u, DT))
    assert cu.launches["aderdg_face_flux"] == cu.launches["aderdg_surface_update"] == 4


# ------------------------------------------------ K2: the CK predictor


def _ck_setup(grid, dtype, **walls):
    """``bench.py::bench_ck``'s solver and initial state at ``grid``."""
    from exahype_tpu_torch.models.elastic import (
        DISSIPATION_MASK,
        MATERIAL_SLOTS,
        elastic3d_heterogeneous,
        two_layer_state,
    )

    dev = _card()
    flux, eig = elastic3d_heterogeneous()
    sol = ADERDGSolver(3, 3, 12, grid, flux, eig, dx=1.0 / grid[0], device=dev, dtype=dtype,
                       predictor_mode="ck", ck_material_slots=MATERIAL_SLOTS,
                       dissipation_mask=DISSIPATION_MASK, **walls)
    q, _ = two_layer_state(sol)
    return sol, CudaADERDG(sol), torch.from_numpy(q).to(dev, dtype).contiguous()


def _ck_err(got, ref, dtype):
    """Evolved and material rows (var axis 3) each within the bound of their
    own largest value: the wave is ~1e-3, the materials up to 3."""
    for lo, n in ((0, 9), (9, 3)):
        g, r = got.narrow(3, lo, n), ref.narrow(3, lo, n)
        assert _err(g, r) <= _bound(r, dtype), (lo, _err(g, r))


CK_CASES = [
    (torch.float64, (8, 4, 32)),
    (torch.float64, (3, 5, 7)),  # ragged last block (105 cells, 4 a block), odd wraps
    (torch.float32, (8, 4, 32)),
    (torch.float32, (3, 5, 7)),  # ragged last block (105 cells, 8 a block)
]
CK_DT = 2e-4  # bench.py's dt, under the CFL limit at dx = 1/g0 <= 1/8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CK_CASES)
def test_ck_predictor_kernel_matches_plain(dtype, grid):
    sol, cu, u = _ck_setup(grid, dtype)
    u0 = u.clone()
    new_k, faces_k, _ = cu.predictor_volume(u, CK_DT)
    new_p, faces_p, _ = sol.predictor_volume(u, CK_DT)
    torch.cuda.synchronize()
    assert torch.equal(u, u0)
    _ck_err(new_k, new_p, dtype)
    _ck_err(faces_k, faces_p, dtype)
    assert torch.equal(new_k[:, :, :, 9:], u[:, :, :, 9:])  # materials untouched
    assert not faces_k[:, 2:, :, 9:].any()  # zero material flux rows
    assert cu.launches == {"aderdg_ck_predictor_volume": 1, "aderdg_face_flux": 0,
                           "aderdg_surface_update": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CK_CASES)
def test_elastic_face_kernel_matches_plain(dtype, grid):
    sol, cu, u = _ck_setup(grid, dtype)
    new, faces, _ = sol.predictor_volume(u, CK_DT)
    out_k, fl_k = cu.face_surface(new.clone(), faces, CK_DT, return_face_fluxes=True)
    out_p, fl_p = sol.face_surface(new, faces, CK_DT, return_face_fluxes=True)
    torch.cuda.synchronize()
    _ck_err(out_k, out_p, dtype)
    assert torch.equal(out_k[:, :, :, 9:], u[:, :, :, 9:])
    for a, b in zip(fl_k, fl_p):
        assert a.shape == b.shape == sol.face_flux_shape
        assert _err(a, b) <= _bound(b, dtype)
        assert not a[:, :, 9:].any()  # masked jump, zero flux: no material flux
    assert cu.launches["aderdg_face_flux"] == cu.launches["aderdg_surface_update"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CK_CASES)
def test_ck_step_kernels_match_plain_and_repeat_bitwise(dtype, grid):
    sol, cu, u = _ck_setup(grid, dtype)
    ref = sol.run(u, 3, CK_DT)
    by_value = cu.run(u, 3, CK_DT)
    by_pointer = cu.run(u, 3, torch.tensor(CK_DT, dtype=dtype, device=u.device))
    torch.cuda.synchronize()
    rounds = 1 if dtype == torch.float64 else 3  # f32: three steps' rounding
    for lo, n in ((0, 9), (9, 3)):
        g, r = by_value.narrow(3, lo, n), ref.narrow(3, lo, n)
        assert _err(g, r) <= rounds * _bound(r, dtype)
    assert torch.equal(by_value, by_pointer)
    assert torch.equal(by_value[:, :, :, 9:], u[:, :, :, 9:])  # bitwise frozen
    assert cu.launches == {"aderdg_ck_predictor_volume": 6, "aderdg_face_flux": 6,
                           "aderdg_surface_update": 6}


# ------------------------------------------------ K2 a: the CK predictor with the sponge


def _ck_sponge_setup(grid, dtype):
    """``examples/seismic3d_layered.py``'s solver (the free surface on axis 2,
    its sponge on axes 0 and 1 with the width widened to reach these small
    grids' interiors) on ``bench_ck``'s two-layer state with seeded noise of
    1e-3 on the 9 wave rows."""
    from exahype_tpu_torch.models.elastic import (
        elastic3d_free_surface_het,
        sponge_source,
    )

    sol, _, u = _ck_setup(grid, dtype, boundary="reflective", wall_axes=(2,),
                          reflect_fn=elastic3d_free_surface_het()[0],
                          reflect_flux_fn=elastic3d_free_surface_het()[1])
    sol.source_fn = sponge_source(sol, width=0.3, rate=40.0, axes=(0, 1), n_wave=9)
    noise = np.random.default_rng(4).standard_normal(u[:, :, :, :9].shape)
    u[:, :, :, :9] += 1e-3 * torch.from_numpy(noise).to(u)
    return sol, CudaADERDG(sol), u


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CK_CASES)
def test_ck_sponge_predictor_kernel_matches_plain(dtype, grid):
    sol, cu, u = _ck_sponge_setup(grid, dtype)
    assert cu.kernels[0] == "aderdg_ck_predictor_volume_sponge"
    u0 = u.clone()
    new_k, faces_k, _ = cu.predictor_volume(u, CK_DT)
    new_p, faces_p, _ = sol.predictor_volume(u, CK_DT)
    torch.cuda.synchronize()
    assert torch.equal(u, u0)
    _ck_err(new_k, new_p, dtype)
    _ck_err(faces_k, faces_p, dtype)
    assert torch.equal(new_k[:, :, :, 9:], u[:, :, :, 9:])  # materials untouched
    # The sponge moved the predictor: the sourceless kernel's new differs.
    bare = CudaADERDG(_ck_setup(grid, dtype)[0]).predictor_volume(u, CK_DT)[0]
    assert _err(new_k, bare) > 1e-7
    assert cu.launches[cu.kernels[0]] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CK_CASES)
def test_ck_sponge_step_kernels_match_plain_and_repeat_bitwise(dtype, grid):
    sol, cu, u = _ck_sponge_setup(grid, dtype)
    ref = sol.run(u, 3, CK_DT)
    by_value = cu.run(u, 3, CK_DT)
    by_pointer = cu.run(u, 3, torch.tensor(CK_DT, dtype=dtype, device=u.device))
    torch.cuda.synchronize()
    rounds = 1 if dtype == torch.float64 else 3
    for lo, n in ((0, 9), (9, 3)):
        g, r = by_value.narrow(3, lo, n), ref.narrow(3, lo, n)
        assert _err(g, r) <= rounds * _bound(r, dtype)
    assert torch.equal(by_value, by_pointer)
    assert torch.equal(by_value[:, :, :, 9:], u[:, :, :, 9:])  # bitwise frozen
    assert cu.launches == {name: 6 for name in cu.kernels}
    info = cu.kernel_info(cu.kernels[0], dtype)
    assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, info


# ------------------------------------------ K2 b: the homogeneous elasticity

#: ρ, λ, μ whose products round (the examples' 1, 2, 1 would hide a
#: misplaced constant behind exact arithmetic).
K2B_MATERIALS = dict(rho=1.3, lam=2.5, mu=0.7)


def _k2b_setup(dim, grid, dtype, walls=False):
    """A K2 b solver on the card (3-D ``elastic3d`` at order 2, periodic;
    2-D ``elastic`` at order 3, periodic or with the free surface on both
    axes), its ``CudaADERDG`` and a seeded state of ~1e-3 in every row."""
    from exahype_tpu_torch.models import elastic

    dev = _card()
    if dim == 3:
        flux, eig = elastic.elastic3d(**K2B_MATERIALS)
        sol = ADERDGSolver(3, 2, 9, grid, flux, eig, dx=1.0 / grid[0], device=dev,
                           dtype=dtype, predictor_mode="ck")
    else:
        hooks = {}
        if walls:
            reflect, reflect_flux = elastic.elastic_free_surface()
            hooks = dict(boundary="reflective", reflect_fn=reflect, reflect_flux_fn=reflect_flux)
        flux, eig = elastic.elastic(**K2B_MATERIALS)
        sol = ADERDGSolver(2, 3, 5, grid, flux, eig, dx=1.0 / grid[0], device=dev, dtype=dtype,
                           predictor_mode="ck", **hooks)
    q = 1e-3 * np.random.default_rng(sum(grid)).standard_normal(sol.state_shape)
    return sol, CudaADERDG(sol), torch.from_numpy(q).to(dev, dtype).contiguous()


K2B_CASES = [
    (3, torch.float64, (4, 4, 8), False),
    (3, torch.float64, (3, 5, 7), False),  # ragged last blocks, odd wraps
    (3, torch.float32, (16, 8, 64), False),
    (2, torch.float64, (9, 9), False),
    (2, torch.float64, (9, 9), True),
    (2, torch.float64, (5, 7), True),
    (2, torch.float32, (64, 48), True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dim,dtype,grid,walls", K2B_CASES)
def test_k2b_kernels_match_plain(dim, dtype, grid, walls):
    """K2 b's three kernels launch by launch against the plain solver (the
    CK predictor's new state and faces, F̂ and with walls the side tensor,
    the update), the stage with its face fluxes, and 3 steps (dt by value
    and by pointer, bitwise equal; 3 launches a step)."""
    sol, cu, u = _k2b_setup(dim, grid, dtype, walls)
    dt = 0.5 * float(sol.cfl_dt(u))

    def close(got, ref, rounds=1):
        assert _err(got, ref) <= rounds * _bound(ref, dtype)

    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    close(new_k, new_p)
    close(faces_k, faces_p)
    fhat, fwall = cu.face_flux(faces_p)
    fshape = sol.face_flux_shape
    plain, side = [], {}
    for d in range(dim):
        q_lo, q_hi, f_lo, f_hi = (faces_p[d, k].reshape(fshape) for k in range(4))
        plain.append(sol.interface_flux(q_lo, q_hi, f_lo, f_hi, d))
        close(fhat[d].view(fshape), plain[d])
        if walls:
            side[d] = sol.low_wall_flux(q_lo, f_lo, d)
            close(cu.wall_fluxes(fwall)[d], side[d])
    assert (fwall is None) != walls
    flat = torch.cat([side[d].reshape(-1) for d in sorted(side)]) if walls else None
    upd = cu.surface_update(new_p.clone(), torch.stack(plain).view(fhat.shape), dt, flat)
    ref = new_p
    for d in range(dim):
        ref = sol.surface_term(ref, plain[d], d, dt, side.get(d))
    close(upd, ref)
    stage, fl_k = cu.face_surface(new_p.clone(), faces_p, dt, return_face_fluxes=True)
    stage_p, fl_p = sol.face_surface(new_p, faces_p, dt, return_face_fluxes=True)
    close(stage, stage_p)
    for a, b in zip(fl_k, fl_p):
        close(a, b)
    cu.reset_launches()
    by_value = cu.run(u, 3, dt)
    by_pointer = cu.run(u, 3, torch.tensor(dt, dtype=dtype, device=u.device))
    torch.cuda.synchronize()
    close(by_value, sol.run(u, 3, dt), 1 if dtype == torch.float64 else 3)
    assert torch.equal(by_value, by_pointer)
    assert cu.launches == {name: 6 for name in cu.kernels}


@pytest.mark.cuda
@pytest.mark.parametrize("dim,walls", [(3, False), (2, False), (2, True)])
def test_k2b_kernel_info_and_names(dim, walls):
    grid = (2, 2, 3) if dim == 3 else (3, 3)
    sol, cu, _ = _k2b_setup(dim, grid, torch.float32, walls)
    suffix = ("_walls_2d" if walls else "_2d") if dim == 2 else "_p2"
    assert cu.kernels == (f"aderdg_ck_predictor_volume{'_2d' if dim == 2 else '_p2'}",
                          f"aderdg_face_flux{suffix}", f"aderdg_surface_update{suffix}")
    for kernel in cu.kernels:
        for dtype in (torch.float32, torch.float64):
            info = cu.kernel_info(kernel, dtype)
            assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, (kernel, info)
            # No local memory, but for the 3-D predictor in float32, which
            # its 3 blocks an SM hold to 80 registers and 24 B of spill.
            spill = 32 if (dim, dtype, kernel) == (3, torch.float32, cu.kernels[0]) else 0
            assert info["local"] <= spill, (kernel, info)
    # A thread a space node: 8 cells of 27 nodes (3-D), 16 cells of 16 (2-D).
    assert cu.kernel_info(cu.kernels[0], torch.float32)["threads"] == (216 if dim == 3 else 256)


# --------------------------- K2 b.1: frozen slots and the mask on the node kernel


def _k2b1_setup(system, grid, dtype, walls=False):
    """A K2 b.1 solver on the card: ``"het3d"`` (the 12-variable
    heterogeneous elasticity at order 2, periodic), ``"het2d"`` (the
    8-variable 2-D one at order 3, periodic or with the free surface on both
    axes) or ``"curvilinear"`` (the curvilinear lift of the 2-D elasticity
    over a hill of height 0.04, periodic); its ``CudaADERDG``, a state with
    seeded wave rows of ~1 and the frozen rows (materials constant per cell,
    or the metric), and the number of rows with flux."""
    from exahype_tpu_torch.models import curvilinear, elastic

    dev = _card()
    rng = np.random.default_rng(sum(grid))
    if system == "curvilinear":
        flux, eig = curvilinear.curvilinear_physics(*elastic.elastic(**K2B_MATERIALS), 2, 5)
        sol = ADERDGSolver(2, 3, 10, grid, flux, eig, dx=1.0 / grid[0], device=dev,
                           dtype=dtype, predictor_mode="ck",
                           ck_material_slots=curvilinear.curvilinear_material_slots(5, 2),
                           dissipation_mask=curvilinear.curvilinear_dissipation_mask(5, 2))
        metric, _ = curvilinear.metric_fields(sol, curvilinear.hill_mapping(0.04))
        wave = rng.standard_normal(sol.state_shape[:2] + (5,) + sol.state_shape[3:])
        u = curvilinear.densitize(torch.from_numpy(wave), metric, 2)
        return sol, CudaADERDG(sol), u.to(dev, dtype).contiguous(), 5
    dim, first = (3, 9) if system == "het3d" else (2, 5)
    hooks = {}
    if walls:
        reflect, reflect_flux = elastic.elastic_free_surface_het()
        hooks = dict(boundary="reflective", reflect_fn=reflect, reflect_flux_fn=reflect_flux)
    if dim == 3:
        pair, slots, mask = (elastic.elastic3d_heterogeneous(), elastic.MATERIAL_SLOTS,
                             elastic.DISSIPATION_MASK)
    else:
        pair, slots, mask = (elastic.elastic_heterogeneous(), elastic.MATERIAL_SLOTS_HET,
                             elastic.DISSIPATION_MASK_HET)
    sol = ADERDGSolver(dim, 5 - dim, first + 3, grid, *pair, dx=1.0 / grid[0], device=dev,
                       dtype=dtype, predictor_mode="ck", ck_material_slots=slots,
                       dissipation_mask=mask, **hooks)
    q = rng.standard_normal(sol.state_shape)
    va = sol.var_axis
    for k, (lo, span) in enumerate(((1.0, 1.0), (1.0, 2.0), (0.5, 1.0))):
        idx = [slice(None)] * q.ndim
        idx[va] = first + k
        q[tuple(idx)] = lo + span * rng.random(tuple(grid))  # constant in each cell
    return sol, CudaADERDG(sol), torch.from_numpy(q).to(dev, dtype).contiguous(), first


K2B1_CASES = [
    ("het3d", torch.float64, (4, 4, 8), False),
    ("het3d", torch.float64, (3, 5, 7), False),  # ragged last blocks, odd wraps
    ("het3d", torch.float32, (16, 8, 64), False),
    ("het2d", torch.float64, (9, 9), False),
    ("het2d", torch.float64, (5, 7), True),
    ("het2d", torch.float32, (64, 48), True),
    ("curvilinear", torch.float64, (9, 9), False),
    ("curvilinear", torch.float64, (5, 7), False),
    ("curvilinear", torch.float32, (64, 48), False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("system,dtype,grid,walls", K2B1_CASES)
def test_k2b1_kernels_match_plain_and_keep_the_frozen_rows(system, dtype, grid, walls):
    """K2 b.1's three kernels launch by launch against the plain solver (the
    CK predictor's new state and faces, F̂'s rows with flux and with walls
    the side tensor, the update), the stage, and 3 steps (3 launches a step,
    bitwise repeatable); the frozen rows leave the step unchanged."""
    sol, cu, u, rows = _k2b1_setup(system, grid, dtype, walls)
    dt = 0.5 * float(sol.cfl_dt(u))

    def close(got, ref, rounds=1):
        assert _err(got, ref) <= rounds * _bound(ref, dtype)

    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    close(new_k, new_p)
    close(faces_k, faces_p)
    va = sol.var_axis
    assert torch.equal(new_k.narrow(va, rows, sol.n_vars - rows), u.narrow(va, rows,
                                                                          sol.n_vars - rows))
    fhat, fwall = cu.face_flux(faces_p)
    fshape = sol.face_flux_shape
    plain, side = [], {}
    for d in range(sol.dim):
        q_lo, q_hi, f_lo, f_hi = (faces_p[d, k].reshape(fshape) for k in range(4))
        plain.append(sol.interface_flux(q_lo, q_hi, f_lo, f_hi, d))
        close(fhat[d, :, :rows], plain[d].reshape(fhat[d].shape)[:, :rows])
        if walls:
            side[d] = sol.low_wall_flux(q_lo, f_lo, d)
            close(cu.wall_fluxes(fwall)[d], side[d])
    flat = torch.cat([side[d].reshape(-1) for d in sorted(side)]) if walls else None
    upd = cu.surface_update(new_p.clone(), torch.stack(plain).view(fhat.shape), dt, flat)
    ref = new_p
    for d in range(sol.dim):
        ref = sol.surface_term(ref, plain[d], d, dt, side.get(d))
    close(upd, ref)
    stage, fl_k = cu.face_surface(new_p.clone(), faces_p, dt, return_face_fluxes=True)
    stage_p, fl_p = sol.face_surface(new_p, faces_p, dt, return_face_fluxes=True)
    close(stage, stage_p)
    for a, b in zip(fl_k, fl_p):
        close(a, b)
    cu.reset_launches()
    out = cu.run(u, 3, dt)
    again = cu.run(u, 3, dt)
    torch.cuda.synchronize()
    close(out, sol.run(u, 3, dt), 1 if dtype == torch.float64 else 3)
    assert torch.equal(out, again)
    assert torch.equal(out.narrow(va, rows, sol.n_vars - rows),
                       u.narrow(va, rows, sol.n_vars - rows))
    assert cu.launches == {name: 6 for name in cu.kernels}


#: Bytes of local memory a thread of the float32 node kernel spills.
K2B1_F32_SPILL = {"het3d": 16, "het2d": 8, "curvilinear": 56}


@pytest.mark.cuda
@pytest.mark.parametrize("system,walls", [("het3d", False), ("het2d", False), ("het2d", True),
                                          ("curvilinear", False)])
def test_k2b1_kernel_info_and_names(system, walls):
    grid = (2, 2, 3) if system == "het3d" else (3, 3)
    sol, cu, _, _ = _k2b1_setup(system, grid, torch.float32, walls)
    suffix = "_p2" if system == "het3d" else ("_walls_2d" if walls else "_2d")
    assert cu.kernels == (
        f"aderdg_ck_predictor_volume{'_p2' if system == 'het3d' else '_2d'}",
        f"aderdg_face_flux{suffix}", f"aderdg_surface_update{suffix}")
    for kernel in cu.kernels:
        for dtype in (torch.float32, torch.float64):
            info = cu.kernel_info(kernel, dtype)
            assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, (kernel, info)
            # No local memory, but for the node kernel in float32, which its
            # 3 blocks an SM hold to 80 registers: the spill as ptxas gave it
            # for the 12, 8 and 10 rows.
            spill = K2B1_F32_SPILL[system] if (dtype, kernel) == (
                torch.float32, cu.kernels[0]) else 0
            assert info["local"] <= spill, (kernel, info)
    assert cu.kernel_info(cu.kernels[0], torch.float32)["threads"] == (
        216 if system == "het3d" else 256)


# ------------------------------------------------ the kernels' tiling at its edges

#: A last axis that is not a multiple of the face stage's 32-cell tile, a
#: grid smaller than one tile (the axis-0 neighbour is the cell itself), and
#: more tiles than resident blocks (1,024 tiles of 32 cells).
EDGE_GRIDS = [(2, 3, 40), (1, 2, 5), (32, 16, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["euler", "elastic"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("grid", EDGE_GRIDS)
def test_kernels_at_tile_edges_match_plain(grid, dtype, physics):
    """The predictor and the face stage, with and without face fluxes."""
    euler = physics == "euler"
    sol, cu, u = _setup(grid, dtype) if euler else _ck_setup(grid, dtype)
    dt = DT if euler else CK_DT

    def close(got, ref):
        if euler:
            assert _err(got, ref) <= _bound(ref, dtype)
        else:
            _ck_err(got, ref, dtype)

    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    out_k = cu.face_surface(new_p.clone(), faces_p, dt)
    out_kf, fl_k = cu.face_surface(new_p.clone(), faces_p, dt, return_face_fluxes=True)
    out_p, fl_p = sol.face_surface(new_p, faces_p, dt, return_face_fluxes=True)
    torch.cuda.synchronize()
    close(new_k, new_p)
    close(faces_k, faces_p)
    close(out_k, out_p)
    assert torch.equal(out_k, out_kf)
    for a, b in zip(fl_k, fl_p):
        assert a.shape == b.shape == sol.face_flux_shape
        assert _err(a, b) <= _bound(b, dtype)
    if not euler:
        assert torch.equal(out_k[:, :, :, 9:], u[:, :, :, 9:])  # materials frozen
        assert not any(a[:, :, 9:].any() for a in fl_k)
    assert torch.equal(cu.step(u, dt), cu.step(u, dt))
    assert cu.launches == {cu.kernels[0]: 3, "aderdg_face_flux": 4, "aderdg_surface_update": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["euler", "elastic"])
def test_kernel_info_reports_each_launch_shape(physics):
    for dtype in (torch.float32, torch.float64):
        _, cu, _ = (_setup if physics == "euler" else _ck_setup)((2, 2, 4), dtype)
        for name in cu.kernels:
            info = cu.kernel_info(name, dtype)
            assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, (name, info)
            assert info["threads"] % 32 == 0, (name, info)


# ------------------------------------------------ order 5: K1 c's space-time predictor


def _p5_setup(grid, dtype):
    """``examples/high_order_p5.py``'s solver and exact density wave (γ = 1.4,
    p0 = 2, velocity (1, 0.5, 0.25)) at ``grid``, dx = 1/g0, the density
    times 1 + 0.05 N(0, 1) (seeded) so that every node differs."""
    dev = _card()
    flux, eig = euler_physics(3)
    sol = ADERDGSolver(3, 5, 5, grid, flux, eig, dx=1.0 / grid[0], device=dev, dtype=dtype)
    phase = sum(np.asarray(c) for c in sol.nodes_meshgrid())
    no_var = sol.state_shape[:3] + sol.state_shape[4:]
    rho = np.broadcast_to(np.squeeze(1.0 + 0.2 * np.sin(2 * np.pi * phase), 3), no_var)
    rho = rho * (1.0 + 0.05 * np.random.default_rng(0).standard_normal(no_var))
    vel = (1.0, 0.5, 0.25)
    e = 2.0 / 0.4 + 0.5 * rho * sum(v * v for v in vel)
    q = np.stack([rho] + [rho * v for v in vel] + [e], axis=3)
    return sol, CudaADERDG(sol), torch.from_numpy(q).to(dev, dtype).contiguous()


P5_CASES = [
    (torch.float64, (4, 2, 8)),
    (torch.float64, (3, 1, 5)),  # ragged last block (15 cells, 2 a block), a one-cell axis
    (torch.float32, (4, 2, 8)),
    (torch.float32, (3, 1, 5)),
]
P5_DT = 2e-4  # under the CFL limit of this state at dx = 1/g0 <= 1/3
P5_NAMES = ("aderdg_predictor_volume_p5", "aderdg_face_flux_p5", "aderdg_surface_update_p5")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", P5_CASES)
def test_p5_predictor_kernel_matches_plain(dtype, grid):
    sol, cu, u = _p5_setup(grid, dtype)
    u0 = u.clone()
    new_k, faces_k, fv = cu.predictor_volume(u, P5_DT)
    new_p, faces_p, _ = sol.predictor_volume(u, P5_DT)
    torch.cuda.synchronize()
    assert torch.equal(u, u0) and fv is None
    assert _err(new_k, new_p) <= _bound(new_p, dtype)
    assert _err(faces_k, faces_p) <= _bound(faces_p, dtype)
    assert cu.kernels == P5_NAMES and cu.launches[P5_NAMES[0]] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", P5_CASES)
def test_p5_face_stage_matches_plain(dtype, grid):
    sol, cu, u = _p5_setup(grid, dtype)
    new, faces, _ = sol.predictor_volume(u, P5_DT)
    fhat_k, side = cu.face_flux(faces)
    fshape = sol.face_flux_shape
    fhat_p = torch.stack([
        sol.interface_flux(*(faces[d, k].reshape(fshape) for k in range(4)), d)
        for d in range(3)]).reshape(fhat_k.shape)
    upd_k = cu.surface_update(new.clone(), fhat_p, P5_DT)
    upd_p = new
    for d in range(3):
        upd_p = sol.surface_term(upd_p, fhat_p[d].view(fshape), d, P5_DT)
    out_k = cu.face_surface(new.clone(), faces, P5_DT)
    out_p = sol.face_surface(new, faces, P5_DT)
    torch.cuda.synchronize()
    assert side is None
    assert _err(fhat_k, fhat_p) <= _bound(fhat_p, dtype)
    assert _err(upd_k, upd_p) <= _bound(upd_p, dtype)
    assert _err(out_k, out_p) <= _bound(out_p, dtype)
    assert cu.launches == {P5_NAMES[0]: 0, P5_NAMES[1]: 2, P5_NAMES[2]: 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", P5_CASES)
def test_p5_step_kernels_match_plain_and_repeat_bitwise(dtype, grid):
    sol, cu, u = _p5_setup(grid, dtype)
    ref = sol.step(u, P5_DT)
    by_value = cu.step(u, P5_DT)
    by_pointer = cu.step(u, torch.tensor(P5_DT, dtype=dtype, device=u.device))
    torch.cuda.synchronize()
    assert _err(by_value, ref) <= _bound(ref, dtype)
    assert torch.equal(by_value, by_pointer)
    assert torch.equal(cu.run(u, 3, P5_DT), cu.run(u, 3, P5_DT))
    assert cu.launches == {name: 8 for name in P5_NAMES}


@pytest.mark.cuda
def test_p5_kernel_info_reports_the_n6_shapes():
    for dtype, smem, size in ((torch.float32, 60624, 4), (torch.float64, 121248, 8)):
        _, cu, _ = _p5_setup((2, 2, 4), dtype)
        pred, flux, update = (cu.kernel_info(name, dtype) for name in P5_NAMES)
        # 2 cells of 216 nodes a block; u, two flux buffers and Kvol in shared memory.
        assert pred["threads"] == 432 and pred["smem"] == smem == (7 * 5 * 432 + 36) * size
        assert pred["registers"] > 0 and pred["blocks_per_sm"] >= 1, pred
        assert flux["threads"] == 128 and update["threads"] == 256
        assert flux["smem"] == update["smem"] == 0


# ------------------------------------------------ the face stage's walls


def _smooth_euler(*x):
    """A smooth Euler state (var last) for Dirichlet rows that vary on
    every face."""
    rho = 1.0 + 0.2 * np.sin(2 * np.pi * x[0]) * np.cos(np.pi * x[2])
    vel = [0.3 + 0.1 * np.cos(2 * np.pi * x[d]) for d in range(3)]
    p = 2.0 + 0.1 * np.sin(np.pi * x[1])
    e = p / 0.4 + 0.5 * rho * sum(v * v for v in vel)
    return np.stack([rho] + [rho * v for v in vel] + [e], axis=-1)


def _euler_walls(name, grid, dx=DX):
    """The walls of each mode, as ``chip_smoke.py``'s walls path sets them."""
    from exahype_tpu_torch.models.aderdg import (
        euler_reflect,
        euler_reflect_flux,
        make_dirichlet_fn,
    )

    mirror = dict(reflect_fn=euler_reflect(3), reflect_flux_fn=euler_reflect_flux(3))
    farfield = (1.0, 2.0, 0.0, 0.0, 1.0 / 0.4 + 2.0)
    return {
        "reflective": dict(boundary="reflective", **mirror),
        "reflective_12": dict(boundary="reflective", wall_axes=(1, 2), **mirror),
        "outflow_0": dict(boundary="outflow", wall_axes=(0,)),
        "farfield_0": dict(boundary="farfield", farfield_state=farfield, wall_axes=(0,)),
        "dirichlet": dict(boundary="dirichlet", dirichlet_fn=make_dirichlet_fn(
            _smooth_euler, dim=3, order=3, grid_shape=grid, dx=dx)),
    }[name]


WALL_NAMES = ["reflective", "reflective_12", "outflow_0", "farfield_0", "dirichlet"]
#: (8, 4, 8): axis 2 is not a multiple of the 32-cell tile, so the ragged
#: tile's guard meets the walls; (3, 5, 7): odd extents.
WALL_CASES = [
    (torch.float64, (8, 4, 8)),
    (torch.float64, (3, 5, 7)),
    (torch.float32, (8, 4, 8)),
]


def _walled_face_stage_close(sol, cu, u, dt, dtype, close):
    """Each launch of the walled face stage and the stage against plain."""
    new, faces, _ = sol.predictor_volume(u, dt)
    fhat_k, fwall_k = cu.face_flux(faces)
    fshape = sol.face_flux_shape
    rows = cu._flux_rows
    plain = {}
    for d in range(3):
        q_lo, q_hi, f_lo, f_hi = (faces[d, k].reshape(fshape) for k in range(4))
        close(fhat_k[d].view(fshape)[:, :, :rows], sol.interface_flux(q_lo, q_hi, f_lo, f_hi, d)
              [:, :, :rows])
        if sol.is_wall(d):
            plain[d] = sol.low_wall_flux(q_lo, f_lo, d)
            close(cu.wall_fluxes(fwall_k)[d], plain[d])
    assert set(plain) == {d for d in range(3) if sol.is_wall(d)}
    out_k = cu.surface_update(new.clone(), fhat_k, dt, fwall_k)
    out_p = sol.face_surface(new, faces, dt)
    close(out_k, out_p)
    stage_k, fl_k = cu.face_surface(new.clone(), faces, dt, return_face_fluxes=True)
    _, fl_p = sol.face_surface(new, faces, dt, return_face_fluxes=True)
    assert torch.equal(stage_k, out_k)
    for a, b in zip(fl_k, fl_p):
        assert a.shape == b.shape == sol.face_flux_shape
        assert _err(a, b) <= _bound(b, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", WALL_CASES)
@pytest.mark.parametrize("name", WALL_NAMES)
def test_walled_face_stage_matches_plain(name, dtype, grid):
    """The face stage's wall variant, launch by launch and as a step, in
    every mode (Euler), against the plain solver's ``face_update``."""
    sol, cu, u = _setup(grid, dtype, **_euler_walls(name, grid))

    def close(got, ref):
        assert _err(got, ref) <= _bound(ref, dtype)

    _walled_face_stage_close(sol, cu, u, DT, dtype, close)
    ref = sol.run(u, 3, DT)
    by_value = cu.run(u, 3, DT)
    by_pointer = cu.run(u, 3, torch.tensor(DT, dtype=dtype, device=u.device))
    torch.cuda.synchronize()
    assert _err(by_value, ref) <= (1 if dtype == torch.float64 else 3) * _bound(ref, dtype)
    assert torch.equal(by_value, by_pointer)
    assert cu.launches["aderdg_predictor_volume"] == 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CK_CASES)
def test_elastic_free_surface_kernels_match_plain(dtype, grid):
    """The CK free surface (``wall_axes=(2,)``): the walled face stage and 3
    steps against plain, the materials bitwise frozen."""
    from exahype_tpu_torch.models.elastic import elastic3d_free_surface_het

    refl, refl_flux = elastic3d_free_surface_het()
    sol, cu, u = _ck_setup(grid, dtype, boundary="reflective", reflect_fn=refl,
                           reflect_flux_fn=refl_flux, wall_axes=(2,))
    def close(got, ref):
        if got.dim() == 7:  # states
            _ck_err(got, ref, dtype)
        else:  # face rows (var axis 2): the evolved rows
            g, r = got.narrow(2, 0, 9), ref.narrow(2, 0, 9)
            assert _err(g, r) <= _bound(r, dtype)

    _walled_face_stage_close(sol, cu, u, CK_DT, dtype, close)
    ref = sol.run(u, 3, CK_DT)
    got = cu.run(u, 3, CK_DT)
    torch.cuda.synchronize()
    rounds = 1 if dtype == torch.float64 else 3
    for lo, n in ((0, 9), (9, 3)):
        assert _err(got.narrow(3, lo, n), ref.narrow(3, lo, n)) <= rounds * _bound(
            ref.narrow(3, lo, n), dtype)
    assert torch.equal(got[:, :, :, 9:], u[:, :, :, 9:])  # bitwise frozen


@pytest.mark.cuda
@pytest.mark.parametrize("name", WALL_NAMES)
def test_walled_kernel_info_and_refusals(name):
    sol, cu, u = _setup((2, 2, 4), torch.float64, **_euler_walls(name, (2, 2, 4)))
    for kernel in ("aderdg_face_flux", "aderdg_surface_update"):
        info = cu.kernel_info(kernel, torch.float64)
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, (kernel, info)
    new, faces, _ = sol.predictor_volume(u, DT)
    fhat, fwall = cu.face_flux(faces)
    with pytest.raises(LoweringError, match="fwall"):
        cu.surface_update(new, fhat, DT)


# ------------------- orders 4 and 7, and walls at 4, 5 and 7: K1 c's other instances


def _st_setup(order, grid, dtype, **walls):
    """``_p5_setup``'s solver and noisy density wave at ``order`` (4, 5 or
    7), with ``walls``."""
    dev = _card()
    flux, eig = euler_physics(3)
    sol = ADERDGSolver(3, order, 5, grid, flux, eig, dx=1.0 / grid[0], device=dev,
                       dtype=dtype, **walls)
    phase = sum(np.asarray(c) for c in sol.nodes_meshgrid())
    no_var = sol.state_shape[:3] + sol.state_shape[4:]
    rho = np.broadcast_to(np.squeeze(1.0 + 0.2 * np.sin(2 * np.pi * phase), 3), no_var)
    rho = rho * (1.0 + 0.05 * np.random.default_rng(order).standard_normal(no_var))
    vel = (1.0, 0.5, 0.25)
    e = 2.0 / 0.4 + 0.5 * rho * sum(v * v for v in vel)
    q = np.stack([rho] + [rho * v for v in vel] + [e], axis=3)
    return sol, CudaADERDG(sol), torch.from_numpy(q).to(dev, dtype).contiguous()


#: Order 4: 2 cells of 125 nodes a block, so (3, 1, 5)'s 15 cells leave a
#: ragged last block; order 7: a cell a block.  Axis 2 below the 32-cell
#: tile in each.
ST_CASES = [
    (4, torch.float64, (4, 2, 8)),
    (4, torch.float64, (3, 1, 5)),
    (4, torch.float32, (4, 2, 8)),
    (7, torch.float64, (2, 2, 3)),
    (7, torch.float64, (3, 1, 2)),
    (7, torch.float32, (2, 2, 3)),
]


def _st_names(order, walled=False):
    w = "_walls" if walled else ""
    return (f"aderdg_predictor_volume_p{order}", f"aderdg_face_flux{w}_p{order}",
            f"aderdg_surface_update{w}_p{order}")


@pytest.mark.cuda
@pytest.mark.parametrize("order,dtype,grid", ST_CASES)
def test_st_orders_predictor_kernel_matches_plain(order, dtype, grid):
    sol, cu, u = _st_setup(order, grid, dtype)
    u0 = u.clone()
    new_k, faces_k, fv = cu.predictor_volume(u, P5_DT)
    new_p, faces_p, _ = sol.predictor_volume(u, P5_DT)
    torch.cuda.synchronize()
    assert torch.equal(u, u0) and fv is None
    assert _err(new_k, new_p) <= _bound(new_p, dtype)
    assert _err(faces_k, faces_p) <= _bound(faces_p, dtype)
    assert cu.kernels == _st_names(order) and cu.launches[cu.kernels[0]] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("order,dtype,grid", ST_CASES)
def test_st_orders_face_stage_matches_plain(order, dtype, grid):
    sol, cu, u = _st_setup(order, grid, dtype)
    new, faces, _ = sol.predictor_volume(u, P5_DT)
    fhat_k, side = cu.face_flux(faces)
    fshape = sol.face_flux_shape
    fhat_p = torch.stack([
        sol.interface_flux(*(faces[d, k].reshape(fshape) for k in range(4)), d)
        for d in range(3)]).reshape(fhat_k.shape)
    upd_k = cu.surface_update(new.clone(), fhat_p, P5_DT)
    upd_p = new
    for d in range(3):
        upd_p = sol.surface_term(upd_p, fhat_p[d].view(fshape), d, P5_DT)
    out_k = cu.face_surface(new.clone(), faces, P5_DT)
    out_p = sol.face_surface(new, faces, P5_DT)
    torch.cuda.synchronize()
    assert side is None
    assert _err(fhat_k, fhat_p) <= _bound(fhat_p, dtype)
    assert _err(upd_k, upd_p) <= _bound(upd_p, dtype)
    assert _err(out_k, out_p) <= _bound(out_p, dtype)
    names = _st_names(order)
    assert cu.launches == {names[0]: 0, names[1]: 2, names[2]: 2}


@pytest.mark.cuda
@pytest.mark.parametrize("order,dtype,grid", ST_CASES)
def test_st_orders_step_kernels_match_plain_and_repeat_bitwise(order, dtype, grid):
    sol, cu, u = _st_setup(order, grid, dtype)
    ref = sol.step(u, P5_DT)
    by_value = cu.step(u, P5_DT)
    by_pointer = cu.step(u, torch.tensor(P5_DT, dtype=dtype, device=u.device))
    torch.cuda.synchronize()
    assert _err(by_value, ref) <= _bound(ref, dtype)
    assert torch.equal(by_value, by_pointer)
    assert torch.equal(cu.run(u, 3, P5_DT), cu.run(u, 3, P5_DT))
    assert cu.launches == {name: 8 for name in _st_names(order)}


@pytest.mark.cuda
def test_st_orders_kernel_info_reports_the_shapes():
    # (order, dtype): threads a block, shared memory (u, two flux buffers,
    # Kvol), face tiles.
    for order, dtype, threads, smem, tiles in (
            (4, torch.float32, 250, (7 * 5 * 250 + 25) * 4, (160, 160)),
            (4, torch.float64, 250, (7 * 5 * 250 + 25) * 8, (160, 160)),
            (7, torch.float32, 512, (7 * 5 * 512 + 64) * 4, (128, 256)),
            (7, torch.float64, 512, (7 * 5 * 512 + 64) * 8, (128, 256))):
        _, cu, _ = _st_setup(order, (2, 2, 4), dtype)
        pred, flux, update = (cu.kernel_info(name, dtype) for name in cu.kernels)
        assert pred["threads"] == threads and pred["smem"] == smem, (order, dtype, pred)
        assert pred["registers"] > 0 and pred["blocks_per_sm"] >= 1, pred
        assert (flux["threads"], update["threads"]) == tiles
        assert flux["smem"] == update["smem"] == 0


def _st_walls(name, order, grid):
    """Each wall mode of ``_euler_walls`` at ``order`` (its Dirichlet rows
    from ``make_dirichlet_fn`` at that order)."""
    from exahype_tpu_torch.models.aderdg import make_dirichlet_fn

    if name != "dirichlet":
        return _euler_walls(name, grid)
    return dict(boundary="dirichlet", dirichlet_fn=make_dirichlet_fn(
        _smooth_euler, dim=3, order=order, grid_shape=grid, dx=1.0 / grid[0]))


#: (order, dtype, grid): float64 at a grid whose axis 2 is below the tile
#: and whose axis 0 has odd extent, float32 at one.
ST_WALL_CASES = [
    (4, torch.float64, (3, 2, 5)),
    (4, torch.float32, (3, 2, 5)),
    (5, torch.float64, (3, 2, 5)),
    (5, torch.float32, (3, 2, 5)),
    (7, torch.float64, (3, 2, 2)),
    (7, torch.float32, (3, 2, 2)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("order,dtype,grid", ST_WALL_CASES)
@pytest.mark.parametrize("name", WALL_NAMES)
def test_st_orders_walled_face_stage_matches_plain(name, order, dtype, grid):
    """The walled pair at n = 5, 6 and 8, launch by launch, as a stage and
    in 3 steps, in every mode, against the plain solver's ``face_update``."""
    sol, cu, u = _st_setup(order, grid, dtype, **_st_walls(name, order, grid))
    assert cu.kernels == _st_names(order, walled=True)

    def close(got, ref):
        assert _err(got, ref) <= _bound(ref, dtype)

    _walled_face_stage_close(sol, cu, u, P5_DT, dtype, close)
    ref = sol.run(u, 3, P5_DT)
    by_value = cu.run(u, 3, P5_DT)
    by_pointer = cu.run(u, 3, torch.tensor(P5_DT, dtype=dtype, device=u.device))
    torch.cuda.synchronize()
    assert _err(by_value, ref) <= (1 if dtype == torch.float64 else 3) * _bound(ref, dtype)
    assert torch.equal(by_value, by_pointer)
    assert cu.launches[cu.kernels[0]] == 6
    for kernel in cu.kernels[1:]:
        info = cu.kernel_info(kernel, dtype)
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, (kernel, info)


# ------------------------------------------------ the viscous step (K1 b)

NS_MU, NS_PRANDTL = 0.02, 0.7
#: (8, 4, 8): the ragged tile meets the walls; (3, 5, 7): odd extents and a
#: ragged last predictor block.
NS_CASES = [
    (torch.float64, (8, 4, 8)),
    (torch.float64, (3, 5, 7)),
    (torch.float32, (8, 4, 8)),
]
NS_WALLS = ["periodic", "noslip_0", "noslip_box", "outflow_0", "farfield_0", "dirichlet"]


def _ns_walls(name, grid, dx):
    from exahype_tpu_torch.models.aderdg import make_dirichlet_fn
    from exahype_tpu_torch.models.navier_stokes import noslip_reflect, noslip_reflect_flux

    noslip = dict(boundary="reflective", reflect_fn=noslip_reflect(3),
                  reflect_flux_fn=noslip_reflect_flux(3))
    return {
        "periodic": {},
        "noslip_0": dict(noslip, wall_axes=(0,)),
        "noslip_box": noslip,
        "outflow_0": dict(boundary="outflow", wall_axes=(0,)),
        "farfield_0": dict(boundary="farfield", farfield_state=(1.0, 0.3, 0.0, 0.0, 2.6),
                           wall_axes=(0,)),
        "dirichlet": dict(boundary="dirichlet", dirichlet_fn=make_dirichlet_fn(
            _smooth_euler, dim=3, order=3, grid_shape=grid, dx=dx)),
    }[name]


def _ns_setup(grid, dtype, walls="periodic"):
    """A 3-D p3 Navier–Stokes solver at dx = 1/g0 on a random admissible
    state (random momenta: every gradient is O(1/dx)); dt = its cfl_dt."""
    from exahype_tpu_torch.models.navier_stokes import navier_stokes

    dev = _card()
    dx = 1.0 / grid[0]
    flux, eig, visc, visc_eig = navier_stokes(3, mu=NS_MU, prandtl=NS_PRANDTL)
    sol = ADERDGSolver(3, 3, 5, grid, flux, eig, dx=dx, device=dev, dtype=dtype,
                       visc_flux_fn=visc, visc_eigenvalue_fn=visc_eig,
                       **_ns_walls(walls, grid, dx))
    rng = np.random.default_rng(1)
    no_var = (4, 4, 4) + grid
    rho = 1.0 + 0.2 * rng.random(no_var)
    m = [0.3 * rng.standard_normal(no_var) for _ in range(3)]
    p = 1.0 + 0.2 * rng.random(no_var)
    e = p / 0.4 + 0.5 * sum(x * x for x in m) / rho
    u = torch.from_numpy(np.stack([rho] + m + [e], axis=3)).to(dev, dtype).contiguous()
    return sol, CudaADERDG(sol), u, float(sol.cfl_dt(u))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", NS_CASES)
@pytest.mark.parametrize("walls", NS_WALLS)
def test_viscous_predictor_kernel_matches_plain(walls, dtype, grid):
    """``aderdg_predictor_volume_visc``: the new state, the face tensor and,
    with walls, the viscous-only wall planes."""
    sol, cu, u, dt = _ns_setup(grid, dtype, walls)
    u0 = u.clone()
    got = cu.predictor_volume(u, dt)
    ref = sol.predictor_volume(u, dt)
    torch.cuda.synchronize()
    assert torch.equal(u, u0)
    assert len(got) == len(ref) == 3
    assert (got[2] is None) == (ref[2] is None) == (walls == "periodic")
    for a, b in zip(got, ref):
        if b is None:
            continue
        assert a.shape == b.shape
        assert _err(a, b) <= _bound(b, dtype)
    assert cu.launches["aderdg_predictor_volume_visc"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", NS_CASES)
@pytest.mark.parametrize("walls", NS_WALLS)
def test_viscous_face_stage_matches_plain(walls, dtype, grid):
    """The Navier–Stokes face stage (the Gassner penalty; with walls the
    advective/viscous split), launch by launch and as a stage."""
    sol, cu, u, dt = _ns_setup(grid, dtype, walls)
    new, faces, fvwall = sol.predictor_volume(u, dt)
    fhat_k, fwall_k = cu.face_flux(faces, fvwall)
    fshape = sol.face_flux_shape
    rows = sol.visc_wall_rows(fvwall) if fvwall is not None else {}
    low = {}
    for d in range(3):
        q_lo, q_hi, f_lo, f_hi = (faces[d, k].reshape(fshape) for k in range(4))
        fv_lo, fv_hi = rows.get(d, (None, None))
        ref = sol.interface_flux(q_lo, q_hi, f_lo, f_hi, d, fv_hi)
        assert _err(fhat_k[d].view(fshape), ref) <= _bound(ref, dtype)
        if sol.is_wall(d):
            low[d] = sol.low_wall_flux(q_lo, f_lo, d, fv_lo)
            assert _err(cu.wall_fluxes(fwall_k)[d], low[d]) <= _bound(low[d], dtype)
    out_k = cu.surface_update(new.clone(), fhat_k, dt, fwall_k)
    out_p = sol.face_surface(new, faces, dt, fvwall=fvwall)
    stage_k = cu.face_surface(new.clone(), faces, dt, fvwall=fvwall)
    torch.cuda.synchronize()
    assert _err(out_k, out_p) <= _bound(out_p, dtype)
    assert torch.equal(stage_k, out_k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", NS_CASES)
@pytest.mark.parametrize("walls", NS_WALLS)
def test_viscous_step_matches_plain_and_repeats_bitwise(walls, dtype, grid):
    sol, cu, u, dt = _ns_setup(grid, dtype, walls)
    ref = sol.run(u, 3, dt)
    by_value = cu.run(u, 3, dt)
    by_pointer = cu.run(u, 3, torch.tensor(dt, dtype=dtype, device=u.device))
    torch.cuda.synchronize()
    assert _err(by_value, ref) <= (1 if dtype == torch.float64 else 3) * _bound(ref, dtype)
    assert torch.equal(by_value, by_pointer)
    assert cu.launches == {name: 6 for name in cu.kernels}
    m0, m1 = cu.total_mass(u.double()), cu.total_mass(by_value.double())
    if walls == "periodic":  # mass, momentum and energy conserved
        assert ((m1 - m0).abs() / m0.abs().clamp(min=1.0)).max().item() < (
            1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("walls", ["periodic", "noslip_0"])
def test_viscous_kernel_info_and_refusals(walls):
    for dtype in (torch.float32, torch.float64):
        sol, cu, u, dt = _ns_setup((2, 2, 4), dtype, walls)
        for name in cu.kernels:
            info = cu.kernel_info(name, dtype)
            assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, (name, info)
            assert info["threads"] % 32 == 0, (name, info)
    new, faces, fvwall = sol.predictor_volume(u, dt)
    if fvwall is not None:
        with pytest.raises(LoweringError, match="fvwall"):
            cu.face_flux(faces)
    else:
        with pytest.raises(LoweringError, match="fvwall"):
            cu.face_flux(faces, torch.zeros(8, dtype=u.dtype, device=u.device))


# ------------------------------------------------ K3: the subcell row sweep


def _limiter(grid, dtype, dx=DX, kernels=False):
    """The bench's limiter over a fresh solver, capacity 8 rows; with
    ``kernels`` the candidate and the sweeps go through the kernels."""
    from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible

    sol, cu, _ = _setup(grid, dtype, dx)
    return LimitedADERDG(sol, euler_admissible(3), troubled_capacity=8,
                         troubled_granularity="row", dmp_delta0=5e-4,
                         accelerator=cu if kernels else None, subcell_cuda=kernels,
                         device=sol.weights.device), cu


def _sweep_inputs(d, K, L, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)

    def state(shape):
        lead = shape[:3] + shape[4:]
        rho = 1.0 + 0.3 * rng.random(lead)
        mom = [0.4 * rng.standard_normal(lead) for _ in range(3)]
        E = 2.5 + rng.random(lead)
        return torch.from_numpy(np.stack([rho, *mom, E], axis=3)).to(dev, dtype).contiguous()

    shape = (7, 7, 7, 5, K, L)
    gshape = list(shape)
    gshape[d] = 1
    return state(shape), state(tuple(gshape)), state(tuple(gshape))


SWEEP_CASES = [
    (d, dtype, K, L)
    for d in (0, 1, 2)
    for dtype, K, L in ((torch.float64, 8, 16), (torch.float32, 4, 33))
]


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,K,L", SWEEP_CASES)
def test_subcell_sweep_kernel_matches_plain(d, dtype, K, L):
    """The in-place contract for n_active in {0, 1, K//2, K}: the active
    slots as the plain sweep gives them, the others bitwise untouched with
    zero edge fluxes, the ghosts unchanged, bitwise repeatable, dt by value
    and by pointer alike (L = 33: blocks of 32 cells straddle slots)."""
    from exahype_tpu_torch.models import subcell_cuda

    lim, _ = _limiter((4, 2, 8), dtype)
    s0, lo, hi = _sweep_inputs(d, K, L, dtype, lim.P.device)
    lo0, hi0 = lo.clone(), hi.clone()
    ref = lim._row_sweep_math(s0, lo, hi, d, DT)
    subcell_cuda.reset_launches()
    for n in sorted({0, 1, K // 2, K}):
        n_active = torch.tensor(n, device=s0.device)
        s1, s2 = s0.clone(), s0.clone()
        got = subcell_cuda.row_sweep_call(lim, d, s1, lo, hi, DT, n_active)
        again = subcell_cuda.row_sweep_call(
            lim, d, s2, lo, hi, torch.tensor(DT, dtype=dtype, device=s0.device), n_active)
        torch.cuda.synchronize()
        assert got[0] is s1 and again[0] is s2
        for a, b, c in zip(got, again, ref):
            assert a.shape == c.shape
            if n:
                act = c[..., :n, :]
                assert _err(a[..., :n, :], act) <= _bound(act, dtype), n
            assert torch.equal(a, b), n  # bitwise repeatable, dt by value == by pointer
        assert torch.equal(s1[..., n:, :], s0[..., n:, :]), n
        assert not got[1][:, n:].any() and not got[2][:, n:].any(), n
        assert torch.equal(lo, lo0) and torch.equal(hi, hi0)
    assert subcell_cuda.launches["subcell_row_sweep"] == 2 * len({0, 1, K // 2, K})


@pytest.mark.cuda
def test_subcell_sweep_kernel_refuses_what_it_is_not_built_for():
    from exahype_tpu_torch.models import subcell_cuda
    from exahype_tpu_torch.utils.errors import LoweringError

    lim, _ = _limiter((4, 2, 8), torch.float64)
    s, lo, hi = _sweep_inputs(0, 2, 8, torch.float64, lim.P.device)
    n_active = torch.tensor(2, device=s.device)
    with pytest.raises(LoweringError, match="shape"):
        subcell_cuda.row_sweep_call(lim, 0, s, hi[:, :, :, :, :1].contiguous(), hi, DT,
                                    n_active)
    with pytest.raises(LoweringError, match="contiguous"):
        subcell_cuda.row_sweep_call(lim, 0, s.transpose(4, 5), lo, hi, DT, n_active)
    for bad in (torch.tensor(2), n_active.int(), 2):  # the CPU, int32, not a tensor
        with pytest.raises(LoweringError, match="n_active"):
            subcell_cuda.row_sweep_call(lim, 0, s, lo, hi, DT, bad)


@pytest.mark.cuda
def test_subcell_sweep_kernel_info():
    from exahype_tpu_torch.models import subcell_cuda

    _card()
    for dtype in (torch.float32, torch.float64):
        for d in range(3):
            info = subcell_cuda.kernel_info(dtype, d)
            assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, info
            assert info["threads"] == 224 and info["clusters"] >= 1, info


@pytest.mark.cuda
def test_limited_step_kernels_match_plain():
    """The limited step with the candidate and sweeps on the kernels
    against the plain path on the card: the Sod shock, capacity 8 rows, two
    steps (the first flags rows); masks equal and states at 1e-12."""
    from exahype_tpu_torch.models import subcell_cuda

    grid = (8, 2, 16)
    lim_k, cu = _limiter(grid, torch.float64, dx=1.0 / 8, kernels=True)
    lim_p, _ = _limiter(grid, torch.float64, dx=1.0 / 8)
    left = np.broadcast_to(np.arange(grid[0]).reshape(-1, 1, 1) < grid[0] // 2, grid)
    rho = np.broadcast_to(np.where(left, 1.0, 0.125), (4, 4, 4) + grid)
    p = np.broadcast_to(np.where(left, 1.0, 0.1), (4, 4, 4) + grid)
    zero = np.zeros_like(rho)
    q = np.stack([rho, zero, zero, zero, p / 0.4], axis=3)
    u = torch.from_numpy(q).to(lim_k.P.device).contiguous()
    subcell_cuda.reset_launches()
    a = b = u
    for _ in range(2):
        a, b = lim_k.step(a, 4.8e-3), lim_p.step(b, 4.8e-3)
    torch.cuda.synchronize()
    assert _err(a, b) <= 1e-12
    assert cu.launches == {"aderdg_predictor_volume": 2, "aderdg_face_flux": 2,
                           "aderdg_surface_update": 2}
    assert subcell_cuda.launches["subcell_row_sweep"] == 6
    assert torch.equal(lim_k.run(u, 2, 4.8e-3), a)


# ------------------------------------- K3 a: the Z4+GRHD p2 sweep with NCP


def _z4m_limiter(grid, dtype, kernels=False, capacity=8):
    """A limiter over the Z4+GRHD p2 solver on the card (geodesic slicing,
    dx = 1/8); with ``kernels`` the candidate through ``CudaADERDG`` and the
    sweeps through K3 a."""
    from exahype_tpu_torch.models.limiter import LimitedADERDG
    from exahype_tpu_torch.models.z4_matter import make_z4_matter_solver, z4_matter_admissible

    dev = _card()
    sol = make_z4_matter_solver(3, 2, grid, dx=1.0 / 8, slicing="harmonic", f=0.0,
                                fused_rhs="soa", device=dev, dtype=dtype)
    cu = CudaADERDG(sol)
    return LimitedADERDG(sol, z4_matter_admissible(), troubled_capacity=capacity,
                         troubled_granularity="row", accelerator=cu if kernels else None,
                         subcell_cuda=kernels, device=dev), cu


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(d, t) for d in (0, 1, 2)
                                     for t in (torch.float64, torch.float32)])
def test_z4_matter_sweep_kernel_matches_plain(d, dtype):
    """K3 a (``subcell_row_sweep_z4_matter``) in place for n_active in {0, 1,
    K}: the active slots as the plain sweep gives them (f64 at 1e-12 of
    max(1, max|plain|), f32 at 64 spacings), the others bitwise untouched
    with zero edge fluxes, the ghosts unchanged, bitwise repeatable, dt by
    value and by pointer alike (K = 3, L = 20: a block of 32 cells
    straddles slots)."""
    from exahype_tpu_torch.models import subcell_cuda

    lim, _ = _z4m_limiter((2, 2, 4), dtype)
    dev = lim.P.device
    K, L = 3, 20
    s0 = z4m_gathered_batch((5, 5, 5, 43, K, L), 1, dtype, dev)
    gshape = [5, 5, 5, 43, K, L]
    gshape[d] = 1
    lo, hi = (z4m_gathered_batch(tuple(gshape), seed, dtype, dev) for seed in (2, 3))
    lo0, hi0 = lo.clone(), hi.clone()
    ref = lim._row_sweep_math(s0, lo, hi, d, DT)
    subcell_cuda.reset_launches()
    for n in (0, 1, K):
        n_active = torch.tensor(n, device=dev)
        s1, s2 = s0.clone(), s0.clone()
        got = subcell_cuda.row_sweep_call(lim, d, s1, lo, hi, DT, n_active)
        again = subcell_cuda.row_sweep_call(
            lim, d, s2, lo, hi, torch.tensor(DT, dtype=dtype, device=dev), n_active)
        torch.cuda.synchronize()
        assert got[0] is s1 and again[0] is s2
        for a, b, c in zip(got, again, ref):
            if n:
                act = c[..., :n, :]
                bar = (1e-12 * max(1.0, act.abs().max().item()) if dtype == torch.float64
                       else _bound(act, dtype))
                assert _err(a[..., :n, :], act) <= bar, n
            assert torch.equal(a, b), n
        assert torch.equal(s1[..., n:, :], s0[..., n:, :]), n
        assert not got[1][:, n:].any() and not got[2][:, n:].any(), n
        assert torch.equal(lo, lo0) and torch.equal(hi, hi0)
    assert subcell_cuda.launches == {"subcell_row_sweep": 0, "subcell_row_sweep_z4_matter": 6}


@pytest.mark.cuda
def test_z4_matter_sweep_kernel_info_and_refusals():
    """K3 a's occupancy (one block an SM: 5 warps in f32, 2 in f64) and the
    refusals on the card: a Z4+GRMHD limiter with ``subcell_cuda=True``
    (ROADMAP Queue 2 K3 a), a batch of the wrong shape."""
    from exahype_tpu_torch.models import subcell_cuda
    from exahype_tpu_torch.models.limiter import LimitedADERDG
    from exahype_tpu_torch.models.z4_grmhd import make_z4_grmhd_solver

    dev = _card()
    for dtype, threads in ((torch.float32, 160), (torch.float64, 64)):
        for d in range(3):
            info = subcell_cuda.kernel_info(dtype, d, "z4_matter")
            assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, info
            assert info["threads"] == threads and info["smem"] > 48 * 1024, info
    with pytest.raises(LoweringError, match="ROADMAP.md, Queue 2 K3 a"):
        LimitedADERDG(make_z4_grmhd_solver(3, 2, (2, 2, 2), fused_rhs="soa", device=dev),
                      troubled_capacity=2, troubled_granularity="row", subcell_cuda=True,
                      device=dev)
    lim, _ = _z4m_limiter((2, 2, 4), torch.float64)
    s = z4m_gathered_batch((5, 5, 5, 43, 2, 4), 1, torch.float64, dev)
    with pytest.raises(LoweringError, match="shape"):
        subcell_cuda.row_sweep_call(lim, 0, s, s[:1].contiguous(), s[:, :1].contiguous(), DT,
                                    torch.tensor(2, device=dev))


@pytest.mark.cuda
def test_limited_z4_matter_step_kernels_match_plain():
    """The limited Z4+GRHD step on the kernels (K1 d's candidate, K3 a's
    sweeps) against the plain limited step on the card in f64: the FLRW
    slice with a one-cell clump at (4, 4, 8), capacity 8 rows, two steps;
    states within 1e-12 of max(1, max|plain|), launches counted, bitwise
    repeatable."""
    from exahype_tpu_torch.models import subcell_cuda
    from exahype_tpu_torch.models.z4_matter import flrw_state

    grid = (4, 4, 8)
    lim_k, cu = _z4m_limiter(grid, torch.float64, kernels=True)
    lim_p, _ = _z4m_limiter(grid, torch.float64)
    sol = lim_k.solver
    u = flrw_state(sol, 1.0, float(np.sqrt(8 * np.pi * 0.02 * 1.4 / 3)), rho0=0.02, eps0=0.4)
    r2 = 0.0
    for d, c in enumerate(sol.nodes_meshgrid()):
        r2 = r2 + (np.squeeze(c, sol.var_axis) - 0.5 * grid[d] / 8) ** 2
    bump = torch.from_numpy(np.ascontiguousarray(1.0 + 4.0 * np.exp(-r2 / (2 / 64)))).to(u)
    u = u.clone()
    for slot in (38, 42):
        u.narrow(sol.var_axis, slot, 1).mul_(bump.unsqueeze(sol.var_axis))
    u = u.contiguous()
    cu.reset_launches()
    subcell_cuda.reset_launches()
    a = b = u
    for _ in range(2):
        a, b = lim_k.step(a, 1e-4), lim_p.step(b, 1e-4)
    torch.cuda.synchronize()
    assert _err(a, b) <= 1e-12 * max(1.0, b.abs().max().item())
    assert set(cu.launches.values()) == {2}
    assert subcell_cuda.launches["subcell_row_sweep_z4_matter"] == 6
    assert torch.equal(lim_k.run(u, 2, 1e-4), a)


# ------------------------------------------------ the 2-D Euler step (K1 c)


def _setup_2d(grid, dtype, name="periodic"):
    """A 2-D p3 Euler solver on the card (dx = 1/g0) in wall mode ``name``,
    its ``CudaADERDG`` and a seeded state with flow along both axes."""
    from exahype_tpu_torch.models.aderdg import (
        euler_reflect,
        euler_reflect_flux,
        make_dirichlet_fn,
    )

    dev = _card()
    dx = 1.0 / grid[0]

    def held(*x):
        rho = 1.0 + 0.2 * np.sin(2 * np.pi * x[0]) * np.cos(np.pi * x[1])
        vel = (0.3 + 0.1 * np.cos(2 * np.pi * x[1]), -0.2 + 0.1 * np.sin(np.pi * x[0]))
        e = (2.0 + 0.1 * np.sin(np.pi * x[1])) / 0.4 + 0.5 * rho * sum(v * v for v in vel)
        return np.stack([rho, rho * vel[0], rho * vel[1], e], axis=-1)

    mirror = dict(reflect_fn=euler_reflect(2), reflect_flux_fn=euler_reflect_flux(2))
    walls = {
        "periodic": {},
        "reflective": dict(boundary="reflective", **mirror),
        "reflective_1": dict(boundary="reflective", wall_axes=(1,), **mirror),
        "outflow_0": dict(boundary="outflow", wall_axes=(0,)),
        "farfield_0": dict(boundary="farfield", farfield_state=(1.0, 2.0, 0.0, 1.0 / 0.4 + 2.0),
                           wall_axes=(0,)),
        "dirichlet": dict(boundary="dirichlet", dirichlet_fn=make_dirichlet_fn(
            held, dim=2, order=3, grid_shape=grid, dx=dx)),
    }[name]
    flux, eig = euler_physics(2, n_real=4)
    sol = ADERDGSolver(2, 3, 4, grid, flux, eig, dx=dx, device=dev, dtype=dtype, **walls)
    rng = np.random.default_rng(2)
    rho = 1.0 + 0.2 * rng.random((4, 4) + grid)
    q = np.stack([rho, 0.5 * rho, -0.3 * rho, 5.0 + 0.5 * rho], axis=2)
    return sol, CudaADERDG(sol), torch.from_numpy(q).to(dev, dtype).contiguous()


NAMES_2D = ["periodic", "reflective", "reflective_1", "outflow_0", "farfield_0", "dirichlet"]
#: (8, 8); (5, 7): a ragged last block of the predictor (16 cells) and of
#: the face stage (128), odd extents; f32 at (64, 48).
CASES_2D = [(torch.float64, (8, 8)), (torch.float64, (5, 7)), (torch.float32, (64, 48))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CASES_2D)
@pytest.mark.parametrize("name", NAMES_2D)
def test_2d_kernels_match_plain(name, dtype, grid):
    """``csrc/aderdg_2d.cu`` launch by launch against the plain solver:
    the predictor's new state and faces, the face flux's F̂ (and with walls
    its side tensor), the update, the stage with its face fluxes, and 3
    steps (dt by value and by pointer, bitwise equal)."""
    sol, cu, u = _setup_2d(grid, dtype, name)
    dt = 0.5 * float(sol.cfl_dt(u))

    def close(got, ref, rounds=1):
        assert _err(got, ref) <= rounds * _bound(ref, dtype)

    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    close(new_k, new_p)
    close(faces_k, faces_p)
    fhat, fwall = cu.face_flux(faces_p)
    fshape = sol.face_flux_shape
    plain, walls = [], {}
    for d in range(2):
        q_lo, q_hi, f_lo, f_hi = (faces_p[d, k].reshape(fshape) for k in range(4))
        plain.append(sol.interface_flux(q_lo, q_hi, f_lo, f_hi, d))
        close(fhat[d].view(fshape), plain[d])
        if sol.is_wall(d):
            walls[d] = sol.low_wall_flux(q_lo, f_lo, d)
            close(cu.wall_fluxes(fwall)[d], walls[d])
    assert (fwall is None) == (name == "periodic")
    side = None if fwall is None else torch.cat([walls[d].reshape(-1) for d in sorted(walls)])
    upd = cu.surface_update(new_p.clone(), torch.stack(plain).view(fhat.shape), dt, side)
    ref = new_p
    for d in range(2):
        ref = sol.surface_term(ref, plain[d], d, dt, walls.get(d))
    close(upd, ref)
    stage, fl_k = cu.face_surface(new_p.clone(), faces_p, dt, return_face_fluxes=True)
    stage_p, fl_p = sol.face_surface(new_p, faces_p, dt, return_face_fluxes=True)
    close(stage, stage_p)
    for a, b in zip(fl_k, fl_p):
        close(a, b)
    by_value = cu.run(u, 3, dt)
    by_pointer = cu.run(u, 3, torch.tensor(dt, dtype=dtype, device=u.device))
    torch.cuda.synchronize()
    close(by_value, sol.run(u, 3, dt), 1 if dtype == torch.float64 else 3)
    assert torch.equal(by_value, by_pointer)
    # The predictor: 1 + 2 x 3; the face pair: once alone, once in the stage, 2 x 3.
    assert cu.launches == dict(zip(cu.kernels, (7, 8, 8)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["periodic", "reflective"])
def test_2d_kernel_info(name):
    sol, cu, _ = _setup_2d((4, 4), torch.float32, name)
    suffix = "_walls_2d" if name != "periodic" else "_2d"
    assert cu.kernels == ("aderdg_predictor_volume_2d", f"aderdg_face_flux{suffix}",
                          f"aderdg_surface_update{suffix}")
    for kernel in cu.kernels:
        for dtype in (torch.float32, torch.float64):
            info = cu.kernel_info(kernel, dtype)
            assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, (kernel, info)
    assert cu.kernel_info(cu.kernels[0], torch.float32)["threads"] == 256


@pytest.mark.cuda
def test_walled_limited_steps_match_plain():
    """The limited step with walls on the card against the plain limiter,
    f64 at 1e-12: the gathered rows in a 3-D reflective box at (8, 4, 8)
    (CudaADERDG's walled face stage and K3), and the whole-grid subcell
    fallback in the 2-D reflective box (the 2-D kernels)."""
    from exahype_tpu_torch.models import subcell_cuda
    from exahype_tpu_torch.models.aderdg import euler_reflect, euler_reflect_flux
    from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible

    mirror = dict(boundary="reflective", reflect_fn=euler_reflect(3),
                  reflect_flux_fn=euler_reflect_flux(3))
    grid = (8, 4, 8)
    sol, cu, _ = _setup(grid, torch.float64, 1.0 / 8, **mirror)
    opts = dict(troubled_capacity=8, troubled_granularity="row", dmp_delta0=5e-4,
                device=sol.weights.device)
    lim_k = LimitedADERDG(sol, euler_admissible(3), accelerator=cu, subcell_cuda=True, **opts)
    lim_p = LimitedADERDG(sol, euler_admissible(3), **opts)
    left = np.broadcast_to(np.arange(grid[0]).reshape(-1, 1, 1) < grid[0] // 2, grid)
    rho = np.broadcast_to(np.where(left, 1.0, 0.125), (4, 4, 4) + grid)
    p = np.broadcast_to(np.where(left, 1.0, 0.1), (4, 4, 4) + grid)
    zero = np.zeros_like(rho)
    q = np.stack([rho, 0.5 * rho, zero, zero, p / 0.4 + 0.125 * rho], axis=3)
    u = torch.from_numpy(q).to(sol.weights.device).contiguous()
    subcell_cuda.reset_launches()
    a = b = u
    for _ in range(2):
        a, b = lim_k.step(a, 4.8e-3), lim_p.step(b, 4.8e-3)
    torch.cuda.synchronize()
    assert _err(a, b) <= 1e-12
    assert cu.kernels[1:] == ("aderdg_face_flux_walls", "aderdg_surface_update_walls")
    assert all(n == 2 for n in cu.launches.values())
    assert subcell_cuda.launches["subcell_row_sweep"] == 6

    sol2, cu2, u2 = _setup_2d((8, 8), torch.float64, "reflective")
    lim_k = LimitedADERDG(sol2, euler_admissible(2), accelerator=cu2, device=u2.device)
    lim_p = LimitedADERDG(sol2, euler_admissible(2), device=u2.device)
    u2 = u2.clone()
    u2[:, :, 3, 3:5, 3:5] *= 20.0  # a pressurised block: troubled cells
    dt = 0.5 * float(sol2.cfl_dt(u2))
    assert bool(lim_p.troubled_mask(u2, sol2.step(u2, dt)).any())
    a, fl_a = lim_k.step(u2, dt, return_face_fluxes=True)
    b, fl_b = lim_p.step(u2, dt, return_face_fluxes=True)
    torch.cuda.synchronize()
    assert _err(a, b) <= 1e-12
    for x, y in zip(fl_a, fl_b):
        assert _err(x, y) <= 1e-12
    assert all(n == 1 for n in cu2.launches.values())


# ------------------------------------- the 2-D Navier–Stokes step (K1 c)


def _setup_2d_ns(grid, dtype, mu=0.02, order=3, name="periodic"):
    """A 2-D Navier–Stokes solver on the card at ``order`` (dx_0 = 1/g0,
    dx_1 = 0.7/g1) in wall mode ``name`` (``NS_NAMES_2D``), its
    ``CudaADERDG`` and a state with seeded noise on every node (every
    gradient of order 1/dx)."""
    from exahype_tpu_torch.models.aderdg import make_dirichlet_fn
    from exahype_tpu_torch.models.navier_stokes import (
        navier_stokes,
        noslip_reflect,
        noslip_reflect_flux,
    )

    dev = _card()

    def held(*x):
        rho = 1.0 + 0.2 * np.sin(2 * np.pi * x[0]) * np.cos(np.pi * x[1])
        vel = (0.3 + 0.1 * np.cos(2 * np.pi * x[1]), -0.2 + 0.1 * np.sin(np.pi * x[0]))
        e = (2.0 + 0.1 * np.sin(np.pi * x[1])) / 0.4 + 0.5 * rho * sum(v * v for v in vel)
        return np.stack([rho, rho * vel[0], rho * vel[1], e], axis=-1)

    dx = (1.0 / grid[0], 0.7 / grid[1])
    noslip = dict(boundary="reflective", reflect_fn=noslip_reflect(2),
                  reflect_flux_fn=noslip_reflect_flux(2))
    walls = {
        "periodic": {},
        "noslip_box": noslip,
        "noslip_1": dict(noslip, wall_axes=(1,)),
        "outflow_0": dict(boundary="outflow", wall_axes=(0,)),
        "farfield_0": dict(boundary="farfield", farfield_state=(1.0, 0.3, 0.0, 2.6),
                           wall_axes=(0,)),
        "dirichlet": dict(boundary="dirichlet", dirichlet_fn=make_dirichlet_fn(
            held, dim=2, order=order, grid_shape=grid, dx=dx)),
    }[name]
    flux, eig, visc, visc_eig = navier_stokes(2, mu=mu, prandtl=0.7)
    sol = ADERDGSolver(2, order, 4, grid, flux, eig, dx=dx, visc_flux_fn=visc,
                       visc_eigenvalue_fn=visc_eig, device=dev, dtype=dtype, **walls)
    rng = np.random.default_rng(5)
    shape = (order + 1, order + 1) + grid
    rho = 1.0 + 0.3 * rng.random(shape)
    vel = [0.3 * rng.standard_normal(shape) for _ in range(2)]
    p = 1.0 + 0.3 * rng.random(shape)
    e = p / 0.4 + 0.5 * rho * (vel[0] ** 2 + vel[1] ** 2)
    q = np.stack([rho, rho * vel[0], rho * vel[1], e], axis=2)
    return sol, CudaADERDG(sol), torch.from_numpy(q).to(dev, dtype).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CASES_2D)
def test_2d_ns_kernels_match_plain(dtype, grid):
    """``aderdg_predictor_volume_visc_2d`` and the periodic face pair's
    Navier–Stokes instance launch by launch against the plain solver: the
    predictor's new state and faces, F̂ (with the Gassner penalty), the
    update, the stage with its face fluxes, and 3 steps (dt by value and by
    pointer, bitwise equal)."""
    sol, cu, u = _setup_2d_ns(grid, dtype)
    assert cu.kernels == ("aderdg_predictor_volume_visc_2d", "aderdg_face_flux_2d",
                          "aderdg_surface_update_2d")
    dt = 0.5 * float(sol.cfl_dt(u))

    def close(got, ref, rounds=1):
        assert _err(got, ref) <= rounds * _bound(ref, dtype)

    new_k, faces_k, fv = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    assert fv is None
    close(new_k, new_p)
    close(faces_k, faces_p)
    fhat, fwall = cu.face_flux(faces_p)
    assert fwall is None
    fshape = sol.face_flux_shape
    plain = []
    for d in range(2):
        plain.append(sol.interface_flux(*(faces_p[d, k].reshape(fshape) for k in range(4)), d))
        close(fhat[d].view(fshape), plain[d])
    upd = cu.surface_update(new_p.clone(), torch.stack(plain).view(fhat.shape), dt)
    ref = new_p
    for d in range(2):
        ref = sol.surface_term(ref, plain[d], d, dt)
    close(upd, ref)
    stage, fl_k = cu.face_surface(new_p.clone(), faces_p, dt, return_face_fluxes=True)
    stage_p, fl_p = sol.face_surface(new_p, faces_p, dt, return_face_fluxes=True)
    close(stage, stage_p)
    for a, b in zip(fl_k, fl_p):
        close(a, b)
    by_value = cu.run(u, 3, dt)
    by_pointer = cu.run(u, 3, torch.tensor(dt, dtype=dtype, device=u.device))
    torch.cuda.synchronize()
    close(by_value, sol.run(u, 3, dt), 1 if dtype == torch.float64 else 3)
    assert torch.equal(by_value, by_pointer)
    assert cu.launches == dict(zip(cu.kernels, (7, 8, 8)))


#: The 2-D Navier–Stokes wall modes: periodic, the no-slip box and the
#: no-slip walls on axis 1, outflow and farfield on axis 0, Dirichlet on both.
NS_NAMES_2D = ["periodic", "noslip_box", "noslip_1", "outflow_0", "farfield_0", "dirichlet"]


#: (wall mode, order) of the new 2-D Navier–Stokes instances: every wall
#: mode at order 3 (the periodic order-3 kernels: test_2d_ns_kernels_match_plain)
#: and every mode, periodic included, at order 2.
NS_CASES_2D = [(name, order) for order in (3, 2) for name in NS_NAMES_2D
               if (name, order) != ("periodic", 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CASES_2D)
@pytest.mark.parametrize("name,order", NS_CASES_2D)
def test_2d_ns_walls_and_p2_kernels_match_plain(name, order, dtype, grid):
    """The walled 2-D Navier–Stokes kernels (the viscous predictor with the
    wall planes, the face pair with the advective/viscous wall split) in
    every wall mode, and the order-2 instances periodic and walled, launch
    by launch against the plain solver: the predictor's new state, faces
    and wall planes, F̂ and the low-wall fluxes, the update, the stage with
    its face fluxes, and 3 steps (dt by value and by pointer, bitwise
    equal)."""
    sol, cu, u = _setup_2d_ns(grid, dtype, order=order, name=name)
    dt = 0.5 * float(sol.cfl_dt(u))

    def close(got, ref, rounds=1):
        assert got.shape == ref.shape
        assert _err(got, ref) <= rounds * _bound(ref, dtype)

    got = cu.predictor_volume(u, dt)
    ref = sol.predictor_volume(u, dt)
    assert (got[2] is None) == (ref[2] is None) == (name == "periodic")
    for a, b in zip(got, ref):
        if b is not None:
            close(a, b)
    new_p, faces_p, fv_p = ref
    fhat, fwall = cu.face_flux(faces_p, fv_p)
    fshape = sol.face_flux_shape
    rows = sol.visc_wall_rows(fv_p) if fv_p is not None else {}
    plain, walls = [], {}
    for d in range(2):
        q_lo, q_hi, f_lo, f_hi = (faces_p[d, k].reshape(fshape) for k in range(4))
        fv_lo, fv_hi = rows.get(d, (None, None))
        plain.append(sol.interface_flux(q_lo, q_hi, f_lo, f_hi, d, fv_hi))
        close(fhat[d].view(fshape), plain[d])
        if sol.is_wall(d):
            walls[d] = sol.low_wall_flux(q_lo, f_lo, d, fv_lo)
            close(cu.wall_fluxes(fwall)[d], walls[d])
    side = None if fwall is None else torch.cat([walls[d].reshape(-1) for d in sorted(walls)])
    upd = cu.surface_update(new_p.clone(), torch.stack(plain).view(fhat.shape), dt, side)
    want = new_p
    for d in range(2):
        want = sol.surface_term(want, plain[d], d, dt, walls.get(d))
    close(upd, want)
    stage, fl_k = cu.face_surface(new_p.clone(), faces_p, dt, return_face_fluxes=True,
                                  fvwall=fv_p)
    stage_p, fl_p = sol.face_surface(new_p, faces_p, dt, return_face_fluxes=True, fvwall=fv_p)
    close(stage, stage_p)
    for a, b in zip(fl_k, fl_p):
        close(a, b)
    by_value = cu.run(u, 3, dt)
    by_pointer = cu.run(u, 3, torch.tensor(dt, dtype=dtype, device=u.device))
    torch.cuda.synchronize()
    close(by_value, sol.run(u, 3, dt), 1 if dtype == torch.float64 else 3)
    assert torch.equal(by_value, by_pointer)
    assert cu.launches == dict(zip(cu.kernels, (7, 8, 8)))


@pytest.mark.cuda
def test_2d_ns_kernel_info_and_refusals():
    """The 2-D viscous kernels' occupancy (index 27 and the face pair of
    physics 2; the walled predictor 75 and the walled pair; the order-2
    step's 70-74 and its walled predictor 76); the launchers refuse Euler's
    predictor for Navier–Stokes and the viscous one for Euler, the order-2
    entries for Euler, and a walled Navier–Stokes face flux without the
    wall planes (an Euler one with them)."""
    from exahype_tpu_torch import _build

    sol, cu, u = _setup_2d_ns((4, 4), torch.float32)
    for order, name, threads, smem in ((3, "periodic", 256, 20544), (3, "noslip_box", 256, 28736),
                                       (2, "periodic", 288, 23076), (2, "noslip_box", 288, 32292)):
        _, c, _ = _setup_2d_ns((4, 4), torch.float32, order=order, name=name)
        for kernel in c.kernels:
            for dtype in (torch.float32, torch.float64):
                info = c.kernel_info(kernel, dtype)
                assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, (kernel, info)
        info = c.kernel_info(c.kernels[0], torch.float32)
        assert (info["threads"], info["smem"]) == (threads, smem), (order, name, info)
        assert c.kernel_info(c.kernels[0], torch.float64)["smem"] == 2 * smem
    esol, ecu, _ = _setup_2d((4, 4), torch.float32)
    lib = _build.library()
    new, faces = torch.empty_like(u), torch.empty(sol.face_shape, dtype=u.dtype, device=u.device)
    for name, c in (("aderdg_predictor_volume_2d", cu), ("aderdg_predictor_volume_visc_2d", ecu),
                    ("aderdg_predictor_volume_visc_p2_2d", ecu)):
        planes = (0, None, None, 0) if "visc" in name else ()
        err = getattr(lib, f"exahype_{name}_f32")(
            u.data_ptr(), new.data_ptr(), faces.data_ptr(), None, 1e-4, c._ops.ctypes.data,
            c._dx.ctypes.data, 2 if "p2" in name else 3, 2, c._physics_id, c._params.ctypes.data,
            *c._grid, *planes, None)
        assert err != 0, name
    _, wcu, wu = _setup_2d_ns((4, 4), torch.float32, name="noslip_box")
    efaces = wcu.predictor_volume(wu, 1e-4)[1]
    with pytest.raises(RuntimeError, match="CUDA error"):  # the planes withheld
        mask, mode, table, rows, off, side = wcu._wall_args(efaces)
        fhat = torch.empty((2, 4, 4, 4, 4), dtype=wu.dtype, device=wu.device)
        fw = torch.empty(wcu.walls["size"], dtype=wu.dtype, device=wu.device)
        err = lib.exahype_aderdg_face_flux_walls_2d_f32(
            efaces.data_ptr(), fhat.data_ptr(), wcu._ops.ctypes.data, wcu._dx.ctypes.data, 3,
            wcu._physics_id, wcu._params.ctypes.data, *wcu._grid, mask, mode, table, rows,
            fw.data_ptr(), off, side, None, None)
        _build.check(lib, err, "aderdg_face_flux_walls_2d")


@pytest.mark.cuda
def test_viscous_limited_steps_match_plain():
    """The limited step over a viscous solver on the card against the plain
    limiter, f64 at 1e-12, with its face fluxes: the 2-D MUSCL fallback on
    the 2-D Navier–Stokes kernels (a pressurised block: troubled cells),
    and the 3-D first-order fallback on ``aderdg_predictor_volume_visc``
    with no-slip walls."""
    from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible
    from exahype_tpu_torch.models.navier_stokes import (
        navier_stokes,
        noslip_reflect,
        noslip_reflect_flux,
    )

    sol, cu, u = _setup_2d_ns((8, 8), torch.float64, mu=5e-3)
    u = u.clone()
    u[:, :, 3, 3:5, 3:5] *= 20.0
    cases = [(sol, cu, u, dict(fallback_order=2, fallback_slope="mc"))]
    dev = u.device
    flux, eig, visc, visc_eig = navier_stokes(3, mu=0.02, prandtl=0.7)
    grid = (4, 4, 4)
    sol3 = ADERDGSolver(3, 3, 5, grid, flux, eig, dx=0.25, visc_flux_fn=visc,
                        visc_eigenvalue_fn=visc_eig, boundary="reflective",
                        reflect_fn=noslip_reflect(3), reflect_flux_fn=noslip_reflect_flux(3),
                        wall_axes=(0,), device=dev, dtype=torch.float64)
    rng = np.random.default_rng(7)
    rho = 1.0 + 0.2 * rng.random((4, 4, 4) + grid)
    rho[:, :, :, 1:3] *= 8.0
    q = np.stack([rho, 0.3 * rho, -0.2 * rho, 0.1 * rho, 2.5 + rho], axis=3)
    cases.append((sol3, CudaADERDG(sol3), torch.from_numpy(q).to(dev), {}))
    for s, c, x, opts in cases:
        lim_k = LimitedADERDG(s, euler_admissible(s.dim), accelerator=c, device=dev, **opts)
        lim_p = LimitedADERDG(s, euler_admissible(s.dim), device=dev, **opts)
        dt = 0.5 * float(s.cfl_dt(x))
        assert bool(lim_p.troubled_mask(x, s.step(x, dt)).any())
        a, fl_a = lim_k.step(x, dt, return_face_fluxes=True)
        b, fl_b = lim_p.step(x, dt, return_face_fluxes=True)
        torch.cuda.synchronize()
        assert _err(a, b) <= 1e-12
        for y, z in zip(fl_a, fl_b):
            assert _err(y, z) <= 1e-12
        assert all(n == 1 for n in c.launches.values()), c.launches


# ------------------------------------------------ K4: the generated spec kernel


def _fv_state(grid, dtype, dev, seed=0, n_vars=5, extent=6):
    """``__graft_entry__._example_state``'s recipe on the SoA-P grid state
    ``[*extent, V, *grid]`` (one spatial axis per grid axis)."""
    dim = len(grid)
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.1, 1.0, size=(extent,) * dim + (n_vars,) + grid)
    lead = (slice(None),) * dim
    q[lead + (0,)] += 1.0
    q[lead + (dim + 1,)] += 5.0
    return torch.from_numpy(q).to(dev, dtype).contiguous()


def _spec(name, grid, n_aux=0):
    """The spec ``name`` (``fv`` or ``rusanov``, patch 4, or ``fv_p6`` and
    the like for another patch size) on one patch per grid cell."""
    from exahype_tpu_torch.models.fv import build_fv_rusanov_kernel
    from exahype_tpu_torch.models.rusanov import build_rusanov_kernel

    name, _, patch = name.partition("_p")
    build = {"fv": build_fv_rusanov_kernel, "rusanov": build_rusanov_kernel}[name]
    return build(dim=len(grid), patch_size=int(patch or 4), halo_size=1, n_real=5,
                 n_aux=n_aux, n_patches=int(np.prod(grid)))


SPEC_CASES = [
    ("fv", torch.float64, (2, 2, 2), 0),
    ("rusanov", torch.float64, (2, 2, 2), 0),
    ("fv", torch.float64, (3, 1, 5), 0),  # ragged last tile (4 patches per block)
    ("fv", torch.float32, (8, 4, 33), 0),  # 132 full tiles of 8 patches
    ("fv", torch.float32, (3, 3, 3), 0),  # ragged last tile (8 patches per block)
    ("rusanov", torch.float32, (4, 4, 8), 0),
    # The reference's 2-D configuration: 10 variables, 5 of them evolved;
    # ragged last tiles (35 patches in f64, 99 in f32).
    ("rusanov", torch.float64, (5, 7), 5),
    ("fv", torch.float32, (9, 11), 5),
    # Patches too large for a 32-byte tile: tiles of 4 (f32, 9 patches,
    # ragged) and of 1 (f64).
    ("fv_p6", torch.float32, (3, 3, 1), 0),
    ("fv_p8", torch.float64, (1, 3, 1), 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("spec,dtype,grid,n_aux", SPEC_CASES)
def test_spec_kernel_matches_plain(spec, dtype, grid, n_aux):
    from exahype_tpu_torch.backends.cuda_backend import CudaPrinter

    dev = _card()
    kb = _spec(spec, grid, n_aux)
    fn = CudaPrinter(kb).build()
    q = _fv_state(grid, dtype, dev, n_vars=5 + n_aux, extent=kb.config.extent)
    got = q.clone()
    assert fn(got, 0.05) is got  # in place
    by_pointer = fn(q.clone(), torch.tensor(0.05, dtype=dtype, device=dev))
    ref = fn.plain(q.clone(), 0.05)
    torch.cuda.synchronize()
    assert _err(got, ref) <= _bound(ref, dtype)
    assert torch.equal(got, by_pointer)
    assert fn.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("spec,dtype,grid,n_aux", SPEC_CASES)
def test_spec_kernel_reads_and_writes_only_its_sets(spec, dtype, grid, n_aux):
    """With a sentinel in every state value outside the printer's read set,
    the kernel's output on the write set is bitwise its output from the
    clean state, and every value outside the write set keeps its input."""
    from exahype_tpu_torch.backends.cuda_backend import CudaPrinter

    dev = _card()
    kb = _spec(spec, grid, n_aux)
    pr = CudaPrinter(kb)
    fn = pr.build()
    q = _fv_state(grid, dtype, dev, n_vars=5 + n_aux, extent=kb.config.extent)
    read = torch.zeros(q.shape[:len(grid) + 1], dtype=torch.bool, device=dev)
    write = torch.zeros_like(read)
    for cell, v in pr.read_cells:
        read[cell + (v,)] = True
    for cell, v in pr.write_cells:
        write[cell + (v,)] = True
    probed = q.clone()
    probed[~read] = 1e30
    clean = fn(q.clone(), 0.05)
    got = fn(probed.clone(), 0.05)
    torch.cuda.synchronize()
    assert torch.equal(got[write], clean[write])
    assert torch.isfinite(got[write]).all()
    assert torch.equal(got[~write], probed[~write])
    assert torch.equal(clean[~write], q[~write])
    info = fn.kernel_info(dtype)
    assert info["blocks_per_sm"] >= 1 and info["threads"] % 32 == 0, info


@pytest.mark.cuda
def test_fv_grid_solver_on_the_card():
    import copy

    from exahype_tpu_torch.models import euler
    from exahype_tpu_torch.parallel.grid import TpuPatchGrid
    from exahype_tpu_torch.parallel.solver import GridSolver

    dev = _card()
    grid = (4, 2, 8)
    kb = _spec("fv", grid)
    sv = GridSolver(TpuPatchGrid(kb.config, grid), kb, dx=1.0 / 16, cfl=0.45,
                    eigenvalue_fn=euler.wave_speed_fn(3), kernel_dt="lambda",
                    device=dev, dtype=torch.float64)
    q0 = _fv_state(grid, torch.float64, dev, seed=1)
    u, t = sv.run(q0, 5)
    again, _ = sv.run(q0, 5)
    plain = copy.copy(sv)
    plain.kernel_fn = sv.kernel_fn.plain
    ref, t_ref = plain.run(q0, 5)
    torch.cuda.synchronize()
    assert sv.kernel_fn.launches == 10
    assert torch.equal(u, again)
    assert _err(u, ref) <= 1e-12
    assert abs(float(t) - float(t_ref)) <= 1e-15


# ------------------------------------------------ K5: the fused Z4 right-hand side


def _z4_setup(grid, dtype, **params):
    """``scripts/z4_probe.py``'s production Z4 solver at ``grid`` (p2, dx =
    1/128; ``params`` overrides the slicing, f, m, κ₁, κ₂), plain and
    through K5, and the gauge wave of amplitude 0.1."""
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4 import gauge_wave_state, make_z4_solver

    dev = _card()
    plain = make_z4_solver(3, 2, grid, dx=1.0 / 128, impl="soa", fused_rhs="soa",
                           device=dev, dtype=dtype, **params)
    return plain, with_cuda_rhs(plain), gauge_wave_state(plain, amplitude=0.1)


def _z4_bound(ref, dtype):
    if dtype == torch.float64:
        return 1e-12 * max(1.0, ref.abs().max().item())
    return _bound(ref, dtype)


def _rhs_calls(plain, u, dt=1e-4):
    """The inputs of every ``rhs_all_fn`` call of one plain step."""
    import copy

    calls = []
    rec = copy.copy(plain)

    def record(Q, grads, va):
        calls.append((Q, tuple(grads), va))
        return plain.rhs_all_fn(Q, grads, va)

    rec.rhs_all_fn = record
    rec.step(u, dt)
    return calls


Z4_CASES = [
    (torch.float64, (8, 4, 16)),
    (torch.float64, (3, 5, 7)),  # a ragged last block
    (torch.float32, (8, 4, 16)),
    (torch.float32, (5, 3, 7)),
]
#: The kernel's other branches: 1+log slicing (g = 2/α, d(αg)/dα = 0) and
#: harmonic slicing with f ≠ 1, each with m ≠ 2 and both κ damping terms.
Z4_PARAMS = [
    dict(),
    dict(slicing="1+log", f=0.7, m=1.5, kappa1=0.1, kappa2=0.3),
    dict(f=0.7, m=1.5, kappa1=0.1, kappa2=0.3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("params", Z4_PARAMS, ids=["harmonic", "1+log_damped", "f_m_damped"])
@pytest.mark.parametrize("dtype,grid", Z4_CASES)
def test_rhs_kernel_matches_plain(dtype, grid, params):
    """Every call of one step, Picard- and corrector-shaped."""
    plain, kern, u = _z4_setup(grid, dtype, **params)
    k5 = kern.rhs_all_fn
    calls = _rhs_calls(plain, u)
    assert len(calls) == plain.picard_iters + 2
    for Q, grads, va in calls:
        Q0 = Q.clone()
        got = k5(Q, grads, va)
        ref = plain.rhs_all_fn(Q, grads, va)
        torch.cuda.synchronize()
        assert torch.equal(Q, Q0)
        assert got.shape == ref.shape
        assert _err(got, ref) <= _z4_bound(ref, dtype)
        assert torch.equal(got, k5(Q, grads, va))  # bitwise repeatable
    assert k5.launches == 2 * len(calls)


@pytest.mark.cuda
def test_rhs_kernel_refuses_what_it_cannot_read():
    from exahype_tpu_torch.utils.errors import LoweringError

    plain, kern, u = _z4_setup((4, 2, 8), torch.float64)
    Q, grads, va = _rhs_calls(plain, u)[0]
    k5 = kern.rhs_all_fn
    with pytest.raises(LoweringError, match="contiguous"):
        k5(Q, (grads[0].transpose(-1, -2).contiguous().transpose(-1, -2), *grads[1:]), va)
    with pytest.raises(LoweringError, match="contiguous"):
        k5(Q.transpose(-1, -2).contiguous().transpose(-1, -2), grads, va)
    with pytest.raises(LoweringError, match=r"grads\[1\]"):
        k5(Q, (grads[0], grads[1].float(), grads[2]), va)
    with pytest.raises(LoweringError, match="dtype"):
        k5(Q.half(), tuple(g.half() for g in grads), va)
    assert k5.launches == 0


@pytest.mark.cuda
def test_z4_step_through_the_kernel_counts_its_launches():
    plain, kern, u = _z4_setup((4, 2, 8), torch.float64)
    a = kern.run(u, 2, 1e-4)
    b = plain.run(u, 2, 1e-4)
    torch.cuda.synchronize()
    assert kern.rhs_all_fn.launches == 2 * (kern.picard_iters + 2)
    assert _err(a, b) <= _z4_bound(b, torch.float64)
    assert torch.equal(a, kern.run(u, 2, 1e-4))
    assert not hasattr(plain.rhs_all_fn, "launches")  # the plain solver stays plain


# ------------------------------------------- K1 d: the Z4 step's own kernels


def _z4_step_setup(grid, dtype, **params):
    """The fused Z4 solver at ``grid`` (p2, dx = 1/128) on the card, its
    ``CudaADERDG`` (``csrc/aderdg_z4.cu``) and the gauge wave of amplitude
    0.1 with seeded noise of 1e-3 (so no two cells are alike)."""
    from exahype_tpu_torch.models.z4 import gauge_wave_state, make_z4_solver

    dev = _card()
    sol = make_z4_solver(3, 2, grid, dx=1.0 / 128, impl="soa", fused_rhs="soa", device=dev,
                         dtype=dtype, **params)
    u = gauge_wave_state(sol, amplitude=0.1)
    noise = np.random.default_rng(5).standard_normal(u.shape)
    return sol, CudaADERDG(sol), (u + 1e-3 * torch.from_numpy(noise).to(u)).contiguous()


def _z4_plain_halves(sol, faces):
    """The plain face flux kernel's two outputs in its layout."""
    fs = sol.face_flux_shape
    parts = [[faces[d, k].reshape(fs) for k in range(4)] for d in range(3)]
    shape = (3, 9, sol.n_vars) + sol.grid_shape
    fhat = torch.stack([sol.interface_flux(*parts[d], d) for d in range(3)]).reshape(shape)
    fhalf = torch.stack([sol.ncp_half(*parts[d], d) for d in range(3)]).reshape(shape)
    return fhat, fhalf


def _z4_half_bound(sol, faces, got, ref):
    """``(error, limit)`` of float32 NCP halves ``got``: a difference of two
    evaluations of the algebra (~25 each) that cancels to ~1e-2, so they
    are held against the plain halves in float64 from the same faces, to 4
    times the plain float32 halves' (``ref``) own distance (the rule
    ``chip_smoke.py`` holds them to)."""
    ref64 = _z4_plain_halves(_z4_f64_twin(sol), faces.double())[1]
    limit = max(4 * _err(ref, ref64), _bound(ref64, torch.float32))
    assert limit < 0.1 * ref64.abs().max().item()  # the rule can tell a missing half
    return _err(got, ref64), limit


def _z4_f64_twin(sol):
    """The same fused Z4 solver (zero-shift, shifted, Z4+GRHD or Z4+GRMHD)
    in float64."""
    from exahype_tpu_torch.models.z4 import make_z4_shift_solver, make_z4_solver
    from exahype_tpu_torch.models.z4_grmhd import make_z4_grmhd_solver
    from exahype_tpu_torch.models.z4_matter import make_z4_matter_solver

    tag = sol.rhs_all_fn.physics
    names = ("slicing", "f", "m", "kappa1", "kappa2", "shift", "f_b", "eta")
    if tag.name == "z4_matter":
        names = ("slicing", "f", "m", "kappa1", "kappa2", "gamma", "iters")
    if tag.name == "z4_grmhd":
        names = ("slicing", "f", "m", "kappa1", "kappa2", "gamma", "iters", "c_h", "glm_kappa")
    make = {"z4": make_z4_solver, "z4_shift": make_z4_shift_solver,
            "z4_matter": make_z4_matter_solver, "z4_grmhd": make_z4_grmhd_solver}[tag.name]
    return make(3, 2, sol.grid_shape, dx=sol._dxs[0], impl="soa", fused_rhs="soa",
                device=sol.weights.device, dtype=torch.float64, **dict(zip(names, tag.params)))


def _z4_plain_update(sol, new, fhat, fhalf, dt):
    fs = sol.face_flux_shape
    for d in range(3):
        new = sol.surface_term(new, fhat[d].view(fs), d, dt)
        new = sol.ncp_term(new, fhalf[d].view(fs), d, dt)
    return new


Z4_STEP_CASES = [
    (torch.float64, (8, 4, 16)),
    (torch.float64, (3, 5, 7)),  # a ragged last predictor block and face tile
    (torch.float32, (8, 4, 16)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("params", Z4_PARAMS, ids=["harmonic", "1+log_damped", "f_m_damped"])
@pytest.mark.parametrize("dtype,grid", Z4_STEP_CASES)
def test_z4_kernels_match_plain(dtype, grid, params):
    """Each of the three kernels against its plain version, fed the plain
    inputs; dt by value and by pointer."""
    sol, cu, u = _z4_step_setup(grid, dtype, **params)
    dt = 1e-4
    u0 = u.clone()
    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_t, faces_t, _ = cu.predictor_volume(u, torch.tensor(dt, dtype=dtype, device=u.device))
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    fhat_k, fhalf_k = cu.face_flux(faces_p)
    fhat_p, fhalf_p = _z4_plain_halves(sol, faces_p)
    upd_k = cu.surface_update(new_p.clone(), fhat_p, dt, fhalf=fhalf_p)
    upd_p = _z4_plain_update(sol, new_p, fhat_p, fhalf_p, dt)
    torch.cuda.synchronize()
    assert torch.equal(u, u0)
    for a, b in ((new_k, new_p), (faces_k, faces_p), (fhat_k, fhat_p), (upd_k, upd_p)):
        assert _err(a, b) <= _z4_bound(b, dtype)
    if dtype == torch.float64:
        assert _err(fhalf_k, fhalf_p) <= _z4_bound(fhalf_p, dtype)
    else:
        err, limit = _z4_half_bound(sol, faces_p, fhalf_k, fhalf_p)
        assert err <= limit
    assert not faces_k[:, 2:].any()  # the F̄ rows are written as zeros
    assert torch.equal(new_t, new_k) and torch.equal(faces_t, faces_k)
    assert cu.launches == {name: n for name, n in zip(cu.kernels, (2, 1, 1))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", Z4_STEP_CASES)
def test_z4_stages_cross_feed_and_step(dtype, grid):
    """The kernel predictor into the plain face stage and the plain
    predictor into the kernel face stage; the step, 3 launches, bitwise
    repeatable."""
    sol, cu, u = _z4_step_setup(grid, dtype)
    dt = 1e-4
    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    ref = sol.face_surface(new_p, faces_p, dt)
    mixed_a = sol.face_surface(new_k, faces_k, dt)
    mixed_b = cu.face_surface(new_p.clone(), faces_p, dt)
    cu.reset_launches()
    step = cu.step(u, dt)
    assert cu.launches == {name: 1 for name in cu.kernels}
    again = cu.run(u, 1, dt)
    out, fluxes = cu.step(u, dt, return_face_fluxes=True)
    ref_out, ref_fluxes = sol.step(u, dt, return_face_fluxes=True)
    torch.cuda.synchronize()
    for a in (mixed_a, mixed_b, step):
        assert _err(a, ref) <= _z4_bound(ref, dtype)
    assert torch.equal(step, again) and torch.equal(out, step)
    # F̂ = −½ s Δq, a difference of face states: from two predictors' faces
    # it differs by their rounding, on the faces' scale.
    scale = faces_p[:, :2].abs().max()
    for a, b in zip(fluxes, ref_fluxes):
        assert _err(a, b) <= _z4_bound(scale, dtype)


@pytest.mark.cuda
def test_z4_kernel_info_and_refusals():
    sol, cu, u = _z4_step_setup((4, 2, 8), torch.float64)
    for dtype in (torch.float32, torch.float64):
        for name in cu.kernels:
            info = cu.kernel_info(name, dtype)
            assert info["blocks_per_sm"] >= 1 and info["registers"] > 0, (name, dtype, info)
    assert cu.kernel_info(cu.kernels[0], torch.float32)["threads"] == 324
    assert cu.kernel_info(cu.kernels[0], torch.float64)["threads"] == 162
    new, faces, _ = cu.predictor_volume(u, 1e-4)
    fhat, fhalf = cu.face_flux(faces)
    with pytest.raises(LoweringError, match="fhalf"):
        cu.surface_update(new, fhat, 1e-4)
    with pytest.raises(LoweringError, match="shape"):
        cu.surface_update(new, fhat, 1e-4, fhalf=fhalf[:2])
    with pytest.raises(LoweringError, match="dtype"):
        cu.predictor_volume(u.half(), 1e-4)
    euler = CudaADERDG(ADERDGSolver(3, 3, 5, (4, 2, 8), *euler_physics(3), device=u.device,
                                    dtype=torch.float64))
    with pytest.raises(LoweringError, match="fhalf"):
        euler.surface_update(torch.zeros(euler.solver.state_shape, dtype=torch.float64,
                                         device=u.device),
                             torch.zeros((3, 16, 5, 4, 2, 8), dtype=torch.float64,
                                         device=u.device), 1e-4,
                             fhalf=torch.zeros(1, device=u.device))


# ---------------- K1 d's per-axis branch (3-D p2) and the 2-D vacuum steps (p2, p3)


#: (dim, order, fused_rhs) of the vacuum forms on the per-axis and 2-D kernels.
Z4_FORMS = [(3, 2, False), (2, 2, False), (2, 2, "soa"), (2, 3, False), (2, 3, "soa")]
Z4_FORM_IDS = ["3d_p2_per_axis", "2d_p2_per_axis", "2d_p2_fused", "2d_p3_per_axis",
               "2d_p3_fused"]


def _z4_form_setup(dim, order, fused, dtype, grid=None):
    """The vacuum Z4 solver of one form on the card (dx = 1/64), its
    ``CudaADERDG`` and the gauge wave of amplitude 0.1 with seeded noise of
    1e-3; the grid ragged in the last predictor block and face tile by
    default."""
    from exahype_tpu_torch.models.z4 import gauge_wave_state, make_z4_solver

    dev = _card()
    grid = grid or ((3, 5, 7) if dim == 3 else (7, 37))
    sol = make_z4_solver(dim, order, grid, dx=1.0 / 64, impl="soa", fused_rhs=fused, device=dev,
                         dtype=dtype)
    u = gauge_wave_state(sol, amplitude=0.1)
    noise = np.random.default_rng(7).standard_normal(u.shape)
    return sol, CudaADERDG(sol), (u + 1e-3 * torch.from_numpy(noise).to(u)).contiguous()


def _z4_form_halves(sol, faces):
    """The plain face flux kernel's two outputs, ``[dim, n^(dim-1), 38, *grid]``."""
    fs = sol.face_flux_shape
    parts = [[faces[d, k].reshape(fs) for k in range(4)] for d in range(sol.dim)]
    shape = (sol.dim, sol.n_nodes ** (sol.dim - 1), sol.n_vars) + sol.grid_shape
    return (torch.stack([sol.interface_flux(*parts[d], d) for d in range(sol.dim)]).reshape(shape),
            torch.stack([sol.ncp_half(*parts[d], d) for d in range(sol.dim)]).reshape(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("dim,order,fused", Z4_FORMS, ids=Z4_FORM_IDS)
def test_z4_form_kernels_match_plain(dim, order, fused, dtype):
    """Each kernel of the per-axis and 2-D forms against its plain version,
    fed the plain inputs (float32 NCP halves against plain float64 from the
    same faces, as ``test_z4_kernels_match_plain`` holds them)."""
    from exahype_tpu_torch.models.z4 import make_z4_solver

    sol, cu, u = _z4_form_setup(dim, order, fused, dtype)
    dt = 1e-4
    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    fhat_k, fhalf_k = cu.face_flux(faces_p)
    fhat_p, fhalf_p = _z4_form_halves(sol, faces_p)
    upd_k = cu.surface_update(new_p.clone(), fhat_p.contiguous(), dt,
                              fhalf=fhalf_p.contiguous())
    upd_p = new_p
    for d in range(dim):
        upd_p = sol.surface_term(upd_p, fhat_p[d].view(sol.face_flux_shape), d, dt)
        upd_p = sol.ncp_term(upd_p, fhalf_p[d].view(sol.face_flux_shape), d, dt)
    torch.cuda.synchronize()
    for a, b in ((new_k, new_p), (faces_k, faces_p), (fhat_k, fhat_p), (upd_k, upd_p)):
        assert _err(a, b) <= _z4_bound(b, dtype)
    if dtype == torch.float64:
        assert _err(fhalf_k, fhalf_p) <= _z4_bound(fhalf_p, dtype)
    else:
        sol64 = make_z4_solver(dim, order, sol.grid_shape, dx=sol._dxs[0], impl="soa",
                               fused_rhs=fused, device=u.device, dtype=torch.float64)
        ref64 = _z4_form_halves(sol64, faces_p.double())[1]
        limit = max(4 * _err(fhalf_p, ref64), _bound(ref64, torch.float32))
        assert limit < 0.1 * ref64.abs().max().item()
        assert _err(fhalf_k, ref64) <= limit
    assert not faces_k[:, 2:].any()
    assert cu.launches == {name: 1 for name in cu.kernels}


@pytest.mark.cuda
@pytest.mark.parametrize("dim,order,fused", Z4_FORMS, ids=Z4_FORM_IDS)
def test_z4_form_steps_launch_three_kernels(dim, order, fused):
    """Two steps: 3 launches a step, bitwise repeatable, within the bar of
    the plain steps; the occupancy query answers for each kernel."""
    sol, cu, u = _z4_form_setup(dim, order, fused, torch.float64)
    cu.reset_launches()
    got = cu.run(u, 2, 1e-4)
    assert cu.launches == {name: 2 for name in cu.kernels}
    assert torch.equal(got, cu.run(u, 2, 1e-4))
    ref = sol.run(u, 2, 1e-4)
    assert _err(got, ref) <= _z4_bound(ref, torch.float64)
    for dtype in (torch.float32, torch.float64):
        for name in cu.kernels:
            info = cu.kernel_info(name, dtype)
            assert info["blocks_per_sm"] >= 1 and info["registers"] > 0, (name, dtype, info)


@pytest.mark.cuda
def test_z4_example_chip_run_fails_in_float32():
    """``examples/z4_gauge_wave.py``'s chip configuration ((64, 2) cells,
    order 3, per-axis, 256 steps to t = 0.1) on the kernels: in float64
    within its chip gates, in float32 over them, as in the JAX package and
    the port's plain path (ROADMAP.md Queue 3: a mode seeded by float32
    rounding grows ~8 % a step); the float32 kernel path two steps from the
    plain one within the float32 bar."""
    from exahype_tpu_torch.models.z4 import gauge_wave_state, make_z4_solver, solver_constraints

    dev = _card()
    sol64 = make_z4_solver(2, 3, (64, 2), dx=1.0 / 64, device=dev, dtype=torch.float64)
    readings = {}
    for dtype in (torch.float64, torch.float32):
        sol = make_z4_solver(2, 3, (64, 2), dx=1.0 / 64, device=dev, dtype=dtype)
        cu = CudaADERDG(sol)
        u0 = gauge_wave_state(sol, amplitude=0.01)
        u = cu.run(u0, 256, 0.1 / 256)
        exact = gauge_wave_state(sol64, t=0.1, amplitude=0.01)
        H, M = solver_constraints(sol64, u.double())
        readings[dtype] = ((u.double() - exact).pow(2).mean().sqrt().item(),
                           max(H.abs().max().item(), M.abs().max().item()))
        if dtype == torch.float32:
            ref = sol.run(u0, 2, 0.1 / 256)
            assert _err(cu.run(u0, 2, 0.1 / 256), ref) <= 2 * _bound(ref, dtype)
    err64, c64 = readings[torch.float64]
    err32, c32 = readings[torch.float32]
    assert err64 < 5e-4 and c64 < 1e-3, readings
    assert c32 > 1e-3, readings


# ------------------------- the shifted system: K5 c and K1 d's 53-variable instance


#: The three families of the shifted system: frozen shift, Gamma-driver with
#: κ₁ damping and η ≠ 1, Gamma-driver with 1+log slicing, f_b ≠ 0.75, m ≠ 2.
Z4S_PARAMS = [
    dict(shift="frozen"),
    dict(shift="gamma_driver", kappa1=0.2, eta=0.7),
    dict(shift="gamma_driver", slicing="1+log", f_b=0.5, m=1.5),
]
Z4S_IDS = ["frozen", "driver", "driver_1+log"]


def _z4s_setup(grid, dtype, **params):
    """The fused shifted solver at ``grid`` (p2, dx = 1/128) on the card,
    its ``CudaADERDG`` and its ``with_cuda_rhs`` copy, and the moving gauge
    wave (v = 0.2, amplitude 0.1) with seeded noise of 1e-3 on every slot:
    on the exact wave b = B = 0 and their gradients vanish, so a kernel that
    dropped the ∂B, ∂b or B·D terms would pass there."""
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4 import make_z4_shift_solver, moving_gauge_wave_state

    dev = _card()
    sol = make_z4_shift_solver(3, 2, grid, dx=1.0 / 128, fused_rhs="soa", device=dev,
                               dtype=dtype, **params)
    u = moving_gauge_wave_state(sol, v=0.2, amplitude=0.1)
    noise = np.random.default_rng(5).standard_normal(u.shape)
    u = (u + 1e-3 * torch.from_numpy(noise).to(u)).contiguous()
    return sol, CudaADERDG(sol), with_cuda_rhs(sol), u


@pytest.mark.cuda
@pytest.mark.parametrize("params", Z4S_PARAMS, ids=Z4S_IDS)
@pytest.mark.parametrize("dtype,grid", Z4_CASES)
def test_shift_rhs_kernel_matches_plain(dtype, grid, params):
    """K5 c against the wrapped plain function on every call of one step."""
    plain, _, kern, u = _z4s_setup(grid, dtype, **params)
    k5 = kern.rhs_all_fn
    assert k5.kernel == "rhs_all_z4_shift"
    calls = _rhs_calls(plain, u)
    assert len(calls) == plain.picard_iters + 2
    for Q, grads, va in calls:
        Q0 = Q.clone()
        got = k5(Q, grads, va)
        ref = plain.rhs_all_fn(Q, grads, va)
        torch.cuda.synchronize()
        assert torch.equal(Q, Q0) and got.shape == ref.shape
        assert _err(got, ref) <= _z4_bound(ref, dtype)
        assert torch.equal(got, k5(Q, grads, va))  # bitwise repeatable
        if params["shift"] == "frozen":
            assert not got[:, 38:].any()
    assert k5.launches == 2 * len(calls)
    step = kern.step(u, 1e-4)
    ref = plain.step(u, 1e-4)
    torch.cuda.synchronize()
    assert _err(step, ref) <= _z4_bound(ref, dtype)
    assert k5.launches == 2 * len(calls) + plain.picard_iters + 2


@pytest.mark.cuda
@pytest.mark.parametrize("params", Z4S_PARAMS, ids=Z4S_IDS)
@pytest.mark.parametrize("dtype,grid", Z4_STEP_CASES)
def test_z4_shift_kernels_match_plain(dtype, grid, params):
    """Each of the three shifted kernels against its plain version, fed the
    plain inputs; dt by value and by pointer."""
    sol, cu, _, u = _z4s_setup(grid, dtype, **params)
    dt = 1e-4
    u0 = u.clone()
    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_t, faces_t, _ = cu.predictor_volume(u, torch.tensor(dt, dtype=dtype, device=u.device))
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    fhat_k, fhalf_k = cu.face_flux(faces_p)
    fhat_p, fhalf_p = _z4_plain_halves(sol, faces_p)
    upd_k = cu.surface_update(new_p.clone(), fhat_p, dt, fhalf=fhalf_p)
    upd_t = cu.surface_update(new_p.clone(), fhat_p, torch.tensor(dt, dtype=dtype, device=u.device),
                              fhalf=fhalf_p)
    upd_p = _z4_plain_update(sol, new_p, fhat_p, fhalf_p, dt)
    torch.cuda.synchronize()
    assert torch.equal(u, u0)
    for a, b in ((new_k, new_p), (faces_k, faces_p), (fhat_k, fhat_p), (upd_k, upd_p)):
        assert _err(a, b) <= _z4_bound(b, dtype)
    if dtype == torch.float64:
        assert _err(fhalf_k, fhalf_p) <= _z4_bound(fhalf_p, dtype)
    else:
        err, limit = _z4_half_bound(sol, faces_p, fhalf_k, fhalf_p)
        assert err <= limit
    assert not faces_k[:, 2:].any()  # the F̄ rows are written as zeros
    assert torch.equal(new_t, new_k) and torch.equal(faces_t, faces_k)
    assert torch.equal(upd_t, upd_k)
    assert cu.launches == {name: n for name, n in zip(cu.kernels, (2, 1, 2))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", Z4_STEP_CASES)
def test_z4_shift_stages_cross_feed_and_step(dtype, grid):
    """The kernel predictor into the plain face stage and the plain
    predictor into the kernel face stage; the step, 3 launches, bitwise
    repeatable; the Gamma-driver moves the gauge sector."""
    sol, cu, _, u = _z4s_setup(grid, dtype, **Z4S_PARAMS[1])
    dt = 1e-4
    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    ref = sol.face_surface(new_p, faces_p, dt)
    mixed_a = sol.face_surface(new_k, faces_k, dt)
    mixed_b = cu.face_surface(new_p.clone(), faces_p, dt)
    cu.reset_launches()
    step = cu.step(u, dt)
    assert cu.launches == {name: 1 for name in cu.kernels}
    again = cu.run(u, 1, dt)
    torch.cuda.synchronize()
    for a in (mixed_a, mixed_b, step):
        assert _err(a, ref) <= _z4_bound(ref, dtype)
    assert torch.equal(step, again)
    assert (step - u)[:, :, :, 38:].abs().max().item() > 0


@pytest.mark.cuda
def test_z4_shift_kernel_info_and_refusals():
    sol, cu, _, u = _z4s_setup((4, 2, 8), torch.float64)
    assert cu.kernels == ("aderdg_predictor_volume_z4_shift", "aderdg_face_flux_z4_shift",
                          "aderdg_surface_update_z4_shift")
    for dtype in (torch.float32, torch.float64):
        for name in cu.kernels:
            info = cu.kernel_info(name, dtype)
            assert info["blocks_per_sm"] >= 1 and info["registers"] > 0, (name, dtype, info)
    # 3 cells a block in float32 and 1 in float64: as many as 227 KB admit.
    f32 = cu.kernel_info(cu.kernels[0], torch.float32)
    f64 = cu.kernel_info(cu.kernels[0], torch.float64)
    assert (f32["threads"], f32["smem"]) == (243, 194076)
    assert (f64["threads"], f64["smem"]) == (81, 129384)
    new, faces, _ = cu.predictor_volume(u, 1e-4)
    fhat, fhalf = cu.face_flux(faces)
    with pytest.raises(LoweringError, match="fhalf"):
        cu.surface_update(new, fhat, 1e-4)
    with pytest.raises(LoweringError, match="shape"):
        cu.predictor_volume(u[:, :, :, :38].contiguous(), 1e-4)


# ------------------------- Z4+GRHD: K5 d and K1 d's conservative-flux variant


#: The Z4+GRHD families: the matter path's own (harmonic slicing f = 0, Γ =
#: 5/3, 10 Newton trips) and the kernels' other branches (1+log slicing, m ≠
#: 2, κ damping, Γ = 4/3, 7 trips).
Z4M_PARAMS = [
    dict(slicing="harmonic", f=0.0),
    dict(slicing="1+log", m=1.5, kappa1=0.1, kappa2=0.3, gamma=4.0 / 3.0, iters=7),
]
Z4M_IDS = ["flrw_gauge", "1+log_damped"]


def _z4m_setup(grid, dtype, **params):
    """The fused Z4+GRHD solver at ``grid`` (p2, dx = 1/128) on the card,
    its ``CudaADERDG`` and ``with_cuda_rhs`` copy, and a state from
    ``pack_matter``: near the FLRW slice (γ ≈ δ, K ≈ −0.48 δ) with seeded
    noise of 1e-3 on every Z4 slot, ρ ≈ 0.02, p ≈ 0.008 and a velocity
    field of up to ~0.3 (so every flux row, matter term and hydro source is
    live)."""
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4_matter import make_z4_matter_solver, pack_matter

    dev = _card()
    sol = make_z4_matter_solver(3, 2, grid, dx=1.0 / 128, fused_rhs="soa", device=dev,
                                dtype=dtype, **params)
    va = sol.var_axis
    shape = sol.state_shape[:va] + sol.state_shape[va + 1:]
    rng = np.random.default_rng(5)
    z4 = 1e-3 * rng.standard_normal(shape + (38,))
    z4[..., [0, 1, 4, 6]] += 1.0
    z4[..., [7, 10, 12]] -= 0.48
    rho = 0.02 * (1.0 + 0.1 * rng.random(shape))
    p = 0.008 * (1.0 + 0.1 * rng.random(shape))
    v = 0.3 * (rng.random(shape + (3,)) - 0.5)
    q = pack_matter(*(torch.from_numpy(x) for x in (z4, rho, v, p)))
    u = q.movedim(-1, va).to(dev, dtype).contiguous()
    return sol, CudaADERDG(sol), with_cuda_rhs(sol), u


@pytest.mark.cuda
@pytest.mark.parametrize("params", Z4M_PARAMS, ids=Z4M_IDS)
@pytest.mark.parametrize("dtype,grid", Z4_CASES)
def test_matter_rhs_kernel_matches_plain(dtype, grid, params):
    """K5 d against the wrapped plain function on every call of one step."""
    plain, _, kern, u = _z4m_setup(grid, dtype, **params)
    k5 = kern.rhs_all_fn
    assert k5.kernel == "rhs_all_z4_matter"
    calls = _rhs_calls(plain, u)
    assert len(calls) == plain.picard_iters + 2
    for Q, grads, va in calls:
        Q0 = Q.clone()
        got = k5(Q, grads, va)
        ref = plain.rhs_all_fn(Q, grads, va)
        torch.cuda.synchronize()
        assert torch.equal(Q, Q0) and got.shape == ref.shape
        assert _err(got, ref) <= _z4_bound(ref, dtype)
        assert torch.equal(got, k5(Q, grads, va))  # bitwise repeatable
        assert ref.narrow(va, 39, 4).abs().max().item() > 0  # the hydro sources are live
    assert k5.launches == 2 * len(calls)
    step = kern.step(u, 1e-4)
    ref = plain.step(u, 1e-4)
    torch.cuda.synchronize()
    assert _err(step, ref) <= _z4_bound(ref, dtype)
    assert k5.launches == 2 * len(calls) + plain.picard_iters + 2


@pytest.mark.cuda
@pytest.mark.parametrize("params", Z4M_PARAMS, ids=Z4M_IDS)
@pytest.mark.parametrize("dtype,grid", Z4_STEP_CASES)
def test_z4_matter_kernels_match_plain(dtype, grid, params):
    """Each of the three Z4+GRHD kernels against its plain version, fed the
    plain inputs; dt by value and by pointer; the face tensor's f rows carry
    the hydro flux and only it."""
    sol, cu, _, u = _z4m_setup(grid, dtype, **params)
    dt = 1e-4
    u0 = u.clone()
    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_t, faces_t, _ = cu.predictor_volume(u, torch.tensor(dt, dtype=dtype, device=u.device))
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    fhat_k, fhalf_k = cu.face_flux(faces_p)
    fhat_p, fhalf_p = _z4_plain_halves(sol, faces_p)
    upd_k = cu.surface_update(new_p.clone(), fhat_p, dt, fhalf=fhalf_p)
    upd_p = _z4_plain_update(sol, new_p, fhat_p, fhalf_p, dt)
    torch.cuda.synchronize()
    assert torch.equal(u, u0)
    for a, b in ((new_k, new_p), (faces_k, faces_p), (fhat_k, fhat_p), (upd_k, upd_p)):
        assert _err(a, b) <= _z4_bound(b, dtype)
    if dtype == torch.float64:
        assert _err(fhalf_k, fhalf_p) <= _z4_bound(fhalf_p, dtype)
    else:
        err, limit = _z4_half_bound(sol, faces_p, fhalf_k, fhalf_p)
        assert err <= limit
    assert not faces_k[:, 2:, :, :38].any()  # the Z4 rows' F̄ are zeros
    assert faces_k[:, 2:, :, 38:].any()  # the hydro rows' are not
    assert torch.equal(new_t, new_k) and torch.equal(faces_t, faces_k)
    assert cu.launches == {name: n for name, n in zip(cu.kernels, (2, 1, 1))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", Z4_STEP_CASES)
def test_z4_matter_stages_cross_feed_and_step(dtype, grid):
    """The kernel predictor into the plain face stage and the plain
    predictor into the kernel face stage; the step, 3 launches, bitwise
    repeatable; the fluid moves."""
    sol, cu, _, u = _z4m_setup(grid, dtype, **Z4M_PARAMS[0])
    dt = 1e-4
    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    ref = sol.face_surface(new_p, faces_p, dt)
    mixed_a = sol.face_surface(new_k, faces_k, dt)
    mixed_b = cu.face_surface(new_p.clone(), faces_p, dt)
    cu.reset_launches()
    step = cu.step(u, dt)
    assert cu.launches == {name: 1 for name in cu.kernels}
    again = cu.run(u, 1, dt)
    torch.cuda.synchronize()
    for a in (mixed_a, mixed_b, step):
        assert _err(a, ref) <= _z4_bound(ref, dtype)
    assert torch.equal(step, again)
    assert (step - u)[:, :, :, 38:].abs().max().item() > 0


@pytest.mark.cuda
def test_z4_matter_kernel_info_and_refusals():
    sol, cu, _, u = _z4m_setup((4, 2, 8), torch.float64)
    assert cu.kernels == ("aderdg_predictor_volume_z4_matter", "aderdg_face_flux_z4_matter",
                          "aderdg_surface_update_z4_matter")
    for dtype in (torch.float32, torch.float64):
        for name in cu.kernels:
            info = cu.kernel_info(name, dtype)
            assert info["blocks_per_sm"] >= 1 and info["registers"] > 0, (name, dtype, info)
    # 4 cells a block in float32 and 2 in float64: as many as 227 KB admit
    # with the 15 flux rows.
    f32 = cu.kernel_info(cu.kernels[0], torch.float32)
    f64 = cu.kernel_info(cu.kernels[0], torch.float64)
    assert (f32["threads"], f32["smem"]) == (324, 214272)
    assert (f64["threads"], f64["smem"]) == (162, 214272)
    new, faces, _ = cu.predictor_volume(u, 1e-4)
    fhat, fhalf = cu.face_flux(faces)
    with pytest.raises(LoweringError, match="fhalf"):
        cu.surface_update(new, fhat, 1e-4)
    with pytest.raises(LoweringError, match="shape"):
        cu.predictor_volume(u[:, :, :, :38].contiguous(), 1e-4)


# ------ Z4+GRHD: K1 d's per-axis branch with a flux (3-D p2), the 2-D step (p2) and K5 b


#: (dim, fused_rhs) of the Z4+GRHD forms on the per-axis and 2-D kernels.
Z4M_FORMS = [(3, False), (2, False), (2, "soa")]
Z4M_FORM_IDS = ["3d_p2_per_axis", "2d_p2_per_axis", "2d_p2_fused"]
#: Each form's predictor launch: (threads, dynamic shared memory) in float32
#: and float64 (csrc/aderdg_z4.cuh::z4_cells_per_block: 2 and 1 cells of
#: 81,432 B; 9 and 4 of 23,256 B; 14 and 8 of 14,148 B).
Z4M_FORM_BLOCKS = {
    (3, False): ((162, 162864), (81, 162864)),
    (2, False): ((243, 209304), (108, 186048)),
    (2, "soa"): ((378, 198072), (216, 226368)),
}


def _z4m_form_setup(dim, fused, dtype, grid=None, **params):
    """The Z4+GRHD solver of one form on the card (dx = 1/128), its
    ``CudaADERDG`` and the ``_z4m_setup`` state; the grid ragged in the last
    predictor block and face tile by default."""
    from exahype_tpu_torch.models.z4_matter import make_z4_matter_solver, pack_matter

    dev = _card()
    grid = grid or ((3, 5, 7) if dim == 3 else (7, 37))
    sol = make_z4_matter_solver(dim, 2, grid, dx=1.0 / 128, fused_rhs=fused, device=dev,
                                dtype=dtype, **params)
    va = sol.var_axis
    shape = sol.state_shape[:va] + sol.state_shape[va + 1:]
    rng = np.random.default_rng(5)
    z4 = 1e-3 * rng.standard_normal(shape + (38,))
    z4[..., [0, 1, 4, 6]] += 1.0
    z4[..., [7, 10, 12]] -= 0.48
    rho = 0.02 * (1.0 + 0.1 * rng.random(shape))
    p = 0.008 * (1.0 + 0.1 * rng.random(shape))
    v = 0.3 * (rng.random(shape + (3,)) - 0.5)
    q = pack_matter(*(torch.from_numpy(x) for x in (z4, rho, v, p)))
    return sol, CudaADERDG(sol), q.movedim(-1, va).to(dev, dtype).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("params", Z4M_PARAMS, ids=Z4M_IDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("dim,fused", Z4M_FORMS, ids=Z4M_FORM_IDS)
def test_z4_matter_form_kernels_match_plain(dim, fused, dtype, params):
    """Each kernel of the Z4+GRHD per-axis and 2-D forms against its plain
    version, fed the plain inputs (float32 NCP halves against plain float64
    from the same faces, as ``test_z4_kernels_match_plain`` holds them); the
    face tensor's f rows carry the hydro flux and only it."""
    from exahype_tpu_torch.models.z4_matter import make_z4_matter_solver

    sol, cu, u = _z4m_form_setup(dim, fused, dtype, **params)
    dt = 1e-4
    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    fhat_k, fhalf_k = cu.face_flux(faces_p)
    fhat_p, fhalf_p = _z4_form_halves(sol, faces_p)
    upd_k = cu.surface_update(new_p.clone(), fhat_p.contiguous(), dt,
                              fhalf=fhalf_p.contiguous())
    upd_p = new_p
    for d in range(dim):
        upd_p = sol.surface_term(upd_p, fhat_p[d].view(sol.face_flux_shape), d, dt)
        upd_p = sol.ncp_term(upd_p, fhalf_p[d].view(sol.face_flux_shape), d, dt)
    torch.cuda.synchronize()
    for a, b in ((new_k, new_p), (faces_k, faces_p), (fhat_k, fhat_p), (upd_k, upd_p)):
        assert _err(a, b) <= _z4_bound(b, dtype)
    if dtype == torch.float64:
        assert _err(fhalf_k, fhalf_p) <= _z4_bound(fhalf_p, dtype)
    else:
        sol64 = make_z4_matter_solver(dim, 2, sol.grid_shape, dx=sol._dxs[0], fused_rhs=fused,
                                      device=u.device, dtype=torch.float64, **params)
        ref64 = _z4_form_halves(sol64, faces_p.double())[1]
        limit = max(4 * _err(fhalf_p, ref64), _bound(ref64, torch.float32))
        assert limit < 0.1 * ref64.abs().max().item()
        assert _err(fhalf_k, ref64) <= limit
    assert not faces_k[:, 2:, :, :38].any()  # the Z4 rows' F̄ are zeros
    assert faces_k[:, 2:, :, 38:].any()  # the hydro rows' are not
    assert cu.launches == {name: 1 for name in cu.kernels}


@pytest.mark.cuda
@pytest.mark.parametrize("dim,fused", Z4M_FORMS, ids=Z4M_FORM_IDS)
def test_z4_matter_form_steps_launch_three_kernels(dim, fused):
    """Two steps: 3 launches a step, bitwise repeatable, within the bar of
    the plain steps, the fluid moving; the occupancy query answers for each
    kernel, and the predictor launches as many cells a block as the shared
    memory admits."""
    sol, cu, u = _z4m_form_setup(dim, fused, torch.float64)
    name = "aderdg_predictor_volume" + ("_per_axis" if fused is False else "")
    assert cu.kernels == (f"{name}{'_2d' if dim == 2 else ''}_z4_matter",
                          f"aderdg_face_flux{'_2d' if dim == 2 else ''}_z4_matter",
                          f"aderdg_surface_update{'_2d' if dim == 2 else ''}_z4_matter")
    cu.reset_launches()
    got = cu.run(u, 2, 1e-4)
    assert cu.launches == {name: 2 for name in cu.kernels}
    assert torch.equal(got, cu.run(u, 2, 1e-4))
    ref = sol.run(u, 2, 1e-4)
    assert _err(got, ref) <= _z4_bound(ref, torch.float64)
    assert (got - u).narrow(sol.var_axis, 38, 5).abs().max().item() > 0
    for dtype in (torch.float32, torch.float64):
        for kernel in cu.kernels:
            info = cu.kernel_info(kernel, dtype)
            assert info["blocks_per_sm"] >= 1 and info["registers"] > 0, (kernel, dtype, info)
    for dtype, (threads, smem) in zip((torch.float32, torch.float64),
                                      Z4M_FORM_BLOCKS[(dim, fused)]):
        info = cu.kernel_info(cu.kernels[0], dtype)
        assert (info["threads"], info["smem"]) == (threads, smem), (dtype, info)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", [(torch.float64, (8, 6)), (torch.float32, (16, 8)),
                                        (torch.float64, (5, 3))])
def test_k5b_matter_rhs_kernel_matches_plain(dtype, grid):
    """K5 b's Z4+GRHD instance (``rhs_all_z4_matter_2d``) on every call of
    one step of the 2-D fused solver, and the step through it."""
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs

    plain, _, u = _z4m_form_setup(2, "soa", dtype, grid=grid, **Z4M_PARAMS[1])
    kern = with_cuda_rhs(plain)
    k5 = kern.rhs_all_fn
    assert k5.kernel == "rhs_all_z4_matter_2d"
    calls = _rhs_calls(plain, u)
    assert len(calls) == plain.picard_iters + 2
    for Q, grads, va in calls:
        assert len(grads) == 2
        got = k5(Q, grads, va)
        ref = plain.rhs_all_fn(Q, grads, va)
        torch.cuda.synchronize()
        assert _err(got, ref) <= _z4_bound(ref, dtype)
        assert torch.equal(got, k5(Q, grads, va))  # bitwise repeatable
    k5.reset_launches()
    step = kern.step(u, 1e-4)
    ref = plain.step(u, 1e-4)
    torch.cuda.synchronize()
    assert _err(step, ref) <= _z4_bound(ref, dtype)
    assert k5.launches == plain.picard_iters + 2


# ---------------------- Z4+GRMHD: K5 e and K1 d's conservative-flux variant


#: The Z4+GRMHD families: the GRMHD path's own (harmonic slicing f = 0, Γ =
#: 5/3, 20 Newton trips, c_h = 1, κ = 0.5) and the kernels' other branches
#: (1+log slicing, m ≠ 2, κ₁, κ₂ damping, Γ = 4/3, 7 trips, c_h = 0.8, κ =
#: 2).
Z4G_PARAMS = [
    dict(slicing="harmonic", f=0.0, glm_kappa=0.5),
    dict(slicing="1+log", m=1.5, kappa1=0.1, kappa2=0.3, gamma=4.0 / 3.0, iters=7, c_h=0.8,
         glm_kappa=2.0),
]
Z4G_IDS = ["path_gauge", "1+log_damped"]


def _z4g_setup(grid, dtype, **params):
    """The fused Z4+GRMHD solver at ``grid`` (p2, dx = 1/128) on the card,
    its ``CudaADERDG`` and ``with_cuda_rhs`` copy, and a state from
    ``pack_matter_mhd``: near flat space with seeded noise of 1e-3 on every
    Z4 slot, ρ ≈ 1, p ≈ 1, a velocity field of up to ~0.15 a component, a
    field of 0.05 to 0.1 a component (nowhere zero) and a GLM scalar of
    ~1e-2 (so every flux row, matter term and source is live)."""
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4_grmhd import make_z4_grmhd_solver, pack_matter_mhd

    dev = _card()
    sol = make_z4_grmhd_solver(3, 2, grid, dx=1.0 / 128, fused_rhs="soa", device=dev,
                               dtype=dtype, **params)
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
    q = pack_matter_mhd(*(torch.from_numpy(x) for x in (z4, rho, v, p, B)),
                        psi_glm=torch.from_numpy(psi))
    u = q.movedim(-1, va).to(dev, dtype).contiguous()
    return sol, CudaADERDG(sol), with_cuda_rhs(sol), u


@pytest.mark.cuda
@pytest.mark.parametrize("params", Z4G_PARAMS, ids=Z4G_IDS)
@pytest.mark.parametrize("dtype,grid", Z4_CASES)
def test_grmhd_rhs_kernel_matches_plain(dtype, grid, params):
    """K5 e against the wrapped plain function on every call of one step."""
    plain, _, kern, u = _z4g_setup(grid, dtype, **params)
    k5 = kern.rhs_all_fn
    assert k5.kernel == "rhs_all_z4_grmhd"
    calls = _rhs_calls(plain, u)
    assert len(calls) == plain.picard_iters + 2
    for Q, grads, va in calls:
        Q0 = Q.clone()
        got = k5(Q, grads, va)
        ref = plain.rhs_all_fn(Q, grads, va)
        torch.cuda.synchronize()
        assert torch.equal(Q, Q0) and got.shape == ref.shape
        assert _err(got, ref) <= _z4_bound(ref, dtype)
        assert torch.equal(got, k5(Q, grads, va))  # bitwise repeatable
        assert ref.narrow(va, 39, 4).abs().max().item() > 0  # the hydro sources are live
        assert ref.narrow(va, 46, 1).abs().max().item() > 0  # the GLM damping is live
    assert k5.launches == 2 * len(calls)
    step = kern.step(u, 1e-4)
    ref = plain.step(u, 1e-4)
    torch.cuda.synchronize()
    assert _err(step, ref) <= _z4_bound(ref, dtype)
    assert k5.launches == 2 * len(calls) + plain.picard_iters + 2


@pytest.mark.cuda
def test_grmhd_rhs_kernel_refuses_mismatched_gradients():
    """K5 e keeps K5's refusals: a gradient that is not Q's shape, dtype or
    layout never launches (``PallasRHS`` reshapes it silently)."""
    plain, _, kern, u = _z4g_setup((4, 2, 8), torch.float64)
    Q, grads, va = _rhs_calls(plain, u)[0]
    k5 = kern.rhs_all_fn
    with pytest.raises(LoweringError, match=r"grads\[0\]"):
        k5(Q, (grads[0].reshape(-1).reshape(Q.shape[::-1]), *grads[1:]), va)
    with pytest.raises(LoweringError, match=r"grads\[1\]"):
        k5(Q, (grads[0], grads[1].float(), grads[2]), va)
    with pytest.raises(LoweringError, match="contiguous"):
        k5(Q, (grads[0].transpose(-1, -2).contiguous().transpose(-1, -2), *grads[1:]), va)
    with pytest.raises(LoweringError, match="expected 3 gradient arrays"):
        k5(Q, grads[:2], va)
    assert k5.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("params", Z4G_PARAMS, ids=Z4G_IDS)
@pytest.mark.parametrize("dtype,grid", Z4_STEP_CASES)
def test_z4_grmhd_kernels_match_plain(dtype, grid, params):
    """Each of the three Z4+GRMHD kernels against its plain version, fed the
    plain inputs; dt by value and by pointer; the face tensor's f rows carry
    the matter flux and only it."""
    sol, cu, _, u = _z4g_setup(grid, dtype, **params)
    dt = 1e-4
    u0 = u.clone()
    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_t, faces_t, _ = cu.predictor_volume(u, torch.tensor(dt, dtype=dtype, device=u.device))
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    fhat_k, fhalf_k = cu.face_flux(faces_p)
    fhat_p, fhalf_p = _z4_plain_halves(sol, faces_p)
    upd_k = cu.surface_update(new_p.clone(), fhat_p, dt, fhalf=fhalf_p)
    upd_p = _z4_plain_update(sol, new_p, fhat_p, fhalf_p, dt)
    torch.cuda.synchronize()
    assert torch.equal(u, u0)
    for a, b in ((new_k, new_p), (faces_k, faces_p), (fhat_k, fhat_p), (upd_k, upd_p)):
        assert _err(a, b) <= _z4_bound(b, dtype)
    if dtype == torch.float64:
        assert _err(fhalf_k, fhalf_p) <= _z4_bound(fhalf_p, dtype)
    else:
        err, limit = _z4_half_bound(sol, faces_p, fhalf_k, fhalf_p)
        assert err <= limit
    assert not faces_k[:, 2:, :, :38].any()  # the Z4 rows' F̄ are zeros
    assert faces_k[:, 2:, :, 38:].abs().amax(dim=(0, 1, 2, 4, 5, 6)).min() > 0  # every
    # matter row's F̄ is live
    assert torch.equal(new_t, new_k) and torch.equal(faces_t, faces_k)
    assert cu.launches == {name: n for name, n in zip(cu.kernels, (2, 1, 1))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", Z4_STEP_CASES)
def test_z4_grmhd_stages_cross_feed_and_step(dtype, grid):
    """The kernel predictor into the plain face stage and the plain
    predictor into the kernel face stage; the step, 3 launches, bitwise
    repeatable; the fluid and the field move."""
    sol, cu, _, u = _z4g_setup(grid, dtype, **Z4G_PARAMS[0])
    dt = 1e-4
    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    ref = sol.face_surface(new_p, faces_p, dt)
    mixed_a = sol.face_surface(new_k, faces_k, dt)
    mixed_b = cu.face_surface(new_p.clone(), faces_p, dt)
    cu.reset_launches()
    step = cu.step(u, dt)
    assert cu.launches == {name: 1 for name in cu.kernels}
    again = cu.run(u, 1, dt)
    torch.cuda.synchronize()
    for a in (mixed_a, mixed_b, step):
        assert _err(a, ref) <= _z4_bound(ref, dtype)
    assert torch.equal(step, again)
    assert (step - u)[:, :, :, 38:43].abs().max().item() > 0
    assert (step - u)[:, :, :, 43:].abs().max().item() > 0


@pytest.mark.cuda
def test_z4_grmhd_kernel_info_and_refusals():
    sol, cu, _, u = _z4g_setup((4, 2, 8), torch.float64)
    assert cu.kernels == ("aderdg_predictor_volume_z4_grmhd", "aderdg_face_flux_z4_grmhd",
                          "aderdg_surface_update_z4_grmhd")
    for dtype in (torch.float32, torch.float64):
        for name in cu.kernels:
            info = cu.kernel_info(name, dtype)
            assert info["blocks_per_sm"] >= 1 and info["registers"] > 0, (name, dtype, info)
    # 3 cells a block in float32 and 1 in float64: as many as 227 KB admit
    # with the 27 flux rows (14,796 values a cell).
    f32 = cu.kernel_info(cu.kernels[0], torch.float32)
    f64 = cu.kernel_info(cu.kernels[0], torch.float64)
    assert (f32["threads"], f32["smem"]) == (243, 177552)
    assert (f64["threads"], f64["smem"]) == (81, 118368)
    new, faces, _ = cu.predictor_volume(u, 1e-4)
    fhat, fhalf = cu.face_flux(faces)
    with pytest.raises(LoweringError, match="fhalf"):
        cu.surface_update(new, fhat, 1e-4)
    with pytest.raises(LoweringError, match="shape"):
        cu.predictor_volume(u[:, :, :, :43].contiguous(), 1e-4)


# ------ Z4+GRMHD: K1 d's per-axis branch with a flux (3-D p2), the 2-D step (p2) and K5 b


#: Each Z4+GRMHD form's predictor launch: (threads, dynamic shared memory)
#: in float32 and float64 (csrc/aderdg_z4.cuh::z4_cells_per_block: 2 and 1
#: cells of 89,640 B; 9 and 4 of 25,560 B; 14 and 7 of 16,020 B).
Z4G_FORM_BLOCKS = {
    (3, False): ((162, 179280), (81, 179280)),
    (2, False): ((243, 230040), (108, 204480)),
    (2, "soa"): ((378, 224280), (189, 224280)),
}


def _z4g_form_setup(dim, fused, dtype, grid=None, **params):
    """The Z4+GRMHD solver of one form on the card (dx = 1/128), its
    ``CudaADERDG`` and the ``_z4g_setup`` state (a field nowhere zero); the
    grid ragged in the last predictor block and face tile by default."""
    from exahype_tpu_torch.models.z4_grmhd import make_z4_grmhd_solver, pack_matter_mhd

    dev = _card()
    grid = grid or ((3, 5, 7) if dim == 3 else (7, 37))
    sol = make_z4_grmhd_solver(dim, 2, grid, dx=1.0 / 128, fused_rhs=fused, device=dev,
                               dtype=dtype, **params)
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
    q = pack_matter_mhd(*(torch.from_numpy(x) for x in (z4, rho, v, p, B)),
                        psi_glm=torch.from_numpy(psi))
    return sol, CudaADERDG(sol), q.movedim(-1, va).to(dev, dtype).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("params", Z4G_PARAMS, ids=Z4G_IDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("dim,fused", Z4M_FORMS, ids=Z4M_FORM_IDS)
def test_z4_grmhd_form_kernels_match_plain(dim, fused, dtype, params):
    """Each kernel of the Z4+GRMHD per-axis and 2-D forms against its plain
    version, fed the plain inputs (float32 NCP halves against plain float64
    from the same faces, as ``test_z4_kernels_match_plain`` holds them); the
    face tensor's f rows carry the matter flux and only it."""
    from exahype_tpu_torch.models.z4_grmhd import make_z4_grmhd_solver

    sol, cu, u = _z4g_form_setup(dim, fused, dtype, **params)
    dt = 1e-4
    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    fhat_k, fhalf_k = cu.face_flux(faces_p)
    fhat_p, fhalf_p = _z4_form_halves(sol, faces_p)
    upd_k = cu.surface_update(new_p.clone(), fhat_p.contiguous(), dt,
                              fhalf=fhalf_p.contiguous())
    upd_p = new_p
    for d in range(dim):
        upd_p = sol.surface_term(upd_p, fhat_p[d].view(sol.face_flux_shape), d, dt)
        upd_p = sol.ncp_term(upd_p, fhalf_p[d].view(sol.face_flux_shape), d, dt)
    torch.cuda.synchronize()
    for a, b in ((new_k, new_p), (faces_k, faces_p), (fhat_k, fhat_p), (upd_k, upd_p)):
        assert _err(a, b) <= _z4_bound(b, dtype)
    if dtype == torch.float64:
        assert _err(fhalf_k, fhalf_p) <= _z4_bound(fhalf_p, dtype)
    else:
        sol64 = make_z4_grmhd_solver(dim, 2, sol.grid_shape, dx=sol._dxs[0], fused_rhs=fused,
                                     device=u.device, dtype=torch.float64, **params)
        ref64 = _z4_form_halves(sol64, faces_p.double())[1]
        limit = max(4 * _err(fhalf_p, ref64), _bound(ref64, torch.float32))
        assert limit < 0.1 * ref64.abs().max().item()
        assert _err(fhalf_k, ref64) <= limit
    assert not faces_k[:, 2:, :, :38].any()  # the Z4 rows' F̄ are zeros
    assert faces_k[:, 2:, :, 38:].any()  # the matter rows' are not
    assert cu.launches == {name: 1 for name in cu.kernels}


@pytest.mark.cuda
@pytest.mark.parametrize("dim,fused", Z4M_FORMS, ids=Z4M_FORM_IDS)
def test_z4_grmhd_form_steps_launch_three_kernels(dim, fused):
    """Two steps: 3 launches a step, bitwise repeatable, within the bar of
    the plain steps, the matter moving; the occupancy query answers for each
    kernel, and the predictor launches as many cells a block as the shared
    memory admits."""
    sol, cu, u = _z4g_form_setup(dim, fused, torch.float64)
    name = "aderdg_predictor_volume" + ("_per_axis" if fused is False else "")
    assert cu.kernels == (f"{name}{'_2d' if dim == 2 else ''}_z4_grmhd",
                          f"aderdg_face_flux{'_2d' if dim == 2 else ''}_z4_grmhd",
                          f"aderdg_surface_update{'_2d' if dim == 2 else ''}_z4_grmhd")
    cu.reset_launches()
    got = cu.run(u, 2, 1e-4)
    assert cu.launches == {name: 2 for name in cu.kernels}
    assert torch.equal(got, cu.run(u, 2, 1e-4))
    ref = sol.run(u, 2, 1e-4)
    assert _err(got, ref) <= _z4_bound(ref, torch.float64)
    assert (got - u).narrow(sol.var_axis, 38, 9).abs().max().item() > 0
    for dtype in (torch.float32, torch.float64):
        for kernel in cu.kernels:
            info = cu.kernel_info(kernel, dtype)
            assert info["blocks_per_sm"] >= 1 and info["registers"] > 0, (kernel, dtype, info)
    for dtype, (threads, smem) in zip((torch.float32, torch.float64),
                                      Z4G_FORM_BLOCKS[(dim, fused)]):
        info = cu.kernel_info(cu.kernels[0], dtype)
        assert (info["threads"], info["smem"]) == (threads, smem), (dtype, info)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", [(torch.float64, (8, 6)), (torch.float32, (16, 8)),
                                        (torch.float64, (5, 3))])
def test_k5b_grmhd_rhs_kernel_matches_plain(dtype, grid):
    """K5 b's Z4+GRMHD instance (``rhs_all_z4_grmhd_2d``) on every call of
    one step of the 2-D fused solver, and the step through it."""
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs

    plain, _, u = _z4g_form_setup(2, "soa", dtype, grid=grid, **Z4G_PARAMS[1])
    kern = with_cuda_rhs(plain)
    k5 = kern.rhs_all_fn
    assert k5.kernel == "rhs_all_z4_grmhd_2d"
    calls = _rhs_calls(plain, u)
    assert len(calls) == plain.picard_iters + 2
    for Q, grads, va in calls:
        assert len(grads) == 2
        got = k5(Q, grads, va)
        ref = plain.rhs_all_fn(Q, grads, va)
        torch.cuda.synchronize()
        assert _err(got, ref) <= _z4_bound(ref, dtype)
        assert torch.equal(got, k5(Q, grads, va))  # bitwise repeatable
    k5.reset_launches()
    step = kern.step(u, 1e-4)
    ref = plain.step(u, 1e-4)
    torch.cuda.synchronize()
    assert _err(step, ref) <= _z4_bound(ref, dtype)
    assert k5.launches == plain.picard_iters + 2


#: Each shifted form's predictor launch: (threads, dynamic shared memory) in
#: float32 and float64 (csrc/aderdg_z4.cuh::z4_cells_per_block: 2 and 1
#: cells of 99,036 B; 8 and 4 of 28,368 B; 13 and 6 of 16,920 B).
Z4S_FORM_BLOCKS = {
    (3, False): ((162, 198072), (81, 198072)),
    (2, False): ((216, 226944), (108, 226944)),
    (2, "soa"): ((351, 219960), (162, 203040)),
}


def _z4s_form_setup(dim, fused, dtype, grid=None, **params):
    """The shifted solver of one form on the card (dx = 1/128), its
    ``CudaADERDG`` and the moving gauge wave (v = 0.2, amplitude 0.1) with
    seeded noise of 1e-3 on every slot (on the exact wave b = B = ∂b = ∂B =
    0, and the kernels' gradient rows skip β's slots 38-40); the grid ragged
    in the last predictor block and face tile by default."""
    from exahype_tpu_torch.models.z4 import make_z4_shift_solver, moving_gauge_wave_state

    dev = _card()
    grid = grid or ((3, 5, 7) if dim == 3 else (7, 37))
    sol = make_z4_shift_solver(dim, 2, grid, dx=1.0 / 128, fused_rhs=fused, device=dev,
                               dtype=dtype, **params)
    u = moving_gauge_wave_state(sol, v=0.2, amplitude=0.1)
    noise = np.random.default_rng(5).standard_normal(u.shape)
    return sol, CudaADERDG(sol), (u + 1e-3 * torch.from_numpy(noise).to(u)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("params", Z4S_PARAMS, ids=Z4S_IDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("dim,fused", Z4M_FORMS, ids=Z4M_FORM_IDS)
def test_z4_shift_form_kernels_match_plain(dim, fused, dtype, params):
    """Each kernel of the shifted per-axis and 2-D forms against its plain
    version, fed the plain inputs (float32 NCP halves against plain float64
    from the same faces, as ``test_z4_kernels_match_plain`` holds them); the
    face tensor's f rows are zeros."""
    from exahype_tpu_torch.models.z4 import make_z4_shift_solver

    sol, cu, u = _z4s_form_setup(dim, fused, dtype, **params)
    dt = 1e-4
    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    fhat_k, fhalf_k = cu.face_flux(faces_p)
    fhat_p, fhalf_p = _z4_form_halves(sol, faces_p)
    upd_k = cu.surface_update(new_p.clone(), fhat_p.contiguous(), dt,
                              fhalf=fhalf_p.contiguous())
    upd_p = new_p
    for d in range(dim):
        upd_p = sol.surface_term(upd_p, fhat_p[d].view(sol.face_flux_shape), d, dt)
        upd_p = sol.ncp_term(upd_p, fhalf_p[d].view(sol.face_flux_shape), d, dt)
    torch.cuda.synchronize()
    for a, b in ((new_k, new_p), (faces_k, faces_p), (fhat_k, fhat_p), (upd_k, upd_p)):
        assert _err(a, b) <= _z4_bound(b, dtype)
    if dtype == torch.float64:
        assert _err(fhalf_k, fhalf_p) <= _z4_bound(fhalf_p, dtype)
    else:
        sol64 = make_z4_shift_solver(dim, 2, sol.grid_shape, dx=sol._dxs[0], fused_rhs=fused,
                                     device=u.device, dtype=torch.float64, **params)
        ref64 = _z4_form_halves(sol64, faces_p.double())[1]
        limit = max(4 * _err(fhalf_p, ref64), _bound(ref64, torch.float32))
        assert limit < 0.1 * ref64.abs().max().item()
        assert _err(fhalf_k, ref64) <= limit
    assert not faces_k[:, 2:].any()  # the F̄ rows are written as zeros
    assert cu.launches == {name: 1 for name in cu.kernels}


@pytest.mark.cuda
@pytest.mark.parametrize("params", Z4S_PARAMS[:2], ids=Z4S_IDS[:2])
@pytest.mark.parametrize("dim,fused", Z4M_FORMS, ids=Z4M_FORM_IDS)
def test_z4_shift_form_steps_launch_three_kernels(dim, fused, params):
    """Two steps in each shift mode: 3 launches a step, bitwise repeatable,
    within the bar of the plain steps, the gauge sector moving under the
    Gamma-driver (frozen, it moves by the face stage's dissipation only);
    the occupancy query answers for each kernel, and the
    predictor launches as many cells a block as the shared memory admits."""
    sol, cu, u = _z4s_form_setup(dim, fused, torch.float64, **params)
    name = "aderdg_predictor_volume" + ("_per_axis" if fused is False else "")
    assert cu.kernels == (f"{name}{'_2d' if dim == 2 else ''}_z4_shift",
                          f"aderdg_face_flux{'_2d' if dim == 2 else ''}_z4_shift",
                          f"aderdg_surface_update{'_2d' if dim == 2 else ''}_z4_shift")
    cu.reset_launches()
    got = cu.run(u, 2, 1e-4)
    assert cu.launches == {name: 2 for name in cu.kernels}
    assert torch.equal(got, cu.run(u, 2, 1e-4))
    ref = sol.run(u, 2, 1e-4)
    assert _err(got, ref) <= _z4_bound(ref, torch.float64)
    if params["shift"] == "gamma_driver":
        assert (got - u).narrow(sol.var_axis, 38, 15).abs().max().item() > 0
    for dtype in (torch.float32, torch.float64):
        for kernel in cu.kernels:
            info = cu.kernel_info(kernel, dtype)
            assert info["blocks_per_sm"] >= 1 and info["registers"] > 0, (kernel, dtype, info)
    for dtype, (threads, smem) in zip((torch.float32, torch.float64),
                                      Z4S_FORM_BLOCKS[(dim, fused)]):
        info = cu.kernel_info(cu.kernels[0], dtype)
        assert (info["threads"], info["smem"]) == (threads, smem), (dtype, info)


@pytest.mark.cuda
@pytest.mark.parametrize("params", Z4S_PARAMS, ids=Z4S_IDS)
@pytest.mark.parametrize("dtype,grid", [(torch.float64, (8, 6)), (torch.float32, (16, 8)),
                                        (torch.float64, (5, 3))])
def test_k5b_shift_rhs_kernel_matches_plain(dtype, grid, params):
    """K5 b's shifted instance (``rhs_all_z4_shift_2d``) on every call of
    one step of the 2-D fused solver, and the step through it."""
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs

    plain, _, u = _z4s_form_setup(2, "soa", dtype, grid=grid, **params)
    kern = with_cuda_rhs(plain)
    k5 = kern.rhs_all_fn
    assert k5.kernel == "rhs_all_z4_shift_2d"
    calls = _rhs_calls(plain, u)
    assert len(calls) == plain.picard_iters + 2
    for Q, grads, va in calls:
        assert len(grads) == 2
        got = k5(Q, grads, va)
        ref = plain.rhs_all_fn(Q, grads, va)
        torch.cuda.synchronize()
        assert _err(got, ref) <= _z4_bound(ref, dtype)
        assert torch.equal(got, k5(Q, grads, va))  # bitwise repeatable
        if params["shift"] == "frozen":
            assert not got.narrow(va, 38, 15).any()
    k5.reset_launches()
    step = kern.step(u, 1e-4)
    ref = plain.step(u, 1e-4)
    torch.cuda.synchronize()
    assert _err(step, ref) <= _z4_bound(ref, dtype)
    assert k5.launches == plain.picard_iters + 2


# ------------------------------------------------------------ K1 e and K5 b


K1E_CASES = [
    (torch.float64, (8, 4, 8)),
    (torch.float32, (8, 4, 8)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", K1E_CASES)
@pytest.mark.parametrize("name", ["periodic"] + WALL_NAMES)
def test_k1e_exchanged_pair_matches_plain(name, dtype, grid):
    """K1 e, the face pair with exchanged sides: each window of two along
    each axis, walls gated to the window that owns them, against its plain
    version (``shard.exchanged_face_surface``) on the same inputs, and bit
    for bit the unsharded kernels' face stage on that window; with one
    window (every exchange a local copy) the unsharded stage itself."""
    walls = {} if name == "periodic" else _euler_walls(name, grid)
    sol, cu, u = _setup(grid, dtype, **walls)
    new, faces, _ = sol.predictor_volume(u, DT)
    whole = cu.face_surface(new.clone(), faces, DT)
    for d in range(3):
        for parts in (1, 2):
            for p in range(parts):
                local, lf, ln, modes, planes = shard.window_faces(sol, faces, new, d, parts, p)
                lcu = CudaADERDG(local)
                fhat, fside = lcu.face_flux_exchanged(lf, modes, planes)
                got = lcu.surface_update_exchanged(ln.clone(), fhat, DT, fside, modes)
                ref = shard.exchanged_face_surface(local, ln, lf, DT, modes, planes)
                length = grid[d] // parts
                torch.cuda.synchronize()
                assert _err(got, ref) <= _bound(ref, dtype), (d, p, modes)
                assert torch.equal(got, whole.narrow(sol.grid_axis(d), p * length, length)), (
                    d, p, modes)
                assert lcu.launches["aderdg_face_flux_exchanged"] == 1


@pytest.mark.cuda
def test_k1e_kernel_info_and_refusals():
    sol, cu, u = _setup((2, 2, 4), torch.float64)
    info = cu.kernel_info("aderdg_face_flux_exchanged", torch.float64)
    assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, info
    new, faces, _ = cu.predictor_volume(u, DT)
    modes = (("exchanged", "exchanged"), ("periodic", "periodic"), ("periodic", "periodic"))
    with pytest.raises(KeyError):
        cu.face_flux_exchanged(faces, modes, {})
    with pytest.raises(LoweringError, match="faces must be on the card"):
        cu.face_flux_exchanged(faces.cpu(), modes, {})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", [(torch.float64, (8, 6)), (torch.float32, (16, 8)),
                                        (torch.float64, (5, 3))])
def test_k5b_rhs_kernel_matches_plain(dtype, grid):
    """K5 b, the 2-D vacuum Z4 right-hand side, on every call of one step of
    the 2-D gauge wave with seeded noise on every slot."""
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4 import gauge_wave_state, make_z4_solver

    dev = _card()
    plain = make_z4_solver(2, 2, grid, dx=1.0 / grid[0], impl="soa", fused_rhs="soa",
                           kappa1=0.5, kappa2=0.1, device=dev, dtype=dtype)
    kern = with_cuda_rhs(plain)
    k5 = kern.rhs_all_fn
    assert k5.kernel == "rhs_all_z4_2d"
    rng = np.random.default_rng(7)
    u = gauge_wave_state(plain, amplitude=0.1) + torch.as_tensor(
        1e-3 * rng.standard_normal(plain.state_shape), dtype=dtype, device=dev)
    calls = _rhs_calls(plain, u)
    for Q, grads, va in calls:
        got = k5(Q, grads, va)
        ref = plain.rhs_all_fn(Q, grads, va)
        torch.cuda.synchronize()
        assert _err(got, ref) <= _z4_bound(ref, dtype)
        assert torch.equal(got, k5(Q, grads, va))
    step = kern.step(u, 1e-4)
    ref = plain.step(u, 1e-4)
    torch.cuda.synchronize()
    assert _err(step, ref) <= _z4_bound(ref, dtype)
