"""The CUDA kernels against their plain PyTorch versions, on the card: the
Picard predictor and the two-launch face stage of ``csrc/aderdg.cu`` (with
its face-flux output), the CK predictor (K2) and the face stage's elastic
variant, both at the edges of their tilings, the
limiter's subcell sweep (K3, ``csrc/subcell.cu``) alone and under
``LimitedADERDG``, the spec kernel (K4) that ``CudaPrinter`` generates,
alone and under ``GridSolver``, and the fused Z4 right-hand side (K5,
``csrc/rhs.cu``) alone and under the Z4 step.

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


def _setup(grid, dtype, dx=DX):
    dev = _card()
    flux, eig = euler_physics(3)
    sol = ADERDGSolver(3, 3, 5, grid, flux, eig, dx=dx, device=dev, dtype=dtype)
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
    new_k, faces_k = cu.predictor_volume(u, DT)
    new_p, faces_p = sol.predictor_volume(u, DT)
    torch.cuda.synchronize()
    assert torch.equal(u, u0)
    assert _err(new_k, new_p) <= _bound(new_p, dtype)
    assert _err(faces_k, faces_p) <= _bound(faces_p, dtype)
    assert cu.launches["aderdg_predictor_volume"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CASES)
def test_face_surface_kernel_matches_plain(dtype, grid):
    sol, cu, u = _setup(grid, dtype)
    new, faces = sol.predictor_volume(u, DT)
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
    new, faces = sol.predictor_volume(u, DT)
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


def _ck_setup(grid, dtype):
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
                       dissipation_mask=DISSIPATION_MASK)
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
    (torch.float64, (3, 5, 7)),  # ragged last block, odd wraps
    (torch.float32, (8, 4, 32)),
]
CK_DT = 2e-4  # bench.py's dt, under the CFL limit at dx = 1/g0 <= 1/8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,grid", CK_CASES)
def test_ck_predictor_kernel_matches_plain(dtype, grid):
    sol, cu, u = _ck_setup(grid, dtype)
    u0 = u.clone()
    new_k, faces_k = cu.predictor_volume(u, CK_DT)
    new_p, faces_p = sol.predictor_volume(u, CK_DT)
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
    new, faces = sol.predictor_volume(u, CK_DT)
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

    new_k, faces_k = cu.predictor_volume(u, dt)
    new_p, faces_p = sol.predictor_volume(u, dt)
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
    from exahype_tpu_torch.models import subcell_cuda

    lim, _ = _limiter((4, 2, 8), dtype)
    s, lo, hi = _sweep_inputs(d, K, L, dtype, lim.P.device)
    s0 = s.clone()
    subcell_cuda.reset_launches()
    got = subcell_cuda.row_sweep_call(lim, d, s, lo, hi, DT)
    again = subcell_cuda.row_sweep_call(lim, d, s, lo, hi,
                                        torch.tensor(DT, dtype=dtype, device=s.device))
    ref = lim._row_sweep_math(s, lo, hi, d, DT)
    torch.cuda.synchronize()
    assert torch.equal(s, s0)
    for a, b, c in zip(got, again, ref):
        assert a.shape == c.shape
        assert _err(a, c) <= _bound(c, dtype)
        assert torch.equal(a, b)  # bitwise repeatable, dt by value == by pointer
    assert subcell_cuda.launches["subcell_row_sweep"] == 2


@pytest.mark.cuda
def test_subcell_sweep_kernel_refuses_what_it_is_not_built_for():
    from exahype_tpu_torch.models import subcell_cuda
    from exahype_tpu_torch.utils.errors import LoweringError

    lim, _ = _limiter((4, 2, 8), torch.float64)
    s, lo, hi = _sweep_inputs(0, 2, 8, torch.float64, lim.P.device)
    with pytest.raises(LoweringError, match="shape"):
        subcell_cuda.row_sweep_call(lim, 0, s, hi[:, :, :, :, :1].contiguous(), hi, DT)
    with pytest.raises(LoweringError, match="contiguous"):
        subcell_cuda.row_sweep_call(lim, 0, s.transpose(4, 5), lo, hi, DT)


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


# ------------------------------------------------ K4: the generated spec kernel


def _fv_state(grid, dtype, dev, seed=0, n_vars=5):
    """``__graft_entry__._example_state``'s recipe on the SoA-P grid state
    ``[*extent, V, *grid]`` (one spatial axis per grid axis)."""
    dim = len(grid)
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.1, 1.0, size=(6,) * dim + (n_vars,) + grid)
    lead = (slice(None),) * dim
    q[lead + (0,)] += 1.0
    q[lead + (dim + 1,)] += 5.0
    return torch.from_numpy(q).to(dev, dtype).contiguous()


def _spec(name, grid, n_aux=0):
    from exahype_tpu_torch.models.fv import build_fv_rusanov_kernel
    from exahype_tpu_torch.models.rusanov import build_rusanov_kernel

    build = {"fv": build_fv_rusanov_kernel, "rusanov": build_rusanov_kernel}[name]
    return build(dim=len(grid), patch_size=4, halo_size=1, n_real=5, n_aux=n_aux,
                 n_patches=int(np.prod(grid)))


SPEC_CASES = [
    ("fv", torch.float64, (2, 2, 2), 0),
    ("rusanov", torch.float64, (2, 2, 2), 0),
    ("fv", torch.float64, (3, 1, 5), 0),  # ragged last tile (4 patches per block)
    ("fv", torch.float32, (8, 4, 33), 0),  # ragged last tile (8 patches per block)
    ("rusanov", torch.float32, (4, 4, 8), 0),
    # The reference's 2-D configuration: 10 variables, 5 of them evolved;
    # tiles of 32 patches, ragged.
    ("rusanov", torch.float64, (5, 7), 5),
    ("fv", torch.float32, (9, 11), 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("spec,dtype,grid,n_aux", SPEC_CASES)
def test_spec_kernel_matches_plain(spec, dtype, grid, n_aux):
    from exahype_tpu_torch.backends.cuda_backend import CudaPrinter

    dev = _card()
    fn = CudaPrinter(_spec(spec, grid, n_aux)).build()
    q = _fv_state(grid, dtype, dev, n_vars=5 + n_aux)
    got = q.clone()
    assert fn(got, 0.05) is got  # in place
    by_pointer = fn(q.clone(), torch.tensor(0.05, dtype=dtype, device=dev))
    ref = fn.plain(q.clone(), 0.05)
    torch.cuda.synchronize()
    assert _err(got, ref) <= _bound(ref, dtype)
    assert torch.equal(got, by_pointer)
    assert fn.launches == 2


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
