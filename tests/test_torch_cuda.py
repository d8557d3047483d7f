"""The CUDA kernels against their plain PyTorch versions, on the card: the
two ADER-DG kernels of ``csrc/aderdg.cu`` and the spec kernel (K4) that
``CudaPrinter`` generates, alone and under ``GridSolver``.

Every test here is marked ``cuda`` and skips without a card (the decision
is made inside each test, never at import).  This file imports no JAX, so
it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f64 at rtol=0, atol=1e-12; f32 at 64 float32 spacings (2⁻²³
relative) of the largest compared value — two f32 evaluation orders of a
computation a few hundred operations deep, fused multiply-adds on the
card's side only (``chip_smoke.py`` states the same bound).
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


def _setup(grid, dtype):
    dev = _card()
    flux, eig = euler_physics(3)
    sol = ADERDGSolver(3, 3, 5, grid, flux, eig, dx=DX, device=dev, dtype=dtype)
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
    assert cu.launches["aderdg_face_surface"] == 1


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
    assert cu.launches == {"aderdg_predictor_volume": 8, "aderdg_face_surface": 8}


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
