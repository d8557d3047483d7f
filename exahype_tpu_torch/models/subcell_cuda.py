"""The limiter's gathered-row subcell sweep through a hand-written CUDA
kernel (Hopper, ``sm_90a``).

Port of ``exahype_tpu/models/subcell_pallas.py::row_sweep_call``: one
directional Rusanov sweep of the (2N+1)^dim subcell FV fallback over the
gathered row batch ``[n_sub, n_sub, n_sub, V, K, L]``, one launch per
direction, kernel ``subcell_row_sweep`` of ``csrc/subcell.cu`` (see the note
there for the design).  Its plain version is
:meth:`LimitedADERDG._row_sweep_math`, which the wrapper takes for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises.  Launches
are counted in :data:`launches`.  The Pallas kernel's TPU knobs
(``subcell_vmem_limit_bytes``, ``subcell_interpret``) have no counterpart.
"""

from __future__ import annotations

import torch

from exahype_tpu_torch import _build
from exahype_tpu_torch.utils.errors import LoweringError

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: Launches of ``subcell_row_sweep`` since import (or the last reset).
launches = {"subcell_row_sweep": 0}


def reset_launches():
    launches["subcell_row_sweep"] = 0


def _check(limiter, d, s, ghost_lo, ghost_hi):
    sol = limiter.solver
    if (sol.dim, limiter.n_sub, sol.n_vars) != (3, 7, 5):
        raise LoweringError(
            "the subcell sweep kernel is instantiated for dim=3, n_sub=7 (order "
            f"3) and the 5 Euler variables only, got dim={sol.dim}, "
            f"n_sub={limiter.n_sub}, n_vars={sol.n_vars}"
        )
    if not (0 <= d < sol.dim):
        raise LoweringError(f"direction {d} out of range")
    tags = {getattr(f, "physics", None) for f in (sol.flux_fn, sol.max_eigenvalue_fn)}
    tag = tags.pop() if len(tags) == 1 else None
    if tag is None or tag.name != "euler":
        raise LoweringError(
            "the subcell sweep kernel compiles in Euler physics: build the "
            "solver with exahype_tpu_torch.models.aderdg.euler_physics"
        )
    if s.dtype not in _SUFFIX:
        raise LoweringError(f"s: dtype {s.dtype} not float32/float64")
    n = limiter.n_sub
    if s.dim() != 6 or tuple(s.shape[:4]) != (n, n, n, sol.n_vars):
        raise LoweringError(f"s: shape {tuple(s.shape)} is not [7, 7, 7, 5, K, L]")
    ghost_shape = list(s.shape)
    ghost_shape[d] = 1
    for name, x in (("s", s), ("ghost_lo", ghost_lo), ("ghost_hi", ghost_hi)):
        if x.dtype != s.dtype or x.device != s.device:
            raise LoweringError(f"{name} must match s's dtype and device")
        if x is not s and list(x.shape) != ghost_shape:
            raise LoweringError(f"{name}: shape {tuple(x.shape)} != {tuple(ghost_shape)}")
        if not x.is_contiguous():
            raise LoweringError(f"{name} must be contiguous")
    return tag.gamma


def row_sweep_call(limiter, d: int, s, ghost_lo, ghost_hi, dt):
    """Direction ``d``'s sweep: ``(s_new, g_lo, g_hi)`` exactly as
    :meth:`LimitedADERDG._row_sweep_math` returns them.  ``s`` and the
    ghosts are not modified.  ``dt`` is a float (by value) or a 0-d tensor
    (by device pointer)."""
    if not s.is_cuda:
        return limiter._row_sweep_math(s, ghost_lo, ghost_hi, d, dt)
    gamma = _check(limiter, d, s, ghost_lo, ghost_hi)
    sol = limiter.solver
    K, L = s.shape[4], s.shape[5]
    s_new = torch.empty_like(s)
    g_lo = torch.empty((sol.n_vars, K, L), dtype=s.dtype, device=s.device)
    g_hi = torch.empty_like(g_lo)
    dt_ptr, dt_val = None, 0.0
    if isinstance(dt, torch.Tensor):
        if dt.numel() != 1:
            raise LoweringError("dt must be a scalar")
        dt = dt.to(device=s.device, dtype=s.dtype).reshape(())
        dt_ptr = dt.data_ptr()
    else:
        dt_val = float(dt)
    lib = _build.library()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = getattr(lib, f"exahype_subcell_row_sweep_{_SUFFIX[s.dtype]}")(
            s.data_ptr(), ghost_lo.data_ptr(), ghost_hi.data_ptr(), s_new.data_ptr(),
            g_lo.data_ptr(), g_hi.data_ptr(), dt_ptr, dt_val,
            sol._dxs[d] / limiter.n_sub, gamma, sol.dim, limiter.n_sub, sol.n_vars, d,
            K * L, stream,
        )
    _build.check(lib, err, "subcell_row_sweep")
    launches["subcell_row_sweep"] += 1
    return s_new, g_lo, g_hi
