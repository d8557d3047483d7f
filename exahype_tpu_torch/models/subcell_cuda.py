"""The limiter's gathered-row subcell sweep through a hand-written CUDA
kernel (Hopper, ``sm_90a``).

Port of ``exahype_tpu/models/subcell_pallas.py::row_sweep_call``: one
directional Rusanov sweep of the (2N+1)^dim subcell FV fallback over the
gathered row batch ``[n_sub, n_sub, n_sub, V, K, L]``, one launch per
direction, kernel ``subcell_row_sweep`` of ``csrc/subcell.cu`` (see the note
there for the design).  Unlike the Pallas kernel it sweeps only the active
slots, the prefix ``k < n_active`` of the slot axis, and updates ``s`` in
place (see :func:`row_sweep_call`).  Its plain version is
:meth:`LimitedADERDG._row_sweep_math`, which the wrapper takes for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises.  Launches
are counted in :data:`launches`.  The Pallas kernel's TPU knobs
(``subcell_vmem_limit_bytes``, ``subcell_interpret``) have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from exahype_tpu_torch import _build
from exahype_tpu_torch.utils.errors import LoweringError

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: Launches of ``subcell_row_sweep`` since import (or the last reset).
launches = {"subcell_row_sweep": 0}


def reset_launches():
    launches["subcell_row_sweep"] = 0


def _check(limiter, d, s, ghost_lo, ghost_hi, n_active):
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
    if not (isinstance(n_active, torch.Tensor) and n_active.numel() == 1
            and n_active.dtype == torch.int64 and n_active.device == s.device):
        raise LoweringError("n_active must be a one-element int64 tensor on s's device")
    return tag.gamma


def row_sweep_call(limiter, d: int, s, ghost_lo, ghost_hi, dt, n_active):
    """Direction ``d``'s sweep of the active slots, in place: returns
    ``(s, g_lo, g_hi)``.

    ``n_active`` is the count of active slots, a 0-d int64 tensor on ``s``'s
    device (``_gather_tables_row``'s ``"n_active"``), read by the kernel
    through its device pointer, so the launch adds no host
    synchronisation.  Slots ``< n_active`` of ``s`` take what
    :meth:`LimitedADERDG._row_sweep_math` gives them (f64 within 1e-12,
    f32 within 64 spacings of the largest value), and so do ``g_lo`` and
    ``g_hi`` there; slots ``>= n_active`` of ``s`` are left bitwise
    unchanged, and ``g_lo`` and ``g_hi`` are 0 there.  The ghosts are not
    modified.  ``dt`` is a float (by value) or a 0-d tensor (by device
    pointer).  On the CPU the plain version sweeps the active slots (there
    ``n_active`` may also be an int)."""
    sol = limiter.solver
    K, L = s.shape[-2], s.shape[-1]
    if not s.is_cuda:
        n = min(max(int(n_active), 0), K)
        g_lo = s.new_zeros((sol.n_vars, K, L))
        g_hi = torch.zeros_like(g_lo)
        if n > 0:
            new, lo, hi = limiter._row_sweep_math(
                s.narrow(-2, 0, n), ghost_lo.narrow(-2, 0, n), ghost_hi.narrow(-2, 0, n), d, dt)
            s.narrow(-2, 0, n).copy_(new)
            g_lo.narrow(-2, 0, n).copy_(lo)
            g_hi.narrow(-2, 0, n).copy_(hi)
        return s, g_lo, g_hi
    gamma = _check(limiter, d, s, ghost_lo, ghost_hi, n_active)
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
            s.data_ptr(), s.data_ptr(), ghost_lo.data_ptr(), ghost_hi.data_ptr(),
            g_lo.data_ptr(), g_hi.data_ptr(), dt_ptr, dt_val,
            sol._dxs[d] / limiter.n_sub, gamma, sol.dim, limiter.n_sub, sol.n_vars, d,
            n_active.data_ptr(), K, L, stream,
        )
    _build.check(lib, err, "subcell_row_sweep")
    launches["subcell_row_sweep"] += 1
    return s, g_lo, g_hi


def kernel_info(dtype, d: int = 0) -> dict:
    """How direction ``d``'s kernel launches in ``dtype`` on the current
    card: ``registers`` per thread, resident ``blocks_per_sm``, ``threads``
    per block, ``smem`` (static shared memory bytes a block), ``local``
    (spill) bytes per thread, and ``clusters``, the clusters of 7 blocks the
    card holds at once."""
    out = (ctypes.c_int * 6)()
    lib = _build.library()
    err = lib.exahype_subcell_kernel_info(int(dtype == torch.float64), d, out)
    _build.check(lib, err, "subcell kernel_info")
    return dict(zip(("registers", "blocks_per_sm", "threads", "smem", "local", "clusters"),
                    out))
