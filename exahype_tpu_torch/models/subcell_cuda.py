"""The limiter's gathered-row subcell sweep through hand-written CUDA
kernels (Hopper, ``sm_90a``).

Port of ``exahype_tpu/models/subcell_pallas.py::row_sweep_call``: one
directional Rusanov sweep of the (2N+1)^dim subcell FV fallback over the
gathered row batch ``[n_sub, n_sub, n_sub, V, K, L]``, one launch per
direction.  Two instances, dispatched by (dim, n_sub, physics):

- ``(3, 7, "euler")``: 3-D p3 Euler, kernel ``subcell_row_sweep`` of
  ``csrc/subcell.cu`` (a pencil a thread in registers);
- ``(3, 5, "z4_matter")``: 3-D p2 Z4+GRHD, 43 variables, with the NCP
  half-fluctuations of every face, kernel ``subcell_row_sweep_z4_matter``
  of ``csrc/subcell_ncp.cuh`` (built by ``csrc/subcell_z4_matter.cu`` and
  ``_f64.cu``; the pencil's face terms staged in shared memory).

Any other solver raises ``LoweringError`` naming ROADMAP.md, Queue 2 K3 a
(NCP or dissipation-masked physics, e.g. the masked CK elasticity or
Z4+GRMHD) or K3 b (other (dim, order, physics)).  Unlike the Pallas kernel
the sweeps take only the active slots, the prefix ``k < n_active`` of the
slot axis, and update ``s`` in place (see :func:`row_sweep_call`).  Their
plain version is :meth:`LimitedADERDG._row_sweep_math`, which the wrapper
takes for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.  Launches are counted in :data:`launches`, by kernel.  The Pallas
kernel's TPU knobs (``subcell_vmem_limit_bytes``, ``subcell_interpret``)
have no counterpart.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from exahype_tpu_torch import _build
from exahype_tpu_torch.utils.errors import LoweringError

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: (dim, n_sub, physics) -> the kernel of that instance.
KERNELS = {
    (3, 7, "euler"): "subcell_row_sweep",
    (3, 5, "z4_matter"): "subcell_row_sweep_z4_matter",
}
#: Launches of each kernel since import (or the last reset).
launches = {name: 0 for name in KERNELS.values()}


def reset_launches():
    for name in launches:
        launches[name] = 0


def _tag(sol):
    tags = {getattr(f, "physics", None) for f in (sol.flux_fn, sol.max_eigenvalue_fn)}
    return tags.pop() if len(tags) == 1 else None


def check_physics(limiter) -> str:
    """The kernel that sweeps ``limiter``'s solver, or ``LoweringError``:
    the instances are :data:`KERNELS`; the Euler one takes no NCP and no
    dissipation mask (a source stays outside every sweep)."""
    sol = limiter.solver
    tag = _tag(sol)
    name = None if tag is None else tag.name
    key = (sol.dim, limiter.n_sub, name)
    ncp = sol.ncp_fn is not None or sol.dissipation_mask is not None
    if key in KERNELS and not (name == "euler" and ncp):
        return KERNELS[key]
    item = "a" if ncp or name in ("z4_matter", "z4_grmhd") else "b"
    raise LoweringError(
        f"the subcell sweep kernels take (dim, n_sub, physics) in "
        f"{sorted(KERNELS)} (the Euler one with no NCP and no dissipation mask), got "
        f"dim={sol.dim}, n_sub={limiter.n_sub}, physics={name!r}"
        f"{', an NCP' if sol.ncp_fn is not None else ''}"
        f"{', a dissipation mask' if sol.dissipation_mask is not None else ''}; see "
        f"ROADMAP.md, Queue 2 K3 {item} (or run the plain sweeps: subcell_cuda=False)"
    )


def _check(limiter, d, s, ghost_lo, ghost_hi, n_active) -> str:
    sol = limiter.solver
    kernel = check_physics(limiter)
    if not (0 <= d < sol.dim):
        raise LoweringError(f"direction {d} out of range")
    if s.dtype not in _SUFFIX:
        raise LoweringError(f"s: dtype {s.dtype} not float32/float64")
    n = limiter.n_sub
    if s.dim() != 6 or tuple(s.shape[:4]) != (n, n, n, sol.n_vars):
        raise LoweringError(
            f"s: shape {tuple(s.shape)} is not [{n}, {n}, {n}, {sol.n_vars}, K, L]")
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
    return kernel


def _params(sol) -> np.ndarray:
    """The Z4+GRHD kernel's parameters, as ``CudaADERDG`` gives its own:
    (slicing id, f, m, κ₁, κ₂, Γ, Newton iterations), float64."""
    from exahype_tpu_torch.models.aderdg_cuda import _kernel_params

    return np.ascontiguousarray(_kernel_params(_tag(sol), sol), dtype=np.float64)


def row_sweep_call(limiter, d: int, s, ghost_lo, ghost_hi, dt, n_active):
    """Direction ``d``'s sweep of the active slots, in place: returns
    ``(s, g_lo, g_hi)``.

    ``n_active`` is the count of active slots, a 0-d int64 tensor on ``s``'s
    device (``_gather_tables_row``'s ``"n_active"``), read by the kernel
    through its device pointer, so the launch adds no host
    synchronisation.  Slots ``< n_active`` of ``s`` take what
    :meth:`LimitedADERDG._row_sweep_math` gives them (f64 within 1e-12,
    the Z4+GRHD instance within 1e-12·max(1, max|plain|); f32 within 64
    spacings of the largest value), and so do ``g_lo`` and ``g_hi`` there;
    slots ``>= n_active`` of ``s`` are left bitwise unchanged, and ``g_lo``
    and ``g_hi`` are 0 there.  The ghosts are not modified.  ``dt`` is a
    float (by value) or a 0-d tensor (by device pointer).  On the CPU the
    plain version sweeps the active slots (there ``n_active`` may also be
    an int)."""
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
    kernel = _check(limiter, d, s, ghost_lo, ghost_hi, n_active)
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
    if kernel == "subcell_row_sweep":
        physics = (_tag(sol).gamma,)
    else:
        params = _params(sol)
        physics = (params.ctypes.data,)
    lib = _build.library()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = getattr(lib, f"exahype_{kernel}_{_SUFFIX[s.dtype]}")(
            s.data_ptr(), s.data_ptr(), ghost_lo.data_ptr(), ghost_hi.data_ptr(),
            g_lo.data_ptr(), g_hi.data_ptr(), dt_ptr, dt_val,
            sol._dxs[d] / limiter.n_sub, *physics, sol.dim, limiter.n_sub, sol.n_vars, d,
            n_active.data_ptr(), K, L, stream,
        )
    _build.check(lib, err, kernel)
    launches[kernel] += 1
    return s, g_lo, g_hi


def kernel_info(dtype, d: int = 0, physics: str = "euler") -> dict:
    """How direction ``d``'s kernel of ``physics`` (``"euler"`` or
    ``"z4_matter"``) launches in ``dtype`` on the current card:
    ``registers`` per thread, resident ``blocks_per_sm``, ``threads`` per
    block, ``smem`` (shared memory bytes a block), ``local`` (spill) bytes
    per thread, and ``clusters``, the clusters of 7 blocks the card holds
    at once (the Euler kernel's; 0 for the other, which has none)."""
    out = (ctypes.c_int * 6)()
    lib = _build.library()
    fn = {"euler": lib.exahype_subcell_kernel_info,
          "z4_matter": lib.exahype_subcell_z4_matter_kernel_info}[physics]
    err = fn(int(dtype == torch.float64), d, out)
    _build.check(lib, err, f"subcell kernel_info ({physics})")
    return dict(zip(("registers", "blocks_per_sm", "threads", "smem", "local", "clusters"),
                    out))
