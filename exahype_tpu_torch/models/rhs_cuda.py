"""The fused Z4 right-hand side through a hand-written CUDA kernel (K5).

Port of ``exahype_tpu/models/rhs_pallas.py`` (``PallasRHS``,
``with_pallas_rhs``) for its Z4 instances: the solver's
``rhs_all_fn(Q, grads, var_axis)`` — the pointwise algebra
S(Q) − Σ_d B_d(Q)·∂_d Q given Q and the three physical gradients, which the
Picard predictor calls once per iteration and the corrector twice — runs as
kernel ``rhs_all_z4`` (38 variables, algebra ``csrc/z4.cuh``),
``rhs_all_z4_shift`` (the 53-variable shifted system, ``csrc/z4_shift.cuh``),
``rhs_all_z4_matter`` (K5 d: the 43-variable coupled Z4+GRHD system,
``csrc/z4_matter.cuh``, its con2prim Newton in the kernel) or
``rhs_all_z4_grmhd`` (K5 e: the 47-variable coupled Z4+GRMHD system,
``csrc/z4_grmhd.cuh``, its field-aligned con2prim Newton in the kernel) of
``csrc/rhs.cu`` (see the note there for the design); on a 2-D grid each
system's instance with ``_2d`` (K5 b: ``rhs_all_z4_2d``,
``rhs_all_z4_shift_2d``, ``rhs_all_z4_matter_2d`` and
``rhs_all_z4_grmhd_2d``, two gradient arrays, the third axis's derivatives
zero as the plain version zero-fills them).

:class:`CudaRHS` wraps a tagged Z4 ``rhs_all_fn`` (``make_z4_solver(...,
impl="soa", fused_rhs="soa")`` or ``make_z4_shift_solver(...,
fused_rhs="soa")`` or ``models/z4_matter.py::make_z4_matter_solver(...,
fused_rhs="soa")`` or ``models/z4_grmhd.py::make_z4_grmhd_solver(...,
fused_rhs="soa")``).  For tensors on the CPU it calls the wrapped
plain version; for CUDA tensors it launches the kernel or raises
:class:`LoweringError`.  On both devices it checks every gradient's shape,
dtype and device against Q's (the Pallas wrapper reshapes them silently).
The kernel reads contiguous ``[B, V, G]`` tensors (everything before the
variable axis, the variables, everything after): the solver hands them over
contiguous (``ADERDGSolver._grads``), and the wrapper refuses any other.
The Pallas kernel's TPU knobs (``rows_per_block``, ``vmem_limit_bytes``,
``interpret``) have no counterpart.  Usage::

    solver = make_z4_solver(3, 2, grid, dx, impl="soa", fused_rhs="soa")
    solver = with_cuda_rhs(solver)        # a copy; rhs_all_fn now K5
    u = solver.step(u, dt)                # solver.rhs_all_fn.launches
"""

from __future__ import annotations

import copy
import math

import torch

from exahype_tpu_torch import _build
from exahype_tpu_torch.models.z4 import N_VARS, N_VARS_SHIFT, SHIFTS, SLICINGS
from exahype_tpu_torch.models.z4_grmhd import N_VARS as N_VARS_GRMHD
from exahype_tpu_torch.models.z4_matter import N_VARS as N_VARS_MATTER
from exahype_tpu_torch.utils.errors import LoweringError

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class CudaRHS:
    """``rhs_all_fn(Q, grads, var_axis)`` through K5 for CUDA tensors.

    Built for one solver's ``dim`` and ``n_vars``; the wrapped function
    must carry the ``PhysicsTag("z4", 3, 38, (slicing, f, m, kappa1,
    kappa2))`` that :func:`~exahype_tpu_torch.models.z4.make_z4_solver`
    gives it, or the ``PhysicsTag("z4_shift", 3, 53, (..., shift, f_b,
    eta))`` of :func:`~exahype_tpu_torch.models.z4.make_z4_shift_solver`,
    or the ``PhysicsTag("z4_matter", 3, 43, (..., gamma, iters))`` of
    :func:`~exahype_tpu_torch.models.z4_matter.make_z4_matter_solver`, or
    the ``PhysicsTag("z4_grmhd", 3, 47, (..., gamma, iters, c_h,
    glm_kappa))`` of
    :func:`~exahype_tpu_torch.models.z4_grmhd.make_z4_grmhd_solver`; its
    parameters become the kernel's arguments.  :attr:`kernel` names the
    instance, ``launches`` counts its launches."""

    #: The instance of each system: (kernel, variables).  At ``dim = 2``
    #: each system's is the same name with ``_2d`` (K5 b), two gradient
    #: arrays.
    INSTANCES = {
        "z4": ("rhs_all_z4", N_VARS),
        "z4_shift": ("rhs_all_z4_shift", N_VARS_SHIFT),
        "z4_matter": ("rhs_all_z4_matter", N_VARS_MATTER),
        "z4_grmhd": ("rhs_all_z4_grmhd", N_VARS_GRMHD),
    }

    def __init__(self, rhs_all_fn, dim: int, n_vars: int):
        tag = getattr(rhs_all_fn, "physics", None)
        if tag is None or tag.name not in self.INSTANCES or (
                tag.n_real != self.INSTANCES[tag.name][1]):
            raise LoweringError(
                "K5 is compiled for the 38-variable vacuum Z4 right-hand side, the "
                "53-variable shifted one, the 43-variable Z4+GRHD one and the 47-variable "
                "Z4+GRMHD one: build the solver with exahype_tpu_torch.models.z4."
                "make_z4_solver, make_z4_shift_solver, models.z4_matter.make_z4_matter_solver "
                "or models.z4_grmhd.make_z4_grmhd_solver(..., impl='soa', fused_rhs='soa'); "
                f"got an rhs_all_fn tagged {tag!r}"
            )
        self.kernel, vars_ = self.INSTANCES[tag.name]
        if dim == 2 and n_vars == vars_:
            self.kernel += "_2d"  # K5 b
        elif dim != 3 or n_vars != vars_:
            raise LoweringError(
                f"K5 takes 3 gradient arrays of the {vars_} {tag.name} variables, got "
                f"dim={dim}, n_vars={n_vars} (2 arrays at dim=2)"
            )
        slicing, f, m, kappa1, kappa2, *rest = tag.params
        self.inner = rhs_all_fn
        self.dim = dim
        self.n_vars = n_vars
        self._args = (SLICINGS[slicing], f, m, kappa1, kappa2)
        if tag.name == "z4_shift":
            mode, f_b, eta = rest
            self._args += (SHIFTS[mode], f_b, eta)
        elif tag.name == "z4_matter":
            gamma, iters = rest
            self._args += (gamma, iters)
        elif tag.name == "z4_grmhd":
            gamma, iters, c_h, glm_kappa = rest
            self._args += (gamma, iters, c_h, glm_kappa)
        #: Launches of :attr:`kernel` since construction (or the last reset).
        self.launches = 0

    def reset_launches(self):
        self.launches = 0

    def _check(self, Q, grads, va):
        if len(grads) != self.dim:
            raise LoweringError(f"expected {self.dim} gradient arrays, got {len(grads)}")
        if Q.shape[va] != self.n_vars:
            raise LoweringError(
                f"var axis {va} of Q's shape {tuple(Q.shape)} is not n_vars={self.n_vars}"
            )
        for e, gq in enumerate(grads):
            if gq.shape != Q.shape or gq.dtype != Q.dtype or gq.device != Q.device:
                raise LoweringError(
                    f"grads[{e}] is {tuple(gq.shape)} {gq.dtype} on {gq.device}; it must "
                    f"match Q: {tuple(Q.shape)} {Q.dtype} on {Q.device}"
                )

    def __call__(self, Q, grads, var_axis):
        grads = tuple(grads)
        va = var_axis % Q.dim()
        self._check(Q, grads, va)
        if not Q.is_cuda:
            return self.inner(Q, grads, var_axis)
        if Q.dtype not in _SUFFIX:
            raise LoweringError(f"Q: dtype {Q.dtype} not float32/float64")
        for name, x in (("Q", Q), *((f"grads[{e}]", g) for e, g in enumerate(grads))):
            if not x.is_contiguous():
                raise LoweringError(f"{name} must be contiguous")
        out = torch.empty_like(Q)
        lib = _build.library()
        with torch.cuda.device(Q.device):
            stream = torch.cuda.current_stream(Q.device).cuda_stream
            err = getattr(lib, f"exahype_{self.kernel}_{_SUFFIX[Q.dtype]}")(
                Q.data_ptr(), *(g.data_ptr() for g in grads), out.data_ptr(),
                math.prod(Q.shape[:va]), self.n_vars, math.prod(Q.shape[va + 1:]),
                *self._args, stream,
            )
        _build.check(lib, err, self.kernel)
        self.launches += 1
        return out


def with_cuda_rhs(solver):
    """A copy of ``solver`` whose ``rhs_all_fn`` runs through K5
    (:class:`CudaRHS`); it shares the solver's operator buffers.  The solver
    must carry a fused Z4 hook (``make_z4_solver``, ``make_z4_shift_solver``,
    ``make_z4_matter_solver`` or ``make_z4_grmhd_solver(...,
    fused_rhs="soa")``)."""
    if solver.rhs_all_fn is None:
        raise LoweringError(
            "with_cuda_rhs requires a solver with rhs_all_fn set "
            "(make_z4_solver, make_z4_shift_solver, make_z4_matter_solver or "
            "make_z4_grmhd_solver(..., impl='soa', fused_rhs='soa'))"
        )
    out = copy.copy(solver)
    out.rhs_all_fn = CudaRHS(solver.rhs_all_fn, solver.dim, solver.n_vars)
    return out
