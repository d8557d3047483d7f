"""ADER-DG step through hand-written CUDA kernels (Hopper, ``sm_90a``).

Port of ``exahype_tpu/models/aderdg_pallas.py::PallasADERDG`` on the
periodic, flux-form Picard path of 3-D Euler at order 3.  The step is two
kernels from ``csrc/aderdg.cu`` (see the note there for the design):

- ``aderdg_predictor_volume``: predictor, time averages, volume integral
  and the face projections of every axis;
- ``aderdg_face_surface``: the Rusanov flux of each cell's two faces per
  axis and the surface update of ``new``, in place (on the CPU too).

Each wrapper takes its plain PyTorch version
(``ADERDGSolver.predictor_volume`` / ``face_surface``) for a tensor on the
CPU, and launches its kernel — or raises — for a CUDA tensor.  It counts its
launches in :attr:`CudaADERDG.launches`.  The Pallas kernel's TPU knobs
(``tile0``, ``vmem_limit_bytes``, ``boundary_faces_only``, ``picard_loop``,
``slice_loop``, ``interpret``) have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from exahype_tpu_torch import _build
from exahype_tpu_torch.models.aderdg import ADERDGSolver
from exahype_tpu_torch.utils.errors import LoweringError

#: (dim, order) pairs the kernels are instantiated for.
INSTANTIATED = ((3, 3),)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class CudaADERDG:
    """Solver protocol (``step``, ``run``, ``cfl_dt``, ``total_mass``,
    ``dofs``) over an :class:`ADERDGSolver`, with the step on CUDA kernels.
    """

    KERNELS = ("aderdg_predictor_volume", "aderdg_face_surface")

    def __init__(self, solver: ADERDGSolver):
        tags = {
            getattr(solver.flux_fn, "physics", None),
            getattr(solver.max_eigenvalue_fn, "physics", None),
        }
        tag = tags.pop() if len(tags) == 1 else None
        if tag is None or tag.name != "euler" or tag.dim != solver.dim:
            raise LoweringError(
                "the CUDA kernels compile in Euler physics: build the solver "
                "with exahype_tpu_torch.models.aderdg.euler_physics"
            )
        if tag.n_real != solver.n_vars or solver.n_vars != solver.dim + 2:
            raise LoweringError(
                f"the CUDA kernels take the {solver.dim + 2} Euler variables "
                f"only, got n_vars={solver.n_vars}"
            )
        if (solver.dim, solver.order) not in INSTANTIATED:
            raise LoweringError(
                f"no CUDA kernel instantiated for dim={solver.dim}, "
                f"order={solver.order} (have {INSTANTIATED})"
            )
        self.solver = solver
        self.gamma = tag.gamma
        #: Launches per kernel since construction (or the last reset).
        self.launches = {name: 0 for name in self.KERNELS}
        ops = solver.ops
        self._ops = np.ascontiguousarray(np.concatenate([
            ops.D.ravel(), ops.K1inv.ravel(), ops.Kvol.ravel(), ops.weights,
            ops.phi0, ops.phi1, ops.phi0 / ops.weights, ops.phi1 / ops.weights,
        ]), dtype=np.float64)
        self._dx = np.ascontiguousarray(solver._dxs, dtype=np.float64)

    # ---------------------------------------------------------------- checks

    def _check(self, x, shape, name):
        if x.dtype not in _SUFFIX:
            raise LoweringError(f"{name}: dtype {x.dtype} not float32/float64")
        if tuple(x.shape) != tuple(shape):
            raise LoweringError(f"{name}: shape {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise LoweringError(f"{name}: must be contiguous")

    def _dt_args(self, dt, like):
        """``(tensor, pointer, value)`` for the kernels' dt: a Python float
        goes by value, a tensor stays on the device and goes by pointer (the
        caller holds the tensor until the launch is enqueued)."""
        if isinstance(dt, torch.Tensor):
            if dt.numel() != 1:
                raise LoweringError("dt must be a scalar")
            dt = dt.to(device=like.device, dtype=like.dtype).reshape(())
            return dt, dt.data_ptr(), 0.0
        return None, None, float(dt)

    # --------------------------------------------------------------- kernels

    def predictor_volume(self, u, dt):
        """``(new, faces)`` of the cell-local half of the step.  ``u`` is
        not modified."""
        if not u.is_cuda:
            return self.solver.predictor_volume(u, dt)
        sol = self.solver
        self._check(u, sol.state_shape, "u")
        new = torch.empty_like(u)
        faces = torch.empty(sol.face_shape, dtype=u.dtype, device=u.device)
        dt_dev, dt_ptr, dt_val = self._dt_args(dt, u)
        lib = _build.library()
        with torch.cuda.device(u.device):
            stream = torch.cuda.current_stream(u.device).cuda_stream
            err = getattr(lib, f"exahype_aderdg_predictor_volume_{_SUFFIX[u.dtype]}")(
                u.data_ptr(), new.data_ptr(), faces.data_ptr(), dt_ptr, dt_val,
                self._ops.ctypes.data, self._dx.ctypes.data, sol.order,
                sol.picard_iters, self.gamma, *sol.grid_shape, stream,
            )
        _build.check(lib, err, "aderdg_predictor_volume")
        self.launches["aderdg_predictor_volume"] += 1
        return new, faces

    def face_surface(self, new, faces, dt):
        """Surface update of ``new`` from ``faces``, in place on either
        device; returns ``new``."""
        if not new.is_cuda:
            return new.copy_(self.solver.face_surface(new, faces, dt))
        sol = self.solver
        self._check(new, sol.state_shape, "new")
        self._check(faces, sol.face_shape, "faces")
        if faces.dtype != new.dtype or faces.device != new.device:
            raise LoweringError("faces must match new's dtype and device")
        dt_dev, dt_ptr, dt_val = self._dt_args(dt, new)
        lib = _build.library()
        with torch.cuda.device(new.device):
            stream = torch.cuda.current_stream(new.device).cuda_stream
            err = getattr(lib, f"exahype_aderdg_face_surface_{_SUFFIX[new.dtype]}")(
                new.data_ptr(), faces.data_ptr(), dt_ptr, dt_val,
                self._ops.ctypes.data, self._dx.ctypes.data, sol.order,
                self.gamma, *sol.grid_shape, stream,
            )
        _build.check(lib, err, "aderdg_face_surface")
        self.launches["aderdg_face_surface"] += 1
        return new

    # ------------------------------------------------------- solver protocol

    def step(self, u, dt):
        """One step; a fresh tensor (``u`` is not modified)."""
        if not u.is_cuda:
            return self.solver.step(u, dt)
        new, faces = self.predictor_volume(u, dt)
        return self.face_surface(new, faces, dt)

    def run(self, u, n_steps: int, dt):
        for _ in range(n_steps):
            u = self.step(u, dt)
        return u

    def reset_launches(self):
        for name in self.launches:
            self.launches[name] = 0

    def dofs(self) -> int:
        return self.solver.dofs()

    def cfl_dt(self, u, cfl: float | None = None):
        return self.solver.cfl_dt(u, cfl=cfl)

    def total_mass(self, u):
        return self.solver.total_mass(u)
