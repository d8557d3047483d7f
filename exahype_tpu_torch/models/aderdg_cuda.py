"""ADER-DG step through hand-written CUDA kernels (Hopper, ``sm_90a``).

Port of ``exahype_tpu/models/aderdg_pallas.py::PallasADERDG`` on the
periodic, flux-form path at order 3 in 3-D, for two physics: compressible
Euler on the Picard predictor (``bench.py::main``) and heterogeneous
elasticity on the Cauchy–Kovalewski predictor with its materials frozen
(``bench.py::bench_ck``).  The step is three launches of kernels from
``csrc/aderdg.cu`` (see the note there for the design):

- ``aderdg_predictor_volume`` (Picard) or ``aderdg_ck_predictor_volume``
  (CK): predictor, time averages, volume integral and the face projections
  of every axis;
- the face stage, two launches: ``aderdg_face_flux`` solves every interface
  once (the Rusanov flux, with the physics' dissipation mask) into a
  face-flux tensor, each cell's high-face fluxes of every axis, which is
  also the limiter's input (the Pallas kernel's ``emit_fused_fhat``
  outputs); ``aderdg_surface_update`` then updates ``new`` in place (on the
  CPU too) from each cell's own and its lower neighbours' entries.

Each wrapper takes its plain PyTorch version
(``ADERDGSolver.predictor_volume`` / ``face_surface``) for a tensor on the
CPU, and launches its kernels — or raises — for a CUDA tensor.  It counts
each kernel's launches in :attr:`CudaADERDG.launches`.  The Pallas kernel's TPU knobs
(``tile0``, ``vmem_limit_bytes``, ``boundary_faces_only``, ``picard_loop``,
``slice_loop``, ``interpret``) have no counterpart here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from exahype_tpu_torch import _build
from exahype_tpu_torch.models import elastic
from exahype_tpu_torch.models.aderdg import CALLBACK_OPTIONS, ADERDGSolver
from exahype_tpu_torch.utils.errors import LoweringError

#: (physics, dim, order) -> the predictor mode the kernels are instantiated
#: for with that physics.
INSTANTIATED = {
    ("euler", 3, 3): "picard",
    ("elastic3d_het", 3, 3): "ck",
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _n_vars(name: str, dim: int) -> int:
    return dim + 2 if name == "euler" else elastic.N_VARS_3D_HET


#: What each physics compiles into the kernels: its id in the C interface,
#: and the CK material slots and dissipation mask a solver must carry.
_PHYSICS = {
    "euler": {"id": 0, "ck_material_slots": None, "dissipation_mask": None},
    "elastic3d_het": {
        "id": 1,
        "ck_material_slots": elastic.MATERIAL_SLOTS,
        "dissipation_mask": elastic.DISSIPATION_MASK,
    },
}


class CudaADERDG:
    """Solver protocol (``step``, ``run``, ``cfl_dt``, ``total_mass``,
    ``dofs``) over an :class:`ADERDGSolver`, with the step on CUDA kernels.
    """

    KERNELS = (
        "aderdg_predictor_volume", "aderdg_ck_predictor_volume", "aderdg_face_flux",
        "aderdg_surface_update",
    )

    def __init__(self, solver: ADERDGSolver):
        for option in CALLBACK_OPTIONS:
            if getattr(solver, option) is not None:
                raise LoweringError(
                    f"the CUDA step kernels take flux-form physics only, and "
                    f"{option} is set (a fused rhs_all_fn runs on the card "
                    "through models.rhs_cuda.with_cuda_rhs)"
                )
        tags = {
            getattr(solver.flux_fn, "physics", None),
            getattr(solver.max_eigenvalue_fn, "physics", None),
        }
        tag = tags.pop() if len(tags) == 1 else None
        if tag is None or tag.name not in _PHYSICS or tag.dim != solver.dim:
            raise LoweringError(
                "the CUDA kernels compile in Euler or heterogeneous-elastic "
                "physics: build the solver with exahype_tpu_torch.models."
                "aderdg.euler_physics or models.elastic.elastic3d_heterogeneous"
            )
        n_vars = _n_vars(tag.name, solver.dim)
        if tag.n_real != solver.n_vars or solver.n_vars != n_vars:
            raise LoweringError(
                f"the CUDA kernels take the {n_vars} {tag.name} variables "
                f"only, got n_vars={solver.n_vars}"
            )
        key = (tag.name, solver.dim, solver.order)
        if key not in INSTANTIATED:
            raise LoweringError(
                f"no CUDA kernel instantiated for {tag.name}, dim={solver.dim}, "
                f"order={solver.order} (have {sorted(INSTANTIATED)})"
            )
        mode = INSTANTIATED[key]
        if solver.predictor_mode != mode:
            raise LoweringError(
                f"the {tag.name} kernels are instantiated for predictor_mode="
                f"{mode!r}, got {solver.predictor_mode!r}"
            )
        physics = _PHYSICS[tag.name]
        for option in ("ck_material_slots", "dissipation_mask"):
            if getattr(solver, option) != physics[option]:
                raise LoweringError(
                    f"the {tag.name} kernels compile in {option}="
                    f"{physics[option]!r}, got {getattr(solver, option)!r}"
                )
        self.solver = solver
        self._physics_id = physics["id"]
        # The rows whose face flux can be nonzero: all but the frozen
        # materials, the last rows (the kernels' Phys::kFluxRows).
        self._flux_rows = min(physics["ck_material_slots"] or (n_vars,))
        self._params = np.ascontiguousarray(tag.params or (0.0,), dtype=np.float64)
        #: The kernels of this solver's step: its predictor and the face stage.
        self.kernels = (
            "aderdg_ck_predictor_volume" if mode == "ck" else "aderdg_predictor_volume",
            "aderdg_face_flux", "aderdg_surface_update",
        )
        #: Launches per kernel since construction (or the last reset).
        self.launches = {name: 0 for name in self.kernels}
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
        name = self.kernels[0]
        # The Picard launcher takes the iteration count; the CK one has none.
        iters = () if name == "aderdg_ck_predictor_volume" else (sol.picard_iters,)
        lib = _build.library()
        with torch.cuda.device(u.device):
            stream = torch.cuda.current_stream(u.device).cuda_stream
            err = getattr(lib, f"exahype_{name}_{_SUFFIX[u.dtype]}")(
                u.data_ptr(), new.data_ptr(), faces.data_ptr(), dt_ptr, dt_val,
                self._ops.ctypes.data, self._dx.ctypes.data, sol.order, *iters,
                self._physics_id, self._params.ctypes.data, *sol.grid_shape, stream,
            )
        _build.check(lib, err, name)
        self.launches[name] += 1
        return new, faces

    def face_surface(self, new, faces, dt, return_face_fluxes: bool = False):
        """Surface update of ``new`` from ``faces``, in place on either
        device; returns ``new``, and with ``return_face_fluxes`` also the
        per-axis high-face fluxes (``solver.face_flux_shape`` each)."""
        sol = self.solver
        if not new.is_cuda:
            out = sol.face_surface(new, faces, dt, return_face_fluxes)
            if return_face_fluxes:
                return new.copy_(out[0]), out[1]
            return new.copy_(out)
        fhat = self.face_flux(faces)
        self.surface_update(new, fhat, dt)
        if return_face_fluxes:
            fhat[:, :, self._flux_rows:].zero_()  # the unwritten rows; none for Euler
            return new, [fhat[d].view(sol.face_flux_shape) for d in range(sol.dim)]
        return new

    def face_flux(self, faces):
        """The face stage's first launch (CUDA tensors only): every
        interface's Rusanov flux, ``[dim, n^(dim-1), n_vars, *grid]``, each
        cell's high-face fluxes.  The rows that are zero by construction
        (the elasticity's frozen materials, from its first material slot
        on) are not written: :meth:`surface_update` never reads them, and
        :meth:`face_surface` zeroes them when it returns the fluxes."""
        sol = self.solver
        if not faces.is_cuda:
            raise LoweringError("face_flux launches a CUDA kernel: faces must be on the card")
        self._check(faces, sol.face_shape, "faces")
        fhat = torch.empty(
            (sol.dim, sol.n_nodes ** (sol.dim - 1), sol.n_vars) + sol.grid_shape,
            dtype=faces.dtype, device=faces.device,
        )
        lib = _build.library()
        with torch.cuda.device(faces.device):
            stream = torch.cuda.current_stream(faces.device).cuda_stream
            err = getattr(lib, f"exahype_aderdg_face_flux_{_SUFFIX[faces.dtype]}")(
                faces.data_ptr(), fhat.data_ptr(), self._ops.ctypes.data,
                self._dx.ctypes.data, sol.order, self._physics_id,
                self._params.ctypes.data, *sol.grid_shape, stream,
            )
        _build.check(lib, err, "aderdg_face_flux")
        self.launches["aderdg_face_flux"] += 1
        return fhat

    def surface_update(self, new, fhat, dt):
        """The face stage's second launch (CUDA tensors only): the surface
        update of ``new`` from :meth:`face_flux`'s ``fhat``, in place;
        returns ``new``."""
        sol = self.solver
        if not new.is_cuda:
            raise LoweringError("surface_update launches a CUDA kernel: new must be on the card")
        self._check(new, sol.state_shape, "new")
        self._check(fhat, (sol.dim, sol.n_nodes ** (sol.dim - 1), sol.n_vars) + sol.grid_shape,
                    "fhat")
        if fhat.dtype != new.dtype or fhat.device != new.device:
            raise LoweringError("faces must match new's dtype and device")
        dt_dev, dt_ptr, dt_val = self._dt_args(dt, new)
        lib = _build.library()
        with torch.cuda.device(new.device):
            stream = torch.cuda.current_stream(new.device).cuda_stream
            err = getattr(lib, f"exahype_aderdg_surface_update_{_SUFFIX[new.dtype]}")(
                new.data_ptr(), fhat.data_ptr(), dt_ptr, dt_val, self._ops.ctypes.data,
                self._dx.ctypes.data, sol.order, self._physics_id,
                self._params.ctypes.data, *sol.grid_shape, stream,
            )
        _build.check(lib, err, "aderdg_surface_update")
        self.launches["aderdg_surface_update"] += 1
        return new

    def kernel_info(self, name: str, dtype) -> dict:
        """How ``name`` (one of :attr:`kernels`) launches for this solver's
        physics in ``dtype`` on the current card: ``registers`` per thread,
        resident ``blocks_per_sm``, ``threads`` per block, dynamic ``smem``
        bytes and ``local`` (spill) bytes per thread."""
        out = (ctypes.c_int * 5)()
        lib = _build.library()
        err = lib.exahype_aderdg_kernel_info(
            self.KERNELS.index(name), int(dtype == torch.float64), self._physics_id, out)
        _build.check(lib, err, f"kernel_info({name})")
        return dict(zip(("registers", "blocks_per_sm", "threads", "smem", "local"), out))

    # ------------------------------------------------------- solver protocol

    def step(self, u, dt, return_face_fluxes: bool = False):
        """One step; a fresh tensor (``u`` is not modified).  With
        ``return_face_fluxes``, ``(new, [fhat_hi per axis])`` as
        :meth:`ADERDGSolver.step` returns them."""
        if not u.is_cuda:
            return self.solver.step(u, dt, return_face_fluxes)
        new, faces = self.predictor_volume(u, dt)
        return self.face_surface(new, faces, dt, return_face_fluxes)

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
