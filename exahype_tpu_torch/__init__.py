"""exahype_tpu_torch — the PyTorch/CUDA port of ``exahype_tpu``.

Nine paths of the JAX package run here, on an NVIDIA H100 through CUDA
kernels written for it, and on the CPU through their plain PyTorch
versions, which match the JAX package:

- the ADER-DG order-3 step of 3-D compressible Euler (``bench.py``'s path),
  through the hand-written kernels of ``csrc/aderdg.cu``, periodic or
  closed by domain walls (reflective, outflow, farfield, dirichlet; the
  face stage's wall variant on the card);
- the viscous ADER-DG step of 3-D compressible Navier–Stokes
  (``models/navier_stokes.py``'s callbacks as ``visc_flux_fn`` /
  ``visc_eigenvalue_fn``), through the viscous predictor of
  ``csrc/aderdg_visc.cu`` and the face stage with its diffusion penalty,
  periodic or with walls (no-slip through ``noslip_reflect``);
- the limited production step of the same scheme (``bench.py``'s second
  metric): ``LimitedADERDG`` with the gathered-row subcell FV fallback,
  its sweeps through the kernel of ``csrc/subcell.cu``;
- the Cauchy–Kovalewski step of 3-D heterogeneous elasticity
  (``bench.py``'s third metric): ``ADERDGSolver(predictor_mode="ck")`` on
  ``elastic3d_heterogeneous``, through the CK kernel of ``csrc/aderdg.cu``,
  with or without the free surface (``elastic3d_free_surface_het``), and
  the layered seismic run of ``examples/seismic3d_layered.py``: the CK step
  with the absorbing sponge (``sponge_source``, compiled into the CK
  kernel), a Ricker point force (``PointSources``, ``ricker``) and surface
  receivers (``TracerAdvector``);
- the spec-DSL FV Rusanov patch update (``__graft_entry__.py``'s path):
  ``KernelBuilder`` → ``CudaPrinter``, which generates one CUDA kernel from
  the statement list → ``TpuPatchGrid`` halo exchange → ``GridSolver``;
- the dynamic-GR step of the 38-variable vacuum Z4 system at order 2 in 3-D
  (``scripts/z4_probe.py``'s production path): ``make_z4_solver(...,
  impl="soa", fused_rhs="soa")`` → ``CudaADERDG`` (the step's three kernels
  of ``csrc/aderdg_z4.cu``, the algebra compiled in) or ``with_cuda_rhs``
  (its fused right-hand side through the kernel of ``csrc/rhs.cu``); and
  the same for the 53-variable shifted system (``make_z4_shift_solver``,
  frozen shift or Gamma-driver, ``scripts/z4_probe.py --shift``; kernels of
  ``csrc/aderdg_z4_shift.cu`` and ``csrc/rhs.cu``);
- the coupled Z4 + general-relativistic hydro step (43 variables: dynamic
  spacetime with a perfect fluid, ``scripts/z4_probe.py --matter``):
  ``make_z4_matter_solver(..., fused_rhs="soa")`` → ``CudaADERDG`` (the
  kernels of ``csrc/aderdg_z4_matter.cu``, which carry the hydro flux and
  the recovery's Newton) or ``with_cuda_rhs``; its anchor is the FLRW
  universe (``flrw_state``, ``flrw_reference``);
- the coupled Z4 + general-relativistic MHD step (47 variables: the fluid
  magnetized, with GLM divergence cleaning; the ExaGRyPE flagship's
  shape): ``make_z4_grmhd_solver(..., fused_rhs="soa")`` → ``CudaADERDG``
  (the kernels of ``csrc/aderdg_z4_grmhd.cu``, the field-aligned recovery's
  Newton in them) or ``with_cuda_rhs``; on the magnetized wave
  (``magnetized_wave_state``).

It imports ``torch``, NumPy and (for the spec DSL) SymPy, never JAX.
States use the JAX package's SoA-P layouts, so they pass between the
packages as arrays (:mod:`exahype_tpu_torch.convert`).  Entry points put
their tensors on the CUDA card unless given ``device="cpu"``.

Exports are lazy, so ``import exahype_tpu_torch`` stays cheap.
"""

__version__ = "0.2.0"

_EXPORTS = {
    "ADERDGSolver": "exahype_tpu_torch.models.aderdg",
    "euler_physics": "exahype_tpu_torch.models.aderdg",
    "euler_reflect": "exahype_tpu_torch.models.aderdg",
    "euler_reflect_flux": "exahype_tpu_torch.models.aderdg",
    "make_dirichlet_fn": "exahype_tpu_torch.models.aderdg",
    "sign_reflect": "exahype_tpu_torch.models.aderdg",
    "elastic3d_free_surface_het": "exahype_tpu_torch.models.elastic",
    "elastic3d_heterogeneous": "exahype_tpu_torch.models.elastic",
    "sponge_source": "exahype_tpu_torch.models.elastic",
    "PointSources": "exahype_tpu_torch.models.point_source",
    "ricker": "exahype_tpu_torch.models.point_source",
    "TracerAdvector": "exahype_tpu_torch.models.tracers",
    "navier_stokes": "exahype_tpu_torch.models.navier_stokes",
    "noslip_reflect": "exahype_tpu_torch.models.navier_stokes",
    "noslip_reflect_flux": "exahype_tpu_torch.models.navier_stokes",
    "make_z4_solver": "exahype_tpu_torch.models.z4",
    "gauge_wave_state": "exahype_tpu_torch.models.z4",
    "make_z4_shift_solver": "exahype_tpu_torch.models.z4",
    "moving_gauge_wave_state": "exahype_tpu_torch.models.z4",
    "make_z4_matter_solver": "exahype_tpu_torch.models.z4_matter",
    "flrw_state": "exahype_tpu_torch.models.z4_matter",
    "flrw_reference": "exahype_tpu_torch.models.z4_matter",
    "z4_matter_admissible": "exahype_tpu_torch.models.z4_matter",
    "make_z4_grmhd_solver": "exahype_tpu_torch.models.z4_grmhd",
    "magnetized_wave_state": "exahype_tpu_torch.models.z4_grmhd",
    "z4_grmhd_admissible": "exahype_tpu_torch.models.z4_grmhd",
    "CudaRHS": "exahype_tpu_torch.models.rhs_cuda",
    "with_cuda_rhs": "exahype_tpu_torch.models.rhs_cuda",
    "CudaADERDG": "exahype_tpu_torch.models.aderdg_cuda",
    "LimitedADERDG": "exahype_tpu_torch.models.limiter",
    "euler_admissible": "exahype_tpu_torch.models.limiter",
    "DGOperators": "exahype_tpu_torch.models.dg",
    "KernelBuilder": "exahype_tpu_torch.frontend.kernel_builder",
    "build_rusanov_kernel": "exahype_tpu_torch.models.rusanov",
    "build_fv_rusanov_kernel": "exahype_tpu_torch.models.fv",
    "TorchPrinter": "exahype_tpu_torch.backends.torch_backend",
    "CudaPrinter": "exahype_tpu_torch.backends.cuda_backend",
    "TpuPatchGrid": "exahype_tpu_torch.parallel.grid",
    "GridSolver": "exahype_tpu_torch.parallel.solver",
    "aderdg_from_jax": "exahype_tpu_torch.convert",
    "point_sources_from_jax": "exahype_tpu_torch.convert",
    "limited_from_jax": "exahype_tpu_torch.convert",
    "grid_solver_from_jax": "exahype_tpu_torch.convert",
    "z4_solver_from_jax": "exahype_tpu_torch.convert",
    "z4_shift_solver_from_jax": "exahype_tpu_torch.convert",
    "z4_matter_solver_from_jax": "exahype_tpu_torch.convert",
    "z4_grmhd_solver_from_jax": "exahype_tpu_torch.convert",
    "state_from_numpy": "exahype_tpu_torch.convert",
    "state_to_numpy": "exahype_tpu_torch.convert",
    "SemanticError": "exahype_tpu_torch.utils.errors",
    "LoweringError": "exahype_tpu_torch.utils.errors",
}

__all__ = [*_EXPORTS, "__version__"]


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'exahype_tpu_torch' has no attribute {name!r}")
