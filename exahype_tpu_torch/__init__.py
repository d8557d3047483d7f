"""exahype_tpu_torch — the PyTorch/CUDA port of ``exahype_tpu``.

Two paths of the JAX package run here, on an NVIDIA H100 through CUDA
kernels written for it, and on the CPU through their plain PyTorch
versions, which match the JAX package:

- the ADER-DG order-3 step of 3-D compressible Euler (``bench.py``'s path),
  through the hand-written kernels of ``csrc/aderdg.cu``;
- the spec-DSL FV Rusanov patch update (``__graft_entry__.py``'s path):
  ``KernelBuilder`` → ``CudaPrinter``, which generates one CUDA kernel from
  the statement list → ``TpuPatchGrid`` halo exchange → ``GridSolver``.

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
    "CudaADERDG": "exahype_tpu_torch.models.aderdg_cuda",
    "DGOperators": "exahype_tpu_torch.models.dg",
    "KernelBuilder": "exahype_tpu_torch.frontend.kernel_builder",
    "build_rusanov_kernel": "exahype_tpu_torch.models.rusanov",
    "build_fv_rusanov_kernel": "exahype_tpu_torch.models.fv",
    "TorchPrinter": "exahype_tpu_torch.backends.torch_backend",
    "CudaPrinter": "exahype_tpu_torch.backends.cuda_backend",
    "TpuPatchGrid": "exahype_tpu_torch.parallel.grid",
    "GridSolver": "exahype_tpu_torch.parallel.solver",
    "aderdg_from_jax": "exahype_tpu_torch.convert",
    "grid_solver_from_jax": "exahype_tpu_torch.convert",
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
