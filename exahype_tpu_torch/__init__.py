"""exahype_tpu_torch — the PyTorch/CUDA port of ``exahype_tpu``.

It runs the ADER-DG order-3 step of 3-D compressible Euler (the JAX
package's ``bench.py`` path) on an NVIDIA H100 through hand-written CUDA
kernels (``csrc/aderdg.cu``), and on the CPU through its plain PyTorch
version, which matches the JAX package.  It imports ``torch`` and NumPy,
never JAX.  States use the JAX package's SoA-P layout
``[n_1..n_d, n_vars, g_1..g_d]``, so they pass between the packages as
arrays (:mod:`exahype_tpu_torch.convert`).

Exports are lazy, so ``import exahype_tpu_torch`` stays cheap.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "ADERDGSolver": "exahype_tpu_torch.models.aderdg",
    "euler_physics": "exahype_tpu_torch.models.aderdg",
    "CudaADERDG": "exahype_tpu_torch.models.aderdg_cuda",
    "DGOperators": "exahype_tpu_torch.models.dg",
    "aderdg_from_jax": "exahype_tpu_torch.convert",
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
