"""Compressible Euler physics in the SoA-P layout (PyTorch).

Port of the var-axis forms of ``exahype_tpu/models/euler.py`` (``_v``,
``_pressure_tpu``, ``flux_tpu``, ``max_eigenvalue_tpu``, ``scalar_max``):
the variable axis sits at position ``var_axis`` counted from the front, any
number of axes trail.  State ``[ρ, m_1..m_dim, E, (aux…)]``.  The operation
order is the JAX package's (``inv_rho`` multiplies, it does not divide), and
the CUDA kernels' ``__device__`` physics in ``csrc/euler.cuh`` follows it
too; the ``*_cuda`` functions give the spec DSL's ``cuda_source`` of each.
"""

from __future__ import annotations

import torch

GAMMA = 1.4


def _v(Q, k: int, axis: int):
    """Select variable ``k`` (var axis at front position ``axis``)."""
    return Q[(slice(None),) * axis + (k,)]


def _pressure(Q, dim: int, gamma: float, va: int):
    inv_rho = 1.0 / _v(Q, 0, va)
    kinetic = _v(Q, 1, va) * _v(Q, 1, va) + _v(Q, 2, va) * _v(Q, 2, va)
    if dim == 3:
        kinetic = kinetic + _v(Q, 3, va) * _v(Q, 3, va)
    return (gamma - 1.0) * (_v(Q, dim + 1, va) - 0.5 * inv_rho * kinetic)


def flux(
    Q, normal, *, dim: int = 2, n_real: int = 5, gamma: float = GAMMA,
    var_axis: int | None = None,
):
    """Euler flux along ``normal``, stacked on the var axis."""
    n = int(normal)
    va = dim if var_axis is None else var_axis
    inv_rho = 1.0 / _v(Q, 0, va)
    p = _pressure(Q, dim, gamma, va)
    coeff = inv_rho * _v(Q, n + 1, va)
    comps = [coeff * _v(Q, k, va) for k in range(dim + 1)]
    comps[n + 1] = comps[n + 1] + p
    comps.append(coeff * _v(Q, dim + 1, va) + coeff * p)
    while len(comps) < n_real:
        comps.append(torch.zeros_like(p))
    return torch.stack(comps[:n_real], dim=va)


def max_eigenvalue(
    Q, normal, *, dim: int = 2, gamma: float = GAMMA, var_axis: int | None = None
):
    """Largest |wave speed| along ``normal`` (the var axis is reduced away)."""
    n = int(normal)
    va = dim if var_axis is None else var_axis
    inv_rho = 1.0 / torch.abs(_v(Q, 0, va))
    p = _pressure(Q, dim, gamma, va)
    c = torch.sqrt(gamma * torch.abs(p) * inv_rho)
    u_n = _v(Q, n + 1, va) * inv_rho
    return torch.maximum(torch.abs(u_n - c), torch.abs(u_n + c))


def scalar_max(a, b):
    """Pointer-``max`` analogue (``euler.scalar_max`` of the JAX package)."""
    return torch.maximum(a, b)


def wave_speed_fn(dim: int, gamma: float = GAMMA):
    """``cells -> `` the largest wave speed over all axes, per cell, in the
    SoA-P layout (var axis at ``dim``): a ``GridSolver`` ``eigenvalue_fn``."""

    def wave_speed(cells):
        out = max_eigenvalue(cells, 0, dim=dim, gamma=gamma)
        for d in range(1, dim):
            out = torch.maximum(out, max_eigenvalue(cells, d, dim=dim, gamma=gamma))
        return out

    return wave_speed


# ------------------------------------------------------------- CUDA sources
# The ``cuda_source`` of the spec functions (see
# ``frontend/typed_function.py``): thin device functions over
# ``csrc/euler.cuh``, which holds the same arithmetic in the same order as
# the tensor forms above.  Constants go in as ``T(<double literal>)``, so a
# float32 kernel rounds them as the float32 tensor path does.


def flux_cuda(dim: int, n_real: int = 5, gamma: float = GAMMA) -> str:
    """``spec_Flux(Q, normal, F)``: the flux along ``normal``."""
    return (
        '#include "euler.cuh"\n'
        "template <typename T>\n"
        "__device__ __forceinline__ void spec_Flux(const T* Q, T normal, T* F) {\n"
        f"  euler_flux<T, {dim}, {n_real}>(Q, static_cast<int>(normal), "
        f"T({gamma - 1.0!r}), F);\n"
        "}\n"
    )


def max_eigenvalue_cuda(dim: int, gamma: float = GAMMA) -> str:
    """``spec_maxEigenvalue(Q, normal)``: the largest |wave speed|."""
    return (
        '#include "euler.cuh"\n'
        "template <typename T>\n"
        "__device__ __forceinline__ T spec_maxEigenvalue(const T* Q, T normal) {\n"
        "  const int n = static_cast<int>(normal);\n"
        f"  return euler_max_eigenvalue<T, {dim}>(Q, Q[n + 1], "
        f"T({gamma - 1.0!r}), T({float(gamma)!r}));\n"
        "}\n"
    )


SCALAR_MAX_CUDA = (
    '#include "device_math.cuh"\n'
    "template <typename T>\n"
    "__device__ __forceinline__ T spec_max(T a, T b) { return dmax(a, b); }\n"
)
