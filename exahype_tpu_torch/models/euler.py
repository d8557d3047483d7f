"""Compressible Euler physics in the SoA-P layout (PyTorch).

Port of the var-axis forms of ``exahype_tpu/models/euler.py`` (``_v``,
``_pressure_tpu``, ``flux_tpu``, ``max_eigenvalue_tpu``): the variable axis
sits at position ``var_axis`` counted from the front, any number of axes
trail.  State ``[ρ, m_1..m_dim, E, (aux…)]``.  The operation order is the
JAX package's (``inv_rho`` multiplies, it does not divide), and the CUDA
kernels' ``__device__`` physics in ``csrc/aderdg.cu`` follows it too.
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
