"""Compressible Navier–Stokes (PyTorch): the Euler flux plus the Stokes
stress and the Fourier heat flux, through the ADER-DG solver's viscous-flux
contract.

Port of ``exahype_tpu/models/navier_stokes.py``.  State ``[ρ, m_1..m_dim,
E]``; the viscous flux along ``d`` is

    F_v(ρ) = 0,  F_v(m_j) = −τ_dj,  F_v(E) = −τ_dj v_j − κ_T ∂_d T,
    τ_ij = μ (∂_i v_j + ∂_j v_i − (2/3) δ_ij ∇·v),  T = p/ρ (R = 1),
    κ_T = μγ / ((γ−1) Pr),

from the physical gradients of the conserved variables by the chain rule
∂v_j = (∂m_j − v_j ∂ρ)/ρ, ∂T = ((γ−1)(∂E − v·∂m + ½q²∂ρ) − T∂ρ)/ρ.  The
diffusion eigenvalue (the face penalty and the parabolic time step) is
``max(4/3, γ/Pr)·μ/ρ``.  The operation order is the JAX package's, so the
float64 results agree to rounding; ``csrc/navier_stokes.cuh`` holds the
same arithmetic for the kernels.

:func:`navier_stokes` returns the solver's four callbacks, each tagged
``.physics = PhysicsTag("navier_stokes", dim, dim + 2, (gamma, mu,
prandtl))`` so that ``models/aderdg_cuda.py`` recognises them and reads μ,
Pr and γ.  The no-slip wall hooks are sign tables
(:func:`~exahype_tpu_torch.models.aderdg.sign_reflect`).
"""

from __future__ import annotations

import torch

from exahype_tpu_torch.models import euler
from exahype_tpu_torch.models.aderdg import PhysicsTag, euler_physics, sign_reflect

GAMMA = euler.GAMMA


def _var(Q, k: int, va: int):
    return Q.select(va, k)


def viscous_flux(Q, grads, normal, *, dim: int = 2, mu: float = 1e-2,
                 prandtl: float = 0.7, gamma: float = GAMMA, var_axis: int = -1):
    """The viscous flux along ``normal`` from the physical gradients
    ``grads[e] = ∂Q/∂x_e`` (each shaped like ``Q``), stacked on
    ``var_axis`` (var-last by default, as the JAX function takes it)."""
    va = var_axis % Q.dim()
    rho = _var(Q, 0, va)
    inv_rho = 1.0 / rho
    v = [_var(Q, 1 + j, va) * inv_rho for j in range(dim)]
    E = _var(Q, 1 + dim, va)
    q2 = sum(vj * vj for vj in v)
    T = (gamma - 1.0) * (E * inv_rho - 0.5 * q2)  # p/ρ with R = 1

    # dv[e][j] = ∂_e v_j ; dT[e] = ∂_e T (conserved-variable chain rule).
    dv = [[None] * dim for _ in range(dim)]
    dT = [None] * dim
    for e in range(dim):
        g = grads[e]
        drho = _var(g, 0, va)
        dE = _var(g, 1 + dim, va)
        v_dot_dm = torch.zeros_like(drho)
        for j in range(dim):
            dm = _var(g, 1 + j, va)
            dv[e][j] = (dm - v[j] * drho) * inv_rho
            v_dot_dm = v_dot_dm + v[j] * dm
        dT[e] = ((gamma - 1.0) * (dE - v_dot_dm + 0.5 * q2 * drho) - T * drho) * inv_rho

    div_v = sum(dv[e][e] for e in range(dim))
    d = int(normal)
    tau_d = [
        mu * (dv[d][j] + dv[j][d] - (2.0 / 3.0) * (div_v if j == d else 0.0))
        for j in range(dim)
    ]
    kappa_T = mu * gamma / ((gamma - 1.0) * prandtl)
    rows = [torch.zeros_like(rho)]
    rows += [-tau_d[j] for j in range(dim)]
    rows.append(-sum(tau_d[j] * v[j] for j in range(dim)) - kappa_T * dT[d])
    return torch.stack(rows, dim=va)


def viscous_eigenvalue(Q, normal, *, dim: int = 2, mu: float = 1e-2,
                       prandtl: float = 0.7, gamma: float = GAMMA, var_axis: int = -1):
    """The largest diffusion eigenvalue max(4/3, γ/Pr)·ν, ν = μ/ρ (the var
    axis is reduced away)."""
    nu = mu / _var(Q, 0, var_axis % Q.dim())
    return max(4.0 / 3.0, gamma / prandtl) * nu


def navier_stokes(dim: int = 2, mu: float = 1e-2, prandtl: float = 0.7,
                  gamma: float = GAMMA):
    """``(flux_fn, max_eigenvalue_fn, visc_flux_fn, visc_eigenvalue_fn)`` in
    the solver's contract (``fn(Q, axis, var_axis)``, ``visc_flux_fn(Q,
    grads, axis, var_axis)``), all four tagged with one
    ``PhysicsTag("navier_stokes", dim, dim + 2, (gamma, mu, prandtl))``.
    The flux and eigenvalue are :func:`euler_physics`'s."""
    flux, eig = euler_physics(dim, n_real=dim + 2, gamma=gamma)
    kw = dict(dim=dim, mu=mu, prandtl=prandtl, gamma=gamma)

    def visc_flux(Q, grads, axis, var_axis):
        return viscous_flux(Q, grads, axis, var_axis=var_axis, **kw)

    def visc_eig(Q, axis, var_axis):
        return viscous_eigenvalue(Q, axis, var_axis=var_axis, **kw)

    tag = PhysicsTag("navier_stokes", int(dim), int(dim) + 2,
                     (float(gamma), float(mu), float(prandtl)))
    for fn in (flux, eig, visc_flux, visc_eig):
        fn.physics = tag
    return flux, eig, visc_flux, visc_eig


def noslip_reflect(dim: int):
    """Mirror ghost STATE for no-slip walls: every momentum component
    negated, ρ and E copied, on every axis (the JAX ``noslip_reflect``)."""
    return sign_reflect([[1.0] + [-1.0] * dim + [1.0]] * dim)


def noslip_reflect_flux(dim: int):
    """Mirror ghost ADVECTIVE flux for no-slip walls: under u → −u the
    mass and energy rows are odd, the momentum rows even (the JAX
    ``noslip_reflect_flux``).  The solver applies it to the advective part
    of the wall flux only; the viscous part is the interior one-sided
    value."""
    return sign_reflect([[-1.0] + [1.0] * dim + [-1.0]] * dim)


def wrap_visc_var_last(batch_fn):
    """Adapt a var-last ``(Q, grads, normal)`` viscous callback to the
    solver's ``(Q, grads, axis, var_axis)`` contract."""

    def fn(Q, grads, axis, var_axis):
        out = batch_fn(
            torch.movedim(Q, var_axis, -1),
            tuple(torch.movedim(g, var_axis, -1) for g in grads),
            axis,
        )
        return torch.movedim(out, -1, var_axis)

    return fn
