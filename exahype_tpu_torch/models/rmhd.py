"""Special-relativistic ideal MHD: the conservative-to-primitive recovery
(PyTorch).

The port's copy of what the coupled Z4+GRMHD system (``models/z4_grmhd.py``)
needs from ``exahype_tpu/models/rmhd.py``: ``prim_to_cons``, the vector
``con2prim`` and its field-aligned scalar core ``con2prim_scalar``, in the
reference's operation order (the JAX module loads JAX, so the port keeps its
own copy).  The flat RMHD flux, eigenvalue and solver are not ported
(``ROADMAP.md``, Queue 1 item 12).

State (c = 1, ideal gas, three momentum and field components):
Q = [D, S_x, S_y, S_z, τ, B_x, B_y, B_z, ψ] with D = ρW,
S_i = (ρh + b²)W² v_i − b⁰ b_i, τ = (ρh + b²)W² − (p + b²/2) − (b⁰)² − D.
The recovery is a fixed-``iters`` safeguarded Newton on z = ρhW², the root
of the energy residual

    f(z) = z + B² − p(z) − ½ (B²/W(z)² + (S·B)²/z²) − (τ + D),

every iterate kept in the bracket z ∈ [max(D, |S| − B²), Γ(E + B²)], the
bracket tightened by the residual's sign each trip, and a Newton candidate
that leaves it or is not finite replaced by bisection; the selections are
``torch.where``, so there is no data-dependent control flow.

The reference differentiates the residual with ``jax.jvp``.  Here (and in
``csrc/rmhd.cuh``, which is the same iteration as device code) the
derivative is forward mode written out: :func:`_resid` carries the value
and the tangent through the residual's operations in their order, with
JAX's rule for each (a product's tangent ẋy + xẏ, a quotient's ẋ/y +
(−ẏx)·(1/y²), a root's ġ·(0.5/√x)), and the clip's tangent zero where it
binds (halved on a tie, as ``jnp.maximum``'s balanced rule gives it).
"""

from __future__ import annotations

import torch

N_VARS = 9


def prim_to_cons(rho, v, p, B, *, gamma: float = 5.0 / 3.0):
    """[ρ, v (var-last 3-vector), p, B (3-vector)] → [D, S, τ, B, ψ = 0]."""
    v2 = torch.sum(v * v, dim=-1)
    B2 = torch.sum(B * B, dim=-1)
    Bv = torch.sum(B * v, dim=-1)
    W = 1.0 / torch.sqrt(1.0 - v2)
    h = 1.0 + gamma / (gamma - 1.0) * p / rho
    b2 = B2 / (W * W) + Bv * Bv
    wtot = rho * h + b2
    ptot = p + 0.5 * b2
    b0 = W * Bv
    bi = B / W[..., None] + (W * Bv)[..., None] * v
    D = rho * W
    S = (wtot * W * W)[..., None] * v - b0[..., None] * bi
    tau = wtot * W * W - ptot - b0 * b0 - D
    return torch.cat([D[..., None], S, tau[..., None], B, torch.zeros_like(D)[..., None]],
                     dim=-1)


def _balanced(x, ans, other):
    """The factor of ``jnp.maximum``/``jnp.minimum``'s tangent rule for the
    operand ``x``: 1 where it is the answer, ½ on a tie with ``other``, else
    0."""
    one = torch.where(x == ans, 1.0, 0.0).to(ans.dtype)
    return one / torch.where(other == ans, 2.0, 1.0).to(ans.dtype)


def _resid(z, dz, S2, B2, sB, D, E, gamma: float):
    """The energy residual f(z), its tangent f'(z)·dz, and (W, p) at z.

    Every operation of the reference's ``resid`` in its order, each paired
    with its tangent by JAX's rule; the inputs other than z carry none."""
    z2 = z * z
    dz2 = dz * z + z * dz
    zB = z + B2
    dzB = dz
    # v² = (S² z² + (S·B)² (B² + 2z)) / (z² (z + B²)²), clipped to [0, 1 − 1e-12].
    a = S2 * z2
    da = S2 * dz2
    sBsB = sB * sB
    c = 2.0 * z
    dc = 2.0 * dz
    bz = B2 + c
    b = sBsB * bz
    db = sBsB * dc
    num = a + b
    dnum = da + db
    den1 = z2 * zB
    dden1 = dz2 * zB + z2 * dzB
    den = den1 * zB
    dden = dden1 * zB + den1 * dzB
    r = num / den
    dr = dnum / den + (-dden * num) * (1.0 / (den * den))
    lo = torch.maximum(torch.zeros_like(r), r)
    dlo = dr * _balanced(r, lo, torch.zeros_like(r))
    hi = torch.full_like(r, 1.0 - 1e-12)
    v2 = torch.minimum(hi, lo)
    dv2 = dlo * _balanced(lo, v2, hi)
    s = torch.sqrt(1.0 - v2)
    ds = -dv2 * (0.5 / s)
    W = 1.0 / s
    dW = (-ds * 1.0) * (1.0 / (s * s))
    # p = (Γ−1)/Γ (z − D W) / W².
    DW = D * W
    dDW = D * dW
    t1 = (gamma - 1.0) / gamma * (z - DW)
    dt1 = (gamma - 1.0) / gamma * (dz - dDW)
    WW = W * W
    dWW = dW * W + W * dW
    p = t1 / WW
    dp = dt1 / WW + (-dWW * t1) * (1.0 / (WW * WW))
    # f = z + B² − p − ½ (B²/W² + (S·B)²/z²) − E.
    q1 = B2 / WW
    dq1 = (-dWW * B2) * (1.0 / (WW * WW))
    q2 = sBsB / z2
    dq2 = (-dz2 * sBsB) * (1.0 / (z2 * z2))
    f = z + B2 - p - 0.5 * (q1 + q2) - E
    df = dz - dp - 0.5 * (dq1 + dq2)
    return f, df, W, p


def _newton(D, S2, B2, sB, tau, Smag, *, gamma: float, iters: int, z_floor: float):
    """The bracketed Newton of both forms on the invariants (D, |S|², (S·B)²
    through S·B, |B|², τ): the converged z with (W, p) at it."""
    E = tau + D
    tiny = z_floor * (1.0 + Smag + B2)
    z_lo = torch.clamp(torch.maximum(D, Smag - B2) + tiny, min=z_floor)
    z_hi = torch.maximum(gamma * (E + B2) + tiny, z_lo * 2.0)
    # The weak-field estimate: E ≈ z + B² − p, p from the field-corrected τ.
    p0 = torch.clamp((gamma - 1.0) * (tau - 0.5 * B2), min=z_floor)
    z = torch.minimum(z_hi, torch.maximum(z_lo, E - B2 + p0))
    ones = torch.ones_like(z)
    for _ in range(iters):
        f, df, _, _ = _resid(z, ones, S2, B2, sB, D, E, gamma)
        newton = z - f / df
        # f increases in z: tighten the bracket by the residual's sign.
        below = f < 0
        z_lo = torch.where(below, z, z_lo)
        z_hi = torch.where(below, z_hi, z)
        inside = torch.isfinite(newton) & (newton >= z_lo) & (newton <= z_hi)
        z = torch.clamp(torch.where(inside, newton, 0.5 * (z_lo + z_hi)), min=z_floor)
    _, _, W, p = _resid(z, ones, S2, B2, sB, D, E, gamma)
    return z, W, p


def con2prim(Q, *, gamma: float = 5.0 / 3.0, iters: int = 20, z_floor: float = 1e-12):
    """Recover ``(rho, v, p, W)`` from the var-last conserved state (ψ
    ignored), with the reference's subluminal clamp of v."""
    D = Q[..., 0]
    S = Q[..., 1:4]
    tau = Q[..., 4]
    B = Q[..., 5:8]
    S2 = torch.sum(S * S, dim=-1)
    B2 = torch.sum(B * B, dim=-1)
    sB = torch.sum(S * B, dim=-1)
    Smag = torch.sqrt(S2)
    z, W, p = _newton(D, S2, B2, sB, tau, Smag, gamma=gamma, iters=iters, z_floor=z_floor)
    v = (S + (sB / z)[..., None] * B) / (z + B2)[..., None]
    # The clamp keeps the primitives bounded on unphysical inputs (the
    # limiter evaluates candidates); physical states have |v| < 1 already.
    v2 = torch.sum(v * v, dim=-1)
    scale = torch.sqrt((1.0 - 1e-12) / torch.clamp(v2, min=1e-300))
    v = v * torch.clamp(scale, max=1.0)[..., None]
    W = 1.0 / torch.sqrt(1.0 - torch.clamp(v2, 0.0, 1.0 - 1e-12))
    rho = D / W
    return rho, v, p, W


def con2prim_scalar(D, S_par, S_perp, tau, Bmag, *, gamma: float = 5.0 / 3.0,
                    iters: int = 20, z_floor: float = 1e-12):
    """The same recovery on the field-aligned decomposition (D, S_∥, S_⊥, τ,
    |B|), every input and output grid-shaped: the form the coupled system's
    algebra calls (and its kernels evaluate).  Returns ``(rho, p, W)``,
    W from the aligned velocity (no clamp of v, as in the reference)."""
    S2 = S_par * S_par + S_perp * S_perp
    B2 = Bmag * Bmag
    sB = S_par * Bmag
    Smag = torch.sqrt(S2)
    z, W, p = _newton(D, S2, B2, sB, tau, Smag, gamma=gamma, iters=iters, z_floor=z_floor)
    v_par = (S_par + (sB / z) * Bmag) / (z + B2)
    v_perp = S_perp / (z + B2)
    v2 = v_par * v_par + v_perp * v_perp
    W = 1.0 / torch.sqrt(1.0 - torch.clamp(v2, 0.0, 1.0 - 1e-12))
    rho = D / W
    return rho, p, W
