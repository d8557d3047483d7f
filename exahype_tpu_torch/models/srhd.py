"""Special-relativistic hydrodynamics: the conservative-to-primitive
recovery (PyTorch).

The port's copy of what the coupled Z4+GRHD system (``models/z4_matter.py``)
needs from ``exahype_tpu/models/srhd.py``: ``prim_to_cons``, ``con2prim``
and its scalar core ``con2prim_smag``, in the reference's operation order
(the JAX module loads JAX, so the port keeps its own copy).  The flat SRHD
fluxes, wave speeds and solver are not ported (``ROADMAP.md``, Queue 1 item
12).

State (c = 1, ideal gas p = (Γ−1)ρε): Q = [D, S_1..S_dim, τ] with D = ρW,
S_j = ρhW² v_j, τ = ρhW² − p − D.  The recovery is a fixed-``iters``
safeguarded Newton on the pressure: every iterate keeps the physical bracket
p ∈ (max(p_floor, |S| − E), (Γ−1)E], the bracket tightens by the sign of the
(decreasing) residual each iteration, and a Newton candidate that leaves it
or is not finite is replaced by bisection; the selections are
``torch.where``, so there is no data-dependent control flow.  ``csrc/
srhd.cuh`` is the same iteration as device code.
"""

from __future__ import annotations

import torch


def prim_to_cons(rho, v, p, *, gamma: float = 5.0 / 3.0):
    """[ρ, v_j (var-last vector), p] → conserved state [D, S_j, τ]."""
    v2 = torch.sum(v * v, dim=-1)
    W = 1.0 / torch.sqrt(1.0 - v2)
    eps = p / ((gamma - 1.0) * rho)
    h = 1.0 + eps + p / rho
    D = rho * W
    rhohW2 = rho * h * W * W
    S = rhohW2[..., None] * v
    tau = rhohW2 - p - D
    return torch.cat([D[..., None], S, tau[..., None]], dim=-1)


def con2prim(Q, *, gamma: float = 5.0 / 3.0, iters: int = 10, p_floor: float = 1e-12):
    """Recover ``(rho, v, p, W)`` from ``Q = [D, S_j, τ]`` (var-last): the
    momentum norm |S| = √(Σ S_j²), then :func:`con2prim_smag`."""
    D = Q[..., 0]
    S = Q[..., 1:-1]
    tau = Q[..., -1]
    S2 = torch.sum(S * S, dim=-1)
    Smag = torch.sqrt(S2)
    rho, p, W = con2prim_smag(D, Smag, tau, gamma=gamma, iters=iters, p_floor=p_floor)
    v = S / (tau + D + p)[..., None]
    return rho, v, p, W


def con2prim_smag(D, Smag, tau, *, gamma: float = 5.0 / 3.0, iters: int = 10,
                  p_floor: float = 1e-12):
    """The recovery on ``(D, |S|, τ)``, every input and output grid-shaped:
    the form the algebra of the coupled system calls (and its kernels
    evaluate).  Returns ``(rho, p, W)``.  ``torch.maximum``/``minimum``
    propagate NaN as ``jnp.maximum``/``minimum`` do."""
    E = tau + D
    S2 = Smag * Smag

    tiny = torch.tensor(1e-12, dtype=D.dtype, device=D.device) * (1.0 + Smag)
    p_lo = torch.clamp(Smag - E + tiny, min=p_floor)
    p_hi = torch.maximum((gamma - 1.0) * E * (1.0 + 1e-6) + 10 * p_floor, p_lo * 2.0)

    # The initial guess: the smaller of the Newtonian pressure and the
    # ultrarelativistic estimate (Γ−1)(E−|S|), inside the bracket.
    p = torch.clamp(
        torch.minimum((gamma - 1.0) * tau, (gamma - 1.0) * (E - Smag)), min=p_floor
    )
    p = torch.minimum(torch.maximum(p, p_lo), p_hi)
    for _ in range(iters):
        Ep = E + p
        v2 = torch.clamp(S2 / (Ep * Ep), 0.0, 1.0 - 1e-12)
        W = 1.0 / torch.sqrt(1.0 - v2)
        rho = D / W
        h = Ep / (D * W)
        eps = h - 1.0 - p / rho
        f = (gamma - 1.0) * rho * eps - p
        cs2 = gamma * p / (rho * h)
        df = v2 * cs2 - 1.0
        newton = p - f / df
        # Tighten the bracket by the residual's sign (f decreases in p),
        # then take the Newton step iff it stays inside (non-strict bounds:
        # at convergence newton == p == the edge just assigned).
        p_lo = torch.where(f > 0, p, p_lo)
        p_hi = torch.where(f > 0, p_hi, p)
        inside = torch.isfinite(newton) & (newton >= p_lo) & (newton <= p_hi)
        p = torch.clamp(torch.where(inside, newton, 0.5 * (p_lo + p_hi)), min=p_floor)
    Ep = E + p
    v2 = torch.clamp(S2 / (Ep * Ep), 0.0, 1.0 - 1e-12)
    W = 1.0 / torch.sqrt(1.0 - v2)
    rho = D / W
    return rho, p, W
