"""Coupled matter and dynamic spacetime: Z4 + general-relativistic hydro
(PyTorch).

Port of ``exahype_tpu/models/z4_matter.py`` on its production path
(``impl="soa"``, ``fused_rhs="soa"``): the Einstein equations in first-order
Z4 form sourced by a perfect fluid, and the fluid evolved on the dynamic
metric.  43 variables, var-last in the ``*_rhs`` functions: the 38 zero-shift
Z4 variables of ``models/z4.py`` followed by the densitized Valencia hydro
block

    Q = [α, γ_ij, K_ij, Θ, Z_i, A_k, D_kij,  D̃, S̃_i (3), τ̃]

with D̃ = √γ ρW, S̃_i = √γ ρhW² v_i, τ̃ = √γ (ρhW² − p) − D̃ (G = c = 1,
ideal gas p = (Γ−1)ρε).  The vacuum right-hand side gains the trace-reversed
matter terms on K, Θ and Z, and the hydro sector its conservative flux
(``z4_matter_flux``: Valencia rows, zero Z4 rows) and algebraic geometric
sources; no matter term reads a derivative, so the right-hand side stays
affine in ∂Q and the solver's NCP/source split follows by linearity, as in
``models/z4.py``.  The recovery is ``models/srhd.py``'s safeguarded Newton
fed the curved momentum norm |S|²_γ = γ^ij S_i S_j.

Each callback carries ``.physics = PhysicsTag("z4_matter", 3, 43, (slicing,
f, m, kappa1, kappa2, gamma, iters))``, which the kernel wrappers read
(``models/aderdg_cuda.py``: the K1 d kernels over ``csrc/z4_matter.cuh``;
``models/rhs_cuda.py``: K5 d).  The einsum formulation (``impl="einsum"``,
the JAX default: ``z4_matter_rhs``) and its fused hook (``fused_rhs=True``)
are not ported and raise :class:`SemanticError` (``ROADMAP.md``, Queue 1
item 7.4).  The JAX function's ``var_first`` layout exists for the Mosaic
kernel and is not carried.

The anchor is the flat FLRW universe (``flrw_reference``, ``flrw_values``,
``flrw_state``): on homogeneous data the coupled system reduces to the
Friedmann equations, integrated here by an independent RK4.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from exahype_tpu_torch.models import srhd
from exahype_tpu_torch.models.aderdg import ADERDGSolver, PhysicsTag
from exahype_tpu_torch.models.z4 import (
    N_VARS as N_Z4,
    _AL,
    _G,
    _callbacks,
    _oein,
    _oinv3,
    _on_solver,
    _require_fused,
    _require_soa,
    _rhs_all_of,
    _slicing,
    _vec_obj,
    _z4_core_soa,
    _z4_pack_soa,
    _z4_unpack_soa,
    inv3,
    sym_to_mat,
)

EIGHT_PI = 8.0 * math.pi

N_HYDRO = 5
N_VARS = N_Z4 + N_HYDRO  # 43

_HD = N_Z4  # D̃
_HS = slice(N_Z4 + 1, N_Z4 + 4)  # S̃_i
_HTAU = N_Z4 + 4  # τ̃


# ------------------------------------------------------------- recovery


def recover(q, *, gamma: float = 5.0 / 3.0, iters: int = 10):
    """Curved-metric con2prim on the var-last coupled state.

    Returns ``(rho, v_low[3], p, W, sqg, gi)``: the primitive density, the
    covariant velocity v_i, the pressure, the Lorentz factor, √γ and the
    inverse spatial metric."""
    g = sym_to_mat(q[..., _G])
    gi, detg = inv3(g)
    sqg = torch.sqrt(detg)
    D = q[..., _HD] / sqg
    S = q[..., _HS] / sqg[..., None]  # lower index
    tau = q[..., _HTAU] / sqg
    S2 = torch.einsum("...ij,...i,...j->...", gi, S, S)
    Smag = torch.sqrt(torch.clamp(S2, min=0.0))
    flat = torch.stack([D, Smag, tau], dim=-1)
    rho, _, p, W = srhd.con2prim(flat, gamma=gamma, iters=iters)
    v_low = S / (tau + D + p)[..., None]  # v_i = S_i / (ρhW²)
    return rho, v_low, p, W, sqg, gi


def stress_energy(q, *, gamma: float = 5.0 / 3.0, iters: int = 10):
    """Matter projections ``(E, S_i, S_ij, trace S)`` of the perfect fluid
    from the coupled state."""
    rho, v_low, p, W, sqg, gi = recover(q, gamma=gamma, iters=iters)
    g = sym_to_mat(q[..., _G])
    rhohW2 = (q[..., _HTAU] + q[..., _HD]) / sqg + p  # ρhW²
    E = rhohW2 - p
    S_low = rhohW2[..., None] * v_low
    S_ij = (rhohW2[..., None, None] * torch.einsum("...i,...j->...ij", v_low, v_low)
            + p[..., None, None] * g)
    v2 = torch.einsum("...ij,...i,...j->...", gi, v_low, v_low)
    S_tr = rhohW2 * v2 + 3.0 * p
    return E, S_low, S_ij, S_tr


# ------------------------------------------------------------------ RHS


def z4_matter_rhs_soa(
    q,
    dq3,
    *,
    gamma: float = 5.0 / 3.0,
    iters: int = 10,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
):
    """The coupled right-hand side without the hydro flux divergence,
    component-unrolled: the vacuum SoA core, the matter terms on (K, Θ, Z)
    and the algebraic hydro sources, in the JAX ``z4_matter_rhs_soa``'s
    operation order (``csrc/z4_matter.cuh`` follows it).  ``q`` var-last
    ``[..., 43]``, ``dq3`` ``[..., 3, 43]``; affine in ``dq3``."""
    al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD = _z4_unpack_soa(q, dq3)
    r_al, r_g, r_K, r_th, r_Z, r_A, r_D = _z4_core_soa(
        al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD,
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
    )

    gi, detg = _oinv3(g)
    sqg = torch.sqrt(detg)
    Dt = q[..., _HD]
    St = _vec_obj(q, _HS)
    taut = q[..., _HTAU]
    Dh = Dt / sqg
    S_low = np.empty((3,), dtype=object)
    for i in range(3):
        S_low[i] = St[i] / sqg
    tau = taut / sqg
    S2 = _oein("ij,i,j->", gi, S_low, S_low)
    Smag = torch.sqrt(torch.clamp(S2, min=0.0))
    rho, p, W = srhd.con2prim_smag(Dh, Smag, tau, gamma=gamma, iters=iters)
    rhohW2 = tau + Dh + p
    E = rhohW2 - p
    v_low = np.empty((3,), dtype=object)
    for i in range(3):
        v_low[i] = S_low[i] / rhohW2
    v_up = _oein("ij,j->i", gi, v_low)
    v2 = _oein("i,i->", v_low, v_up)
    S_tr = rhohW2 * v2 + 3.0 * p
    Sm_low = np.empty((3,), dtype=object)
    for i in range(3):
        Sm_low[i] = rhohW2 * v_low[i]
    # The matter terms on the Z4 sector.
    half_tr = 0.5 * (S_tr - E)
    for i in range(3):
        for j in range(3):
            S_ij = rhohW2 * v_low[i] * v_low[j] + p * g[i, j]
            r_K[i, j] = r_K[i, j] - EIGHT_PI * al * (S_ij - half_tr * g[i, j])
    r_th = r_th - EIGHT_PI * al * E
    for i in range(3):
        r_Z[i] = r_Z[i] - EIGHT_PI * al * Sm_low[i]

    # The hydro geometric sources.
    Sup = np.empty((3, 3), dtype=object)
    for i in range(3):
        for j in range(3):
            Sup[i, j] = rhohW2 * v_up[i] * v_up[j] + p * gi[i, j]
    asg = al * sqg
    r_S = _oein("ik,jik->j", Sup, D)
    SupK = _oein("ik,ik->", Sup, K)
    S_up_vec = _oein("ij,j->i", gi, Sm_low)
    SA = _oein("k,k->", S_up_vec, A)
    extra = [torch.zeros_like(al)]
    for j in range(3):
        extra.append(asg * (r_S[j] - E * A[j]))
    extra.append(asg * (SupK - SA))
    return _z4_pack_soa(r_al, r_g, r_K, r_th, r_Z, r_A, r_D, extra=tuple(extra))


def z4_matter_flux(Q, axis, var_axis, *, gamma: float = 5.0 / 3.0, iters: int = 10):
    """The conservative flux along grid ``axis``: the Valencia hydro rows on
    the dynamic metric from one :func:`recover`, zero Z4 rows."""
    q = torch.movedim(Q, var_axis, -1)
    al = q[..., _AL]
    rho, v_low, p, W, sqg, gi = recover(q, gamma=gamma, iters=iters)
    vd = torch.einsum("...j,...j->...", gi[..., axis, :], v_low)  # v^d
    Dt = q[..., _HD]
    St = q[..., _HS]
    taut = q[..., _HTAU]
    psg = p * sqg
    f_D = al * Dt * vd
    # The pressure enters the ``axis`` momentum row only.
    onehot = torch.zeros(3, dtype=q.dtype, device=q.device)
    onehot[axis] = 1.0
    f_S = al[..., None] * (St * vd[..., None]) + (al * psg)[..., None] * onehot
    f_tau = al * (taut + psg) * vd
    out = torch.cat(
        [torch.zeros(q.shape[:-1] + (N_Z4,), dtype=q.dtype, device=q.device),
         f_D[..., None], f_S, f_tau[..., None]],
        dim=-1,
    )
    return torch.movedim(out, -1, var_axis)


def z4_matter_eig(Q, axis, var_axis, *, slicing: str = "harmonic", f: float = 1.0):
    """The Rusanov bound: the wider of the gauge and light cones,
    α √(max(g(α), 1) γ^dd) (the relativistic hydro characteristics lie
    inside the light cone): the vacuum system's, which is the callback
    :func:`z4_matter_system` gives (``models/z4.py::_callbacks``)."""
    q = torch.movedim(Q, var_axis, -1)
    al = q[..., _AL]
    gi, _ = inv3(sym_to_mat(q[..., _G]))
    gdd = gi[..., axis, axis]
    g_of, _ = _slicing(slicing, f)
    return al * torch.sqrt(torch.clamp(g_of(al), min=1.0) * gdd)


# ------------------------------------------------------------ system


def _matter_tag(slicing, f, m, kappa1, kappa2, gamma, iters) -> PhysicsTag:
    return PhysicsTag(
        "z4_matter", 3, N_VARS,
        (slicing, float(f), float(m), float(kappa1), float(kappa2), float(gamma), int(iters)),
    )


def z4_matter_system(
    gamma: float = 5.0 / 3.0,
    iters: int = 10,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    impl: str = "soa",
):
    """(flux_fn, max_eigenvalue_fn, ncp_fn, source_fn) in the solver's
    ``(Q, axis, var_axis)`` contract: :func:`z4_matter_flux`, the vacuum
    wave speed (:func:`z4_matter_eig`), and the NCP and source of
    :func:`z4_matter_rhs_soa` by affinity.  ``impl="soa"`` only (the JAX
    default, ``"einsum"``, raises).  Each callback is tagged
    ``.physics = PhysicsTag("z4_matter", 3, 43, (slicing, f, m, kappa1,
    kappa2, gamma, iters))``."""
    _require_soa(impl)
    kw = dict(gamma=gamma, iters=iters, slicing=slicing, f=f, m=m, kappa1=kappa1,
              kappa2=kappa2)
    g_of, _ = _slicing(slicing, f)

    def flux(Q, axis, va):
        return z4_matter_flux(Q, axis, va, gamma=gamma, iters=iters)

    return _callbacks(lambda q, dq3: z4_matter_rhs_soa(q, dq3, **kw), N_VARS, g_of,
                      _matter_tag(**kw), shifted=False, flux=flux)


def make_z4_matter_solver(
    dim: int,
    order: int,
    grid_shape: tuple,
    dx=1.0,
    gamma: float = 5.0 / 3.0,
    iters: int = 10,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    impl: str = "soa",
    fused_rhs=False,
    **kwargs,
) -> ADERDGSolver:
    """A coupled Z4+GRHD ADER-DG solver on a periodic box (the JAX
    ``make_z4_matter_solver``; ``kwargs`` go to :class:`ADERDGSolver`:
    ``device``, ``dtype``, ``picard_iters``, ``basis``).  ``impl``: ``"soa"``
    only; ``fused_rhs``: ``False`` (per-axis NCP) or ``"soa"`` (the
    one-evaluation ``rhs_all_fn`` hook, which ``with_cuda_rhs`` puts on K5 d
    and ``CudaADERDG`` compiles in); the einsum hook ``True`` raises."""
    _require_fused(fused_rhs)
    kw = dict(gamma=gamma, iters=iters, slicing=slicing, f=f, m=m, kappa1=kappa1,
              kappa2=kappa2)
    flux, eig, ncp, source = z4_matter_system(impl=impl, **kw)
    rhs_all = None
    if fused_rhs == "soa":
        rhs_all = _rhs_all_of(lambda q, dq3: z4_matter_rhs_soa(q, dq3, **kw))
        rhs_all.physics = flux.physics
    return ADERDGSolver(
        dim=dim,
        order=order,
        n_vars=N_VARS,
        grid_shape=grid_shape,
        flux_fn=flux,
        max_eigenvalue_fn=eig,
        ncp_fn=ncp,
        source_fn=source,
        rhs_all_fn=rhs_all,
        dx=dx,
        **kwargs,
    )


def z4_matter_admissible(gamma: float = 5.0 / 3.0, iters: int = 10):
    """Admissibility hook ``ok(Q, var_axis)``: positive lapse, a
    positive-definite spatial metric (leading minors), positive recovered
    density and pressure, subluminal velocity, every slot finite."""

    def ok(Q, var_axis):
        q = torch.movedim(Q, var_axis, -1)
        al = q[..., _AL]
        g = sym_to_mat(q[..., _G])
        m1 = g[..., 0, 0]
        m2 = g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] ** 2
        _, detg = inv3(g)
        rho, v_low, p, W, sqg, gi = recover(q, gamma=gamma, iters=iters)
        v2 = torch.einsum("...ij,...i,...j->...", gi, v_low, v_low)
        fin = torch.all(torch.isfinite(q), dim=-1)
        return (fin & (al > 0) & (m1 > 0) & (m2 > 0) & (detg > 0) & (rho > 0) & (p > 0)
                & (v2 < 1.0))

    return ok


# --------------------------------------------------------------- states


def pack_matter(z4_vals, rho, v_low, p, *, gamma: float = 5.0 / 3.0):
    """Z4 var-last values ``[..., 38]`` and primitives (v_i covariant, a
    var-last 3-vector) → the coupled state ``[..., 43]``, the hydro block
    densitized on the metric inside ``z4_vals`` (tensors)."""
    g = sym_to_mat(z4_vals[..., _G])
    gi, detg = inv3(g)
    sqg = torch.sqrt(detg)
    rho = torch.as_tensor(rho, dtype=z4_vals.dtype, device=z4_vals.device)
    p = torch.as_tensor(p, dtype=z4_vals.dtype, device=z4_vals.device)
    v_low = torch.broadcast_to(
        torch.as_tensor(v_low, dtype=z4_vals.dtype, device=z4_vals.device), rho.shape + (3,))
    v2 = torch.einsum("...ij,...i,...j->...", gi, v_low, v_low)
    W = 1.0 / torch.sqrt(1.0 - v2)
    eps = p / ((gamma - 1.0) * rho)
    h = 1.0 + eps + p / rho
    rhohW2 = rho * h * W * W
    Dt = sqg * rho * W
    St = (sqg * rhohW2)[..., None] * v_low
    taut = sqg * (rhohW2 - p) - Dt
    return torch.cat([z4_vals, Dt[..., None], St, taut[..., None]], dim=-1)


# ---------------------------------------------------------------- FLRW


def flrw_reference(t_end: float, *, rho0: float, eps0: float = 0.0,
                   gamma: float = 5.0 / 3.0, n_rk: int = 200_000,
                   expanding: bool = True):
    """The flat FLRW scale factor by RK4 on the Friedmann system: a Γ-law
    perfect fluid, ρ = ρ₀ a⁻³, ε = ε₀ a^{−3(Γ−1)}, ä/a = −(4π/3)(E + 3p)
    from a(0) = 1 and ȧ(0) = ±√(8πE₀/3).  Returns ``(a, adot)`` at
    ``t_end`` (float64 NumPy arithmetic)."""

    def Ep(a):
        rho = rho0 / a**3
        eps = eps0 / a ** (3.0 * (gamma - 1.0))
        E = rho * (1.0 + eps)
        p = (gamma - 1.0) * rho * eps
        return E, p

    E0, _ = Ep(1.0)
    adot = np.sqrt(8.0 * np.pi * E0 / 3.0) * (1.0 if expanding else -1.0)
    a = 1.0
    h = t_end / n_rk

    def deriv(a, adot):
        E, p = Ep(a)
        return adot, -(4.0 * np.pi / 3.0) * (E + 3.0 * p) * a

    for _ in range(n_rk):
        k1a, k1v = deriv(a, adot)
        k2a, k2v = deriv(a + 0.5 * h * k1a, adot + 0.5 * h * k1v)
        k3a, k3v = deriv(a + 0.5 * h * k2a, adot + 0.5 * h * k2v)
        k4a, k4v = deriv(a + h * k3a, adot + h * k3v)
        a += h / 6.0 * (k1a + 2 * k2a + 2 * k3a + k4a)
        adot += h / 6.0 * (k1v + 2 * k2v + 2 * k3v + k4v)
    return a, adot


def flrw_values(a: float, adot: float, *, rho0: float, eps0: float = 0.0,
                gamma: float = 5.0 / 3.0) -> np.ndarray:
    """The var-last ``[43]`` values of the flat FLRW slice at scale factor
    ``a`` (float64 NumPy): γ_ij = a²δ, K_ij = −aȧδ, α = 1 (geodesic slicing:
    run with ``slicing="harmonic", f=0``), the homogeneous fluid at rest."""
    v = np.zeros(N_VARS)
    v[_AL] = 1.0
    v[1] = v[4] = v[6] = a * a  # γ xx, yy, zz
    v[7] = v[10] = v[12] = -a * adot  # K xx, yy, zz
    rho = rho0 / a**3
    eps = eps0 / a ** (3.0 * (gamma - 1.0))
    p = (gamma - 1.0) * rho * eps
    sqg = a**3
    h = 1.0 + eps + p / rho
    v[_HD] = sqg * rho
    v[_HTAU] = sqg * (rho * h - p) - v[_HD]
    return v


def flrw_state(solver, a: float, adot: float, *, rho0: float, eps0: float = 0.0,
               gamma: float = 5.0 / 3.0) -> torch.Tensor:
    """The homogeneous FLRW nodal state on ``solver`` (its dtype and
    device)."""
    vals = flrw_values(a, adot, rho0=rho0, eps0=eps0, gamma=gamma)
    shape = solver.state_shape[: solver.var_axis] + solver.state_shape[solver.var_axis + 1:]
    return _on_solver(solver, np.broadcast_to(vals, shape + (N_VARS,)))
