"""Coupled magnetized matter and dynamic spacetime: Z4 + GRMHD (PyTorch).

Port of ``exahype_tpu/models/z4_grmhd.py`` on its production path
(``impl="soa"``, ``fused_rhs="soa"``): the magnetized extension of
``models/z4_matter.py``.  47 variables, var-last in the ``*_rhs``
functions: the 38 zero-shift Z4 variables, the densitized Valencia block,
then the densitized field and the GLM cleaning scalar

    Q = [α, γ_ij, K_ij, Θ, Z_i, A_k, D_kij,  D̃, S̃_i (3), τ̃,  B̃^i (3), φ̃]

with B̃^i = √γ B^i.  Ideal-MHD closure on the zero-shift slice (b^μ the
fluid-frame field): b² = B²/W² + (v·B)², p* = p + b²/2, ρh* = ρh + b²;
D = ρW, S_i = (ρhW² + B²)v_i − (v·B)B_i, τ = ρh*W² − p* − (W v·B)² − D.
The fluxes are the magnetized Valencia rows, the induction rows and the
GLM pair at the coordinate speed α c_h (``z4_grmhd_flux``); the Z4 sector
takes the trace-reversed TOTAL (fluid and field) stress-energy, the hydro
block its geometric sources with the total S^ik, the field rows none, and
φ̃ the damping −κ α φ̃ (``glm_kappa``).  No matter term reads a derivative,
so the right-hand side stays affine in ∂Q and the solver's NCP/source split
follows by linearity, as in ``models/z4.py``.

The recovery is ``models/rmhd.py``'s safeguarded Newton fed the metric's
scalars (|S|²_γ, S·B, |B|²_γ): ``recover`` through the flat vector form on
a field-aligned proxy state (the flux's), the algebra through the scalar
core ``con2prim_scalar`` (its kernels' too).

Each callback carries ``.physics = PhysicsTag("z4_grmhd", 3, 47, (slicing,
f, m, kappa1, kappa2, gamma, iters, c_h, glm_kappa))``, which the kernel
wrappers read (``models/aderdg_cuda.py``: the K1 d kernels over
``csrc/z4_grmhd.cuh``; ``models/rhs_cuda.py``: K5 e).  The einsum
formulation (``impl="einsum"``, the JAX default: ``z4_grmhd_rhs``) and its
fused hook (``fused_rhs=True``) are not ported and raise
:class:`SemanticError` (``ROADMAP.md``, Queue 1 item 7.4).

Reference caveat, mirrored and not repaired: the guards ``max(|B|,
1e-300)`` and ``max(v², 1e-300)`` are 0 in float32, so a point whose field
is exactly zero recovers NaN there (0/0 in S_∥), as in the JAX package;
float64 recovers it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from exahype_tpu_torch.models import rmhd
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

N_MHD = 9
N_VARS = N_Z4 + N_MHD  # 47

_HD = N_Z4  # D̃
_HS = slice(N_Z4 + 1, N_Z4 + 4)  # S̃_i
_HTAU = N_Z4 + 4  # τ̃
_HB = slice(N_Z4 + 5, N_Z4 + 8)  # B̃^i
_HPSI = N_Z4 + 8  # φ̃


# ------------------------------------------------------------- recovery


def recover(q, *, gamma: float = 5.0 / 3.0, iters: int = 20):
    """Curved-metric magnetized con2prim on the var-last coupled state.

    Returns ``(rho, v_low[3], p, W, vB, sqg, gi)``: the primitives with the
    covariant velocity, v·B = v_i B^i, √γ and the inverse metric.  The flat
    :func:`rmhd.con2prim` runs on the field-aligned proxy state (the same D,
    τ, |S|, S·B and |B|); v_i follows from the recovered z = ρhW², clamped
    subluminal in the real metric."""
    g = sym_to_mat(q[..., _G])
    gi, detg = inv3(g)
    sqg = torch.sqrt(detg)
    D = q[..., _HD] / sqg
    S = q[..., _HS] / sqg[..., None]  # lower index
    tau = q[..., _HTAU] / sqg
    Bup = q[..., _HB] / sqg[..., None]  # upper index
    B_low = torch.einsum("...ij,...j->...i", g, Bup)
    S2 = torch.einsum("...ij,...i,...j->...", gi, S, S)
    B2 = torch.einsum("...i,...i->...", Bup, B_low)
    sB = torch.einsum("...i,...i->...", S, Bup)
    Bmag = torch.sqrt(torch.clamp(B2, min=0.0))
    # The proxy: B̄ along x, S̄ in the x-y plane.
    S_par = sB / torch.clamp(Bmag, min=1e-300)
    S_perp = torch.sqrt(torch.clamp(S2 - S_par * S_par, min=0.0))
    zeros = torch.zeros_like(D)
    flat = torch.stack([D, S_par, S_perp, zeros, tau, Bmag, zeros, zeros, zeros], dim=-1)
    rho, _, p, W = rmhd.con2prim(flat, gamma=gamma, iters=iters)
    h = 1.0 + gamma / (gamma - 1.0) * p / rho
    z = rho * h * W * W
    v_low = (S + (sB / z)[..., None] * B_low) / (z + B2)[..., None]
    v2 = torch.einsum("...ij,...i,...j->...", gi, v_low, v_low)
    scale = torch.sqrt((1.0 - 1e-12) / torch.clamp(v2, min=1e-300))
    v_low = v_low * torch.clamp(scale, max=1.0)[..., None]
    v2 = torch.clamp(v2, 0.0, 1.0 - 1e-12)
    W = 1.0 / torch.sqrt(1.0 - v2)
    vB = torch.einsum("...i,...i->...", v_low, Bup)
    return rho, v_low, p, W, vB, sqg, gi


def stress_energy(q, *, gamma: float = 5.0 / 3.0, iters: int = 20):
    """The TOTAL (fluid and field) matter projections ``(E, S_i, S_ij,
    trace S)`` from the coupled state."""
    g = sym_to_mat(q[..., _G])
    rho, v_low, p, W, vB, sqg, gi = recover(q, gamma=gamma, iters=iters)
    Bup = q[..., _HB] / sqg[..., None]
    B_low = torch.einsum("...ij,...j->...i", g, Bup)
    B2 = torch.einsum("...i,...i->...", Bup, B_low)
    b2 = B2 / (W * W) + vB * vB
    ptot = p + 0.5 * b2
    h = 1.0 + gamma / (gamma - 1.0) * p / rho
    whW2 = rho * h * W * W + b2 * W * W  # ρh* W²
    b_low = B_low / W[..., None] + (W * vB)[..., None] * v_low
    E = whW2 - ptot - (W * vB) ** 2
    S_low = whW2[..., None] * v_low - (W * vB)[..., None] * b_low
    S_ij = (whW2[..., None, None] * torch.einsum("...i,...j->...ij", v_low, v_low)
            + ptot[..., None, None] * g
            - torch.einsum("...i,...j->...ij", b_low, b_low))
    v2 = torch.einsum("...ij,...i,...j->...", gi, v_low, v_low)
    bib_up = b2 + (W * vB) ** 2  # b_i b^i
    S_tr = whW2 * v2 + 3.0 * ptot - bib_up
    return E, S_low, S_ij, S_tr


# ------------------------------------------------------------------ RHS


def z4_grmhd_rhs_soa(
    q,
    dq3,
    *,
    gamma: float = 5.0 / 3.0,
    iters: int = 20,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    glm_kappa: float = 0.0,
):
    """The coupled right-hand side without the conservative flux
    divergence, component-unrolled: the vacuum SoA core, the total
    stress-energy terms on (K, Θ, Z), the hydro geometric sources with the
    total S^ik, zero field rows and the GLM damping, in the JAX
    ``z4_grmhd_rhs_soa``'s operation order (``csrc/z4_grmhd.cuh`` follows
    it; the recovery is the scalar core).  ``q`` var-last ``[..., 47]``,
    ``dq3`` ``[..., 3, 47]``; affine in ``dq3``."""
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
    Btil = _vec_obj(q, _HB)
    Dh = Dt / sqg
    tau = taut / sqg
    S_low = np.empty((3,), dtype=object)
    Bup = np.empty((3,), dtype=object)
    for i in range(3):
        S_low[i] = St[i] / sqg
        Bup[i] = Btil[i] / sqg
    B_low = _oein("ij,j->i", g, Bup)
    S2 = _oein("ij,i,j->", gi, S_low, S_low)
    B2 = _oein("i,i->", Bup, B_low)
    sB = _oein("i,i->", S_low, Bup)
    Bmag = torch.sqrt(torch.clamp(B2, min=0.0))
    S_par = sB / torch.clamp(Bmag, min=1e-300)
    S_perp = torch.sqrt(torch.clamp(S2 - S_par * S_par, min=0.0))
    rho, p, W = rmhd.con2prim_scalar(Dh, S_par, S_perp, tau, Bmag, gamma=gamma, iters=iters)
    h_f = 1.0 + gamma / (gamma - 1.0) * p / rho
    z = rho * h_f * W * W
    v_low = np.empty((3,), dtype=object)
    for i in range(3):
        v_low[i] = (S_low[i] + (sB / z) * B_low[i]) / (z + B2)
    v2 = _oein("ij,i,j->", gi, v_low, v_low)
    scale = torch.clamp(torch.sqrt((1.0 - 1e-12) / torch.clamp(v2, min=1e-300)), max=1.0)
    for i in range(3):
        v_low[i] = v_low[i] * scale
    v2 = torch.clamp(v2 * scale * scale, 0.0, 1.0 - 1e-12)
    W = 1.0 / torch.sqrt(1.0 - v2)
    vB = _oein("i,i->", v_low, Bup)
    b2 = B2 / (W * W) + vB * vB
    ptot = p + 0.5 * b2
    whW2 = rho * h_f * W * W + b2 * W * W
    b_low = np.empty((3,), dtype=object)
    for i in range(3):
        b_low[i] = B_low[i] / W + (W * vB) * v_low[i]
    E = whW2 - ptot - (W * vB) ** 2
    Sm_low = np.empty((3,), dtype=object)
    for i in range(3):
        Sm_low[i] = whW2 * v_low[i] - (W * vB) * b_low[i]
    bib_up = b2 + (W * vB) ** 2
    S_tr = whW2 * v2 + 3.0 * ptot - bib_up
    # The total stress-energy on the Z4 sector.
    half_tr = 0.5 * (S_tr - E)
    for i in range(3):
        for j in range(3):
            S_ij = whW2 * v_low[i] * v_low[j] + ptot * g[i, j] - b_low[i] * b_low[j]
            r_K[i, j] = r_K[i, j] - EIGHT_PI * al * (S_ij - half_tr * g[i, j])
    r_th = r_th - EIGHT_PI * al * E
    for i in range(3):
        r_Z[i] = r_Z[i] - EIGHT_PI * al * Sm_low[i]

    # The hydro geometric sources with the total S^ik.
    v_up = _oein("ij,j->i", gi, v_low)
    b_up = np.empty((3,), dtype=object)
    for i in range(3):
        b_up[i] = Bup[i] / W + (W * vB) * v_up[i]
    Sup = np.empty((3, 3), dtype=object)
    for i in range(3):
        for j in range(3):
            Sup[i, j] = whW2 * v_up[i] * v_up[j] + ptot * gi[i, j] - b_up[i] * b_up[j]
    asg = al * sqg
    r_S = _oein("ik,jik->j", Sup, D)
    SupK = _oein("ik,ik->", Sup, K)
    S_up_vec = _oein("ij,j->i", gi, Sm_low)
    SA = _oein("k,k->", S_up_vec, A)
    extra = [torch.zeros_like(al)]
    for j in range(3):
        extra.append(asg * (r_S[j] - E * A[j]))
    extra.append(asg * (SupK - SA))
    for _ in range(3):
        extra.append(torch.zeros_like(al))
    extra.append(-glm_kappa * al * q[..., _HPSI])
    return _z4_pack_soa(r_al, r_g, r_K, r_th, r_Z, r_A, r_D, extra=tuple(extra))


def z4_grmhd_flux(Q, axis, var_axis, *, gamma: float = 5.0 / 3.0, iters: int = 20,
                  c_h: float = 1.0):
    """The conservative flux along grid ``axis`` from one :func:`recover`:
    the magnetized Valencia rows on the dynamic metric, the induction rows
    and the GLM pair; zero Z4 rows."""
    q = torch.movedim(Q, var_axis, -1)
    al = q[..., _AL]
    rho, v_low, p, W, vB, sqg, gi = recover(q, gamma=gamma, iters=iters)
    g = sym_to_mat(q[..., _G])
    Bt = q[..., _HB]  # B̃^i
    Bup = Bt / sqg[..., None]
    B_low = torch.einsum("...ij,...j->...i", g, Bup)
    B2 = torch.einsum("...i,...i->...", Bup, B_low)
    b2 = B2 / (W * W) + vB * vB
    ptot = p + 0.5 * b2
    v_up = torch.einsum("...ij,...j->...i", gi, v_low)
    vd = v_up[..., axis]
    Bd = Bup[..., axis]
    Dt = q[..., _HD]
    St = q[..., _HS]
    taut = q[..., _HTAU]
    psi = q[..., _HPSI]
    psg = ptot * sqg
    # The pressure and φ̃ enter the ``axis`` rows only.
    onehot = torch.zeros(3, dtype=q.dtype, device=q.device)
    onehot[axis] = 1.0
    f_D = al * Dt * vd
    f_S = (al[..., None] * (St * vd[..., None]) + (al * psg)[..., None] * onehot
           - (al * sqg * Bd)[..., None] * (B_low / (W * W)[..., None] + vB[..., None] * v_low))
    f_tau = al * ((taut + psg) * vd - sqg * vB * Bd)
    f_B = (al[..., None] * (vd[..., None] * Bt - Bt[..., axis:axis + 1] * v_up)
           + (al * psi)[..., None] * onehot)
    f_psi = al * c_h * c_h * Bt[..., axis]
    out = torch.cat(
        [torch.zeros(q.shape[:-1] + (N_Z4,), dtype=q.dtype, device=q.device),
         f_D[..., None], f_S, f_tau[..., None], f_B, f_psi[..., None]],
        dim=-1,
    )
    return torch.movedim(out, -1, var_axis)


def z4_grmhd_eig(Q, axis, var_axis, *, slicing: str = "harmonic", f: float = 1.0,
                 c_h: float = 1.0):
    """The Rusanov bound: the widest of the gauge cone, the light cone (the
    magnetosonic speeds lie inside it) and the cleaning speed,
    α max(√(max(g(α), 1) γ^dd), c_h)."""
    q = torch.movedim(Q, var_axis, -1)
    al = q[..., _AL]
    gi, _ = inv3(sym_to_mat(q[..., _G]))
    gdd = gi[..., axis, axis]
    g_of, _ = _slicing(slicing, f)
    cone = torch.sqrt(torch.clamp(g_of(al), min=1.0) * gdd)
    return al * torch.clamp(cone, min=c_h)


# ------------------------------------------------------------ system


def _grmhd_tag(slicing, f, m, kappa1, kappa2, gamma, iters, c_h, glm_kappa) -> PhysicsTag:
    return PhysicsTag(
        "z4_grmhd", 3, N_VARS,
        (slicing, float(f), float(m), float(kappa1), float(kappa2), float(gamma), int(iters),
         float(c_h), float(glm_kappa)),
    )


def z4_grmhd_system(
    gamma: float = 5.0 / 3.0,
    iters: int = 20,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    c_h: float = 1.0,
    glm_kappa: float = 0.0,
    impl: str = "soa",
):
    """(flux_fn, max_eigenvalue_fn, ncp_fn, source_fn) in the solver's
    ``(Q, axis, var_axis)`` contract: :func:`z4_grmhd_flux`,
    :func:`z4_grmhd_eig`, and the NCP and source of :func:`z4_grmhd_rhs_soa`
    by affinity.  ``impl="soa"`` only (the JAX default, ``"einsum"``,
    raises).  Each callback is tagged ``.physics = PhysicsTag("z4_grmhd",
    3, 47, (slicing, f, m, kappa1, kappa2, gamma, iters, c_h,
    glm_kappa))``."""
    _require_soa(impl)
    kw = dict(gamma=gamma, iters=iters, slicing=slicing, f=f, m=m, kappa1=kappa1,
              kappa2=kappa2, glm_kappa=glm_kappa)
    g_of, _ = _slicing(slicing, f)

    def flux(Q, axis, va):
        return z4_grmhd_flux(Q, axis, va, gamma=gamma, iters=iters, c_h=c_h)

    def eig(Q, axis, va):
        return z4_grmhd_eig(Q, axis, va, slicing=slicing, f=f, c_h=c_h)

    return _callbacks(lambda q, dq3: z4_grmhd_rhs_soa(q, dq3, **kw), N_VARS, g_of,
                      _grmhd_tag(c_h=c_h, **kw), shifted=False, flux=flux, eig=eig)


def make_z4_grmhd_solver(
    dim: int,
    order: int,
    grid_shape: tuple,
    dx=1.0,
    gamma: float = 5.0 / 3.0,
    iters: int = 20,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    c_h: float = 1.0,
    glm_kappa: float = 0.0,
    impl: str = "soa",
    fused_rhs=False,
    **kwargs,
) -> ADERDGSolver:
    """A coupled Z4+GRMHD ADER-DG solver on a periodic box (the JAX
    ``make_z4_grmhd_solver``; ``kwargs`` go to :class:`ADERDGSolver`:
    ``device``, ``dtype``, ``picard_iters``, ``basis``).  ``impl``:
    ``"soa"`` only; ``fused_rhs``: ``False`` (per-axis NCP) or ``"soa"``
    (the one-evaluation ``rhs_all_fn`` hook, which ``with_cuda_rhs`` puts on
    K5 e and ``CudaADERDG`` compiles in); the einsum hook ``True``
    raises."""
    _require_fused(fused_rhs)
    kw = dict(gamma=gamma, iters=iters, slicing=slicing, f=f, m=m, kappa1=kappa1,
              kappa2=kappa2, glm_kappa=glm_kappa)
    flux, eig, ncp, source = z4_grmhd_system(c_h=c_h, impl=impl, **kw)
    rhs_all = None
    if fused_rhs == "soa":
        rhs_all = _rhs_all_of(lambda q, dq3: z4_grmhd_rhs_soa(q, dq3, **kw))
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


def z4_grmhd_admissible(gamma: float = 5.0 / 3.0, iters: int = 20):
    """Admissibility hook ``ok(Q, var_axis)``: positive lapse, a
    positive-definite spatial metric (leading minors), a positive magnetized
    recovery, subluminal velocity, every slot finite."""

    def ok(Q, var_axis):
        q = torch.movedim(Q, var_axis, -1)
        al = q[..., _AL]
        g = sym_to_mat(q[..., _G])
        m1 = g[..., 0, 0]
        m2 = g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] ** 2
        _, detg = inv3(g)
        rho, v_low, p, W, vB, sqg, gi = recover(q, gamma=gamma, iters=iters)
        v2 = torch.einsum("...ij,...i,...j->...", gi, v_low, v_low)
        fin = torch.all(torch.isfinite(q), dim=-1)
        return (fin & (al > 0) & (m1 > 0) & (m2 > 0) & (detg > 0) & (rho > 0) & (p > 0)
                & (v2 < 1.0))

    return ok


# --------------------------------------------------------------- states


def pack_matter_mhd(z4_vals, rho, v_low, p, B_up, *, gamma: float = 5.0 / 3.0,
                    psi_glm=0.0):
    """Z4 var-last values ``[..., 38]`` and primitives (v_i covariant, B^i
    contravariant, var-last 3-vectors) → the coupled state ``[..., 47]``,
    densitized on the metric inside ``z4_vals`` (tensors)."""
    like = dict(dtype=z4_vals.dtype, device=z4_vals.device)
    g = sym_to_mat(z4_vals[..., _G])
    gi, detg = inv3(g)
    sqg = torch.sqrt(detg)
    rho = torch.as_tensor(rho, **like)
    p = torch.as_tensor(p, **like)
    v_low = torch.broadcast_to(torch.as_tensor(v_low, **like), rho.shape + (3,))
    B_up = torch.broadcast_to(torch.as_tensor(B_up, **like), rho.shape + (3,))
    B_low = torch.einsum("...ij,...j->...i", g, B_up)
    B2 = torch.einsum("...i,...i->...", B_up, B_low)
    v2 = torch.einsum("...ij,...i,...j->...", gi, v_low, v_low)
    vB = torch.einsum("...i,...i->...", v_low, B_up)
    W = 1.0 / torch.sqrt(1.0 - v2)
    eps = p / ((gamma - 1.0) * rho)
    h = 1.0 + eps + p / rho
    z = rho * h * W * W
    b2 = B2 / (W * W) + vB * vB
    ptot = p + 0.5 * b2
    b_low = B_low / W[..., None] + (W * vB)[..., None] * v_low
    whW2 = z + b2 * W * W
    Dt = sqg * rho * W
    St = sqg[..., None] * (whW2[..., None] * v_low - (W * vB)[..., None] * b_low)
    taut = sqg * (whW2 - ptot - (W * vB) ** 2) - Dt
    Bt = sqg[..., None] * B_up
    psit = torch.broadcast_to(torch.as_tensor(psi_glm, **like), Dt.shape)
    return torch.cat([z4_vals, Dt[..., None], St, taut[..., None], Bt, psit[..., None]],
                     dim=-1)


def magnetized_wave_state(solver, B0: float = 0.05, amp: float = 0.05) -> torch.Tensor:
    """The magnetized wave of the JAX package's tests
    (``tests/test_z4_grmhd.py::_magnetized_wave_state``) at every node of
    ``solver``, in its dtype on its device: along grid axis 0, with one
    period over the axis's length L (on a unit axis, the JAX test's state),
    k = 2π/L, a weakly curved slice γ_xx = 1 + amp sin kx with D_xxx = ½
    ∂_x γ_xx, ρ = 1 + 0.1 sin kx, p = 1 + 0.05 cos kx, v_y = 0.1 sin kx,
    B^x = B0, B^z = 0.3 B0 cos kx (values formed in float64 NumPy)."""
    coords = solver.nodes_meshgrid()
    x = np.broadcast_to(
        np.squeeze(np.asarray(coords[0]), axis=solver.var_axis),
        solver.state_shape[: solver.var_axis] + solver.state_shape[solver.var_axis + 1:],
    )
    k = 2.0 * np.pi / (solver.grid_shape[0] * solver._dxs[0])
    z4 = np.zeros(x.shape + (N_Z4,))
    z4[..., 0] = 1.0
    z4[..., 1] = 1.0 + amp * np.sin(k * x)  # γ_xx
    z4[..., 4] = z4[..., 6] = 1.0
    z4[..., 20] = 0.5 * amp * k * np.cos(k * x)  # D_xxx
    rho = 1.0 + 0.1 * np.sin(k * x)
    p = 1.0 + 0.05 * np.cos(k * x)
    v = np.zeros(x.shape + (3,))
    v[..., 1] = 0.1 * np.sin(k * x)
    B = np.zeros(x.shape + (3,))
    B[..., 0] = B0
    B[..., 2] = 0.3 * B0 * np.cos(k * x)
    q = pack_matter_mhd(*(torch.from_numpy(a) for a in (z4, rho, v, p, B)))
    return _on_solver(solver, q.numpy())
