"""First-order Z4, vacuum: dynamic-spacetime GR (PyTorch).

Port of the 38-variable zero-shift system and the 53-variable shifted
system of ``exahype_tpu/models/z4.py`` on their production path
(``impl="soa"``, ``fused_rhs="soa"``): the slot constants,
``sym_to_mat``/``mat_to_sym``/``inv3``, the component-unrolled right-hand
sides ``z4_rhs_soa`` and ``z4_shift_rhs_soa`` (``_oein``, ``_omap``,
``_osym``, ``_oinv3``, the SoA unpack/pack and ``_z4_core_soa``), the solver
quadruples ``z4_system`` and ``z4_shift_system``, the fused hook
``_rhs_all_of``, ``make_z4_solver`` and ``make_z4_shift_solver``, the flat,
gauge-wave and moving gauge-wave states, and the ADM constraint monitor.
The JAX module loads JAX, so the port keeps its own copy.

The variables are α (1), γ_ij (6), K_ij (6), Θ (1), Z_i (3), A_k = ∂_k ln α
(3) and D_kij = ½ ∂_k γ_ij (18); the right-hand side ``rhs(Q, ∂Q)`` is
affine in the derivatives, so the solver's split follows by linearity:

    source(Q)      = rhs(Q, 0)
    B_d(Q)·∂_d Q   = rhs(Q, 0) − rhs(Q, ∂_d Q only)
    rhs_all(Q, ∇Q) = rhs(Q, ∇Q)

The SoA algebra holds tensors as NumPy *object* arrays whose entries are
torch tensors over the grid; every contraction unrolls into elementwise
tensor arithmetic in the reference's operation order (``_oein``: output
indices in order, contracted indices in sorted letter order, operands
multiplied left to right, the sum started from the first term).  That order
is also the one ``csrc/z4.cuh`` follows, so the kernel (K5,
``models/rhs_cuda.py``) differs from this plain version by fused
multiply-adds only.

The shifted system adds the gauge sector β^i (slots 38-40), the
Gamma-driver's b^i (41-43) and B_k^i = ∂_k β^i (44 + 3k + i), the
Lie-derivative terms of every core variable, and either a frozen shift
(``shift="frozen"``: the sector does not evolve) or the Gamma-driver
(``shift="gamma_driver"``: ∂_t β = f_b b, ∂_t b = ∂_t Γ^i − η b, ∂_t B = f_b
∂b, with ∂_t Γ^i by the explicit chain rule of the JAX ``z4_shift_rhs_soa``).

Each callback carries ``.physics = PhysicsTag("z4", 3, 38, (slicing, f, m,
kappa1, kappa2))`` or ``PhysicsTag("z4_shift", 3, 53, (slicing, f, m,
kappa1, kappa2, shift, f_b, eta))``, which the kernel wrappers read.  The
einsum formulation (``impl="einsum"``, the JAX default: ``z4_rhs``, and
for the shifted system ``z4_shift_rhs`` with its ``jax.jvp`` Gamma-driver
term ``_gamma_contracted``) and its fused hook (``fused_rhs=True``) are
not ported and raise :class:`SemanticError` (``ROADMAP.md``, Queue 1 item
7.4); the coupled Z4+GRHD system is ``models/z4_matter.py``, Z4+GRMHD
``models/z4_grmhd.py``.  The
constraint monitor uses ``torch.einsum``, as the JAX one uses
``jnp.einsum``.
"""

from __future__ import annotations

from itertools import product

import numpy as np
import torch

from exahype_tpu_torch.models.aderdg import ADERDGSolver, PhysicsTag
from exahype_tpu_torch.utils.errors import SemanticError

#: Packed symmetric-pair order for 3×3 symmetric tensors.
SYM6 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))

N_VARS = 38
N_VARS_SHIFT = 53

# Variable slots.
_AL = 0
_G = slice(1, 7)
_K = slice(7, 13)
_TH = 13
_Z = slice(14, 17)
_A = slice(17, 20)
_D = slice(20, 38)
# The shifted system's gauge sector: β^i, the Gamma-driver's b^i, and
# B_k^i = ∂_k β^i at 44 + 3k + i.
_BETA = slice(38, 41)
_BSM = slice(41, 44)
_BB = slice(44, 53)

#: The slicing conditions, by name, and the id the CUDA kernel takes.
SLICINGS = {"harmonic": 0, "1+log": 1}
#: The shift conditions of the shifted system, and the id the CUDA kernels take.
SHIFTS = {"frozen": 0, "gamma_driver": 1}


def sym_to_mat(s):
    """[..., 6] packed symmetric → [..., 3, 3]."""
    rows = [[None] * 3 for _ in range(3)]
    for slot, (i, j) in enumerate(SYM6):
        rows[i][j] = s[..., slot]
        rows[j][i] = s[..., slot]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def mat_to_sym(m):
    """[..., 3, 3] (symmetrized) → [..., 6] packed."""
    m = 0.5 * (m + m.transpose(-1, -2))
    return torch.stack([m[..., i, j] for (i, j) in SYM6], dim=-1)


def inv3(m):
    """Closed-form batched 3×3 inverse: (inverse, det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = f * g - d * i
    cc = d * h - e * g
    det = a * ca + b * cb + c * cc
    adj = torch.stack(
        [
            torch.stack([ca, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([cb, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([cc, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None], det


def unpack(q):
    """q[..., 38] → (α, γ[3,3], K[3,3], Θ, Z[3], A[3], D[3,3,3])."""
    al = q[..., _AL]
    g = sym_to_mat(q[..., _G])
    K = sym_to_mat(q[..., _K])
    th = q[..., _TH]
    Z = q[..., _Z]
    A = q[..., _A]
    D = sym_to_mat(q[..., _D].reshape(q.shape[:-1] + (3, 6)))
    return al, g, K, th, Z, A, D


def _slicing(slicing: str, f: float):
    """(g(α), d(αg)/dα) as callables of α."""
    if slicing == "harmonic":
        return (lambda al: torch.full_like(al, f)), (
            lambda al: torch.full_like(al, f)
        )
    if slicing == "1+log":
        # αg = 2 exactly, so d(αg)/dα = 0.
        return (lambda al: 2.0 / al), (lambda al: torch.zeros_like(al))
    raise ValueError(f"unknown slicing {slicing!r}")


# ------------------------------------------------- SoA-unrolled evaluation


def _oein(spec, *ops):
    """Einsum over object ndarrays of grid tensors, unrolled.

    All indices have extent 3.  Supports an optional '->' (no broadcast
    '...'; scalars come back as bare entries)."""
    spec = spec.replace(" ", "")
    if "->" in spec:
        lhs, out = spec.split("->")
    else:
        lhs = spec
        counts = {}
        for ch in lhs.replace(",", ""):
            counts[ch] = counts.get(ch, 0) + 1
        out = "".join(sorted(ch for ch, n in counts.items() if n == 1))
    ins = lhs.split(",")
    contracted = sorted({ch for sub in ins for ch in sub if ch not in out})
    res = np.empty((3,) * len(out), dtype=object)
    for oa in product(range(3), repeat=len(out)):
        env = dict(zip(out, oa))
        acc = None
        for ca in product(range(3), repeat=len(contracted)):
            env.update(zip(contracted, ca))
            term = None
            for op, sub in zip(ops, ins):
                v = op[tuple(env[c] for c in sub)]
                term = v if term is None else term * v
            acc = term if acc is None else acc + term
        res[oa] = acc
    return res if out else res[()]


def _omap(fn, *Ts):
    """Elementwise map over object ndarrays (scalar×tensor etc.)."""
    return np.frompyfunc(fn, len(Ts), 1)(*Ts)


def _osym(T):
    """Symmetrize an object (3, 3) array in its two indices."""
    return _omap(lambda a, b: 0.5 * (a + b), T, T.T)


def _oinv3(G):
    """Cofactor inverse of an object (3, 3) array: (inverse, det)."""
    a, b, c = G[0, 0], G[0, 1], G[0, 2]
    d, e, f = G[1, 0], G[1, 1], G[1, 2]
    g_, h, i = G[2, 0], G[2, 1], G[2, 2]
    ca = e * i - f * h
    cb = f * g_ - d * i
    cc = d * h - e * g_
    det = a * ca + b * cb + c * cc
    inv_det = 1.0 / det
    rows = [
        [ca, c * h - b * i, b * f - c * e],
        [cb, a * i - c * g_, c * d - a * f],
        [cc, b * g_ - a * h, a * e - b * d],
    ]
    out = np.empty((3, 3), dtype=object)
    for ii in range(3):
        for jj in range(3):
            out[ii, jj] = rows[ii][jj] * inv_det
    return out, det


def _sym_obj(q, sl):
    """Pack a 6-slot symmetric slice of q into an object (3, 3) array."""
    out = np.empty((3, 3), dtype=object)
    base = sl.start
    for slot, (i, j) in enumerate(SYM6):
        out[i, j] = q[..., base + slot]
        out[j, i] = out[i, j]
    return out


def _vec_obj(q, sl):
    out = np.empty((3,), dtype=object)
    for i in range(3):
        out[i] = q[..., sl.start + i]
    return out


def _z4_unpack_soa(q, dq3):
    """Slice a var-last state ``q[..., V]`` and its 3-direction derivative
    stack ``dq3[..., 3, V]`` into object-array tensors (entries are
    grid-shaped tensors)."""
    al = q[..., _AL]
    g = _sym_obj(q, _G)
    K = _sym_obj(q, _K)
    th = q[..., _TH]
    Z = _vec_obj(q, _Z)
    A = _vec_obj(q, _A)
    D = np.empty((3, 3, 3), dtype=object)
    dK = np.empty((3, 3, 3), dtype=object)
    dth = np.empty((3,), dtype=object)
    dZ = np.empty((3, 3), dtype=object)
    dA = np.empty((3, 3), dtype=object)
    dD = np.empty((3, 3, 3, 3), dtype=object)
    for k in range(3):
        for slot, (i, j) in enumerate(SYM6):
            D[k, i, j] = D[k, j, i] = q[..., _D.start + 6 * k + slot]
            dK[k, i, j] = dK[k, j, i] = dq3[..., k, _K.start + slot]
        dth[k] = dq3[..., k, _TH]
        for i in range(3):
            dZ[k, i] = dq3[..., k, _Z.start + i]
            dA[k, i] = dq3[..., k, _A.start + i]
        for l in range(3):
            for slot, (i, j) in enumerate(SYM6):
                dD[k, l, i, j] = dD[k, l, j, i] = dq3[..., k, _D.start + 6 * l + slot]
    return al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD


def _z4_pack_soa(r_al, r_g, r_K, r_th, r_Z, r_A, r_D, extra=()):
    """Symmetrize the (i, j) pairs and stack into the packed var axis
    (last), the shifted system's ``extra`` slots after the 38."""
    parts = [r_al]
    r_g = _osym(r_g)
    r_K = _osym(r_K)
    for (i, j) in SYM6:
        parts.append(r_g[i, j])
    for (i, j) in SYM6:
        parts.append(r_K[i, j])
    parts.append(r_th)
    parts.extend(r_Z[i] for i in range(3))
    parts.extend(r_A[i] for i in range(3))
    for k in range(3):
        rDs = _osym(r_D[k])
        for (i, j) in SYM6:
            parts.append(rDs[i, j])
    parts.extend(extra)
    return torch.stack(parts, dim=-1)


def z4_rhs_soa(
    q,
    dq3,
    *,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
):
    """The complete vacuum Z4 right-hand side ∂_t Q (zero shift),
    component-unrolled.

    ``q`` var-last ``[..., 38]``, ``dq3`` ``[..., 3, 38]`` (∂_k Q for k =
    x, y, z; zero-fill the axes a lower-dimensional grid does not have).
    Affine in ``dq3``.  (The JAX function's ``var_first`` layout exists for
    the Mosaic kernel; the CUDA kernel reads the solver's own layout.)"""
    al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD = _z4_unpack_soa(q, dq3)
    parts = _z4_core_soa(
        al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD,
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
    )
    return _z4_pack_soa(*parts)


def _z4_core_soa(al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD, *,
                 slicing, f, m, kappa1, kappa2):
    """Zero-shift Z4 RHS parts on object-array tensors.  Returns raw
    (unsymmetrized) parts.  ``csrc/z4.cuh`` follows it stage by stage."""
    E = _oein
    gi, _ = _oinv3(g)
    dgi = _omap(lambda x: -2.0 * x, E("la,mb,kab->klm", gi, gi, D))
    Glow = (
        np.transpose(D, (2, 0, 1)) + np.transpose(D, (2, 1, 0)) - D
    )
    Gam = E("kl,lij->kij", gi, Glow)
    Gtr = E("kl,jkl->j", gi, D)
    dGlow = (
        np.transpose(dD, (0, 3, 1, 2))
        + np.transpose(dD, (0, 3, 2, 1))
        - dD
    )
    ric = (
        E("kkl,lij->ij", dgi, Glow)
        + E("kl,klij->ij", gi, dGlow)
        - E("ikl,jkl->ij", dgi, D)
        - E("kl,ijkl->ij", gi, dD)
        + E("l,lij->ij", Gtr, Gam)
        - E("kli,lkj->ij", Gam, Gam)
    )
    ric = _osym(ric)

    hess = (
        _osym(dA) + E("i,j->ij", A, A) - E("kij,k->ij", Gam, A)
    )
    covZ = dZ - E("kij,k->ij", Gam, Z)
    trK = E("ij,ij->", gi, K)
    Kup = E("ia,jb,ab->ij", gi, gi, K)
    K2 = E("ij,ij->", K, Kup)
    KK = E("il,lm,mj->ij", K, gi, K)
    Kmix = E("jl,il->ij", gi, K)
    divKi = (
        E("jl,jil->i", gi, dK)
        - E("jl,mji,ml->i", gi, Gam, K)
        - E("jl,mjl,im->i", gi, Gam, K)
    )
    dtrK = E("ikl,kl->i", dgi, K) + E("kl,ikl->i", gi, dK)
    Rs = E("ij,ij->", gi, ric)
    divZ = E("ij,ij->", gi, covZ)
    Zup = E("ij,j->i", gi, Z)

    g_of, dag_of = _slicing(slicing, f)
    gal = g_of(al)
    ag = al * gal
    dag = dag_of(al)
    Kmth = trK - m * th

    r_al = -ag * al * Kmth
    r_g = _omap(lambda x: -2.0 * al * x, K)
    r_K = _omap(
        lambda h, r, cz, czt, kk, kq, gq: (
            -al * h
            + al * (r + cz + czt - 2.0 * kk + (trK - 2.0 * th) * kq)
            - kappa1 * (1.0 + kappa2) * al * th * gq
        ),
        hess, ric, covZ, covZ.T, KK, K, g,
    )
    r_th = (
        0.5 * al * (Rs + 2.0 * divZ + (trK - 2.0 * th) * trK - K2)
        - al * E("i,i->", Zup, A)
        - kappa1 * (2.0 + kappa2) * al * th
    )
    KmixZ = E("ij,j->i", Kmix, Z)
    r_Z = _omap(
        lambda dk, dt, dthi, kz, av, zv: (
            al * (dk - dt + dthi - 2.0 * kz) - al * th * av
            - kappa1 * al * zv
        ),
        divKi, dtrK, dth, KmixZ, A, Z,
    )
    r_A = _omap(
        lambda av, dt, dthk: -dag * al * av * Kmth - ag * (dt - m * dthk),
        A, dtrK, dth,
    )
    r_D = _omap(
        lambda ak, kij, dkv: -al * ak * kij - al * dkv,
        np.broadcast_to(A[:, None, None], (3, 3, 3)),
        np.broadcast_to(K[None, :, :], (3, 3, 3)),
        dK,
    )
    return r_al, r_g, r_K, r_th, r_Z, r_A, r_D


def z4_shift_rhs_soa(
    q,
    dq3,
    *,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    shift: str = "frozen",
    f_b: float = 0.75,
    eta: float = 1.0,
):
    """The shifted vacuum Z4 right-hand side ∂_t Q (53 variables),
    component-unrolled: the zero-shift parts, the Lie-derivative terms in
    ``_oein`` order, and the gauge sector of ``shift`` (``"frozen"`` or
    ``"gamma_driver"``).  ``q`` var-last ``[..., 53]``, ``dq3`` ``[..., 3,
    53]``; affine in ``dq3``.  The Gamma-driver's ∂_t Γ^i is the explicit
    chain rule along the full (post-Lie) ∂_t γ and ∂_t D: ∂_t γ^ab =
    −γ^am γ^bn ∂_t γ_mn and ∂_t Γlow by Γlow's own permutation of ∂_t D."""
    if shift not in SHIFTS:
        raise ValueError(f"unknown shift mode {shift!r}")
    E = _oein
    al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD = _z4_unpack_soa(q, dq3)
    beta = _vec_obj(q, _BETA)
    b = _vec_obj(q, _BSM)
    B = np.empty((3, 3), dtype=object)
    db = np.empty((3, 3), dtype=object)
    dB = np.empty((3, 3, 3), dtype=object)
    for k in range(3):
        for i in range(3):
            B[k, i] = q[..., _BB.start + 3 * k + i]
            db[k, i] = dq3[..., k, _BSM.start + i]
            for l in range(3):
                dB[k, l, i] = dq3[..., k, _BB.start + 3 * l + i]

    r_al, r_g, r_K, r_th, r_Z, r_A, r_D = _z4_core_soa(
        al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD,
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
    )

    # The Lie-derivative terms.
    r_al = r_al + al * E("k,k->", beta, A)
    r_g = (
        r_g
        + _omap(lambda x: 2.0 * x, E("k,kij->ij", beta, D))
        + E("ik,kj->ij", B, g)
        + E("jk,ki->ij", B, g)
    )
    r_K = (
        r_K
        + E("k,kij->ij", beta, dK)
        + E("ik,kj->ij", B, K)
        + E("jk,ki->ij", B, K)
    )
    r_th = r_th + E("k,k->", beta, dth)
    r_Z = r_Z + E("k,ki->i", beta, dZ) + E("ik,k->i", B, Z)
    r_A = r_A + E("km,m->k", B, A) + E("m,km->k", beta, dA)
    r_D = (
        r_D
        + E("km,mij->kij", B, D)
        + E("m,kmij->kij", beta, dD)
        + E("im,kmj->kij", B, D)
        + E("jm,kmi->kij", B, D)
        + _omap(lambda x: 0.5 * x, E("kim,mj->kij", dB, g))
        + _omap(lambda x: 0.5 * x, E("kjm,mi->kij", dB, g))
    )

    if shift == "frozen":
        extra = [torch.zeros_like(al)] * 15
    else:
        gi, _ = _oinv3(g)
        Glow = np.transpose(D, (2, 0, 1)) + np.transpose(D, (2, 1, 0)) - D
        dgi_t = _omap(lambda x: -x, E("am,bn,mn->ab", gi, gi, _osym(r_g)))
        dGlow_t = (
            np.transpose(r_D, (2, 0, 1))
            + np.transpose(r_D, (2, 1, 0))
            - r_D
        )
        dt_gamma = (
            E("il,jk,ljk->i", dgi_t, gi, Glow)
            + E("il,jk,ljk->i", gi, dgi_t, Glow)
            + E("il,jk,ljk->i", gi, gi, dGlow_t)
        )
        extra = [f_b * b[i] for i in range(3)]
        extra += [dt_gamma[i] - eta * b[i] for i in range(3)]
        for k in range(3):
            extra += [f_b * db[k, i] for i in range(3)]
    return _z4_pack_soa(r_al, r_g, r_K, r_th, r_Z, r_A, r_D, extra)


# ------------------------------------------------------------- the system


def _tag(slicing, f, m, kappa1, kappa2) -> PhysicsTag:
    return PhysicsTag(
        "z4", 3, N_VARS,
        (slicing, float(f), float(m), float(kappa1), float(kappa2)),
    )


def _require_soa(impl: str):
    if impl != "soa":
        raise SemanticError(
            f"impl={impl!r} is not ported to exahype_tpu_torch yet: pass "
            "impl='soa' (the einsum formulation, with the shifted system's "
            "jax.jvp Gamma-driver term, is the JAX package's oracle); see "
            "ROADMAP.md, Queue 1 item 7.4"
        )


def _require_fused(fused_rhs):
    if fused_rhs not in (False, "soa"):
        raise SemanticError(
            f"fused_rhs={fused_rhs!r} is not ported to exahype_tpu_torch yet "
            "(the einsum hook): pass fused_rhs='soa' or False; see ROADMAP.md, "
            "Queue 1 item 7.4"
        )


def _callbacks(rhs, n_vars: int, g_of, tag: PhysicsTag, shifted: bool, flux=None, eig=None):
    """The solver's four callbacks over an affine ``rhs(q, dq3)`` of
    ``n_vars`` variables, each tagged ``tag``; the wave speed adds |β^d|
    when ``shifted``.  The flux is ``flux(Q, axis, va)`` where given (the
    coupled matter systems', ``models/z4_matter.py`` and
    ``models/z4_grmhd.py``), else zero; the wave speed ``eig(Q, axis, va)``
    where given (Z4+GRMHD's, widened to the cleaning speed), else the
    vacuum cone."""

    if flux is None:
        def flux(Q, axis, va):
            return torch.zeros_like(Q)

    if eig is None:
        def eig(Q, axis, va):
            q = torch.movedim(Q, va, -1)
            al = q[..., _AL]
            gi, _ = inv3(sym_to_mat(q[..., _G]))
            gdd = gi[..., axis, axis]
            cone = al * torch.sqrt(torch.clamp(g_of(al), min=1.0) * gdd)
            return torch.abs(q[..., _BETA.start + axis]) + cone if shifted else cone

    def source(Q, va):
        q = torch.movedim(Q, va, -1)
        dq3 = torch.zeros(q.shape[:-1] + (3, n_vars), dtype=q.dtype, device=q.device)
        return torch.movedim(rhs(q, dq3), -1, va)

    def ncp(Q, dQ, axis, va):
        # rhs is affine in the derivatives: B_d·∂_dQ = rhs(Q,0) − rhs(Q,∂_d)
        q = torch.movedim(Q, va, -1)
        dq = torch.movedim(dQ, va, -1)
        zeros = torch.zeros(q.shape[:-1] + (3, n_vars), dtype=q.dtype, device=q.device)
        zrow = torch.zeros_like(dq)
        dq3 = torch.stack([dq if d == axis else zrow for d in range(3)], dim=-2)
        out = rhs(q, zeros) - rhs(q, dq3)
        return torch.movedim(out, -1, va)

    for fn in (flux, eig, ncp, source):
        fn.physics = tag
    return flux, eig, ncp, source


def z4_system(
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    impl: str = "soa",
):
    """(flux_fn, max_eigenvalue_fn, ncp_fn, source_fn) in the solver's
    ``(Q, axis, var_axis)`` contract — a fluxless pure-NCP system.  The
    Rusanov bound along axis d is the wider of the light and gauge cones,
    α√(max(g(α), 1)·γ^dd).  ``impl="soa"`` only (the JAX default,
    ``"einsum"``, raises).
    Each callback is tagged ``.physics = PhysicsTag("z4", 3, 38, (slicing,
    f, m, kappa1, kappa2))``."""
    _require_soa(impl)
    kw = dict(slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2)
    g_of, _ = _slicing(slicing, f)
    return _callbacks(lambda q, dq3: z4_rhs_soa(q, dq3, **kw), N_VARS, g_of, _tag(**kw),
                      shifted=False)


def _shift_tag(slicing, f, m, kappa1, kappa2, shift, f_b, eta) -> PhysicsTag:
    return PhysicsTag(
        "z4_shift", 3, N_VARS_SHIFT,
        (slicing, float(f), float(m), float(kappa1), float(kappa2), shift, float(f_b),
         float(eta)),
    )


def z4_shift_system(
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    shift: str = "frozen",
    f_b: float = 0.75,
    eta: float = 1.0,
    impl: str = "soa",
):
    """(flux_fn, max_eigenvalue_fn, ncp_fn, source_fn) of the 53-variable
    shifted system (:func:`z4_shift_rhs_soa`).  The Rusanov bound along
    axis d adds the coordinate speed |β^d| to the wider of the light and
    gauge cones: |β^d| + α√(max(g(α), 1)·γ^dd).  ``impl="soa"`` only (the
    JAX default, ``"einsum"``, raises).  Each callback is tagged
    ``.physics = PhysicsTag("z4_shift", 3, 53, (slicing, f, m, kappa1,
    kappa2, shift, f_b, eta))``."""
    _require_soa(impl)
    if shift not in SHIFTS:
        raise ValueError(f"unknown shift mode {shift!r}")
    kw = dict(slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2, shift=shift, f_b=f_b,
              eta=eta)
    g_of, _ = _slicing(slicing, f)
    return _callbacks(lambda q, dq3: z4_shift_rhs_soa(q, dq3, **kw), N_VARS_SHIFT, g_of,
                      _shift_tag(**kw), shifted=True)


def _rhs_all_of(rhs_fn):
    """Wrap an affine ``rhs(q, dq3)`` as the solver's fused
    ``rhs_all_fn(Q, grads, va)`` hook: by affinity the single full-RHS
    evaluation equals ``source − Σ_d B_d·∂_d Q`` exactly."""

    def rhs_all(Q, grads, va):
        q = torch.movedim(Q, va, -1)
        rows = [torch.movedim(gq, va, -1) for gq in grads]
        rows += [torch.zeros_like(rows[0])] * (3 - len(rows))
        dq3 = torch.stack(rows, dim=-2)
        return torch.movedim(rhs_fn(q, dq3), -1, va)

    return rhs_all


def make_z4_solver(
    dim: int,
    order: int,
    grid_shape: tuple,
    dx=1.0,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    fused_rhs=False,
    impl: str = "soa",
    **kwargs,
) -> ADERDGSolver:
    """A vacuum Z4 ADER-DG solver on a periodic box (the JAX
    ``make_z4_solver``; ``kwargs`` go to :class:`ADERDGSolver`: ``device``,
    ``dtype``, ``picard_iters``, ``basis``).

    ``impl``: ``"soa"`` only (the JAX default, ``"einsum"``, raises);
    ``fused_rhs``: ``False`` (per-axis NCP) or ``"soa"`` (the one-evaluation
    ``rhs_all_fn`` hook, which :func:`~exahype_tpu_torch.models.rhs_cuda.
    with_cuda_rhs` puts on the K5 kernel); the einsum hook ``True``
    raises."""
    _require_fused(fused_rhs)
    kw = dict(slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2)
    flux, eig, ncp, source = z4_system(impl=impl, **kw)
    rhs_all = None
    if fused_rhs == "soa":
        rhs_all = _rhs_all_of(lambda q, dq3: z4_rhs_soa(q, dq3, **kw))
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



def make_z4_shift_solver(
    dim: int,
    order: int,
    grid_shape: tuple,
    dx=1.0,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    shift: str = "frozen",
    f_b: float = 0.75,
    eta: float = 1.0,
    fused_rhs=False,
    impl: str = "soa",
    **kwargs,
) -> ADERDGSolver:
    """A shifted vacuum Z4 ADER-DG solver (53 variables) on a periodic box
    (the JAX ``make_z4_shift_solver``; ``kwargs`` go to
    :class:`ADERDGSolver`).  ``impl`` and ``fused_rhs`` as in
    :func:`make_z4_solver`: ``fused_rhs="soa"`` gives the one-evaluation
    ``rhs_all_fn`` hook (:func:`~exahype_tpu_torch.models.rhs_cuda.
    with_cuda_rhs` puts it on K5, ``CudaADERDG`` compiles it in)."""
    _require_fused(fused_rhs)
    kw = dict(slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2, shift=shift, f_b=f_b,
              eta=eta)
    flux, eig, ncp, source = z4_shift_system(impl=impl, **kw)
    rhs_all = None
    if fused_rhs == "soa":
        rhs_all = _rhs_all_of(lambda q, dq3: z4_shift_rhs_soa(q, dq3, **kw))
        rhs_all.physics = flux.physics
    return ADERDGSolver(
        dim=dim,
        order=order,
        n_vars=N_VARS_SHIFT,
        grid_shape=grid_shape,
        flux_fn=flux,
        max_eigenvalue_fn=eig,
        ncp_fn=ncp,
        source_fn=source,
        rhs_all_fn=rhs_all,
        dx=dx,
        **kwargs,
    )


# ------------------------------------------------------------ states


def _on_solver(solver, vals):
    """A var-last NumPy array of values at every node → the solver's
    SoA-P state tensor, in its dtype, on its device."""
    arr = np.ascontiguousarray(np.moveaxis(vals, -1, solver.var_axis))
    return torch.from_numpy(arr).to(
        device=solver.weights.device, dtype=solver.weights.dtype
    )


def flat_state_values(n_vars: int = N_VARS) -> np.ndarray:
    """Minkowski in Cartesian coordinates (the robust-stability base); with
    ``n_vars=53`` the shifted system's, its gauge sector zero."""
    v = np.zeros(n_vars)
    v[_AL] = 1.0
    v[1] = v[4] = v[6] = 1.0  # γ = identity (xx, yy, zz slots)
    return v


def z4_flat_state(solver) -> torch.Tensor:
    """Flat-space nodal state on ``solver`` (its dtype and device; 38 or 53
    variables, as the solver has)."""
    shape = solver.state_shape[: solver.var_axis] + solver.state_shape[solver.var_axis + 1:]
    n = solver.n_vars
    return _on_solver(solver, np.broadcast_to(flat_state_values(n), shape + (n,)))


def gauge_wave_values(x, t, amplitude=0.01, wavelength=1.0):
    """The Apples-with-Apples gauge wave, var-last values at positions x
    (float64 NumPy): ds² = −H dt² + H dx² + dy² + dz², H = 1 − a
    sin(2π(x−t)/L), harmonic slicing f=1, zero shift, Θ = Z = 0."""
    x = np.asarray(x, dtype=np.float64)
    k = 2.0 * np.pi / wavelength
    s = np.sin(k * (x - t))
    c = np.cos(k * (x - t))
    H = 1.0 - amplitude * s
    dH = -amplitude * k * c  # ∂_x H  (= −∂_t H)
    al = np.sqrt(H)
    out = np.zeros(x.shape + (N_VARS,))
    out[..., _AL] = al
    out[..., 1] = H  # γ_xx
    out[..., 4] = 1.0  # γ_yy
    out[..., 6] = 1.0  # γ_zz
    out[..., 7] = dH / (2.0 * al)  # K_xx = −∂_t γ_xx/(2α)
    out[..., 17] = dH / (2.0 * H)  # A_x = ∂_x ln α
    out[..., 20] = 0.5 * dH  # D_xxx = ½ ∂_x γ_xx
    return out


def gauge_wave_state(solver, t=0.0, amplitude=0.01, wavelength=None) -> torch.Tensor:
    """Exact gauge-wave nodal state on ``solver`` (wave along grid axis 0;
    default wavelength = the axis-0 domain length, so the state is
    periodic), in the solver's dtype on its device."""
    coords = solver.nodes_meshgrid()
    if wavelength is None:
        wavelength = solver.grid_shape[0] * solver._dxs[0]
    x = np.broadcast_to(
        np.squeeze(np.asarray(coords[0]), axis=solver.var_axis),
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1:],
    )
    return _on_solver(solver, gauge_wave_values(x, t, amplitude, wavelength))



def moving_gauge_wave_values(x, t, v=0.2, amplitude=0.01, wavelength=1.0):
    """The gauge wave in uniformly moving coordinates x' = x − v t, var-last
    53-variable values at positions x (float64 NumPy): an exact vacuum
    solution with constant shift β^x = v, so every Lie term is exercised.
    γ_x'x' = H, α = √H, K_x'x' = ∂_x'H/(2√H), with H a function of ξ = x' −
    (1 − v) t; b = B = 0 since β is constant."""
    x = np.asarray(x, dtype=np.float64)
    k = 2.0 * np.pi / wavelength
    s = np.sin(k * (x - (1.0 - v) * t))
    c = np.cos(k * (x - (1.0 - v) * t))
    H = 1.0 - amplitude * s
    dH = -amplitude * k * c  # ∂_x H
    al = np.sqrt(H)
    out = np.zeros(x.shape + (N_VARS_SHIFT,))
    out[..., 0] = al
    out[..., 1] = H
    out[..., 4] = 1.0
    out[..., 6] = 1.0
    out[..., 7] = dH / (2.0 * al)
    out[..., 17] = dH / (2.0 * H)
    out[..., 20] = 0.5 * dH
    out[..., 38] = v
    return out


def moving_gauge_wave_state(solver, t=0.0, v=0.2, amplitude=0.01,
                            wavelength=None) -> torch.Tensor:
    """Exact moving-coordinates gauge-wave nodal state on a shifted solver
    (wave along grid axis 0; default wavelength = the axis-0 domain length),
    in the solver's dtype on its device."""
    coords = solver.nodes_meshgrid()
    if wavelength is None:
        wavelength = solver.grid_shape[0] * solver._dxs[0]
    x = np.broadcast_to(
        np.squeeze(np.asarray(coords[0]), axis=solver.var_axis),
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1:],
    )
    return _on_solver(solver, moving_gauge_wave_values(x, t, v, amplitude, wavelength))


# ------------------------------------------------------- constraint monitor


def adm_constraints(q, dq3):
    """Vacuum ADM constraints from the first-order state (var-last; 38 or
    53 variables, slots 0-37 read):
    ``(H, M)``, the Hamiltonian constraint ``H = R + K² − K_ij K^ij`` and
    the momentum constraint ``M_i = ∇_j K^j_i − ∂_i K``.  ``dq3`` as in
    :func:`z4_rhs_soa`."""
    ein = torch.einsum
    al, g, K, th, Z, A, D = unpack(q)
    dK = sym_to_mat(dq3[..., _K])
    dD = sym_to_mat(dq3[..., _D].reshape(dq3.shape[:-1] + (3, 6)))
    gi, _ = inv3(g)
    dgi = -2.0 * ein("...la,...mb,...kab->...klm", gi, gi, D)
    Glow = (
        ein("...ijl->...lij", D)
        + ein("...jil->...lij", D)
        - D
    )
    Gam = ein("...kl,...lij->...kij", gi, Glow)
    Gtr = ein("...kl,...jkl->...j", gi, D)
    dGlow = (
        ein("...kijl->...klij", dD)
        + ein("...kjil->...klij", dD)
        - dD
    )
    ric = (
        ein("...kkl,...lij->...ij", dgi, Glow)
        + ein("...kl,...klij->...ij", gi, dGlow)
        - ein("...ikl,...jkl->...ij", dgi, D)
        - ein("...kl,...ijkl->...ij", gi, dD)
        + ein("...l,...lij->...ij", Gtr, Gam)
        - ein("...kli,...lkj->...ij", Gam, Gam)
    )
    ric = 0.5 * (ric + ric.transpose(-1, -2))
    Rs = ein("...ij,...ij->...", gi, ric)
    trK = ein("...ij,...ij->...", gi, K)
    Kup = ein("...ia,...jb,...ab->...ij", gi, gi, K)
    K2 = ein("...ij,...ij->...", K, Kup)
    ham = Rs + trK * trK - K2
    divKi = (
        ein("...jl,...jil->...i", gi, dK)
        - ein("...jl,...mji,...ml->...i", gi, Gam, K)
        - ein("...jl,...mjl,...im->...i", gi, Gam, K)
    )
    dtrK = ein("...ikl,...kl->...i", dgi, K) + ein("...kl,...ikl->...i", gi, dK)
    mom = divKi - dtrK
    return ham, mom


def solver_constraints(solver, Q):
    """(H, M_i) on every node of a solver state: nodal spectral
    derivatives per grid axis (exact for the DG polynomial), missing 3-D
    axes zero-filled on 2-D grids."""
    q = torch.movedim(Q, solver.var_axis, -1)
    Dmat = solver.D.to(q.dtype)
    parts = []
    for k in range(3):
        if k < solver.dim:
            na = solver.node_axis(k)
            na = na if na < solver.var_axis else na - 1
            d = torch.tensordot(Dmat, q, dims=([1], [na]))
            d = torch.movedim(d, 0, na) / solver._dxs[k]
        else:
            d = torch.zeros_like(q)
        parts.append(d)
    dq3 = torch.stack(parts, dim=-2)
    return adm_constraints(q, dq3)
