// The coupled Z4+GRMHD right-hand side (47 variables: the 38 zero-shift Z4
// variables, the densitized Valencia block D̃, S̃_i, τ̃, the densitized field
// B̃^i and the GLM scalar φ̃) at one point, its conservative flux, and its
// wave speed, as device code templated on the value type.
//
// It follows exahype_tpu_torch/models/z4_grmhd.py::z4_grmhd_rhs_soa (the
// port's copy of exahype_tpu/models/z4_grmhd.py::z4_grmhd_rhs_soa): the
// zero-shift parts of csrc/z4.cuh, the trace-reversed TOTAL (fluid and
// field) stress-energy added to r_K, r_Θ and r_Z before the symmetrisation,
// then the nine matter rows (D̃: zero; S̃_j: α√γ (S^ik D_jik − E A_j); τ̃:
// α√γ (S^ik K_ik − S^k A_k), S^ik the total stress; B̃^i: zero; φ̃: −κ α φ̃).
// Every contraction in _oein's order, as csrc/z4.cuh says; so the kernels
// differ from the plain version by fused multiply-adds only.
//
// The recovery (recover: γ^ij, √γ, B_i, the metric's scalars |S|², |B|²,
// S·B, the field-aligned S_∥, S_⊥, csrc/rmhd.cuh's Newton, then v_i clamped
// subluminal, W, v·B, b², p*, ρh*W², E, b_i, b^i, v^i and the trace term) is
// computed once a point and handed to the algebra's extension (Mhd) and to
// the flux: the kernels compute it before the algebra writes its first
// result, since the predictor stores results in place of the state.  The
// plain version recovers twice: the flux through models/z4_grmhd.py::recover
// (γ^ij as the adjugate over the determinant, torch.einsum's contractions,
// the flat vector Newton on the aligned proxy state), the algebra through
// the SoA expressions (γ^ij as the cofactors times 1/det, the scalar
// Newton); the kernels use the latter for both, so their flux rows differ
// from the plain ones by the rounding of those two forms (chip_smoke.py's
// float32 bound covers it, float64 is held at 1e-12 of the largest value).
//
// The extension's hooks take the algebra's own α, A_k, γ_ij and K_ij as they
// pass (none is read from the state again), and read no derivative: the
// matter terms are algebraic, so the right-hand side stays affine in ∂Q and
// each NCP pair rhs(q, g) − rhs(q, 0) cancels them exactly.
#pragma once

#include "rmhd.cuh"
#include "z4.cuh"

namespace z4gm {

constexpr int kVars = 47;
// The matter block's slots (models/z4_grmhd.py): D̃, S̃_i, τ̃, B̃^i, φ̃.
constexpr int kHD = 38, kHS = 39, kHTau = 42, kHB = 43, kHPsi = 46;
constexpr int kHydro = 9;  // the rows with a flux: 38-46
// 8π as Python forms it.
constexpr double kEightPi = 8.0 * 3.141592653589793;

// The zero-shift system's parameters, the fluid's Γ and the recovery's
// Newton iterations, the cleaning speed c_h and the GLM damping κ.
struct Params {
  z4::Params core;
  double gamma;
  int iters;
  double c_h, glm_kappa;
};

// What the algebra and the flux take from one recovery at a point.
template <typename T>
struct Recovered {
  T al;                     // α
  T sqg;                    // √γ
  T gi[3][3];               // γ^ij
  T Dt, St[3], taut;        // the densitized conserved values
  T Bt[3], psi;             // B̃^i, φ̃
  T Bup[3], B_low[3];       // B^i, B_i
  T p, W, vB;               // pressure, Lorentz factor, v·B
  T ptot;                   // p* = p + b²/2
  T whW2;                   // ρh* W²
  T E;                      // ρh* W² − p* − (W v·B)²
  T half_tr;                // ½ (S − E)
  T v_low[3], v_up[3];      // v_i, v^i
  T b_low[3], b_up[3];      // b_i, b^i
  T c_h;                    // the cleaning speed (the φ̃ flux's)
};

// The recovery at a point whose state q(slot) reads (slots 0-6, 38-46).
template <typename T, typename LoadQ>
__device__ __forceinline__ Recovered<T> recover(const LoadQ& q, const Params& prm) {
  using rmhd::nan_max;
  using rmhd::nan_min;
  Recovered<T> r;
  r.al = q(z4::kAl);
  r.c_h = T(prm.c_h);
  T g[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) g[i][j] = q(z4::kG + z4::sym(i, j));
  // γ^ij: the cofactors times 1/det (models/z4.py::_oinv3).
  T det;
  {
    const T a = g[0][0], b = g[0][1], c = g[0][2];
    const T d = g[1][0], e = g[1][1], f = g[1][2];
    const T g_ = g[2][0], h = g[2][1], i = g[2][2];
    const T ca = e * i - f * h;
    const T cb = f * g_ - d * i;
    const T cc = d * h - e * g_;
    det = a * ca + b * cb + c * cc;
    const T inv_det = T(1) / det;
    r.gi[0][0] = ca * inv_det;
    r.gi[0][1] = (c * h - b * i) * inv_det;
    r.gi[0][2] = (b * f - c * e) * inv_det;
    r.gi[1][0] = cb * inv_det;
    r.gi[1][1] = (a * i - c * g_) * inv_det;
    r.gi[1][2] = (c * d - a * f) * inv_det;
    r.gi[2][0] = cc * inv_det;
    r.gi[2][1] = (b * g_ - a * h) * inv_det;
    r.gi[2][2] = (a * e - b * d) * inv_det;
  }
  r.sqg = dsqrt(det);
  r.Dt = q(kHD);
  r.taut = q(kHTau);
  r.psi = q(kHPsi);
  T S_low[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r.St[i] = q(kHS + i);
    r.Bt[i] = q(kHB + i);
  }
  const T Dh = r.Dt / r.sqg;
  const T tau = r.taut / r.sqg;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    S_low[i] = r.St[i] / r.sqg;
    r.Bup[i] = r.Bt[i] / r.sqg;
  }
  // B_i = γ_ij B^j; |S|² = γ^ij S_i S_j (i outer, j inner); |B|² = B^i B_i;
  // S·B = S_i B^i; each sum started from its first term.
  T S2, B2, sB;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T acc;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T t = g[i][j] * r.Bup[j];
      acc = j ? acc + t : t;
    }
    r.B_low[i] = acc;
  }
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const int i = c / 3, j = c % 3;
    const T t = r.gi[i][j] * S_low[i] * S_low[j];
    S2 = c ? S2 + t : t;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T tb = r.Bup[i] * r.B_low[i];
    const T ts = S_low[i] * r.Bup[i];
    B2 = i ? B2 + tb : tb;
    sB = i ? sB + ts : ts;
  }
  // The field-aligned decomposition; in float32 the guard 1e-300 is 0, so a
  // point with no field gives 0/0 here, as in the reference.
  const T Bmag = dsqrt(nan_max(B2, T(0)));
  const T S_par = sB / nan_max(Bmag, T(1e-300));
  const T S_perp = dsqrt(nan_max(S2 - S_par * S_par, T(0)));
  const rmhd::Prim<T> pr =
      rmhd::con2prim_scalar<T>(Dh, S_par, S_perp, tau, Bmag, prm.gamma, prm.iters);
  r.p = pr.p;
  const T h_f = T(1) + T(prm.gamma / (prm.gamma - 1.0)) * pr.p / pr.rho;
  const T z = pr.rho * h_f * pr.W * pr.W;
#pragma unroll
  for (int i = 0; i < 3; ++i) r.v_low[i] = (S_low[i] + (sB / z) * r.B_low[i]) / (z + B2);
  // The subluminal clamp in the real metric (physical states: scale 1).
  T v2;
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const int i = c / 3, j = c % 3;
    const T t = r.gi[i][j] * r.v_low[i] * r.v_low[j];
    v2 = c ? v2 + t : t;
  }
  const T scale = nan_min(dsqrt(T(1.0 - 1e-12) / nan_max(v2, T(1e-300))), T(1));
#pragma unroll
  for (int i = 0; i < 3; ++i) r.v_low[i] = r.v_low[i] * scale;
  v2 = nan_min(nan_max(v2 * scale * scale, T(0)), T(1.0 - 1e-12));
  r.W = T(1) / dsqrt(T(1) - v2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T t = r.v_low[i] * r.Bup[i];
    r.vB = i ? r.vB + t : t;
  }
  const T b2 = B2 / (r.W * r.W) + r.vB * r.vB;
  r.ptot = r.p + T(0.5) * b2;
  r.whW2 = pr.rho * h_f * r.W * r.W + b2 * r.W * r.W;
  const T wvb = r.W * r.vB;
#pragma unroll
  for (int i = 0; i < 3; ++i) r.b_low[i] = r.B_low[i] / r.W + wvb * r.v_low[i];
  r.E = r.whW2 - r.ptot - wvb * wvb;
  const T bib_up = b2 + wvb * wvb;
  const T S_tr = r.whW2 * v2 + T(3) * r.ptot - bib_up;
  r.half_tr = T(0.5) * (S_tr - r.E);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T acc;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T t = r.gi[i][j] * r.v_low[j];
      acc = j ? acc + t : t;
    }
    r.v_up[i] = acc;
    r.b_up[i] = r.Bup[i] / r.W + wvb * r.v_up[i];
  }
  return r;
}

// The matter flux row `row` (0 D̃, 1-3 S̃_j, 4 τ̃, 5-7 B̃^j, 8 φ̃) along axis
// d (models/z4_grmhd.py::z4_grmhd_flux): α D̃ v^d; α S̃_j v^d (+ α √γ p* on
// the d row) − α √γ B^d (B_j/W² + (v·B) v_j); α ((τ̃ + √γ p*) v^d − √γ (v·B)
// B^d); α (v^d B̃^j − B̃^d v^j) (+ α φ̃ on the d row); α c_h² B̃^d.
template <typename T>
__device__ __forceinline__ T flux(const Recovered<T>& r, int d, int row) {
  const T vd = d == 0 ? r.v_up[0] : (d == 1 ? r.v_up[1] : r.v_up[2]);
  const T Bd = d == 0 ? r.Bup[0] : (d == 1 ? r.Bup[1] : r.Bup[2]);
  const T Btd = d == 0 ? r.Bt[0] : (d == 1 ? r.Bt[1] : r.Bt[2]);
  const T psg = r.ptot * r.sqg;
  if (row == 0) return r.al * r.Dt * vd;
  if (row == 4) return r.al * ((r.taut + psg) * vd - r.sqg * r.vB * Bd);
  if (row == 8) return r.al * r.c_h * r.c_h * Btd;
  if (row < 4) {
    const int j = row - 1;
    const T s = j == 0 ? r.St[0] : (j == 1 ? r.St[1] : r.St[2]);
    const T bl = j == 0 ? r.B_low[0] : (j == 1 ? r.B_low[1] : r.B_low[2]);
    const T vl = j == 0 ? r.v_low[0] : (j == 1 ? r.v_low[1] : r.v_low[2]);
    T x = r.al * (s * vd);
    if (j == d) x = x + r.al * psg;
    return x - r.al * r.sqg * Bd * (bl / (r.W * r.W) + r.vB * vl);
  }
  const int j = row - 5;
  const T bt = j == 0 ? r.Bt[0] : (j == 1 ? r.Bt[1] : r.Bt[2]);
  const T vu = j == 0 ? r.v_up[0] : (j == 1 ? r.v_up[1] : r.v_up[2]);
  const T x = r.al * (vd * bt - Btd * vu);
  return j == d ? x + r.al * r.psi : x;
}

// The extension of csrc/z4.cuh's rhs: the total stress-energy on K, Θ, Z
// before the symmetrisation, and the matter rows in finish.  The hooks keep
// the algebra's α, A_k, γ_ij and K_ij as they pass.
template <typename T>
struct Mhd {
  const Recovered<T>& r;
  double glm_kappa;
  T alpha, Ak[3], gm[3][3], Km[3][3];

  __device__ __forceinline__ Mhd(const Recovered<T>& rec, double kappa)
      : r(rec), glm_kappa(kappa) {}

  // S_i = ρh* W² v_i − (W v·B) b_i.
  __device__ __forceinline__ T S_low(int i) const {
    return r.whW2 * r.v_low[i] - (r.W * r.vB) * r.b_low[i];
  }

  template <typename LoadQ>
  __device__ __forceinline__ void begin(const LoadQ&) {}
  __device__ __forceinline__ T al(T x, T a, const T (&Av)[3]) {
    alpha = a;
#pragma unroll
    for (int k = 0; k < 3; ++k) Ak[k] = Av[k];
    return x;
  }
  __device__ __forceinline__ T g(int i, int j, T x, const T (&gv)[3][3], const T (&)[3][3][3]) {
    gm[i][j] = gv[i][j];
    return x;
  }
  // r_K − 8π α (S_ij − ½ (S − E) γ_ij), S_ij = ρh* W² v_i v_j + p* γ_ij − b_i b_j.
  template <typename LoadDQ>
  __device__ __forceinline__ T K(int i, int j, T x, const T (&Kv)[3][3], const LoadDQ&) {
    Km[i][j] = Kv[i][j];
    const T S_ij =
        r.whW2 * r.v_low[i] * r.v_low[j] + r.ptot * gm[i][j] - r.b_low[i] * r.b_low[j];
    return x - T(kEightPi) * alpha * (S_ij - r.half_tr * gm[i][j]);
  }
  // r_Θ − 8π α E
  template <typename LoadDQ>
  __device__ __forceinline__ T th(T x, const LoadDQ&) {
    return x - T(kEightPi) * alpha * r.E;
  }
  // r_Z_i − 8π α S_i
  template <typename LoadDQ>
  __device__ __forceinline__ T Z(int i, T x, const T (&)[3], const LoadDQ&) {
    return x - T(kEightPi) * alpha * S_low(i);
  }
  template <typename LoadDQ>
  __device__ __forceinline__ T A(int, T x, const T (&)[3], const LoadDQ&) {
    return x;
  }
  template <typename LoadDQ>
  __device__ __forceinline__ T D(int, int, int, T x, const T (&)[3][3], const T (&)[3][3][3],
                                 const LoadDQ&) {
    return x;
  }
  // The matter rows 38-46: D̃ 0, S̃_j α√γ (S^ik D_jik − E A_j), τ̃ α√γ (S^ik
  // K_ik − S^k A_k), B̃^i 0, φ̃ −κ α φ̃; S^ik = ρh* W² v^i v^k + p* γ^ik − b^i
  // b^k, S^k = γ^kj S_j.
  template <typename LoadDQ, typename Store>
  __device__ __forceinline__ void finish(const T (&)[3][3], const T (&Dv)[3][3][3],
                                         const LoadDQ&, const Store& out) {
    T Sup[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        Sup[i][k] = r.whW2 * r.v_up[i] * r.v_up[k] + r.ptot * r.gi[i][k] - r.b_up[i] * r.b_up[k];
    const T asg = alpha * r.sqg;
    T SupK, SA;
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const T t = Sup[c / 3][c % 3] * Km[c / 3][c % 3];
      SupK = c ? SupK + t : t;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T su;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T t = r.gi[i][j] * S_low(j);
        su = j ? su + t : t;
      }
      const T t = su * Ak[i];
      SA = i ? SA + t : t;
    }
    out(kHD, T(0));
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T rS;
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        const T t = Sup[c / 3][c % 3] * Dv[j][c / 3][c % 3];
        rS = c ? rS + t : t;
      }
      out(kHS + j, asg * (rS - r.E * Ak[j]));
    }
    out(kHTau, asg * (SupK - SA));
#pragma unroll
    for (int i = 0; i < 3; ++i) out(kHB + i, T(0));
    out(kHPsi, T(-glm_kappa) * alpha * r.psi);
  }
};

// ∂_t Q at one point (47 slots; the accessors as csrc/z4.cuh's rhs takes
// them) from the recovery `rec` made at the same point: the caller may
// store results in place of the state.
template <typename T, typename LoadQ, typename LoadDQ, typename Store>
__device__ __forceinline__ void rhs(const LoadQ& q, const LoadDQ& dq, const Params& p,
                                    const Recovered<T>& rec, const Store& out) {
  Mhd<T> ext(rec, p.glm_kappa);
  z4::rhs<T>(q, dq, p.core, out, &ext);
}

// The same, recovering at the point first (the state is read before any
// result is stored).
template <typename T, typename LoadQ, typename LoadDQ, typename Store>
__device__ __forceinline__ void rhs(const LoadQ& q, const LoadDQ& dq, const Params& p,
                                    const Store& out) {
  const Recovered<T> rec = recover<T>(q, p);
  rhs<T>(q, dq, p, rec, out);
}

// The Rusanov bound along axis d (models/z4_grmhd.py::z4_grmhd_eig): α
// max(√(max(g(α), 1) γ^dd), c_h), γ^dd the cofactor over the determinant
// as csrc/z4.cuh's wave_speed takes it (q holds the 47 slots).
template <typename T>
__device__ __forceinline__ T wave_speed(const T* q, int d, const Params& p) {
  const T al = q[z4::kAl];
  const T a = q[z4::kG + 0], b = q[z4::kG + 1], c = q[z4::kG + 2];
  const T e = q[z4::kG + 3], f = q[z4::kG + 4], i = q[z4::kG + 5];
  const T ca = e * i - f * f;
  const T cb = f * c - b * i;
  const T cc = b * f - e * c;
  const T det = a * ca + b * cb + c * cc;
  const T cof = d == 0 ? ca : (d == 1 ? a * i - c * c : a * e - b * b);
  const T gdd = cof / det;
  T gal = p.core.slicing == 0 ? T(p.core.f) : T(2) / al;
  gal = gal < T(1) ? T(1) : gal;  // torch.clamp(min=1): NaN stays NaN
  T cone = dsqrt(gal * gdd);
  cone = cone < T(p.c_h) ? T(p.c_h) : cone;  // torch.clamp(min=c_h)
  return al * cone;
}

}  // namespace z4gm
