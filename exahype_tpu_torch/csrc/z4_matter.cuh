// The coupled Z4+GRHD right-hand side (43 variables: the 38 zero-shift Z4
// variables and the densitized Valencia block D̃, S̃_i, τ̃) at one point, its
// conservative hydro flux, and its wave speed, as device code templated on
// the value type.
//
// It follows exahype_tpu_torch/models/z4_matter.py::z4_matter_rhs_soa (the
// port's copy of exahype_tpu/models/z4_matter.py::z4_matter_rhs_soa): the
// zero-shift parts of csrc/z4.cuh, the trace-reversed matter terms added to
// r_K, r_Θ and r_Z before the symmetrisation, then the five hydro rows (D̃:
// zero; S̃_j: α√γ (S^ik D_jik − E A_j); τ̃: α√γ (S^ik K_ik − S^k A_k)).  Every
// contraction in _oein's order, as csrc/z4.cuh says; so the kernels differ
// from the plain version by fused multiply-adds only.
//
// The recovery (recover: γ^ij, √γ, the curved momentum norm, csrc/srhd.cuh's
// Newton, ρhW², E, v_i, v^i, the trace term) is computed once a point and
// handed to the algebra's extension (Matter) and to the flux: the kernels
// compute it before the algebra writes its first result, since the
// predictor stores results in place of the state.  The plain version
// recovers twice: the flux through models/z4_matter.py::recover (γ^ij as the
// adjugate over the determinant, torch.einsum's |S|², and the recovery fed
// √(|S|²)), the algebra through the SoA expressions (γ^ij as the cofactors
// times 1/det); the kernels use the latter for both, so their flux rows
// differ from the plain ones by the rounding of those two forms (an ulp or
// two of the hydro values; chip_smoke.py's float32 bound covers it, float64
// is held at 1e-12 of the largest value).
//
// The extension's hooks take the algebra's own α, A_k, γ_ij and K_ij as they
// pass (none is read from the state again), and read no derivative: the
// matter terms are algebraic, so the right-hand side stays affine in ∂Q and
// each NCP pair rhs(q, g) − rhs(q, 0) cancels them exactly.
#pragma once

#include "srhd.cuh"
#include "z4.cuh"

namespace z4m {

constexpr int kVars = 43;
// The hydro block's slots (models/z4_matter.py): D̃, S̃_i, τ̃.
constexpr int kHD = 38, kHS = 39, kHTau = 42;
constexpr int kHydro = 5;
// 8π as Python forms it.
constexpr double kEightPi = 8.0 * 3.141592653589793;

// The zero-shift system's parameters, and the fluid's Γ and the recovery's
// Newton iterations.
struct Params {
  z4::Params core;
  double gamma;
  int iters;
};

// What the algebra and the flux take from one recovery at a point.
template <typename T>
struct Recovered {
  T al;          // α
  T sqg;         // √γ
  T p;           // pressure
  T rhohW2;      // ρhW² = τ + D + p
  T E;           // ρhW² − p
  T half_tr;     // ½ (S − E), S = ρhW² v² + 3p
  T v_low[3];    // v_i
  T v_up[3];     // v^i = γ^ij v_j
  T gi[3][3];    // γ^ij
  T Dt, St[3], taut;  // the densitized conserved values
};

// The recovery at a point whose state q(slot) reads (slots 0-6, 38-42).
template <typename T, typename LoadQ>
__device__ __forceinline__ Recovered<T> recover(const LoadQ& q, const Params& prm) {
  Recovered<T> r;
  r.al = q(z4::kAl);
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
  T S_low[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r.St[i] = q(kHS + i);
    S_low[i] = r.St[i] / r.sqg;
  }
  const T Dh = r.Dt / r.sqg;
  const T tau = r.taut / r.sqg;
  // |S|² = γ^ij S_i S_j, i outer, j inner, started from the first term.
  T S2;
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const int i = c / 3, j = c % 3;
    const T t = r.gi[i][j] * S_low[i] * S_low[j];
    S2 = c ? S2 + t : t;
  }
  const T Smag = dsqrt(srhd::nan_max(S2, T(0)));
  r.p = srhd::con2prim_smag<T>(Dh, Smag, tau, prm.gamma, prm.iters).p;
  r.rhohW2 = tau + Dh + r.p;
  r.E = r.rhohW2 - r.p;
#pragma unroll
  for (int i = 0; i < 3; ++i) r.v_low[i] = S_low[i] / r.rhohW2;
  T v2;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T acc;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T t = r.gi[i][j] * r.v_low[j];
      acc = j ? acc + t : t;
    }
    r.v_up[i] = acc;
    const T t = r.v_low[i] * r.v_up[i];
    v2 = i ? v2 + t : t;
  }
  const T S_tr = r.rhohW2 * v2 + T(3) * r.p;
  r.half_tr = T(0.5) * (S_tr - r.E);
  return r;
}

// The hydro flux row `row` (0 D̃, 1-3 S̃_j, 4 τ̃) along axis d
// (models/z4_matter.py::z4_matter_flux): α D̃ v^d, α S̃_j v^d (+ α √γ p on
// the d row), α (τ̃ + √γ p) v^d.  v^d = γ^dj v_j is r.v_up[d].
template <typename T>
__device__ __forceinline__ T flux(const Recovered<T>& r, int d, int row) {
  const T vd = d == 0 ? r.v_up[0] : (d == 1 ? r.v_up[1] : r.v_up[2]);
  const T psg = r.p * r.sqg;
  if (row == 0) return r.al * r.Dt * vd;
  if (row == 4) return r.al * (r.taut + psg) * vd;
  const T s = row == 1 ? r.St[0] : (row == 2 ? r.St[1] : r.St[2]);
  const T x = r.al * (s * vd);
  return row - 1 == d ? x + r.al * psg : x;
}

// The extension of csrc/z4.cuh's rhs: the matter terms on K, Θ, Z before
// the symmetrisation, and the hydro rows in finish.  The hooks keep the
// algebra's α, A_k, γ_ij and K_ij as they pass.
template <typename T>
struct Matter {
  const Recovered<T>& r;
  T alpha, Ak[3], gm[3][3], Km[3][3];

  __device__ __forceinline__ explicit Matter(const Recovered<T>& rec) : r(rec) {}

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
  // r_K − 8π α (S_ij − ½ (S − E) γ_ij), S_ij = ρhW² v_i v_j + p γ_ij.
  template <typename LoadDQ>
  __device__ __forceinline__ T K(int i, int j, T x, const T (&Kv)[3][3], const LoadDQ&) {
    Km[i][j] = Kv[i][j];
    const T S_ij = r.rhohW2 * r.v_low[i] * r.v_low[j] + r.p * gm[i][j];
    return x - T(kEightPi) * alpha * (S_ij - r.half_tr * gm[i][j]);
  }
  // r_Θ − 8π α E
  template <typename LoadDQ>
  __device__ __forceinline__ T th(T x, const LoadDQ&) {
    return x - T(kEightPi) * alpha * r.E;
  }
  // r_Z_i − 8π α S_i, S_i = ρhW² v_i
  template <typename LoadDQ>
  __device__ __forceinline__ T Z(int i, T x, const T (&)[3], const LoadDQ&) {
    return x - T(kEightPi) * alpha * (r.rhohW2 * r.v_low[i]);
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
  // The hydro rows 38-42: D̃ 0, S̃_j α√γ (S^ik D_jik − E A_j), τ̃ α√γ (S^ik
  // K_ik − S^k A_k), S^ik = ρhW² v^i v^k + p γ^ik, S^k = γ^kj ρhW² v_j.
  template <typename LoadDQ, typename Store>
  __device__ __forceinline__ void finish(const T (&)[3][3], const T (&Dv)[3][3][3],
                                         const LoadDQ&, const Store& out) {
    T Sup[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) Sup[i][k] = r.rhohW2 * r.v_up[i] * r.v_up[k] + r.p * r.gi[i][k];
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
        const T t = r.gi[i][j] * (r.rhohW2 * r.v_low[j]);
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
  }
};

// ∂_t Q at one point (43 slots; the accessors as csrc/z4.cuh's rhs takes
// them) from the recovery `rec` made at the same point: the caller may
// store results in place of the state.
template <typename T, typename LoadQ, typename LoadDQ, typename Store>
__device__ __forceinline__ void rhs(const LoadQ& q, const LoadDQ& dq, const Params& p,
                                    const Recovered<T>& rec, const Store& out) {
  Matter<T> ext(rec);
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

// The Rusanov bound along axis d (models/z4_matter.py::z4_matter_eig): the
// vacuum system's, csrc/z4.cuh's wave_speed (q holds the 43 slots).
template <typename T>
__device__ __forceinline__ T wave_speed(const T* q, int d, const Params& p) {
  return z4::wave_speed<T>(q, d, p.core);
}

}  // namespace z4m
