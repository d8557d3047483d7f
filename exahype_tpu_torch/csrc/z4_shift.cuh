// The shifted vacuum Z4 right-hand side (53 variables) at one point, and its
// wave speed, as device code templated on the value type.
//
// It follows exahype_tpu_torch/models/z4.py::z4_shift_rhs_soa (the port's
// copy of exahype_tpu/models/z4.py::z4_shift_rhs_soa): the zero-shift parts
// of csrc/z4.cuh, each with its Lie-derivative terms added before the
// symmetrisation, then the gauge sector of the shift condition chosen at run
// time: frozen (slots 38-52 do not move) or the Gamma-driver, ∂_t β^i =
// f_b b^i, ∂_t b^i = ∂_t Γ^i − η b^i, ∂_t B_k^i = f_b ∂_k b^i, with ∂_t Γ^i
// by the explicit chain rule along the post-Lie ∂_t γ_ij and ∂_t D_kij
// (dgi_t, dGlow_t, dt_gamma).  Every contraction in _oein's order, as
// csrc/z4.cuh says; so the kernels differ from the plain version by fused
// multiply-adds only.
//
// The extension (Lie) reads the gauge sector β^i, b^i, B_k^i of the state
// in begin, before the algebra writes its first result, so that a caller
// may store the results in place of the state; its hooks take the other
// state values from the algebra's own registers and the derivatives from
// dq.  It keeps the post-Lie r_g and the unsymmetrised post-Lie r_D for the
// Gamma-driver (36 values).  The algebra reads the gradients of slots 7-37 and
// 41-52 (43 an axis; never ∂β).
#pragma once

#include "z4.cuh"

namespace z4s {

constexpr int kVars = 53;
// The gauge sector's slots (models/z4.py): β^i, b^i, B_k^i at kBB + 3k + i.
constexpr int kBeta = 38, kB = 41, kBB = 44;

// The zero-shift system's parameters, and the shift condition (models/
// z4.py::SHIFTS: 0 frozen, 1 Gamma-driver) with its f_b and η.
struct Params {
  z4::Params core;
  int shift;
  double f_b, eta;
};

// Σ_k a(k) b(k), the sum started from the first term.
template <typename T, typename F>
__device__ __forceinline__ T dot3(const F& term) {
  T acc = term(0);
#pragma unroll
  for (int k = 1; k < 3; ++k) acc = acc + term(k);
  return acc;
}

template <typename T>
struct Lie {
  const Params& p;
  T beta[3], b[3], B[3][3];  // B[k][i] = ∂_k β^i
  T rg[3][3];                // post-Lie r_g
  T rD[3][3][3];             // post-Lie r_D, unsymmetrised

  __device__ __forceinline__ explicit Lie(const Params& params) : p(params) {}

  template <typename LoadQ>
  __device__ __forceinline__ void begin(const LoadQ& q) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      beta[i] = q(kBeta + i);
      b[i] = q(kB + i);
#pragma unroll
      for (int k = 0; k < 3; ++k) B[i][k] = q(kBB + 3 * i + k);
    }
  }
  // r_α + α β^k A_k
  __device__ __forceinline__ T al(T r, T alpha, const T (&A)[3]) {
    return r + alpha * dot3<T>([&](int k) { return beta[k] * A[k]; });
  }
  // r_g + 2 β^k D_kij + B_ik γ_kj + B_jk γ_ki (B_ik = ∂_i β^k)
  __device__ __forceinline__ T g(int i, int j, T r, const T (&gm)[3][3],
                                 const T (&D)[3][3][3]) {
    const T e1 = dot3<T>([&](int k) { return beta[k] * D[k][i][j]; });
    const T e2 = dot3<T>([&](int k) { return B[i][k] * gm[k][j]; });
    const T e3 = dot3<T>([&](int k) { return B[j][k] * gm[k][i]; });
    const T x = r + T(2) * e1 + e2 + e3;
    rg[i][j] = x;
    return x;
  }
  // r_K + β^k ∂_k K_ij + B_ik K_kj + B_jk K_ki
  template <typename LoadDQ>
  __device__ __forceinline__ T K(int i, int j, T r, const T (&Km)[3][3], const LoadDQ& dq) {
    const T e1 = dot3<T>([&](int k) { return beta[k] * dq(k, z4::kK + z4::sym(i, j)); });
    const T e2 = dot3<T>([&](int k) { return B[i][k] * Km[k][j]; });
    const T e3 = dot3<T>([&](int k) { return B[j][k] * Km[k][i]; });
    return r + e1 + e2 + e3;
  }
  // r_Θ + β^k ∂_k Θ
  template <typename LoadDQ>
  __device__ __forceinline__ T th(T r, const LoadDQ& dq) {
    return r + dot3<T>([&](int k) { return beta[k] * dq(k, z4::kTh); });
  }
  // r_Z_i + β^k ∂_k Z_i + B_ik Z_k
  template <typename LoadDQ>
  __device__ __forceinline__ T Z(int i, T r, const T (&Zv)[3], const LoadDQ& dq) {
    const T e1 = dot3<T>([&](int k) { return beta[k] * dq(k, z4::kZ + i); });
    const T e2 = dot3<T>([&](int k) { return B[i][k] * Zv[k]; });
    return r + e1 + e2;
  }
  // r_A_k + B_km A_m + β^m ∂_k A_m
  template <typename LoadDQ>
  __device__ __forceinline__ T A(int k, T r, const T (&Av)[3], const LoadDQ& dq) {
    const T e1 = dot3<T>([&](int m) { return B[k][m] * Av[m]; });
    const T e2 = dot3<T>([&](int m) { return beta[m] * dq(k, z4::kA + m); });
    return r + e1 + e2;
  }
  // r_D_kij + B_km D_mij + β^m ∂_k D_mij + B_im D_kmj + B_jm D_kmi
  //         + ½ ∂_k B_i^m γ_mj + ½ ∂_k B_j^m γ_mi
  template <typename LoadDQ>
  __device__ __forceinline__ T D(int k, int i, int j, T r, const T (&gm)[3][3],
                                 const T (&Dv)[3][3][3], const LoadDQ& dq) {
    const T e1 = dot3<T>([&](int m) { return B[k][m] * Dv[m][i][j]; });
    const T e2 = dot3<T>([&](int m) { return beta[m] * dq(k, z4::kD + 6 * m + z4::sym(i, j)); });
    const T e3 = dot3<T>([&](int m) { return B[i][m] * Dv[k][m][j]; });
    const T e4 = dot3<T>([&](int m) { return B[j][m] * Dv[k][m][i]; });
    const T e5 = dot3<T>([&](int m) { return dq(k, kBB + 3 * i + m) * gm[m][j]; });
    const T e6 = dot3<T>([&](int m) { return dq(k, kBB + 3 * j + m) * gm[m][i]; });
    const T x = r + e1 + e2 + e3 + e4 + T(0.5) * e5 + T(0.5) * e6;
    rD[k][i][j] = x;
    return x;
  }

  // The gauge sector: slots 38-52.
  template <typename LoadDQ, typename Store>
  __device__ __forceinline__ void finish(const T (&gm)[3][3], const T (&Dv)[3][3][3],
                                         const LoadDQ& dq, const Store& out) {
    if (p.shift == 0) {
#pragma unroll
      for (int s = kBeta; s < kVars; ++s) out(s, T(0));
      return;
    }
    const T f_b = T(p.f_b), eta = T(p.eta);
    // γ^ij, the cofactors over the determinant (models/z4.py::_oinv3).
    T gi[3][3];
    {
      const T a = gm[0][0], bb = gm[0][1], c = gm[0][2];
      const T d = gm[1][0], e = gm[1][1], f = gm[1][2];
      const T g_ = gm[2][0], h = gm[2][1], i = gm[2][2];
      const T ca = e * i - f * h;
      const T cb = f * g_ - d * i;
      const T cc = d * h - e * g_;
      const T det = a * ca + bb * cb + c * cc;
      const T inv_det = T(1) / det;
      gi[0][0] = ca * inv_det;
      gi[0][1] = (c * h - bb * i) * inv_det;
      gi[0][2] = (bb * f - c * e) * inv_det;
      gi[1][0] = cb * inv_det;
      gi[1][1] = (a * i - c * g_) * inv_det;
      gi[1][2] = (c * d - a * f) * inv_det;
      gi[2][0] = cc * inv_det;
      gi[2][1] = (bb * g_ - a * h) * inv_det;
      gi[2][2] = (a * e - bb * d) * inv_det;
    }
    // dgi_t[a][b] = −γ^am γ^bn ∂_t γ_mn, ∂_t γ_mn the symmetrised r_g.
    T dgi_t[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bi = 0; bi < 3; ++bi) {
        T acc;
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          const int m = c / 3, n = c % 3;
          const T rgs = T(0.5) * (rg[m][n] + rg[n][m]);
          const T t = gi[a][m] * gi[bi][n] * rgs;
          acc = c ? acc + t : t;
        }
        dgi_t[a][bi] = -acc;
      }
    // ∂_t Γ^i = ∂_t γ^il γ^jk Γ_ljk + γ^il ∂_t γ^jk Γ_ljk + γ^il γ^jk ∂_t Γ_ljk,
    // Γ_ljk = D_jkl + D_kjl − D_ljk and ∂_t Γ_ljk the same of r_D.
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T s1, s2, s3;
#pragma unroll
      for (int c = 0; c < 27; ++c) {
        const int j = c / 9, k = (c / 3) % 3, l = c % 3;
        const T glow = Dv[j][k][l] + Dv[k][j][l] - Dv[l][j][k];
        const T dglow = rD[j][k][l] + rD[k][j][l] - rD[l][j][k];
        const T a1 = dgi_t[i][l] * gi[j][k] * glow;
        const T a2 = gi[i][l] * dgi_t[j][k] * glow;
        const T a3 = gi[i][l] * gi[j][k] * dglow;
        s1 = c ? s1 + a1 : a1;
        s2 = c ? s2 + a2 : a2;
        s3 = c ? s3 + a3 : a3;
      }
      out(kBeta + i, f_b * b[i]);
      out(kB + i, s1 + s2 + s3 - eta * b[i]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < 3; ++i) out(kBB + 3 * k + i, f_b * dq(k, kB + i));
  }
};

// ∂_t Q at one point (53 slots; the accessors as csrc/z4.cuh's rhs takes them).
template <typename T, typename LoadQ, typename LoadDQ, typename Store>
__device__ __forceinline__ void rhs(const LoadQ& q, const LoadDQ& dq, const Params& p,
                                    const Store& out) {
  Lie<T> lie(p);
  z4::rhs<T>(q, dq, p.core, out, &lie);
}

// The Rusanov bound along axis d (models/z4.py::z4_shift_system's eig): the
// coordinate speed |β^d| added to csrc/z4.cuh's wave speed.  q holds the 53
// slots.
template <typename T>
__device__ __forceinline__ T wave_speed(const T* q, int d, const Params& p) {
  return dabs(q[kBeta + d]) + z4::wave_speed<T>(q, d, p.core);
}

}  // namespace z4s
