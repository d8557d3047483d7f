// Linear elasticity for the port's kernels.  The 3-D heterogeneous system:
// 12 variables [v_x, v_y, v_z, σ_xx, σ_yy, σ_zz, σ_yz, σ_xz, σ_xy, ρ, λ, μ]
// (Voigt stress order), the materials frozen per node.  The homogeneous
// systems, ρ, λ and μ constants of the kernel (Elastic3D: the 9 variables
// without the materials; Elastic2D: [v_x, v_y, σ_xx, σ_yy, σ_xy]), after
// it; then the systems whose last rows are frozen slots (K2 b.1): the 2-D
// heterogeneous system (ElasticHet2D, 8 variables) and the curvilinear lift
// of Elastic2D (CurvilinearElastic, 10 variables: J and J·a^k_i frozen).
//
// Operation order of exahype_tpu/models/elastic.py (elastic3d_het_flux,
// elastic3d_het_eigenvalue) and of exahype_tpu_torch/models/elastic.py,
// whose tensor forms are the plain versions: the velocity rows multiply by
// 1/ρ, the stress rows add λ and μ terms in the reference's order (its
// "+ 0" terms included), and the rows that do not involve the normal are
// -0.  The flux takes 1/ρ, λ and μ from the caller, so a kernel computes
// them once per node and keeps them in registers.
#pragma once

#include <cmath>

#include "device_math.cuh"

// Voigt index of σ_ij: (0,0) 3, (1,1) 4, (2,2) 5, (1,2) 6, (0,2) 7, (0,1) 8.
__host__ __device__ constexpr int elastic_sig(int i, int j) {
  return i == j ? 3 + i : 9 - i - j;
}

// Flux along axis n (a compile-time constant once inlined) of the 9 evolved
// variables q[0..8]; the material rows' flux is zero and not written.
template <typename T>
__device__ __forceinline__ void elastic3d_het_flux(const T* q, T inv_rho, T lam, T mu,
                                                   int n, T* f) {
#pragma unroll
  for (int i = 0; i < 3; ++i) f[i] = -q[elastic_sig(i, n)] * inv_rho;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = i; j < 3; ++j) {
      T val;
      if (i == j) {
        val = lam * q[n];
        if (i == n) val = (val + mu * q[j]) + mu * q[j];
      } else if (i == n) {
        val = (T(0) + mu * q[j]) + T(0);
      } else if (j == n) {
        val = T(0) + mu * q[i];
      } else {
        val = T(0);
      }
      f[elastic_sig(i, j)] = -val;
    }
  }
}

// The P-wave speed √((λ + 2μ)/ρ), the largest |wave speed| on every axis.
template <typename T>
__device__ __forceinline__ T elastic3d_het_eigenvalue(T rho, T lam, T mu) {
  return dsqrt((lam + T(2) * mu) / rho);
}

// The homogeneous 3-D flux (exahype_tpu/models/elastic.py::elastic3d_flux)
// along axis n: the velocity rows −σ_in / ρ, a division as the reference
// takes it, and the stress rows in its order, its 0·v_x and + 0 terms
// included (so the rows that do not involve the normal are −(0·v_x)).
template <typename T>
__device__ __forceinline__ void elastic3d_flux(const T* q, T rho, T lam, T mu, int n, T* f) {
#pragma unroll
  for (int i = 0; i < 3; ++i) f[i] = -q[elastic_sig(i, n)] / rho;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = i; j < 3; ++j) {
      T val = i == j ? lam * q[n] : T(0) * q[0];
      if (i == n) {
        val = val + mu * q[j];
        val = val + (j == n ? mu * q[j] : T(0));
      } else if (j == n) {
        val = val + mu * q[i];
      }
      f[elastic_sig(i, j)] = -val;
    }
  }
}

// The 2-D flux (exahype_tpu/models/elastic.py::elastic_flux) along axis n
// of [v_x, v_y, σ_xx, σ_yy, σ_xy]: −σ/ρ on the velocity rows, and on the
// stress rows the negated constants nl2m = −(λ + 2μ), nlam = −λ, nmu = −μ,
// which the reference forms in float64 before they meet the state.
template <typename T>
__device__ __forceinline__ void elastic2d_flux(const T* q, T rho, T nl2m, T nlam, T nmu, int n,
                                               T* f) {
  if (n == 0) {
    f[0] = -q[2] / rho;
    f[1] = -q[4] / rho;
    f[2] = nl2m * q[0];
    f[3] = nlam * q[0];
    f[4] = nmu * q[1];
  } else {
    f[0] = -q[4] / rho;
    f[1] = -q[3] / rho;
    f[2] = nlam * q[1];
    f[3] = nl2m * q[1];
    f[4] = nmu * q[0];
  }
}

// The homogeneous systems as the kernels take a physics: V variables, all
// of them with flux and with the Rusanov jump unmasked; params = {ρ, λ, μ}
// (float64); the wave speed is c_p = √((λ + 2μ)/ρ) on every axis, computed
// in float64 as the reference's _speeds and then cast.  flux(q, d, f) is
// the flux along axis d, d a compile-time constant once unrolled;
// flux_along(q, d, f) the same for a thread-dependent d (a wall's ghost
// flux), dispatched to compile-time axes.
template <typename T>
struct Elastic3D {
  static constexpr int V = 9;
  static constexpr int kFluxRows = V;
  static constexpr bool kMasked = false;
  static constexpr bool kViscous = false;
  T rho, lam, mu, cp;
  static Elastic3D make(const double* p) {
    return {static_cast<T>(p[0]), static_cast<T>(p[1]), static_cast<T>(p[2]),
            static_cast<T>(std::sqrt((p[1] + 2.0 * p[2]) / p[0]))};
  }
  __device__ __forceinline__ T max_eigenvalue(const T*, int) const { return cp; }
  __device__ __forceinline__ void flux(const T* q, int d, T* f) const {
    elastic3d_flux<T>(q, rho, lam, mu, d, f);
  }
  __device__ __forceinline__ void flux_along(const T* q, int d, T* f) const {
#pragma unroll
    for (int dd = 0; dd < 3; ++dd) {
      if (dd == d) elastic3d_flux<T>(q, rho, lam, mu, dd, f);
    }
  }
  static __device__ __forceinline__ T dissipation(int) { return T(1); }
};

template <typename T>
struct Elastic2D {
  static constexpr int V = 5;
  static constexpr int kFluxRows = V;
  static constexpr bool kMasked = false;
  static constexpr bool kViscous = false;
  T rho, nl2m, nlam, nmu, cp;
  static Elastic2D make(const double* p) {
    return {static_cast<T>(p[0]), static_cast<T>(-(p[1] + 2.0 * p[2])), static_cast<T>(-p[1]),
            static_cast<T>(-p[2]), static_cast<T>(std::sqrt((p[1] + 2.0 * p[2]) / p[0]))};
  }
  __device__ __forceinline__ T max_eigenvalue(const T*, int) const { return cp; }
  __device__ __forceinline__ void flux(const T* q, int d, T* f) const {
    elastic2d_flux<T>(q, rho, nl2m, nlam, nmu, d, f);
  }
  __device__ __forceinline__ void flux_along(const T* q, int d, T* f) const {
    if (d == 0) {
      elastic2d_flux<T>(q, rho, nl2m, nlam, nmu, 0, f);
    } else {
      elastic2d_flux<T>(q, rho, nl2m, nlam, nmu, 1, f);
    }
  }
  static __device__ __forceinline__ T dissipation(int) { return T(1); }
};

// The physics with frozen slots as the kernels take them: V variables, the
// first kFluxRows with flux and with the Rusanov jump (dissipation 1), the
// rest frozen (zero flux, dissipation 0, kMasked): the CK node kernel holds
// them at u's values through the Taylor recursion (csrc/aderdg_ck_nodes.cuh)
// and the face stages neither solve nor update them.  flux(q, d, f) writes
// the kFluxRows rows of the flux along d (d a compile-time constant once
// unrolled) from all V rows of q; flux_along(q, d, f) the same for a
// thread-dependent d (a wall's ghost flux).

// The 12-variable heterogeneous elasticity with its CK configuration
// compiled in: materials in slots 9-11 (kRho..kMu), the dissipation mask
// (1,)*9 + (0, 0, 0).
template <typename T>
struct ElasticHetPhysics {
  static constexpr int V = 12;
  static constexpr int kEvolved = 9;
  static constexpr int kFluxRows = kEvolved;
  static constexpr int kRho = 9, kLam = 10, kMu = 11;
  static constexpr bool kMasked = true;
  static constexpr bool kViscous = false;
  static ElasticHetPhysics make(const double*) { return {}; }
  __device__ __forceinline__ T max_eigenvalue(const T* q, int) const {
    return elastic3d_het_eigenvalue<T>(q[kRho], q[kLam], q[kMu]);
  }
  __device__ __forceinline__ void flux(const T* q, int d, T* f) const {
    elastic3d_het_flux<T>(q, T(1) / q[kRho], q[kLam], q[kMu], d, f);
  }
  // The flux of the evolved rows along axis d (a wall's ghost flux).
  __device__ __forceinline__ void flux_along(const T* q, int d, T* f) const {
    const T inv_rho = T(1) / q[kRho];
#pragma unroll
    for (int dd = 0; dd < 3; ++dd) {
      if (dd == d) elastic3d_het_flux<T>(q, inv_rho, q[kLam], q[kMu], dd, f);
    }
  }
  static __device__ __forceinline__ T dissipation(int v) {
    return v < kEvolved ? T(1) : T(0);
  }
};

// The 2-D heterogeneous flux (exahype_tpu/models/elastic.py::
// elastic_het_flux) along axis n of [v_x, v_y, σ_xx, σ_yy, σ_xy] with the
// point's 1/ρ, λ and μ, in the reference's order: −σ·(1/ρ), −(λ + 2μ)·v,
// −λ·v, −μ·v.
template <typename T>
__device__ __forceinline__ void elastic2d_het_flux(const T* q, T inv_rho, T lam, T mu, int n,
                                                   T* f) {
  if (n == 0) {
    f[0] = -q[2] * inv_rho;
    f[1] = -q[4] * inv_rho;
    f[2] = -(lam + T(2) * mu) * q[0];
    f[3] = -lam * q[0];
    f[4] = -mu * q[1];
  } else {
    f[0] = -q[4] * inv_rho;
    f[1] = -q[3] * inv_rho;
    f[2] = -lam * q[1];
    f[3] = -(lam + T(2) * mu) * q[1];
    f[4] = -mu * q[0];
  }
}

// The 8-variable 2-D heterogeneous elasticity [v_x, v_y, σ_xx, σ_yy, σ_xy,
// ρ, λ, μ]: materials in slots 5-7, the dissipation mask (1,)*5 + (0,)*3
// (tests/test_ck.py:139's configuration).
template <typename T>
struct ElasticHet2D {
  static constexpr int V = 8;
  static constexpr int kFluxRows = 5;
  static constexpr int kRho = 5, kLam = 6, kMu = 7;
  static constexpr bool kMasked = true;
  static constexpr bool kViscous = false;
  static ElasticHet2D make(const double*) { return {}; }
  __device__ __forceinline__ T max_eigenvalue(const T* q, int) const {
    return elastic3d_het_eigenvalue<T>(q[kRho], q[kLam], q[kMu]);
  }
  __device__ __forceinline__ void flux(const T* q, int d, T* f) const {
    elastic2d_het_flux<T>(q, T(1) / q[kRho], q[kLam], q[kMu], d, f);
  }
  __device__ __forceinline__ void flux_along(const T* q, int d, T* f) const {
    if (d == 0) {
      flux(q, 0, f);
    } else {
      flux(q, 1, f);
    }
  }
  static __device__ __forceinline__ T dissipation(int v) {
    return v < kFluxRows ? T(1) : T(0);
  }
};

// The curvilinear lift of Elastic2D (exahype_tpu/models/curvilinear.py::
// curvilinear_physics over elastic(ρ, λ, μ), n_wave = 5): 10 variables, the
// densitized wave rows Q̃ = J·q, then J (kJ) and J·a^k_i (kJ + 1 + 2k + i),
// frozen.  Along reference axis k the flux of the wave rows is
// J·a^k_0 F_0(Q̃/J) + J·a^k_1 F_1(Q̃/J) (the reference's order: the wave rows
// divided by J, a division each, the terms summed over i), and the wave
// speed ‖J·a^k‖₂/J · c_p, with a_i = J·a^k_i / J (divisions) and
// √(a_0 a_0 + a_1 a_1).  params = {ρ, λ, μ}.
template <typename T>
struct CurvilinearElastic {
  static constexpr int kWave = 5;
  static constexpr int V = 10;
  static constexpr int kFluxRows = kWave;
  static constexpr int kJ = kWave;
  static constexpr bool kMasked = true;
  static constexpr bool kViscous = false;
  Elastic2D<T> base;
  static CurvilinearElastic make(const double* p) { return {Elastic2D<T>::make(p)}; }
  __device__ __forceinline__ T max_eigenvalue(const T* q, int k) const {
    const T J = q[kJ];
    const T a0 = (k == 0 ? q[kJ + 1] : q[kJ + 3]) / J;
    const T a1 = (k == 0 ? q[kJ + 2] : q[kJ + 4]) / J;
    return dsqrt(a0 * a0 + a1 * a1) * base.cp;
  }
  __device__ __forceinline__ void flux(const T* q, int k, T* f) const {
    T w[kWave], f0[kWave], f1[kWave];
#pragma unroll
    for (int v = 0; v < kWave; ++v) w[v] = q[v] / q[kJ];
    base.flux(w, 0, f0);
    base.flux(w, 1, f1);
    const T a0 = q[kJ + 1 + 2 * k], a1 = q[kJ + 2 + 2 * k];
#pragma unroll
    for (int v = 0; v < kWave; ++v) f[v] = a0 * f0[v] + a1 * f1[v];
  }
  __device__ __forceinline__ void flux_along(const T* q, int k, T* f) const {
    if (k == 0) {
      flux(q, 0, f);
    } else {
      flux(q, 1, f);
    }
  }
  static __device__ __forceinline__ T dissipation(int v) {
    return v < kFluxRows ? T(1) : T(0);
  }
};
