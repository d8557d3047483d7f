// 3-D heterogeneous linear elasticity for the port's kernels: 12 variables
// [v_x, v_y, v_z, σ_xx, σ_yy, σ_zz, σ_yz, σ_xz, σ_xy, ρ, λ, μ] (Voigt stress
// order), the materials frozen per node.
//
// Operation order of exahype_tpu/models/elastic.py (elastic3d_het_flux,
// elastic3d_het_eigenvalue) and of exahype_tpu_torch/models/elastic.py,
// whose tensor forms are the plain versions: the velocity rows multiply by
// 1/ρ, the stress rows add λ and μ terms in the reference's order (its
// "+ 0" terms included), and the rows that do not involve the normal are
// -0.  The flux takes 1/ρ, λ and μ from the caller, so a kernel computes
// them once per node and keeps them in registers.
#pragma once

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
