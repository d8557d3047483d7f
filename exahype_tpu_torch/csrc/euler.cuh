// Compressible Euler physics for the port's kernels, state
// [rho, m_1..m_DIM, E, (aux...)] as one cell's variable vector.
//
// Operation order of exahype_tpu/models/euler.py (_pressure_tpu, flux_tpu,
// max_eigenvalue_tpu) and of exahype_tpu_torch/models/euler.py, whose
// tensor forms are the plain versions: inv_rho multiplies, it does not
// divide.  Used by csrc/aderdg.cu and, through the cuda_source of the
// spec functions (models/euler.py), by the generated spec kernels.
#pragma once

#include "device_math.cuh"

// The pressure from the state and its 1/rho.
template <typename T, int DIM>
__device__ __forceinline__ T euler_pressure_from(const T* q, T inv_rho, T gm1) {
  T kinetic = q[1] * q[1] + q[2] * q[2];
  if constexpr (DIM == 3) kinetic = kinetic + q[3] * q[3];
  return gm1 * (q[DIM + 1] - T(0.5) * inv_rho * kinetic);
}

template <typename T, int DIM>
__device__ __forceinline__ T euler_pressure(const T* q, T gm1) {
  return euler_pressure_from<T, DIM>(q, T(1) / q[0], gm1);
}

// Flux along axis n (a compile-time constant once inlined) from the state,
// its 1/rho and its pressure: NREAL components, zero beyond the DIM + 2 of
// Euler.  A caller that needs the flux along every axis computes 1/rho and
// the pressure once (one division per node, not one per axis).
template <typename T, int DIM, int NREAL>
__device__ __forceinline__ void euler_flux_from(const T* q, int n, T inv_rho, T p, T* f) {
  const T coeff = inv_rho * q[n + 1];
  T c[DIM + 2];
#pragma unroll
  for (int k = 0; k < DIM + 1; ++k) c[k] = coeff * q[k];
  c[n + 1] = c[n + 1] + p;
  c[DIM + 1] = coeff * q[DIM + 1] + coeff * p;
#pragma unroll
  for (int k = 0; k < NREAL; ++k) {
    if (k < DIM + 2) {
      f[k] = c[k];
    } else {
      f[k] = T(0);
    }
  }
}

template <typename T, int DIM, int NREAL>
__device__ __forceinline__ void euler_flux(const T* q, int n, T gm1, T* f) {
  const T inv_rho = T(1) / q[0];
  euler_flux_from<T, DIM, NREAL>(q, n, inv_rho, euler_pressure_from<T, DIM>(q, inv_rho, gm1), f);
}

// Largest |wave speed| along the axis whose momentum is q_n.
template <typename T, int DIM>
__device__ __forceinline__ T euler_max_eigenvalue(const T* q, T q_n, T gm1, T gamma) {
  const T inv_rho = T(1) / dabs(q[0]);
  const T p = euler_pressure<T, DIM>(q, gm1);
  const T c = dsqrt(gamma * dabs(p) * inv_rho);
  const T u_n = q_n * inv_rho;
  return dmax(dabs(u_n - c), dabs(u_n + c));
}
