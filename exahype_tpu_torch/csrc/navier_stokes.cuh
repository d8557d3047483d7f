// The viscous terms of 3-D compressible Navier–Stokes for the port's
// kernels, state [rho, m_1..m_3, E].
//
// Operation order of exahype_tpu/models/navier_stokes.py::viscous_flux and
// of exahype_tpu_torch/models/navier_stokes.py, whose tensor form is the
// plain version: 1/rho multiplies, the velocity and temperature gradients
// come from the conserved-variable chain rule
//   dv_j = (dm_j - v_j drho) / rho,
//   dT = ((gamma - 1)(dE - v.dm + q^2 drho / 2) - T drho) / rho,
// and the flux along d is F_v(m_j) = -tau_dj, F_v(E) = -tau_dj v_j -
// kappa_T dT_d with tau_ij = mu (dv_i,j + dv_j,i - 2/3 delta_ij div v).
// Used by csrc/aderdg_visc.cu (through csrc/aderdg_common.cuh).
#pragma once

#include "device_math.cuh"

// fv[d][v] for every axis d and the rows v = 1..4 (the mass row of the
// viscous flux is zero and is not written), from the state q and its
// physical gradients g[e][v] = dq_v/dx_e.  gm1 = gamma - 1.  T, 1/rho, the
// velocity and the velocity and temperature gradients are computed once
// for the three axes.
template <typename T>
__device__ __forceinline__ void navier_stokes_viscous_fluxes(const T* q, const T (&g)[3][5],
                                                             T gm1, T mu, T kappa_T,
                                                             T (&fv)[3][5]) {
  const T inv_rho = T(1) / q[0];
  T v[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) v[j] = q[1 + j] * inv_rho;
  const T q2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const T temp = gm1 * (q[4] * inv_rho - T(0.5) * q2);  // p / rho with R = 1
  T dv[3][3], dT[3];  // dv[e][j] = d_e v_j, dT[e] = d_e T
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const T drho = g[e][0];
    T v_dot_dm = v[0] * g[e][1];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dv[e][j] = (g[e][1 + j] - v[j] * drho) * inv_rho;
      if (j > 0) v_dot_dm = v_dot_dm + v[j] * g[e][1 + j];
    }
    dT[e] = (gm1 * (g[e][4] - v_dot_dm + T(0.5) * q2 * drho) - temp * drho) * inv_rho;
  }
  const T div_v = dv[0][0] + dv[1][1] + dv[2][2];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    T tau[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      tau[j] = j == d ? mu * (dv[d][d] + dv[d][d] - T(2.0 / 3.0) * div_v)
                      : mu * (dv[d][j] + dv[j][d]);
      fv[d][1 + j] = -tau[j];
    }
    fv[d][4] = -(tau[0] * v[0] + tau[1] * v[1] + tau[2] * v[2]) - kappa_T * dT[d];
  }
}

// The 2-D form, state [rho, m_1, m_2, E]: fv[d][v] for both axes and the
// rows v = 1..3 from the state and its physical gradients g[e][v], in the
// 3-D form's operation order (exahype_tpu/models/navier_stokes.py at
// dim = 2).  Its own function, so that the 3-D kernels keep their code.
// Used by csrc/aderdg_2d.cu.
template <typename T>
__device__ __forceinline__ void navier_stokes_viscous_fluxes_2d(const T* q, const T (&g)[2][4],
                                                                T gm1, T mu, T kappa_T,
                                                                T (&fv)[2][4]) {
  const T inv_rho = T(1) / q[0];
  T v[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) v[j] = q[1 + j] * inv_rho;
  const T q2 = v[0] * v[0] + v[1] * v[1];
  const T temp = gm1 * (q[3] * inv_rho - T(0.5) * q2);  // p / rho with R = 1
  T dv[2][2], dT[2];  // dv[e][j] = d_e v_j, dT[e] = d_e T
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const T drho = g[e][0];
    dv[e][0] = (g[e][1] - v[0] * drho) * inv_rho;
    dv[e][1] = (g[e][2] - v[1] * drho) * inv_rho;
    const T v_dot_dm = v[0] * g[e][1] + v[1] * g[e][2];
    dT[e] = (gm1 * (g[e][3] - v_dot_dm + T(0.5) * q2 * drho) - temp * drho) * inv_rho;
  }
  const T div_v = dv[0][0] + dv[1][1];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    T tau[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      tau[j] = j == d ? mu * (dv[d][d] + dv[d][d] - T(2.0 / 3.0) * div_v)
                      : mu * (dv[d][j] + dv[j][d]);
      fv[d][1 + j] = -tau[j];
    }
    fv[d][3] = -(tau[0] * v[0] + tau[1] * v[1]) - kappa_T * dT[d];
  }
}
