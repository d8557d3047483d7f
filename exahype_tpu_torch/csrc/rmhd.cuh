// The magnetized conservative-to-primitive recovery on the field-aligned
// decomposition (D, S_∥, S_⊥, τ, |B|) at one point, as device code
// templated on the value type.
//
// It follows exahype_tpu_torch/models/rmhd.py::con2prim_scalar (the port's
// copy of exahype_tpu/models/rmhd.py::con2prim_scalar) operation by
// operation: the bracket z ∈ [max(D, |S| − B²), Γ(E + B²)] on z = ρhW², the
// weak-field initial guess inside it, then `iters` safeguarded Newton trips
// on the energy residual (the bracket tightened by the residual's sign, a
// Newton candidate outside it or not finite replaced by bisection), and the
// final W from the aligned velocity and ρ = D/W.  The residual's derivative
// is forward mode written out (resid): each operation of the residual paired
// with its tangent by the rule JAX's jax.jvp applies to it, the clip's
// tangent zero where it binds and halved on a tie; the plain version
// (models/rmhd.py::_resid) is the same sequence.  `iters` is a run-time
// loop, not unrolled, as csrc/srhd.cuh's.
//
// Every constant is cast to T as PyTorch casts a Python float into a tensor
// of that type: in float32 1 − 1e-12 is exactly 1 and 1e-300 is 0, so the
// reference's guards behave as they do there (a field of exactly zero gives
// 0/0 in the caller's S_∥).  (Γ − 1)/Γ and Γ − 1 are formed in double
// first, as Python forms them.  max and min propagate NaN as torch.maximum
// and torch.minimum do, and the finiteness test stays.
#pragma once

#include "device_math.cuh"
#include "srhd.cuh"

namespace rmhd {

using srhd::nan_max;
using srhd::nan_min;

// (ρ, p, W) of the recovery.
template <typename T>
struct Prim {
  T rho, p, W;
};

// The energy residual f(z), its tangent, and (W, p) at z.
template <typename T>
struct Resid {
  T f, df, W, p;
};

// The factor jnp.maximum / jnp.minimum's tangent rule gives the operand x
// of an answer `ans` against the other operand: 1 where x is the answer,
// ½ on a tie, else 0.
template <typename T>
__device__ __forceinline__ T balanced(T x, T ans, T other) {
  return (x == ans ? T(1) : T(0)) / (other == ans ? T(2) : T(1));
}

// f(z) = z + B² − p(z) − ½ (B²/W² + (S·B)²/z²) − E and f'(z)·dz, in the
// plain version's order.
template <typename T>
__device__ __forceinline__ Resid<T> resid(T z, T dz, T S2, T B2, T sB, T D, T E, double gamma) {
  const T z2 = z * z;
  const T dz2 = dz * z + z * dz;
  const T zB = z + B2;
  const T dzB = dz;
  // v² = (S² z² + (S·B)² (B² + 2z)) / (z² (z + B²)²), clipped to [0, 1 − 1e-12].
  const T a = S2 * z2;
  const T da = S2 * dz2;
  const T sBsB = sB * sB;
  const T c = T(2) * z;
  const T dc = T(2) * dz;
  const T bz = B2 + c;
  const T b = sBsB * bz;
  const T db = sBsB * dc;
  const T num = a + b;
  const T dnum = da + db;
  const T den1 = z2 * zB;
  const T dden1 = dz2 * zB + z2 * dzB;
  const T den = den1 * zB;
  const T dden = dden1 * zB + den1 * dzB;
  const T r = num / den;
  const T dr = dnum / den + (-dden * num) * (T(1) / (den * den));
  const T lo = nan_max(T(0), r);
  const T dlo = dr * balanced(r, lo, T(0));
  const T hi = T(1.0 - 1e-12);
  const T v2 = nan_min(hi, lo);
  const T dv2 = dlo * balanced(lo, v2, hi);
  const T s = dsqrt(T(1) - v2);
  const T ds = -dv2 * (T(0.5) / s);
  const T W = T(1) / s;
  const T dW = (-ds * T(1)) * (T(1) / (s * s));
  // p = (Γ−1)/Γ (z − D W) / W².
  const T DW = D * W;
  const T dDW = D * dW;
  const T cg = T((gamma - 1.0) / gamma);
  const T t1 = cg * (z - DW);
  const T dt1 = cg * (dz - dDW);
  const T WW = W * W;
  const T dWW = dW * W + W * dW;
  const T p = t1 / WW;
  const T dp = dt1 / WW + (-dWW * t1) * (T(1) / (WW * WW));
  // The magnetic terms.
  const T q1 = B2 / WW;
  const T dq1 = (-dWW * B2) * (T(1) / (WW * WW));
  const T q2 = sBsB / z2;
  const T dq2 = (-dz2 * sBsB) * (T(1) / (z2 * z2));
  const T f = z + B2 - p - T(0.5) * (q1 + q2) - E;
  const T df = dz - dp - T(0.5) * (dq1 + dq2);
  return {f, df, W, p};
}

template <typename T>
__device__ __forceinline__ Prim<T> con2prim_scalar(T D, T S_par, T S_perp, T tau, T Bmag,
                                                   double gamma, int iters,
                                                   double z_floor = 1e-12) {
  const T S2 = S_par * S_par + S_perp * S_perp;
  const T B2 = Bmag * Bmag;
  const T sB = S_par * Bmag;
  const T Smag = dsqrt(S2);
  const T E = tau + D;
  const T fl = T(z_floor);
  const T tiny = fl * (T(1) + Smag + B2);
  T z_lo = nan_max(nan_max(D, Smag - B2) + tiny, fl);
  T z_hi = nan_max(T(gamma) * (E + B2) + tiny, z_lo * T(2));
  // The weak-field estimate: E ≈ z + B² − p, p from the field-corrected τ.
  const T p0 = nan_max(T(gamma - 1.0) * (tau - T(0.5) * B2), fl);
  T z = nan_min(z_hi, nan_max(z_lo, E - B2 + p0));
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const Resid<T> r = resid<T>(z, T(1), S2, B2, sB, D, E, gamma);
    const T newton = z - r.f / r.df;
    // f increases in z: tighten the bracket by the residual's sign.
    const bool below = r.f < T(0);
    z_lo = below ? z : z_lo;
    z_hi = below ? z_hi : z;
    const bool inside = isfinite(newton) && newton >= z_lo && newton <= z_hi;
    z = nan_max(inside ? newton : T(0.5) * (z_lo + z_hi), fl);
  }
  const T p = resid<T>(z, T(1), S2, B2, sB, D, E, gamma).p;
  const T v_par = (S_par + (sB / z) * Bmag) / (z + B2);
  const T v_perp = S_perp / (z + B2);
  const T v2 = v_par * v_par + v_perp * v_perp;
  const T W = T(1) / dsqrt(T(1) - nan_min(nan_max(v2, T(0)), T(1.0 - 1e-12)));
  return {D / W, p, W};
}

}  // namespace rmhd
