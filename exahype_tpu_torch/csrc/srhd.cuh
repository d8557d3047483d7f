// The special-relativistic conservative-to-primitive recovery on (D, |S|,
// τ) at one point, as device code templated on the value type.
//
// It follows exahype_tpu_torch/models/srhd.py::con2prim_smag (the port's
// copy of exahype_tpu/models/srhd.py::con2prim_smag) operation by
// operation: the bracket p ∈ (max(p_floor, |S| − E), (Γ−1)E], the initial
// guess min((Γ−1)τ, (Γ−1)(E − |S|)) inside it, then `iters` safeguarded
// Newton trips (the bracket tightened by the residual's sign, a Newton
// candidate outside it or not finite replaced by bisection), and the final
// W and ρ.  `iters` is a run-time loop, not unrolled: the trips run one
// code copy (PERF.md: an unrolled loop of this depth costs more in
// instruction fetch than it saves).
//
// Every constant is cast to T as PyTorch casts a Python float into a tensor
// of that type: in float32 1 − 1e-12 is exactly 1, so v² is clipped at 1
// there, as on the plain path.  Γ − 1, 1 + 1e-6 and 10 p_floor are formed
// in double first, as Python forms them.  max and min propagate NaN as
// torch.maximum and torch.minimum do, and the finiteness test stays (the
// port compiles without fast math); so a NaN input gives the NaN output of
// the plain version.
#pragma once

#include "device_math.cuh"

namespace srhd {

// torch.maximum / torch.minimum: NaN if either operand is NaN.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a || a < b) ? a : b;
}

// (ρ, p, W) of the recovery.
template <typename T>
struct Prim {
  T rho, p, W;
};

template <typename T>
__device__ __forceinline__ Prim<T> con2prim_smag(T D, T Smag, T tau, double gamma, int iters,
                                                 double p_floor = 1e-12) {
  const T gm1 = T(gamma - 1.0);
  const T g = T(gamma);
  const T floor_ = T(p_floor);
  const T one_m = T(1.0 - 1e-12);
  const T E = tau + D;
  const T S2 = Smag * Smag;

  const T tiny = T(1e-12) * (T(1) + Smag);
  T p_lo = nan_max(Smag - E + tiny, floor_);
  T p_hi = nan_max(gm1 * E * T(1.0 + 1e-6) + T(10 * p_floor), p_lo * T(2));

  T p = nan_max(nan_min(gm1 * tau, gm1 * (E - Smag)), floor_);
  p = nan_min(nan_max(p, p_lo), p_hi);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const T Ep = E + p;
    const T v2 = nan_min(nan_max(S2 / (Ep * Ep), T(0)), one_m);
    const T W = T(1) / dsqrt(T(1) - v2);
    const T rho = D / W;
    const T h = Ep / (D * W);
    const T eps = h - T(1) - p / rho;
    const T f = gm1 * rho * eps - p;
    const T cs2 = g * p / (rho * h);
    const T df = v2 * cs2 - T(1);
    const T newton = p - f / df;
    const bool up = f > T(0);
    p_lo = up ? p : p_lo;
    p_hi = up ? p_hi : p;
    const bool inside = isfinite(newton) && newton >= p_lo && newton <= p_hi;
    p = nan_max(inside ? newton : T(0.5) * (p_lo + p_hi), floor_);
  }
  const T Ep = E + p;
  const T v2 = nan_min(nan_max(S2 / (Ep * Ep), T(0)), one_m);
  const T W = T(1) / dsqrt(T(1) - v2);
  return {D / W, p, W};
}

}  // namespace srhd
