// K5: the fused pointwise NCP right-hand side of the Z4 systems,
// rhs_all(Q, ∇Q) = S(Q) − Σ_d B_d(Q)·∂_d Q, for Hopper (sm_90a): the
// 38-variable zero-shift instance (rhs_all_z4), the 53-variable shifted
// one (rhs_all_z4_shift, frozen shift or Gamma-driver), the 43-variable
// coupled Z4+GRHD one (rhs_all_z4_matter, K5 d: the con2prim Newton of
// csrc/srhd.cuh inside the kernel, a run-time loop of `iters` trips) and the
// 47-variable coupled Z4+GRMHD one (rhs_all_z4_grmhd, K5 e: the
// field-aligned con2prim Newton of csrc/rmhd.cuh inside the kernel).
//
// K5 b, rhs_all_z4_2d, is the 38-variable instance on a 2-D grid: two
// gradient arrays, the third axis's derivatives a run-time zero;
// rhs_all_z4_shift_2d is the 53-variable shifted one,
// rhs_all_z4_matter_2d the 43-variable Z4+GRHD one and rhs_all_z4_grmhd_2d
// the 47-variable Z4+GRMHD one.
//
// Replaces the TPU kernel exahype_tpu/models/rhs_pallas.py::PallasRHS._build
// (its pallas_call) on those instances.  The numbers to match are those of
// exahype_tpu/models/z4.py::z4_rhs_soa and ::z4_shift_rhs_soa and
// exahype_tpu/models/z4_matter.py::z4_matter_rhs_soa and
// exahype_tpu/models/z4_grmhd.py::z4_grmhd_rhs_soa; the plain PyTorch
// versions are the port's functions of those names through the solver's
// rhs_all_fn (models/z4.py::_rhs_all_of).  The algebras are csrc/z4.cuh,
// csrc/z4_shift.cuh, csrc/z4_matter.cuh and csrc/z4_grmhd.cuh.
//
// Layout.  The solver hands over q and the three physical gradients as
// contiguous [B, V, G] tensors (B = the product of the axes before the
// variable axis: the Picard time node and the node axes; V = 38, 53, 43 or
// 47; G = the product of the cell-grid axes after it) and takes the result
// in the same layout.  Each variable's row is contiguous over G, so one thread per point
// (b, x) reads q[b, s, x] and ∂_k Q[b, s, x] at stride G between slots, and
// the 32 threads of a warp read 32 neighbouring x of one slot: every load
// and store is coalesced.  The Mosaic kernel's var-first (8, 128) tiling
// and 1024-multiple wrap-pad have no counterpart.
//
// What bounds it on the H100.  Per point it reads the 38 state values and
// the 31 slots of each gradient that the algebra uses (∂α and ∂γ_ij never
// appear), and writes 38: 676 B in f32 (shifted: 53, 43 of each gradient
// and 53, 1,040 B; Z4+GRHD: 43, 31 and 43, 716 B; Z4+GRMHD: 47, 31 and 47,
// 748 B; their recoveries' Newton adds hundreds of operations, not bytes).  Its arithmetic is a few thousand operations per
// point (chip_smoke.py counts them by running the plain algebra on a
// counting scalar): ~6 per byte, under the card's f32 ridge of ~20, so the
// bytes bound it.  No value is reused across points, so there is nothing to
// stage in shared memory; the design's only concern is registers: the 152
// inputs and the algebra's deep temporaries (Γ^k_ij, ∂_k γ^ij, Γ_lij: 27
// values each) are live together, so the derivative entries are read where
// they are used, and ptxas's register and spill counts are printed by
// chip_smoke.py.  IEEE division (no fast math); nvcc contracts a·b + c into
// fused multiply-adds.
//
// Template parameter T: float or double.

#include <cuda_runtime.h>

#include "z4.cuh"
#include "z4_grmhd.cuh"
#include "z4_matter.cuh"
#include "z4_shift.cuh"

namespace {

constexpr int kBlock = 128;

template <typename T>
__global__ void __launch_bounds__(kBlock)
rhs_all_z4(const T* __restrict__ q, const T* __restrict__ g0, const T* __restrict__ g1,
           const T* __restrict__ g2, T* __restrict__ out, long long n_points, long long G,
           z4::Params p) {
  const long long idx = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= n_points) return;
  const long long b = idx / G;
  const long long base = b * z4::kVars * G + (idx - b * G);
  const T* const grads[3] = {g0, g1, g2};
  auto load_q = [&](int s) { return q[base + s * G]; };
  auto load_dq = [&](int k, int s) { return grads[k][base + s * G]; };
  auto store = [&](int s, T v) { out[base + s * G] = v; };
  z4::rhs<T>(load_q, load_dq, p, store);
}

// The shifted instance: the same layout over 53 slots.  The algebra reads
// the gauge sector of q before it writes a result (csrc/z4_shift.cuh); out
// is the wrapper's own tensor, never q.
template <typename T>
__global__ void __launch_bounds__(kBlock)
rhs_all_z4_shift(const T* __restrict__ q, const T* __restrict__ g0, const T* __restrict__ g1,
                 const T* __restrict__ g2, T* __restrict__ out, long long n_points,
                 long long G, z4s::Params p) {
  const long long idx = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= n_points) return;
  const long long b = idx / G;
  const long long base = b * z4s::kVars * G + (idx - b * G);
  const T* const grads[3] = {g0, g1, g2};
  auto load_q = [&](int s) { return q[base + s * G]; };
  auto load_dq = [&](int k, int s) { return grads[k][base + s * G]; };
  auto store = [&](int s, T v) { out[base + s * G] = v; };
  z4s::rhs<T>(load_q, load_dq, p, store);
}

// The Z4+GRHD instance (K5 d): the same layout over 43 slots.  The algebra
// recovers the fluid's primitives from q before it writes a result
// (csrc/z4_matter.cuh); it reads no gradient of the hydro slots.
template <typename T>
__global__ void __launch_bounds__(kBlock)
rhs_all_z4_matter(const T* __restrict__ q, const T* __restrict__ g0, const T* __restrict__ g1,
                  const T* __restrict__ g2, T* __restrict__ out, long long n_points,
                  long long G, z4m::Params p) {
  const long long idx = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= n_points) return;
  const long long b = idx / G;
  const long long base = b * z4m::kVars * G + (idx - b * G);
  const T* const grads[3] = {g0, g1, g2};
  auto load_q = [&](int s) { return q[base + s * G]; };
  auto load_dq = [&](int k, int s) { return grads[k][base + s * G]; };
  auto store = [&](int s, T v) { out[base + s * G] = v; };
  z4m::rhs<T>(load_q, load_dq, p, store);
}

// The Z4+GRMHD instance (K5 e): the same layout over 47 slots.  The algebra
// recovers the primitives from q before it writes a result
// (csrc/z4_grmhd.cuh); it reads no gradient of the matter slots.
template <typename T>
__global__ void __launch_bounds__(kBlock)
rhs_all_z4_grmhd(const T* __restrict__ q, const T* __restrict__ g0, const T* __restrict__ g1,
                 const T* __restrict__ g2, T* __restrict__ out, long long n_points,
                 long long G, z4gm::Params p) {
  const long long idx = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= n_points) return;
  const long long b = idx / G;
  const long long base = b * z4gm::kVars * G + (idx - b * G);
  const T* const grads[3] = {g0, g1, g2};
  auto load_q = [&](int s) { return q[base + s * G]; };
  auto load_dq = [&](int k, int s) { return grads[k][base + s * G]; };
  auto store = [&](int s, T v) { out[base + s * G] = v; };
  z4gm::rhs<T>(load_q, load_dq, p, store);
}

// K5 b: the 38-variable instance on a 2-D grid, two gradient arrays.  The
// algebra is 3-D; the derivatives along the absent third axis are zero, as
// the plain version zero-fills them (models/z4.py::_rhs_all_of).  The zero
// comes in at run time (`zero`, which the launcher sets to 0): a zero the
// compiler saw would fold the products it enters, and f32 would then round
// the terms the plain version keeps (x·0 = 0 exactly, its sums unchanged)
// otherwise than it; with it, the instance is rhs_all_z4's code.
template <typename T>
__global__ void __launch_bounds__(kBlock)
rhs_all_z4_2d(const T* __restrict__ q, const T* __restrict__ g0, const T* __restrict__ g1,
              T* __restrict__ out, long long n_points, long long G, z4::Params p, T zero) {
  const long long idx = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= n_points) return;
  const long long b = idx / G;
  const long long base = b * z4::kVars * G + (idx - b * G);
  const T* const grads[2] = {g0, g1};
  auto load_q = [&](int s) { return q[base + s * G]; };
  auto load_dq = [&](int k, int s) { return k == 2 ? zero : grads[k][base + s * G]; };
  auto store = [&](int s, T v) { out[base + s * G] = v; };
  z4::rhs<T>(load_q, load_dq, p, store);
}

// K5 b's shifted instance: rhs_all_z4_shift's algebra on a 2-D grid, two
// gradient arrays and the third a run-time zero, as in rhs_all_z4_2d.
template <typename T>
__global__ void __launch_bounds__(kBlock)
rhs_all_z4_shift_2d(const T* __restrict__ q, const T* __restrict__ g0,
                    const T* __restrict__ g1, T* __restrict__ out, long long n_points,
                    long long G, z4s::Params p, T zero) {
  const long long idx = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= n_points) return;
  const long long b = idx / G;
  const long long base = b * z4s::kVars * G + (idx - b * G);
  const T* const grads[2] = {g0, g1};
  auto load_q = [&](int s) { return q[base + s * G]; };
  auto load_dq = [&](int k, int s) { return k == 2 ? zero : grads[k][base + s * G]; };
  auto store = [&](int s, T v) { out[base + s * G] = v; };
  z4s::rhs<T>(load_q, load_dq, p, store);
}

// K5 b's Z4+GRHD instance: rhs_all_z4_matter's algebra on a 2-D grid, two
// gradient arrays and the third a run-time zero, as in rhs_all_z4_2d.
template <typename T>
__global__ void __launch_bounds__(kBlock)
rhs_all_z4_matter_2d(const T* __restrict__ q, const T* __restrict__ g0,
                     const T* __restrict__ g1, T* __restrict__ out, long long n_points,
                     long long G, z4m::Params p, T zero) {
  const long long idx = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= n_points) return;
  const long long b = idx / G;
  const long long base = b * z4m::kVars * G + (idx - b * G);
  const T* const grads[2] = {g0, g1};
  auto load_q = [&](int s) { return q[base + s * G]; };
  auto load_dq = [&](int k, int s) { return k == 2 ? zero : grads[k][base + s * G]; };
  auto store = [&](int s, T v) { out[base + s * G] = v; };
  z4m::rhs<T>(load_q, load_dq, p, store);
}

// K5 b's Z4+GRMHD instance: rhs_all_z4_grmhd's algebra on a 2-D grid, two
// gradient arrays and the third a run-time zero, as in rhs_all_z4_2d.
template <typename T>
__global__ void __launch_bounds__(kBlock)
rhs_all_z4_grmhd_2d(const T* __restrict__ q, const T* __restrict__ g0,
                    const T* __restrict__ g1, T* __restrict__ out, long long n_points,
                    long long G, z4gm::Params p, T zero) {
  const long long idx = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= n_points) return;
  const long long b = idx / G;
  const long long base = b * z4gm::kVars * G + (idx - b * G);
  const T* const grads[2] = {g0, g1};
  auto load_q = [&](int s) { return q[base + s * G]; };
  auto load_dq = [&](int k, int s) { return k == 2 ? zero : grads[k][base + s * G]; };
  auto store = [&](int s, T v) { out[base + s * G] = v; };
  z4gm::rhs<T>(load_q, load_dq, p, store);
}

template <typename T>
int launch(const T* q, const T* g0, const T* g1, const T* g2, T* out, long long n_lead,
           int n_vars, long long n_grid, int slicing, double f, double m, double kappa1,
           double kappa2, void* stream) {
  if (n_vars != z4::kVars || n_lead <= 0 || n_grid <= 0 || (slicing != 0 && slicing != 1)) {
    return cudaErrorInvalidValue;
  }
  const long long n_points = n_lead * n_grid;
  const long long blocks = (n_points + kBlock - 1) / kBlock;
  const z4::Params p{slicing, f, m, kappa1, kappa2};
  rhs_all_z4<T><<<static_cast<unsigned>(blocks), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      q, g0, g1, g2, out, n_points, n_grid, p);
  return cudaGetLastError();
}

template <typename T>
int launch_2d(const T* q, const T* g0, const T* g1, T* out, long long n_lead, int n_vars,
              long long n_grid, int slicing, double f, double m, double kappa1, double kappa2,
              void* stream) {
  if (n_vars != z4::kVars || n_lead <= 0 || n_grid <= 0 || (slicing != 0 && slicing != 1)) {
    return cudaErrorInvalidValue;
  }
  const long long n_points = n_lead * n_grid;
  const long long blocks = (n_points + kBlock - 1) / kBlock;
  const z4::Params p{slicing, f, m, kappa1, kappa2};
  rhs_all_z4_2d<T><<<static_cast<unsigned>(blocks), kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(q, g0, g1, out, n_points, n_grid, p,
                                                          T(0));
  return cudaGetLastError();
}

template <typename T>
int launch_shift(const T* q, const T* g0, const T* g1, const T* g2, T* out, long long n_lead,
                 int n_vars, long long n_grid, int slicing, double f, double m, double kappa1,
                 double kappa2, int shift, double f_b, double eta, void* stream) {
  if (n_vars != z4s::kVars || n_lead <= 0 || n_grid <= 0 || (slicing != 0 && slicing != 1) ||
      (shift != 0 && shift != 1)) {
    return cudaErrorInvalidValue;
  }
  const long long n_points = n_lead * n_grid;
  const long long blocks = (n_points + kBlock - 1) / kBlock;
  const z4s::Params p{{slicing, f, m, kappa1, kappa2}, shift, f_b, eta};
  rhs_all_z4_shift<T>
      <<<static_cast<unsigned>(blocks), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          q, g0, g1, g2, out, n_points, n_grid, p);
  return cudaGetLastError();
}

template <typename T>
int launch_shift_2d(const T* q, const T* g0, const T* g1, T* out, long long n_lead, int n_vars,
                    long long n_grid, int slicing, double f, double m, double kappa1,
                    double kappa2, int shift, double f_b, double eta, void* stream) {
  if (n_vars != z4s::kVars || n_lead <= 0 || n_grid <= 0 || (slicing != 0 && slicing != 1) ||
      (shift != 0 && shift != 1)) {
    return cudaErrorInvalidValue;
  }
  const long long n_points = n_lead * n_grid;
  const long long blocks = (n_points + kBlock - 1) / kBlock;
  const z4s::Params p{{slicing, f, m, kappa1, kappa2}, shift, f_b, eta};
  rhs_all_z4_shift_2d<T>
      <<<static_cast<unsigned>(blocks), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          q, g0, g1, out, n_points, n_grid, p, T(0));
  return cudaGetLastError();
}

template <typename T>
int launch_matter(const T* q, const T* g0, const T* g1, const T* g2, T* out, long long n_lead,
                  int n_vars, long long n_grid, int slicing, double f, double m, double kappa1,
                  double kappa2, double gamma, int iters, void* stream) {
  if (n_vars != z4m::kVars || n_lead <= 0 || n_grid <= 0 || (slicing != 0 && slicing != 1) ||
      iters < 0) {
    return cudaErrorInvalidValue;
  }
  const long long n_points = n_lead * n_grid;
  const long long blocks = (n_points + kBlock - 1) / kBlock;
  const z4m::Params p{{slicing, f, m, kappa1, kappa2}, gamma, iters};
  rhs_all_z4_matter<T>
      <<<static_cast<unsigned>(blocks), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          q, g0, g1, g2, out, n_points, n_grid, p);
  return cudaGetLastError();
}

template <typename T>
int launch_matter_2d(const T* q, const T* g0, const T* g1, T* out, long long n_lead, int n_vars,
                     long long n_grid, int slicing, double f, double m, double kappa1,
                     double kappa2, double gamma, int iters, void* stream) {
  if (n_vars != z4m::kVars || n_lead <= 0 || n_grid <= 0 || (slicing != 0 && slicing != 1) ||
      iters < 0) {
    return cudaErrorInvalidValue;
  }
  const long long n_points = n_lead * n_grid;
  const long long blocks = (n_points + kBlock - 1) / kBlock;
  const z4m::Params p{{slicing, f, m, kappa1, kappa2}, gamma, iters};
  rhs_all_z4_matter_2d<T>
      <<<static_cast<unsigned>(blocks), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          q, g0, g1, out, n_points, n_grid, p, T(0));
  return cudaGetLastError();
}

template <typename T>
int launch_grmhd(const T* q, const T* g0, const T* g1, const T* g2, T* out, long long n_lead,
                 int n_vars, long long n_grid, int slicing, double f, double m, double kappa1,
                 double kappa2, double gamma, int iters, double c_h, double glm_kappa,
                 void* stream) {
  if (n_vars != z4gm::kVars || n_lead <= 0 || n_grid <= 0 || (slicing != 0 && slicing != 1) ||
      iters < 0) {
    return cudaErrorInvalidValue;
  }
  const long long n_points = n_lead * n_grid;
  const long long blocks = (n_points + kBlock - 1) / kBlock;
  const z4gm::Params p{{slicing, f, m, kappa1, kappa2}, gamma, iters, c_h, glm_kappa};
  rhs_all_z4_grmhd<T>
      <<<static_cast<unsigned>(blocks), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          q, g0, g1, g2, out, n_points, n_grid, p);
  return cudaGetLastError();
}

template <typename T>
int launch_grmhd_2d(const T* q, const T* g0, const T* g1, T* out, long long n_lead, int n_vars,
                    long long n_grid, int slicing, double f, double m, double kappa1,
                    double kappa2, double gamma, int iters, double c_h, double glm_kappa,
                    void* stream) {
  if (n_vars != z4gm::kVars || n_lead <= 0 || n_grid <= 0 || (slicing != 0 && slicing != 1) ||
      iters < 0) {
    return cudaErrorInvalidValue;
  }
  const long long n_points = n_lead * n_grid;
  const long long blocks = (n_points + kBlock - 1) / kBlock;
  const z4gm::Params p{{slicing, f, m, kappa1, kappa2}, gamma, iters, c_h, glm_kappa};
  rhs_all_z4_grmhd_2d<T>
      <<<static_cast<unsigned>(blocks), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          q, g0, g1, out, n_points, n_grid, p, T(0));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueues K5 on `stream` and returns the launch's cudaError_t (0 =
// cudaSuccess).  q, g0, g1, g2 and out are contiguous [n_lead, n_vars,
// n_grid]; only n_vars = 38 is instantiated.  slicing: 0 harmonic, 1 1+log.

int exahype_rhs_all_z4_f32(const float* q, const float* g0, const float* g1, const float* g2,
                           float* out, long long n_lead, int n_vars, long long n_grid,
                           int slicing, double f, double m, double kappa1, double kappa2,
                           void* stream) {
  return launch<float>(q, g0, g1, g2, out, n_lead, n_vars, n_grid, slicing, f, m, kappa1,
                       kappa2, stream);
}

int exahype_rhs_all_z4_f64(const double* q, const double* g0, const double* g1,
                           const double* g2, double* out, long long n_lead, int n_vars,
                           long long n_grid, int slicing, double f, double m, double kappa1,
                           double kappa2, void* stream) {
  return launch<double>(q, g0, g1, g2, out, n_lead, n_vars, n_grid, slicing, f, m, kappa1,
                        kappa2, stream);
}

// K5 b, the 38-variable instance on a 2-D grid: the same without g2 (the
// third axis's derivatives are zero).

int exahype_rhs_all_z4_2d_f32(const float* q, const float* g0, const float* g1, float* out,
                              long long n_lead, int n_vars, long long n_grid, int slicing,
                              double f, double m, double kappa1, double kappa2, void* stream) {
  return launch_2d<float>(q, g0, g1, out, n_lead, n_vars, n_grid, slicing, f, m, kappa1, kappa2,
                          stream);
}

int exahype_rhs_all_z4_2d_f64(const double* q, const double* g0, const double* g1, double* out,
                              long long n_lead, int n_vars, long long n_grid, int slicing,
                              double f, double m, double kappa1, double kappa2, void* stream) {
  return launch_2d<double>(q, g0, g1, out, n_lead, n_vars, n_grid, slicing, f, m, kappa1,
                           kappa2, stream);
}

// The shifted instance: the same, n_vars = 53, and after kappa2 the shift
// condition (0 frozen, 1 Gamma-driver) with the Gamma-driver's f_b and eta.

int exahype_rhs_all_z4_shift_f32(const float* q, const float* g0, const float* g1,
                                 const float* g2, float* out, long long n_lead, int n_vars,
                                 long long n_grid, int slicing, double f, double m,
                                 double kappa1, double kappa2, int shift, double f_b,
                                 double eta, void* stream) {
  return launch_shift<float>(q, g0, g1, g2, out, n_lead, n_vars, n_grid, slicing, f, m, kappa1,
                             kappa2, shift, f_b, eta, stream);
}

int exahype_rhs_all_z4_shift_f64(const double* q, const double* g0, const double* g1,
                                 const double* g2, double* out, long long n_lead, int n_vars,
                                 long long n_grid, int slicing, double f, double m,
                                 double kappa1, double kappa2, int shift, double f_b,
                                 double eta, void* stream) {
  return launch_shift<double>(q, g0, g1, g2, out, n_lead, n_vars, n_grid, slicing, f, m,
                              kappa1, kappa2, shift, f_b, eta, stream);
}

// The Z4+GRHD instance (K5 d): the same, n_vars = 43, and after kappa2 the
// fluid's gamma and the recovery's Newton iterations (at least 0).

int exahype_rhs_all_z4_matter_f32(const float* q, const float* g0, const float* g1,
                                  const float* g2, float* out, long long n_lead, int n_vars,
                                  long long n_grid, int slicing, double f, double m,
                                  double kappa1, double kappa2, double gamma, int iters,
                                  void* stream) {
  return launch_matter<float>(q, g0, g1, g2, out, n_lead, n_vars, n_grid, slicing, f, m, kappa1,
                              kappa2, gamma, iters, stream);
}

int exahype_rhs_all_z4_matter_f64(const double* q, const double* g0, const double* g1,
                                  const double* g2, double* out, long long n_lead, int n_vars,
                                  long long n_grid, int slicing, double f, double m,
                                  double kappa1, double kappa2, double gamma, int iters,
                                  void* stream) {
  return launch_matter<double>(q, g0, g1, g2, out, n_lead, n_vars, n_grid, slicing, f, m,
                               kappa1, kappa2, gamma, iters, stream);
}

// K5 b's Z4+GRHD instance on a 2-D grid: the same without g2.

int exahype_rhs_all_z4_matter_2d_f32(const float* q, const float* g0, const float* g1,
                                     float* out, long long n_lead, int n_vars, long long n_grid,
                                     int slicing, double f, double m, double kappa1,
                                     double kappa2, double gamma, int iters, void* stream) {
  return launch_matter_2d<float>(q, g0, g1, out, n_lead, n_vars, n_grid, slicing, f, m, kappa1,
                                 kappa2, gamma, iters, stream);
}

int exahype_rhs_all_z4_matter_2d_f64(const double* q, const double* g0, const double* g1,
                                     double* out, long long n_lead, int n_vars, long long n_grid,
                                     int slicing, double f, double m, double kappa1,
                                     double kappa2, double gamma, int iters, void* stream) {
  return launch_matter_2d<double>(q, g0, g1, out, n_lead, n_vars, n_grid, slicing, f, m,
                                  kappa1, kappa2, gamma, iters, stream);
}

// The Z4+GRMHD instance (K5 e): the same, n_vars = 47, and after kappa2 the
// fluid's gamma, the recovery's Newton iterations (at least 0), the
// cleaning speed c_h and the GLM damping glm_kappa.

int exahype_rhs_all_z4_grmhd_f32(const float* q, const float* g0, const float* g1,
                                 const float* g2, float* out, long long n_lead, int n_vars,
                                 long long n_grid, int slicing, double f, double m,
                                 double kappa1, double kappa2, double gamma, int iters,
                                 double c_h, double glm_kappa, void* stream) {
  return launch_grmhd<float>(q, g0, g1, g2, out, n_lead, n_vars, n_grid, slicing, f, m, kappa1,
                             kappa2, gamma, iters, c_h, glm_kappa, stream);
}

int exahype_rhs_all_z4_grmhd_f64(const double* q, const double* g0, const double* g1,
                                 const double* g2, double* out, long long n_lead, int n_vars,
                                 long long n_grid, int slicing, double f, double m,
                                 double kappa1, double kappa2, double gamma, int iters,
                                 double c_h, double glm_kappa, void* stream) {
  return launch_grmhd<double>(q, g0, g1, g2, out, n_lead, n_vars, n_grid, slicing, f, m,
                              kappa1, kappa2, gamma, iters, c_h, glm_kappa, stream);
}

// K5 b's Z4+GRMHD instance on a 2-D grid: the same without g2.

int exahype_rhs_all_z4_grmhd_2d_f32(const float* q, const float* g0, const float* g1,
                                    float* out, long long n_lead, int n_vars, long long n_grid,
                                    int slicing, double f, double m, double kappa1,
                                    double kappa2, double gamma, int iters, double c_h,
                                    double glm_kappa, void* stream) {
  return launch_grmhd_2d<float>(q, g0, g1, out, n_lead, n_vars, n_grid, slicing, f, m, kappa1,
                                kappa2, gamma, iters, c_h, glm_kappa, stream);
}

int exahype_rhs_all_z4_grmhd_2d_f64(const double* q, const double* g0, const double* g1,
                                    double* out, long long n_lead, int n_vars, long long n_grid,
                                    int slicing, double f, double m, double kappa1,
                                    double kappa2, double gamma, int iters, double c_h,
                                    double glm_kappa, void* stream) {
  return launch_grmhd_2d<double>(q, g0, g1, out, n_lead, n_vars, n_grid, slicing, f, m,
                                 kappa1, kappa2, gamma, iters, c_h, glm_kappa, stream);
}

// K5 b's shifted instance on a 2-D grid: the shifted instance's arguments
// without g2.

int exahype_rhs_all_z4_shift_2d_f32(const float* q, const float* g0, const float* g1,
                                    float* out, long long n_lead, int n_vars, long long n_grid,
                                    int slicing, double f, double m, double kappa1,
                                    double kappa2, int shift, double f_b, double eta,
                                    void* stream) {
  return launch_shift_2d<float>(q, g0, g1, out, n_lead, n_vars, n_grid, slicing, f, m, kappa1,
                                kappa2, shift, f_b, eta, stream);
}

int exahype_rhs_all_z4_shift_2d_f64(const double* q, const double* g0, const double* g1,
                                    double* out, long long n_lead, int n_vars, long long n_grid,
                                    int slicing, double f, double m, double kappa1,
                                    double kappa2, int shift, double f_b, double eta,
                                    void* stream) {
  return launch_shift_2d<double>(q, g0, g1, out, n_lead, n_vars, n_grid, slicing, f, m, kappa1,
                                 kappa2, shift, f_b, eta, stream);
}

}  // extern "C"
