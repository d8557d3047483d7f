// One directional sweep of the limiter's subcell Rusanov FV fallback over the
// gathered troubled rows, 3-D compressible Euler, for Hopper (sm_90a).
//
// Replaces the TPU kernel exahype_tpu/models/subcell_pallas.py::
// row_sweep_call.  The numbers to match are those of exahype_tpu/models/
// limiter.py::LimitedADERDG._row_sweep_math; the plain PyTorch version is
// exahype_tpu_torch/models/limiter.py::LimitedADERDG._row_sweep_math.
//
// Shapes (the gathered batch of K rows of L cells, n_sub = 2N+1 subcells
// per axis): s and s_new [n_sub, n_sub, n_sub, V, K, L]; ghost_lo and
// ghost_hi the same with sub-axis d cut to 1 (the subcell layers beyond the
// first and the last subcell along d); g_lo and g_hi [V, K, L], the fluxes
// through each cell's low and high face along d averaged over the n_sub^2
// transverse subcells.
//
// What bounds it on the H100.  Each output element needs only its pencil
// along d: n_sub subcells and the two ghosts at the same transverse
// position.  Per subcell that is one Euler flux and one wave speed (~37
// flops) and the Rusanov face and update (~75 flops) against 40 bytes read
// and written in f32: ~3 flops per byte, far below the card's f32 ridge of
// ~20.  So the kernel is memory-bound, and the design reads s and the
// ghosts once and writes s_new once, with nothing else in device memory.
//
// Design.  One thread per (transverse position, k, l) holds its pencil in
// registers and walks it face by face: each face's flux is computed once and
// used by both subcells beside it (face j lies between subcells j-1 and j,
// face 0 against ghost_lo, face n_sub against ghost_hi), as the plain
// version's hi and lo fluxes of one face are the same operands in the same
// order.  A block holds all n_sub^2 transverse positions of LB consecutive
// (k, l) cells, LB = one 32-byte sector of values, so every load and store
// of a warp is whole sectors.  The transverse means g_lo and g_hi are summed
// in shared memory in a fixed order (transverse position 0 first), so the
// kernel has no float atomics and two runs are bitwise equal.  The sweep
// direction is a template parameter, so the flux's component indices are
// compile-time constants.  IEEE division and square root (no fast math);
// the Euler physics is csrc/euler.cuh, shared with the ADER-DG kernels.

#include <cuda_runtime.h>

#include "euler.cuh"

namespace {

constexpr int kDim = 3;
constexpr int kVars = kDim + 2;

template <typename T>
constexpr int cells_per_block() { return 32 / static_cast<int>(sizeof(T)); }

// Rusanov flux between left state (qa, fa, sa) and right state (qb, fb, sb):
// ½(fa + fb) − ½ max(sa, sb) (qb − qa), the plain version's operand order.
template <typename T>
__device__ __forceinline__ void rusanov(const T* qa, const T* fa, T sa, const T* qb,
                                        const T* fb, T sb, T* fhat) {
  const T s = dmax(sa, sb);
#pragma unroll
  for (int v = 0; v < kVars; ++v) {
    fhat[v] = T(0.5) * (fa[v] + fb[v]) - T(0.5) * s * (qb[v] - qa[v]);
  }
}

template <typename T, int DIR>
__device__ __forceinline__ void physics(const T* q, T gm1, T gamma, T* f, T* e) {
  euler_flux<T, kDim, kVars>(q, DIR, gm1, f);
  *e = euler_max_eigenvalue<T, kDim>(q, q[DIR + 1], gm1, gamma);
}

template <typename T, int NSUB, int DIR, int LB>
__global__ void __launch_bounds__(LB * NSUB * NSUB)
subcell_row_sweep(const T* __restrict__ s, const T* __restrict__ ghost_lo,
                  const T* __restrict__ ghost_hi, T* __restrict__ s_new,
                  T* __restrict__ g_lo, T* __restrict__ g_hi,
                  const T* __restrict__ dt_ptr, T dt_val, T h, T gm1, T gamma,
                  long long n_kl) {
  constexpr int NT = NSUB * NSUB;  // transverse positions
  constexpr int V = kVars;
  // sG[side][v][t][c]: side 0 = low face, 1 = high face.
  __shared__ T sG[2][V][NT][LB];

  const int c = threadIdx.x;
  const int t = threadIdx.y;
  const long long kl_raw = static_cast<long long>(blockIdx.x) * LB + c;
  const bool valid = kl_raw < n_kl;
  const long long kl = valid ? kl_raw : n_kl - 1;  // ragged tail: clamp

  // Strides of s in units of n_kl: sub-axes 0, 1, 2, then the variables.
  const long long vs = n_kl;
  const long long st[kDim] = {NSUB * NSUB * V * vs, NSUB * V * vs, V * vs};
  // The transverse position's two sub-axes, in order.
  constexpr int O0 = DIR == 0 ? 1 : 0;
  constexpr int O1 = DIR == 2 ? 1 : 2;
  const int a = t / NSUB, b = t % NSUB;
  const long long base = a * st[O0] + b * st[O1] + kl;
  // Ghosts: [.., V, K, L] with sub-axis DIR of size 1.
  const long long gbase = static_cast<long long>(t) * V * vs + kl;

  const T dtv = dt_ptr != nullptr ? *dt_ptr : dt_val;
  const T lam = dtv / h;

  // Left state of the face being computed, its flux and wave speed.
  T qa[V], fa[V], ea;
#pragma unroll
  for (int v = 0; v < V; ++v) qa[v] = ghost_lo[gbase + v * vs];
  physics<T, DIR>(qa, gm1, gamma, fa, &ea);

  T f_lo[V];  // flux through the low face of the subcell being updated
#pragma unroll
  for (int j = 0; j <= NSUB; ++j) {
    T qb[V], fb[V], eb, fhat[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      qb[v] = j < NSUB ? s[base + j * st[DIR] + v * vs] : ghost_hi[gbase + v * vs];
    }
    physics<T, DIR>(qb, gm1, gamma, fb, &eb);
    rusanov(qa, fa, ea, qb, fb, eb, fhat);
    if (j == 0) {
#pragma unroll
      for (int v = 0; v < V; ++v) sG[0][v][t][c] = fhat[v];
    } else {
      // Subcell j-1 (state qa) between faces j-1 and j.
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const T x = qa[v] - lam * (fhat[v] - f_lo[v]);
        if (valid) s_new[base + (j - 1) * st[DIR] + v * vs] = x;
      }
    }
    if (j == NSUB) {
#pragma unroll
      for (int v = 0; v < V; ++v) sG[1][v][t][c] = fhat[v];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      f_lo[v] = fhat[v];
      qa[v] = qb[v];
      fa[v] = fb[v];
    }
    ea = eb;
  }
  __syncthreads();

  // Transverse means: thread r < 2·V·LB owns one (side, v, c) and sums the
  // NT positions in order.
  const int r = threadIdx.y * LB + threadIdx.x;
  if (r < 2 * V * LB) {
    const int side = r / (V * LB);
    const int v = (r / LB) % V;
    const int cc = r % LB;
    const long long kl_out = static_cast<long long>(blockIdx.x) * LB + cc;
    T acc = sG[side][v][0][cc];
#pragma unroll
    for (int p = 1; p < NT; ++p) acc = acc + sG[side][v][p][cc];
    if (kl_out < n_kl) (side == 0 ? g_lo : g_hi)[v * vs + kl_out] = acc / T(NT);
  }
}

template <typename T, int DIR>
cudaError_t launch_dir(const T* s, const T* ghost_lo, const T* ghost_hi, T* s_new, T* g_lo,
                       T* g_hi, const T* dt_ptr, T dt_val, T h, T gm1, T gamma,
                       long long n_kl, cudaStream_t stream) {
  constexpr int NSUB = 7;
  constexpr int LB = cells_per_block<T>();
  const long long blocks = (n_kl + LB - 1) / LB;
  subcell_row_sweep<T, NSUB, DIR, LB><<<static_cast<unsigned>(blocks), dim3(LB, NSUB * NSUB),
                                        0, stream>>>(s, ghost_lo, ghost_hi, s_new, g_lo, g_hi,
                                                     dt_ptr, dt_val, h, gm1, gamma, n_kl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_row_sweep(const T* s, const T* ghost_lo, const T* ghost_hi, T* s_new,
                             T* g_lo, T* g_hi, const T* dt_ptr, double dt_val, double h,
                             double gamma, int dim, int n_sub, int n_vars, int d,
                             long long n_kl, void* stream) {
  if (dim != kDim || n_sub != 7 || n_vars != kVars || n_kl <= 0 || h <= 0.0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T gm1 = static_cast<T>(gamma - 1.0);
  const T args[3] = {static_cast<T>(dt_val), static_cast<T>(h), static_cast<T>(gamma)};
  switch (d) {
    case 0:
      return launch_dir<T, 0>(s, ghost_lo, ghost_hi, s_new, g_lo, g_hi, dt_ptr, args[0],
                              args[1], gm1, args[2], n_kl, st);
    case 1:
      return launch_dir<T, 1>(s, ghost_lo, ghost_hi, s_new, g_lo, g_hi, dt_ptr, args[0],
                              args[1], gm1, args[2], n_kl, st);
    case 2:
      return launch_dir<T, 2>(s, ghost_lo, ghost_hi, s_new, g_lo, g_hi, dt_ptr, args[0],
                              args[1], gm1, args[2], n_kl, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Enqueues one sweep along sub-axis d on `stream` and returns the launch's
// cudaError_t (0 = cudaSuccess).  dt_ptr: a device scalar of the state's
// dtype, or null to use dt_val; h = dx_d / n_sub, the subcell width.
// n_kl = K * L.  Only dim 3, n_sub 7 and the 5 Euler variables are
// instantiated; anything else returns cudaErrorInvalidValue.

int exahype_subcell_row_sweep_f32(const float* s, const float* ghost_lo,
                                  const float* ghost_hi, float* s_new, float* g_lo,
                                  float* g_hi, const float* dt_ptr, double dt_val, double h,
                                  double gamma, int dim, int n_sub, int n_vars, int d,
                                  long long n_kl, void* stream) {
  return launch_row_sweep<float>(s, ghost_lo, ghost_hi, s_new, g_lo, g_hi, dt_ptr, dt_val, h,
                                 gamma, dim, n_sub, n_vars, d, n_kl, stream);
}

int exahype_subcell_row_sweep_f64(const double* s, const double* ghost_lo,
                                  const double* ghost_hi, double* s_new, double* g_lo,
                                  double* g_hi, const double* dt_ptr, double dt_val, double h,
                                  double gamma, int dim, int n_sub, int n_vars, int d,
                                  long long n_kl, void* stream) {
  return launch_row_sweep<double>(s, ghost_lo, ghost_hi, s_new, g_lo, g_hi, dt_ptr, dt_val,
                                  h, gamma, dim, n_sub, n_vars, d, n_kl, stream);
}

}  // extern "C"
