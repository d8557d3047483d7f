// A/B lever (b, c) of the K3 redesign, for scripts/torch_kernel_ab.py --k3
// only: the first K3 kernel, exahype_tpu_torch/csrc/subcell.cu as of commit
// 50bcef4 (a thread a pencil, LB = one 32-byte sector of cells x 49
// transverse positions a block) with the current C interface of that
// file: the active prefix (a block past n_active * L zeroes its g values
// and returns; each cell is masked) and a separate s_out, so it runs out
// of place (b) or in place (c).  With -DK3_RESTRICT, s and s_new are
// __restrict__ as in that kernel (out of place only).  Not built into the
// port's library.

#include <cuda_runtime.h>

#include "euler.cuh"

#ifdef K3_RESTRICT
#define K3_RESTRICT_Q __restrict__
#else
#define K3_RESTRICT_Q
#endif

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
subcell_row_sweep(const T* K3_RESTRICT_Q s, const T* __restrict__ ghost_lo,
                  const T* __restrict__ ghost_hi, T* K3_RESTRICT_Q s_new,
                  T* __restrict__ g_lo, T* __restrict__ g_hi,
                  const T* __restrict__ dt_ptr, T dt_val, T h, T gm1, T gamma,
                  const long long* __restrict__ n_active, long long n_slots, long long L) {
  constexpr int NT = NSUB * NSUB;  // transverse positions
  constexpr int V = kVars;
  // sG[side][v][t][c]: side 0 = low face, 1 = high face.
  __shared__ T sG[2][V][NT][LB];

  const int c = threadIdx.x;
  const int t = threadIdx.y;
  const long long n_kl = n_slots * L;
  long long n_act = *n_active;
  n_act = n_act < 0 ? 0 : (n_act > n_slots ? n_slots : n_act);
  const long long n_act_kl = n_act * L;
  const long long kl0 = static_cast<long long>(blockIdx.x) * LB;
  if (kl0 >= n_act_kl) {  // no active cell: zero g and leave s alone
    const int r = threadIdx.y * LB + threadIdx.x;
    if (r < 2 * V * LB && kl0 + r % LB < n_kl) {
      (r < V * LB ? g_lo : g_hi)[((r / LB) % V) * n_kl + kl0 + r % LB] = T(0);
    }
    return;
  }
  const long long kl_raw = kl0 + c;
  const bool valid = kl_raw < n_act_kl;
  const long long kl = valid ? kl_raw : n_act_kl - 1;  // inactive cell: clamp

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
    if (kl_out < n_kl) {
      (side == 0 ? g_lo : g_hi)[v * vs + kl_out] = kl_out < n_act_kl ? acc / T(NT) : T(0);
    }
  }
}

template <typename T, int DIR>
cudaError_t launch_dir(const T* s, T* s_out, const T* ghost_lo, const T* ghost_hi, T* g_lo,
                       T* g_hi, const T* dt_ptr, T dt_val, T h, T gm1, T gamma,
                       const long long* n_active, long long n_slots, long long L,
                       cudaStream_t stream) {
  constexpr int NSUB = 7;
  constexpr int LB = cells_per_block<T>();
  const long long blocks = (n_slots * L + LB - 1) / LB;
  subcell_row_sweep<T, NSUB, DIR, LB><<<static_cast<unsigned>(blocks), dim3(LB, NSUB * NSUB),
                                        0, stream>>>(s, ghost_lo, ghost_hi, s_out, g_lo, g_hi,
                                                     dt_ptr, dt_val, h, gm1, gamma, n_active,
                                                     n_slots, L);
  return cudaGetLastError();
}

template <typename T>
int launch_row_sweep(const T* s, T* s_out, const T* ghost_lo, const T* ghost_hi, T* g_lo,
                     T* g_hi, const T* dt_ptr, double dt_val, double h, double gamma, int dim,
                     int n_sub, int n_vars, int d, const long long* n_active, long long n_slots,
                     long long L, void* stream) {
  if (dim != kDim || n_sub != 7 || n_vars != kVars || n_slots <= 0 || L <= 0 || h <= 0.0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T gm1 = static_cast<T>(gamma - 1.0);
  const T a[3] = {static_cast<T>(dt_val), static_cast<T>(h), static_cast<T>(gamma)};
  switch (d) {
    case 0:
      return launch_dir<T, 0>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr, a[0], a[1],
                              gm1, a[2], n_active, n_slots, L, st);
    case 1:
      return launch_dir<T, 1>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr, a[0], a[1],
                              gm1, a[2], n_active, n_slots, L, st);
    case 2:
      return launch_dir<T, 2>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr, a[0], a[1],
                              gm1, a[2], n_active, n_slots, L, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int exahype_subcell_row_sweep_f32(const float* s, float* s_out, const float* ghost_lo,
                                  const float* ghost_hi, float* g_lo, float* g_hi,
                                  const float* dt_ptr, double dt_val, double h, double gamma,
                                  int dim, int n_sub, int n_vars, int d,
                                  const long long* n_active, long long n_slots, long long L,
                                  void* stream) {
  return launch_row_sweep<float>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr, dt_val, h,
                                 gamma, dim, n_sub, n_vars, d, n_active, n_slots, L, stream);
}

}  // extern "C"
