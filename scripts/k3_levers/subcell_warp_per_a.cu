// A/B lever (d) of the K3 redesign, for scripts/torch_kernel_ab.py --k3
// only: the active prefix, in place, and a block of 32 (k, l) cells x n_sub
// warps, warp a = the first transverse index, each thread walking its n_sub
// pencils b in order with the edge fluxes summed over b in registers and
// over a in shared memory.  The production C interface of
// exahype_tpu_torch/csrc/subcell.cu.  Not built into the port's library.

#include <cuda_runtime.h>

#include "euler.cuh"

namespace {

constexpr int kDim = 3;
constexpr int kVars = kDim + 2;
constexpr int kSub = 7;
constexpr int kCells = 32;  // (k, l) cells a block: one warp's width

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

template <typename T, int NSUB, int DIR>
__global__ void __launch_bounds__(kCells * NSUB)
subcell_row_sweep(const T* s, T* s_out, const T* __restrict__ ghost_lo,
                  const T* __restrict__ ghost_hi, T* __restrict__ g_lo,
                  T* __restrict__ g_hi, const T* __restrict__ dt_ptr, T dt_val, T h, T gm1,
                  T gamma, const long long* __restrict__ n_active, long long n_slots,
                  long long L) {
  constexpr int V = kVars;
  constexpr int NT = NSUB * NSUB;  // transverse positions
  constexpr int NOUT = 2 * V * kCells;  // g values a block: (side, v, cell)
  // sG[side][v][a][c]: side 0 = low face, 1 = high face; the sum over b.
  __shared__ T sG[2][V][NSUB][kCells];

  const int c = threadIdx.x;
  const int a = threadIdx.y;
  const int tid = a * kCells + c;
  const long long n_kl = n_slots * L;
  const long long kl0 = static_cast<long long>(blockIdx.x) * kCells;
  long long n_act = *n_active;
  n_act = n_act < 0 ? 0 : (n_act > n_slots ? n_slots : n_act);
  const long long n_act_kl = n_act * L;
  const long long vs = n_kl;  // stride of the variable axis

  if (kl0 >= n_act_kl) {  // no active cell: zero g and leave s alone
    for (int r = tid; r < NOUT; r += kCells * NSUB) {
      const long long kl = kl0 + r % kCells;
      const int v = (r / kCells) % V;
      if (kl < n_kl) (r < V * kCells ? g_lo : g_hi)[v * vs + kl] = T(0);
    }
    return;
  }

  const long long kl = kl0 + c;
  if (kl < n_act_kl) {
    // Strides of s in units of n_kl: sub-axes 0, 1, 2, then the variables.
    const long long st[kDim] = {NT * V * vs, NSUB * V * vs, V * vs};
    // The transverse position's two sub-axes, in order.
    constexpr int O0 = DIR == 0 ? 1 : 0;
    constexpr int O1 = DIR == 2 ? 1 : 2;
    const T lam = (dt_ptr != nullptr ? *dt_ptr : dt_val) / h;
    T glo[V], ghi[V];  // the edge fluxes summed over b, in order
#pragma unroll
    for (int v = 0; v < V; ++v) glo[v] = ghi[v] = T(0);

#pragma unroll 1
    for (int b = 0; b < NSUB; ++b) {
      const long long base = a * st[O0] + b * st[O1] + kl;
      // Ghosts: [.., V, K, L] with sub-axis DIR of size 1.
      const long long gbase = static_cast<long long>(a * NSUB + b) * V * vs + kl;
      // The pencil: q[0] = ghost_lo, q[1..NSUB] = the subcells, q[NSUB+1] =
      // ghost_hi, all loaded before any store of this pencil.
      T q[NSUB + 2][V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        q[0][v] = ghost_lo[gbase + v * vs];
        q[NSUB + 1][v] = ghost_hi[gbase + v * vs];
      }
#pragma unroll
      for (int j = 0; j < NSUB; ++j) {
#pragma unroll
        for (int v = 0; v < V; ++v) q[j + 1][v] = s[base + j * st[DIR] + v * vs];
      }

      // Left state of the face being computed: its flux and wave speed.
      T fa[V], ea;
      physics<T, DIR>(q[0], gm1, gamma, fa, &ea);
      T f_lo[V];  // flux through the low face of the subcell being updated
#pragma unroll
      for (int j = 0; j <= NSUB; ++j) {
        T fb[V], eb, fhat[V];
        physics<T, DIR>(q[j + 1], gm1, gamma, fb, &eb);
        rusanov(q[j], fa, ea, q[j + 1], fb, eb, fhat);
        if (j == 0) {
#pragma unroll
          for (int v = 0; v < V; ++v) glo[v] = glo[v] + fhat[v];
        } else {
          // Subcell j-1 (state q[j]) between faces j-1 and j.
#pragma unroll
          for (int v = 0; v < V; ++v) {
            s_out[base + (j - 1) * st[DIR] + v * vs] = q[j][v] - lam * (fhat[v] - f_lo[v]);
          }
        }
        if (j == NSUB) {
#pragma unroll
          for (int v = 0; v < V; ++v) ghi[v] = ghi[v] + fhat[v];
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          f_lo[v] = fhat[v];
          fa[v] = fb[v];
        }
        ea = eb;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sG[0][v][a][c] = glo[v];
      sG[1][v][a][c] = ghi[v];
    }
  }
  __syncthreads();

  // Transverse means: output r = (side, v, cell), the NSUB partial sums
  // added in order of a; a warp writes one whole line of g.
  for (int r = tid; r < NOUT; r += kCells * NSUB) {
    const int cc = r % kCells;
    const int v = (r / kCells) % V;
    const int side = r / (V * kCells);
    const long long kl_out = kl0 + cc;
    if (kl_out >= n_kl) continue;
    T acc = T(0);
    if (kl_out < n_act_kl) {
      acc = sG[side][v][0][cc];
#pragma unroll
      for (int p = 1; p < NSUB; ++p) acc = acc + sG[side][v][p][cc];
      acc = acc / T(NT);
    }
    (side == 0 ? g_lo : g_hi)[v * vs + kl_out] = acc;
  }
}

template <typename T, int DIR>
cudaError_t launch_dir(const T* s, T* s_out, const T* ghost_lo, const T* ghost_hi, T* g_lo,
                       T* g_hi, const T* dt_ptr, T dt_val, T h, T gm1, T gamma,
                       const long long* n_active, long long n_slots, long long L,
                       cudaStream_t stream) {
  const long long blocks = (n_slots * L + kCells - 1) / kCells;
  subcell_row_sweep<T, kSub, DIR><<<static_cast<unsigned>(blocks), dim3(kCells, kSub), 0,
                                    stream>>>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr,
                                              dt_val, h, gm1, gamma, n_active, n_slots, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_row_sweep(const T* s, T* s_out, const T* ghost_lo, const T* ghost_hi,
                             T* g_lo, T* g_hi, const T* dt_ptr, double dt_val, double h,
                             double gamma, int dim, int n_sub, int n_vars, int d,
                             const long long* n_active, long long n_slots, long long L,
                             void* stream) {
  if (dim != kDim || n_sub != kSub || n_vars != kVars || n_slots <= 0 || L <= 0 ||
      h <= 0.0 || n_active == nullptr) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T gm1 = static_cast<T>(gamma - 1.0);
  const T args[3] = {static_cast<T>(dt_val), static_cast<T>(h), static_cast<T>(gamma)};
  switch (d) {
    case 0:
      return launch_dir<T, 0>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr, args[0],
                              args[1], gm1, args[2], n_active, n_slots, L, st);
    case 1:
      return launch_dir<T, 1>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr, args[0],
                              args[1], gm1, args[2], n_active, n_slots, L, st);
    case 2:
      return launch_dir<T, 2>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr, args[0],
                              args[1], gm1, args[2], n_active, n_slots, L, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Enqueues one sweep along sub-axis d on `stream` and returns the launch's
// cudaError_t (0 = cudaSuccess).  s_out may be s (in place).  dt_ptr: a
// device scalar of the state's dtype, or null to use dt_val; h = dx_d /
// n_sub, the subcell width; n_active: a device int64 scalar, the count of
// active slots (clamped to [0, n_slots]).  Only dim 3, n_sub 7 and the 5
// Euler variables are instantiated; anything else returns
// cudaErrorInvalidValue.

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
