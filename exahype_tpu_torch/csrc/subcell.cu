// One directional sweep of the limiter's subcell Rusanov FV fallback over the
// gathered troubled rows, 3-D compressible Euler, for Hopper (sm_90a).
//
// Replaces the TPU kernel exahype_tpu/models/subcell_pallas.py::
// row_sweep_call.  The numbers to match are those of exahype_tpu/models/
// limiter.py::LimitedADERDG._row_sweep_math; the plain PyTorch version is
// exahype_tpu_torch/models/limiter.py::LimitedADERDG._row_sweep_math.
//
// Shapes (the gathered batch of K slots of L cells, n_sub = 2N+1 subcells
// per axis): s [n_sub, n_sub, n_sub, V, K, L]; ghost_lo and ghost_hi the
// same with sub-axis d cut to 1 (the subcell layers beyond the first and
// the last subcell along d), built before the launch as the Pallas module
// builds them; g_lo and g_hi [V, K, L], the fluxes through each cell's low
// and high face along d averaged over the n_sub^2 transverse subcells.
//
// Contract.  n_active, a device scalar (int64), is the count of active
// slots; the active slots are the prefix k < n_active of the slot axis (the
// limiter's tables rank the flagged rows, lowest first).  Slots < n_active
// of s_out take the swept values; slots >= n_active of s_out are not
// written, and g_lo and g_hi are 0 there.  s_out may be s: the limiter
// sweeps in place.  That cannot race: a thread owns its pencils whole (it
// reads every subcell of one before it writes any), and the ghosts are
// separate tensors.
//
// What bounds it on the H100.  Each output element needs only its pencil
// along d: n_sub subcells and the two ghosts at the same transverse
// position.  Per subcell that is one Euler flux and one wave speed (~37
// flops) and the Rusanov face and update (~75 flops) against 40 bytes read
// and written in f32: ~3 flops per byte, far below the card's f32 ridge of
// ~20.  So the kernel is memory-bound, and it moves the active rows only:
// each read once, each written once.
//
// Design.  A thread sweeps one pencil: lane = one of 32 consecutive (k, l)
// cells, so every load and store of a warp is one whole 128-byte line
// (f32); warp b and block row a (blockIdx.y) are its transverse indices
// along the first and the second of the two other sub-axes, so a block of
// n_sub warps holds one a, and a cluster of n_sub blocks (a = its rank) all
// n_sub^2 pencils of its 32 cells.  The grid is sized for all K slots, so
// the launch needs nothing from the host; a cluster whose first cell lies at
// or past n_active * L writes its zero g values and returns before it loads
// anything, and one that straddles the boundary masks each cell.  A thread
// loads its whole pencil (n_sub + 2 states) before it writes any of it, so
// the loads are in flight together, then walks it face by face: each face's
// flux is computed once and used by both subcells beside it (face j lies
// between subcells j-1 and j, face 0 against ghost_lo, face n_sub against
// ghost_hi), as the plain version's hi and lo fluxes of one face are the
// same operands in the same order.  The transverse means are fixed-order
// sums: over b in each block's shared memory, then over a across the
// cluster, each block reading its partners' partial sums through
// distributed shared memory (no float atomics, so two runs are bitwise
// equal; no second launch).  The sweep direction is a template parameter,
// so the flux's component indices are compile-time constants.  IEEE
// division and square root (no fast math); the Euler physics is
// csrc/euler.cuh, shared with the ADER-DG kernels.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "euler.cuh"

namespace {

constexpr int kDim = 3;
constexpr int kVars = kDim + 2;
constexpr int kSub = 7;
constexpr int kCells = 32;  // (k, l) cells a block: one warp's width

// Resident blocks an SM that the kernel is compiled for: registers a thread
// at most 65536 / (224 * blocks).  In f32, 4 (72 registers, 16-28 bytes
// spilled, 28 warps an SM) beat 3 (80 registers) and 2 on the H100
// (scripts/torch_kernel_ab.py --k3); 5 would leave 58 registers for a
// pencil of 45 values.  f64 (the tests' type) takes what it needs.
template <typename T>
constexpr int min_blocks() { return sizeof(T) == 4 ? 4 : 1; }

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
__global__ void __cluster_dims__(1, NSUB, 1) __launch_bounds__(kCells * NSUB, min_blocks<T>())
subcell_row_sweep(const T* s, T* s_out, const T* __restrict__ ghost_lo,
                  const T* __restrict__ ghost_hi, T* __restrict__ g_lo,
                  T* __restrict__ g_hi, const T* __restrict__ dt_ptr, T dt_val, T h, T gm1,
                  T gamma, const long long* __restrict__ n_active, long long n_slots,
                  long long L) {
  constexpr int V = kVars;
  constexpr int NT = NSUB * NSUB;  // transverse positions
  constexpr int NROW = 2 * V;      // g rows: side * V + v, side 0 = low face
  // sB[row][b][c]: each pencil's edge flux; sP[row][c]: their sum over b.
  __shared__ T sB[NROW][NSUB][kCells];
  __shared__ T sP[NROW][kCells];

  const int c = threadIdx.x;
  const int b = threadIdx.y;
  const int a = blockIdx.y;  // the block's rank in its cluster
  const long long n_kl = n_slots * L;
  const long long kl0 = static_cast<long long>(blockIdx.x) * kCells;
  const long long kl = kl0 + c;
  long long n_act = *n_active;
  n_act = n_act < 0 ? 0 : (n_act > n_slots ? n_slots : n_act);
  const long long n_act_kl = n_act * L;
  const long long vs = n_kl;  // stride of the variable axis
  // Block a writes g rows a and a + NSUB, warp 0 and warp 1 one each.
  const int row = a + b * NSUB;
  T* const g_row = row < NROW ? (row < V ? g_lo : g_hi) + (row % V) * vs : nullptr;

  if (kl0 >= n_act_kl) {  // no active cell in the cluster: zero g, leave s
    if (b < 2 && row < NROW && kl < n_kl) g_row[kl] = T(0);
    return;
  }

  if (kl < n_act_kl) {
    // Strides of s in units of n_kl: sub-axes 0, 1, 2, then the variables.
    const long long st[kDim] = {NT * V * vs, NSUB * V * vs, V * vs};
    // The transverse position's two sub-axes, in order.
    constexpr int O0 = DIR == 0 ? 1 : 0;
    constexpr int O1 = DIR == 2 ? 1 : 2;
    const long long base = a * st[O0] + b * st[O1] + kl;
    // Ghosts: [.., V, K, L] with sub-axis DIR of size 1.
    const long long gbase = static_cast<long long>(a * NSUB + b) * V * vs + kl;
    // The pencil: q[0] = ghost_lo, q[1..NSUB] = the subcells, q[NSUB+1] =
    // ghost_hi, all loaded before any store.
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
    const T lam = (dt_ptr != nullptr ? *dt_ptr : dt_val) / h;

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
        for (int v = 0; v < V; ++v) sB[v][b][c] = fhat[v];
      } else {
        // Subcell j-1 (state q[j]) between faces j-1 and j.
#pragma unroll
        for (int v = 0; v < V; ++v) {
          s_out[base + (j - 1) * st[DIR] + v * vs] = q[j][v] - lam * (fhat[v] - f_lo[v]);
        }
      }
      if (j == NSUB) {
#pragma unroll
        for (int v = 0; v < V; ++v) sB[V + v][b][c] = fhat[v];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        f_lo[v] = fhat[v];
        fa[v] = fb[v];
      }
      ea = eb;
    }
  }
  __syncthreads();

  // The sum over b, in order (entries of inactive cells are never read).
  for (int r = b * kCells + c; r < NROW * kCells; r += NSUB * kCells) {
    const int rr = r / kCells, cc = r % kCells;
    T acc = sB[rr][0][cc];
#pragma unroll
    for (int p = 1; p < NSUB; ++p) acc = acc + sB[rr][p][cc];
    sP[rr][cc] = acc;
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  // The sum over a, in order, from every block of the cluster.
  if (b < 2 && row < NROW && kl < n_kl) {
    T acc = T(0);
    if (kl < n_act_kl) {
      acc = cluster.map_shared_rank(&sP[0][0], 0)[row * kCells + c];
#pragma unroll
      for (int p = 1; p < NSUB; ++p) {
        acc = acc + cluster.map_shared_rank(&sP[0][0], p)[row * kCells + c];
      }
      acc = acc / T(NT);
    }
    g_row[kl] = acc;
  }
  cluster.sync();  // every block's sP stays until its partners have read it
}

template <typename T, int DIR>
const void* kernel_of() {
  return reinterpret_cast<const void*>(subcell_row_sweep<T, kSub, DIR>);
}

template <typename T, int DIR>
cudaError_t launch_dir(const T* s, T* s_out, const T* ghost_lo, const T* ghost_hi, T* g_lo,
                       T* g_hi, const T* dt_ptr, T dt_val, T h, T gm1, T gamma,
                       const long long* n_active, long long n_slots, long long L,
                       cudaStream_t stream) {
  const long long blocks = (n_slots * L + kCells - 1) / kCells;
  subcell_row_sweep<T, kSub, DIR><<<dim3(static_cast<unsigned>(blocks), kSub),
                                    dim3(kCells, kSub), 0, stream>>>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr,
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

template <typename T>
int kernel_info(int d, int* out) {
  const void* fn = d == 0 ? kernel_of<T, 0>() : d == 1 ? kernel_of<T, 1>() : kernel_of<T, 2>();
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return e;
  const dim3 block(kCells, kSub);
  const int threads = kCells * kSub;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(1, kSub);
  config.blockDim = block;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, fn, &config);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = blocks;
  out[2] = threads;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = static_cast<int>(attr.localSizeBytes);
  out[5] = clusters;
  return cudaSuccess;
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

int exahype_subcell_row_sweep_f64(const double* s, double* s_out, const double* ghost_lo,
                                  const double* ghost_hi, double* g_lo, double* g_hi,
                                  const double* dt_ptr, double dt_val, double h, double gamma,
                                  int dim, int n_sub, int n_vars, int d,
                                  const long long* n_active, long long n_slots, long long L,
                                  void* stream) {
  return launch_row_sweep<double>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr, dt_val,
                                  h, gamma, dim, n_sub, n_vars, d, n_active, n_slots, L,
                                  stream);
}

// How direction d's kernel launches on the current card: out = {registers
// a thread, resident blocks an SM, threads a block, static shared memory
// bytes a block, local (spill) bytes a thread, clusters of kSub blocks the
// card holds at once}.
int exahype_subcell_kernel_info(int f64, int d, int* out) {
  if (d < 0 || d > 2) return cudaErrorInvalidValue;
  return f64 ? kernel_info<double>(d, out) : kernel_info<float>(d, out);
}

}  // extern "C"
