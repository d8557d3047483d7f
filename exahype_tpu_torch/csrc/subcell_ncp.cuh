// One directional sweep of the limiter's subcell Rusanov FV fallback over the
// gathered troubled rows for a system with a non-conservative product, for
// Hopper (sm_90a): csrc/subcell.cu's sweep with the NCP half-fluctuation of
// every face, templated on a physics policy (Z4MatterSweep below: the
// 43-variable Z4+GRHD system of csrc/z4_matter.cuh).  The float32 instance
// and its C interface are csrc/subcell_z4_matter.cu, the float64 one
// csrc/subcell_z4_matter_f64.cu.
//
// Replaces the TPU kernel exahype_tpu/models/subcell_pallas.py::
// row_sweep_call on an NCP solver (its body, exahype_tpu/models/limiter.py::
// LimitedADERDG._row_sweep_math, with the ncp_fn term at :1278-1295).  The
// plain PyTorch version is exahype_tpu_torch/models/limiter.py::
// LimitedADERDG._row_sweep_math.
//
// Shapes and contract: csrc/subcell.cu's (s [n_sub, n_sub, n_sub, V, K, L],
// the ghosts with sub-axis d cut to 1, g_lo and g_hi [V, K, L]; the active
// slots are the prefix k < *n_active, swept in place; the rest of s is not
// written and g is 0 there).  For each subcell j of each pencil along d:
//   fhat_j  = ½ (F(q_{j−1}) + F(q_j)) − ½ max(e(q_{j−1}), e(q_j)) (q_j − q_{j−1}),
//   H_j     = ½ ncp(½ (q_{j−1} + q_j), q_j − q_{j−1}, d)   (face j, q_{−1} and
//             q_{n_sub} the ghosts),
//   q_j ← q_j − λ (fhat_{j+1} − fhat_j) − λ (H_{j+1} + H_j),  λ = dt / h,
// and the transverse means of fhat_0 and fhat_{n_sub} into g_lo and g_hi.
// The Z4+GRHD flux F is zero on the 38 Z4 rows and the Valencia flux on the 5
// hydro rows, from one recovery of the state (csrc/z4_matter.cuh::recover,
// its Newton of csrc/srhd.cuh); e is the light/gauge cone (z4::wave_speed);
// ncp(q̃, Δq, d) = rhs(q̃, 0) − rhs(q̃, e_d Δq), the two evaluations of the
// algebra of csrc/aderdg_z4.cuh::z4_face_half (one code copy, the zero
// gradient given at run time, and one recovery at q̃ shared by both, so
// their gradient-free terms cancel exactly as the plain version's do).
//
// What bounds it on the H100.  A subcell is 43 values (172 B in f32, read
// and written once: 344 B with the ghosts' share).  The function needs
// ~1,600 operations a subcell: a state's recovery, hydro flux and wave
// speed (~360), and at a face the Rusanov flux and the NCP product B_d·Δq
// alone (~350, the gradient-reading terms of the algebra and their
// coefficients; chip_smoke.py::z4_ncp_ops counts them).  That is ~5 a
// byte, under the card's f32 ridge of ~20, so bytes bound the function.
// This kernel does far more work than that: it reaches the product as the
// difference of two whole evaluations of the ~4,000-operation algebra.
//
// Design.  A pencil of 7 states of 43 values does not fit a thread's
// registers (csrc/subcell.cu holds Euler's 7 × 5 there), and the algebra
// itself takes 168-255 of them.  So a thread sweeps one pencil at a time and
// keeps no state in registers: it reads the two states of a face from
// device memory when it needs them (each value of the pencil at most three
// times, through L1), and stages the face's terms in its own words of shared
// memory, each row [v][lane] (stride 32, so a warp's accesses are
// conflict-free): q̃ and Δq (what z4_face_half reads), the first
// evaluation, the half H_j, and the previous face's fhat and H, which the
// update of the subcell between the two faces needs.  A face's flux and its
// half are computed once and serve both subcells beside it; a state's
// recovery, flux and wave speed once, for both of its faces.  The subcell
// j−1 is written once face j is known, after the thread's last read of it
// (face j reads it as its left state), so the in-place sweep cannot race:
// no other thread reads that pencil.  Lanes are 32 consecutive (k, l) cells
// (every device access of a warp is one 128-byte line in f32); a block's NW
// warps take the 25 transverse pencils of those cells round robin (warp w:
// pencils w, w + NW, ...), each summing its pencils' edge fluxes in order in
// its shared rows, and after a barrier the block sums the warps' partial
// sums in order and divides by 25: fixed-order sums, no atomics, so two runs
// are bitwise equal.  NW is what the shared memory allows: 8 × 43 rows of 32
// values a warp, 44,032 B in float32 (5 warps, 220,160 B) and 88,064 B in
// float64 (2 warps, 176,128 B); one block an SM.  The grid is sized for all
// K slots (nothing from the host); a block past n_active writes its zero g
// values and returns.  IEEE division and square root (no fast math); nvcc
// contracts a·b + c into fused multiply-adds, so the kernel differs from the
// plain version by rounding only.
#pragma once

#include <cuda_runtime.h>

#include "aderdg_z4.cuh"

namespace {

// The Z4+GRHD policy: its variable count, a state's hydro flux rows and wave
// speed from one recovery, and the NCP half-fluctuation of a face.
struct Z4MatterSweep {
  using Sys = Z4Matter;
  using P = Sys::P;
  static constexpr int kVars = Sys::kVars;
  static constexpr int kFluxFirst = Sys::kFluxFirst;
  static constexpr int kFluxRows = Sys::kHydro;
  static P make(const double* params) { return Sys::make(params); }
  static bool bad(const double* params) { return Sys::bad(params); }
  // The flux rows kFluxFirst.. along DIR and the wave speed of the state at
  // q (its slots vs apart in device memory).
  template <typename T, int DIR>
  static __device__ __forceinline__ void physics(const T* q, long long vs, const P& p,
                                                 T* f, T* e) {
    auto load = [&](int v) { return q[v * vs]; };
    const auto rec = Sys::template recover<T>(load, p);
#pragma unroll
    for (int r = 0; r < kFluxRows; ++r) f[r] = Sys::template flux<T>(rec, DIR, r);
    T w[7];  // the slots the wave speed reads: α and γ_ij
#pragma unroll
    for (int v = 0; v < 7; ++v) w[v] = q[v * vs];
    *e = Sys::template wave_speed<T>(w, DIR, p);
  }
  // ½ ncp(q̃, Δq, DIR) into out[v * stride], from q̃ and Δq in a thread's
  // words of shared memory (stride kTile); sR is scratch of the same shape.
  template <typename T, int DIR>
  static __device__ __forceinline__ void ncp_half(const P& p, const T* sMid, const T* sDq,
                                                  T* sR, T* out, long long stride) {
    z4_face_half<T, Sys, DIR>(p, sMid, sDq, sR, out, stride);
  }
};

// Rows of shared memory a warp stages, each kTile values: q̃, Δq, the first
// evaluation, H_j, the previous face's H and fhat (V each), the edge-flux
// partial sums (2 V).
template <typename Phys>
__host__ __device__ constexpr int ncp_rows() { return 8 * Phys::kVars; }

template <typename T, typename Phys>
constexpr int ncp_warps() {
  constexpr int fit = static_cast<int>(kZ4SmemLimit / (ncp_rows<Phys>() * kTile * sizeof(T)));
  return fit < 5 ? fit : 5;
}

template <typename T, typename Phys>
constexpr size_t ncp_smem() {
  return static_cast<size_t>(ncp_warps<T, Phys>()) * ncp_rows<Phys>() * kTile * sizeof(T);
}

template <typename T, int NSUB, int DIR, typename Phys, int NW>
__global__ void __launch_bounds__(kTile * NW, 1)
subcell_row_sweep_ncp(const T* s, T* s_out, const T* __restrict__ ghost_lo,
                      const T* __restrict__ ghost_hi, T* __restrict__ g_lo,
                      T* __restrict__ g_hi, const T* __restrict__ dt_ptr, T dt_val, T h,
                      const typename Phys::P prm, const long long* __restrict__ n_active,
                      long long n_slots, long long L) {
  constexpr int V = Phys::kVars;
  constexpr int F0 = Phys::kFluxFirst;
  constexpr int NF = Phys::kFluxRows;
  constexpr int NT = NSUB * NSUB;  // transverse pencils of a (k, l) cell
  constexpr int ROWS = ncp_rows<Phys>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = threadIdx.x;  // lane: the (k, l) cell
  const int w = threadIdx.y;  // warp
  T* const mine = reinterpret_cast<T*>(smem_raw) + w * ROWS * kTile + c;
  T* const sMid = mine;
  T* const sDq = sMid + V * kTile;
  T* const sR = sDq + V * kTile;
  T* const sH = sR + V * kTile;
  T* const sHp = sH + V * kTile;
  T* const sFp = sHp + V * kTile;
  T* const sG = sFp + V * kTile;  // [2 V]: low face, then high face

  const long long n_kl = n_slots * L;
  const long long kl0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long kl = kl0 + c;
  long long n_act = *n_active;
  n_act = n_act < 0 ? 0 : (n_act > n_slots ? n_slots : n_act);
  const long long n_act_kl = n_act * L;
  const long long vs = n_kl;  // stride of the variable axis

  if (kl0 >= n_act_kl) {  // no active cell in the block: zero g, leave s
    for (int r = w; r < 2 * V; r += NW) {
      if (kl < n_kl) (r < V ? g_lo : g_hi)[(r % V) * vs + kl] = T(0);
    }
    return;
  }
  const bool active = kl < n_act_kl;
  for (int r = 0; r < 2 * V; ++r) sG[r * kTile] = T(0);

  if (active) {
    const T lam = (dt_ptr != nullptr ? *dt_ptr : dt_val) / h;
    // Strides of s: sub-axes 0, 1, 2, then the variables.
    const long long st[kDim] = {NT * V * vs, NSUB * V * vs, V * vs};
    constexpr int O0 = DIR == 0 ? 1 : 0;  // the pencil's transverse sub-axes
    constexpr int O1 = DIR == 2 ? 1 : 2;
#pragma unroll 1
    for (int p = w; p < NT; p += NW) {
      const int a = p / NSUB, b = p % NSUB;
      const long long base = a * st[O0] + b * st[O1] + kl;
      const long long gbase = static_cast<long long>(a * NSUB + b) * V * vs + kl;
      // The extended pencil: 0 ghost_lo, 1..NSUB the subcells, NSUB + 1
      // ghost_hi.
      auto state = [&](int j) -> const T* {
        return j == 0 ? ghost_lo + gbase
                      : (j == NSUB + 1 ? ghost_hi + gbase : s + base + (j - 1) * st[DIR]);
      };
      T fa[NF], ea;  // the left state's flux rows and wave speed
      Phys::template physics<T, DIR>(state(0), vs, prm, fa, &ea);
#pragma unroll 1
      for (int j = 0; j <= NSUB; ++j) {  // face j: between states j and j + 1
        const T* qa = state(j);
        const T* qb = state(j + 1);
        T fb[NF], eb;
        Phys::template physics<T, DIR>(qb, vs, prm, fb, &eb);
#pragma unroll 1
        for (int v = 0; v < V; ++v) {
          const T xa = qa[v * vs], xb = qb[v * vs];
          sMid[v * kTile] = T(0.5) * (xa + xb);
          sDq[v * kTile] = xb - xa;
        }
        Phys::template ncp_half<T, DIR>(prm, sMid, sDq, sR, sH, kTile);
        const T sp = dmax(ea, eb);
#pragma unroll 1
        for (int v = 0; v < V; ++v) {
          const T dq = sDq[v * kTile];
          // The plain version's ½ (0 + 0) on the fluxless rows.
          T fh = T(0) - T(0.5) * sp * dq;
          if (v >= F0) fh = T(0.5) * (fa[v - F0] + fb[v - F0]) - T(0.5) * sp * dq;
          const T hh = sH[v * kTile];
          if (j > 0) {
            // Subcell j − 1 (state j) between faces j − 1 and j.
            const T q = qa[v * vs];
            s_out[base + (j - 1) * st[DIR] + v * vs] =
                (q - lam * (fh - sFp[v * kTile])) - lam * (hh + sHp[v * kTile]);
          }
          if (j == 0) sG[v * kTile] = sG[v * kTile] + fh;
          if (j == NSUB) sG[(V + v) * kTile] = sG[(V + v) * kTile] + fh;
          sFp[v * kTile] = fh;
          sHp[v * kTile] = hh;
        }
#pragma unroll
        for (int r = 0; r < NF; ++r) fa[r] = fb[r];
        ea = eb;
      }
    }
  }
  __syncthreads();

  // The sum over the warps, in order; the mean over the NT pencils.
  for (int r = w; r < 2 * V; r += NW) {
    if (kl >= n_kl) continue;
    T acc = T(0);
    if (active) {
      const T* col = reinterpret_cast<const T*>(smem_raw) + (6 * V + r) * kTile + c;
      acc = col[0];
#pragma unroll
      for (int q = 1; q < NW; ++q) acc = acc + col[q * ROWS * kTile];
      acc = acc / T(NT);
    }
    (r < V ? g_lo : g_hi)[(r % V) * vs + kl] = acc;
  }
}

template <typename T, int NSUB, int DIR, typename Phys>
const void* ncp_kernel_of() {
  return reinterpret_cast<const void*>(
      subcell_row_sweep_ncp<T, NSUB, DIR, Phys, ncp_warps<T, Phys>()>);
}

template <typename T, int NSUB, int DIR, typename Phys>
cudaError_t ncp_launch_dir(const T* s, T* s_out, const T* ghost_lo, const T* ghost_hi, T* g_lo,
                           T* g_hi, const T* dt_ptr, T dt_val, T h, const typename Phys::P& prm,
                           const long long* n_active, long long n_slots, long long L,
                           cudaStream_t stream) {
  constexpr int NW = ncp_warps<T, Phys>();
  constexpr size_t smem = ncp_smem<T, Phys>();
  auto kernel = subcell_row_sweep_ncp<T, NSUB, DIR, Phys, NW>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long blocks = (n_slots * L + kTile - 1) / kTile;
  kernel<<<dim3(static_cast<unsigned>(blocks)), dim3(kTile, NW), smem, stream>>>(
      s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr, dt_val, h, prm, n_active, n_slots, L);
  return cudaGetLastError();
}

// The C interface's body: checks, then the launch of direction d.
template <typename T, int NSUB, typename Phys>
cudaError_t ncp_row_sweep(const T* s, T* s_out, const T* ghost_lo, const T* ghost_hi, T* g_lo,
                          T* g_hi, const T* dt_ptr, double dt_val, double h,
                          const double* params, int dim, int n_sub, int n_vars, int d,
                          const long long* n_active, long long n_slots, long long L,
                          void* stream) {
  if (dim != kDim || n_sub != NSUB || n_vars != Phys::kVars || n_slots <= 0 || L <= 0 ||
      h <= 0.0 || n_active == nullptr || params == nullptr || Phys::bad(params)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const typename Phys::P prm = Phys::make(params);
  const T dtv = static_cast<T>(dt_val), hv = static_cast<T>(h);
  switch (d) {
    case 0:
      return ncp_launch_dir<T, NSUB, 0, Phys>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr,
                                              dtv, hv, prm, n_active, n_slots, L, st);
    case 1:
      return ncp_launch_dir<T, NSUB, 1, Phys>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr,
                                              dtv, hv, prm, n_active, n_slots, L, st);
    case 2:
      return ncp_launch_dir<T, NSUB, 2, Phys>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr,
                                              dtv, hv, prm, n_active, n_slots, L, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// out = {registers a thread, resident blocks an SM, threads a block, shared
// memory bytes a block (dynamic), local (spill) bytes a thread, 0}.
template <typename T, int NSUB, typename Phys>
int ncp_kernel_info(int d, int* out) {
  if (d < 0 || d > 2) return cudaErrorInvalidValue;
  const void* fn = d == 0   ? ncp_kernel_of<T, NSUB, 0, Phys>()
                   : d == 1 ? ncp_kernel_of<T, NSUB, 1, Phys>()
                            : ncp_kernel_of<T, NSUB, 2, Phys>();
  constexpr size_t smem = ncp_smem<T, Phys>();
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return e;
  const int threads = kTile * ncp_warps<T, Phys>();
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = blocks;
  out[2] = threads;
  out[3] = static_cast<int>(smem);
  out[4] = static_cast<int>(attr.localSizeBytes);
  out[5] = 0;
  return cudaSuccess;
}

}  // namespace
