// The ADER-DG space-time predictor for orders whose cell does not fit the
// order-3 predictor's thread shape, for Hopper (sm_90a): 3-D, Picard, flux
// form, templated on the node count NN and the physics.  Instantiated for
// compressible Euler at orders 4, 5 and 7 (NN = 5, 6, 8): float32 in
// csrc/aderdg_p4.cu, aderdg_p5.cu and aderdg_p7.cu, float64 in the _f64
// sources beside them, so that nvcc compiles them in parallel.  The face
// stage of those steps is csrc/aderdg.cu's, instantiated at n = 5, 6 and 8
// (its _p4, _p5 and _p7 entries, periodic and walled).
//
// Replaces the TPU kernel exahype_tpu/models/aderdg_pallas.py::
// PallasADERDG.build (K1 c, its order-generic instances) on the Euler path
// at orders 4, 5 and 7: the Picard branch of its body, q̄ and F̄_d, the
// Kvol volume integral and the face projections.  The numbers to match are
// those of exahype_tpu/models/aderdg.py::ADERDGSolver.step; the plain
// PyTorch version is exahype_tpu_torch/models/aderdg.py::
// ADERDGSolver.predictor_volume.
//
//   aderdg_predictor_volume_st  cell-local: the Picard space-time predictor
//                            over picard_iters iterations (a run-time
//                            count), the time averages q̄ and F̄_d, the volume
//                            integral new = u + Σ_d λ_d Kvol F̄_d and the face
//                            projections (q_lo, q_hi, f_lo, f_hi) of every
//                            axis, in the face tensor's layout that the face
//                            stage reads, [d][which][m][v][cell].
//
// What bounds it on the H100.  At order 5 a cell has 216 space nodes and 6
// time slices; one step of the predictor is ~2.8e6 arithmetic operations a
// cell (6 Picard iterations of 3 fluxes and three 6-point D contractions a
// space-time point, and K1inv; chip_smoke.py::predictor_ops) against 17.3
// KB of device memory a cell in float32 (u read, new and the faces
// written), ~160 operations a byte: operations bound it, not bytes.  The
// operations a node grow as NN^3 (NN iterations of NN slices of NN-point
// contractions): at order 7 2.1x order 5's a degree of freedom.
//
// Why the order-3 design does not carry over.  At order 3 a thread holds a
// pencil of a cell along the last node axis (4 nodes x 4 slices x 5
// variables with their right-hand sides, 80 registers) and a warp the 16
// pencils of 2 cells, so the axis-0 and axis-1 contractions are xor
// shuffles within lane groups of 4.  At order 5 a cell has 36 pencils, which
// do not tile a warp; a pencil is 6 x 6 x 5 = 180 values before its
// right-hand sides, more than 255 registers; and xor shuffles need groups
// of a power of two.
//
// Design.  A thread a space node, CB cells a block (st_cells: 2 at orders
// 4 and 5, 250 and 432 threads; 1 at order 7, 512 threads).  The
// contractions mix time slices only through K1inv and
// the weights, and space nodes only through D on the fluxes, so a thread
// keeps its node's q for every slice in registers (NN x V values; a slice's
// right-hand side replaces its q once the slice's fluxes are taken, as at
// order 3), and only the fluxes are shared: for each slice, every thread
// writes its node's three axis fluxes to shared memory, a barrier, and each
// thread contracts the three lines of fluxes through its node with its own
// rows of D (held in registers) into its right-hand side, in the plain
// version's order (φ0 u − λ_0 w D·F_0 − λ_1 w D·F_1 − λ_2 w D·F_2).  The
// flux array is double-buffered, so a slice needs one barrier.  Then q ←
// K1inv rhs is thread-local.  The epilogue averages q and its fluxes over
// the slices in registers, stores q̄ and F̄_d to shared memory (over the
// flux buffers), and the volume integral and the face projections run in
// the I/O mapping, straight from shared memory to device memory.  Device
// memory is read and written in runs of the block's consecutive cells (the
// cell index fastest in the I/O mapping), u staged through shared memory,
// where it stays for the right-hand sides and the volume integral.  At
// order 4 a cell's 125 nodes are not a multiple of 32: warps straddle the
// block's two cells, which changes nothing of the above (a thread reads
// its own cell's lines by offsets, whatever its lane).
//
// The contractions take one shared-memory load a multiply-add, and the SM
// issues one warp-wide shared load a clock against four FMA instructions,
// so shared memory rather than the FMA units bounds this design: ~22,000
// warp-wide loads a cell and step, about twice the cell's operation bound
// at the card's FMA rate.  The shared memory of a block, u and the two flux
// buffers: 7 V NN^3 CB values and Kvol, 60,624 B in float32 and 121,248 B
// in float64 at order 5 (opt-in above 48 KB); two blocks an SM in float32, one
// in float64.
//
// Order 7 (NN = 8).  512 space nodes a cell, so a block is one cell of 512
// threads, at most 128 registers a thread, one block an SM (71,936 B of
// shared memory in float32, 143,872 B in float64).  In float32 q (40
// values) and D's three rows (24) fit in registers; in float64 they take the
// 128 registers alone, so ptxas spills (the [kernel] line of chip_smoke.py
// gives the bytes).
//
// Not carried over from the TPU kernel: picard_loop and slice_loop (Mosaic
// code-size workarounds: here the Picard loop is a run-time loop and the
// slice loop is unrolled, q in registers), and the Mosaic workarounds _shift,
// dyn_scalar and rotate-and-append.  IEEE division and square root (no fast
// math); nvcc contracts a·b + c into fused multiply-adds, so the kernel
// differs from the plain version by rounding only.  No atomics: the result
// is bitwise repeatable.  Offsets into device memory are 64-bit.
#pragma once

#include <cuda_runtime.h>

#include "aderdg_common.cuh"

namespace {

// Cells a block.  Order 5: 2, so that a block is 432 threads (13.5 warps)
// and the block's runs of cells are 8 bytes in float32, 16 in float64.  The
// f32 kernel asks for 2 blocks an SM (at most 72 registers a thread: ptxas
// spills 28 B), the f64 kernel for one.  Of the shapes tried at order 5 in
// float32 (1, 2 or 4 cells a block, one block an SM without spill) this
// one ran fastest on an H100 80GB HBM3 at 700 W (scripts/torch_p5_ab.py;
// PERF.md).  Order 4: 2 (250 threads), 3 blocks an SM in float32 (at most
// 80 registers a thread), 2 in float64.  Order 7: 1 (512 threads), one
// block an SM.
template <int NN>
__host__ __device__ constexpr int st_cells() { return NN >= 8 ? 1 : 2; }

template <typename T, int NN>
__host__ __device__ constexpr int st_min_blocks() {
  return NN >= 8 ? 1 : (NN == 5 ? (sizeof(T) == 4 ? 3 : 2) : (sizeof(T) == 4 ? 2 : 1));
}

// Shared memory of a block, in values of T: u [V][NP], the double-buffered
// fluxes [2][kDim][V][NP] (the epilogue's q̄ [V][NP] and F̄ [kDim][V][NP]
// over them), and Kvol [NN][NN], read at a thread-dependent row.  NP =
// CB NN^3: the block's space nodes, cell by cell.
template <int NN, int CB, int V>
struct StSmem {
  static constexpr int kNodes = NN * NN * NN;
  static constexpr int kNP = CB * kNodes;
  static constexpr int kFluxes = kDim * V * kNP;  // one buffer
  static constexpr int kF = V * kNP;
  static constexpr int kK = kF + 2 * kFluxes;
  static constexpr int kTotal = kK + NN * NN;
};

template <typename T, int NN, int V>
constexpr size_t st_predictor_smem() {
  return static_cast<size_t>(StSmem<NN, st_cells<NN>(), V>::kTotal) *
         sizeof(T);
}

// The node stride of axis d within a cell (node = (i0 NN + i1) NN + i2), and
// a node's index along d.
template <int NN>
__device__ __forceinline__ int st_stride(int d) { return d == 0 ? NN * NN : (d == 1 ? NN : 1); }
template <int NN>
__device__ __forceinline__ int st_digit(int node, int d) {
  return d == 0 ? node / (NN * NN) : (d == 1 ? (node / NN) % NN : node % NN);
}

template <typename T, int NN, int CB, typename Phys>
__global__ void __launch_bounds__(CB * NN * NN * NN, (st_min_blocks<T, NN>()))
aderdg_predictor_volume_st(const T* __restrict__ u, T* __restrict__ out,
                           T* __restrict__ faces, const T* __restrict__ dt_ptr, T dt_val,
                           const Params<T, NN, Phys> P) {
  constexpr int V = Phys::V;
  constexpr int NF = NN * NN;
  using S = StSmem<NN, CB, V>;
  constexpr int NC = S::kNodes;  // space nodes of a cell
  constexpr int NP = S::kNP;     // of the block: its thread count
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sU = reinterpret_cast<T*>(smem_raw);  // u [v][point]
  T* sF = sU + S::kF;                      // the flux buffers; then q̄, F̄
  T* sK = sU + S::kK;                      // Kvol

  const long long ncell = P.ncell;
  const long long cell0 = static_cast<long long>(blockIdx.x) * CB;

  // u into shared memory in the I/O mapping: element e = (node V + v) CB + c
  // of the block, V of them a thread, the block's cells fastest; the ragged
  // last block clamps its loads to the last cell.  All of a thread's loads
  // are issued before any is stored.
  {
    T x[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int e = static_cast<int>(threadIdx.x) + k * NP;
      const int c = e % CB, r = e / CB;
      const long long cell = cell0 + c < ncell ? cell0 + c : ncell - 1;
      x[k] = u[static_cast<long long>(r) * ncell + cell];
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int e = static_cast<int>(threadIdx.x) + k * NP;
      const int c = e % CB, r = e / CB;
      const int node = r / V, v = r - node * V;
      sU[v * NP + c * NC + node] = x[k];
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NN; ++i) {
#pragma unroll
      for (int j = 0; j < NN; ++j) sK[i * NN + j] = P.Kvol[i][j];
    }
  }

  // The compute mapping: my point is node `node` of the block's cell c.
  const int pt = static_cast<int>(threadIdx.x);
  const int node = pt % NC;
  int id[kDim];  // my node's index along each axis
#pragma unroll
  for (int d = 0; d < kDim; ++d) id[d] = st_digit<NN>(node, d);
  T Dr[kDim][NN];  // D's row of my index along each axis
#pragma unroll
  for (int d = 0; d < kDim; ++d) select_row<T, NN>(P.D, id[d], Dr[d]);
  const T dtv = dt_ptr != nullptr ? *dt_ptr : dt_val;
  T lam[kDim];
#pragma unroll
  for (int d = 0; d < kDim; ++d) lam[d] = dtv / P.dx[d];
  __syncthreads();  // u and Kvol staged

  T q[NN][V];  // [time slice][v]: q, or a slice's right-hand side
#pragma unroll
  for (int s = 0; s < NN; ++s) {
#pragma unroll
    for (int v = 0; v < V; ++v) q[s][v] = sU[v * NP + pt];
  }

  // Picard: q <- K1inv (φ0 u − Σ_d λ_d w ∂_ξd F_d(q)), slice by slice; the
  // flux buffer alternates from slice to slice (across iterations too).
  int buffer = 0;
  for (int it = 0; it < P.picard_iters; ++it) {
#pragma unroll
    for (int s = 0; s < NN; ++s) {
      T* fl = sF + buffer * S::kFluxes;
      buffer ^= 1;
      {
        T f[kDim][V];
        P.phys.fluxes(q[s], f);
#pragma unroll
        for (int d = 0; d < kDim; ++d) {
#pragma unroll
          for (int v = 0; v < V; ++v) fl[(d * V + v) * NP + pt] = f[d][v];
        }
      }
      __syncthreads();  // every node's fluxes of slice s are in
      T lw[kDim];
#pragma unroll
      for (int d = 0; d < kDim; ++d) lw[d] = lam[d] * P.W[s];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        T dF[kDim];
#pragma unroll
        for (int d = 0; d < kDim; ++d) {
          const int st = st_stride<NN>(d);
          const T* x = fl + (d * V + v) * NP + pt - id[d] * st;  // the line's first node
          T acc = Dr[d][0] * x[0];
#pragma unroll
          for (int j = 1; j < NN; ++j) acc = acc + Dr[d][j] * x[j * st];
          dF[d] = acc;
        }
        T r = P.PHI0[s] * sU[v * NP + pt];
        r = r - lw[0] * dF[0];
        r = r - lw[1] * dF[1];
        q[s][v] = r - lw[2] * dF[2];  // slice s's fluxes are taken: its rhs goes here
      }
    }
    // q <- K1inv rhs, one variable at a time.
#pragma unroll
    for (int v = 0; v < V; ++v) {
      T r[NN];
#pragma unroll
      for (int t = 0; t < NN; ++t) r[t] = q[t][v];
#pragma unroll
      for (int s = 0; s < NN; ++s) {
        T acc = P.K1inv[s][0] * r[0];
#pragma unroll
        for (int t = 1; t < NN; ++t) acc = acc + P.K1inv[s][t] * r[t];
        q[s][v] = acc;
      }
    }
  }

  // Time averages of the final q and of its fluxes at my node.
  T qb[V], fb[kDim][V];
#pragma unroll
  for (int s = 0; s < NN; ++s) {
    const T w = P.W[s];
    T f[kDim][V];
    P.phys.fluxes(q[s], f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      qb[v] = s == 0 ? w * q[s][v] : qb[v] + w * q[s][v];
#pragma unroll
      for (int d = 0; d < kDim; ++d) fb[d][v] = s == 0 ? w * f[d][v] : fb[d][v] + w * f[d][v];
    }
  }
  T* sQb = sF;           // q̄ [v][point]
  T* sFb = sF + V * NP;  // F̄ [d][v][point]
  __syncthreads();       // the last slice's contractions are done with the buffers
#pragma unroll
  for (int v = 0; v < V; ++v) {
    sQb[v * NP + pt] = qb[v];
#pragma unroll
    for (int d = 0; d < kDim; ++d) sFb[(d * V + v) * NP + pt] = fb[d][v];
  }
  __syncthreads();

  // Back in the I/O mapping.  The volume integral, new = u + Σ_d λ_d
  // Kvol_d F̄_d, of element e = (node V + v) CB + c.
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int e = static_cast<int>(threadIdx.x) + k * NP;
    const int c = e % CB, r = e / CB;
    const int n = r / V, v = r - n * V;
    const int at = c * NC + n;  // the node's point
    T nv = sU[v * NP + at];
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
      const int st = st_stride<NN>(d), i = st_digit<NN>(n, d);
      const T* x = sFb + (d * V + v) * NP + at - i * st;
      const T* kr = sK + i * NN;
      T kv = kr[0] * x[0];
#pragma unroll
      for (int j = 1; j < NN; ++j) kv = kv + kr[j] * x[j * st];
      nv = nv + lam[d] * kv;
    }
    if (cell0 + c < ncell) out[static_cast<long long>(r) * ncell + cell0 + c] = nv;
  }

  // The face projections of element e = ((d NF + m) V + v) CB + c: the line
  // of nodes along d through face node m (the other two indices, in axis
  // order, m = a NN + b), projected with φ(0) and φ(1).
  // faces[d][which][m][v][cell], which = q_lo, q_hi, f_lo, f_hi.
  const long long stride_w = static_cast<long long>(NF * V) * ncell;
  for (int e = static_cast<int>(threadIdx.x); e < kDim * NF * V * CB; e += NP) {
    const int c = e % CB, r = e / CB;
    if (cell0 + c >= ncell) continue;
    const int v = r % V, dm = r / V;
    const int d = dm / NF, m = dm - d * NF;
    const int a = m / NN, b = m % NN;
    const int base = d == 0 ? a * NN + b : (d == 1 ? a * NF + b : a * NF + b * NN);
    const int st = st_stride<NN>(d);
    const T* xq = sQb + v * NP + c * NC + base;
    const T* xf = sFb + (d * V + v) * NP + c * NC + base;
    T qlo = P.PHI0[0] * xq[0], qhi = P.PHI1[0] * xq[0];
    T flo = P.PHI0[0] * xf[0], fhi = P.PHI1[0] * xf[0];
#pragma unroll
    for (int j = 1; j < NN; ++j) {
      const T qj = xq[j * st], fj = xf[j * st];
      qlo = qlo + P.PHI0[j] * qj;
      qhi = qhi + P.PHI1[j] * qj;
      flo = flo + P.PHI0[j] * fj;
      fhi = fhi + P.PHI1[j] * fj;
    }
    const long long o = (static_cast<long long>(d * 4 * NF + m) * V + v) * ncell + cell0 + c;
    faces[o] = qlo;
    faces[o + stride_w] = qhi;
    faces[o + 2 * stride_w] = flo;
    faces[o + 3 * stride_w] = fhi;
  }
}

template <typename T, int NN, typename Phys>
Shape st_predictor_shape() {
  constexpr int CB = st_cells<NN>();
  return {reinterpret_cast<const void*>(aderdg_predictor_volume_st<T, NN, CB, Phys>),
          dim3(CB * NN * NN * NN), st_predictor_smem<T, NN, Phys::V>()};
}

// The launcher of the instance with NN nodes an axis (physics 0, Euler;
// order NN - 1): exahype_aderdg_predictor_volume_*'s arguments (csrc/aderdg.cu).
// The block's shared memory (Kvol included) is
// opted in above 48 KB and checked against the card's limit at the launch.
template <typename T, int NN>
int st_predictor_volume(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                        const double* ops, const double* dx, int order, int picard_iters,
                        int physics, const double* params, long long g0, long long g1,
                        long long g2, void* stream) {
  using Phys = EulerPhysics<T>;
  constexpr int CB = st_cells<NN>();
  if (physics != kEuler || bad_grid<NN>(order, g0, g1, g2) || picard_iters < 0)
    return cudaErrorInvalidValue;
  const auto P = make_params<T, NN, Phys>(ops, dx, picard_iters, params, g0, g1, g2);
  const Shape sh = st_predictor_shape<T, NN, Phys>();
  const cudaError_t attr = allow_smem(aderdg_predictor_volume_st<T, NN, CB, Phys>, sh.smem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (P.ncell + CB - 1) / CB;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  aderdg_predictor_volume_st<T, NN, CB, Phys>
      <<<static_cast<unsigned>(blocks), sh.block, sh.smem, static_cast<cudaStream_t>(stream)>>>(
          u, out, faces, dt_ptr, static_cast<T>(dt_val), P);
  return cudaGetLastError();
}

}  // namespace
