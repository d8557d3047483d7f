// ADER-DG step on a periodic 3-D grid for Hopper (sm_90a): four kernels,
// templated on the physics (3-D compressible Euler, 3-D heterogeneous
// elasticity).
//
// Replaces the TPU kernel exahype_tpu/models/aderdg_pallas.py::
// PallasADERDG.build (its pallas_call and the XLA face epilogue around it)
// on the periodic, flux-form path: the Picard branch of its body (K1) and
// its predictor_mode == "ck" branch (K2).  The numbers to match are those of
// exahype_tpu/models/aderdg.py::ADERDGSolver.step; the plain PyTorch version
// is exahype_tpu_torch/models/aderdg.py::ADERDGSolver.{predictor_volume,
// face_surface} (the face stage's halves: interface_flux, surface_term).
//
//   aderdg_predictor_volume  cell-local (Euler): Picard space-time
//                            predictor, time averages q̄ and F̄_d, volume
//                            integral new = u + Σ_d λ_d Kvol F̄_d, and the
//                            face projections (q_lo, q_hi, f_lo, f_hi) of
//                            every axis.
//   aderdg_ck_predictor_volume  cell-local (elasticity): the Cauchy–
//                            Kovalewski Taylor recursion, q̄ = Σ_k q_k/(k+1),
//                            F̄_d = F_d(q̄), then the same volume integral and
//                            face projections.
//   aderdg_face_flux         the face stage, first launch: the Rusanov flux
//                            F̂ of every interface, once, into fhat[d][m][v]
//                            [cell] (each cell's high-face fluxes, which is
//                            also the limiter's face-flux input, the TPU
//                            kernel's emit_fused_fhat outputs).
//   aderdg_surface_update    the face stage, second launch: the surface
//                            update of `new`, in place, from each cell's own
//                            F̂ and its lower neighbours'.
//
// What bounds them on the H100.  The predictor is compute-bound: ~3e5 flops
// per cell per step (4 Picard iterations of flux evaluations and 4-point
// contractions) against 6.4 KB of device-memory traffic per cell in f32,
// ~46 flops per byte, above the card's f32 ridge of ~20.  At order 3 one
// cell's space-time array is 4 time nodes x 64 space nodes x 5 vars = 1,280
// values, twice that with the Picard right-hand sides: one thread per cell
// cannot hold it.  A thread holds one pencil of a cell along the last node
// axis (4 nodes x 4 time slices x 5 vars, its right-hand sides in the same
// registers: a slice's rhs replaces its q once the slice's fluxes are
// taken), so the time contractions (K1inv, the weights) and the axis-2
// contraction are thread-local.  The axis-0 and axis-1 contractions need
// the 3 other pencils through my pencil along that axis: a warp holds the
// 16 pencils of 2 cells, so those pencils are lanes of my warp, and each
// contraction is 3 xor shuffles an output.  The Picard loop therefore uses
// no shared memory and no barrier (the first design of this kind, with the
// two contractions through shared memory, 50 shared-memory words a node
// and slice against the 75 of one thread a node, and a barrier a slice,
// ran slower; PERF.md).  1/ρ and the pressure are computed once a node
// and slice, for the three axes' fluxes.  The thread's 80 values of q and
// rhs, its 20 of the axis-2 contraction and one node's 15 fluxes fill 168
// registers (3 blocks of 128 threads an SM): u is not held, it is read
// from shared memory where used.  Global memory is read and written in
// another mapping, CB cells fastest (32-byte runs): u is staged through
// shared memory at the start, and q̄ and F̄_d go through shared memory to
// the volume integral and the face projections at the end, in layouts
// swizzled so that both mappings' accesses are free of bank conflicts.
//
// The face stage is memory-bound: ~8 flops per byte.  Each interface is
// solved once: a thread per (cell, axis, face node) reads its own high face
// (q, f) and the +d neighbour's low face, each face value once from device
// memory, and writes F̂; the update reads F̂ of the cell and of its −d
// neighbour.  A warp covers 32 consecutive cells of one row (128-byte runs
// in f32); the row and the tile come from the block index, and neighbours
// from the tile's coordinates (no 64-bit division).  Small blocks (128 and
// 256 threads, 40-70 registers) put 7-10 blocks on an SM, enough loads in
// flight to cover device-memory latency; the update's node groups of one
// tile are consecutive blocks, so the four nodes of a pencil that read one
// F̂ value, and the neighbour tiles, find it in L2.  Rows that are zero by
// construction (the elasticity's frozen materials: zero flux, mask 0) are
// neither read as fluxes, solved nor updated, nor written to F̂ (the
// wrapper zeroes them when it returns the fluxes).  There are no races and no
// float atomics: the step is bitwise deterministic run to run, and the
// face-flux output changes no bit of the state.  Offsets are 64-bit.  IEEE
// division and square root (no fast math).  The Euler physics is
// csrc/euler.cuh, shared with the generated spec kernels; the elastic
// physics is csrc/elastic.cuh.
//
// K2, the CK predictor (elasticity, 12 variables).  Its work is smaller than
// one Picard iteration: N = 3 applications of the spatial operator on the
// spatial nodal array, no space-time array.  So it is memory-bound: ~1e5
// flops per cell against 15.4 KB per cell in f32 (the state read and
// written, 3 KB each, and 9.2 KB of faces written), ~7 flops per byte,
// under the f32 ridge; so is the face stage's 12-variable variant, with
// fewer bytes and flops.  Its layout is one thread per (cell, node), CB
// cells per block (512 threads, one block per SM).  A thread
// loads its node's 12 values once and keeps 1/ρ, λ and μ in registers for
// the whole step: the materials are frozen, so the injection of the
// reference (a where-select per level) is the use of those registers, and
// the zeroing of the material rows is that the kernel holds only the 9
// evolved rows of q_k and q̄ (q_k's material rows are zero, q̄'s are u's).
// Each level writes F_d(q_k) of the 9 evolved rows to shared memory, syncs,
// contracts each axis with its D row and forms r = −Σ_d λ_d (D F_d),
// q_k = r / k, q̄ += q_k / (k + 1): the Pallas branch's order (λ_d = dt/dx_d
// inside, /k after); the plain version follows XLA's (dt/k)·L, the same up
// to rounding.  The material rows' volume term and face fluxes come from
// exact zeros (zero flux rows), and the face stage does not touch them
// (mask 0), so slots 9-11 leave the step bitwise unchanged.  Shared
// memory: the epilogue holds q̄ and F̄_d of all 12 rows for CB cells, 96 KB
// in f32 and f64, so the launcher opts in above the 48 KB default.

#include <cuda_runtime.h>

#include "elastic.cuh"
#include "euler.cuh"

namespace {

constexpr int kDim = 3;

// Physics ids of the C interface.
enum PhysicsId : int { kEuler = 0, kElasticHet = 1 };

template <typename T>
__device__ __forceinline__ T momentum(const T* q, int d) {
  return d == 0 ? q[1] : (d == 1 ? q[2] : q[3]);
}

// Each physics: V variables, its fluxes of all V rows (Euler: fluxes(q, f)
// along every axis, for the Picard predictor; elasticity: flux(q, d, f),
// for K2), max_eigenvalue(q, d), the dissipation weight of each row in the
// Rusanov jump term (kMasked: whether any weight is not 1), and kFluxRows:
// the rows 0..kFluxRows-1 whose face flux can be nonzero (the others have
// zero flux and a zero weight, so their F̂ is zero and their state never
// moves).
template <typename T>
struct EulerPhysics {
  static constexpr int V = kDim + 2;
  static constexpr int kFluxRows = V;
  static constexpr bool kMasked = false;
  T gm1;  // gamma - 1
  T gamma;
  static EulerPhysics make(const double* params) {
    return {static_cast<T>(params[0] - 1.0), static_cast<T>(params[0])};
  }
  // The flux along every axis, with one 1/ρ and one pressure for all three.
  __device__ __forceinline__ void fluxes(const T* q, T (&f)[kDim][V]) const {
    const T inv_rho = T(1) / q[0];
    const T p = euler_pressure_from<T, kDim>(q, inv_rho, gm1);
#pragma unroll
    for (int d = 0; d < kDim; ++d) euler_flux_from<T, kDim, V>(q, d, inv_rho, p, f[d]);
  }
  __device__ __forceinline__ T max_eigenvalue(const T* q, int d) const {
    return euler_max_eigenvalue<T, kDim>(q, momentum(q, d), gm1, gamma);
  }
  static __device__ __forceinline__ T dissipation(int) { return T(1); }
};

// The 12-variable heterogeneous elasticity of csrc/elastic.cuh with its CK
// configuration compiled in: materials in slots 9-11 (kRho..kMu), the
// dissipation mask (1,)*9 + (0, 0, 0).
template <typename T>
struct ElasticHetPhysics {
  static constexpr int V = 12;
  static constexpr int kEvolved = 9;
  static constexpr int kFluxRows = kEvolved;
  static constexpr int kRho = 9, kLam = 10, kMu = 11;
  static constexpr bool kMasked = true;
  static ElasticHetPhysics make(const double*) { return {}; }
  __device__ __forceinline__ void flux(const T* q, int d, T* f) const {
    elastic3d_het_flux<T>(q, T(1) / q[kRho], q[kLam], q[kMu], d, f);
#pragma unroll
    for (int v = kEvolved; v < V; ++v) f[v] = T(0);
  }
  __device__ __forceinline__ T max_eigenvalue(const T* q, int) const {
    return elastic3d_het_eigenvalue<T>(q[kRho], q[kLam], q[kMu]);
  }
  static __device__ __forceinline__ T dissipation(int v) {
    return v < kEvolved ? T(1) : T(0);
  }
};

template <typename T, int NN, typename Phys>
struct Params {
  T D[NN][NN];
  T K1inv[NN][NN];
  T Kvol[NN][NN];
  T W[NN];
  T PHI0[NN];
  T PHI1[NN];
  T PHI0W[NN];
  T PHI1W[NN];
  T dx[kDim];
  Phys phys;
  int picard_iters;
  long long g[kDim];  // cell grid
  long long ncell;
};

// Stride of node axis d in the flat node index (i0 * NN + i1) * NN + i2.
template <int NN>
__device__ __forceinline__ int node_stride(int d) {
  return d == 0 ? NN * NN : (d == 1 ? NN : 1);
}

// Flat node index of face node m (the node axes other than d, in order)
// with node index 0 on axis d.
template <int NN>
__device__ __forceinline__ int face_base(int d, int m) {
  const int a = m / NN, b = m % NN;
  return d == 0 ? a * NN + b : (d == 1 ? a * NN * NN + b : a * NN * NN + b * NN);
}

// row[j] = mat[r][j] for a thread-dependent r, reading the parameter
// bank at compile-time offsets only (a dynamic index into a kernel
// parameter can make the compiler copy the struct to local memory).
template <typename T, int NN>
__device__ __forceinline__ void select_row(const T (&mat)[NN][NN], int r, T* row) {
#pragma unroll
  for (int i = 0; i < NN; ++i) {
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      if (i == r) row[j] = mat[i][j];
    }
  }
}

template <typename T, int NN>
__device__ __forceinline__ T select(const T (&vec)[NN], int r) {
  T out = vec[0];
#pragma unroll
  for (int i = 1; i < NN; ++i) {
    if (i == r) out = vec[i];
  }
  return out;
}

// Index of (axis d, variable v, node, cell c) in the shared flux array
// sF[d][v][node][c].
template <int V, int NODES, int CB>
__device__ __forceinline__ int flux_index(int d, int v, int node, int c) {
  return ((d * V + v) * NODES + node) * CB + c;
}

// The end of both predictors, from a node's u, q̄ and F̄_d in registers:
// q̄ and F̄_d to shared memory, the volume integral of this node into `out`,
// and the face projections (q_lo, q_hi, f_lo, f_hi) of every axis into
// `faces`.  sF holds kDim * V * NN^3 * CB values, sQ V * NN^3 * CB.  Every
// thread of the block calls it (it syncs).
template <typename T, int NN, int CB, int V, typename Prm>
__device__ __forceinline__ void volume_and_faces(
    const T (&uu)[V], const T (&qbar)[V], const T (&fbar)[kDim][V], const Prm& P,
    T* sF, T* sQ, int node, int c, const int (&ix)[kDim], const int (&base)[kDim],
    const T (&lam)[kDim], bool valid, long long cell, long long ncell,
    T* __restrict__ out, T* __restrict__ faces) {
  constexpr int NF = NN * NN;
  constexpr int NODES = NN * NF;
  auto iF = [](int d, int v, int node, int c) {
    return flux_index<V, NODES, CB>(d, v, node, c);
  };
#pragma unroll
  for (int v = 0; v < V; ++v) {
    sQ[(v * NODES + node) * CB + c] = qbar[v];
#pragma unroll
    for (int d = 0; d < kDim; ++d) sF[iF(d, v, node, c)] = fbar[d][v];
  }
  __syncthreads();

  // Volume integral.
  T Kvrow[kDim][NN];
#pragma unroll
  for (int d = 0; d < kDim; ++d) select_row<T, NN>(P.Kvol, ix[d], Kvrow[d]);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    T nv = uu[v];
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
      const int st = node_stride<NN>(d);
      T kv = Kvrow[d][0] * sF[iF(d, v, base[d], c)];
#pragma unroll
      for (int j = 1; j < NN; ++j) kv = kv + Kvrow[d][j] * sF[iF(d, v, base[d] + j * st, c)];
      nv = nv + lam[d] * kv;
    }
    if (valid) out[static_cast<long long>(node * V + v) * ncell + cell] = nv;
  }

  // Face projections: threads 0..3*NF-1 of each cell own one (axis, face
  // node) pair and write its q_lo, q_hi, f_lo, f_hi.
  if (node < kDim * NF && valid) {
    const int d = node / NF;
    const int m = node % NF;
    const int b = face_base<NN>(d, m);
    const int st = node_stride<NN>(d);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      T qlo = P.PHI0[0] * sQ[(v * NODES + b) * CB + c];
      T qhi = P.PHI1[0] * sQ[(v * NODES + b) * CB + c];
      T flo = P.PHI0[0] * sF[iF(d, v, b, c)];
      T fhi = P.PHI1[0] * sF[iF(d, v, b, c)];
#pragma unroll
      for (int j = 1; j < NN; ++j) {
        const T qj = sQ[(v * NODES + b + j * st) * CB + c];
        const T fj = sF[iF(d, v, b + j * st, c)];
        qlo = qlo + P.PHI0[j] * qj;
        qhi = qhi + P.PHI1[j] * qj;
        flo = flo + P.PHI0[j] * fj;
        fhi = fhi + P.PHI1[j] * fj;
      }
      const long long stride_w = static_cast<long long>(NF * V) * ncell;
      const long long o =
          (static_cast<long long>(d * 4 * NF + m) * V + v) * ncell + cell;
      faces[o] = qlo;
      faces[o + stride_w] = qhi;
      faces[o + 2 * stride_w] = flo;
      faces[o + 3 * stride_w] = fhi;
    }
  }
}

// Shared-memory layout of the Picard predictor's q̄ and F̄_d: per variable,
// NN slabs of fixed i2, each the NF pencils (i0, i1) x CB cells, padded by
// CB values, the cell index XOR-swizzled by 2 i0.  A warp of the I/O
// mapping (fixed i0; i1 and the cell vary) reads a permutation of
// contiguous words; the pad puts the four i2 slabs that the axis-1 face
// projections read in one instruction on different banks; the swizzle
// spreads the compute mapping's stores (16 pencils x 2 cells a warp) over
// all 32 banks.
template <int NN, int CB>
struct Slabs {
  static constexpr int kSlab = NN * NN * CB + CB;
  static constexpr int kVar = NN * kSlab;
  static __device__ __forceinline__ int at(int v, int i0, int i1, int i2, int c) {
    return v * kVar + i2 * kSlab + (i0 * NN + i1) * CB + (c ^ ((2 * i0) & (CB - 1)));
  }
};

// Dynamic shared memory of aderdg_predictor_volume: u, q̄ and F̄_d of the
// block's cells.
template <typename T, int NN, int CB, int V>
constexpr size_t predictor_smem() {
  return static_cast<size_t>((2 + kDim) * V * Slabs<NN, CB>::kVar) * sizeof(T);
}

// K1, the Picard predictor (see the note at the top): one thread per (cell,
// pencil along the last node axis), CB cells x NN^2 pencils per block.
template <typename T, int NN, int CB, typename Phys>
__global__ void __launch_bounds__(CB * NN * NN, 3)
aderdg_predictor_volume(const T* __restrict__ u, T* __restrict__ out,
                        T* __restrict__ faces, const T* __restrict__ dt_ptr,
                        T dt_val, const Params<T, NN, Phys> P) {
  static_assert(NN * NN * 2 == 32, "a warp holds the 16 pencils of 2 cells");
  constexpr int NF = NN * NN;
  constexpr int V = Phys::V;
  constexpr unsigned kAll = 0xffffffffu;
  using L = Slabs<NN, CB>;
  constexpr int kArr = V * L::kVar;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sU = reinterpret_cast<T*>(smem_raw);  // u
  T* sQ = sU + kArr;                       // q̄
  T* sFbar = sQ + kArr;                    // F̄_d at sFbar + d * kArr

  // The I/O mapping (global loads and stores): cells fastest, so a warp
  // covers 32-byte runs of CB cells in four rows.
  const int c_io = threadIdx.x % CB;
  const int p_io = threadIdx.x / CB;
  const int j0 = p_io / NN, j1 = p_io % NN;
  const long long ncell = P.ncell;
  const long long cell_raw = static_cast<long long>(blockIdx.x) * CB + c_io;
  const bool valid = cell_raw < ncell;
  const long long cell = valid ? cell_raw : ncell - 1;  // ragged tail: clamp
  // Global offset of (node (j0, j1, i2), variable v): (node * V + v) * ncell + cell.
  const long long at0 = static_cast<long long>(p_io * NN * V) * ncell + cell;
  auto gat = [&](int i2, int v) { return at0 + static_cast<long long>(i2 * V + v) * ncell; };
  // u in the compute mapping's order: lane 2 p + (c % 2) of warp c / 2
  // reads word 2 p + (c % 2), rotated by 8 (c / 2), of the warp's 32 in
  // each (v, i2) row, conflict-free; the rotation spreads the I/O
  // mapping's stores (4 pencils x CB cells a warp) over the banks too.
  auto uat = [](int v, int i2, int pencil, int cc) {
    return (v * NN + i2) * (NF * CB) + (cc / 2) * 32 +
           ((pencil * 2 + (cc % 2) + (cc / 2) * 8) & 31);
  };
#pragma unroll
  for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
    for (int v = 0; v < V; ++v) sU[uat(v, i2, p_io, c_io)] = u[gat(i2, v)];
  }

  // The compute mapping: a warp holds the 16 pencils of 2 cells, lane =
  // 2 (4 i0 + i1) + cell bit, so the pencils along axes 0 and 1 through my
  // pencil are in my warp (lane xor k<<3 and xor k<<1): their contractions
  // are shuffles, and the Picard loop needs no shared memory and no barrier.
  const int lane = threadIdx.x % 32;
  const int c = (threadIdx.x / 32) * 2 + (lane & 1);
  const int i0 = lane >> 3, i1 = (lane >> 1) & (NN - 1);

  const T dtv = dt_ptr != nullptr ? *dt_ptr : dt_val;
  T lam[kDim];
#pragma unroll
  for (int d = 0; d < kDim; ++d) lam[d] = dtv / P.dx[d];
  // X0[k] = D[i0][i0 ^ k], X1[k] = D[i1][i1 ^ k]: the D coefficient of the
  // value that the xor-k shuffle brings.
  T X0[NN], X1[NN];
  {
    T r0[NN], r1[NN];
    select_row<T, NN>(P.D, i0, r0);
    select_row<T, NN>(P.D, i1, r1);
#pragma unroll
    for (int k = 0; k < NN; ++k) {
      X0[k] = select<T, NN>(r0, i0 ^ k);
      X1[k] = select<T, NN>(r1, i1 ^ k);
    }
  }
  __syncthreads();  // u staged

  // u is read where it is used, not held: 20 registers fewer leave room
  // for three blocks an SM without spilling.
  auto U = [&](int i2, int v) { return sU[uat(v, i2, i0 * NN + i1, c)]; };
  T q[NN][NN][V];  // [time slice][i2][v]
#pragma unroll
  for (int s = 0; s < NN; ++s) {
#pragma unroll
    for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
      for (int v = 0; v < V; ++v) q[s][i2][v] = U(i2, v);
    }
  }

  // Picard: q <- K1inv (θ(0) u − Σ_d λ_d w ∂_ξd F_d(q)), time slice by
  // slice, node by node of my pencil.
  for (int it = 0; it < P.picard_iters; ++it) {
#pragma unroll
    for (int s = 0; s < NN; ++s) {
      T lw[kDim];
#pragma unroll
      for (int d = 0; d < kDim; ++d) lw[d] = lam[d] * P.W[s];
      T dF2[NN][V];
#pragma unroll
      for (int i2 = 0; i2 < NN; ++i2) {
        T f[kDim][V];
        P.phys.fluxes(q[s][i2], f);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            dF2[n][v] = i2 == 0 ? P.D[n][0] * f[2][v] : dF2[n][v] + P.D[n][i2] * f[2][v];
          }
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          T dF0 = X0[0] * f[0][v];
          T dF1 = X1[0] * f[1][v];
#pragma unroll
          for (int k = 1; k < NN; ++k) {
            dF0 = dF0 + X0[k] * __shfl_xor_sync(kAll, f[0][v], k << 3);
            dF1 = dF1 + X1[k] * __shfl_xor_sync(kAll, f[1][v], k << 1);
          }
          T r = P.PHI0[s] * U(i2, v);
          r = r - lw[0] * dF0;
          q[s][i2][v] = r - lw[1] * dF1;  // q[s][i2]'s fluxes are taken: its rhs goes here
        }
      }
#pragma unroll
      for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
        for (int v = 0; v < V; ++v) q[s][i2][v] = q[s][i2][v] - lw[2] * dF2[i2][v];
      }
    }
    // q <- K1inv rhs, one (node, variable) at a time.
#pragma unroll
    for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        T r[NN];
#pragma unroll
        for (int t = 0; t < NN; ++t) r[t] = q[t][i2][v];
#pragma unroll
        for (int s = 0; s < NN; ++s) {
          T acc = P.K1inv[s][0] * r[0];
#pragma unroll
          for (int t = 1; t < NN; ++t) acc = acc + P.K1inv[s][t] * r[t];
          q[s][i2][v] = acc;
        }
      }
    }
  }

  // Time averages of the final q and of its fluxes, node by node, to
  // shared memory.
#pragma unroll
  for (int i2 = 0; i2 < NN; ++i2) {
    T qb[V], fb[kDim][V];
#pragma unroll
    for (int s = 0; s < NN; ++s) {
      const T w = P.W[s];
      T f[kDim][V];
      P.phys.fluxes(q[s][i2], f);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        qb[v] = s == 0 ? w * q[s][i2][v] : qb[v] + w * q[s][i2][v];
#pragma unroll
        for (int d = 0; d < kDim; ++d) fb[d][v] = s == 0 ? w * f[d][v] : fb[d][v] + w * f[d][v];
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sQ[L::at(v, i0, i1, i2, c)] = qb[v];
#pragma unroll
      for (int d = 0; d < kDim; ++d) sFbar[d * kArr + L::at(v, i0, i1, i2, c)] = fb[d][v];
    }
  }
  __syncthreads();

  // Back in the I/O mapping.  Volume integral of my pencil: new = u +
  // Σ_d λ_d Kvol_d F̄_d.
  T K0[NN], K1[NN];
  select_row<T, NN>(P.Kvol, j0, K0);
  select_row<T, NN>(P.Kvol, j1, K1);
#pragma unroll
  for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      T kv0 = K0[0] * sFbar[L::at(v, 0, j1, i2, c_io)];
      T kv1 = K1[0] * sFbar[kArr + L::at(v, j0, 0, i2, c_io)];
      T kv2 = P.Kvol[i2][0] * sFbar[2 * kArr + L::at(v, j0, j1, 0, c_io)];
#pragma unroll
      for (int j = 1; j < NN; ++j) {
        kv0 = kv0 + K0[j] * sFbar[L::at(v, j, j1, i2, c_io)];
        kv1 = kv1 + K1[j] * sFbar[kArr + L::at(v, j0, j, i2, c_io)];
        kv2 = kv2 + P.Kvol[i2][j] * sFbar[2 * kArr + L::at(v, j0, j1, j, c_io)];
      }
      T nv = sU[uat(v, i2, p_io, c_io)];
      nv = nv + lam[0] * kv0;
      nv = nv + lam[1] * kv1;
      nv = nv + lam[2] * kv2;
      if (valid) out[gat(i2, v)] = nv;
    }
  }
  if (!valid) return;

  // Face projections (q_lo, q_hi, f_lo, f_hi), one face node per axis: on
  // axis 2 my own pencil's (m = (j0, j1)), on axis 0 the pencil of nodes
  // (j, j1, j0) (m = (j1, j0)), on axis 1 that of nodes (j0, j, j1)
  // (m = (j0, j1)).  faces[d][which][m][v][cell].
  const long long stride_w = static_cast<long long>(NF * V) * ncell;
  auto project = [&](int d, int m, int v, auto node_at) {
    const T q0 = sQ[node_at(0)], f0 = sFbar[d * kArr + node_at(0)];
    T qlo = P.PHI0[0] * q0, qhi = P.PHI1[0] * q0;
    T flo = P.PHI0[0] * f0, fhi = P.PHI1[0] * f0;
#pragma unroll
    for (int j = 1; j < NN; ++j) {
      const T qj = sQ[node_at(j)];
      const T fj = sFbar[d * kArr + node_at(j)];
      qlo = qlo + P.PHI0[j] * qj;
      qhi = qhi + P.PHI1[j] * qj;
      flo = flo + P.PHI0[j] * fj;
      fhi = fhi + P.PHI1[j] * fj;
    }
    const long long o = (static_cast<long long>(d * 4 * NF + m) * V + v) * ncell + cell;
    faces[o] = qlo;
    faces[o + stride_w] = qhi;
    faces[o + 2 * stride_w] = flo;
    faces[o + 3 * stride_w] = fhi;
  };
#pragma unroll
  for (int v = 0; v < V; ++v) {
    project(2, j0 * NN + j1, v, [&](int j) { return L::at(v, j0, j1, j, c_io); });
    project(0, j1 * NN + j0, v, [&](int j) { return L::at(v, j, j1, j0, c_io); });
    project(1, j0 * NN + j1, v, [&](int j) { return L::at(v, j0, j, j1, c_io); });
  }
}

// K2: the Cauchy–Kovalewski predictor of the heterogeneous elasticity (see
// the note at the top), then the shared epilogue.
template <typename T, int NN, int CB>
__global__ void __launch_bounds__(CB * NN * NN * NN)
aderdg_ck_predictor_volume(const T* __restrict__ u, T* __restrict__ out,
                           T* __restrict__ faces, const T* __restrict__ dt_ptr,
                           T dt_val, const Params<T, NN, ElasticHetPhysics<T>> P) {
  using Phys = ElasticHetPhysics<T>;
  constexpr int NF = NN * NN;
  constexpr int NODES = NN * NF;
  constexpr int V = Phys::V;
  constexpr int E = Phys::kEvolved;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // sF[d][v][node][c] (the recursion uses rows v < E), then sQ[v][node][c].
  T* sF = reinterpret_cast<T*>(smem_raw);
  T* sQ = sF + kDim * V * NODES * CB;
  auto iF = [](int d, int v, int node, int c) {
    return flux_index<V, NODES, CB>(d, v, node, c);
  };

  const int c = threadIdx.x % CB;
  const int node = threadIdx.x / CB;
  const int ix[kDim] = {node / NF, (node / NN) % NN, node % NN};
  const long long ncell = P.ncell;
  const long long cell_raw = static_cast<long long>(blockIdx.x) * CB + c;
  const bool valid = cell_raw < ncell;
  const long long cell = valid ? cell_raw : ncell - 1;  // ragged tail: clamp

  const T dtv = dt_ptr != nullptr ? *dt_ptr : dt_val;
  T lam[kDim];
  T Drow[kDim][NN];
  int base[kDim];
#pragma unroll
  for (int d = 0; d < kDim; ++d) {
    lam[d] = dtv / P.dx[d];
    select_row<T, NN>(P.D, ix[d], Drow[d]);
    base[d] = node - ix[d] * node_stride<NN>(d);
  }

  T uu[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    uu[v] = u[static_cast<long long>(node * V + v) * ncell + cell];
  }
  // This node's materials, for every level (the reference injects u's).
  const T inv_rho = T(1) / uu[Phys::kRho];
  const T lame = uu[Phys::kLam];
  const T mu = uu[Phys::kMu];
  T qk[E], qb[E];
#pragma unroll
  for (int v = 0; v < E; ++v) {
    qk[v] = uu[v];
    qb[v] = uu[v];
  }

#pragma unroll
  for (int k = 1; k < NN; ++k) {
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
      T f[E];
      elastic3d_het_flux<T>(qk, inv_rho, lame, mu, d, f);
#pragma unroll
      for (int v = 0; v < E; ++v) sF[iF(d, v, node, c)] = f[v];
    }
    __syncthreads();
#pragma unroll
    for (int v = 0; v < E; ++v) {
      T r = T(0);
#pragma unroll
      for (int d = 0; d < kDim; ++d) {
        const int st = node_stride<NN>(d);
        T dF = Drow[d][0] * sF[iF(d, v, base[d], c)];
#pragma unroll
        for (int j = 1; j < NN; ++j) {
          dF = dF + Drow[d][j] * sF[iF(d, v, base[d] + j * st, c)];
        }
        const T term = lam[d] * dF;
        r = d == 0 ? -term : r - term;
      }
      qk[v] = r / T(k);
      qb[v] = qb[v] + qk[v] / T(k + 1);
    }
    __syncthreads();
  }

  // q̄ of all rows (the materials are u's) and F̄_d = F_d(q̄).
  T qbar[V];
  T fbar[kDim][V];
#pragma unroll
  for (int v = 0; v < V; ++v) qbar[v] = v < E ? qb[v] : uu[v];
#pragma unroll
  for (int d = 0; d < kDim; ++d) P.phys.flux(qbar, d, fbar[d]);
  volume_and_faces<T, NN, CB, V>(uu, qbar, fbar, P, sF, sQ, node, c, ix, base, lam,
                                 valid, cell, ncell, out, faces);
}

// The face stage's tiling: a tile is kTile consecutive cells of one row of
// the last grid axis (one warp), the row (i0, i1) and the tile come from
// the block index; blocks of aderdg_face_flux take kFluxNodes face nodes of
// one axis, blocks of aderdg_surface_update kUpdateNodes space nodes.
constexpr int kTile = 32;
constexpr int kFluxNodes = 4;
constexpr int kUpdateNodes = 8;

// A thread's cell of the face stage: its grid coordinates, flat index, and
// whether it lies inside the grid (the last tile of a row may be ragged).
struct TileCell {
  int i[kDim];
  int g[kDim];
  long long cell;
  bool inside;

  __device__ __forceinline__ TileCell(int tile_index, const long long (&grid)[kDim]) {
#pragma unroll
    for (int d = 0; d < kDim; ++d) g[d] = static_cast<int>(grid[d]);
    const int ntile = (g[2] + kTile - 1) / kTile;
    const int row = tile_index / ntile;
    i[2] = (tile_index - row * ntile) * kTile + static_cast<int>(threadIdx.x);
    i[0] = row / g[1];
    i[1] = row - i[0] * g[1];
    inside = i[2] < g[2];
    cell = static_cast<long long>(row) * g[2] + i[2];
  }

  // The periodic neighbour one cell up (+1) or down (-1) axis d.
  __device__ __forceinline__ long long neighbour(int d, int step) const {
    const long long stride = d == 0 ? static_cast<long long>(g[1]) * g[2] : (d == 1 ? g[2] : 1);
    const int id = d == 0 ? i[0] : (d == 1 ? i[1] : i[2]);
    const int gd = d == 0 ? g[0] : (d == 1 ? g[1] : g[2]);
    if (step > 0) return id + 1 == gd ? cell - (gd - 1) * stride : cell + stride;
    return id == 0 ? cell + (gd - 1) * stride : cell - stride;
  }
};

// The face stage, first launch: one thread per (cell, axis d, face node m)
// solves the interface between the cell's high face and its +d
// neighbour's low face once, with the Rusanov flux
// F̂ = ½(f_hi + f_lo⁺) − ½ s m (q_lo⁺ − q_hi), s the larger wave speed of
// the two states, m the physics' dissipation weight of each row, and
// writes it to fhat[d][m][v][cell]: the cell's high-face flux and the
// neighbour's low-face flux.  Rows from Phys::kFluxRows on are zero by
// construction and are not written (the update never reads them).
template <typename T, int NN, typename Phys>
__global__ void __launch_bounds__(kTile * kFluxNodes)
aderdg_face_flux(const T* __restrict__ faces, T* __restrict__ fhat,
                 const Params<T, NN, Phys> P) {
  constexpr int NF = NN * NN;
  constexpr int V = Phys::V;
  constexpr int R = Phys::kFluxRows;
  const TileCell tc(blockIdx.x, P.g);
  if (!tc.inside) return;  // no barrier here
  const int d = blockIdx.y / (NF / kFluxNodes);
  const int m = (blockIdx.y % (NF / kFluxNodes)) * kFluxNodes + threadIdx.y;
  const long long ncell = P.ncell;
  const long long cell = tc.cell;
  const long long plus = tc.neighbour(d, 1);
  // faces[d][which][m][v][cell], which = q_lo, q_hi, f_lo, f_hi.
  const T* base = faces + static_cast<long long>(d * 4 * NF + m) * V * ncell;
  const long long wstride = static_cast<long long>(NF * V) * ncell;
  T qa[V], qb[V], fa[R], fb[R];  // a: my high face, b: the neighbour's low face
#pragma unroll
  for (int v = 0; v < V; ++v) {
    qa[v] = base[wstride + v * ncell + cell];
    qb[v] = base[v * ncell + plus];
  }
#pragma unroll
  for (int v = 0; v < R; ++v) {
    fa[v] = base[3 * wstride + v * ncell + cell];
    fb[v] = base[2 * wstride + v * ncell + plus];
  }
  const T s = dmax(P.phys.max_eigenvalue(qa, d), P.phys.max_eigenvalue(qb, d));
  T* out = fhat + static_cast<long long>(d * NF + m) * V * ncell + cell;
#pragma unroll
  for (int v = 0; v < R; ++v) {
    T dq = qb[v] - qa[v];
    if constexpr (Phys::kMasked) dq = dq * Phys::dissipation(v);
    out[v * ncell] = T(0.5) * (fa[v] + fb[v]) - T(0.5) * s * dq;
  }
}

// The face stage, second launch: one thread per (cell, space node) updates
// the node's rows 0..kFluxRows-1 of `state` in place with
// −λ_d (ℓ_i(1)/w_i F̂_hi − ℓ_i(0)/w_i F̂_lo) of each axis, F̂_hi the cell's
// own entry of fhat and F̂_lo its −d neighbour's.  The node groups of a
// tile are consecutive blocks, so the four nodes of a pencil that read one
// F̂ value, and the neighbour tiles' reads, find it in L2.
template <typename T, int NN, typename Phys>
__global__ void __launch_bounds__(kTile * kUpdateNodes)
aderdg_surface_update(T* __restrict__ state, const T* __restrict__ fhat,
                      const T* __restrict__ dt_ptr, T dt_val, const Params<T, NN, Phys> P) {
  constexpr int NF = NN * NN;
  constexpr int NG = NN * NF / kUpdateNodes;
  constexpr int V = Phys::V;
  constexpr int R = Phys::kFluxRows;
  const int tile_index = blockIdx.x / NG;
  const TileCell tc(tile_index, P.g);
  if (!tc.inside) return;
  const int node = (blockIdx.x - tile_index * NG) * kUpdateNodes + threadIdx.y;
  const long long ncell = P.ncell;
  const long long cell = tc.cell;
  const T dtv = dt_ptr != nullptr ? *dt_ptr : dt_val;
  const int ix[kDim] = {node / NF, (node / NN) % NN, node % NN};
  const int mf[kDim] = {ix[1] * NN + ix[2], ix[0] * NN + ix[2], ix[0] * NN + ix[1]};
  T lam[kDim], p1w[kDim], p0w[kDim];
  long long hi[kDim], lo[kDim];  // offsets of F̂_hi and F̂_lo of row 0
#pragma unroll
  for (int d = 0; d < kDim; ++d) {
    lam[d] = dtv / P.dx[d];
    p1w[d] = select<T, NN>(P.PHI1W, ix[d]);
    p0w[d] = select<T, NN>(P.PHI0W, ix[d]);
    const long long row0 = static_cast<long long>(d * NF + mf[d]) * V * ncell;
    hi[d] = row0 + cell;
    lo[d] = row0 + tc.neighbour(d, -1);
  }
#pragma unroll
  for (int v = 0; v < R; ++v) {
    const long long o = static_cast<long long>(node * V + v) * ncell + cell;
    T x = state[o];
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
      x = x - lam[d] * (p1w[d] * fhat[hi[d] + v * ncell] - p0w[d] * fhat[lo[d] + v * ncell]);
    }
    state[o] = x;
  }
}

// Host side ---------------------------------------------------------------

// ops: D, K1inv, Kvol (NN*NN each, row-major), W, PHI0, PHI1, PHI0W, PHI1W
// (NN each), float64, as DGOperators builds them.  params: the physics'
// parameters (Euler: gamma; elasticity: none).
template <typename T, int NN, typename Phys>
Params<T, NN, Phys> make_params(const double* ops, const double* dx, int picard_iters,
                                const double* params, long long g0, long long g1,
                                long long g2) {
  Params<T, NN, Phys> P;
  const double* o = ops;
  for (int i = 0; i < NN; ++i)
    for (int j = 0; j < NN; ++j) P.D[i][j] = static_cast<T>(o[i * NN + j]);
  o += NN * NN;
  for (int i = 0; i < NN; ++i)
    for (int j = 0; j < NN; ++j) P.K1inv[i][j] = static_cast<T>(o[i * NN + j]);
  o += NN * NN;
  for (int i = 0; i < NN; ++i)
    for (int j = 0; j < NN; ++j) P.Kvol[i][j] = static_cast<T>(o[i * NN + j]);
  o += NN * NN;
  T* vecs[5] = {P.W, P.PHI0, P.PHI1, P.PHI0W, P.PHI1W};
  for (int k = 0; k < 5; ++k) {
    for (int i = 0; i < NN; ++i) vecs[k][i] = static_cast<T>(o[i]);
    o += NN;
  }
  for (int d = 0; d < kDim; ++d) P.dx[d] = static_cast<T>(dx[d]);
  P.phys = Phys::make(params);
  P.picard_iters = picard_iters;
  P.g[0] = g0;
  P.g[1] = g1;
  P.g[2] = g2;
  P.ncell = g0 * g1 * g2;
  return P;
}

// Cells per block: a full 32-byte sector of cells for every (node, var).
template <typename T>
constexpr int cells_per_block() { return 32 / static_cast<int>(sizeof(T)); }

// Let `kernel` take `smem` bytes of dynamic shared memory: the opt-in
// above the 48 KB default (a host call of about a microsecond, made at every
// launch so that it holds on whichever card is current).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

constexpr int kNN = 4;  // order 3

bool bad_grid(int order, long long g0, long long g1, long long g2) {
  return order != kNN - 1 || g0 <= 0 || g1 <= 0 || g2 <= 0;
}

// Tiles of the face stage (kTile cells of one row of the last axis), or 0
// if the update kernel's block index (tiles x its node groups) or a grid
// coordinate would not fit a 32-bit int.
long long face_tiles(int order, long long g0, long long g1, long long g2) {
  constexpr long long kMax = 0x7fffffffLL;
  if (bad_grid(order, g0, g1, g2) || g0 > kMax || g1 > kMax || g2 > kMax) return 0;
  const long long tiles = g0 * g1 * ((g2 + kTile - 1) / kTile);
  return tiles * (kNN * kNN * kNN / kUpdateNodes) > kMax ? 0 : tiles;
}

// Each kernel's function, block and dynamic shared memory, as its launcher
// uses them (and the occupancy query reports them).
struct Shape {
  const void* fn;
  dim3 block;
  size_t smem;
};

template <typename T, typename Phys>
Shape predictor_shape() {
  constexpr int CB = cells_per_block<T>();
  return {reinterpret_cast<const void*>(aderdg_predictor_volume<T, kNN, CB, Phys>),
          dim3(CB * kNN * kNN), predictor_smem<T, kNN, CB, Phys::V>()};
}

template <typename T>
Shape ck_predictor_shape() {
  constexpr int CB = cells_per_block<T>();
  return {reinterpret_cast<const void*>(aderdg_ck_predictor_volume<T, kNN, CB>),
          dim3(CB * kNN * kNN * kNN),
          static_cast<size_t>((kDim + 1) * ElasticHetPhysics<T>::V * kNN * kNN * kNN * CB) *
              sizeof(T)};
}

template <typename T, typename Phys>
Shape face_flux_shape() {
  return {reinterpret_cast<const void*>(aderdg_face_flux<T, kNN, Phys>), dim3(kTile, kFluxNodes),
          0};
}

template <typename T, typename Phys>
Shape surface_update_shape() {
  return {reinterpret_cast<const void*>(aderdg_surface_update<T, kNN, Phys>),
          dim3(kTile, kUpdateNodes), 0};
}

template <typename T, typename Phys>
cudaError_t launch_predictor_volume(const T* u, T* out, T* faces, const T* dt_ptr,
                                    double dt_val, const double* ops, const double* dx,
                                    int order, int picard_iters, const double* params,
                                    long long g0, long long g1, long long g2,
                                    void* stream) {
  constexpr int CB = cells_per_block<T>();
  if (bad_grid(order, g0, g1, g2) || picard_iters < 0) return cudaErrorInvalidValue;
  const auto P = make_params<T, kNN, Phys>(ops, dx, picard_iters, params, g0, g1, g2);
  const Shape sh = predictor_shape<T, Phys>();
  const cudaError_t attr = allow_smem(aderdg_predictor_volume<T, kNN, CB, Phys>, sh.smem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (P.ncell + CB - 1) / CB;
  aderdg_predictor_volume<T, kNN, CB, Phys>
      <<<static_cast<unsigned>(blocks), sh.block, sh.smem,
         static_cast<cudaStream_t>(stream)>>>(u, out, faces, dt_ptr, static_cast<T>(dt_val), P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ck_predictor_volume(const T* u, T* out, T* faces, const T* dt_ptr,
                                       double dt_val, const double* ops, const double* dx,
                                       int order, const double* params, long long g0,
                                       long long g1, long long g2, void* stream) {
  using Phys = ElasticHetPhysics<T>;
  constexpr int CB = cells_per_block<T>();
  if (bad_grid(order, g0, g1, g2)) return cudaErrorInvalidValue;
  const auto P = make_params<T, kNN, Phys>(ops, dx, 0, params, g0, g1, g2);
  const Shape sh = ck_predictor_shape<T>();
  const cudaError_t attr = allow_smem(aderdg_ck_predictor_volume<T, kNN, CB>, sh.smem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (P.ncell + CB - 1) / CB;
  aderdg_ck_predictor_volume<T, kNN, CB>
      <<<static_cast<unsigned>(blocks), sh.block, sh.smem,
         static_cast<cudaStream_t>(stream)>>>(u, out, faces, dt_ptr, static_cast<T>(dt_val), P);
  return cudaGetLastError();
}

template <typename T, typename Phys>
cudaError_t launch_face_flux(const T* faces, T* fhat, const double* ops,
                             const double* dx, int order, const double* params, long long g0,
                             long long g1, long long g2, void* stream) {
  const long long tiles = face_tiles(order, g0, g1, g2);
  if (tiles == 0) return cudaErrorInvalidValue;
  const auto P = make_params<T, kNN, Phys>(ops, dx, 0, params, g0, g1, g2);
  const Shape sh = face_flux_shape<T, Phys>();
  const dim3 grid(static_cast<unsigned>(tiles), kDim * kNN * kNN / kFluxNodes);
  aderdg_face_flux<T, kNN, Phys><<<grid, sh.block, 0, static_cast<cudaStream_t>(stream)>>>(
      faces, fhat, P);
  return cudaGetLastError();
}

template <typename T, typename Phys>
cudaError_t launch_surface_update(T* state, const T* fhat, const T* dt_ptr, double dt_val,
                                  const double* ops, const double* dx, int order,
                                  const double* params, long long g0, long long g1,
                                  long long g2, void* stream) {
  const long long tiles = face_tiles(order, g0, g1, g2);
  if (tiles == 0) return cudaErrorInvalidValue;
  const auto P = make_params<T, kNN, Phys>(ops, dx, 0, params, g0, g1, g2);
  const Shape sh = surface_update_shape<T, Phys>();
  const long long blocks = tiles * (kNN * kNN * kNN / kUpdateNodes);
  aderdg_surface_update<T, kNN, Phys>
      <<<static_cast<unsigned>(blocks), sh.block, 0, static_cast<cudaStream_t>(stream)>>>(
          state, fhat, dt_ptr, static_cast<T>(dt_val), P);
  return cudaGetLastError();
}

template <typename T>
int predictor_volume(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                     const double* ops, const double* dx, int order, int picard_iters,
                     int physics, const double* params, long long g0, long long g1,
                     long long g2, void* stream) {
  if (physics != kEuler) return cudaErrorInvalidValue;
  return launch_predictor_volume<T, EulerPhysics<T>>(u, out, faces, dt_ptr, dt_val, ops, dx,
                                                     order, picard_iters, params, g0, g1,
                                                     g2, stream);
}

template <typename T>
int ck_predictor_volume(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                        const double* ops, const double* dx, int order, int physics,
                        const double* params, long long g0, long long g1, long long g2,
                        void* stream) {
  if (physics != kElasticHet) return cudaErrorInvalidValue;
  return launch_ck_predictor_volume<T>(u, out, faces, dt_ptr, dt_val, ops, dx, order, params,
                                       g0, g1, g2, stream);
}

template <typename T>
int face_flux(const T* faces, T* fhat, const double* ops, const double* dx,
              int order, int physics, const double* params, long long g0, long long g1,
              long long g2, void* stream) {
  switch (physics) {
    case kEuler:
      return launch_face_flux<T, EulerPhysics<T>>(faces, fhat, ops, dx, order,
                                                  params, g0, g1, g2, stream);
    case kElasticHet:
      return launch_face_flux<T, ElasticHetPhysics<T>>(faces, fhat, ops, dx, order,
                                                       params, g0, g1, g2, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int surface_update(T* state, const T* fhat, const T* dt_ptr, double dt_val, const double* ops,
                   const double* dx, int order, int physics, const double* params,
                   long long g0, long long g1, long long g2, void* stream) {
  switch (physics) {
    case kEuler:
      return launch_surface_update<T, EulerPhysics<T>>(state, fhat, dt_ptr, dt_val, ops, dx,
                                                       order, params, g0, g1, g2, stream);
    case kElasticHet:
      return launch_surface_update<T, ElasticHetPhysics<T>>(state, fhat, dt_ptr, dt_val, ops,
                                                            dx, order, params, g0, g1, g2,
                                                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Registers, resident blocks per SM, threads per block, dynamic shared
// memory and local (spill) bytes of one kernel, into out[0..4].
int shape_info(const Shape& sh, int* out) {
  if (sh.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sh.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sh.smem));
    if (e != cudaSuccess) return e;
  }
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, sh.fn);
  if (e != cudaSuccess) return e;
  const int threads = static_cast<int>(sh.block.x * sh.block.y * sh.block.z);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sh.fn, threads, sh.smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = blocks;
  out[2] = threads;
  out[3] = static_cast<int>(sh.smem);
  out[4] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}

template <typename T>
int kernel_info(int kernel, int physics, int* out) {
  const bool euler = physics == kEuler;
  if (physics != kEuler && physics != kElasticHet) return cudaErrorInvalidValue;
  switch (kernel) {
    case 0:
      return euler ? shape_info(predictor_shape<T, EulerPhysics<T>>(), out)
                   : cudaErrorInvalidValue;
    case 1:
      return euler ? cudaErrorInvalidValue : shape_info(ck_predictor_shape<T>(), out);
    case 2:
      return shape_info(euler ? face_flux_shape<T, EulerPhysics<T>>()
                              : face_flux_shape<T, ElasticHetPhysics<T>>(),
                        out);
    case 3:
      return shape_info(euler ? surface_update_shape<T, EulerPhysics<T>>()
                              : surface_update_shape<T, ElasticHetPhysics<T>>(),
                        out);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns the launch's
// cudaError_t (0 = cudaSuccess).  dt_ptr: a device scalar of the state's
// dtype, or null to use dt_val.  physics: 0 = 3-D Euler (params = {gamma}),
// 1 = 3-D heterogeneous elasticity with its CK configuration (no params);
// the Picard predictor is instantiated for Euler, the CK predictor for the
// elasticity, the face stage (face_flux, then surface_update) for both.
// fhat: [dim, n^(dim-1), n_vars, *grid], the interface fluxes; face_flux
// leaves the rows that are zero by construction (the elasticity's
// materials) unwritten.  Only order 3 is instantiated.

int exahype_aderdg_predictor_volume_f32(const float* u, float* out, float* faces,
                                        const float* dt_ptr, double dt_val,
                                        const double* ops, const double* dx, int order,
                                        int picard_iters, int physics, const double* params,
                                        long long g0, long long g1, long long g2,
                                        void* stream) {
  return predictor_volume<float>(u, out, faces, dt_ptr, dt_val, ops, dx, order, picard_iters,
                                 physics, params, g0, g1, g2, stream);
}

int exahype_aderdg_predictor_volume_f64(const double* u, double* out, double* faces,
                                        const double* dt_ptr, double dt_val,
                                        const double* ops, const double* dx, int order,
                                        int picard_iters, int physics, const double* params,
                                        long long g0, long long g1, long long g2,
                                        void* stream) {
  return predictor_volume<double>(u, out, faces, dt_ptr, dt_val, ops, dx, order, picard_iters,
                                  physics, params, g0, g1, g2, stream);
}

int exahype_aderdg_ck_predictor_volume_f32(const float* u, float* out, float* faces,
                                           const float* dt_ptr, double dt_val,
                                           const double* ops, const double* dx, int order,
                                           int physics, const double* params, long long g0,
                                           long long g1, long long g2, void* stream) {
  return ck_predictor_volume<float>(u, out, faces, dt_ptr, dt_val, ops, dx, order, physics,
                                    params, g0, g1, g2, stream);
}

int exahype_aderdg_ck_predictor_volume_f64(const double* u, double* out, double* faces,
                                           const double* dt_ptr, double dt_val,
                                           const double* ops, const double* dx, int order,
                                           int physics, const double* params, long long g0,
                                           long long g1, long long g2, void* stream) {
  return ck_predictor_volume<double>(u, out, faces, dt_ptr, dt_val, ops, dx, order, physics,
                                     params, g0, g1, g2, stream);
}

int exahype_aderdg_face_flux_f32(const float* faces, float* fhat,
                                 const double* ops, const double* dx, int order, int physics,
                                 const double* params, long long g0, long long g1, long long g2,
                                 void* stream) {
  return face_flux<float>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2,
                          stream);
}

int exahype_aderdg_face_flux_f64(const double* faces, double* fhat,
                                 const double* ops, const double* dx, int order, int physics,
                                 const double* params, long long g0, long long g1, long long g2,
                                 void* stream) {
  return face_flux<double>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2,
                           stream);
}

int exahype_aderdg_surface_update_f32(float* state, const float* fhat, const float* dt_ptr,
                                      double dt_val, const double* ops, const double* dx,
                                      int order, int physics, const double* params,
                                      long long g0, long long g1, long long g2, void* stream) {
  return surface_update<float>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics, params,
                               g0, g1, g2, stream);
}

int exahype_aderdg_surface_update_f64(double* state, const double* fhat, const double* dt_ptr,
                                      double dt_val, const double* ops, const double* dx,
                                      int order, int physics, const double* params,
                                      long long g0, long long g1, long long g2, void* stream) {
  return surface_update<double>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics, params,
                                g0, g1, g2, stream);
}

// out[0..4]: registers per thread, resident blocks per SM, threads per
// block, dynamic shared memory bytes and local (spill) bytes per thread of
// one kernel as its launcher launches it: kernel 0 = predictor_volume,
// 1 = ck_predictor_volume, 2 = face_flux, 3 = surface_update; f64 = 0 or 1.
int exahype_aderdg_kernel_info(int kernel, int f64, int physics, int* out) {
  return f64 ? kernel_info<double>(kernel, physics, out)
             : kernel_info<float>(kernel, physics, out);
}

const char* exahype_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
