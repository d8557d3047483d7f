// ADER-DG step on a periodic 3-D grid for Hopper (sm_90a): three kernels,
// templated on the physics (3-D compressible Euler, 3-D heterogeneous
// elasticity).
//
// Replaces the TPU kernel exahype_tpu/models/aderdg_pallas.py::
// PallasADERDG.build (its pallas_call and the XLA face epilogue around it)
// on the periodic, flux-form path: the Picard branch of its body (K1) and
// its predictor_mode == "ck" branch (K2).  The numbers to match are those of
// exahype_tpu/models/aderdg.py::ADERDGSolver.step; the plain PyTorch version
// is exahype_tpu_torch/models/aderdg.py::ADERDGSolver.{predictor_volume,
// face_surface}.
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
//   aderdg_face_surface      per cell and axis: the Rusanov flux of its high
//                            face and of its low face, then the surface
//                            update of `new`, in place; optionally each
//                            cell's high-face fluxes of every axis, which the
//                            limiter's interface matching reads (the TPU
//                            kernel's emit_fused_fhat outputs).
//
// What bounds it on the H100.  The predictor is compute-bound: ~3e5 flops
// per cell per step (4 Picard iterations of flux evaluations and 4-point
// contractions) against 6.4 KB of device-memory traffic per cell in f32,
// ~46 flops per byte, above the card's f32 ridge of ~20.  The face kernel
// is memory-bound: a few thousand flops against 6-10 KB per cell.  At
// order 3 one cell's space-time array is 4 time nodes x 64 space nodes x
// 5 vars = 1,280 values (5 KB in f32), twice that with the Picard
// right-hand sides: one thread per cell cannot keep it in 255 registers.
// So the design puts one thread on each (cell, space node): a thread keeps
// its node's 4 time slices and right-hand sides (40 values) in registers,
// the time-axis contractions (K1inv, the quadrature weights) are
// thread-local, and only the space-axis contractions (D, Kvol, the face
// projections) go through shared memory, one flux array per time slice.
// Threads run over cells fastest (CB cells x 64 nodes per block), and cells
// are the contiguous last axis of the SoA-P layout, so every global load
// and store is a full 32-byte sector.  The face kernel recomputes each
// cell's low-face flux from the neighbour's face data rather than receiving
// it, so there are no races and no float atomics: the step is bitwise
// deterministic run to run.  Offsets are 64-bit.  IEEE division and square
// root (no fast math).  The Euler physics is csrc/euler.cuh, shared with the
// generated spec kernels; the elastic physics is csrc/elastic.cuh.
//
// K2, the CK predictor (elasticity, 12 variables).  Its work is smaller than
// one Picard iteration: N = 3 applications of the spatial operator on the
// spatial nodal array, no space-time array.  So it is memory-bound: ~1e5
// flops per cell against 15.4 KB per cell in f32 (the state read and
// written, 3 KB each, and 9.2 KB of faces written), ~7 flops per byte,
// under the f32 ridge; so is the face kernel's 12-variable variant, with
// the same bytes and fewer flops.  It keeps the Picard kernel's
// layout, one thread per (cell, node) and CB cells per block.  A thread
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
// exact zeros (zero flux rows, and the face kernel multiplies their jump by
// the mask's 0), so slots 9-11 leave the step bitwise unchanged.  Shared
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

// Each physics: V variables, flux(q, d, f) of all V rows,
// max_eigenvalue(q, d), and the dissipation weight of each row in the
// Rusanov jump term (kMasked: whether any weight is not 1).
template <typename T>
struct EulerPhysics {
  static constexpr int V = kDim + 2;
  static constexpr bool kMasked = false;
  T gm1;  // gamma - 1
  T gamma;
  static EulerPhysics make(const double* params) {
    return {static_cast<T>(params[0] - 1.0), static_cast<T>(params[0])};
  }
  __device__ __forceinline__ void flux(const T* q, int d, T* f) const {
    euler_flux<T, kDim, V>(q, d, gm1, f);
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

template <typename T, int NN, int CB, typename Phys>
__global__ void __launch_bounds__(CB * NN * NN * NN)
aderdg_predictor_volume(const T* __restrict__ u, T* __restrict__ out,
                        T* __restrict__ faces, const T* __restrict__ dt_ptr,
                        T dt_val, const Params<T, NN, Phys> P) {
  constexpr int NF = NN * NN;
  constexpr int NODES = NN * NF;
  constexpr int V = Phys::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // sF[d][v][node][c]: one flux array per axis; sQ[v][node][c]: q̄.
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
  T q[NN][V];
#pragma unroll
  for (int s = 0; s < NN; ++s) {
#pragma unroll
    for (int v = 0; v < V; ++v) q[s][v] = uu[v];
  }

  // Picard: q <- K1inv (θ(0) u − Σ_d λ_d w ∂_ξd F_d(q)), time slice by slice.
  for (int it = 0; it < P.picard_iters; ++it) {
    T rhs[NN][V];
#pragma unroll
    for (int s = 0; s < NN; ++s) {
#pragma unroll
      for (int d = 0; d < kDim; ++d) {
        T f[V];
        P.phys.flux(q[s], d, f);
#pragma unroll
        for (int v = 0; v < V; ++v) sF[iF(d, v, node, c)] = f[v];
      }
      __syncthreads();
#pragma unroll
      for (int v = 0; v < V; ++v) {
        T r = P.PHI0[s] * uu[v];
#pragma unroll
        for (int d = 0; d < kDim; ++d) {
          const int st = node_stride<NN>(d);
          T dF = Drow[d][0] * sF[iF(d, v, base[d], c)];
#pragma unroll
          for (int j = 1; j < NN; ++j) {
            dF = dF + Drow[d][j] * sF[iF(d, v, base[d] + j * st, c)];
          }
          r = r - (lam[d] * P.W[s]) * dF;
        }
        rhs[s][v] = r;
      }
      __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < NN; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        T acc = P.K1inv[s][0] * rhs[0][v];
#pragma unroll
        for (int t = 1; t < NN; ++t) acc = acc + P.K1inv[s][t] * rhs[t][v];
        q[s][v] = acc;
      }
    }
  }

  // Time averages of the final q and of its fluxes.
  T qbar[V];
  T fbar[kDim][V];
#pragma unroll
  for (int s = 0; s < NN; ++s) {
    const T w = P.W[s];
#pragma unroll
    for (int v = 0; v < V; ++v) qbar[v] = s == 0 ? w * q[s][v] : qbar[v] + w * q[s][v];
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
      T f[V];
      P.phys.flux(q[s], d, f);
#pragma unroll
      for (int v = 0; v < V; ++v) fbar[d][v] = s == 0 ? w * f[v] : fbar[d][v] + w * f[v];
    }
  }
  volume_and_faces<T, NN, CB, V>(uu, qbar, fbar, P, sF, sQ, node, c, ix, base, lam,
                                 valid, cell, ncell, out, faces);
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

// Rusanov flux between left state (qa, fa) and right state (qb, fb) on an
// axis-d face: ½(fa + fb) − ½ s (m (qb − qa)), s the larger wave speed of
// the two states, m the physics' dissipation weight of each row (applied
// only where the physics has a mask, so Euler computes what it always did).
template <typename T, typename Phys>
__device__ __forceinline__ void rusanov(const T* qa, const T* qb, const T* fa,
                                        const T* fb, int d, const Phys& phys,
                                        T* fhat) {
  const T s = dmax(phys.max_eigenvalue(qa, d), phys.max_eigenvalue(qb, d));
#pragma unroll
  for (int v = 0; v < Phys::V; ++v) {
    T dq = qb[v] - qa[v];
    if constexpr (Phys::kMasked) dq = dq * Phys::dissipation(v);
    fhat[v] = T(0.5) * (fa[v] + fb[v]) - T(0.5) * s * dq;
  }
}

template <typename T, int NN, int CB, typename Phys>
__global__ void __launch_bounds__(CB * NN * NN * NN)
aderdg_face_surface(T* __restrict__ state, const T* __restrict__ faces,
                    T* __restrict__ fhat_out, const T* __restrict__ dt_ptr,
                    T dt_val, const Params<T, NN, Phys> P) {
  constexpr int NF = NN * NN;
  constexpr int V = Phys::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // sH[d][side][v][m][c]: side 0 = high face, 1 = low face.
  T* sH = reinterpret_cast<T*>(smem_raw);
  auto iH = [](int d, int side, int v, int m, int c) {
    return (((d * 2 + side) * V + v) * NF + m) * CB + c;
  };

  const int c = threadIdx.x % CB;
  const int node = threadIdx.x / CB;
  const long long ncell = P.ncell;
  const long long cell_raw = static_cast<long long>(blockIdx.x) * CB + c;
  const bool valid = cell_raw < ncell;
  const long long cell = valid ? cell_raw : ncell - 1;
  const T dtv = dt_ptr != nullptr ? *dt_ptr : dt_val;

  if (node < kDim * NF) {
    const int d = node / NF;
    const int m = node % NF;
    const long long gstride = d == 0 ? P.g[1] * P.g[2] : (d == 1 ? P.g[2] : 1);
    const long long gd = P.g[d];
    const long long cd = (cell / gstride) % gd;
    const long long plus = cell + (cd + 1 == gd ? -(gd - 1) * gstride : gstride);
    const long long minus = cell + (cd == 0 ? (gd - 1) * gstride : -gstride);
    auto load = [&](int which, long long at, T* x) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        x[v] = faces[(static_cast<long long>((d * 4 + which) * NF + m) * V + v) * ncell + at];
      }
    };
    T qa[V], qb[V], fa[V], fb[V], fhat[V];
    // My high face: me (q_hi, f_hi) | plus neighbour (q_lo, f_lo).
    load(1, cell, qa);
    load(0, plus, qb);
    load(3, cell, fa);
    load(2, plus, fb);
    rusanov(qa, qb, fa, fb, d, P.phys, fhat);
#pragma unroll
    for (int v = 0; v < V; ++v) sH[iH(d, 0, v, m, c)] = fhat[v];
    // fhat_out[d][m][v][cell], the layout of the face tensor's entries.
    if (fhat_out != nullptr && valid) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        fhat_out[(static_cast<long long>(d * NF + m) * V + v) * ncell + cell] = fhat[v];
      }
    }
    // My low face: minus neighbour (q_hi, f_hi) | me (q_lo, f_lo) — the
    // same operands in the same order as the neighbour's own high face.
    load(1, minus, qa);
    load(0, cell, qb);
    load(3, minus, fa);
    load(2, cell, fb);
    rusanov(qa, qb, fa, fb, d, P.phys, fhat);
#pragma unroll
    for (int v = 0; v < V; ++v) sH[iH(d, 1, v, m, c)] = fhat[v];
  }
  __syncthreads();

  // Surface update of my node: −λ_d (ℓ_i(1)/w_i F̂_hi − ℓ_i(0)/w_i F̂_lo).
  const int ix[kDim] = {node / NF, (node / NN) % NN, node % NN};
  const int mf[kDim] = {ix[1] * NN + ix[2], ix[0] * NN + ix[2], ix[0] * NN + ix[1]};
  T lam[kDim], p1w[kDim], p0w[kDim];
#pragma unroll
  for (int d = 0; d < kDim; ++d) {
    lam[d] = dtv / P.dx[d];
    p1w[d] = select<T, NN>(P.PHI1W, ix[d]);
    p0w[d] = select<T, NN>(P.PHI0W, ix[d]);
  }
  if (!valid) return;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const long long o = static_cast<long long>(node * V + v) * ncell + cell;
    T x = state[o];
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
      x = x - lam[d] * (p1w[d] * sH[iH(d, 0, v, mf[d], c)] -
                        p0w[d] * sH[iH(d, 1, v, mf[d], c)]);
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

template <typename T, typename Phys>
cudaError_t launch_predictor_volume(const T* u, T* out, T* faces, const T* dt_ptr,
                                    double dt_val, const double* ops, const double* dx,
                                    int order, int picard_iters, const double* params,
                                    long long g0, long long g1, long long g2,
                                    void* stream) {
  constexpr int NN = kNN;
  constexpr int CB = cells_per_block<T>();
  if (bad_grid(order, g0, g1, g2) || picard_iters < 0) return cudaErrorInvalidValue;
  const auto P = make_params<T, NN, Phys>(ops, dx, picard_iters, params, g0, g1, g2);
  const size_t smem = static_cast<size_t>((kDim + 1) * Phys::V * NN * NN * NN * CB) * sizeof(T);
  const cudaError_t attr = allow_smem(aderdg_predictor_volume<T, NN, CB, Phys>, smem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (P.ncell + CB - 1) / CB;
  aderdg_predictor_volume<T, NN, CB, Phys>
      <<<static_cast<unsigned>(blocks), CB * NN * NN * NN, smem,
         static_cast<cudaStream_t>(stream)>>>(u, out, faces, dt_ptr, static_cast<T>(dt_val), P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ck_predictor_volume(const T* u, T* out, T* faces, const T* dt_ptr,
                                       double dt_val, const double* ops, const double* dx,
                                       int order, const double* params, long long g0,
                                       long long g1, long long g2, void* stream) {
  using Phys = ElasticHetPhysics<T>;
  constexpr int NN = kNN;
  constexpr int CB = cells_per_block<T>();
  if (bad_grid(order, g0, g1, g2)) return cudaErrorInvalidValue;
  const auto P = make_params<T, NN, Phys>(ops, dx, 0, params, g0, g1, g2);
  const size_t smem = static_cast<size_t>((kDim + 1) * Phys::V * NN * NN * NN * CB) * sizeof(T);
  const cudaError_t attr = allow_smem(aderdg_ck_predictor_volume<T, NN, CB>, smem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (P.ncell + CB - 1) / CB;
  aderdg_ck_predictor_volume<T, NN, CB>
      <<<static_cast<unsigned>(blocks), CB * NN * NN * NN, smem,
         static_cast<cudaStream_t>(stream)>>>(u, out, faces, dt_ptr, static_cast<T>(dt_val), P);
  return cudaGetLastError();
}

template <typename T, typename Phys>
cudaError_t launch_face_surface(T* state, const T* faces, T* fhat, const T* dt_ptr,
                                double dt_val, const double* ops, const double* dx,
                                int order, const double* params, long long g0,
                                long long g1, long long g2, void* stream) {
  constexpr int NN = kNN;
  constexpr int CB = cells_per_block<T>();
  if (bad_grid(order, g0, g1, g2)) return cudaErrorInvalidValue;
  const auto P = make_params<T, NN, Phys>(ops, dx, 0, params, g0, g1, g2);
  const size_t smem = static_cast<size_t>(kDim * 2 * Phys::V * NN * NN * CB) * sizeof(T);
  const cudaError_t attr = allow_smem(aderdg_face_surface<T, NN, CB, Phys>, smem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (P.ncell + CB - 1) / CB;
  aderdg_face_surface<T, NN, CB, Phys>
      <<<static_cast<unsigned>(blocks), CB * NN * NN * NN, smem,
         static_cast<cudaStream_t>(stream)>>>(state, faces, fhat, dt_ptr,
                                              static_cast<T>(dt_val), P);
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
int face_surface(T* state, const T* faces, T* fhat, const T* dt_ptr, double dt_val,
                 const double* ops, const double* dx, int order, int physics,
                 const double* params, long long g0, long long g1, long long g2,
                 void* stream) {
  switch (physics) {
    case kEuler:
      return launch_face_surface<T, EulerPhysics<T>>(state, faces, fhat, dt_ptr, dt_val, ops,
                                                     dx, order, params, g0, g1, g2, stream);
    case kElasticHet:
      return launch_face_surface<T, ElasticHetPhysics<T>>(state, faces, fhat, dt_ptr, dt_val,
                                                          ops, dx, order, params, g0, g1, g2,
                                                          stream);
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
// elasticity, the face kernel for both.  fhat: [dim, n^(dim-1), n_vars,
// *grid] for the high-face fluxes, or null to skip them.  Only order 3 is
// instantiated.

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

int exahype_aderdg_face_surface_f32(float* state, const float* faces, float* fhat,
                                    const float* dt_ptr, double dt_val, const double* ops,
                                    const double* dx, int order, int physics,
                                    const double* params, long long g0, long long g1,
                                    long long g2, void* stream) {
  return face_surface<float>(state, faces, fhat, dt_ptr, dt_val, ops, dx, order, physics,
                             params, g0, g1, g2, stream);
}

int exahype_aderdg_face_surface_f64(double* state, const double* faces, double* fhat,
                                    const double* dt_ptr, double dt_val, const double* ops,
                                    const double* dx, int order, int physics,
                                    const double* params, long long g0, long long g1,
                                    long long g2, void* stream) {
  return face_surface<double>(state, faces, fhat, dt_ptr, dt_val, ops, dx, order, physics,
                              params, g0, g1, g2, stream);
}

const char* exahype_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
