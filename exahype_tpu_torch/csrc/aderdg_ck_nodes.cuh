// K2 b, the Cauchy–Kovalewski predictor a thread a space node, for linear
// systems: the homogeneous 3-D elasticity at order 2 (csrc/aderdg.cu's entry
// aderdg_ck_predictor_volume_p2, NN = 3, 9 variables) and the 2-D
// elasticity at order 3 (csrc/aderdg_2d.cu's entry
// aderdg_ck_predictor_volume_2d, NN = 4, 5 variables), and (K2 b.1) the
// systems whose last rows are frozen slots: the 12-variable heterogeneous
// elasticity at order 2 (the _p2 entry, ElasticHetPhysics), the 8-variable
// 2-D heterogeneous one and the 10-variable curvilinear lift of the 2-D
// elasticity at order 3 (the _2d entry, ElasticHet2D, CurvilinearElastic).
// Each source instantiates it with its own parameter bank (Params,
// Params2D: the same members) and its own physics (csrc/elastic.cuh).
//
// Replaces the predictor_mode == "ck" branch of the TPU kernel
// exahype_tpu/models/aderdg_pallas.py::PallasADERDG.build (:358-430, with
// its material injection, inject/zero_mat :377-419, but no source or NCP)
// and its epilogue (the volume integral and the face projections); the
// plain PyTorch version is
// exahype_tpu_torch/models/aderdg.py::ADERDGSolver.predictor_volume on a
// predictor_mode="ck" solver (_predictor_ck).
//
// Design.  K2's pencil mapping (a warp the 16 pencils of 2 cells, the
// contractions along axes 0 and 1 by xor shuffles) needs NN = 4 in 3-D; at
// NN = 3 a cell has 9 pencils, and a 2-D cell has 4.  This kernel takes
// csrc/aderdg_st.cuh's design instead: a thread a space node, CB cells a
// block.  A thread holds its node's Taylor term q_k and the running q̄ in
// registers (2V values); each level shares the fluxes: every thread writes
// its node's DIM axis fluxes F_d(q_{k−1}) to shared memory, a barrier, and
// each thread contracts the lines through its node with its own rows of D,
// r = −λ_0 D F_0 − λ_1 D F_1 (− λ_2 D F_2), q_k = r/k, q̄ += q_k/(k+1) (the
// Pallas branch's order, λ_d = dt/dx_d inside and /k after; the plain
// version's (dt/k)·L is the same function up to rounding); a second
// barrier frees the buffer for the next level.  There are NN − 1 levels.
// The epilogue takes F̄_d = F_d(q̄) at each node (the flux is linear), puts
// q̄ and F̄_d beside u in shared memory, and the volume integral new = u +
// Σ_d λ_d Kvol F̄_d and the face projections (q_lo, q_hi, f_lo, f_hi) of
// every axis run in the I/O mapping, the block's cells fastest (CB values a
// run), from shared memory to device memory; u is staged in through the
// same mapping.  A cell's nodes sit at an odd stride in shared memory, so
// that the I/O mapping's accesses (CB cells at one node) are free of bank
// conflicts (2-D p3 pads its 16 nodes to 17).
//
// Frozen slots (K2 b.1: Phys::kFluxRows = R < V, the rows R..V-1 frozen:
// materials, or J and the metric).  The reference injects u's frozen rows
// into each level's Taylor term before its flux (inject) and zeroes them
// in the level's result (zero_mat), so q̄'s frozen rows are u's.  Here a
// thread's q_k keeps u's frozen rows through the recursion (the injection)
// and only its R flux rows are formed a level (the zeroing): the fluxes of
// a level read all V rows and write R, the shared flux buffer holds R rows
// an axis, q̄ keeps u's frozen rows, F̄_d = F_d(q̄) is R rows, new's frozen
// rows are u's bits, and the face projections of the frozen rows are q̄'s
// (u's) for q_lo and q_hi, which the face stage reads for the flux and the
// wave speed (ρ, λ, μ; J and J·a^k), and exact zeros for f_lo and f_hi.  The
// code for R < V sits in `if constexpr` branches, so the R = V instances
// compile as before.
//
// What bounds it: per cell and step it reads the state and writes the
// state and 4·DIM face rows (3-D p2: 243 + 243 + 972 values; 2-D p3: 80 +
// 80 + 160), against ~2·V·DIM·NN flops a node and level in the
// contractions: a few flops a byte, under the card's ridge, so it is
// memory-bound; the levels' shared-memory traffic (DIM·NN reads a value)
// is what it pays on top.  Offsets into device memory are 64-bit; IEEE
// division (no fast math); the ragged last block clamps its loads and
// masks its stores.
#pragma once

#include <cuda_runtime.h>

#include "aderdg_common.cuh"

namespace {

// Space nodes of a cell, and node stride of axis d (row-major, the last
// axis fastest).
template <int DIM, int NN>
__host__ __device__ constexpr int ck_cell_nodes() { return DIM == 2 ? NN * NN : NN * NN * NN; }

// A cell's stride in a shared-memory row: its node count, made odd, so that
// the I/O mapping's accesses (the block's cells fastest, at one node) fall
// on distinct banks (2-D p3's 16 nodes would put 16 cells on 2 banks).
template <int DIM, int NN>
__host__ __device__ constexpr int ck_cell_stride() {
  return ck_cell_nodes<DIM, NN>() + (ck_cell_nodes<DIM, NN>() % 2 == 0 ? 1 : 0);
}

template <int DIM, int NN>
__host__ __device__ __forceinline__ int ck_node_stride(int d) {
  int s = 1;
#pragma unroll
  for (int e = DIM - 1; e > 0; --e) {
    if (e > d) s *= NN;
  }
  return s;
}

// Shared memory of a block, in values of T: u [V][NS], the fluxes
// [DIM][R][NS] (F_d(q_{k−1}) of a level, then F̄_d; R the rows with flux),
// q̄ [V][NS] and Kvol [NN][NN]; a row NS = CB · ck_cell_stride holds the
// block's space nodes cell by cell.
template <int DIM, int NN, int CB, int V, int R = V>
constexpr size_t ck_nodes_smem_values() {
  return static_cast<size_t>((2 * V + DIM * R) * CB * ck_cell_stride<DIM, NN>() + NN * NN);
}

// In float32, three resident blocks an SM are asked for (3-D p2 took 99
// registers a thread and so two blocks, 13 warps, without the request).
template <typename T, int DIM, int NN, int CB, typename Phys, typename Prm>
__global__ void __launch_bounds__(CB * ck_cell_nodes<DIM, NN>(), sizeof(T) == 4 ? 3 : 1)
aderdg_ck_predictor_nodes(const T* __restrict__ u, T* __restrict__ out, T* __restrict__ faces,
                          const T* __restrict__ dt_ptr, T dt_val, const Prm P) {
  constexpr int V = Phys::V;
  constexpr int R = Phys::kFluxRows;            // rows with flux; R..V-1 frozen
  constexpr int NC = ck_cell_nodes<DIM, NN>();   // space nodes of a cell
  constexpr int NP = CB * NC;                    // of the block: its thread count
  constexpr int NF = NC / NN;                    // face nodes of an axis
  constexpr int SC = ck_cell_stride<DIM, NN>();  // a cell's stride in a row
  constexpr int NS = CB * SC;                    // a row of shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sU = reinterpret_cast<T*>(smem_raw);  // u [v][point]
  T* sF = sU + V * NS;                     // the fluxes [d][v][point], v < R
  T* sQ = sF + DIM * R * NS;               // q̄ [v][point]
  T* sK = sQ + V * NS;                     // Kvol

  const long long ncell = P.ncell;
  const long long cell0 = static_cast<long long>(blockIdx.x) * CB;

  // u into shared memory in the I/O mapping: element e = (node V + v) CB + c
  // of the block, V of them a thread, the block's cells fastest; the ragged
  // last block clamps its loads to the last cell.
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
      sU[v * NS + c * SC + node] = x[k];
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NN; ++i) {
#pragma unroll
      for (int j = 0; j < NN; ++j) sK[i * NN + j] = P.Kvol[i][j];
    }
  }

  // The compute mapping: thread t is node `node` of the block's cell t / NC,
  // at point pt of a row; its index along axis d is id[d], the line along d
  // through it starts at pt − id[d]·st[d].
  const int node = static_cast<int>(threadIdx.x) % NC;
  const int pt = (static_cast<int>(threadIdx.x) / NC) * SC + node;
  int id[DIM], st[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    st[d] = ck_node_stride<DIM, NN>(d);
    id[d] = (node / st[d]) % NN;
  }
  T Dr[DIM][NN];  // D's row of my index along each axis
#pragma unroll
  for (int d = 0; d < DIM; ++d) select_row<T, NN>(P.D, id[d], Dr[d]);
  const T dtv = dt_ptr != nullptr ? *dt_ptr : dt_val;
  T lam[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) lam[d] = dtv / P.dx[d];
  __syncthreads();  // u and Kvol staged

  // The Taylor recursion: q_k = −Σ_d λ_d D_d F_d(q_{k−1}) / k, q̄ += q_k /
  // (k + 1), the fluxes of each level through shared memory; the frozen
  // rows of q_k and q̄ stay u's.
  T qk[V], qb[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    qk[v] = sU[v * NS + pt];
    qb[v] = qk[v];
  }
#pragma unroll
  for (int k = 1; k < NN; ++k) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      T f[R];
      P.phys.flux(qk, d, f);
#pragma unroll
      for (int v = 0; v < R; ++v) sF[(d * R + v) * NS + pt] = f[v];
    }
    __syncthreads();  // every node's fluxes of level k − 1 are in
#pragma unroll
    for (int v = 0; v < R; ++v) {
      T r;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const T* x = sF + (d * R + v) * NS + pt - id[d] * st[d];  // the line's first node
        T acc = Dr[d][0] * x[0];
#pragma unroll
        for (int j = 1; j < NN; ++j) acc = acc + Dr[d][j] * x[j * st[d]];
        r = d == 0 ? -(lam[0] * acc) : r - lam[d] * acc;
      }
      qk[v] = r / T(k);
      qb[v] = qb[v] + qk[v] / T(k + 1);
    }
    __syncthreads();  // the buffer is free again
  }

  // F̄_d = F_d(q̄) at my node, and q̄, into shared memory.
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    T f[R];
    P.phys.flux(qb, d, f);
#pragma unroll
    for (int v = 0; v < R; ++v) sF[(d * R + v) * NS + pt] = f[v];
  }
#pragma unroll
  for (int v = 0; v < V; ++v) sQ[v * NS + pt] = qb[v];
  __syncthreads();

  // Back in the I/O mapping.  The volume integral, new = u + Σ_d λ_d
  // Kvol_d F̄_d, of element e = (node V + v) CB + c (a frozen row: u).
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int e = static_cast<int>(threadIdx.x) + k * NP;
    const int c = e % CB, r = e / CB;
    const int n = r / V, v = r - n * V;
    const int at = c * SC + n;  // the node's point
    T nv = sU[v * NS + at];
    bool moves = true;
    if constexpr (R < V) moves = v < R;
    if (moves) {
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const int sd = ck_node_stride<DIM, NN>(d);
        const int in = (n / sd) % NN;
        const T* x = sF + (d * R + v) * NS + at - in * sd;
        const T* kr = sK + in * NN;
        T kv = kr[0] * x[0];
#pragma unroll
        for (int j = 1; j < NN; ++j) kv = kv + kr[j] * x[j * sd];
        nv = nv + lam[d] * kv;
      }
    }
    if (cell0 + c < ncell) out[static_cast<long long>(r) * ncell + cell0 + c] = nv;
  }

  // The face projections of element e = ((d NF + m) V + v) CB + c: the line
  // of nodes along d through face node m (the other axes' indices, in
  // order), projected with φ(0) and φ(1).  faces[d][which][m][v][cell],
  // which = q_lo, q_hi, f_lo, f_hi (a frozen row's f_lo and f_hi: zero).
  const long long stride_w = static_cast<long long>(NF * V) * ncell;
  for (int e = static_cast<int>(threadIdx.x); e < DIM * NF * V * CB; e += NP) {
    const int c = e % CB, r = e / CB;
    if (cell0 + c >= ncell) continue;
    const int v = r % V, dm = r / V;
    const int d = dm / NF, m = dm - d * NF;
    int base = 0, rest = m;
#pragma unroll
    for (int a = DIM - 1; a >= 0; --a) {
      if (a == d) continue;
      base += (rest % NN) * ck_node_stride<DIM, NN>(a);
      rest /= NN;
    }
    const int sd = ck_node_stride<DIM, NN>(d);
    const T* xq = sQ + v * NS + c * SC + base;
    T qlo, qhi, flo, fhi;
    if constexpr (R == V) {
      const T* xf = sF + (d * V + v) * NS + c * SC + base;
      qlo = P.PHI0[0] * xq[0], qhi = P.PHI1[0] * xq[0];
      flo = P.PHI0[0] * xf[0], fhi = P.PHI1[0] * xf[0];
#pragma unroll
      for (int j = 1; j < NN; ++j) {
        const T qj = xq[j * sd], fj = xf[j * sd];
        qlo = qlo + P.PHI0[j] * qj;
        qhi = qhi + P.PHI1[j] * qj;
        flo = flo + P.PHI0[j] * fj;
        fhi = fhi + P.PHI1[j] * fj;
      }
    } else {
      qlo = P.PHI0[0] * xq[0], qhi = P.PHI1[0] * xq[0];
#pragma unroll
      for (int j = 1; j < NN; ++j) {
        const T qj = xq[j * sd];
        qlo = qlo + P.PHI0[j] * qj;
        qhi = qhi + P.PHI1[j] * qj;
      }
      flo = fhi = T(0);
      if (v < R) {
        const T* xf = sF + (d * R + v) * NS + c * SC + base;
        flo = P.PHI0[0] * xf[0], fhi = P.PHI1[0] * xf[0];
#pragma unroll
        for (int j = 1; j < NN; ++j) {
          const T fj = xf[j * sd];
          flo = flo + P.PHI0[j] * fj;
          fhi = fhi + P.PHI1[j] * fj;
        }
      }
    }
    const long long o = (static_cast<long long>(d * 4 * NF + m) * V + v) * ncell + cell0 + c;
    faces[o] = qlo;
    faces[o + stride_w] = qhi;
    faces[o + 2 * stride_w] = flo;
    faces[o + 3 * stride_w] = fhi;
  }
}

// The kernel's shape as a launcher uses it (function, block, dynamic
// shared memory).
template <typename T, int DIM, int NN, int CB, typename Phys, typename Prm>
Shape ck_nodes_shape() {
  return {reinterpret_cast<const void*>(aderdg_ck_predictor_nodes<T, DIM, NN, CB, Phys, Prm>),
          dim3(CB * ck_cell_nodes<DIM, NN>()),
          ck_nodes_smem_values<DIM, NN, CB, Phys::V, Phys::kFluxRows>() * sizeof(T)};
}

// Launch it over the grid's ncell cells (CB a block) on `stream`.
template <typename T, int DIM, int NN, int CB, typename Phys, typename Prm>
cudaError_t launch_ck_nodes(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                            const Prm& P, void* stream) {
  const Shape sh = ck_nodes_shape<T, DIM, NN, CB, Phys, Prm>();
  const cudaError_t attr =
      allow_smem(aderdg_ck_predictor_nodes<T, DIM, NN, CB, Phys, Prm>, sh.smem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (P.ncell + CB - 1) / CB;
  aderdg_ck_predictor_nodes<T, DIM, NN, CB, Phys, Prm>
      <<<static_cast<unsigned>(blocks), sh.block, sh.smem, static_cast<cudaStream_t>(stream)>>>(
          u, out, faces, dt_ptr, static_cast<T>(dt_val), P);
  return cudaGetLastError();
}

}  // namespace
