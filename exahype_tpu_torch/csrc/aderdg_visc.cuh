// The viscous ADER-DG predictor for Hopper (sm_90a): 3-D compressible
// Navier–Stokes at order 3, periodic or closed by domain walls.  Its
// float32 instances and C interface are csrc/aderdg_visc.cu, its float64
// ones csrc/aderdg_visc_f64.cu: two sources that nvcc compiles in parallel
// (the float64 instances spill, and ptxas takes longest on them).
//
// Replaces the viscous terms of the TPU kernel exahype_tpu/models/
// aderdg_pallas.py::PallasADERDG.build inside its Picard body (the physical
// gradient sweeps and the viscous flux in every iteration and in the time
// averages, :324-336, 556-597, 693-705) and, on a walled viscous solver, its
// viscous-only wall fluxes (visc_wall_axes, :216-228, 837-845, 900-903,
// 1006-1009).  The numbers to match are those of exahype_tpu/models/
// aderdg.py::ADERDGSolver.predictor with visc_flux_fn; the plain PyTorch
// version is exahype_tpu_torch/models/aderdg.py::ADERDGSolver.
// predictor_volume on a viscous solver.  The face stage with the Gassner
// penalty and the viscous wall split is csrc/aderdg.cu's, instantiated for
// NavierStokesPhysics.
//
//   aderdg_predictor_volume_visc  cell-local: the Picard space-time
//                            predictor with F_d(q) + F_v,d(q, grad q) at every
//                            node and time slice, the time averages q̄ and
//                            F̄_d (the gradients of the final q), the volume
//                            integral new = u + Σ_d λ_d Kvol F̄_d, the face
//                            projections (q_lo, q_hi, f_lo, f_hi) of every
//                            axis and, with walls, the viscous-only F̄v_d of
//                            each wall axis projected to its wall planes (the
//                            first row's low faces, the last row's high
//                            faces) into a side tensor in the Dirichlet rows'
//                            layout of csrc/aderdg.cu.
//
// Design.  The Euler predictor's thread shape (csrc/aderdg.cu, K1): a
// thread holds one pencil of a cell along the last node axis, 4 nodes x 4
// time slices x 5 vars of q (its right-hand sides in the same registers), a
// warp the 16 pencils of 2 cells, so the axis-2 contraction is thread-local
// and axes 0 and 1 are 3 xor shuffles an output.  The viscous flux at a
// node needs the physical gradient of all 5 variables along all 3 axes.
// They come the same way as the flux contractions: axis 2 from my own
// pencil, axes 0 and 1 by xor shuffles of q, recomputed a node at a time
// (15 values) and consumed at once by the viscous flux.  Within a time
// slice a node's right-hand side replaces its q as soon as its fluxes are
// taken, so the slice's axis-2 derivatives of q are taken first, for all 4
// nodes of the pencil (20 values); the shuffles of a node read the other
// lanes' q of the same node, which they replace only after the same
// shuffles.  The time averages recompute the gradients of the final q, as
// the reference does, and sum q̄, F̄_d (and with walls the viscous-only
// F̄v_d, for the wall-plane projections) in each thread's own words of
// shared memory, a slice at a time.
//
// What bounds it on the H100: operations, about 2.2x the Euler predictor's
// flops a cell (chip_smoke.py::visc_predictor_ops) against the same bytes.
// The time-slice loops are not unrolled: the slice being worked on is always
// q[0], and the slices rotate by one after each (80 register moves), so
// every slice runs the same code.  Unrolled as the Euler predictor is, the
// body is ~19,500 instructions (its 16 copies of the gradient and viscous
// flux), more than the instruction caches hold, and ran 1.7x slower on an
// H100 80GB HBM3 at 700 W (PERF.md); rotated it is ~7,400.  A thread holds
// q (80 registers), the slice's axis-2 derivatives and right-hand-side sums
// (40) and a node's gradients and fluxes: ~205 registers, 2 blocks of 128
// an SM; the periodic instance is held to 168 for 3 blocks (the walled
// one's shared memory admits 2 only).  IEEE division and square root (no fast math); gradients
// divide by dx after the contraction, as the reference does.  There are no
// races and no atomics: the step is bitwise deterministic.

#pragma once

#include <cuda_runtime.h>

#include "aderdg_common.cuh"

namespace {

constexpr int kNN = 4;  // order 3: the node count of this file's instances

// The wall planes of the viscous split (mask 0: none).
template <typename T>
struct ViscPlanes {
  int mask;              // bit d: grid axis d carries walls
  T* planes;             // [side][wall axis][m][v][plane]
  long long off[kDim];   // element offset of axis d's block within a side
  long long side;        // elements of one side
};

// Dynamic shared memory of aderdg_predictor_volume_visc: u, q̄ and F̄_d of
// the block's cells, and with the wall split F̄v_d.
template <typename T, int NN, int CB, int V, bool kSplit>
constexpr size_t visc_predictor_smem() {
  return static_cast<size_t>((2 + kDim + (kSplit ? kDim : 0)) * V * Slabs<NN, CB>::kVar) *
         sizeof(T);
}

template <typename T, int NN, int CB, bool kSplit>
__global__ void __launch_bounds__(CB * NN * NN, kSplit ? 2 : 3)
aderdg_predictor_volume_visc(const T* __restrict__ u, T* __restrict__ out,
                             T* __restrict__ faces, const T* __restrict__ dt_ptr, T dt_val,
                             const Params<T, NN, NavierStokesPhysics<T>> P,
                             const ViscPlanes<T> W) {
  static_assert(NN * NN * 2 == 32, "a warp holds the 16 pencils of 2 cells");
  constexpr int NF = NN * NN;
  constexpr int V = kDim + 2;
  constexpr unsigned kAll = 0xffffffffu;
  using L = Slabs<NN, CB>;
  constexpr int kArr = V * L::kVar;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sU = reinterpret_cast<T*>(smem_raw);  // u
  T* sQ = sU + kArr;                       // q̄
  T* sFbar = sQ + kArr;                    // F̄_d at sFbar + d * kArr
  T* sFv = sFbar + kDim * kArr;            // F̄v_d at sFv + d * kArr (kSplit)

  // The I/O mapping (global loads and stores): cells fastest.
  const int c_io = threadIdx.x % CB;
  const int p_io = threadIdx.x / CB;
  const int j0 = p_io / NN, j1 = p_io % NN;
  const long long ncell = P.ncell;
  const long long cell_raw = static_cast<long long>(blockIdx.x) * CB + c_io;
  const bool valid = cell_raw < ncell;
  const long long cell = valid ? cell_raw : ncell - 1;  // ragged tail: clamp
  const long long at0 = static_cast<long long>(p_io * NN * V) * ncell + cell;
  auto gat = [&](int i2, int v) { return at0 + static_cast<long long>(i2 * V + v) * ncell; };
  using U = PencilStage<NN, CB>;
  U::template load<T, V>(u, sU, p_io, c_io, at0, ncell);

  // The compute mapping: lane = 2 (4 i0 + i1) + cell bit; the pencils along
  // axes 0 and 1 through mine are lanes xor k<<3 and xor k<<1.
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

  auto Uat = [&](int i2, int v) { return sU[U::at(v, i2, i0 * NN + i1, c)]; };
  T q[NN][NN][V];  // [time slice][i2][v]
#pragma unroll
  for (int s = 0; s < NN; ++s) {
#pragma unroll
    for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
      for (int v = 0; v < V; ++v) q[s][i2][v] = Uat(i2, v);
    }
  }

  // The physical gradient g[e][v] at node i2 of a time slice qs, from the
  // axis-2 contraction dq2 (D q along my pencil, taken by the caller) and
  // the shuffles of qs[i2] along axes 0 and 1.  Every lane of the warp
  // calls it at the same node.
  auto gradient = [&](const T (&qi)[V], const T (&dq2)[V], T (&g)[kDim][V]) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      T a0 = X0[0] * qi[v];
      T a1 = X1[0] * qi[v];
#pragma unroll
      for (int k = 1; k < NN; ++k) {
        a0 = a0 + X0[k] * __shfl_xor_sync(kAll, qi[v], k << 3);
        a1 = a1 + X1[k] * __shfl_xor_sync(kAll, qi[v], k << 1);
      }
      g[0][v] = a0 / P.dx[0];
      g[1][v] = a1 / P.dx[1];
      g[2][v] = dq2[v] / P.dx[2];
    }
  };
  // The total flux f = F(q) + F_v(q, g) of every axis at a node, and the
  // viscous part fv.
  auto fluxes = [&](const T (&qi)[V], const T (&g)[kDim][V], T (&f)[kDim][V],
                    T (&fv)[kDim][V]) {
    P.phys.fluxes(qi, f);
    P.phys.viscous_fluxes(qi, g, fv);
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
#pragma unroll
      for (int v = 1; v < V; ++v) f[d][v] = f[d][v] + fv[d][v];
    }
  };

  // Picard: q <- K1inv (θ(0) u − Σ_d λ_d w ∂_ξd (F_d + F_v,d)(q)), time
  // slice by slice, node by node of my pencil.
  for (int it = 0; it < P.picard_iters; ++it) {
    // One time slice a trip, always the one in q[0]: after each trip the
    // slices rotate by one, so after NN trips they are back in order.  The
    // loop is not unrolled, so its body is a quarter of the unrolled code.
#pragma unroll 1
    for (int s = 0; s < NN; ++s) {
      const T phi0_s = select<T, NN>(P.PHI0, s);
      T lw[kDim];
      {
        const T w_s = select<T, NN>(P.W, s);
#pragma unroll
        for (int d = 0; d < kDim; ++d) lw[d] = lam[d] * w_s;
      }
      // The slice's axis-2 derivatives, before its right-hand sides
      // replace q[0].
      T dq2[NN][V];
#pragma unroll
      for (int n = 0; n < NN; ++n) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          T acc = P.D[n][0] * q[0][0][v];
#pragma unroll
          for (int j = 1; j < NN; ++j) acc = acc + P.D[n][j] * q[0][j][v];
          dq2[n][v] = acc;
        }
      }
      T dF2[NN][V];
#pragma unroll
      for (int i2 = 0; i2 < NN; ++i2) {
        T f[kDim][V];
        {
          T g[kDim][V], fv[kDim][V];
          gradient(q[0][i2], dq2[i2], g);
          fluxes(q[0][i2], g, f, fv);
        }
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
          T r = phi0_s * Uat(i2, v);
          r = r - lw[0] * dF0;
          q[0][i2][v] = r - lw[1] * dF1;  // q[0][i2]'s fluxes are taken: its rhs goes here
        }
      }
#pragma unroll
      for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
        for (int v = 0; v < V; ++v) q[0][i2][v] = q[0][i2][v] - lw[2] * dF2[i2][v];
      }
#pragma unroll
      for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const T first = q[0][i2][v];
#pragma unroll
          for (int t = 0; t + 1 < NN; ++t) q[t][i2][v] = q[t + 1][i2][v];
          q[NN - 1][i2][v] = first;
        }
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

  // Time averages of the final q and of its fluxes (the gradients of the
  // final q), slice by slice as the Picard loop goes (the slice in q[0],
  // then a rotation), summed in shared memory in each thread's own words.
#pragma unroll 1
  for (int s = 0; s < NN; ++s) {
    const T w = select<T, NN>(P.W, s);
#pragma unroll
    for (int i2 = 0; i2 < NN; ++i2) {
      T dq2[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        T acc = P.D[i2][0] * q[0][0][v];
#pragma unroll
        for (int j = 1; j < NN; ++j) acc = acc + P.D[i2][j] * q[0][j][v];
        dq2[v] = acc;
      }
      T g[kDim][V], f[kDim][V], fv[kDim][V];
      gradient(q[0][i2], dq2, g);
      fluxes(q[0][i2], g, f, fv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int at = L::at(v, i0, i1, i2, c);
        sQ[at] = s == 0 ? w * q[0][i2][v] : sQ[at] + w * q[0][i2][v];
#pragma unroll
        for (int d = 0; d < kDim; ++d) {
          T& fb = sFbar[d * kArr + at];
          fb = s == 0 ? w * f[d][v] : fb + w * f[d][v];
          if constexpr (kSplit) {
            T& fvb = sFv[d * kArr + at];
            if (v == 0) {
              fvb = T(0);
            } else {
              fvb = s == 0 ? w * fv[d][v] : fvb + w * fv[d][v];
            }
          }
        }
      }
    }
#pragma unroll
    for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const T first = q[0][i2][v];
#pragma unroll
        for (int t = 0; t + 1 < NN; ++t) q[t][i2][v] = q[t + 1][i2][v];
        q[NN - 1][i2][v] = first;
      }
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
      T nv = sU[U::at(v, i2, p_io, c_io)];
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
  auto node_of = [&](int d, int v, int j) {
    return d == 2 ? L::at(v, j0, j1, j, c_io)
                  : (d == 0 ? L::at(v, j, j1, j0, c_io) : L::at(v, j0, j, j1, c_io));
  };
  auto face_node = [&](int d) { return d == 0 ? j1 * NN + j0 : j0 * NN + j1; };
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
      const T q0 = sQ[node_of(d, v, 0)], f0 = sFbar[d * kArr + node_of(d, v, 0)];
      T qlo = P.PHI0[0] * q0, qhi = P.PHI1[0] * q0;
      T flo = P.PHI0[0] * f0, fhi = P.PHI1[0] * f0;
#pragma unroll
      for (int j = 1; j < NN; ++j) {
        const T qj = sQ[node_of(d, v, j)];
        const T fj = sFbar[d * kArr + node_of(d, v, j)];
        qlo = qlo + P.PHI0[j] * qj;
        qhi = qhi + P.PHI1[j] * qj;
        flo = flo + P.PHI0[j] * fj;
        fhi = fhi + P.PHI1[j] * fj;
      }
      const long long o = (static_cast<long long>(d * 4 * NF + face_node(d)) * V + v) * ncell + cell;
      faces[o] = qlo;
      faces[o + stride_w] = qhi;
      faces[o + 2 * stride_w] = flo;
      faces[o + 3 * stride_w] = fhi;
    }
  }

  if constexpr (kSplit) {
    // The viscous-only wall fluxes: on a wall axis d, a cell of the first
    // row projects F̄v_d to its low face (side 0), a cell of the last row to
    // its high face (side 1), at its face node of axis d, into the plane
    // layout [m][v][plane] of the axis's block (plane: my cell with i_d
    // dropped, row-major).
    const long long g1 = P.g[1], g2 = P.g[2];
    const long long ci[kDim] = {cell / (g1 * g2), (cell / g2) % g1, cell % g2};
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
      if (!((W.mask >> d) & 1)) continue;
      const bool lo = ci[d] == 0, hi = ci[d] == P.g[d] - 1;
      if (!lo && !hi) continue;
      const long long plane = d == 0 ? g1 * g2 : P.g[0] * (d == 1 ? g2 : g1);
      const long long p = d == 0 ? ci[1] * g2 + ci[2]
                                 : ci[0] * (d == 1 ? g2 : g1) + (d == 1 ? ci[2] : ci[1]);
      T* base = W.planes + W.off[d] + static_cast<long long>(face_node(d)) * V * plane + p;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const T x0 = sFv[d * kArr + node_of(d, v, 0)];
        T flo = P.PHI0[0] * x0, fhi = P.PHI1[0] * x0;
#pragma unroll
        for (int j = 1; j < NN; ++j) {
          const T xj = sFv[d * kArr + node_of(d, v, j)];
          flo = flo + P.PHI0[j] * xj;
          fhi = fhi + P.PHI1[j] * xj;
        }
        if (lo) base[v * plane] = flo;
        if (hi) base[W.side + v * plane] = fhi;
      }
    }
  }
}

template <typename T, bool kSplit>
Shape visc_predictor_shape() {
  constexpr int CB = cells_per_block<T>();
  return {reinterpret_cast<const void*>(aderdg_predictor_volume_visc<T, kNN, CB, kSplit>),
          dim3(CB * kNN * kNN), visc_predictor_smem<T, kNN, CB, kDim + 2, kSplit>()};
}

template <typename T, bool kSplit>
cudaError_t launch(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                   const Params<T, kNN, NavierStokesPhysics<T>>& P, const ViscPlanes<T>& W,
                   void* stream) {
  constexpr int CB = cells_per_block<T>();
  const Shape sh = visc_predictor_shape<T, kSplit>();
  const cudaError_t attr = allow_smem(aderdg_predictor_volume_visc<T, kNN, CB, kSplit>, sh.smem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (P.ncell + CB - 1) / CB;
  aderdg_predictor_volume_visc<T, kNN, CB, kSplit>
      <<<static_cast<unsigned>(blocks), sh.block, sh.smem, static_cast<cudaStream_t>(stream)>>>(
          u, out, faces, dt_ptr, static_cast<T>(dt_val), P, W);
  return cudaGetLastError();
}

template <typename T>
int predictor_volume_visc(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                          const double* ops, const double* dx, int order, int picard_iters,
                          int physics, const double* params, long long g0, long long g1,
                          long long g2, int wall_mask, T* planes, const long long* wall_off,
                          long long wall_side, void* stream) {
  if (physics != kNavierStokes || bad_grid<kNN>(order, g0, g1, g2) || picard_iters < 0 ||
      wall_mask < 0 || wall_mask > 7)
    return cudaErrorInvalidValue;
  if (wall_mask != 0 && (planes == nullptr || wall_off == nullptr || wall_side <= 0))
    return cudaErrorInvalidValue;
  const auto P = make_params<T, kNN, NavierStokesPhysics<T>>(ops, dx, picard_iters, params, g0,
                                                             g1, g2);
  ViscPlanes<T> W{};
  if (wall_mask == 0) return launch<T, false>(u, out, faces, dt_ptr, dt_val, P, W, stream);
  W.mask = wall_mask;
  W.planes = planes;
  W.side = wall_side;
  for (int d = 0; d < kDim; ++d) W.off[d] = wall_off[d];
  return launch<T, true>(u, out, faces, dt_ptr, dt_val, P, W, stream);
}

}  // namespace
