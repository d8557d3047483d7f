// Definitions shared by the ADER-DG kernels of csrc/aderdg.cu (the Euler
// and elastic predictors, the face stage), csrc/aderdg_visc.cu (the
// viscous predictor), csrc/aderdg_z4*.cu (the Z4 steps: vacuum, shifted
// and coupled to matter, magnetized or not) and csrc/aderdg_p4*.cu,
// aderdg_p5*.cu and aderdg_p7*.cu (the space-time predictor at orders 4, 5
// and 7, csrc/aderdg_st.cuh): the physics the Picard
// predictors and the face stage compile in, the kernels' parameter bank,
// the predictors' shared-memory layouts, the face stage's tiling, and the
// host-side helpers of their launchers.  Each source compiles its own copy
// (an anonymous namespace).
#pragma once

#include <cuda_runtime.h>

#include "euler.cuh"
#include "navier_stokes.cuh"

namespace {

constexpr int kDim = 3;

// Physics ids of the C interface.
enum PhysicsId : int {
  kEuler = 0, kElasticHet = 1, kNavierStokes = 2, kZ4 = 3, kZ4Shift = 4, kZ4Matter = 5,
  kZ4Grmhd = 6, kElastic3D = 7, kElastic2D = 8, kElasticHet2D = 9, kCurvilinearElastic = 10
};

template <typename T>
__device__ __forceinline__ T momentum(const T* q, int d) {
  return d == 0 ? q[1] : (d == 1 ? q[2] : q[3]);
}

// Each physics: V variables (Euler: its fluxes(q, f) of all V rows along
// every axis, for the Picard predictor; K2 calls csrc/elastic.cuh's flux
// itself, with the materials it holds), max_eigenvalue(q, d), the dissipation weight of each row in the
// Rusanov jump term (kMasked: whether any weight is not 1), and kFluxRows:
// the rows 0..kFluxRows-1 whose face flux can be nonzero (the others have
// zero flux and a zero weight, so their F̂ is zero and their state never
// moves); kViscous: whether the face stage adds a diffusion penalty to the
// dissipation speed and splits the wall flux (Navier–Stokes).
template <typename T>
struct EulerPhysics {
  static constexpr int V = kDim + 2;
  static constexpr int kFluxRows = V;
  static constexpr bool kMasked = false;
  static constexpr bool kViscous = false;
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
  // The flux along axis d (a wall's ghost flux F(ghost)); d is dispatched
  // to compile-time axes, so q and f stay in registers.
  __device__ __forceinline__ void flux_along(const T* q, int d, T* f) const {
    const T inv_rho = T(1) / q[0];
    const T p = euler_pressure_from<T, kDim>(q, inv_rho, gm1);
#pragma unroll
    for (int dd = 0; dd < kDim; ++dd) {
      if (dd == d) euler_flux_from<T, kDim, V>(q, dd, inv_rho, p, f);
    }
  }
  static __device__ __forceinline__ T dissipation(int) { return T(1); }
};

// Compressible Navier–Stokes: Euler's flux and wave speed, and the viscous
// terms of csrc/navier_stokes.cuh.  params: gamma, mu, max(4/3, gamma/Pr),
// kappa_T = mu gamma / ((gamma - 1) Pr), and the face penalty factor
// 2 (2N + 1) / dx_d of each axis, each computed in float64 on the host as
// the plain solver computes it.
template <typename T>
struct NavierStokesPhysics : EulerPhysics<T> {
  static constexpr bool kViscous = true;
  T mu;
  T c_kappa;  // max(4/3, gamma/Pr): kappa = c_kappa mu / rho
  T kappa_T;  // the heat conductivity
  T pen[kDim];
  static NavierStokesPhysics make(const double* params) {
    return {EulerPhysics<T>::make(params), static_cast<T>(params[1]),
            static_cast<T>(params[2]), static_cast<T>(params[3]),
            {static_cast<T>(params[4]), static_cast<T>(params[5]), static_cast<T>(params[6])}};
  }
  // The largest diffusion eigenvalue max(4/3, gamma/Pr) mu / rho.
  __device__ __forceinline__ T kappa(const T* q) const { return c_kappa * (mu / q[0]); }
  // The Gassner penalty 2 (2N + 1) / dx_d max(kappa_a, kappa_b) of a face
  // along d (d is dispatched to compile-time axes, see select_row).
  __device__ __forceinline__ T penalty(const T* qa, const T* qb, int d) const {
    T p = pen[0];
#pragma unroll
    for (int i = 1; i < kDim; ++i) {
      if (i == d) p = pen[i];
    }
    return p * dmax(kappa(qa), kappa(qb));
  }
  // The viscous flux of every axis from the state and its physical
  // gradients g[e][v] (rows 1..V-1; the mass row is zero).
  __device__ __forceinline__ void viscous_fluxes(const T* q, const T (&g)[kDim][kDim + 2],
                                                 T (&fv)[kDim][kDim + 2]) const {
    navier_stokes_viscous_fluxes<T>(q, g, this->gm1, mu, kappa_T, fv);
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

// A cell's nodal rows in shared memory (u; K2 also q̄ and F̄_d), laid out
// for the two predictors' compute mapping (a warp holds the 16 pencils of 2
// cells): in each (v, i2) row, lane 2 p + (c % 2) of warp c / 2 finds its
// word at 2 (p ^ i2) + (c % 2), rotated by 8 (c / 2), of the warp's 32,
// conflict-free.  The rotation spreads the I/O mapping's accesses at one i2
// (NF / (32 / CB) pencils x CB cells a warp) over the banks, and the XOR
// with i2 those of K2's face projections along axes 0 and 1, which read
// four i2 rows of one pencil at once.  load() stages the block's cells
// from device memory in the I/O mapping (CB cells fastest, 32-byte runs);
// at0 is the offset of the thread's pencil's node (j0, j1, 0), variable 0
// and cell.
template <int NN, int CB>
struct PencilStage {
  static constexpr int kNF = NN * NN;
  static __device__ __forceinline__ int at(int v, int i2, int pencil, int cc) {
    return (v * NN + i2) * (kNF * CB) + (cc / 2) * 32 +
           (((pencil ^ i2) * 2 + (cc % 2) + (cc / 2) * 8) & 31);
  }
  template <typename T, int V>
  static __device__ __forceinline__ void load(const T* __restrict__ u, T* s, int p_io, int c_io,
                                              long long at0, long long ncell) {
#pragma unroll
    for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        s[at(v, i2, p_io, c_io)] = u[at0 + static_cast<long long>(i2 * V + v) * ncell];
      }
    }
  }
};

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

// The face stage's tiling: a tile is kTile consecutive cells of one row of
// the last grid axis (one warp), the row (i0, i1) and the tile come from
// the block index.
constexpr int kTile = 32;

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

  // My index along axis d, the grid's extent along it, and the plane across
  // it: its size and my index in it (my cell with i_d dropped, row-major).
  __device__ __forceinline__ int at(int d) const {
    return d == 0 ? i[0] : (d == 1 ? i[1] : i[2]);
  }
  __device__ __forceinline__ int extent(int d) const {
    return d == 0 ? g[0] : (d == 1 ? g[1] : g[2]);
  }
  __device__ __forceinline__ long long plane(int d) const {
    return d == 0 ? static_cast<long long>(g[1]) * g[2]
                  : static_cast<long long>(g[0]) * (d == 1 ? g[2] : g[1]);
  }
  __device__ __forceinline__ long long plane_index(int d) const {
    return d == 0 ? static_cast<long long>(i[1]) * g[2] + i[2]
                  : static_cast<long long>(i[0]) * (d == 1 ? g[2] : g[1]) + (d == 1 ? i[2] : i[1]);
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

// Host side -----------------------------------------------------------

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

// Whether a launch of an instance with NN nodes an axis cannot take this
// order or grid (each source names the node count of its instances).
template <int NN>
bool bad_grid(int order, long long g0, long long g1, long long g2) {
  return order != NN - 1 || g0 <= 0 || g1 <= 0 || g2 <= 0;
}

// Each kernel's function, block and dynamic shared memory, as its launcher
// uses them (and the occupancy query reports them).
struct Shape {
  const void* fn;
  dim3 block;
  size_t smem;
};

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

}  // namespace
