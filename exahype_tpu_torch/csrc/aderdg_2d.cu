// ADER-DG step on a 2-D grid for Hopper (sm_90a) at order 3 (NN = 4), three
// launches a step, float32 and float64: compressible Euler (4 variables),
// periodic or closed by domain walls, compressible Navier–Stokes (4
// variables), periodic or walled, also at order 2 (NN = 3, the _p2_2d
// entries), and the elasticity (5 variables, K2 b:
// examples/seismic_point_source.py --ck), periodic or walled, on the CK
// predictor of csrc/aderdg_ck_nodes.cuh (entry
// aderdg_ck_predictor_volume_2d) and this file's face pairs over
// Elastic2D (csrc/elastic.cuh), which take their variable count, their flux
// rows (kFluxRows) and their dissipation mask (kMasked) from the physics.
// K2 b.1, the same entries over the systems with frozen last rows: the
// 8-variable heterogeneous elasticity (ElasticHet2D, physics 9), periodic or
// walled, and the 10-variable curvilinear lift of the elasticity
// (CurvilinearElastic, physics 10: examples/seismic_topography.py), periodic;
// their face pairs solve and update the wave rows only, the masked jump on
// each, so the frozen rows leave the step bitwise unchanged.  The shared helpers (the parameter bank's row
// selection, the occupancy query, the shared-memory opt-in) are
// csrc/aderdg_common.cuh's; the dimension is this file's own: the 3-D
// sources keep theirs (kDim = 3), so their kernels are untouched.  The
// kernels are templated on the physics (Euler2D, NavierStokes2D); the
// viscous code sits in `if constexpr` branches, so the Euler instances
// compile to the code they had without them.
//
// Replaces the TPU kernel exahype_tpu/models/aderdg_pallas.py::
// PallasADERDG.build (K1 c, its 2-D Euler p3 and Navier–Stokes p3 and p2
// instances; pallas_call at :917; the viscous terms of its Picard body
// :324-336 and the Gassner penalty of rusanov_speed :238-250; the
// viscous-only wall fluxes of visc_wall_axes :216-228, 556-597, 837-845,
// 900-903) and, on a grid with walls, the XLA face_update it routes every
// axis through (:52-55, 198-212; the advective/viscous wall split of
// exahype_tpu/models/aderdg.py::ADERDGSolver.face_update :795-840).  The
// numbers to match are those of
// exahype_tpu/models/aderdg.py::ADERDGSolver.step; the plain PyTorch
// version is exahype_tpu_torch/models/aderdg.py::ADERDGSolver.
// {predictor_volume, face_surface} (the face stage's halves:
// interface_flux and low_wall_flux, surface_term).
//
//   aderdg_predictor_volume_2d  cell-local: the Picard space-time predictor
//                            over picard_iters iterations, the time
//                            averages q̄ and F̄_d, the volume integral new =
//                            u + Σ_d λ_d Kvol F̄_d and the face projections
//                            (q_lo, q_hi, f_lo, f_hi) of both axes into
//                            faces[d][which][m][v][cell].
//                            Over NavierStokes2D (the C entry
//                            exahype_aderdg_predictor_volume_visc_2d):
//                            F_d + F_v,d at every node and slice, F_v,d
//                            from the physical gradients of the slice's q
//                            (csrc/navier_stokes.cuh's 2-D form); with
//                            walls (NavierStokesWalls2D) also the
//                            viscous-only F̄v_d of each wall axis projected
//                            to its wall planes, a side tensor in the
//                            Dirichlet rows' layout.
//   aderdg_face_flux_2d      the face stage, first launch: the Rusanov flux
//                            of every interface, once, into fhat[d][m][v]
//                            [cell] (each cell's high-face fluxes: the
//                            limiter's face-flux input); for Navier–Stokes
//                            its dissipation speed gains the Gassner
//                            penalty 2(2N+1)/dx_d max(κ⁻, κ⁺).
//   aderdg_surface_update_2d the face stage, second launch: the surface
//                            update of `new`, in place (it reads no
//                            physics: one instance for both).
//   aderdg_face_flux_walls_2d, aderdg_surface_update_walls_2d
//                            the face stage on a grid with walls: on a wall
//                            axis the last row's right state is the ghost
//                            of its own high face (F̂ there is the
//                            high-wall flux), the first row also solves its
//                            low wall into the side tensor fwall
//                            [wall axis][m][v][plane], which the update
//                            reads in place of the wrapped neighbour.  The
//                            ghosts: a sign table times my face (mirror;
//                            outflow is the all-ones table), the farfield
//                            state or the Dirichlet row, with F(ghost) for
//                            the last two, as csrc/aderdg.cu's 3-D wall pair;
//                            for Navier–Stokes the ghost flux of the
//                            advective part plus the interior viscous
//                            wall plane, and the penalty in s_w.
//
// At order 2 (NN = 3) the Navier–Stokes instances are the same templates:
// the predictor takes 32 cells of 9 nodes a block (288 threads, 9 whole
// warps; cells_2d), the face pair a thread per (cell, face node) and per
// (cell, node) as at order 3.
//
// Design.  At order 3 in 2-D a cell has 16 space nodes and 4 time slices,
// 256 values of q (and as many right-hand sides): the 3-D predictor's
// pencil shape (a warp the 16 pencils of 2 cells) has no counterpart.  The
// predictor takes csrc/aderdg_st.cuh's design instead: a thread a space
// node, kCells2D cells a block (256 threads).  A thread keeps its node's q
// of every slice in registers (a slice's right-hand side replaces its q
// once the slice's fluxes are taken); only the fluxes are shared: for each
// slice every thread writes its node's two axis fluxes to shared memory
// (double-buffered, one barrier a slice) and contracts the two lines
// through its node with its own rows of D, in the plain version's order
// (φ0 u − λ_0 w D·F_0 − λ_1 w D·F_1); q ← K1inv rhs is thread-local.
// Navier–Stokes first shares the slice's q (a second barrier a slice) for
// the gradients, which stay in registers with one buffer of fluxes.  The
// epilogue averages q and its fluxes in registers, stores q̄ and F̄_d over
// the flux buffers, and the volume integral and the face projections run
// in the I/O mapping (the block's cells fastest: 64-byte runs in float32)
// from shared memory to device memory; u is staged through shared memory
// in the same mapping and stays there for the right-hand sides.
//
// The face stage is memory-bound (~8 flops a byte): a thread per (cell,
// axis, face node) solves one interface, a thread per (cell, space node)
// updates one node; consecutive threads take consecutive cells of the
// flattened grid, so every access is a run of a warp's 32 cells.  No
// atomics and no races: the step is bitwise repeatable, and the face-flux
// output changes no bit of the state.  IEEE division and square root (no
// fast math); nvcc contracts a·b + c into fused multiply-adds, so the
// kernels differ from the plain version by rounding only.  Offsets into
// device memory are 64-bit.

#include <cuda_runtime.h>

#include "aderdg_ck_nodes.cuh"
#include "aderdg_common.cuh"
#include "elastic.cuh"

namespace {

constexpr int kDim2 = 2;
// Order 3: the node count of this file's instances.
constexpr int kNN2 = 4;
// Cells a block of the predictor (16 threads each).
constexpr int kCells2D = 16;
// Threads a block of the face stage's two kernels.
constexpr int kFace2DThreads = 128;

// 2-D compressible Euler, state [rho, m_x, m_y, E], csrc/euler.cuh at
// DIM = 2; params = {gamma}.
template <typename T>
struct Euler2D {
  static constexpr int V = kDim2 + 2;
  static constexpr int kFluxRows = V;
  static constexpr bool kMasked = false;
  static constexpr bool kViscous = false;
  T gm1;  // gamma - 1
  T gamma;
  static Euler2D make(const double* params) {
    return {static_cast<T>(params[0] - 1.0), static_cast<T>(params[0])};
  }
  // The flux along both axes, with one 1/ρ and one pressure for the two.
  __device__ __forceinline__ void fluxes(const T* q, T (&f)[kDim2][V]) const {
    const T inv_rho = T(1) / q[0];
    const T p = euler_pressure_from<T, kDim2>(q, inv_rho, gm1);
#pragma unroll
    for (int d = 0; d < kDim2; ++d) euler_flux_from<T, kDim2, V>(q, d, inv_rho, p, f[d]);
  }
  __device__ __forceinline__ T max_eigenvalue(const T* q, int d) const {
    return euler_max_eigenvalue<T, kDim2>(q, d == 0 ? q[1] : q[2], gm1, gamma);
  }
  // The flux along axis d (a wall's ghost flux F(ghost)), d dispatched to
  // compile-time axes so that q and f stay in registers.
  __device__ __forceinline__ void flux_along(const T* q, int d, T* f) const {
    const T inv_rho = T(1) / q[0];
    const T p = euler_pressure_from<T, kDim2>(q, inv_rho, gm1);
    if (d == 0) {
      euler_flux_from<T, kDim2, V>(q, 0, inv_rho, p, f);
    } else {
      euler_flux_from<T, kDim2, V>(q, 1, inv_rho, p, f);
    }
  }
};

// 2-D compressible Navier–Stokes: Euler2D's flux and wave speed, and the
// viscous terms of csrc/navier_stokes.cuh in 2-D.  params: gamma, mu,
// max(4/3, gamma/Pr), kappa_T and the face penalty factor 2 (2N + 1) / dx_d
// of each axis, as csrc/aderdg_common.cuh's NavierStokesPhysics takes them.
template <typename T>
struct NavierStokes2D : Euler2D<T> {
  static constexpr bool kViscous = true;
  T mu;
  T c_kappa;  // max(4/3, gamma/Pr): kappa = c_kappa mu / rho
  T kappa_T;  // the heat conductivity
  T pen[kDim2];
  static NavierStokes2D make(const double* params) {
    return {Euler2D<T>::make(params), static_cast<T>(params[1]), static_cast<T>(params[2]),
            static_cast<T>(params[3]), {static_cast<T>(params[4]), static_cast<T>(params[5])}};
  }
  // The Gassner penalty 2 (2N + 1) / dx_d max(kappa_a, kappa_b) of a face
  // along d.
  __device__ __forceinline__ T penalty(const T* qa, const T* qb, int d) const {
    const T ka = c_kappa * (mu / qa[0]), kb = c_kappa * (mu / qb[0]);
    return (d == 0 ? pen[0] : pen[1]) * dmax(ka, kb);
  }
  // The flux along both axes with the viscous flux of the physical
  // gradients g[e][v] added (the mass row's is zero).
  __device__ __forceinline__ void fluxes(const T* q, const T (&g)[kDim2][4],
                                         T (&f)[kDim2][4]) const {
    Euler2D<T>::fluxes(q, f);
    T fv[kDim2][4];
    navier_stokes_viscous_fluxes_2d<T>(q, g, this->gm1, mu, kappa_T, fv);
#pragma unroll
    for (int d = 0; d < kDim2; ++d) {
#pragma unroll
      for (int v = 1; v < 4; ++v) f[d][v] = f[d][v] + fv[d][v];
    }
  }
  // The same, and the viscous part fv alone (its mass row zero).  A body
  // of its own: the three-argument form as a call of this one gives the
  // periodic predictor another register allocation (other SASS, the same
  // results).
  __device__ __forceinline__ void fluxes(const T* q, const T (&g)[kDim2][4], T (&f)[kDim2][4],
                                         T (&fv)[kDim2][4]) const {
    Euler2D<T>::fluxes(q, f);
    navier_stokes_viscous_fluxes_2d<T>(q, g, this->gm1, mu, kappa_T, fv);
#pragma unroll
    for (int d = 0; d < kDim2; ++d) {
      fv[d][0] = T(0);
#pragma unroll
      for (int v = 1; v < 4; ++v) f[d][v] = f[d][v] + fv[d][v];
    }
  }
};

// The viscous-only wall planes of a walled viscous step (the predictor
// writes them, the wall face flux reads them): the time-averaged viscous
// flux F̄v_d of each wall axis d projected to the first row's low faces
// (side 0) and the last row's high faces (side 1), in the side tensor's
// layout [side][wall axis][m][v][plane], the Dirichlet rows' and fwall's.
template <typename T>
struct ViscPlanes2D {
  int mask;              // bit d: grid axis d carries walls
  T* planes;
  long long off[kDim2];  // element offset of axis d's block within a side
  long long side;        // elements of one side
};

// Navier–Stokes on a grid with walls: NavierStokes2D and the wall planes
// of the advective/viscous wall split (SplitsWallViscosity).
template <typename T>
struct NavierStokesWalls2D : NavierStokes2D<T> {
  ViscPlanes2D<T> fv;
  static NavierStokesWalls2D make(const double* params) {
    return {NavierStokes2D<T>::make(params), {}};
  }
};

// Whether a physics carries the wall planes: the walled Navier–Stokes
// instances only, so that the other instances compile to the code they had.
template <typename Phys>
struct SplitsWallViscosity {
  static constexpr bool value = false;
};
template <typename T>
struct SplitsWallViscosity<NavierStokesWalls2D<T>> {
  static constexpr bool value = true;
};

// Cells a predictor block at NN nodes an axis: 16 cells of 16 nodes (256
// threads) at order 3, 32 of 9 (288 threads, 9 whole warps) at order 2.
template <int NN>
constexpr int cells_2d() {
  return NN == 3 ? 32 : kCells2D;
}

template <typename T, int NN, typename Phys = Euler2D<T>>
struct Params2D {
  T D[NN][NN];
  T K1inv[NN][NN];
  T Kvol[NN][NN];
  T W[NN];
  T PHI0[NN];
  T PHI1[NN];
  T PHI0W[NN];
  T PHI1W[NN];
  T dx[kDim2];
  Phys phys;
  int picard_iters;
  long long g[kDim2];  // cell grid
  long long ncell;
};

// ops and params as csrc/aderdg_common.cuh's make_params reads them.
template <typename T, int NN, typename Phys = Euler2D<T>>
Params2D<T, NN, Phys> make_params_2d(const double* ops, const double* dx, int picard_iters,
                                     const double* params, long long g0, long long g1) {
  Params2D<T, NN, Phys> P;
  const double* o = ops;
  T(*mats[3])[NN] = {P.D, P.K1inv, P.Kvol};
  for (int k = 0; k < 3; ++k) {
    for (int i = 0; i < NN; ++i)
      for (int j = 0; j < NN; ++j) mats[k][i][j] = static_cast<T>(o[i * NN + j]);
    o += NN * NN;
  }
  T* vecs[5] = {P.W, P.PHI0, P.PHI1, P.PHI0W, P.PHI1W};
  for (int k = 0; k < 5; ++k) {
    for (int i = 0; i < NN; ++i) vecs[k][i] = static_cast<T>(o[i]);
    o += NN;
  }
  for (int d = 0; d < kDim2; ++d) P.dx[d] = static_cast<T>(dx[d]);
  P.phys = Phys::make(params);
  P.picard_iters = picard_iters;
  P.g[0] = g0;
  P.g[1] = g1;
  P.ncell = g0 * g1;
  return P;
}

// Wall modes of the C interface (csrc/aderdg.cu's).
enum WallMode : int { kMirror = 0, kFarfield = 1, kDirichlet = 2 };

// The face stage's wall description (zero, and unread, without walls).
template <typename T, int V>
struct Walls2D {
  int mask;              // bit d: grid axis d carries walls
  int mode;              // WallMode
  T sq[kDim2][V];        // kMirror: ghost state S_q[d] q
  T sf[kDim2][V];        // kMirror: ghost flux S_f[d] f
  T far[V];              // kFarfield: the ghost state
  const T* rows;         // kDirichlet: ghost rows [side][wall axis][m][v][plane]
  T* fwall;              // low-wall fluxes [wall axis][m][v][plane]
  long long off[kDim2];  // element offset of axis d's block (wall axes)
  long long side;        // elements of one side of rows
};

// A thread's cell of the face stage: its flat index, its coordinates, and
// the grid.
struct Cell2D {
  long long cell;
  int i[kDim2];
  int g[kDim2];

  __device__ __forceinline__ Cell2D(long long c, const long long (&grid)[kDim2]) : cell(c) {
    g[0] = static_cast<int>(grid[0]);
    g[1] = static_cast<int>(grid[1]);
    i[0] = static_cast<int>(c / g[1]);
    i[1] = static_cast<int>(c - static_cast<long long>(i[0]) * g[1]);
  }
  __device__ __forceinline__ int at(int d) const { return d == 0 ? i[0] : i[1]; }
  __device__ __forceinline__ int extent(int d) const { return d == 0 ? g[0] : g[1]; }
  // The plane across axis d (the other axis) and my index in it.
  __device__ __forceinline__ long long plane(int d) const { return d == 0 ? g[1] : g[0]; }
  __device__ __forceinline__ long long plane_index(int d) const { return d == 0 ? i[1] : i[0]; }
  // The periodic neighbour one cell up (+1) or down (-1) axis d.
  __device__ __forceinline__ long long neighbour(int d, int step) const {
    const long long stride = d == 0 ? g[1] : 1;
    const int id = at(d), gd = extent(d);
    if (step > 0) return id + 1 == gd ? cell - (gd - 1) * stride : cell + stride;
    return id == 0 ? cell + (gd - 1) * stride : cell - stride;
  }
};

// ------------------------------------------------------------- predictor

// Shared memory of a predictor block, in values of T: u [V][NP], the
// double-buffered fluxes [2][kDim2][V][NP] (the epilogue's q̄ [V][NP] and
// F̄ [kDim2][V][NP] over them; a viscous physics keeps the slice's q [V][NP]
// at the first buffer's start and its fluxes after it, one buffer), and
// Kvol [NN][NN]; with the wall planes, F̄v [kDim2][V][NP] after them.
// NP = CB NN²: the block's space nodes, cell by cell.
template <int NN, int CB, int V>
struct Smem2D {
  static constexpr int kNodes = NN * NN;
  static constexpr int kNP = CB * kNodes;
  static constexpr int kFluxes = kDim2 * V * kNP;  // one buffer
  static constexpr int kF = V * kNP;
  static constexpr int kK = kF + 2 * kFluxes;
  static constexpr int kTotal = kK + NN * NN;
};

template <typename T, int NN, int V, int CB = kCells2D, bool kSplit = false>
constexpr size_t predictor_2d_smem() {
  using S = Smem2D<NN, CB, V>;
  return static_cast<size_t>(S::kTotal + (kSplit ? S::kFluxes : 0)) * sizeof(T);
}

// The predictor (Euler) and, with a viscous Phys (Navier–Stokes), the
// viscous predictor: for each slice a thread first shares its node's q and
// contracts the two lines of q through its node with its own rows of D
// (times 1/dx_d, a product) into ∂q/∂x_0 and ∂q/∂x_1, then forms F_d + F_v,d
// at its node and goes on as the Euler body does, two barriers a slice; the
// time averages take the gradients of the final q, as the plain version
// does.  The viscous code sits in `if constexpr` branches, so the Euler
// instance compiles to the code it had.  With the wall planes
// (NavierStokesWalls2D) the time averages also sum the viscous part F̄v_d,
// and a cell of a wall axis's first or last row projects it to its wall
// face (ViscPlanes2D); the other instances compile without that code.
template <typename T, int NN, int CB, typename Phys>
__global__ void __launch_bounds__(CB * NN * NN)
aderdg_predictor_volume_2d(const T* __restrict__ u, T* __restrict__ out,
                           T* __restrict__ faces, const T* __restrict__ dt_ptr, T dt_val,
                           const Params2D<T, NN, Phys> P) {
  constexpr int V = Phys::V;
  constexpr int NF = NN;  // face nodes of an axis
  constexpr bool kSplit = SplitsWallViscosity<Phys>::value;
  using S = Smem2D<NN, CB, V>;
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

  // The compute mapping: my point is node (i0, i1) of the block's cell c;
  // axis 0's node stride is NN, axis 1's is 1.
  const int pt = static_cast<int>(threadIdx.x);
  const int node = pt % NC;
  const int id[kDim2] = {node / NN, node % NN};
  const int st[kDim2] = {NN, 1};
  T Dr[kDim2][NN];  // D's row of my index along each axis
#pragma unroll
  for (int d = 0; d < kDim2; ++d) select_row<T, NN>(P.D, id[d], Dr[d]);
  const T dtv = dt_ptr != nullptr ? *dt_ptr : dt_val;
  T lam[kDim2];
#pragma unroll
  for (int d = 0; d < kDim2; ++d) lam[d] = dtv / P.dx[d];
  __syncthreads();  // u and Kvol staged

  // Viscous: the slice's q of every node, and my node's F_d + F_v,d of my q
  // `qs` from it (the gradients first, each line contracted with my row of
  // D).
  T* sQ = sF;
  auto gradients = [&](T (&g)[kDim2][V]) {
#pragma unroll
    for (int d = 0; d < kDim2; ++d) {
      const T inv_dx = T(1) / P.dx[d];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const T* x = sQ + v * NP + pt - id[d] * st[d];
        T acc = Dr[d][0] * x[0];
#pragma unroll
        for (int j = 1; j < NN; ++j) acc = acc + Dr[d][j] * x[j * st[d]];
        g[d][v] = acc * inv_dx;
      }
    }
  };
  auto visc_fluxes = [&](const T* qs, T (&f)[kDim2][V]) {
    if constexpr (Phys::kViscous) {
      T g[kDim2][V];
      gradients(g);
      P.phys.fluxes(qs, g, f);
    }
  };

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
        T f[kDim2][V];
        if constexpr (Phys::kViscous) {
          // One buffer each, after the slice's q: the barrier after the
          // contractions' reads of slice s - 1 is this slice's first.
          fl = sQ + V * NP;
#pragma unroll
          for (int v = 0; v < V; ++v) sQ[v * NP + pt] = q[s][v];
          __syncthreads();  // every node's q of slice s is in
          visc_fluxes(q[s], f);
        } else {
          P.phys.fluxes(q[s], f);
        }
#pragma unroll
        for (int d = 0; d < kDim2; ++d) {
#pragma unroll
          for (int v = 0; v < V; ++v) fl[(d * V + v) * NP + pt] = f[d][v];
        }
      }
      __syncthreads();  // every node's fluxes of slice s are in
      T lw[kDim2];
#pragma unroll
      for (int d = 0; d < kDim2; ++d) lw[d] = lam[d] * P.W[s];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        T dF[kDim2];
#pragma unroll
        for (int d = 0; d < kDim2; ++d) {
          const T* x = fl + (d * V + v) * NP + pt - id[d] * st[d];  // the line's first node
          T acc = Dr[d][0] * x[0];
#pragma unroll
          for (int j = 1; j < NN; ++j) acc = acc + Dr[d][j] * x[j * st[d]];
          dF[d] = acc;
        }
        T r = P.PHI0[s] * sU[v * NP + pt];
        r = r - lw[0] * dF[0];
        q[s][v] = r - lw[1] * dF[1];  // slice s's fluxes are taken: its rhs goes here
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

  // Time averages of the final q and of its fluxes at my node (with the
  // wall planes, of the viscous part of the fluxes too).
  T qb[V], fb[kDim2][V], fvb[kDim2][V];
#pragma unroll
  for (int s = 0; s < NN; ++s) {
    const T w = P.W[s];
    T f[kDim2][V];
    if constexpr (Phys::kViscous) {
      __syncthreads();  // every node is done with the buffer's last q
#pragma unroll
      for (int v = 0; v < V; ++v) sQ[v * NP + pt] = q[s][v];
      __syncthreads();  // slice s's q is in
      if constexpr (kSplit) {
        T g[kDim2][V], fv[kDim2][V];
        gradients(g);
        P.phys.fluxes(q[s], g, f, fv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
#pragma unroll
          for (int d = 0; d < kDim2; ++d)
            fvb[d][v] = s == 0 ? w * fv[d][v] : fvb[d][v] + w * fv[d][v];
        }
      } else {
        visc_fluxes(q[s], f);
      }
    } else {
      P.phys.fluxes(q[s], f);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      qb[v] = s == 0 ? w * q[s][v] : qb[v] + w * q[s][v];
#pragma unroll
      for (int d = 0; d < kDim2; ++d) fb[d][v] = s == 0 ? w * f[d][v] : fb[d][v] + w * f[d][v];
    }
  }
  T* sQb = sF;           // q̄ [v][point]
  T* sFb = sF + V * NP;  // F̄ [d][v][point]
  T* sFvb = sU + S::kTotal;  // F̄v [d][v][point] (kSplit)
  __syncthreads();       // the last slice's contractions are done with the buffers
#pragma unroll
  for (int v = 0; v < V; ++v) {
    sQb[v * NP + pt] = qb[v];
#pragma unroll
    for (int d = 0; d < kDim2; ++d) sFb[(d * V + v) * NP + pt] = fb[d][v];
    if constexpr (kSplit) {
#pragma unroll
      for (int d = 0; d < kDim2; ++d) sFvb[(d * V + v) * NP + pt] = fvb[d][v];
    }
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
    const int in[kDim2] = {n / NN, n % NN};
    T nv = sU[v * NP + at];
#pragma unroll
    for (int d = 0; d < kDim2; ++d) {
      const T* x = sFb + (d * V + v) * NP + at - in[d] * st[d];
      const T* kr = sK + in[d] * NN;
      T kv = kr[0] * x[0];
#pragma unroll
      for (int j = 1; j < NN; ++j) kv = kv + kr[j] * x[j * st[d]];
      nv = nv + lam[d] * kv;
    }
    if (cell0 + c < ncell) out[static_cast<long long>(r) * ncell + cell0 + c] = nv;
  }

  // The face projections of element e = ((d NF + m) V + v) CB + c: the line
  // of nodes along d through face node m (the other axis's index), projected
  // with φ(0) and φ(1).  faces[d][which][m][v][cell], which = q_lo, q_hi,
  // f_lo, f_hi.
  const long long stride_w = static_cast<long long>(NF * V) * ncell;
  for (int e = static_cast<int>(threadIdx.x); e < kDim2 * NF * V * CB; e += NP) {
    const int c = e % CB, r = e / CB;
    if (cell0 + c >= ncell) continue;
    const int v = r % V, dm = r / V;
    const int d = dm / NF, m = dm - d * NF;
    const int base = d == 0 ? m : m * NN;
    const int sd = d == 0 ? NN : 1;
    const T* xq = sQb + v * NP + c * NC + base;
    const T* xf = sFb + (d * V + v) * NP + c * NC + base;
    T qlo = P.PHI0[0] * xq[0], qhi = P.PHI1[0] * xq[0];
    T flo = P.PHI0[0] * xf[0], fhi = P.PHI1[0] * xf[0];
#pragma unroll
    for (int j = 1; j < NN; ++j) {
      const T qj = xq[j * sd], fj = xf[j * sd];
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

  if constexpr (kSplit) {
    // The viscous-only wall planes, element e as above: on a wall axis d a
    // cell of the first row projects F̄v_d with φ(0) to its low face (side
    // 0), a cell of the last row with φ(1) to its high face (side 1), into
    // [m][v][plane] of the axis's block (plane: the other axis's index).
    const ViscPlanes2D<T>& W = P.phys.fv;
    for (int e = static_cast<int>(threadIdx.x); e < kDim2 * NF * V * CB; e += NP) {
      const int c = e % CB, r = e / CB;
      const long long cell = cell0 + c;
      if (cell >= ncell) continue;
      const int v = r % V, dm = r / V;
      const int d = dm / NF, m = dm - d * NF;
      if (!((W.mask >> d) & 1)) continue;
      const long long i0 = cell / P.g[1], i1 = cell - i0 * P.g[1];
      const long long at = d == 0 ? i0 : i1;
      const bool lo = at == 0, hi = at == (d == 0 ? P.g[0] : P.g[1]) - 1;
      if (!lo && !hi) continue;
      const long long plane = d == 0 ? P.g[1] : P.g[0];
      const int base = d == 0 ? m : m * NN;
      const int sd = d == 0 ? NN : 1;
      const T* x = sFvb + (d * V + v) * NP + c * NC + base;
      T flo = P.PHI0[0] * x[0], fhi = P.PHI1[0] * x[0];
#pragma unroll
      for (int j = 1; j < NN; ++j) {
        flo = flo + P.PHI0[j] * x[j * sd];
        fhi = fhi + P.PHI1[j] * x[j * sd];
      }
      T* o = W.planes + (d == 0 ? W.off[0] : W.off[1]) +
             (static_cast<long long>(m) * V + v) * plane + (d == 0 ? i1 : i0);
      if (lo) o[0] = flo;
      if (hi) o[W.side] = fhi;
    }
  }
}

// ------------------------------------------------------------ face stage

// The ghost of wall (axis d, side) at face node m, plane index p, from my
// own face state q and flux f: its state gq (all V rows) and flux gf (the
// kFluxRows rows).  With the wall planes (NavierStokesWalls2D) the flux is
// split: the ghost flux of the advective part f - fv (the mirror's sign
// table, or F(ghost)) plus the interior one-sided viscous part fv, my
// cell's own projection of F̄v_d to the wall.
template <typename T, typename Phys>
__device__ __forceinline__ void wall_ghost_2d(const Walls2D<T, Phys::V>& W, const Phys& phys,
                                              int d, int side, int m, long long plane,
                                              long long p, const T* q, const T* f, T* gq,
                                              T* gf) {
  constexpr int V = Phys::V;
  constexpr int R = Phys::kFluxRows;
  constexpr bool kSplit = SplitsWallViscosity<Phys>::value;
  const T* fv = nullptr;  // kSplit: my cell's viscous wall plane, [v * plane]
  T fa[R];                // kSplit: the advective part f - fv
  if constexpr (kSplit) {
    fv = phys.fv.planes + side * phys.fv.side + (d == 0 ? phys.fv.off[0] : phys.fv.off[1]) +
         static_cast<long long>(m) * V * plane + p;
#pragma unroll
    for (int v = 0; v < R; ++v) fa[v] = f[v] - fv[v * plane];
    f = fa;
  }
  auto add_viscous = [&] {
    if constexpr (kSplit) {
#pragma unroll
      for (int v = 0; v < R; ++v) gf[v] = gf[v] + fv[v * plane];
    }
  };
  if (W.mode == kMirror) {
    if constexpr (R == V) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        gq[v] = (d == 0 ? W.sq[0][v] : W.sq[1][v]) * q[v];
        gf[v] = (d == 0 ? W.sf[0][v] : W.sf[1][v]) * f[v];
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) gq[v] = (d == 0 ? W.sq[0][v] : W.sq[1][v]) * q[v];
#pragma unroll
      for (int v = 0; v < R; ++v) gf[v] = (d == 0 ? W.sf[0][v] : W.sf[1][v]) * f[v];
    }
    add_viscous();
    return;
  }
  if (W.mode == kFarfield) {
#pragma unroll
    for (int v = 0; v < V; ++v) gq[v] = W.far[v];
  } else {
    const T* row = W.rows + side * W.side + (d == 0 ? W.off[0] : W.off[1]) +
                   static_cast<long long>(m) * V * plane + p;
#pragma unroll
    for (int v = 0; v < V; ++v) gq[v] = row[v * plane];
  }
  phys.flux_along(gq, d, gf);
  add_viscous();
}

// The face stage, first launch: one thread per (cell, axis d, face node m)
// solves the interface between the cell's high face and its +d
// neighbour's low face, F̂ = ½(f_hi + f_lo⁺) − ½ s m_v (q_lo⁺ − q_hi), s the
// larger wave speed, m_v the physics' dissipation weight of row v (kMasked),
// into fhat[d][m][v][cell], rows 0..kFluxRows-1 (the frozen rows after them
// are neither read as fluxes nor written: their F̂ is zero).  kWalls: on a wall axis the
// last row's right state is the ghost of its own high face, and the first
// row also solves its low wall, ½(g_f + f_lo) − ½ s_w (q_lo − g_q), into
// W.fwall.  A viscous Phys (Navier–Stokes) adds the Gassner penalty to s
// and to s_w; with walls (NavierStokesWalls2D) the ghost flux hook acts on
// the advective part only (wall_ghost_2d).
template <typename T, int NN, bool kWalls, typename Phys>
__global__ void __launch_bounds__(kFace2DThreads)
aderdg_face_flux_2d(const T* __restrict__ faces, T* __restrict__ fhat,
                    const Params2D<T, NN, Phys> P, const Walls2D<T, Phys::V> W) {
  constexpr int NF = NN;
  constexpr int V = Phys::V;
  constexpr int R = Phys::kFluxRows;
  static_assert(Phys::kMasked || R == V, "frozen rows go with a dissipation mask");
  const long long ncell = P.ncell;
  const long long c = static_cast<long long>(blockIdx.x) * kFace2DThreads + threadIdx.x;
  if (c >= ncell) return;
  const Cell2D tc(c, P.g);
  const int d = blockIdx.y / NF;
  const int m = blockIdx.y - d * NF;
  const bool wall = kWalls && ((W.mask >> d) & 1);
  // faces[d][which][m][v][cell], which = q_lo, q_hi, f_lo, f_hi.
  const T* base = faces + static_cast<long long>(d * 4 * NF + m) * V * ncell;
  const long long wstride = static_cast<long long>(NF * V) * ncell;
  T qa[V], qb[V], fa[R], fb[R];  // a: my high face, b: the neighbour's low face or my ghost
  if constexpr (R == V) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      qa[v] = base[wstride + v * ncell + c];
      fa[v] = base[3 * wstride + v * ncell + c];
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) qa[v] = base[wstride + v * ncell + c];
#pragma unroll
    for (int v = 0; v < R; ++v) fa[v] = base[3 * wstride + v * ncell + c];
  }
  if (wall && tc.at(d) == tc.extent(d) - 1) {  // the high wall
    wall_ghost_2d<T, Phys>(W, P.phys, d, 1, m, tc.plane(d), tc.plane_index(d), qa, fa, qb, fb);
  } else {
    const long long plus = tc.neighbour(d, 1);
    if constexpr (R == V) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        qb[v] = base[v * ncell + plus];
        fb[v] = base[2 * wstride + v * ncell + plus];
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) qb[v] = base[v * ncell + plus];
#pragma unroll
      for (int v = 0; v < R; ++v) fb[v] = base[2 * wstride + v * ncell + plus];
    }
  }
  if (wall && tc.at(d) == 0) {  // the low wall
    const long long plane = tc.plane(d);
    const long long p = tc.plane_index(d);
    T ql[V], fl[R], gq[V], gf[R];
    if constexpr (R == V) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        ql[v] = base[v * ncell + c];
        fl[v] = base[2 * wstride + v * ncell + c];
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) ql[v] = base[v * ncell + c];
#pragma unroll
      for (int v = 0; v < R; ++v) fl[v] = base[2 * wstride + v * ncell + c];
    }
    wall_ghost_2d<T, Phys>(W, P.phys, d, 0, m, plane, p, ql, fl, gq, gf);
    T sw = dmax(P.phys.max_eigenvalue(ql, d), P.phys.max_eigenvalue(gq, d));
    if constexpr (Phys::kViscous) sw = sw + P.phys.penalty(ql, gq, d);
    T* w = W.fwall + (d == 0 ? W.off[0] : W.off[1]) + static_cast<long long>(m) * V * plane + p;
    if constexpr (Phys::kMasked) {
#pragma unroll
      for (int v = 0; v < R; ++v)
        w[v * plane] = T(0.5) * (gf[v] + fl[v]) - T(0.5) * sw * ((ql[v] - gq[v]) * Phys::dissipation(v));
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) w[v * plane] = T(0.5) * (gf[v] + fl[v]) - T(0.5) * sw * (ql[v] - gq[v]);
    }
  }
  T s = dmax(P.phys.max_eigenvalue(qa, d), P.phys.max_eigenvalue(qb, d));
  if constexpr (Phys::kViscous) s = s + P.phys.penalty(qa, qb, d);
  T* out = fhat + static_cast<long long>(d * NF + m) * V * ncell + c;
  if constexpr (Phys::kMasked) {  // the jump weighted by each row's dissipation
#pragma unroll
    for (int v = 0; v < R; ++v)
      out[v * ncell] = T(0.5) * (fa[v] + fb[v]) - T(0.5) * s * ((qb[v] - qa[v]) * Phys::dissipation(v));
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v * ncell] = T(0.5) * (fa[v] + fb[v]) - T(0.5) * s * (qb[v] - qa[v]);
  }
}

// The face stage, second launch: one thread per (cell, space node) updates
// the node's rows of `state` in place with −λ_d (ℓ_i(1)/w_i F̂_hi −
// ℓ_i(0)/w_i F̂_lo) of each axis, F̂_hi the cell's own entry of fhat and
// F̂_lo its −d neighbour's, or (kWalls, the first row of a wall axis) the
// low-wall flux of W.fwall.  It reads no physics: Phys gives the variable
// count and the rows that move, kFluxRows (Euler2D for Euler and
// Navier–Stokes, Elastic2D, ElasticHet2D, CurvilinearElastic).
template <typename T, int NN, bool kWalls, typename Phys = Euler2D<T>>
__global__ void __launch_bounds__(kFace2DThreads)
aderdg_surface_update_2d(T* __restrict__ state, const T* __restrict__ fhat,
                         const T* __restrict__ dt_ptr, T dt_val, const Params2D<T, NN> P,
                         const Walls2D<T, Phys::V> W) {
  constexpr int NF = NN;
  constexpr int V = Phys::V;
  constexpr int R = Phys::kFluxRows;
  const long long ncell = P.ncell;
  const long long c = static_cast<long long>(blockIdx.x) * kFace2DThreads + threadIdx.x;
  if (c >= ncell) return;
  const Cell2D tc(c, P.g);
  const int node = blockIdx.y;
  const T dtv = dt_ptr != nullptr ? *dt_ptr : dt_val;
  const int ix[kDim2] = {node / NN, node % NN};
  const int mf[kDim2] = {ix[1], ix[0]};  // my face node on each axis's faces
  T lam[kDim2], p1w[kDim2], p0w[kDim2];
  long long hi[kDim2];  // offset of F̂_hi of row 0
  const T* lo[kDim2];   // F̂_lo of row 0, and the stride between rows
  long long lo_step[kDim2];
#pragma unroll
  for (int d = 0; d < kDim2; ++d) {
    lam[d] = dtv / P.dx[d];
    p1w[d] = select<T, NN>(P.PHI1W, ix[d]);
    p0w[d] = select<T, NN>(P.PHI0W, ix[d]);
    const long long row0 = static_cast<long long>(d * NF + mf[d]) * V * ncell;
    hi[d] = row0 + c;
    if (kWalls && ((W.mask >> d) & 1) && tc.at(d) == 0) {
      const long long plane = tc.plane(d);
      lo[d] = W.fwall + W.off[d] + static_cast<long long>(mf[d]) * V * plane + tc.plane_index(d);
      lo_step[d] = plane;
    } else {
      lo[d] = fhat + row0 + tc.neighbour(d, -1);
      lo_step[d] = ncell;
    }
  }
#pragma unroll
  for (int v = 0; v < R; ++v) {
    const long long o = static_cast<long long>(node * V + v) * ncell + c;
    T x = state[o];
#pragma unroll
    for (int d = 0; d < kDim2; ++d) {
      x = x - lam[d] * (p1w[d] * fhat[hi[d] + v * ncell] - p0w[d] * lo[d][v * lo_step[d]]);
    }
    state[o] = x;
  }
}

// ------------------------------------------------------------ host side

// The wall description from the C interface's arguments (all zero for
// mask == 0; no ghost tables without `table`: the update reads only the
// mask, fwall and the offsets).  table: S_q [2][V], S_f [2][V], the
// farfield state [V], float64.
template <typename T, int V>
Walls2D<T, V> make_walls_2d(int mask, int mode, const double* table, const T* rows, T* fwall,
                            const long long* off, long long side) {
  Walls2D<T, V> W{};
  if (mask == 0) return W;
  W.mask = mask;
  W.mode = mode;
  W.rows = rows;
  W.fwall = fwall;
  W.side = side;
  for (int d = 0; d < kDim2; ++d) W.off[d] = off[d];
  if (table == nullptr) return W;
  for (int d = 0; d < kDim2; ++d) {
    for (int v = 0; v < V; ++v) {
      W.sq[d][v] = static_cast<T>(table[d * V + v]);
      W.sf[d][v] = static_cast<T>(table[(kDim2 + d) * V + v]);
    }
  }
  for (int v = 0; v < V; ++v) W.far[v] = static_cast<T>(table[2 * kDim2 * V + v]);
  return W;
}

// A launch this file's instances can take: Euler, Navier–Stokes or the
// elasticity (homogeneous, heterogeneous, curvilinear), order NN - 1 (3;
// the order-2 instances take Navier–Stokes only, their launchers' check),
// a 2-D grid (g2 is 1) whose cells and coordinates fit a 32-bit int.
template <int NN = kNN2>
bool bad_2d(int physics, int order, long long g0, long long g1, long long g2) {
  constexpr long long kMax = 0x7fffffffLL;
  return (physics != kEuler && physics != kNavierStokes && physics != kElastic2D &&
          physics != kElasticHet2D && physics != kCurvilinearElastic) ||
         order != NN - 1 || g0 <= 0 || g1 <= 0 || g2 != 1 || g0 * g1 > kMax;
}

// The wall arguments: a mask of the 2 axes with the side tensor and its
// offsets, and for the face flux a known mode, the tables and, in
// Dirichlet mode, the rows.
bool bad_walls_2d(int mask, const void* fwall, const long long* off) {
  return mask <= 0 || mask > 3 || fwall == nullptr || off == nullptr;
}

template <typename T, typename Phys = Euler2D<T>, int NN = kNN2>
Shape predictor_2d_shape() {
  constexpr int CB = cells_2d<NN>();
  return {reinterpret_cast<const void*>(aderdg_predictor_volume_2d<T, NN, CB, Phys>),
          dim3(CB * NN * NN),
          predictor_2d_smem<T, NN, Phys::V, CB, SplitsWallViscosity<Phys>::value>()};
}

template <typename T, bool kWalls, typename Phys = Euler2D<T>, int NN = kNN2>
Shape face_flux_2d_shape() {
  return {reinterpret_cast<const void*>(aderdg_face_flux_2d<T, NN, kWalls, Phys>),
          dim3(kFace2DThreads), 0};
}

template <typename T, bool kWalls, typename Phys = Euler2D<T>, int NN = kNN2>
Shape surface_update_2d_shape() {
  return {reinterpret_cast<const void*>(aderdg_surface_update_2d<T, NN, kWalls, Phys>),
          dim3(kFace2DThreads), 0};
}

// K2 b's 2-D instances: the CK predictor of csrc/aderdg_ck_nodes.cuh over
// Elastic2D and (K2 b.1) ElasticHet2D and CurvilinearElastic, a thread a
// space node, kCells2D cells a block.
template <typename T, typename Phys = Elastic2D<T>>
using CkParams2D = Params2D<T, kNN2, Phys>;

template <typename T, typename Phys = Elastic2D<T>>
Shape ck_predictor_2d_shape() {
  return ck_nodes_shape<T, kDim2, kNN2, kCells2D, Phys, CkParams2D<T, Phys>>();
}

template <typename T, typename Phys>
int ck_predictor_volume_2d_of(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                              const double* ops, const double* dx, const double* params,
                              long long g0, long long g1, void* stream) {
  const auto P = make_params_2d<T, kNN2, Phys>(ops, dx, 0, params, g0, g1);
  return launch_ck_nodes<T, kDim2, kNN2, kCells2D, Phys, CkParams2D<T, Phys>>(
      u, out, faces, dt_ptr, dt_val, P, stream);
}

template <typename T>
int ck_predictor_volume_2d(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                           const double* ops, const double* dx, int order, int physics,
                           const double* params, long long g0, long long g1, long long g2,
                           void* stream) {
  if (bad_2d(physics, order, g0, g1, g2)) return cudaErrorInvalidValue;
  if (physics == kElastic2D)
    return ck_predictor_volume_2d_of<T, Elastic2D<T>>(u, out, faces, dt_ptr, dt_val, ops, dx,
                                                      params, g0, g1, stream);
  if (physics == kElasticHet2D)
    return ck_predictor_volume_2d_of<T, ElasticHet2D<T>>(u, out, faces, dt_ptr, dt_val, ops,
                                                         dx, params, g0, g1, stream);
  if (physics == kCurvilinearElastic)
    return ck_predictor_volume_2d_of<T, CurvilinearElastic<T>>(u, out, faces, dt_ptr, dt_val,
                                                               ops, dx, params, g0, g1, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int NN, typename Phys>
int launch_predictor_2d(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                        const Params2D<T, NN, Phys>& P, void* stream) {
  constexpr int CB = cells_2d<NN>();
  const Shape sh = predictor_2d_shape<T, Phys, NN>();
  const cudaError_t attr = allow_smem(aderdg_predictor_volume_2d<T, NN, CB, Phys>, sh.smem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (P.ncell + CB - 1) / CB;
  aderdg_predictor_volume_2d<T, NN, CB, Phys>
      <<<static_cast<unsigned>(blocks), sh.block, sh.smem, static_cast<cudaStream_t>(stream)>>>(
          u, out, faces, dt_ptr, static_cast<T>(dt_val), P);
  return cudaGetLastError();
}

// The Euler predictor (physics 0, order 3).
template <typename T>
int predictor_volume_2d(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                        const double* ops, const double* dx, int order, int picard_iters,
                        int physics, const double* params, long long g0, long long g1,
                        long long g2, void* stream) {
  if (bad_2d(physics, order, g0, g1, g2) || physics != kEuler || picard_iters < 0)
    return cudaErrorInvalidValue;
  const auto P = make_params_2d<T, kNN2, Euler2D<T>>(ops, dx, picard_iters, params, g0, g1);
  return launch_predictor_2d<T, kNN2, Euler2D<T>>(u, out, faces, dt_ptr, dt_val, P, stream);
}

// The viscous predictor (physics 2) at NN nodes an axis (order NN - 1); with
// walls (wall_mask, bit d: axis d) it also writes the viscous-only wall
// planes into `planes`, in the side tensor's layout (wall_off, wall_side).
template <typename T, int NN>
int predictor_volume_visc_2d(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                             const double* ops, const double* dx, int order, int picard_iters,
                             int physics, const double* params, long long g0, long long g1,
                             long long g2, int wall_mask, T* planes, const long long* wall_off,
                             long long wall_side, void* stream) {
  if (bad_2d<NN>(physics, order, g0, g1, g2) || physics != kNavierStokes || picard_iters < 0 ||
      wall_mask < 0 || wall_mask > 3 ||
      (wall_mask != 0 && (planes == nullptr || wall_off == nullptr || wall_side <= 0)))
    return cudaErrorInvalidValue;
  if (wall_mask == 0) {
    const auto P = make_params_2d<T, NN, NavierStokes2D<T>>(ops, dx, picard_iters, params, g0,
                                                            g1);
    return launch_predictor_2d<T, NN, NavierStokes2D<T>>(u, out, faces, dt_ptr, dt_val, P,
                                                         stream);
  }
  auto P = make_params_2d<T, NN, NavierStokesWalls2D<T>>(ops, dx, picard_iters, params, g0, g1);
  P.phys.fv = {wall_mask, planes, {wall_off[0], wall_off[1]}, wall_side};
  return launch_predictor_2d<T, NN, NavierStokesWalls2D<T>>(u, out, faces, dt_ptr, dt_val, P,
                                                            stream);
}

// The wall arguments of a launch (all zero and null without walls).
struct WallArgs2D {
  int mask;
  int mode;
  const double* table;
  const void* rows;
  void* fwall;
  const long long* off;
  long long side;
  const void* visc_rows;  // Navier–Stokes: the predictor's wall planes
};

template <typename T, bool kWalls, typename Phys, int NN = kNN2>
int launch_face_flux_2d(const T* faces, T* fhat, const double* ops, const double* dx,
                        const double* params, long long g0, long long g1, const WallArgs2D& A,
                        void* stream) {
  const auto W = kWalls ? make_walls_2d<T, Phys::V>(A.mask, A.mode, A.table,
                                                    static_cast<const T*>(A.rows),
                                                    static_cast<T*>(A.fwall), A.off, A.side)
                        : Walls2D<T, Phys::V>{};
  auto P = make_params_2d<T, NN, Phys>(ops, dx, 0, params, g0, g1);
  if constexpr (SplitsWallViscosity<Phys>::value)
    P.phys.fv = {A.mask, static_cast<T*>(const_cast<void*>(A.visc_rows)), {A.off[0], A.off[1]},
                 A.side};
  const dim3 grid(static_cast<unsigned>((P.ncell + kFace2DThreads - 1) / kFace2DThreads),
                  kDim2 * NN);
  aderdg_face_flux_2d<T, NN, kWalls, Phys>
      <<<grid, dim3(kFace2DThreads), 0, static_cast<cudaStream_t>(stream)>>>(faces, fhat, P, W);
  return cudaGetLastError();
}

// Navier–Stokes, periodic or walled (with the viscous wall split: the
// predictor's wall planes in A.visc_rows, required there and refused
// elsewhere), at order 3 and (NN = 3) at order 2; at order 3 also Euler and
// the elasticity (homogeneous and heterogeneous), periodic or walled, and
// the curvilinear elasticity, periodic only.
template <typename T, bool kWalls, int NN = kNN2>
int face_flux_2d(const T* faces, T* fhat, const double* ops, const double* dx, int order,
                 int physics, const double* params, long long g0, long long g1, long long g2,
                 const WallArgs2D& A, void* stream) {
  if (bad_2d<NN>(physics, order, g0, g1, g2) ||
      (A.visc_rows != nullptr) != (kWalls && physics == kNavierStokes))
    return cudaErrorInvalidValue;
  if (physics == kNavierStokes) {
    if constexpr (kWalls)
      return launch_face_flux_2d<T, true, NavierStokesWalls2D<T>, NN>(faces, fhat, ops, dx,
                                                                      params, g0, g1, A, stream);
    else
      return launch_face_flux_2d<T, false, NavierStokes2D<T>, NN>(faces, fhat, ops, dx, params,
                                                                  g0, g1, A, stream);
  }
  if constexpr (NN != kNN2) {
    return cudaErrorInvalidValue;
  } else {
    if (physics == kEuler)
      return launch_face_flux_2d<T, kWalls, Euler2D<T>>(faces, fhat, ops, dx, params, g0, g1, A,
                                                         stream);
    if (physics == kElastic2D)
      return launch_face_flux_2d<T, kWalls, Elastic2D<T>>(faces, fhat, ops, dx, params, g0, g1,
                                                           A, stream);
    if (physics == kElasticHet2D)
      return launch_face_flux_2d<T, kWalls, ElasticHet2D<T>>(faces, fhat, ops, dx, params, g0,
                                                              g1, A, stream);
    if (kWalls) return cudaErrorInvalidValue;
    return launch_face_flux_2d<T, false, CurvilinearElastic<T>>(faces, fhat, ops, dx, params,
                                                                 g0, g1, A, stream);
  }
}

template <typename T, bool kWalls, typename Phys, int NN = kNN2>
int launch_surface_update_2d(T* state, const T* fhat, const T* dt_ptr, double dt_val,
                             const double* ops, const double* dx, const double* params,
                             long long g0, long long g1, const WallArgs2D& A, void* stream) {
  const auto W = kWalls ? make_walls_2d<T, Phys::V>(A.mask, kMirror, nullptr, nullptr,
                                                    static_cast<T*>(A.fwall), A.off, 0)
                        : Walls2D<T, Phys::V>{};
  const auto P = make_params_2d<T, NN>(ops, dx, 0, params, g0, g1);
  const dim3 grid(static_cast<unsigned>((P.ncell + kFace2DThreads - 1) / kFace2DThreads),
                  NN * NN);
  aderdg_surface_update_2d<T, NN, kWalls, Phys>
      <<<grid, dim3(kFace2DThreads), 0, static_cast<cudaStream_t>(stream)>>>(
          state, fhat, dt_ptr, static_cast<T>(dt_val), P, W);
  return cudaGetLastError();
}

// The update reads no physics: one instance for Euler and Navier–Stokes
// (at order 2 for Navier–Stokes only), one for the elasticity's 5 rows, and
// one each for the systems with frozen rows (their variable count: the
// heterogeneous elasticity, periodic or walled, and the curvilinear one,
// periodic).
template <typename T, bool kWalls, int NN = kNN2>
int surface_update_2d(T* state, const T* fhat, const T* dt_ptr, double dt_val,
                      const double* ops, const double* dx, int order, int physics,
                      const double* params, long long g0, long long g1, long long g2,
                      const WallArgs2D& A, void* stream) {
  if (bad_2d<NN>(physics, order, g0, g1, g2)) return cudaErrorInvalidValue;
  if constexpr (NN != kNN2) {
    if (physics != kNavierStokes) return cudaErrorInvalidValue;
    return launch_surface_update_2d<T, kWalls, Euler2D<T>, NN>(state, fhat, dt_ptr, dt_val, ops,
                                                               dx, params, g0, g1, A, stream);
  }
  if (physics == kElastic2D)
    return launch_surface_update_2d<T, kWalls, Elastic2D<T>>(state, fhat, dt_ptr, dt_val, ops,
                                                             dx, params, g0, g1, A, stream);
  if (physics == kElasticHet2D)
    return launch_surface_update_2d<T, kWalls, ElasticHet2D<T>>(state, fhat, dt_ptr, dt_val,
                                                                ops, dx, params, g0, g1, A,
                                                                stream);
  if (physics == kCurvilinearElastic) {
    if (kWalls) return cudaErrorInvalidValue;
    return launch_surface_update_2d<T, false, CurvilinearElastic<T>>(
        state, fhat, dt_ptr, dt_val, ops, dx, params, g0, g1, A, stream);
  }
  return launch_surface_update_2d<T, kWalls, Euler2D<T>>(state, fhat, dt_ptr, dt_val, ops, dx,
                                                         params, g0, g1, A, stream);
}

template <typename T, int NN = kNN2>
int face_flux_walls_2d(const T* faces, T* fhat, const double* ops, const double* dx, int order,
                       int physics, const double* params, long long g0, long long g1,
                       long long g2, int wall_mask, int wall_mode, const double* wall_table,
                       const T* wall_rows, T* fwall, const long long* wall_off,
                       long long wall_side, const T* visc_rows, void* stream) {
  if (bad_walls_2d(wall_mask, fwall, wall_off) || wall_table == nullptr ||
      (wall_mode != kMirror && wall_mode != kFarfield && wall_mode != kDirichlet) ||
      (wall_mode == kDirichlet && wall_rows == nullptr))
    return cudaErrorInvalidValue;
  const WallArgs2D A{wall_mask, wall_mode, wall_table, wall_rows, fwall, wall_off, wall_side,
                     visc_rows};
  return face_flux_2d<T, true, NN>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2, A,
                                   stream);
}

template <typename T, int NN = kNN2>
int surface_update_walls_2d(T* state, const T* fhat, const T* dt_ptr, double dt_val,
                            const double* ops, const double* dx, int order, int physics,
                            const double* params, long long g0, long long g1, long long g2,
                            int wall_mask, const T* fwall, const long long* wall_off,
                            void* stream) {
  if (bad_walls_2d(wall_mask, fwall, wall_off)) return cudaErrorInvalidValue;
  const WallArgs2D A{wall_mask, kMirror, nullptr, nullptr, const_cast<T*>(fwall), wall_off, 0,
                     nullptr};
  return surface_update_2d<T, true, NN>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics,
                                        params, g0, g1, g2, A, stream);
}

// The shapes of the elastic steps' kernels over `H` (which 1-4 and 6; the
// wall pair, 3 and 4, only where kWalls is instantiated).
template <typename T, typename H, bool kWalls>
int elastic_info_2d(int which, int* out) {
  switch (which) {
    case 1:
      return shape_info(face_flux_2d_shape<T, false, H>(), out);
    case 2:
      return shape_info(surface_update_2d_shape<T, false, H>(), out);
    case 3:
      if constexpr (kWalls) return shape_info(face_flux_2d_shape<T, true, H>(), out);
      return cudaErrorInvalidValue;
    case 4:
      if constexpr (kWalls) return shape_info(surface_update_2d_shape<T, true, H>(), out);
      return cudaErrorInvalidValue;
    case 6:
      return shape_info(ck_predictor_2d_shape<T, H>(), out);
    default:
      return cudaErrorInvalidValue;
  }
}

// which: 0 predictor, 1 face flux, 2 update, 3 face flux (walls), 4 update
// (walls), 5 the viscous predictor, 6 the CK predictor, 7 the viscous
// predictor with the wall planes; 8-13 the order-2 instances of 5, 1, 2, 3,
// 4 and 7.  Physics 2 (Navier–Stokes) has 1-5 and 7-13, its own face flux
// and Euler's update; physics 8 and 9 (the elasticity, homogeneous and
// heterogeneous) 1-4 and 6; physics 10 (the curvilinear elasticity) 1, 2
// and 6.
template <typename T>
int kernel_info_2d(int which, int physics, int* out) {
  if (physics == kElastic2D) return elastic_info_2d<T, Elastic2D<T>, true>(which, out);
  if (physics == kElasticHet2D) return elastic_info_2d<T, ElasticHet2D<T>, true>(which, out);
  if (physics == kCurvilinearElastic)
    return elastic_info_2d<T, CurvilinearElastic<T>, false>(which, out);
  if (physics == kNavierStokes) {
    using N = NavierStokes2D<T>;
    using NW = NavierStokesWalls2D<T>;
    using E = Euler2D<T>;
    switch (which) {
      case 1:
        return shape_info(face_flux_2d_shape<T, false, N>(), out);
      case 2:
        return shape_info(surface_update_2d_shape<T, false>(), out);
      case 3:
        return shape_info(face_flux_2d_shape<T, true, NW>(), out);
      case 4:
        return shape_info(surface_update_2d_shape<T, true>(), out);
      case 5:
        return shape_info(predictor_2d_shape<T, N>(), out);
      case 7:
        return shape_info(predictor_2d_shape<T, NW>(), out);
      case 8:
        return shape_info(predictor_2d_shape<T, N, 3>(), out);
      case 9:
        return shape_info(face_flux_2d_shape<T, false, N, 3>(), out);
      case 10:
        return shape_info(surface_update_2d_shape<T, false, E, 3>(), out);
      case 11:
        return shape_info(face_flux_2d_shape<T, true, NW, 3>(), out);
      case 12:
        return shape_info(surface_update_2d_shape<T, true, E, 3>(), out);
      case 13:
        return shape_info(predictor_2d_shape<T, NW, 3>(), out);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (physics != kEuler) return cudaErrorInvalidValue;
  switch (which) {
    case 0:
      return shape_info(predictor_2d_shape<T>(), out);
    case 1:
      return shape_info(face_flux_2d_shape<T, false>(), out);
    case 2:
      return shape_info(surface_update_2d_shape<T, false>(), out);
    case 3:
      return shape_info(face_flux_2d_shape<T, true>(), out);
    case 4:
      return shape_info(surface_update_2d_shape<T, true>(), out);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The launchers take csrc/aderdg.cu's entries' arguments and layouts, with
// the grid (g0, g1, 1), order 3: physics 0 (Euler, params = {gamma}) for
// the Euler predictor, 2 (Navier–Stokes, params as NavierStokes2D::make
// reads them) for the viscous predictor, either for the periodic pair and
// the wall pair.  faces: [2][4][4][4][cell]; fhat: [2][4][4][cell].  The
// wall pair's wall_table is S_q [2][4], S_f [2][4], the farfield state [4]
// (float64), wall_mask a mask of the 2 axes; visc_rows, for physics 2 only
// and then required, the viscous predictor's wall planes (in wall_rows'
// layout).  Each returns the launch's cudaError_t.

int exahype_aderdg_predictor_volume_2d_f32(const float* u, float* out, float* faces,
                                           const float* dt_ptr, double dt_val,
                                           const double* ops, const double* dx, int order,
                                           int picard_iters, int physics, const double* params,
                                           long long g0, long long g1, long long g2,
                                           void* stream) {
  return predictor_volume_2d<float>(u, out, faces, dt_ptr, dt_val, ops, dx, order, picard_iters,
                                    physics, params, g0, g1, g2, stream);
}

int exahype_aderdg_predictor_volume_2d_f64(const double* u, double* out, double* faces,
                                           const double* dt_ptr, double dt_val,
                                           const double* ops, const double* dx, int order,
                                           int picard_iters, int physics, const double* params,
                                           long long g0, long long g1, long long g2,
                                           void* stream) {
  return predictor_volume_2d<double>(u, out, faces, dt_ptr, dt_val, ops, dx, order,
                                     picard_iters, physics, params, g0, g1, g2, stream);
}

// The viscous predictor (physics 2): the Picard predictor's arguments, then
// the wall planes of the viscous split as csrc/aderdg_visc.cu's entry takes
// them (wall_mask, planes, wall_off, wall_side; mask 0 and null without
// walls); _p2_2d: order 2.
int exahype_aderdg_predictor_volume_visc_2d_f32(const float* u, float* out, float* faces,
                                                const float* dt_ptr, double dt_val,
                                                const double* ops, const double* dx, int order,
                                                int picard_iters, int physics,
                                                const double* params, long long g0,
                                                long long g1, long long g2, int wall_mask,
                                                float* planes, const long long* wall_off,
                                                long long wall_side, void* stream) {
  return predictor_volume_visc_2d<float, kNN2>(u, out, faces, dt_ptr, dt_val, ops, dx, order,
                                               picard_iters, physics, params, g0, g1, g2,
                                               wall_mask, planes, wall_off, wall_side, stream);
}

int exahype_aderdg_predictor_volume_visc_2d_f64(const double* u, double* out, double* faces,
                                                const double* dt_ptr, double dt_val,
                                                const double* ops, const double* dx, int order,
                                                int picard_iters, int physics,
                                                const double* params, long long g0,
                                                long long g1, long long g2, int wall_mask,
                                                double* planes, const long long* wall_off,
                                                long long wall_side, void* stream) {
  return predictor_volume_visc_2d<double, kNN2>(u, out, faces, dt_ptr, dt_val, ops, dx, order,
                                                picard_iters, physics, params, g0, g1, g2,
                                                wall_mask, planes, wall_off, wall_side, stream);
}

int exahype_aderdg_predictor_volume_visc_p2_2d_f32(const float* u, float* out, float* faces,
                                                   const float* dt_ptr, double dt_val,
                                                   const double* ops, const double* dx,
                                                   int order, int picard_iters, int physics,
                                                   const double* params, long long g0,
                                                   long long g1, long long g2, int wall_mask,
                                                   float* planes, const long long* wall_off,
                                                   long long wall_side, void* stream) {
  return predictor_volume_visc_2d<float, 3>(u, out, faces, dt_ptr, dt_val, ops, dx, order,
                                            picard_iters, physics, params, g0, g1, g2,
                                            wall_mask, planes, wall_off, wall_side, stream);
}

int exahype_aderdg_predictor_volume_visc_p2_2d_f64(const double* u, double* out, double* faces,
                                                   const double* dt_ptr, double dt_val,
                                                   const double* ops, const double* dx,
                                                   int order, int picard_iters, int physics,
                                                   const double* params, long long g0,
                                                   long long g1, long long g2, int wall_mask,
                                                   double* planes, const long long* wall_off,
                                                   long long wall_side, void* stream) {
  return predictor_volume_visc_2d<double, 3>(u, out, faces, dt_ptr, dt_val, ops, dx, order,
                                             picard_iters, physics, params, g0, g1, g2,
                                             wall_mask, planes, wall_off, wall_side, stream);
}

// K2 b's 2-D CK predictor (physics 8, the elasticity, params = {ρ, λ, μ}):
// the CK entries' arguments (csrc/aderdg.cu), the grid (g0, g1, 1), order 3;
// faces: [2][4][4][5][cell].  The face pairs above and below take physics 8
// too (the periodic and the wall pair; fhat [2][4][5][cell]).
int exahype_aderdg_ck_predictor_volume_2d_f32(const float* u, float* out, float* faces,
                                              const float* dt_ptr, double dt_val,
                                              const double* ops, const double* dx, int order,
                                              int physics, const double* params, long long g0,
                                              long long g1, long long g2, void* stream) {
  return ck_predictor_volume_2d<float>(u, out, faces, dt_ptr, dt_val, ops, dx, order, physics,
                                       params, g0, g1, g2, stream);
}

int exahype_aderdg_ck_predictor_volume_2d_f64(const double* u, double* out, double* faces,
                                              const double* dt_ptr, double dt_val,
                                              const double* ops, const double* dx, int order,
                                              int physics, const double* params, long long g0,
                                              long long g1, long long g2, void* stream) {
  return ck_predictor_volume_2d<double>(u, out, faces, dt_ptr, dt_val, ops, dx, order, physics,
                                        params, g0, g1, g2, stream);
}

int exahype_aderdg_face_flux_2d_f32(const float* faces, float* fhat, const double* ops,
                                    const double* dx, int order, int physics,
                                    const double* params, long long g0, long long g1,
                                    long long g2, void* stream) {
  return face_flux_2d<float, false>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2,
                                    WallArgs2D{}, stream);
}

int exahype_aderdg_face_flux_2d_f64(const double* faces, double* fhat, const double* ops,
                                    const double* dx, int order, int physics,
                                    const double* params, long long g0, long long g1,
                                    long long g2, void* stream) {
  return face_flux_2d<double, false>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2,
                                    WallArgs2D{}, stream);
}

int exahype_aderdg_surface_update_2d_f32(float* state, const float* fhat, const float* dt_ptr,
                                         double dt_val, const double* ops, const double* dx,
                                         int order, int physics, const double* params,
                                         long long g0, long long g1, long long g2,
                                         void* stream) {
  return surface_update_2d<float, false>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics,
                                         params, g0, g1, g2, WallArgs2D{}, stream);
}

int exahype_aderdg_surface_update_2d_f64(double* state, const double* fhat,
                                         const double* dt_ptr, double dt_val,
                                         const double* ops, const double* dx, int order,
                                         int physics, const double* params, long long g0,
                                         long long g1, long long g2, void* stream) {
  return surface_update_2d<double, false>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics,
                                          params, g0, g1, g2, WallArgs2D{}, stream);
}

int exahype_aderdg_face_flux_walls_2d_f32(const float* faces, float* fhat, const double* ops,
                                          const double* dx, int order, int physics,
                                          const double* params, long long g0, long long g1,
                                          long long g2, int wall_mask, int wall_mode,
                                          const double* wall_table, const float* wall_rows,
                                          float* fwall, const long long* wall_off,
                                          long long wall_side, const float* visc_rows,
                                          void* stream) {
  return face_flux_walls_2d<float>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2,
                                   wall_mask, wall_mode, wall_table, wall_rows, fwall, wall_off,
                                   wall_side, visc_rows, stream);
}

int exahype_aderdg_face_flux_walls_2d_f64(const double* faces, double* fhat, const double* ops,
                                          const double* dx, int order, int physics,
                                          const double* params, long long g0, long long g1,
                                          long long g2, int wall_mask, int wall_mode,
                                          const double* wall_table, const double* wall_rows,
                                          double* fwall, const long long* wall_off,
                                          long long wall_side, const double* visc_rows,
                                          void* stream) {
  return face_flux_walls_2d<double>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2,
                                    wall_mask, wall_mode, wall_table, wall_rows, fwall, wall_off,
                                    wall_side, visc_rows, stream);
}

int exahype_aderdg_surface_update_walls_2d_f32(float* state, const float* fhat,
                                               const float* dt_ptr, double dt_val,
                                               const double* ops, const double* dx, int order,
                                               int physics, const double* params, long long g0,
                                               long long g1, long long g2, int wall_mask,
                                               const float* fwall, const long long* wall_off,
                                               void* stream) {
  return surface_update_walls_2d<float>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics,
                                        params, g0, g1, g2, wall_mask, fwall, wall_off, stream);
}

int exahype_aderdg_surface_update_walls_2d_f64(double* state, const double* fhat,
                                               const double* dt_ptr, double dt_val,
                                               const double* ops, const double* dx, int order,
                                               int physics, const double* params, long long g0,
                                               long long g1, long long g2, int wall_mask,
                                               const double* fwall, const long long* wall_off,
                                               void* stream) {
  return surface_update_walls_2d<double>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics,
                                         params, g0, g1, g2, wall_mask, fwall, wall_off, stream);
}

// The order-2 Navier–Stokes face pairs (physics 2 only): the order-3
// entries' arguments and layouts at 3 nodes an axis (faces: [2][4][3][4]
// [cell]; fhat: [2][3][4][cell]).
int exahype_aderdg_face_flux_p2_2d_f32(const float* faces, float* fhat, const double* ops,
                                       const double* dx, int order, int physics,
                                       const double* params, long long g0, long long g1,
                                       long long g2, void* stream) {
  return face_flux_2d<float, false, 3>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2,
                                       WallArgs2D{}, stream);
}

int exahype_aderdg_face_flux_p2_2d_f64(const double* faces, double* fhat, const double* ops,
                                       const double* dx, int order, int physics,
                                       const double* params, long long g0, long long g1,
                                       long long g2, void* stream) {
  return face_flux_2d<double, false, 3>(faces, fhat, ops, dx, order, physics, params, g0, g1,
                                        g2, WallArgs2D{}, stream);
}

int exahype_aderdg_surface_update_p2_2d_f32(float* state, const float* fhat,
                                            const float* dt_ptr, double dt_val,
                                            const double* ops, const double* dx, int order,
                                            int physics, const double* params, long long g0,
                                            long long g1, long long g2, void* stream) {
  return surface_update_2d<float, false, 3>(state, fhat, dt_ptr, dt_val, ops, dx, order,
                                            physics, params, g0, g1, g2, WallArgs2D{}, stream);
}

int exahype_aderdg_surface_update_p2_2d_f64(double* state, const double* fhat,
                                            const double* dt_ptr, double dt_val,
                                            const double* ops, const double* dx, int order,
                                            int physics, const double* params, long long g0,
                                            long long g1, long long g2, void* stream) {
  return surface_update_2d<double, false, 3>(state, fhat, dt_ptr, dt_val, ops, dx, order,
                                             physics, params, g0, g1, g2, WallArgs2D{}, stream);
}

int exahype_aderdg_face_flux_walls_p2_2d_f32(const float* faces, float* fhat,
                                             const double* ops, const double* dx, int order,
                                             int physics, const double* params, long long g0,
                                             long long g1, long long g2, int wall_mask,
                                             int wall_mode, const double* wall_table,
                                             const float* wall_rows, float* fwall,
                                             const long long* wall_off, long long wall_side,
                                             const float* visc_rows, void* stream) {
  return face_flux_walls_2d<float, 3>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2,
                                      wall_mask, wall_mode, wall_table, wall_rows, fwall,
                                      wall_off, wall_side, visc_rows, stream);
}

int exahype_aderdg_face_flux_walls_p2_2d_f64(const double* faces, double* fhat,
                                             const double* ops, const double* dx, int order,
                                             int physics, const double* params, long long g0,
                                             long long g1, long long g2, int wall_mask,
                                             int wall_mode, const double* wall_table,
                                             const double* wall_rows, double* fwall,
                                             const long long* wall_off, long long wall_side,
                                             const double* visc_rows, void* stream) {
  return face_flux_walls_2d<double, 3>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2,
                                       wall_mask, wall_mode, wall_table, wall_rows, fwall,
                                       wall_off, wall_side, visc_rows, stream);
}

int exahype_aderdg_surface_update_walls_p2_2d_f32(float* state, const float* fhat,
                                                  const float* dt_ptr, double dt_val,
                                                  const double* ops, const double* dx,
                                                  int order, int physics, const double* params,
                                                  long long g0, long long g1, long long g2,
                                                  int wall_mask, const float* fwall,
                                                  const long long* wall_off, void* stream) {
  return surface_update_walls_2d<float, 3>(state, fhat, dt_ptr, dt_val, ops, dx, order,
                                           physics, params, g0, g1, g2, wall_mask, fwall,
                                           wall_off, stream);
}

int exahype_aderdg_surface_update_walls_p2_2d_f64(double* state, const double* fhat,
                                                  const double* dt_ptr, double dt_val,
                                                  const double* ops, const double* dx,
                                                  int order, int physics, const double* params,
                                                  long long g0, long long g1, long long g2,
                                                  int wall_mask, const double* fwall,
                                                  const long long* wall_off, void* stream) {
  return surface_update_walls_2d<double, 3>(state, fhat, dt_ptr, dt_val, ops, dx, order,
                                            physics, params, g0, g1, g2, wall_mask, fwall,
                                            wall_off, stream);
}

}  // extern "C"

// The 2-D kernels' occupancy, for exahype_aderdg_kernel_info (kernels 22-27,
// 32 and 70-76, csrc/aderdg.cu): `which` as kernel_info_2d reads it.
int aderdg_2d_kernel_info_f32(int which, int physics, int* out) {
  return kernel_info_2d<float>(which, physics, out);
}
int aderdg_2d_kernel_info_f64(int which, int physics, int* out) {
  return kernel_info_2d<double>(which, physics, out);
}
