// ADER-DG step on a 3-D grid for Hopper (sm_90a), periodic or closed by
// domain walls: four kernels and the face stage's wall variant, templated
// on the physics (3-D compressible Euler, 3-D heterogeneous elasticity, and
// for the face stage 3-D compressible Navier–Stokes, whose predictor is
// csrc/aderdg_visc.cuh's, and the homogeneous elasticity at order 2, whose
// predictor is csrc/aderdg_ck_nodes.cuh's, K2 b).  The definitions both sources share are in
// csrc/aderdg_common.cuh.  The Z4 steps (physics 3 to 6) have their own
// three kernels each, csrc/aderdg_z4.cuh; this file's occupancy query
// reports them.  At orders 4, 5 and 7 the Euler predictor is
// csrc/aderdg_st.cuh's (built by csrc/aderdg_p4.cu, aderdg_p5.cu,
// aderdg_p7.cu and their _f64 twins), and this file instantiates the face
// stage, periodic and walled, at n = 5, 6 and 8 for it (the _p4, _p5 and
// _p7 entries).
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
//   aderdg_face_flux_walls, aderdg_surface_update_walls
//                            the face stage on a grid with domain walls.
//   aderdg_face_flux_exchanged
//                            K1 e: the face flux of a rank's window of a
//                            grid split over ranks (parallel/shard.py), each
//                            side of each axis periodic, a wall, or a face
//                            row received from the neighbour rank; the
//                            update is aderdg_surface_update_walls.
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
// written, 3 KB each, and 9.2 KB of faces written, all of which the
// contract defines), ~7 flops per byte, under the f32 ridge; so is the
// face stage's 12-variable variant, with fewer bytes and flops.  What it
// needs is enough bytes in flight and no idle phase: K2 takes the Picard
// predictor's thread shape.  A thread holds one pencil of a cell along the
// last node axis: 4 nodes x 9 evolved rows of q_k in registers and of q̄ in
// its own words of shared memory, and each node's 1/ρ, λ and μ, frozen for
// the step (the reference's injection of u's materials at every level is
// the use of those registers; q_k's material rows are zero and q̄'s are
// u's, so only the 9 evolved rows are held).  A warp holds the 16 pencils of 2 cells: the axis-2 contraction
// with D is thread-local, axes 0 and 1 are 3 xor shuffles an output, so
// the 3 levels use no shared memory and no barrier.  The flux is linear
// in q but its coefficients vary from node to node, so the contraction is
// taken on the fluxes, as the reference does.  Each level forms
// r = −Σ_d λ_d (D F_d), q_k = r / k, q̄ += q_k / (k + 1): the Pallas
// branch's order (λ_d = dt/dx_d inside, /k after); the plain version
// follows XLA's (dt/k)·L, the same up to rounding.  The epilogue goes axis
// by axis: F̄_d = F_d(q̄) and its volume term by the same shuffles, into
// new's registers; then the face projections of axis d run in the I/O
// mapping, every thread one face node of CB cells, from q̄ and F̄_d staged
// in shared memory, and go straight to device memory as 32-byte runs (a
// transpose of the projections by shuffles cost more instructions than the
// staging; PERF.md).  Shared memory stages u (it becomes q̄, then new, in
// place) and one axis's F̄_d, each in a layout that the compute mapping, the
// I/O mapping and the projections along every axis read free of bank
// conflicts in f32: 42 KB a block of CB x 16 threads, 5 blocks an SM by
// shared memory, 3 by the register cap.  The material rows of new are u's
// bits, their face fluxes exact zeros, and the face stage does not touch them (mask 0), so slots
// 9-11 leave the step bitwise unchanged.
//
// K2 a, the CK predictor's source instance (aderdg_ck_predictor_volume
// with Source = SpongeSource, entry _sponge): the absorbing sponge of
// examples/seismic3d_layered.py, S(q) = −σ_c q on the 9 evolved rows, zero
// on the materials, σ_c a cell's rate (a [ncell] input in the state's
// dtype, read once a cell; the TPU kernel captures σ as a constant of the
// grid's shape, which its interpret mode refuses and its tiling cannot
// cut, so JAX runs that example on XLA).  It replaces the source branch of
// PallasADERDG.build's CK body (exahype_tpu/models/aderdg_pallas.py:416-425):
// each level adds dt·(−σ_c q_{k−1}) to the x and y flux terms before the
// z term and the division by k (r = ((−λ_0 D F_0 − λ_1 D F_1) + dt·S) −
// λ_2 D F_2, q_k = r/k), and new starts from u + dt·S(q̄).  The reference
// (the plain version, XLA) takes q_k = (dt/k)·(Σ_d −D F_d/dx_d + S): the
// same function up to the rounding of a reordered sum, ~1e-16 of the
// terms in float64.  The extra work is 9 multiply-adds a node and level and
// one load a cell, so it stays memory-bound like K2; the sourceless
// instance is compiled from the same body with the source branches
// compiled out (if constexpr), so its machine code is K2's.
//
// K2 b, the homogeneous 3-D elasticity (Elastic3D of csrc/elastic.cuh: 9
// variables, ρ, λ, μ kernel parameters) at order 2, periodic, three launches
// a step: the CK predictor of csrc/aderdg_ck_nodes.cuh (a thread a space
// node, 8 cells a block; K2's pencil mapping needs NN = 4) through the entry
// aderdg_ck_predictor_volume_p2, and the face stage's NN = 3 instances
// (aderdg_face_flux_p2, aderdg_surface_update_p2: the Rusanov flux with no
// mask on all 9 rows), tiled by 3 face nodes and 9 space nodes a block
// (FaceTiling), where NN = 4 and 6 keep 4 and 8.  K2 b.1: the same three
// entries take the 12-variable heterogeneous elasticity (physics 1,
// ElasticHetPhysics of csrc/elastic.cuh, tests/test_ck.py:317's system):
// the node kernel holds the materials at u's values through the recursion
// and forms the 9 evolved rows' fluxes only, the face stage's n = 3
// instances solve the 9 rows with the mask, so slots 9-11 leave the step
// bitwise unchanged.
//
// Walls (the face stage's wall variant: two kernels of their own beside the
// periodic pair, which is unchanged).  On a wall axis the TPU
// path turns its in-kernel solves off, emits every axis's face projections
// (the all-epilogue layout, which the predictors here always write) and
// runs the base solver's face_update on them
// (exahype_tpu/models/aderdg.py:823-950).  The ghost of a wall is my own
// face times a sign table (mirror; outflow is the all-ones table), the
// constant farfield state, or the Dirichlet row, with the flux F(ghost) for
// the last two; every hook of the catalog is one of these
// (models/aderdg_cuda.py reads the tables off the hooks).  A thread of
// aderdg_face_flux_walls on the last row of a wall axis builds the ghost from its
// own high face instead of reading the wrapped neighbour, so F̂ there is the
// high-wall flux; a thread on the first row also solves its low wall
// (ghost on the left, its own low face on the right, the jump masked as in
// the interior) into a side tensor fwall, [wall axis][m][v][plane], the
// grid's plane across the axis (my cell with i_d dropped, row-major), whose
// blocks sit at off[d].  aderdg_surface_update_walls reads fwall instead of the
// wrapped neighbour's F̂ where i_d == 0 on a wall axis.  Each interface is
// still solved once, with no atomics; the side tensor is ~1 % of F̂ at
// (256, 8, 128), so the walled stage has the periodic one's bound to within
// that.  The Dirichlet rows come in the same layout as fwall, one block set
// per side.
//
// Navier–Stokes (the face stage's viscous instance, NavierStokesPhysics:
// Euler's flux and wave speed; if constexpr on Phys::kViscous, so the Euler
// and elastic instances compile to the code they had).  The dissipation
// speed of every solve gains the Gassner penalty 2(2N+1)/dx_d max(κ_a,
// κ_b), κ = max(4/3, γ/Pr) μ/ρ (exahype_tpu/models/aderdg.py:865-876,
// 900-908).  On a wall the ghost flux hook takes the advective part only:
// S_f (f − fv) + fv with the sign table, F(ghost) + fv with the farfield
// state or a Dirichlet row, fv the interior one-sided viscous flux of my own
// face (:833-844, 920-929).  The predictor writes fv on the wall planes only
// (the first row's low faces, side 0; the last row's high faces, side 1), in
// the Dirichlet rows' layout, so a thread reads it at the offset it reads a
// Dirichlet row at.  Its update is the Euler instance's: the update reads no
// physics.

#include <cuda_runtime.h>

#include "aderdg_ck_nodes.cuh"
#include "aderdg_common.cuh"
#include "elastic.cuh"

// The viscous predictor's occupancy (csrc/aderdg_visc.cu and
// aderdg_visc_f64.cu; weak, so that this file also builds and loads alone):
// out as shape_info gives it, without (wall_planes = 0) or with the wall
// planes.
int visc_predictor_info_f32(int wall_planes, int* out) __attribute__((weak));
int visc_predictor_info_f64(int wall_planes, int* out) __attribute__((weak));
// The Z4 kernels' occupancy (csrc/aderdg_z4.cu and aderdg_z4_f64.cu; weak
// too): `which` 0 predictor, 1 face flux, 2 update.
int z4_kernel_info_f32(int which, int* out) __attribute__((weak));
int z4_kernel_info_f64(int which, int* out) __attribute__((weak));
// The shifted Z4 kernels' occupancy (csrc/aderdg_z4_shift.cu and
// aderdg_z4_shift_f64.cu; weak too), the same `which`.
int z4_shift_kernel_info_f32(int which, int* out) __attribute__((weak));
int z4_shift_kernel_info_f64(int which, int* out) __attribute__((weak));
// The Z4+GRHD kernels' occupancy (csrc/aderdg_z4_matter.cu and
// aderdg_z4_matter_f64.cu; weak too), the same `which`.
int z4_matter_kernel_info_f32(int which, int* out) __attribute__((weak));
int z4_matter_kernel_info_f64(int which, int* out) __attribute__((weak));
// The Z4+GRMHD kernels' occupancy (csrc/aderdg_z4_grmhd.cu and
// aderdg_z4_grmhd_f64.cu; weak too), the same `which`.
int z4_grmhd_kernel_info_f32(int which, int* out) __attribute__((weak));
int z4_grmhd_kernel_info_f64(int which, int* out) __attribute__((weak));
// The vacuum Z4 system's per-axis predictor on the 3-D cell
// (csrc/aderdg_z4_per_axis.cu and _f64.cu; weak too), and its 2-D kernels at
// orders 2 and 3 (csrc/aderdg_z4_2d.cu, aderdg_z4_2d_p3.cu and their _f64
// twins): `which` 0 the fused predictor, 1 face flux, 2 update, 3 the
// per-axis predictor.
int z4_per_axis_info_f32(int* out) __attribute__((weak));
int z4_per_axis_info_f64(int* out) __attribute__((weak));
int z4_2d_info_f32(int which, int* out) __attribute__((weak));
int z4_2d_info_f64(int which, int* out) __attribute__((weak));
int z4_2d_p3_info_f32(int which, int* out) __attribute__((weak));
int z4_2d_p3_info_f64(int which, int* out) __attribute__((weak));
// The Z4+GRHD system's per-axis predictor on the 3-D cell
// (csrc/aderdg_z4_matter_per_axis.cu and _f64.cu; weak too) and its 2-D
// kernels at order 2 (csrc/aderdg_z4_matter_2d.cu and _f64.cu), the same
// `which`.
int z4_matter_per_axis_info_f32(int* out) __attribute__((weak));
int z4_matter_per_axis_info_f64(int* out) __attribute__((weak));
int z4_matter_2d_info_f32(int which, int* out) __attribute__((weak));
int z4_matter_2d_info_f64(int which, int* out) __attribute__((weak));
// The Z4+GRMHD system's, the same (csrc/aderdg_z4_grmhd_per_axis.cu,
// aderdg_z4_grmhd_2d.cu and their _f64 twins; weak too).
int z4_grmhd_per_axis_info_f32(int* out) __attribute__((weak));
int z4_grmhd_per_axis_info_f64(int* out) __attribute__((weak));
int z4_grmhd_2d_info_f32(int which, int* out) __attribute__((weak));
int z4_grmhd_2d_info_f64(int which, int* out) __attribute__((weak));
// The shifted system's, the same (csrc/aderdg_z4_shift_per_axis.cu,
// aderdg_z4_shift_2d.cu and their _f64 twins; weak too).
int z4_shift_per_axis_info_f32(int* out) __attribute__((weak));
int z4_shift_per_axis_info_f64(int* out) __attribute__((weak));
int z4_shift_2d_info_f32(int which, int* out) __attribute__((weak));
int z4_shift_2d_info_f64(int which, int* out) __attribute__((weak));
// The space-time predictor's occupancy at orders 5, 4 and 7
// (csrc/aderdg_p5.cu, aderdg_p4.cu, aderdg_p7.cu and their _f64 twins; weak
// too).
int st_predictor_info_f32(int* out) __attribute__((weak));
int st_predictor_info_f64(int* out) __attribute__((weak));
int st_predictor_p4_info_f32(int* out) __attribute__((weak));
int st_predictor_p4_info_f64(int* out) __attribute__((weak));
int st_predictor_p7_info_f32(int* out) __attribute__((weak));
int st_predictor_p7_info_f64(int* out) __attribute__((weak));
// The 2-D steps' occupancy (csrc/aderdg_2d.cu; weak too): `which` 0
// predictor, 1 face flux, 2 update, 3 and 4 the wall pair, 5 the viscous
// predictor, of `physics` (0 Euler; 2 Navier–Stokes: 1, 2 and 5).
int aderdg_2d_kernel_info_f32(int which, int physics, int* out) __attribute__((weak));
int aderdg_2d_kernel_info_f64(int which, int physics, int* out) __attribute__((weak));

namespace {

// Order 3: the node count of this file's predictors and of its face stage's
// order-3 instances (the face stage also has Euler instances at orders 4,
// 5 and 7, for csrc/aderdg_st.cuh's predictor).
constexpr int kNN = 4;

// Wall modes of the C interface: the ghost is my own face times a sign
// table (mirror; outflow is the all-ones table), the constant farfield
// state, or the Dirichlet row.
enum WallMode : int { kMirror = 0, kFarfield = 1, kDirichlet = 2 };

// The face stage's wall description (zero, and unread, in the periodic
// instantiation).
template <typename T, int V>
struct WallParams {
  int mask;             // bit d: grid axis d carries walls
  int mode;             // WallMode
  T sq[kDim][V];        // kMirror: ghost state S_q[d] q
  T sf[kDim][V];        // kMirror: ghost flux S_f[d] f
  T far[V];             // kFarfield: the ghost state
  const T* rows;        // kDirichlet: ghost rows [side][wall axis][m][v][plane]
  T* fwall;             // low-wall fluxes [wall axis][m][v][plane]
  long long off[kDim];  // element offset of axis d's block (wall axes)
  long long side;       // elements of one side of rows
  const T* fv;          // viscous physics: the viscous-only wall fluxes, in rows' layout
};

// tbl[d][v] for a thread-dependent d and a compile-time v (see select_row).
template <typename T, int V>
__device__ __forceinline__ T select_col(const T (&tbl)[kDim][V], int d, int v) {
  T out = tbl[0][v];
#pragma unroll
  for (int i = 1; i < kDim; ++i) {
    if (i == d) out = tbl[i][v];
  }
  return out;
}

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
  using U = PencilStage<NN, CB>;
  U::template load<T, V>(u, sU, p_io, c_io, at0, ncell);

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
          T r = P.PHI0[s] * Uat(i2, v);
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

// The CK predictor's source instances (a template argument): none, or K2
// a's absorbing sponge S(q) = −σ_c q on the evolved rows, σ_c a cell's rate
// (models/elastic.py::sponge_source; zero on the material rows).
struct NoSource {
  static constexpr bool kOn = false;
};
struct SpongeSource {
  static constexpr bool kOn = true;
};

// Dynamic shared memory of aderdg_ck_predictor_volume: u (then q̄, then
// new) in V rows and one axis's F̄_d in E rows, each NN^3 CB values a row.
template <typename T, int NN, int CB, int V, int E>
constexpr size_t ck_predictor_smem() {
  return static_cast<size_t>((V + E) * NN * NN * NN * CB) * sizeof(T);
}

// K2, the CK predictor (see the note at the top): one thread per (cell,
// pencil along the last node axis), CB cells x NN^2 pencils per block, the
// Picard predictor's thread shape; shared memory only stages u in, q̄ and
// F̄_d for the face projections, and new out.  With Source = SpongeSource
// (K2 a) each level adds dt·S(q_{k−1}) = dt·(−σ_c q) to the evolved rows
// before the division by k, and new starts from u + dt·S(q̄); sigma, σ_c
// per cell, is read once a cell (unread, and null, without a source).
template <typename T, int NN, int CB, typename Source = NoSource>
__global__ void __launch_bounds__(CB * NN * NN, 3)
aderdg_ck_predictor_volume(const T* __restrict__ u, T* __restrict__ out,
                           T* __restrict__ faces, const T* __restrict__ dt_ptr,
                           T dt_val, const Params<T, NN, ElasticHetPhysics<T>> P,
                           const T* __restrict__ sigma) {
  static_assert(NN * NN * 2 == 32, "a warp holds the 16 pencils of 2 cells");
  using Phys = ElasticHetPhysics<T>;
  using U = PencilStage<NN, CB>;
  constexpr int NF = NN * NN;
  constexpr int V = Phys::V;
  constexpr int E = Phys::kEvolved;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);  // u, then q̄, then new
  T* sF = sA + V * NN * NF * CB;           // one axis's F̄_d

  // The I/O mapping: CB cells fastest (32-byte runs), pencil p_io.
  const int c_io = threadIdx.x % CB;
  const int p_io = threadIdx.x / CB;
  const long long ncell = P.ncell;
  const long long cell_raw = static_cast<long long>(blockIdx.x) * CB + c_io;
  const bool valid = cell_raw < ncell;
  const long long cell = valid ? cell_raw : ncell - 1;  // ragged tail: clamp
  const long long at0 = static_cast<long long>(p_io * NN * V) * ncell + cell;
  U::template load<T, V>(u, sA, p_io, c_io, at0, ncell);

  // The compute mapping: lane = 2 (4 i0 + i1) + cell bit; the pencils
  // along axes 0 and 1 through mine are lanes xor k<<3 and xor k<<1.
  const int lane = threadIdx.x % 32;
  const int c = (threadIdx.x / 32) * 2 + (lane & 1);
  const int i0 = lane >> 3, i1 = (lane >> 1) & (NN - 1);
  const int pencil = i0 * NN + i1;
  auto A = [&](int i2, int v) -> T& { return sA[U::at(v, i2, pencil, c)]; };

  const T dtv = dt_ptr != nullptr ? *dt_ptr : dt_val;
  T lam[kDim];
#pragma unroll
  for (int d = 0; d < kDim; ++d) lam[d] = dtv / P.dx[d];
  // The sponge's rate of my compute-mapping cell (the ragged tail clamped
  // as in the I/O mapping).
  T sig = T(0);
  if constexpr (Source::kOn) {
    const long long cc = static_cast<long long>(blockIdx.x) * CB + c;
    sig = sigma[cc < ncell ? cc : ncell - 1];
  }
  // The coefficient of the value the xor-k shuffle brings: D and Kvol
  // along axes 0 and 1, and the face projections' φ(0), φ(1) (for the
  // face node whose index on that axis is mine).
  T D0[NN], D1[NN], K0[NN], K1[NN];
  {
    T d0[NN], d1[NN], k0[NN], k1[NN];
    select_row<T, NN>(P.D, i0, d0);
    select_row<T, NN>(P.D, i1, d1);
    select_row<T, NN>(P.Kvol, i0, k0);
    select_row<T, NN>(P.Kvol, i1, k1);
#pragma unroll
    for (int k = 0; k < NN; ++k) {
      D0[k] = select<T, NN>(d0, i0 ^ k);
      D1[k] = select<T, NN>(d1, i1 ^ k);
      K0[k] = select<T, NN>(k0, i0 ^ k);
      K1[k] = select<T, NN>(k1, i1 ^ k);
    }
  }
  __syncthreads();  // u staged

  // My pencil's materials, frozen for the whole step (the reference injects
  // u's at every level), and the level-0 Taylor term q_0 = u.
  T inv_rho[NN], lame[NN], mu[NN];
  T qk[NN][E];
  // q̄ accumulates in sF (free until the epilogue), each thread its own
  // rows: 36 registers fewer than in registers, and no slower (PERF.md).
  auto QB = [&](int i2, int v) -> T& { return sF[U::at(v, i2, pencil, c)]; };
#pragma unroll
  for (int i2 = 0; i2 < NN; ++i2) {
    inv_rho[i2] = T(1) / A(i2, Phys::kRho);
    lame[i2] = A(i2, Phys::kLam);
    mu[i2] = A(i2, Phys::kMu);
#pragma unroll
    for (int v = 0; v < E; ++v) {
      qk[i2][v] = A(i2, v);
      QB(i2, v) = qk[i2][v];
    }
  }

  // The Taylor recursion: q_k = −Σ_d λ_d D_d F_d(q_{k−1}) / k, q̄ += q_k /
  // (k + 1), in registers and shuffles (q̄ in the thread's own words of sF).
#pragma unroll
  for (int k = 1; k < NN; ++k) {
    T dF2[NN][E];
#pragma unroll
    for (int i2 = 0; i2 < NN; ++i2) {
      T f[kDim][E];
#pragma unroll
      for (int d = 0; d < kDim; ++d) {
        elastic3d_het_flux<T>(qk[i2], inv_rho[i2], lame[i2], mu[i2], d, f[d]);
      }
#pragma unroll
      for (int n = 0; n < NN; ++n) {
#pragma unroll
        for (int v = 0; v < E; ++v) {
          dF2[n][v] = i2 == 0 ? P.D[n][0] * f[2][v] : dF2[n][v] + P.D[n][i2] * f[2][v];
        }
      }
#pragma unroll
      for (int v = 0; v < E; ++v) {
        T dF0 = D0[0] * f[0][v];
        T dF1 = D1[0] * f[1][v];
#pragma unroll
        for (int x = 1; x < NN; ++x) {
          dF0 = dF0 + D0[x] * __shfl_xor_sync(kAll, f[0][v], x << 3);
          dF1 = dF1 + D1[x] * __shfl_xor_sync(kAll, f[1][v], x << 1);
        }
        // q_{k-1} at this node has given its fluxes: its slot takes r
        // (with the sponge, and its source term dt·(−σ_c q_{k−1})).
        if constexpr (Source::kOn) {
          qk[i2][v] = (-(lam[0] * dF0) - lam[1] * dF1) + dtv * -(sig * qk[i2][v]);
        } else {
          qk[i2][v] = -(lam[0] * dF0) - lam[1] * dF1;
        }
      }
    }
#pragma unroll
    for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
      for (int v = 0; v < E; ++v) {
        const T r = qk[i2][v] - lam[2] * dF2[i2][v];
        qk[i2][v] = r / T(k);
        QB(i2, v) = QB(i2, v) + qk[i2][v] / T(k + 1);
      }
    }
  }

  // new's evolved rows start from u (with the sponge u + dt·S(q̄)), in the
  // registers of q_k (spent); q̄'s evolved rows replace u's in sA (its
  // material rows are u's already).
  T nw[NN][E];
#pragma unroll
  for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
    for (int v = 0; v < E; ++v) {
      if constexpr (Source::kOn) {
        nw[i2][v] = A(i2, v) + dtv * -(sig * QB(i2, v));
      } else {
        nw[i2][v] = A(i2, v);
      }
      A(i2, v) = QB(i2, v);
    }
  }

  // Axis by axis: F̄_d = F_d(q̄) and its volume term new += λ_d Kvol_d F̄_d
  // (d in order) in the compute mapping; F̄_d to sF; then the face
  // projections (q_lo, q_hi, f_lo, f_hi) of axis d in the I/O mapping, one
  // face node p_io a thread, from q̄ in sA and F̄_d in sF, straight to
  // device memory as 32-byte runs.
  const int m_a = p_io / NN, m_b = p_io % NN;  // my face node of each axis
  const long long stride_w = static_cast<long long>(NF * V) * ncell;
#pragma unroll
  for (int d = 0; d < kDim; ++d) {
    T fb[NN][E];
#pragma unroll
    for (int i2 = 0; i2 < NN; ++i2) {
      T qbar[E];
#pragma unroll
      for (int v = 0; v < E; ++v) qbar[v] = A(i2, v);
      elastic3d_het_flux<T>(qbar, inv_rho[i2], lame[i2], mu[i2], d, fb[i2]);
    }
#pragma unroll
    for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
      for (int v = 0; v < E; ++v) {
        T kv;
        if (d == 2) {
          kv = P.Kvol[i2][0] * fb[0][v];
#pragma unroll
          for (int j = 1; j < NN; ++j) kv = kv + P.Kvol[i2][j] * fb[j][v];
        } else {
          const T (&Kx)[NN] = d == 0 ? K0 : K1;
          const int sh = d == 0 ? 3 : 1;
          kv = Kx[0] * fb[i2][v];
#pragma unroll
          for (int x = 1; x < NN; ++x) kv = kv + Kx[x] * __shfl_xor_sync(kAll, fb[i2][v], x << sh);
        }
        nw[i2][v] = nw[i2][v] + lam[d] * kv;
        sF[U::at(v, i2, pencil, c)] = fb[i2][v];
      }
    }
    __syncthreads();  // q̄ (d = 0) and F̄_d staged

    // Face node p_io of axis d: on axis 2 the pencil (m_a, m_b), nodes
    // (m_a, m_b, j); on axis 0 the nodes (j, m_a, m_b); on axis 1 (m_a, j,
    // m_b).  faces[d][which][m][v][cell].
    auto at = [&](int v, int j) {
      return d == 2 ? U::at(v, j, p_io, c_io)
                    : (d == 0 ? U::at(v, m_b, j * NN + m_a, c_io)
                              : U::at(v, m_b, m_a * NN + j, c_io));
    };
    if (valid) {
      const long long base = static_cast<long long>(d * 4 * NF + p_io) * V * ncell + cell;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        T qlo = P.PHI0[0] * sA[at(v, 0)], qhi = P.PHI1[0] * sA[at(v, 0)];
        T flo = T(0), fhi = T(0);  // the materials' flux rows are zero
        if (v < E) {
          flo = P.PHI0[0] * sF[at(v, 0)];
          fhi = P.PHI1[0] * sF[at(v, 0)];
        }
#pragma unroll
        for (int j = 1; j < NN; ++j) {
          const T qj = sA[at(v, j)];
          qlo = qlo + P.PHI0[j] * qj;
          qhi = qhi + P.PHI1[j] * qj;
          if (v < E) {
            const T fj = sF[at(v, j)];
            flo = flo + P.PHI0[j] * fj;
            fhi = fhi + P.PHI1[j] * fj;
          }
        }
        const long long o = base + static_cast<long long>(v) * ncell;
        faces[o] = qlo;
        faces[o + stride_w] = qhi;
        faces[o + 2 * stride_w] = flo;
        faces[o + 3 * stride_w] = fhi;
      }
    }
    __syncthreads();  // sF (and, after d = 2, sA) free
  }

  // new: the evolved rows from the registers, the material rows u's bits
  // (sA's material rows were never written), out in the I/O mapping.
#pragma unroll
  for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
    for (int v = 0; v < E; ++v) A(i2, v) = nw[i2][v];
  }
  __syncthreads();
  if (valid) {
#pragma unroll
    for (int i2 = 0; i2 < NN; ++i2) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        out[at0 + static_cast<long long>(i2 * V + v) * ncell] = sA[U::at(v, i2, p_io, c_io)];
      }
    }
  }
}

// The face stage's tiling (kTile, TileCell: csrc/aderdg_common.cuh):
// blocks of aderdg_face_flux take kFluxNodes face nodes of one axis, blocks
// of aderdg_surface_update kUpdateNodes space nodes.  At NN = 3 (9 face
// nodes an axis, 27 space nodes a cell, K2 b's elasticity at order 2) those
// do not divide: there a block takes 3 face nodes and 9 space nodes; at NN
// = 5 (25 face nodes, 125 space nodes, Euler at order 4) 5 of each
// (FaceTiling; the instances at NN = 4, 6 and 8 keep kFluxNodes and
// kUpdateNodes).  The walled update asks for as many resident threads an SM
// as at NN = 4 (kWallUpdateThreads: 6 blocks of 256), which holds its
// registers at 40.
constexpr int kFluxNodes = 4;
constexpr int kUpdateNodes = 8;
constexpr int kWallUpdateThreads = 6 * kTile * kUpdateNodes;

template <int NN>
struct FaceTiling {
  static constexpr int kFlux = NN == 3 ? 3 : (NN == 5 ? 5 : kFluxNodes);
  static constexpr int kUpdate = NN == 3 ? 9 : (NN == 5 ? 5 : kUpdateNodes);
  static constexpr int kWallUpdateBlocks = kWallUpdateThreads / (kTile * kUpdate);
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
__global__ void __launch_bounds__(kTile * FaceTiling<NN>::kFlux)
aderdg_face_flux(const T* __restrict__ faces, T* __restrict__ fhat,
                 const Params<T, NN, Phys> P) {
  constexpr int NF = NN * NN;
  constexpr int V = Phys::V;
  constexpr int R = Phys::kFluxRows;
  constexpr int FN = FaceTiling<NN>::kFlux;
  const TileCell tc(blockIdx.x, P.g);
  if (!tc.inside) return;  // no barrier here
  const int d = blockIdx.y / (NF / FN);
  const int m = (blockIdx.y % (NF / FN)) * FN + threadIdx.y;
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
  T s = dmax(P.phys.max_eigenvalue(qa, d), P.phys.max_eigenvalue(qb, d));
  if constexpr (Phys::kViscous) s = s + P.phys.penalty(qa, qb, d);
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
__global__ void __launch_bounds__(kTile * FaceTiling<NN>::kUpdate)
aderdg_surface_update(T* __restrict__ state, const T* __restrict__ fhat,
                      const T* __restrict__ dt_ptr, T dt_val, const Params<T, NN, Phys> P) {
  constexpr int NF = NN * NN;
  constexpr int UN = FaceTiling<NN>::kUpdate;
  constexpr int NG = NN * NF / UN;
  constexpr int V = Phys::V;
  constexpr int R = Phys::kFluxRows;
  const int tile_index = blockIdx.x / NG;
  const TileCell tc(tile_index, P.g);
  if (!tc.inside) return;
  const int node = (blockIdx.x - tile_index * NG) * UN + threadIdx.y;
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

// W.off[d] for a thread-dependent d (see select_row).
template <typename T, int V>
__device__ __forceinline__ long long wall_offset(const WallParams<T, V>& W, int d) {
  long long off = W.off[0];
#pragma unroll
  for (int i = 1; i < kDim; ++i) {
    if (i == d) off = W.off[i];
  }
  return off;
}

// The ghost of wall (axis d, side) at face node m, plane index p, from my
// own face state q and flux f: its state gq (all V rows) and flux gf (rows
// 0..R-1).  A Dirichlet row is read from W.rows; the farfield and
// Dirichlet ghost fluxes are the physics' flux of the ghost.  A viscous
// physics splits the flux: the ghost flux of the advective part f - fv
// (the mirror's sign table, or F(ghost)), plus the interior one-sided
// viscous part fv (W.fv, my cell's own projection to the wall).
template <typename T, typename Phys>
__device__ __forceinline__ void wall_ghost(const WallParams<T, Phys::V>& W, const Phys& phys,
                                           int d, int side, int m, long long plane,
                                           long long p, const T* q, const T* f, T* gq,
                                           T* gf) {
  constexpr int V = Phys::V;
  constexpr int R = Phys::kFluxRows;
  if (W.mode == kMirror) {
#pragma unroll
    for (int v = 0; v < V; ++v) gq[v] = select_col<T, V>(W.sq, d, v) * q[v];
    if constexpr (Phys::kViscous) {
      const T* fv = W.fv + side * W.side + wall_offset(W, d) + static_cast<long long>(m) * V * plane + p;
#pragma unroll
      for (int v = 0; v < R; ++v) {
        const T fvv = fv[v * plane];
        gf[v] = select_col<T, V>(W.sf, d, v) * (f[v] - fvv) + fvv;
      }
    } else {
#pragma unroll
      for (int v = 0; v < R; ++v) gf[v] = select_col<T, V>(W.sf, d, v) * f[v];
    }
    return;
  }
  if (W.mode == kFarfield) {
#pragma unroll
    for (int v = 0; v < V; ++v) gq[v] = W.far[v];
  } else {
    const T* row = W.rows + side * W.side + wall_offset(W, d) + static_cast<long long>(m) * V * plane + p;
#pragma unroll
    for (int v = 0; v < V; ++v) gq[v] = row[v * plane];
  }
  phys.flux_along(gq, d, gf);
  if constexpr (Phys::kViscous) {
    const T* fv = W.fv + side * W.side + wall_offset(W, d) + static_cast<long long>(m) * V * plane + p;
#pragma unroll
    for (int v = 0; v < R; ++v) gf[v] = gf[v] + fv[v * plane];
  }
}

// The face stage's wall variant, first launch: aderdg_face_flux, except
// on a wall axis.  There the last row's right state is the wall's ghost of
// its own high face (so its F̂ is the high-wall flux), and the first row
// also solves its low wall, ghost on the left and its own low face on the
// right, ½(g_f + f_lo) − ½ s_w m (q_lo − g_q), into W.fwall.
template <typename T, int NN, typename Phys>
__global__ void __launch_bounds__(kTile * FaceTiling<NN>::kFlux)
aderdg_face_flux_walls(const T* __restrict__ faces, T* __restrict__ fhat,
                       const Params<T, NN, Phys> P, const WallParams<T, Phys::V> W) {
  constexpr int NF = NN * NN;
  constexpr int V = Phys::V;
  constexpr int R = Phys::kFluxRows;
  constexpr int FN = FaceTiling<NN>::kFlux;
  const TileCell tc(blockIdx.x, P.g);
  if (!tc.inside) return;  // no barrier here
  const int d = blockIdx.y / (NF / FN);
  const int m = (blockIdx.y % (NF / FN)) * FN + threadIdx.y;
  const long long ncell = P.ncell;
  const long long cell = tc.cell;
  const bool wall = (W.mask >> d) & 1;
  const T* base = faces + static_cast<long long>(d * 4 * NF + m) * V * ncell;
  const long long wstride = static_cast<long long>(NF * V) * ncell;
  T qa[V], qb[V], fa[R], fb[R];  // a: my high face, b: the neighbour's low face or my ghost
#pragma unroll
  for (int v = 0; v < V; ++v) qa[v] = base[wstride + v * ncell + cell];
#pragma unroll
  for (int v = 0; v < R; ++v) fa[v] = base[3 * wstride + v * ncell + cell];
  if (wall && tc.at(d) == tc.extent(d) - 1) {  // the high wall
    wall_ghost<T, Phys>(W, P.phys, d, 1, m, tc.plane(d), tc.plane_index(d), qa, fa, qb, fb);
  } else {
    const long long plus = tc.neighbour(d, 1);
#pragma unroll
    for (int v = 0; v < V; ++v) qb[v] = base[v * ncell + plus];
#pragma unroll
    for (int v = 0; v < R; ++v) fb[v] = base[2 * wstride + v * ncell + plus];
  }
  if (wall && tc.at(d) == 0) {  // the low wall
    const long long plane = tc.plane(d);
    const long long p = tc.plane_index(d);
    T ql[V], fl[R], gq[V], gf[R];
#pragma unroll
    for (int v = 0; v < V; ++v) ql[v] = base[v * ncell + cell];
#pragma unroll
    for (int v = 0; v < R; ++v) fl[v] = base[2 * wstride + v * ncell + cell];
    wall_ghost<T, Phys>(W, P.phys, d, 0, m, plane, p, ql, fl, gq, gf);
    T sw = dmax(P.phys.max_eigenvalue(ql, d), P.phys.max_eigenvalue(gq, d));
    if constexpr (Phys::kViscous) sw = sw + P.phys.penalty(ql, gq, d);
    T* w = W.fwall + wall_offset(W, d) + static_cast<long long>(m) * V * plane + p;
#pragma unroll
    for (int v = 0; v < R; ++v) {
      T dq = ql[v] - gq[v];
      if constexpr (Phys::kMasked) dq = dq * Phys::dissipation(v);
      w[v * plane] = T(0.5) * (gf[v] + fl[v]) - T(0.5) * sw * dq;
    }
  }
  T s = dmax(P.phys.max_eigenvalue(qa, d), P.phys.max_eigenvalue(qb, d));
  if constexpr (Phys::kViscous) s = s + P.phys.penalty(qa, qb, d);
  T* out = fhat + static_cast<long long>(d * NF + m) * V * ncell + cell;
#pragma unroll
  for (int v = 0; v < R; ++v) {
    T dq = qb[v] - qa[v];
    if constexpr (Phys::kMasked) dq = dq * Phys::dissipation(v);
    out[v * ncell] = T(0.5) * (fa[v] + fb[v]) - T(0.5) * s * dq;
  }
}

// The face stage's wall variant, second launch: aderdg_surface_update,
// with F̂_lo read from W.fwall in the first row of a wall axis.  The
// per-thread choice of F̂_lo's row stride costs registers: the kernel is
// held to the periodic update's 6 resident blocks of 256 threads an SM (at
// NN = 5, 9 blocks of 160).
template <typename T, int NN, typename Phys>
__global__ void __launch_bounds__(kTile * FaceTiling<NN>::kUpdate,
                                  FaceTiling<NN>::kWallUpdateBlocks)
aderdg_surface_update_walls(T* __restrict__ state, const T* __restrict__ fhat,
                            const T* __restrict__ dt_ptr, T dt_val,
                            const Params<T, NN, Phys> P, const WallParams<T, Phys::V> W) {
  constexpr int NF = NN * NN;
  constexpr int UN = FaceTiling<NN>::kUpdate;
  constexpr int NG = NN * NF / UN;
  constexpr int V = Phys::V;
  constexpr int R = Phys::kFluxRows;
  const int tile_index = blockIdx.x / NG;
  const TileCell tc(tile_index, P.g);
  if (!tc.inside) return;
  const int node = (blockIdx.x - tile_index * NG) * UN + threadIdx.y;
  const long long ncell = P.ncell;
  const long long cell = tc.cell;
  const T dtv = dt_ptr != nullptr ? *dt_ptr : dt_val;
  const int ix[kDim] = {node / NF, (node / NN) % NN, node % NN};
  const int mf[kDim] = {ix[1] * NN + ix[2], ix[0] * NN + ix[2], ix[0] * NN + ix[1]};
  T lam[kDim], p1w[kDim], p0w[kDim];
  long long hi[kDim];     // offset of F̂_hi of row 0
  const T* lo[kDim];      // F̂_lo of row 0, and the stride between rows
  long long lo_step[kDim];
#pragma unroll
  for (int d = 0; d < kDim; ++d) {
    lam[d] = dtv / P.dx[d];
    p1w[d] = select<T, NN>(P.PHI1W, ix[d]);
    p0w[d] = select<T, NN>(P.PHI0W, ix[d]);
    const long long row0 = static_cast<long long>(d * NF + mf[d]) * V * ncell;
    hi[d] = row0 + cell;
    if (((W.mask >> d) & 1) && tc.at(d) == 0) {
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
    const long long o = static_cast<long long>(node * V + v) * ncell + cell;
    T x = state[o];
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
      x = x - lam[d] * (p1w[d] * fhat[hi[d] + v * ncell] - p0w[d] * lo[d][v * lo_step[d]]);
    }
    state[o] = x;
  }
}

// K1 e: the face stage of a rank's window of a grid whose axes are split
// over ranks (exahype_tpu_torch/parallel/shard.py), the counterpart of the
// TPU kernel's epilogue_axes.  Each side of each axis is periodic, a
// domain wall this rank owns, or exchanged: the neighbour's face row is a
// plane the rank received.  aderdg_face_flux_exchanged solves every face
// of the window once, as aderdg_face_flux_walls does, except that on an
// exchanged side the last row's right state is the +d neighbour's first
// row's (q_lo, f_lo) and the first row solves its low interface itself,
// the −d neighbour's last row's (q_hi, f_hi) on the left and its own low
// face on the right, into X.fside.  That flux is the same expression on
// the same operands as the neighbour's own high face, so the step matches
// the unsharded one bit for bit; the update is aderdg_surface_update_walls
// with F̂_lo read from X.fside on every axis whose low side is not periodic.
enum SideMode : int { kPeriodicSide = 0, kWallSide = 1, kExchangedSide = 2 };

template <typename T>
struct ExchangeParams {
  int mode[kDim][2];        // SideMode of (axis, side): side 0 low, 1 high
  const T* plane[kDim][2];  // kExchangedSide: the received row [2 (q, f)][n²][V][plane]
  T* fside;                 // the first row's low fluxes [axis][n²][V][plane]
  long long off[kDim];      // element offset of axis d's block in fside
};

// X.mode[d][side] and X.plane[d][side] for a thread-dependent d (see
// select_row).
template <typename T>
__device__ __forceinline__ int side_mode(const ExchangeParams<T>& X, int d, int side) {
  int out = X.mode[0][side];
#pragma unroll
  for (int i = 1; i < kDim; ++i) {
    if (i == d) out = X.mode[i][side];
  }
  return out;
}

template <typename T>
__device__ __forceinline__ const T* side_plane(const ExchangeParams<T>& X, int d, int side) {
  const T* out = X.plane[0][side];
#pragma unroll
  for (int i = 1; i < kDim; ++i) {
    if (i == d) out = X.plane[i][side];
  }
  return out;
}

template <typename T>
__device__ __forceinline__ long long side_offset(const ExchangeParams<T>& X, int d) {
  long long out = X.off[0];
#pragma unroll
  for (int i = 1; i < kDim; ++i) {
    if (i == d) out = X.off[i];
  }
  return out;
}

// The Rusanov flux between left state (qa, fa) and right state (qb, fb)
// along d, rows 0..R-1, to out[v * stride]: the expression of
// aderdg_face_flux, operand for operand.
template <typename T, typename Phys>
__device__ __forceinline__ void rusanov(const Phys& phys, const T* qa, const T* qb,
                                        const T* fa, const T* fb, int d, T* out,
                                        long long stride) {
  T s = dmax(phys.max_eigenvalue(qa, d), phys.max_eigenvalue(qb, d));
  if constexpr (Phys::kViscous) s = s + phys.penalty(qa, qb, d);
#pragma unroll
  for (int v = 0; v < Phys::kFluxRows; ++v) {
    T dq = qb[v] - qa[v];
    if constexpr (Phys::kMasked) dq = dq * Phys::dissipation(v);
    out[v * stride] = T(0.5) * (fa[v] + fb[v]) - T(0.5) * s * dq;
  }
}

template <typename T, int NN, typename Phys>
__global__ void __launch_bounds__(kTile * kFluxNodes)
aderdg_face_flux_exchanged(const T* __restrict__ faces, T* __restrict__ fhat,
                           const Params<T, NN, Phys> P, const WallParams<T, Phys::V> W,
                           const ExchangeParams<T> X) {
  constexpr int NF = NN * NN;
  constexpr int V = Phys::V;
  constexpr int R = Phys::kFluxRows;
  const TileCell tc(blockIdx.x, P.g);
  if (!tc.inside) return;  // no barrier here
  const int d = blockIdx.y / (NF / kFluxNodes);
  const int m = (blockIdx.y % (NF / kFluxNodes)) * kFluxNodes + threadIdx.y;
  const long long ncell = P.ncell;
  const long long cell = tc.cell;
  const int lo_mode = side_mode(X, d, 0);
  const int hi_mode = side_mode(X, d, 1);
  const T* base = faces + static_cast<long long>(d * 4 * NF + m) * V * ncell;
  const long long wstride = static_cast<long long>(NF * V) * ncell;
  T qa[V], qb[V], fa[R], fb[R];  // a: my high face, b: the right state
#pragma unroll
  for (int v = 0; v < V; ++v) qa[v] = base[wstride + v * ncell + cell];
#pragma unroll
  for (int v = 0; v < R; ++v) fa[v] = base[3 * wstride + v * ncell + cell];
  const bool last = tc.at(d) == tc.extent(d) - 1;
  if (last && hi_mode == kWallSide) {  // the high wall
    wall_ghost<T, Phys>(W, P.phys, d, 1, m, tc.plane(d), tc.plane_index(d), qa, fa, qb, fb);
  } else if (last && hi_mode == kExchangedSide) {  // the +d neighbour's first row
    const long long plane = tc.plane(d);
    const T* row = side_plane(X, d, 1) + static_cast<long long>(m) * V * plane + tc.plane_index(d);
    const long long fstride = static_cast<long long>(NF * V) * plane;
#pragma unroll
    for (int v = 0; v < V; ++v) qb[v] = row[v * plane];
#pragma unroll
    for (int v = 0; v < R; ++v) fb[v] = row[fstride + v * plane];
  } else {
    const long long plus = tc.neighbour(d, 1);
#pragma unroll
    for (int v = 0; v < V; ++v) qb[v] = base[v * ncell + plus];
#pragma unroll
    for (int v = 0; v < R; ++v) fb[v] = base[2 * wstride + v * ncell + plus];
  }
  if (tc.at(d) == 0 && lo_mode != kPeriodicSide) {  // the first row's low face
    const long long plane = tc.plane(d);
    const long long p = tc.plane_index(d);
    T* w = X.fside + side_offset(X, d) + static_cast<long long>(m) * V * plane + p;
    T ql[V], fl[R], gq[V], gf[R];  // my low face; the left state
#pragma unroll
    for (int v = 0; v < V; ++v) ql[v] = base[v * ncell + cell];
#pragma unroll
    for (int v = 0; v < R; ++v) fl[v] = base[2 * wstride + v * ncell + cell];
    if (lo_mode == kWallSide) {  // aderdg_face_flux_walls's low wall, operand for operand
      wall_ghost<T, Phys>(W, P.phys, d, 0, m, plane, p, ql, fl, gq, gf);
      T sw = dmax(P.phys.max_eigenvalue(ql, d), P.phys.max_eigenvalue(gq, d));
      if constexpr (Phys::kViscous) sw = sw + P.phys.penalty(ql, gq, d);
#pragma unroll
      for (int v = 0; v < R; ++v) {
        T dq = ql[v] - gq[v];
        if constexpr (Phys::kMasked) dq = dq * Phys::dissipation(v);
        w[v * plane] = T(0.5) * (gf[v] + fl[v]) - T(0.5) * sw * dq;
      }
    } else {  // the −d neighbour's last row's high face on the left
      const T* row = side_plane(X, d, 0) + static_cast<long long>(m) * V * plane + p;
      const long long fstride = static_cast<long long>(NF * V) * plane;
#pragma unroll
      for (int v = 0; v < V; ++v) gq[v] = row[v * plane];
#pragma unroll
      for (int v = 0; v < R; ++v) gf[v] = row[fstride + v * plane];
      rusanov<T, Phys>(P.phys, gq, ql, gf, fl, d, w, plane);
    }
  }
  rusanov<T, Phys>(P.phys, qa, qb, fa, fb, d,
                   fhat + static_cast<long long>(d * NF + m) * V * ncell + cell, ncell);
}

// Host side ---------------------------------------------------------------

// The face stage's wall description from the C interface's arguments (see
// there); all zero for mask == 0, no ghost tables without `table` (the
// update reads only the mask, fwall and the offsets).
template <typename T, int V>
WallParams<T, V> make_walls(int mask, int mode, const double* table, const T* rows, T* fwall,
                            const long long* off, long long side, const T* fv = nullptr) {
  WallParams<T, V> W{};
  if (mask == 0) return W;
  W.mask = mask;
  W.mode = mode;
  W.rows = rows;
  W.fv = fv;
  W.fwall = fwall;
  W.side = side;
  for (int d = 0; d < kDim; ++d) W.off[d] = off[d];
  if (table == nullptr) return W;
  for (int d = 0; d < kDim; ++d) {
    for (int v = 0; v < V; ++v) {
      W.sq[d][v] = static_cast<T>(table[d * V + v]);
      W.sf[d][v] = static_cast<T>(table[(kDim + d) * V + v]);
    }
  }
  for (int v = 0; v < V; ++v) W.far[v] = static_cast<T>(table[2 * kDim * V + v]);
  return W;
}

// A wall description the update can use: a mask of the 3 axes, the side
// tensor and its offsets.
bool bad_walls(int mask, const void* fwall, const long long* off) {
  return mask != 0 && (mask < 0 || mask > 7 || fwall == nullptr || off == nullptr);
}

// The wall entry points take walls only (a mask of 0 is the periodic entry's).
bool no_walls(int mask) { return mask == 0; }

// ... and the face flux: a known mode, the tables, the rows in Dirichlet mode.
bool bad_ghosts(int mask, int mode, const double* table, const void* rows) {
  if (mask == 0) return false;
  if (table == nullptr || (mode != kMirror && mode != kFarfield && mode != kDirichlet))
    return true;
  return mode == kDirichlet && rows == nullptr;
}

// Tiles of the face stage (kTile cells of one row of the last axis), or 0
// if the update kernel's block index (tiles x its node groups) or a grid
// coordinate would not fit a 32-bit int.
template <int NN>
long long face_tiles(int order, long long g0, long long g1, long long g2) {
  constexpr long long kMax = 0x7fffffffLL;
  if (bad_grid<NN>(order, g0, g1, g2) || g0 > kMax || g1 > kMax || g2 > kMax) return 0;
  const long long tiles = g0 * g1 * ((g2 + kTile - 1) / kTile);
  return tiles * (NN * NN * NN / FaceTiling<NN>::kUpdate) > kMax ? 0 : tiles;
}

template <typename T, typename Phys>
Shape predictor_shape() {
  constexpr int CB = cells_per_block<T>();
  return {reinterpret_cast<const void*>(aderdg_predictor_volume<T, kNN, CB, Phys>),
          dim3(CB * kNN * kNN), predictor_smem<T, kNN, CB, Phys::V>()};
}

template <typename T, typename Source = NoSource>
Shape ck_predictor_shape() {
  constexpr int CB = cells_per_block<T>();
  return {reinterpret_cast<const void*>(aderdg_ck_predictor_volume<T, kNN, CB, Source>),
          dim3(CB * kNN * kNN),
          ck_predictor_smem<T, kNN, CB, ElasticHetPhysics<T>::V,
                            ElasticHetPhysics<T>::kEvolved>()};
}

// The face stage's shapes and launchers take the instance's node count NN:
// both pairs are instantiated at order 3 and, for Euler, at orders 4, 5 and
// 7; the periodic pair also at order 2 (K2 b's elasticity).
template <typename T, typename Phys, bool kWalls, int NN = kNN>
Shape face_flux_shape() {
  const void* fn;
  if constexpr (kWalls) {
    fn = reinterpret_cast<const void*>(aderdg_face_flux_walls<T, NN, Phys>);
  } else {
    fn = reinterpret_cast<const void*>(aderdg_face_flux<T, NN, Phys>);
  }
  return {fn, dim3(kTile, FaceTiling<NN>::kFlux), 0};
}

template <typename T, typename Phys, bool kWalls, int NN = kNN>
Shape surface_update_shape() {
  const void* fn;
  if constexpr (kWalls) {
    fn = reinterpret_cast<const void*>(aderdg_surface_update_walls<T, NN, Phys>);
  } else {
    fn = reinterpret_cast<const void*>(aderdg_surface_update<T, NN, Phys>);
  }
  return {fn, dim3(kTile, FaceTiling<NN>::kUpdate), 0};
}

template <typename T, typename Phys>
cudaError_t launch_predictor_volume(const T* u, T* out, T* faces, const T* dt_ptr,
                                    double dt_val, const double* ops, const double* dx,
                                    int order, int picard_iters, const double* params,
                                    long long g0, long long g1, long long g2,
                                    void* stream) {
  constexpr int CB = cells_per_block<T>();
  if (bad_grid<kNN>(order, g0, g1, g2) || picard_iters < 0) return cudaErrorInvalidValue;
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

template <typename T, typename Source>
cudaError_t launch_ck_predictor_volume(const T* u, T* out, T* faces, const T* dt_ptr,
                                       double dt_val, const double* ops, const double* dx,
                                       int order, const double* params, long long g0,
                                       long long g1, long long g2, const T* sigma,
                                       void* stream) {
  using Phys = ElasticHetPhysics<T>;
  constexpr int CB = cells_per_block<T>();
  if (bad_grid<kNN>(order, g0, g1, g2) || (Source::kOn && sigma == nullptr))
    return cudaErrorInvalidValue;
  const auto P = make_params<T, kNN, Phys>(ops, dx, 0, params, g0, g1, g2);
  const Shape sh = ck_predictor_shape<T, Source>();
  const cudaError_t attr =
      allow_smem(aderdg_ck_predictor_volume<T, kNN, CB, Source>, sh.smem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (P.ncell + CB - 1) / CB;
  aderdg_ck_predictor_volume<T, kNN, CB, Source>
      <<<static_cast<unsigned>(blocks), sh.block, sh.smem,
         static_cast<cudaStream_t>(stream)>>>(u, out, faces, dt_ptr, static_cast<T>(dt_val), P,
                                              sigma);
  return cudaGetLastError();
}

template <typename T, typename Phys, bool kWalls, int NN = kNN>
cudaError_t launch_face_flux(const T* faces, T* fhat, const double* ops,
                             const double* dx, int order, const double* params, long long g0,
                             long long g1, long long g2, const WallParams<T, Phys::V>& W,
                             void* stream) {
  const long long tiles = face_tiles<NN>(order, g0, g1, g2);
  if (tiles == 0) return cudaErrorInvalidValue;
  const auto P = make_params<T, NN, Phys>(ops, dx, 0, params, g0, g1, g2);
  const Shape sh = face_flux_shape<T, Phys, kWalls, NN>();
  const dim3 grid(static_cast<unsigned>(tiles), kDim * NN * NN / FaceTiling<NN>::kFlux);
  if constexpr (kWalls) {
    aderdg_face_flux_walls<T, NN, Phys>
        <<<grid, sh.block, 0, static_cast<cudaStream_t>(stream)>>>(faces, fhat, P, W);
  } else {
    aderdg_face_flux<T, NN, Phys><<<grid, sh.block, 0, static_cast<cudaStream_t>(stream)>>>(
        faces, fhat, P);
  }
  return cudaGetLastError();
}

template <typename T, typename Phys, bool kWalls, int NN = kNN>
cudaError_t launch_surface_update(T* state, const T* fhat, const T* dt_ptr, double dt_val,
                                  const double* ops, const double* dx, int order,
                                  const double* params, long long g0, long long g1,
                                  long long g2, const WallParams<T, Phys::V>& W,
                                  void* stream) {
  const long long tiles = face_tiles<NN>(order, g0, g1, g2);
  if (tiles == 0) return cudaErrorInvalidValue;
  const auto P = make_params<T, NN, Phys>(ops, dx, 0, params, g0, g1, g2);
  const Shape sh = surface_update_shape<T, Phys, kWalls, NN>();
  const long long blocks = tiles * (NN * NN * NN / FaceTiling<NN>::kUpdate);
  if constexpr (kWalls) {
    aderdg_surface_update_walls<T, NN, Phys>
        <<<static_cast<unsigned>(blocks), sh.block, 0, static_cast<cudaStream_t>(stream)>>>(
            state, fhat, dt_ptr, static_cast<T>(dt_val), P, W);
  } else {
    aderdg_surface_update<T, NN, Phys>
        <<<static_cast<unsigned>(blocks), sh.block, 0, static_cast<cudaStream_t>(stream)>>>(
            state, fhat, dt_ptr, static_cast<T>(dt_val), P);
  }
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

template <typename T, typename Source = NoSource>
int ck_predictor_volume(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                        const double* ops, const double* dx, int order, int physics,
                        const double* params, long long g0, long long g1, long long g2,
                        const T* sigma, void* stream) {
  if (physics != kElasticHet) return cudaErrorInvalidValue;
  return launch_ck_predictor_volume<T, Source>(u, out, faces, dt_ptr, dt_val, ops, dx, order,
                                               params, g0, g1, g2, sigma, stream);
}

template <typename T, typename Phys, int NN = kNN>
int face_flux_of(const T* faces, T* fhat, const double* ops, const double* dx, int order,
                 const double* params, long long g0, long long g1, long long g2, int wall_mask,
                 int wall_mode, const double* wall_table, const T* wall_rows, T* fwall,
                 const long long* wall_off, long long wall_side, const T* visc_rows,
                 void* stream) {
  if (bad_walls(wall_mask, fwall, wall_off) ||
      bad_ghosts(wall_mask, wall_mode, wall_table, wall_rows))
    return cudaErrorInvalidValue;
  // The viscous wall split: the wall fluxes of a viscous physics with walls,
  // and only then.
  if ((visc_rows != nullptr) != (Phys::kViscous && wall_mask != 0)) return cudaErrorInvalidValue;
  const auto W = make_walls<T, Phys::V>(wall_mask, wall_mode, wall_table, wall_rows, fwall,
                                        wall_off, wall_side, visc_rows);
  if (wall_mask == 0)
    return launch_face_flux<T, Phys, false, NN>(faces, fhat, ops, dx, order, params, g0, g1, g2,
                                                W, stream);
  return launch_face_flux<T, Phys, true, NN>(faces, fhat, ops, dx, order, params, g0, g1, g2, W,
                                             stream);
}

template <typename T>
int face_flux(const T* faces, T* fhat, const double* ops, const double* dx,
              int order, int physics, const double* params, long long g0, long long g1,
              long long g2, int wall_mask, int wall_mode, const double* wall_table,
              const T* wall_rows, T* fwall, const long long* wall_off, long long wall_side,
              const T* visc_rows, void* stream) {
  switch (physics) {
    case kEuler:
      return face_flux_of<T, EulerPhysics<T>>(faces, fhat, ops, dx, order, params, g0, g1, g2,
                                              wall_mask, wall_mode, wall_table, wall_rows,
                                              fwall, wall_off, wall_side, visc_rows, stream);
    case kElasticHet:
      return face_flux_of<T, ElasticHetPhysics<T>>(faces, fhat, ops, dx, order, params, g0, g1,
                                                   g2, wall_mask, wall_mode, wall_table,
                                                   wall_rows, fwall, wall_off, wall_side,
                                                   visc_rows, stream);
    case kNavierStokes:
      return face_flux_of<T, NavierStokesPhysics<T>>(faces, fhat, ops, dx, order, params, g0,
                                                     g1, g2, wall_mask, wall_mode, wall_table,
                                                     wall_rows, fwall, wall_off, wall_side,
                                                     visc_rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename Phys, int NN = kNN>
int surface_update_of(T* state, const T* fhat, const T* dt_ptr, double dt_val,
                      const double* ops, const double* dx, int order, const double* params,
                      long long g0, long long g1, long long g2, int wall_mask, const T* fwall,
                      const long long* wall_off, void* stream) {
  if (bad_walls(wall_mask, fwall, wall_off)) return cudaErrorInvalidValue;
  const auto W = make_walls<T, Phys::V>(wall_mask, kMirror, nullptr, nullptr,
                                        const_cast<T*>(fwall), wall_off, 0);
  if (wall_mask == 0)
    return launch_surface_update<T, Phys, false, NN>(state, fhat, dt_ptr, dt_val, ops, dx,
                                                     order, params, g0, g1, g2, W, stream);
  return launch_surface_update<T, Phys, true, NN>(state, fhat, dt_ptr, dt_val, ops, dx, order,
                                                  params, g0, g1, g2, W, stream);
}

template <typename T>
int surface_update(T* state, const T* fhat, const T* dt_ptr, double dt_val, const double* ops,
                   const double* dx, int order, int physics, const double* params,
                   long long g0, long long g1, long long g2, int wall_mask, const T* fwall,
                   const long long* wall_off, void* stream) {
  switch (physics) {
    case kEuler:
    case kNavierStokes:  // the update reads no physics: Euler's instantiation
      return surface_update_of<T, EulerPhysics<T>>(state, fhat, dt_ptr, dt_val, ops, dx, order,
                                                   params, g0, g1, g2, wall_mask, fwall,
                                                   wall_off, stream);
    case kElasticHet:
      return surface_update_of<T, ElasticHetPhysics<T>>(state, fhat, dt_ptr, dt_val, ops, dx,
                                                        order, params, g0, g1, g2, wall_mask,
                                                        fwall, wall_off, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K1 e's launch: the walled pair's grid and block (order 3 only).
template <typename T, typename Phys>
Shape face_flux_exchanged_shape() {
  return {reinterpret_cast<const void*>(aderdg_face_flux_exchanged<T, kNN, Phys>),
          dim3(kTile, kFluxNodes), 0};
}

// K1 e's arguments (see the C interface): a known mode for each side; a
// wall side only on a walled axis, and a walled axis's sides walls or
// exchanged; a plane for each exchanged side; fside and its offsets when a
// low side is not periodic; the ghost tables for the walls.
template <typename T, typename Phys>
int face_flux_exchanged_of(const T* faces, T* fhat, const double* ops, const double* dx,
                           int order, const double* params, long long g0, long long g1,
                           long long g2, int wall_mask, int wall_mode, const double* wall_table,
                           const T* wall_rows, const long long* wall_off, long long wall_side,
                           const int* modes, const T* const* planes, T* fside,
                           const long long* side_off, void* stream) {
  if (modes == nullptr || planes == nullptr || wall_mask < 0 || wall_mask > 7 ||
      bad_ghosts(wall_mask, wall_mode, wall_table, wall_rows) ||
      (wall_mask != 0 && wall_off == nullptr))
    return cudaErrorInvalidValue;
  ExchangeParams<T> X{};
  bool any_lo = false;
  for (int d = 0; d < kDim; ++d) {
    const bool walled = (wall_mask >> d) & 1;
    for (int side = 0; side < 2; ++side) {
      const int mode = modes[2 * d + side];
      if (mode != kPeriodicSide && mode != kWallSide && mode != kExchangedSide)
        return cudaErrorInvalidValue;
      if ((mode == kWallSide) != walled && !(walled && mode == kExchangedSide))
        return cudaErrorInvalidValue;
      if (mode == kExchangedSide && planes[2 * d + side] == nullptr) return cudaErrorInvalidValue;
      X.mode[d][side] = mode;
      X.plane[d][side] = planes[2 * d + side];
    }
    any_lo = any_lo || X.mode[d][0] != kPeriodicSide;
  }
  if (any_lo && (fside == nullptr || side_off == nullptr)) return cudaErrorInvalidValue;
  X.fside = fside;
  for (int d = 0; d < kDim; ++d) X.off[d] = side_off == nullptr ? 0 : side_off[d];
  const long long tiles = face_tiles<kNN>(order, g0, g1, g2);
  if (tiles == 0) return cudaErrorInvalidValue;
  const auto W = make_walls<T, Phys::V>(wall_mask, wall_mode, wall_table, wall_rows, nullptr,
                                        wall_off, wall_side);
  const auto P = make_params<T, kNN, Phys>(ops, dx, 0, params, g0, g1, g2);
  const Shape sh = face_flux_exchanged_shape<T, Phys>();
  const dim3 grid(static_cast<unsigned>(tiles), kDim * kNN * kNN / kFluxNodes);
  aderdg_face_flux_exchanged<T, kNN, Phys>
      <<<grid, sh.block, 0, static_cast<cudaStream_t>(stream)>>>(faces, fhat, P, W, X);
  return cudaGetLastError();
}

// The Euler face stage at orders 4, 5 and 7 (NN = 5, 6, 8), periodic or
// walled: the second and third launches of a step on csrc/aderdg_st.cuh's
// predictor.  The periodic entries pass no walls (mask 0); the walled ones
// take walls only, in every mode (the Euler physics has no viscous planes).
constexpr int kNN4 = 5;
constexpr int kNN5 = 6;
constexpr int kNN7 = 8;

template <typename T, int NN>
int st_face_flux(const T* faces, T* fhat, const double* ops, const double* dx, int order,
                 int physics, const double* params, long long g0, long long g1, long long g2,
                 int wall_mask, int wall_mode, const double* wall_table, const T* wall_rows,
                 T* fwall, const long long* wall_off, long long wall_side, const T* visc_rows,
                 void* stream) {
  if (physics != kEuler) return cudaErrorInvalidValue;
  return face_flux_of<T, EulerPhysics<T>, NN>(faces, fhat, ops, dx, order, params, g0, g1, g2,
                                              wall_mask, wall_mode, wall_table, wall_rows,
                                              fwall, wall_off, wall_side, visc_rows, stream);
}

template <typename T, int NN>
int st_surface_update(T* state, const T* fhat, const T* dt_ptr, double dt_val,
                      const double* ops, const double* dx, int order, int physics,
                      const double* params, long long g0, long long g1, long long g2,
                      int wall_mask, const T* fwall, const long long* wall_off, void* stream) {
  if (physics != kEuler) return cudaErrorInvalidValue;
  return surface_update_of<T, EulerPhysics<T>, NN>(state, fhat, dt_ptr, dt_val, ops, dx, order,
                                                   params, g0, g1, g2, wall_mask, fwall,
                                                   wall_off, stream);
}

// The shapes of the Euler step at NN nodes an axis: `which` 0 the
// predictor (its source's weak query, `info`), 1 the face flux, 2 the
// update, 3 and 4 the walled pair.
template <typename T, int NN>
int st_info(int which, int (*info)(int*), int* out) {
  using E = EulerPhysics<T>;
  switch (which) {
    case 0:
      return info ? info(out) : cudaErrorInvalidValue;
    case 1:
      return shape_info(face_flux_shape<T, E, false, NN>(), out);
    case 2:
      return shape_info(surface_update_shape<T, E, false, NN>(), out);
    case 3:
      return shape_info(face_flux_shape<T, E, true, NN>(), out);
    case 4:
      return shape_info(surface_update_shape<T, E, true, NN>(), out);
    default:
      return cudaErrorInvalidValue;
  }
}

// K2 b's 3-D step: the homogeneous elasticity (physics 7, Elastic3D,
// params = {ρ, λ, μ}) at order 2 (NN = 3), periodic: csrc/aderdg_ck_nodes.cuh's
// CK predictor, a thread a space node, 8 cells a block (216 threads), and
// the face stage's NN = 3 instances.  K2 b.1: the same entries over the
// 12-variable heterogeneous elasticity (physics 1, ElasticHetPhysics: the
// materials frozen in slots 9-11, the mask on the face solves).
constexpr int kNNp2 = 3;
constexpr int kCellsP2 = 8;

template <typename T, typename Phys>
using CkP2Params = Params<T, kNNp2, Phys>;

template <typename T, typename Phys>
int ck_predictor_volume_p2_of(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                              const double* ops, const double* dx, int order,
                              const double* params, long long g0, long long g1, long long g2,
                              void* stream) {
  if (bad_grid<kNNp2>(order, g0, g1, g2)) return cudaErrorInvalidValue;
  const auto P = make_params<T, kNNp2, Phys>(ops, dx, 0, params, g0, g1, g2);
  return launch_ck_nodes<T, kDim, kNNp2, kCellsP2, Phys, CkP2Params<T, Phys>>(
      u, out, faces, dt_ptr, dt_val, P, stream);
}

template <typename T>
int ck_predictor_volume_p2(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                           const double* ops, const double* dx, int order, int physics,
                           const double* params, long long g0, long long g1, long long g2,
                           void* stream) {
  if (physics == kElastic3D)
    return ck_predictor_volume_p2_of<T, Elastic3D<T>>(u, out, faces, dt_ptr, dt_val, ops, dx,
                                                      order, params, g0, g1, g2, stream);
  if (physics == kElasticHet)
    return ck_predictor_volume_p2_of<T, ElasticHetPhysics<T>>(u, out, faces, dt_ptr, dt_val,
                                                              ops, dx, order, params, g0, g1,
                                                              g2, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
int face_flux_p2(const T* faces, T* fhat, const double* ops, const double* dx, int order,
                 int physics, const double* params, long long g0, long long g1, long long g2,
                 void* stream) {
  if (physics == kElastic3D) {
    const WallParams<T, Elastic3D<T>::V> W{};
    return launch_face_flux<T, Elastic3D<T>, false, kNNp2>(faces, fhat, ops, dx, order, params,
                                                          g0, g1, g2, W, stream);
  }
  if (physics == kElasticHet) {
    const WallParams<T, ElasticHetPhysics<T>::V> W{};
    return launch_face_flux<T, ElasticHetPhysics<T>, false, kNNp2>(
        faces, fhat, ops, dx, order, params, g0, g1, g2, W, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int surface_update_p2(T* state, const T* fhat, const T* dt_ptr, double dt_val,
                      const double* ops, const double* dx, int order, int physics,
                      const double* params, long long g0, long long g1, long long g2,
                      void* stream) {
  if (physics == kElastic3D) {
    const WallParams<T, Elastic3D<T>::V> W{};
    return launch_surface_update<T, Elastic3D<T>, false, kNNp2>(
        state, fhat, dt_ptr, dt_val, ops, dx, order, params, g0, g1, g2, W, stream);
  }
  if (physics == kElasticHet) {
    const WallParams<T, ElasticHetPhysics<T>::V> W{};
    return launch_surface_update<T, ElasticHetPhysics<T>, false, kNNp2>(
        state, fhat, dt_ptr, dt_val, ops, dx, order, params, g0, g1, g2, W, stream);
  }
  return cudaErrorInvalidValue;
}

// The shapes of K2 b's 3-D step over `Phys` (kernel 29-31).
template <typename T, typename Phys>
int p2_info(int kernel, int* out) {
  if (kernel == 30) return shape_info(face_flux_shape<T, Phys, false, kNNp2>(), out);
  if (kernel == 31) return shape_info(surface_update_shape<T, Phys, false, kNNp2>(), out);
  return shape_info(ck_nodes_shape<T, kDim, kNNp2, kCellsP2, Phys, CkP2Params<T, Phys>>(), out);
}

template <typename T>
int kernel_info(int kernel, int physics, int* out) {
  const bool euler = physics == kEuler;
  // The 2-D steps', 22-27 and 32; the 2-D Navier–Stokes order-2 step's,
  // 70-74 (predictor, pair, walled pair), and the viscous predictors with
  // the wall planes, 75 (order 3) and 76 (order 2).
  if ((kernel >= 22 && kernel <= 27) || kernel == 32 || (kernel >= 70 && kernel <= 76)) {
    auto* info = sizeof(T) == 8 ? aderdg_2d_kernel_info_f64 : aderdg_2d_kernel_info_f32;
    const int which = kernel == 32   ? 6
                      : kernel < 70  ? kernel - 22
                      : kernel <= 74 ? kernel - 62
                                     : (kernel == 75 ? 7 : 13);
    return info ? info(which, physics, out) : cudaErrorInvalidValue;
  }
  if (kernel >= 29 && kernel <= 31) {  // K2 b's 3-D step, 29-31
    if (physics == kElastic3D) return p2_info<T, Elastic3D<T>>(kernel, out);
    if (physics == kElasticHet) return p2_info<T, ElasticHetPhysics<T>>(kernel, out);
    return cudaErrorInvalidValue;
  }
  const bool f64 = sizeof(T) == 8;
  if (kernel >= 19 && kernel <= 21)  // the order-5 Euler step's, 19-21
    return euler ? st_info<T, kNN5>(kernel - 19, f64 ? st_predictor_info_f64
                                                     : st_predictor_info_f32, out)
                 : cudaErrorInvalidValue;
  if (kernel >= 34 && kernel <= 45) {  // its walled pair, 34-35; orders 4 (36-40), 7 (41-45)
    if (!euler) return cudaErrorInvalidValue;
    if (kernel <= 35) return st_info<T, kNN5>(kernel - 31, nullptr, out);
    if (kernel <= 40)
      return st_info<T, kNN4>(kernel - 36, f64 ? st_predictor_p4_info_f64
                                               : st_predictor_p4_info_f32, out);
    return st_info<T, kNN7>(kernel - 41, f64 ? st_predictor_p7_info_f64
                                             : st_predictor_p7_info_f32, out);
  }
  if (kernel >= 46 && kernel <= 54) {  // the vacuum Z4 per-axis and 2-D kernels, 46-54
    if (physics != kZ4) return cudaErrorInvalidValue;
    if (kernel == 46) {
      auto* info = f64 ? z4_per_axis_info_f64 : z4_per_axis_info_f32;
      return info ? info(out) : cudaErrorInvalidValue;
    }
    auto* info = kernel <= 50 ? (f64 ? z4_2d_info_f64 : z4_2d_info_f32)
                              : (f64 ? z4_2d_p3_info_f64 : z4_2d_p3_info_f32);
    return info ? info((kernel - 47) % 4, out) : cudaErrorInvalidValue;
  }
  if (kernel >= 55 && kernel <= 59) {  // the Z4+GRHD per-axis and 2-D kernels, 55-59
    if (physics != kZ4Matter) return cudaErrorInvalidValue;
    if (kernel == 55) {
      auto* info = f64 ? z4_matter_per_axis_info_f64 : z4_matter_per_axis_info_f32;
      return info ? info(out) : cudaErrorInvalidValue;
    }
    auto* info = f64 ? z4_matter_2d_info_f64 : z4_matter_2d_info_f32;
    return info ? info(kernel - 56, out) : cudaErrorInvalidValue;
  }
  if (kernel >= 60 && kernel <= 64) {  // the Z4+GRMHD per-axis and 2-D kernels, 60-64
    if (physics != kZ4Grmhd) return cudaErrorInvalidValue;
    if (kernel == 60) {
      auto* info = f64 ? z4_grmhd_per_axis_info_f64 : z4_grmhd_per_axis_info_f32;
      return info ? info(out) : cudaErrorInvalidValue;
    }
    auto* info = f64 ? z4_grmhd_2d_info_f64 : z4_grmhd_2d_info_f32;
    return info ? info(kernel - 61, out) : cudaErrorInvalidValue;
  }
  if (kernel >= 65 && kernel <= 69) {  // the shifted per-axis and 2-D kernels, 65-69
    if (physics != kZ4Shift) return cudaErrorInvalidValue;
    if (kernel == 65) {
      auto* info = f64 ? z4_shift_per_axis_info_f64 : z4_shift_per_axis_info_f32;
      return info ? info(out) : cudaErrorInvalidValue;
    }
    auto* info = f64 ? z4_shift_2d_info_f64 : z4_shift_2d_info_f32;
    return info ? info(kernel - 66, out) : cudaErrorInvalidValue;
  }
  if (physics == kZ4) {  // the Z4 step's own three kernels, 7-9
    auto* info = sizeof(T) == 8 ? z4_kernel_info_f64 : z4_kernel_info_f32;
    return info && kernel >= 7 && kernel <= 9 ? info(kernel - 7, out) : cudaErrorInvalidValue;
  }
  if (physics == kZ4Shift) {  // the shifted Z4 step's, 10-12
    auto* info = sizeof(T) == 8 ? z4_shift_kernel_info_f64 : z4_shift_kernel_info_f32;
    return info && kernel >= 10 && kernel <= 12 ? info(kernel - 10, out) : cudaErrorInvalidValue;
  }
  if (physics == kZ4Matter) {  // the Z4+GRHD step's, 13-15
    auto* info = sizeof(T) == 8 ? z4_matter_kernel_info_f64 : z4_matter_kernel_info_f32;
    return info && kernel >= 13 && kernel <= 15 ? info(kernel - 13, out) : cudaErrorInvalidValue;
  }
  if (physics == kZ4Grmhd) {  // the Z4+GRMHD step's, 16-18
    auto* info = sizeof(T) == 8 ? z4_grmhd_kernel_info_f64 : z4_grmhd_kernel_info_f32;
    return info && kernel >= 16 && kernel <= 18 ? info(kernel - 16, out) : cudaErrorInvalidValue;
  }
  if (physics == kNavierStokes) {
    // The viscous predictor, the face flux's own instantiation; the update
    // is Euler's.
    using N = NavierStokesPhysics<T>;
    switch (kernel) {
      case 2:
        return shape_info(face_flux_shape<T, N, false>(), out);
      case 4:
        return shape_info(face_flux_shape<T, N, true>(), out);
      case 3:
      case 5:
        return kernel_info<T>(kernel, kEuler, out);
      case 6:
      case 7: {
        auto* info = sizeof(T) == 8 ? visc_predictor_info_f64 : visc_predictor_info_f32;
        return info ? info(kernel == 7, out) : cudaErrorInvalidValue;
      }
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (physics != kEuler && physics != kElasticHet) return cudaErrorInvalidValue;
  using E = EulerPhysics<T>;
  using H = ElasticHetPhysics<T>;
  switch (kernel) {
    case 0:
      return euler ? shape_info(predictor_shape<T, E>(), out) : cudaErrorInvalidValue;
    case 1:
      return euler ? cudaErrorInvalidValue : shape_info(ck_predictor_shape<T>(), out);
    case 28:
      return euler ? cudaErrorInvalidValue
                   : shape_info(ck_predictor_shape<T, SpongeSource>(), out);
    case 2:
      return shape_info(euler ? face_flux_shape<T, E, false>() : face_flux_shape<T, H, false>(),
                        out);
    case 3:
      return shape_info(euler ? surface_update_shape<T, E, false>()
                              : surface_update_shape<T, H, false>(),
                        out);
    case 4:
      return shape_info(euler ? face_flux_shape<T, E, true>() : face_flux_shape<T, H, true>(),
                        out);
    case 5:
      return shape_info(euler ? surface_update_shape<T, E, true>()
                              : surface_update_shape<T, H, true>(),
                        out);
    case 33:
      return euler ? shape_info(face_flux_exchanged_shape<T, E>(), out) : cudaErrorInvalidValue;
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
// materials) unwritten.  These entries are the order-3 instances; the
// Euler face stage at orders 4, 5 and 7 has entries of its own (_p4, _p5,
// _p7, below).
//
// The face stage's wall variant, face_flux_walls then surface_update_walls
// (the periodic entries' arguments, then these): bit d of wall_mask (not
// 0) marks grid axis d as walled;
// wall_mode 0 = mirror (ghost = sign table times my face), 1 = farfield,
// 2 = dirichlet; wall_table (float64): S_q [3][n_vars], S_f [3][n_vars],
// the farfield state [n_vars]; fwall: the low-wall fluxes [wall axis][n²]
// [n_vars][plane], plane the grid's plane across the axis (my cell with
// i_d dropped, row-major), axis d's block at element wall_off[d];
// wall_rows (dirichlet): the ghost rows in fwall's layout, side 1's at
// element wall_side.  face_flux_walls writes fwall (its zero rows unwritten
// as in fhat), surface_update_walls reads it.  visc_rows (physics 2 only,
// and then required): the viscous-only time-averaged flux of each wall
// axis's first row's low faces and last row's high faces, in wall_rows'
// layout (aderdg_predictor_volume_visc writes it); null otherwise.
//
// physics 2 = 3-D compressible Navier–Stokes (params: gamma, mu,
// max(4/3, gamma/Pr), kappa_T, 2(2N+1)/dx_d for each axis): the face flux
// is its own instantiation (the Gassner penalty, the viscous wall split),
// the update Euler's; its predictor is csrc/aderdg_visc.cu's.

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
                                    params, g0, g1, g2, nullptr, stream);
}

int exahype_aderdg_ck_predictor_volume_f64(const double* u, double* out, double* faces,
                                           const double* dt_ptr, double dt_val,
                                           const double* ops, const double* dx, int order,
                                           int physics, const double* params, long long g0,
                                           long long g1, long long g2, void* stream) {
  return ck_predictor_volume<double>(u, out, faces, dt_ptr, dt_val, ops, dx, order, physics,
                                     params, g0, g1, g2, nullptr, stream);
}

// K2 a, the CK predictor with the absorbing sponge (physics 1 only): the
// entries above, then sigma, the sponge's rate of each cell ([ncell], the
// state's dtype, on the card; not null).
int exahype_aderdg_ck_predictor_volume_sponge_f32(const float* u, float* out, float* faces,
                                                  const float* dt_ptr, double dt_val,
                                                  const double* ops, const double* dx,
                                                  int order, int physics,
                                                  const double* params, long long g0,
                                                  long long g1, long long g2,
                                                  const float* sigma, void* stream) {
  return ck_predictor_volume<float, SpongeSource>(u, out, faces, dt_ptr, dt_val, ops, dx, order,
                                                  physics, params, g0, g1, g2, sigma, stream);
}

int exahype_aderdg_ck_predictor_volume_sponge_f64(const double* u, double* out, double* faces,
                                                  const double* dt_ptr, double dt_val,
                                                  const double* ops, const double* dx,
                                                  int order, int physics,
                                                  const double* params, long long g0,
                                                  long long g1, long long g2,
                                                  const double* sigma, void* stream) {
  return ck_predictor_volume<double, SpongeSource>(u, out, faces, dt_ptr, dt_val, ops, dx,
                                                   order, physics, params, g0, g1, g2, sigma,
                                                   stream);
}

int exahype_aderdg_face_flux_f32(const float* faces, float* fhat,
                                 const double* ops, const double* dx, int order, int physics,
                                 const double* params, long long g0, long long g1, long long g2,
                                 void* stream) {
  return face_flux<float>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2, 0, 0,
                          nullptr, nullptr, nullptr, nullptr, 0, nullptr, stream);
}

int exahype_aderdg_face_flux_f64(const double* faces, double* fhat,
                                 const double* ops, const double* dx, int order, int physics,
                                 const double* params, long long g0, long long g1, long long g2,
                                 void* stream) {
  return face_flux<double>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2, 0, 0,
                           nullptr, nullptr, nullptr, nullptr, 0, nullptr, stream);
}

int exahype_aderdg_surface_update_f32(float* state, const float* fhat, const float* dt_ptr,
                                      double dt_val, const double* ops, const double* dx,
                                      int order, int physics, const double* params,
                                      long long g0, long long g1, long long g2, void* stream) {
  return surface_update<float>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics, params,
                               g0, g1, g2, 0, nullptr, nullptr, stream);
}

int exahype_aderdg_surface_update_f64(double* state, const double* fhat, const double* dt_ptr,
                                      double dt_val, const double* ops, const double* dx,
                                      int order, int physics, const double* params,
                                      long long g0, long long g1, long long g2, void* stream) {
  return surface_update<double>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics, params,
                                g0, g1, g2, 0, nullptr, nullptr, stream);
}

int exahype_aderdg_face_flux_walls_f32(const float* faces, float* fhat, const double* ops,
                                       const double* dx, int order, int physics,
                                       const double* params, long long g0, long long g1,
                                       long long g2, int wall_mask, int wall_mode,
                                       const double* wall_table, const float* wall_rows,
                                       float* fwall, const long long* wall_off,
                                       long long wall_side, const float* visc_rows,
                                       void* stream) {
  if (no_walls(wall_mask)) return cudaErrorInvalidValue;
  return face_flux<float>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2, wall_mask,
                          wall_mode, wall_table, wall_rows, fwall, wall_off, wall_side,
                          visc_rows, stream);
}

int exahype_aderdg_face_flux_walls_f64(const double* faces, double* fhat, const double* ops,
                                       const double* dx, int order, int physics,
                                       const double* params, long long g0, long long g1,
                                       long long g2, int wall_mask, int wall_mode,
                                       const double* wall_table, const double* wall_rows,
                                       double* fwall, const long long* wall_off,
                                       long long wall_side, const double* visc_rows,
                                       void* stream) {
  if (no_walls(wall_mask)) return cudaErrorInvalidValue;
  return face_flux<double>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2, wall_mask,
                           wall_mode, wall_table, wall_rows, fwall, wall_off, wall_side,
                           visc_rows, stream);
}

int exahype_aderdg_surface_update_walls_f32(float* state, const float* fhat,
                                            const float* dt_ptr, double dt_val,
                                            const double* ops, const double* dx, int order,
                                            int physics, const double* params, long long g0,
                                            long long g1, long long g2, int wall_mask,
                                            const float* fwall, const long long* wall_off,
                                            void* stream) {
  if (no_walls(wall_mask)) return cudaErrorInvalidValue;
  return surface_update<float>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics, params,
                               g0, g1, g2, wall_mask, fwall, wall_off, stream);
}

int exahype_aderdg_surface_update_walls_f64(double* state, const double* fhat,
                                            const double* dt_ptr, double dt_val,
                                            const double* ops, const double* dx, int order,
                                            int physics, const double* params, long long g0,
                                            long long g1, long long g2, int wall_mask,
                                            const double* fwall, const long long* wall_off,
                                            void* stream) {
  if (no_walls(wall_mask)) return cudaErrorInvalidValue;
  return surface_update<double>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics, params,
                                g0, g1, g2, wall_mask, fwall, wall_off, stream);
}

// K1 e, the face flux of a rank's window of a sharded grid (physics 0, 3-D
// Euler, at order 3 only): face_flux_walls's arguments but fwall, then
// modes (int [3][2]: 0 periodic, 1 a wall this rank owns, 2 exchanged, of
// each axis's low and high side), planes (pointers [3][2]: for an
// exchanged side the received face row [2 (q, f)][n²][n_vars][plane], the
// low side's from the −d neighbour's last row's high faces, the high
// side's from the +d neighbour's first row's low faces; null elsewhere),
// fside (the first row's low-face fluxes of each axis whose low side is
// not periodic, [axis][n²][n_vars][plane], axis d's block at element
// side_off[d]).  wall_mask marks the solver's walled axes (0: none), whose
// sides are walls or exchanged.  surface_update_walls with wall_mask = the
// axes whose low side is not periodic, fwall = fside and wall_off =
// side_off completes the step.
int exahype_aderdg_face_flux_exchanged_f32(
    const float* faces, float* fhat, const double* ops, const double* dx, int order,
    int physics, const double* params, long long g0, long long g1, long long g2, int wall_mask,
    int wall_mode, const double* wall_table, const float* wall_rows, const long long* wall_off,
    long long wall_side, const int* modes, const float* const* planes, float* fside,
    const long long* side_off, void* stream) {
  if (physics != kEuler) return cudaErrorInvalidValue;
  return face_flux_exchanged_of<float, EulerPhysics<float>>(
      faces, fhat, ops, dx, order, params, g0, g1, g2, wall_mask, wall_mode, wall_table,
      wall_rows, wall_off, wall_side, modes, planes, fside, side_off, stream);
}

int exahype_aderdg_face_flux_exchanged_f64(
    const double* faces, double* fhat, const double* ops, const double* dx, int order,
    int physics, const double* params, long long g0, long long g1, long long g2, int wall_mask,
    int wall_mode, const double* wall_table, const double* wall_rows, const long long* wall_off,
    long long wall_side, const int* modes, const double* const* planes, double* fside,
    const long long* side_off, void* stream) {
  if (physics != kEuler) return cudaErrorInvalidValue;
  return face_flux_exchanged_of<double, EulerPhysics<double>>(
      faces, fhat, ops, dx, order, params, g0, g1, g2, wall_mask, wall_mode, wall_table,
      wall_rows, wall_off, wall_side, modes, planes, fside, side_off, stream);
}

// The Euler face stage at orders 4, 5 and 7 (physics 0 only; order must
// be the entry's): the periodic entries' arguments and layouts at n = 5, 6
// and 8 (face_flux_pN, surface_update_pN), and the wall variant's
// (face_flux_walls_pN, surface_update_walls_pN; visc_rows must be null),
// for the predictor of csrc/aderdg_pN.cu.
#define EXAHYPE_ST_FACE_ENTRIES(ORDER, NN, T, S)                                               \
  int exahype_aderdg_face_flux_##ORDER##_##S(                                                  \
      const T* faces, T* fhat, const double* ops, const double* dx, int order, int physics,   \
      const double* params, long long g0, long long g1, long long g2, void* stream) {         \
    return st_face_flux<T, NN>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2, 0,  \
                               0, nullptr, nullptr, nullptr, nullptr, 0, nullptr, stream);   \
  }                                                                                            \
  int exahype_aderdg_surface_update_##ORDER##_##S(                                             \
      T* state, const T* fhat, const T* dt_ptr, double dt_val, const double* ops,             \
      const double* dx, int order, int physics, const double* params, long long g0,           \
      long long g1, long long g2, void* stream) {                                             \
    return st_surface_update<T, NN>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics,    \
                                    params, g0, g1, g2, 0, nullptr, nullptr, stream);         \
  }                                                                                            \
  int exahype_aderdg_face_flux_walls_##ORDER##_##S(                                            \
      const T* faces, T* fhat, const double* ops, const double* dx, int order, int physics,   \
      const double* params, long long g0, long long g1, long long g2, int wall_mask,          \
      int wall_mode, const double* wall_table, const T* wall_rows, T* fwall,                  \
      const long long* wall_off, long long wall_side, const T* visc_rows, void* stream) {     \
    if (no_walls(wall_mask)) return cudaErrorInvalidValue;                                    \
    return st_face_flux<T, NN>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2,     \
                               wall_mask, wall_mode, wall_table, wall_rows, fwall, wall_off, \
                               wall_side, visc_rows, stream);                                 \
  }                                                                                            \
  int exahype_aderdg_surface_update_walls_##ORDER##_##S(                                       \
      T* state, const T* fhat, const T* dt_ptr, double dt_val, const double* ops,             \
      const double* dx, int order, int physics, const double* params, long long g0,           \
      long long g1, long long g2, int wall_mask, const T* fwall, const long long* wall_off,   \
      void* stream) {                                                                          \
    if (no_walls(wall_mask)) return cudaErrorInvalidValue;                                    \
    return st_surface_update<T, NN>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics,    \
                                    params, g0, g1, g2, wall_mask, fwall, wall_off, stream);  \
  }

EXAHYPE_ST_FACE_ENTRIES(p4, kNN4, float, f32)
EXAHYPE_ST_FACE_ENTRIES(p4, kNN4, double, f64)
EXAHYPE_ST_FACE_ENTRIES(p5, kNN5, float, f32)
EXAHYPE_ST_FACE_ENTRIES(p5, kNN5, double, f64)
EXAHYPE_ST_FACE_ENTRIES(p7, kNN7, float, f32)
EXAHYPE_ST_FACE_ENTRIES(p7, kNN7, double, f64)
#undef EXAHYPE_ST_FACE_ENTRIES

// K2 b, the 3-D homogeneous elasticity at order 2 (physics 7, params = {ρ,
// λ, μ}; order must be 2), periodic: the CK predictor (the CK entries'
// arguments) and the face stage (the periodic entries' arguments) at n = 3;
// faces: [3][4][9][9][cell], fhat: [3][9][9][cell].
int exahype_aderdg_ck_predictor_volume_p2_f32(const float* u, float* out, float* faces,
                                              const float* dt_ptr, double dt_val,
                                              const double* ops, const double* dx, int order,
                                              int physics, const double* params, long long g0,
                                              long long g1, long long g2, void* stream) {
  return ck_predictor_volume_p2<float>(u, out, faces, dt_ptr, dt_val, ops, dx, order, physics,
                                       params, g0, g1, g2, stream);
}

int exahype_aderdg_ck_predictor_volume_p2_f64(const double* u, double* out, double* faces,
                                              const double* dt_ptr, double dt_val,
                                              const double* ops, const double* dx, int order,
                                              int physics, const double* params, long long g0,
                                              long long g1, long long g2, void* stream) {
  return ck_predictor_volume_p2<double>(u, out, faces, dt_ptr, dt_val, ops, dx, order, physics,
                                        params, g0, g1, g2, stream);
}

int exahype_aderdg_face_flux_p2_f32(const float* faces, float* fhat, const double* ops,
                                    const double* dx, int order, int physics,
                                    const double* params, long long g0, long long g1,
                                    long long g2, void* stream) {
  return face_flux_p2<float>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2, stream);
}

int exahype_aderdg_face_flux_p2_f64(const double* faces, double* fhat, const double* ops,
                                    const double* dx, int order, int physics,
                                    const double* params, long long g0, long long g1,
                                    long long g2, void* stream) {
  return face_flux_p2<double>(faces, fhat, ops, dx, order, physics, params, g0, g1, g2, stream);
}

int exahype_aderdg_surface_update_p2_f32(float* state, const float* fhat, const float* dt_ptr,
                                         double dt_val, const double* ops, const double* dx,
                                         int order, int physics, const double* params,
                                         long long g0, long long g1, long long g2,
                                         void* stream) {
  return surface_update_p2<float>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics, params,
                                  g0, g1, g2, stream);
}

int exahype_aderdg_surface_update_p2_f64(double* state, const double* fhat,
                                         const double* dt_ptr, double dt_val,
                                         const double* ops, const double* dx, int order,
                                         int physics, const double* params, long long g0,
                                         long long g1, long long g2, void* stream) {
  return surface_update_p2<double>(state, fhat, dt_ptr, dt_val, ops, dx, order, physics, params,
                                   g0, g1, g2, stream);
}

// out[0..4]: registers per thread, resident blocks per SM, threads per
// block, dynamic shared memory bytes and local (spill) bytes per thread of
// one kernel as its launcher launches it: kernel 0 = predictor_volume,
// 1 = ck_predictor_volume, 2 = face_flux, 3 = surface_update,
// 4 = face_flux_walls, 5 = surface_update_walls, 6 and 7 =
// predictor_volume_visc without and with the wall planes (physics 2: the
// face stage and 6, 7 only); physics 3 (Z4, csrc/aderdg_z4.cu): 7 =
// predictor_volume_z4, 8 = face_flux_z4, 9 = surface_update_z4; physics 4
// (the shifted Z4, csrc/aderdg_z4_shift.cu): 10 = predictor_volume_z4_shift,
// 11 = face_flux_z4_shift, 12 = surface_update_z4_shift; physics 5
// (Z4+GRHD, csrc/aderdg_z4_matter.cu): 13 = predictor_volume_z4_matter, 14 =
// face_flux_z4_matter, 15 = surface_update_z4_matter; physics 6 (Z4+GRMHD,
// csrc/aderdg_z4_grmhd.cu): 16 = predictor_volume_z4_grmhd, 17 =
// face_flux_z4_grmhd, 18 = surface_update_z4_grmhd; physics 0 at order 5:
// 19 = predictor_volume_p5 (csrc/aderdg_p5.cu), 20 = face_flux_p5, 21 =
// surface_update_p5, 34 = face_flux_walls_p5, 35 = surface_update_walls_p5;
// physics 0 at order 4 (csrc/aderdg_p4.cu): 36 = predictor_volume_p4, 37 =
// face_flux_p4, 38 = surface_update_p4, 39 = face_flux_walls_p4, 40 =
// surface_update_walls_p4; at order 7 (csrc/aderdg_p7.cu) the same, 41-45;
// physics 0 in 2-D (csrc/aderdg_2d.cu): 22 =
// predictor_volume_2d, 23 = face_flux_2d, 24 = surface_update_2d, 25 =
// face_flux_walls_2d, 26 = surface_update_walls_2d (physics 8, the 2-D
// elasticity: 23-26 its face stage, 32 = ck_predictor_volume_2d); physics 1:
// 28 = ck_predictor_volume_sponge (K2 a, the CK predictor with the sponge);
// physics 7 (the 3-D homogeneous elasticity at order 2) and physics 1 (the
// heterogeneous one at order 2, K2 b.1): 29 = ck_predictor_volume_p2, 30 =
// face_flux_p2, 31 = surface_update_p2; physics 9 and 10 (the 2-D
// heterogeneous and curvilinear elasticity, K2 b.1): 32 and 23-24, and for
// physics 9 also 25-26; physics 0: 33 = face_flux_exchanged (K1 e, the
// sharded face stage, whose update is 5); physics 3: 46 =
// predictor_volume_per_axis_z4, 47-50 and 51-54 the 2-D steps at orders 2
// and 3 (predictor_volume, face_flux, surface_update,
// predictor_volume_per_axis); physics 5: 55 =
// predictor_volume_per_axis_z4_matter, 56-59 the 2-D step at order 2 in the
// same order; physics 6: 60 = predictor_volume_per_axis_z4_grmhd, 61-64 the
// same; physics 4: 65 = predictor_volume_per_axis_z4_shift, 66-69 the same;
// f64 = 0 or 1.
int exahype_aderdg_kernel_info(int kernel, int f64, int physics, int* out) {
  return f64 ? kernel_info<double>(kernel, physics, out)
             : kernel_info<float>(kernel, physics, out);
}

const char* exahype_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
