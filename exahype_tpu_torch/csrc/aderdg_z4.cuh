// The ADER-DG step of the Z4 systems for Hopper (sm_90a): 3-D, order 2,
// periodic, the fused right-hand side, templated on the system: the
// 38-variable zero-shift one (Z4Vacuum, csrc/z4.cuh), the 53-variable
// shifted one (Z4Shift, csrc/z4_shift.cuh), the 43-variable Z4+GRHD one
// (Z4Matter, csrc/z4_matter.cuh), which also carries a conservative flux on
// its hydro rows (kFlux), and the 47-variable Z4+GRMHD one (Z4Grmhd,
// csrc/z4_grmhd.cuh), the same flux branch on its fluid, field and cleaning
// rows.  The float32 instances and C interface are csrc/aderdg_z4.cu,
// csrc/aderdg_z4_shift.cu, csrc/aderdg_z4_matter.cu and
// csrc/aderdg_z4_grmhd.cu, the float64 ones the same names with _f64.  The
// vacuum system also has the per-axis NCP branch (kPerAxis: the solver
// without rhs_all_fn, make_z4_solver's default) on the 3-D cell,
// csrc/aderdg_z4_per_axis.cu, and its steps on 2-D cells (Z4Cell) at orders
// 2 and 3, fused and per-axis, csrc/aderdg_z4_2d.cu and aderdg_z4_2d_p3.cu;
// the Z4+GRHD system the per-axis branch with its flux on the 3-D cell,
// csrc/aderdg_z4_matter_per_axis.cu (make_z4_matter_solver's default), and
// its order-2 steps on the 2-D cell, fused and per-axis,
// csrc/aderdg_z4_matter_2d.cu; the Z4+GRMHD system the same,
// csrc/aderdg_z4_grmhd_per_axis.cu (make_z4_grmhd_solver's default) and
// csrc/aderdg_z4_grmhd_2d.cu; the shifted system the same,
// csrc/aderdg_z4_shift_per_axis.cu (make_z4_shift_solver's default) and
// csrc/aderdg_z4_shift_2d.cu; each again with an _f64 twin: twenty-six
// sources that nvcc compiles in parallel.
//
// Replaces the TPU kernel exahype_tpu/models/aderdg_pallas.py::
// PallasADERDG.build on a pure-NCP solver with the fused rhs_all_fn: its
// Picard body with rhs_all_fn (:446-463), the source average (:714-719), the
// fused strong-form NCP volume term in the epilogue (:734-743), and the NCP
// face half-fluctuations of the Riemann stage (:286-298); on a solver with
// ncp_fn and source_fn but no rhs_all_fn, the per-axis branch of the Picard
// body (r −= λ_d W_s ncp(q_s, D q_s, d), then + dt W_s source(q_s),
// :441-463) and of the epilogue (−λ_d ncp(q̄, D q̄, d) after the source
// average, :744-752); its kernel body works for any dimension (lam_axes,
// :161).  (On the TPU this
// build never compiled: Mosaic could not take the ~4k-op algebra inside
// the predictor, so the JAX package ran the same evaluations under XLA
// around K5.)  The numbers to match are those of exahype_tpu/models/
// aderdg.py::ADERDGSolver.step on make_z4_solver(..., fused_rhs="soa") and,
// per-axis, fused_rhs=False, in 3-D and 2-D;
// the plain PyTorch version is exahype_tpu_torch/models/aderdg.py::
// ADERDGSolver.{predictor_volume, face_surface} on the port's fused Z4
// solver (the face stage's halves: interface_flux, ncp_half, surface_term,
// ncp_term).
//
// Each kernel below has a _shift twin (aderdg_predictor_volume_z4_shift, ...)
// over the same template body with the 53-variable system, a _matter twin
// with the 43-variable one and a _grmhd twin with the 47-variable one.
//
//   aderdg_predictor_volume_z4  cell-local: the Picard predictor with
//                            rhs_s = φ0_s u + dt w_s rhs(q_s, ∇q_s) (the flux
//                            is zero, so there is no D·F term and no volume
//                            integral), q̄ = Σ_s w_s q_s, the source average
//                            s̄ = Σ_s w_s rhs(q_s, 0) of the final q,
//                            new = u + dt s̄ + dt [rhs(q̄, ∇q̄) − rhs(q̄, 0)],
//                            and the face projections (q_lo, q_hi, f_lo,
//                            f_hi) of every axis, the f rows written as
//                            zeros (the face tensor keeps its layout, so the
//                            kernel and plain stages stay interchangeable;
//                            the zeros go out as full lines, each block a
//                            run of the slab).
//   aderdg_face_flux_z4      the face stage, first launch: per (cell, axis
//                            d, face node) the Rusanov flux with f = 0,
//                            F̂ = −½ s (q⁺ − q_hi), s the larger wave speed
//                            α √(max(g(α), 1) γ^dd) of the two states, into
//                            fhat, and the NCP half-fluctuation
//                            ½ [rhs(q̃, 0) − rhs(q̃, e_d (q⁺ − q_hi))] at
//                            q̃ = ½ (q_hi + q⁺), into fhalf.
//   aderdg_surface_update_z4 the face stage, second launch: per (cell, space
//                            node), axis by axis, new −= λ (φ1/w F̂_hi −
//                            φ0/w F̂_lo), then new −= λ (φ1/w h_hi + φ0/w
//                            h_lo), the _lo values the −d neighbour's
//                            high-face ones, in place.
//
// The per-axis branch (kPerAxis; every system).  Per
// Picard iteration each thread evaluates the algebra G::kAxes + 1 times at
// its point in one code copy, the gradient chosen at run time: the source
// rhs(q, 0), then rhs(q, e_d D_d q) for each axis d, D_d q unscaled as the
// plain version hands it to ncp_fn, so that each ncp_d = rhs(q, 0) − rhs(q, e_d D_d q)
// cancels its gradient-free terms exactly; two more rows [slot][point] of
// shared memory hold the source and the running sum φ0 u − Σ_d λ_d w ncp_d,
// and the last pass writes the sum + dt w source in place of q.  The
// epilogue's G::kAxes + 1 evaluations at q̄ go to the slices' threads in
// turn (E_0 = rhs(q̄, 0), E_{d+1} = rhs(q̄, e_d D_d q̄)), and new = u + dt s̄
// − Σ_d λ_d (E_0 − E_{d+1}).  A step is the same three launches: the face
// stage does not depend on how the predictor splits the algebra.  With a
// flux (Z4+GRHD, Z4+GRMHD) the branch keeps the flux rows of the fused variant below
// (rows [axis][hydro row][point] after the per-axis rows): each point
// recovers its primitives once an iteration (Z4Eval), writes its flux rows
// and, after a barrier, runs its G::kAxes + 1 evaluations on that one
// recovery, pass d + 1 subtracting λ_d w_s (D·F_d) on the hydro rows before
// the axis's NCP term as the plain version orders them; the epilogue's
// evaluations at q̄ share one recovery a thread, and new gains each axis's
// volume integral λ_d Kvol·F̄_d before its NCP term.  The shifted system's
// gradient rows skip β's slots (Sys::row_offset, Sys::slot_skip), so each
// pass reads D_d q of the slots the algebra reads through the same maps as
// the fused branch.
//
// The 2-D cells.  The same kernels over Z4Cell<2, N>: a cell's N² nodes and
// N³ points, the gradients of two axes (the algebra's third is a
// compile-time zero), the face stage tiled over the grid (1, g0, g1), and as
// many cells a block as the shared memory and the register file take
// (z4_cells_per_block).
//
// What bounds them on the H100.  One evaluation of the 38-variable algebra
// is ~3,900 arithmetic operations (chip_smoke.py::z4_point_ops; the shifted
// one ~1.6 times that), and the predictor
// makes 378 a cell and step (3 Picard iterations x 81 space-time points,
// 81 for the source average, 54 for the NCP volume term): ~1.5e6
// operations against ~24 KB of device memory a cell in float32, ~60 per
// byte, so operations bound it.  The face stage makes 2 evaluations a
// face node (27 a cell) against ~33 KB a cell, ~3 per byte: bytes bound it.
//
// Design of the predictor.  One thread per space-time point (cell, time
// slice s, space node), CB cells a block (81 CB threads).  The algebra's
// own live values set the register count (168-255 a thread), so a block is
// the only one on its SM, and its CB is as large as the shared memory
// allows (z4_cells_per_block): 4 cells (324 threads, 11 warps) in float32,
// 2 in float64; shifted and Z4+GRMHD, 3 and 1.  A cell's space-time array
// (81 x V) cannot live in registers; it lives in shared memory, with u and
// the physical gradients of the slots the algebra reads (∂α and ∂γ_ij never
// appear: 31 slots an axis; shifted, also ∂b and ∂B, never ∂β: 43), each
// row [slot][point] contiguous over the block's points, so the threads of a
// warp read consecutive words.  A Picard iteration is three phases
// between barriers: (1) each thread takes the gradients of its point
// (3-point contractions with D along each axis, scaled by 1/dx_k after the
// contraction, see z4_gradient), once, instead of the ~440 times the
// algebra reads them; (2) each thread evaluates the algebra at its
// point and writes φ0_s u + dt w_s rhs in place of its q (the algebra reads
// every state slot before it writes one, and no other thread reads that
// point in this phase); (3) q ← K1inv rhs, one (node, slot) a thread, all
// three slices in registers.  The epilogue reuses the gradient rows for
// q̄, ∇q̄ and the two NCP evaluations: the source evaluations rhs(q_s, 0)
// (their zero gradients compile away) run on every point, rhs(q̄, ∇q̄) on
// the threads of slice 0 and rhs(q̄, 0) on those of slice 1.  Device memory
// is read and written in another mapping, the block's cells fastest.  Shared
// memory: 186,192 B a block in either type (shifted: 194,076 B in float32,
// 129,384 B in float64; Z4+GRMHD: 177,552 B and 118,368 B).
//
// The NCP terms are differences of two evaluations, rhs(q, g) − rhs(q, 0),
// kept as the reference makes them.  The plain version runs the same
// operations for both, so their gradient-free terms (~25 in size here)
// round alike and cancel exactly; two code copies with the zero gradient
// compiled away in one would round them differently and leave float32
// noise of that size's rounding in a term of ~1e-2.  So each such pair runs
// one code copy, the zero gradient given at run time.
//
// Design of the face stage.  One thread per (cell, axis, face node), a warp
// a block over 32 consecutive cells of a row (coalesced loads, the
// neighbour from the tile's coordinates, csrc/aderdg_common.cuh::TileCell);
// the axis is dispatched to compile-time axes so that the one-direction
// gradient's two other rows compile away.  q̃, Δq and rhs(q̃, 0) wait in
// the thread's own words of shared memory while the second evaluation runs.
// The update is the Euler update's shape with the NCP term added.
//
// The conservative-flux variant (Z4Matter; the Pallas body's flux_fn beside
// rhs_all_fn, :440-463, the volume integral of F̄, :744-750, and the
// Rusanov flux with f ≠ 0 next to the NCP halves, :286-298).  Phase (2)
// splits in two around a barrier: (2a) each thread recovers the fluid's
// primitives at its point once (csrc/z4_matter.cuh::recover, the con2prim
// Newton in it) and writes the flux of its 5 hydro rows along all 3 axes
// into rows of their own (15 a point: 53,568 B a cell in float32 with the
// rest, so still 4 cells a block, 2 in float64); (2b) the algebra runs on
// the same recovery, held in registers across the barrier, and the hydro
// rows' right-hand sides become φ0 u − Σ_d λ_d w_s (D·F_d) + dt w_s rhs,
// the D·F contractions read along the thread's pencils, in the plain
// version's order (the Z4 rows' F is zero, so theirs are the fluxless
// ones).  The epilogue's source pass also writes F_d(q_s); after a barrier
// F̄_d = Σ_s w_s F_d(q_s) replaces slice 0's flux rows, and new gains λ_d
// Kvol·F̄_d on the hydro rows and the face tensor F̄'s projections on them
// (zero rows elsewhere, written with the q rows, not as slabs).  The face
// flux kernel adds ½ (f_hi + f⁺) on the hydro rows and makes the recovery
// at q̃ once for both NCP evaluations.  The recovery and its Newton are one
// code copy each a thread and phase, so a cancelling pair sees the same
// matter terms and they cancel exactly.
//
// IEEE division and square root (no fast math; the gradient's division by
// dx is a product with its reciprocal, see z4_gradient); nvcc contracts
// a·b + c into fused multiply-adds, so the kernels differ from the plain
// version by rounding only.  No atomics: the step is bitwise deterministic.
#pragma once

#include <cuda_runtime.h>

#include "aderdg_common.cuh"
#include "z4.cuh"
#include "z4_grmhd.cuh"
#include "z4_matter.cuh"
#include "z4_shift.cuh"

namespace {

constexpr int kZ4N = 3;  // order 2: nodes an axis of the 3-D cell
// The shared memory a block may take (227 KB on an H100).
constexpr size_t kZ4SmemLimit = 232448;

// The cell a kernel instance takes: DIM axes of N nodes (order N − 1), its
// nodes and face nodes numbered row-major as the solver numbers them.  The
// 3-D order-2 cell (Z4Cell3) is every system's; the 2-D cells at orders 2
// and 3 are the vacuum system's, and at order 2 also every other
// system's.  The face
// stage tiles the grid's last axis (csrc/aderdg_common.cuh::TileCell), so a
// 2-D grid (g0, g1) goes to it as the 3-D grid (1, g0, g1): grid axis d is
// the tiling's axis kAxis0 + d.
// The algebra stays 3-D: a 2-D cell's third gradient is a compile-time zero.
template <int DIM, int N>
struct Z4Cell {
  static constexpr int kAxes = DIM;
  static constexpr int kN = N;
  static constexpr int kFaces = DIM == 3 ? N * N : N;  // face nodes of an axis
  static constexpr int kNodes = N * kFaces;            // space nodes of a cell
  static constexpr int kPoints = N * kNodes;           // space-time points of a cell
  static constexpr int kAxis0 = 3 - DIM;
  // Face-stage blocks: one tile of kTile cells of one (axis, face node); the
  // update's blocks take kUpdateNodes space nodes of one tile.
  static constexpr int kUpdateNodes = DIM == 3 ? 9 : kNodes;
  // The node stride of axis k within a cell's nodes, and a node's digit.
  static __device__ __forceinline__ int stride(int k) {
    if constexpr (DIM == 3) {
      return k == 0 ? N * N : (k == 1 ? N : 1);
    } else {
      return k == 0 ? N : 1;
    }
  }
  static __device__ __forceinline__ int digit(int node, int k) {
    if constexpr (DIM == 3) {
      return k == 0 ? node / (N * N) : (k == 1 ? (node / N) % N : node % N);
    } else {
      return k == 0 ? node / N : node % N;
    }
  }
  // The first node (digit 0 along d) of the row along d through face node
  // fm, whose digits are the other axes' in order.
  static __device__ __forceinline__ int face_base(int d, int fm) {
    if constexpr (DIM == 3) {
      return d == 0 ? fm : (d == 1 ? (fm / N) * (N * N) + fm % N : fm * N);
    } else {
      return d == 0 ? fm : fm * N;
    }
  }
  // The face node of axis d's faces on which the node of digits ix lies.
  static __device__ __forceinline__ int face_node(const int (&ix)[DIM], int d) {
    if constexpr (DIM == 3) {
      return d == 0 ? ix[1] * N + ix[2] : (d == 1 ? ix[0] * N + ix[2] : ix[0] * N + ix[1]);
    } else {
      return d == 0 ? ix[1] : ix[0];
    }
  }
};
using Z4Cell3 = Z4Cell<3, kZ4N>;

// x[k] of a per-axis array, k a thread-dependent axis (a chain of selects,
// no dynamic index into registers).
template <typename T, int A>
__device__ __forceinline__ T z4_axis_value(const T (&x)[A], int k) {
  if constexpr (A == 3) {
    return k == 0 ? x[0] : (k == 1 ? x[1] : x[2]);
  } else {
    return k == 0 ? x[0] : x[1];
  }
}

// A system the kernels compile in: its variable count kVars, its physics id
// in the C interface, the slots whose gradients its algebra reads (rows
// 0..kGradSlots-1 in slot order from kGradFirst: reads_grad says whether a
// slot has one, slot v's row is v - row_offset(v), row r's slot is
// kGradFirst + r + slot_skip(kGradFirst + r); the 38-variable system's
// offsets are constants, so its kernels index as they did before
// templating, to the instruction), its parameters (from the C interface's
// params array, and their check), its right-hand side and its wave speed.
//
// The 38-variable zero-shift system: the algebra reads the gradients of
// slots kK..37 only (31 an axis).
struct Z4Vacuum {
  static constexpr int kVars = z4::kVars;
  static constexpr int kPhysics = kZ4;
  static constexpr bool kFlux = false;
  static constexpr int kHydro = 0;  // rows with a flux
  static constexpr int kGradFirst = z4::kK;
  static constexpr int kGradSlots = kVars - kGradFirst;
  using P = z4::Params;
  static __host__ __device__ constexpr bool reads_grad(int) { return true; }
  static __host__ __device__ constexpr int row_offset(int) { return kGradFirst; }
  static __host__ __device__ constexpr int slot_skip(int) { return 0; }
  static P make(const double* params) {
    return {static_cast<int>(params[0]), params[1], params[2], params[3], params[4]};
  }
  static bool bad(const double* params) { return params[0] != 0.0 && params[0] != 1.0; }
  template <typename T, typename LoadQ, typename LoadDQ, typename Store>
  static __device__ __forceinline__ void rhs(const LoadQ& q, const LoadDQ& dq, const P& p,
                                             const Store& out) {
    z4::rhs<T>(q, dq, p, out);
  }
  template <typename T>
  static __device__ __forceinline__ T wave_speed(const T* q, int d, const P& p) {
    return z4::wave_speed<T>(q, d, p);
  }
};

// The 53-variable shifted system: the core's 31 gradient slots an axis, then
// b^i and B_k^i (slots 41-52; ∂β never appears): 43.
struct Z4Shift {
  static constexpr int kVars = z4s::kVars;
  static constexpr int kPhysics = kZ4Shift;
  static constexpr bool kFlux = false;
  static constexpr int kHydro = 0;
  static constexpr int kGradFirst = z4::kK;
  static constexpr int kGradSlots = z4s::kBeta - kGradFirst + kVars - z4s::kB;
  using P = z4s::Params;
  static __host__ __device__ constexpr bool reads_grad(int v) {
    return v < z4s::kBeta || v >= z4s::kB;
  }
  static __host__ __device__ constexpr int row_offset(int v) {
    return v < z4s::kBeta ? kGradFirst : kGradFirst + (z4s::kB - z4s::kBeta);
  }
  static __host__ __device__ constexpr int slot_skip(int v) {
    return v < z4s::kBeta ? 0 : z4s::kB - z4s::kBeta;
  }
  static P make(const double* params) {
    return {Z4Vacuum::make(params), static_cast<int>(params[5]), params[6], params[7]};
  }
  static bool bad(const double* params) {
    return Z4Vacuum::bad(params) || (params[5] != 0.0 && params[5] != 1.0);
  }
  template <typename T, typename LoadQ, typename LoadDQ, typename Store>
  static __device__ __forceinline__ void rhs(const LoadQ& q, const LoadDQ& dq, const P& p,
                                             const Store& out) {
    z4s::rhs<T>(q, dq, p, out);
  }
  template <typename T>
  static __device__ __forceinline__ T wave_speed(const T* q, int d, const P& p) {
    return z4s::wave_speed<T>(q, d, p);
  }
};

// The 43-variable Z4+GRHD system: a conservative flux (kFlux) on the kHydro
// hydro rows from kFluxFirst on, besides the NCP; the algebra reads the
// core's 31 gradient slots an axis (the matter terms read none).  Its
// recovery (z4m::recover) is made once a point and shared by the flux and
// the algebra (csrc/z4_matter.cuh).
struct Z4Matter {
  static constexpr int kVars = z4m::kVars;
  static constexpr int kPhysics = kZ4Matter;
  static constexpr bool kFlux = true;
  static constexpr int kFluxFirst = z4m::kHD;
  static constexpr int kHydro = z4m::kHydro;
  static constexpr int kGradFirst = z4::kK;
  static constexpr int kGradSlots = z4::kVars - kGradFirst;
  using P = z4m::Params;
  template <typename T>
  using Rec = z4m::Recovered<T>;
  static __host__ __device__ constexpr bool reads_grad(int v) { return v < z4::kVars; }
  static __host__ __device__ constexpr int row_offset(int) { return kGradFirst; }
  static __host__ __device__ constexpr int slot_skip(int) { return 0; }
  // params: the zero-shift system's five, then Γ and the recovery's Newton
  // iterations (a whole number, at least 0).
  static P make(const double* params) {
    return {Z4Vacuum::make(params), params[5], static_cast<int>(params[6])};
  }
  static bool bad(const double* params) {
    return Z4Vacuum::bad(params) || !(params[6] >= 0.0) || params[6] > 1e6 ||
           params[6] != static_cast<double>(static_cast<int>(params[6]));
  }
  template <typename T, typename LoadQ>
  static __device__ __forceinline__ Rec<T> recover(const LoadQ& q, const P& p) {
    return z4m::recover<T>(q, p);
  }
  // The hydro flux row r (0..kHydro-1) along axis d.
  template <typename T>
  static __device__ __forceinline__ T flux(const Rec<T>& rec, int d, int r) {
    return z4m::flux<T>(rec, d, r);
  }
  template <typename T, typename LoadQ, typename LoadDQ, typename Store>
  static __device__ __forceinline__ void rhs(const LoadQ& q, const LoadDQ& dq, const P& p,
                                             const Rec<T>& rec, const Store& out) {
    z4m::rhs<T>(q, dq, p, rec, out);
  }
  template <typename T>
  static __device__ __forceinline__ T wave_speed(const T* q, int d, const P& p) {
    return z4m::wave_speed<T>(q, d, p);
  }
};

// The 47-variable Z4+GRMHD system: the template's conservative-flux branch
// as Z4Matter takes it, on the kHydro = 9 rows of the fluid, the field and
// the cleaning scalar; its recovery (z4gm::recover, the field-aligned
// Newton of csrc/rmhd.cuh in it) is made once a point and shared by the
// flux and the algebra (csrc/z4_grmhd.cuh).
struct Z4Grmhd {
  static constexpr int kVars = z4gm::kVars;
  static constexpr int kPhysics = kZ4Grmhd;
  static constexpr bool kFlux = true;
  static constexpr int kFluxFirst = z4gm::kHD;
  static constexpr int kHydro = z4gm::kHydro;
  static constexpr int kGradFirst = z4::kK;
  static constexpr int kGradSlots = z4::kVars - kGradFirst;
  using P = z4gm::Params;
  template <typename T>
  using Rec = z4gm::Recovered<T>;
  static __host__ __device__ constexpr bool reads_grad(int v) { return v < z4::kVars; }
  static __host__ __device__ constexpr int row_offset(int) { return kGradFirst; }
  static __host__ __device__ constexpr int slot_skip(int) { return 0; }
  // params: Z4Matter's seven, then c_h and the GLM damping κ.
  static P make(const double* params) {
    return {Z4Vacuum::make(params), params[5], static_cast<int>(params[6]), params[7],
            params[8]};
  }
  static bool bad(const double* params) { return Z4Matter::bad(params); }
  template <typename T, typename LoadQ>
  static __device__ __forceinline__ Rec<T> recover(const LoadQ& q, const P& p) {
    return z4gm::recover<T>(q, p);
  }
  // The matter flux row r (0..kHydro-1) along axis d.
  template <typename T>
  static __device__ __forceinline__ T flux(const Rec<T>& rec, int d, int r) {
    return z4gm::flux<T>(rec, d, r);
  }
  template <typename T, typename LoadQ, typename LoadDQ, typename Store>
  static __device__ __forceinline__ void rhs(const LoadQ& q, const LoadDQ& dq, const P& p,
                                             const Rec<T>& rec, const Store& out) {
    z4gm::rhs<T>(q, dq, p, rec, out);
  }
  template <typename T>
  static __device__ __forceinline__ T wave_speed(const T* q, int d, const P& p) {
    return z4gm::wave_speed<T>(q, d, p);
  }
};

// The system's parameters as the kernels take them (make_params's physics).
template <typename T, typename Sys>
struct Z4Physics {
  typename Sys::P p;
  static Z4Physics make(const double* params) { return {Sys::make(params)}; }
};

template <typename T, typename Sys, int N = kZ4N>
using Z4Params = Params<T, N, Z4Physics<T, Sys>>;

// The predictor's shared memory, in values of T: u [slot][node], q (its
// right-hand sides in place) [slot][point], and the gradient rows
// [axis][row of slot][point], which the epilogue reuses for q̄ [slot][node],
// ∇q̄ [axis][row of slot][node] and the NCP terms' two evaluations
// [slot][node] each; then the rows X; with a flux (Sys::kFlux), then its
// rows [axis][hydro row][point] (from kFOff), which the epilogue reuses for
// F̄ (at the points of slice 0).  The per-axis branch (kPerAxis) takes two
// rows [slot][point] as X, the source and the running sum of a Picard
// iteration; its epilogue keeps its G::kAxes + 1 evaluations
// [evaluation][slot][node] from the fused pair's place on, into them.  The
// fused branch has no X unless its epilogue overruns the gradient rows
// (the 2-D Z4+GRHD cell: 43 slots against 31 gradient rows an axis), and
// then X is the overrun.

template <int CB, typename Sys, typename G = Z4Cell3, bool kPerAxis = false>
struct Z4Smem {
  static constexpr int V = Sys::kVars;
  static constexpr int GS = Sys::kGradSlots;
  static constexpr int kPts = CB * G::kPoints;
  static constexpr int kNodes = CB * G::kNodes;
  static constexpr int kU = V * kNodes;
  static constexpr int kQ = V * kPts;
  static constexpr int kG = G::kAxes * GS * kPts;
  static constexpr int kQbar = 0;                                    // offsets in G
  static constexpr int kGbar = kQbar + V * kNodes;
  static constexpr int kNcpA = kGbar + G::kAxes * GS * kNodes;
  static constexpr int kNcpB = kNcpA + V * kNodes;
  static constexpr int kF = G::kAxes * Sys::kHydro * kPts;
  static constexpr int kEpilogue = kNcpA + (kPerAxis ? G::kAxes + 1 : 2) * V * kNodes;
  static constexpr int kOverrun = kEpilogue > kG ? kEpilogue - kG : 0;
  static constexpr int kX =
      kPerAxis ? (2 * V * kPts > kOverrun ? 2 * V * kPts : kOverrun) : kOverrun;  // after G
  static constexpr int kFOff = kG + kX;  // the flux rows, after X
  static_assert(kEpilogue <= kG + kX, "the epilogue fits the gradient rows and X");
  static constexpr int kTotal = kU + kQ + kG + kX + kF;
};

// Cells a predictor block, the block the only one on its SM: as many as
// the shared memory admits, and at most 384 threads in float32 (256 in
// float64), so that ptxas may give the algebra 168 registers (255) a thread;
// no 3-D fused instance reaches that cap.  38 variables: 46,548 B a cell in
// float32 and 93,096 in float64, so 4 and 2; at 4 (324 threads) ptxas fits
// the float32 algebra in 168 registers without spills, and the kernel ran 6
// % faster than at 3 cells and 204 registers (H100 80GB HBM3, 700 W;
// PERF.md).  Shifted: 64,692 B and 129,384 B, so 3 and 1.  Z4+GRHD: 48,708 B
// a cell and the 15 flux rows, 4,860 B: 53,568 B in float32 and 107,136 B in
// float64, so 4 and 2.  Z4+GRMHD: 47 variables and 27 flux rows, 14,796
// values a cell: 59,184 B in float32 and 118,368 B in float64, so 3 (243
// threads) and 1.  The 3-D per-axis branch: 71,172 B a cell in float32, so
// 3, and 1 in float64; Z4+GRHD's, with the flux rows, 81,432 B, so 2 (162
// threads), and 1 in float64.  2-D, order 2 (27 points a cell): 14 cells (378
// threads) and 9, per-axis 11 and 5; order 3 (64 points): 6 and 4, per-axis
// 4 and 2.  2-D Z4+GRHD, order 2: 14,148 B a cell (X the epilogue's
// overrun, 45 values), so 14 (378 threads) and 8; per-axis 23,256 B, so 9
// (243 threads) and 4.  Z4+GRMHD per-axis on the 3-D cell: 89,640 B a cell
// in float32, so 2 (162 threads), and 1 in float64; on the 2-D cell, order
// 2: 16,020 B (X the overrun, 153 values), so 14 and 7; per-axis 25,560 B,
// so 9 and 4.  Shifted per-axis on the 3-D cell: 99,036 B a cell in float32
// (X the two rows, 8,586 values), so 2 (162 threads), and 1 in float64; on
// the 2-D cell, order 2: 16,920 B (no overrun), so 13 (351 threads) and 6;
// per-axis 28,368 B, so 8 (216 threads) and 4.
template <typename T, typename Sys, typename G = Z4Cell3, bool kPerAxis = false>
constexpr int z4_cells_per_block() {
  constexpr int smem =
      static_cast<int>(kZ4SmemLimit / (Z4Smem<1, Sys, G, kPerAxis>::kTotal * sizeof(T)));
  constexpr int threads = (sizeof(T) == 8 ? 256 : 384) / G::kPoints;
  return smem < threads ? smem : threads;
}

template <typename T, typename Sys, typename G = Z4Cell3, bool kPerAxis = false>
constexpr size_t z4_predictor_smem() {
  return static_cast<size_t>(
             Z4Smem<z4_cells_per_block<T, Sys, G, kPerAxis>(), Sys, G, kPerAxis>::kTotal) *
         sizeof(T);
}

// Σ_j m_j x_j along a row of nodes stride `st` apart, x pointing at the
// node whose digit is ik, the sum started from the first term: D·F (the
// flux's derivative in reference coordinates), D·q (the per-axis NCP's
// gradient), Kvol·F̄, the face projections of F̄ and, with ik = 0, the
// 2-D cells' time averages (st the slice stride).
//
// Here and below, the 3-D cell (N = 3) keeps the expressions it had before
// the cell was a template parameter: a loop over N, equal in value, changes
// the fused instances' machine code (their outputs keep their bits).
template <typename T, int N>
__device__ __forceinline__ T z4_contract(const T (&mrow)[N], const T* x, int ik, int st) {
  const T* x0 = x - ik * st;
  if constexpr (N == 3) {
    return mrow[0] * x0[0] + mrow[1] * x0[st] + mrow[2] * x0[2 * st];
  } else {
    T s = mrow[0] * x0[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s = s + mrow[j] * x0[j * st];
    return s;
  }
}

// The physical gradient along axis k at a node (its digit ik along k) of a
// row of nodes stride `st` apart, x pointing at the node:
// (Σ_j D[ik][j] x_j) · (1/dx_k).  The plain version divides by dx_k; the
// reciprocal moves the rounding by at most one unit in the last place (none
// where dx is a power of two), and an IEEE division here, taken ~290 times a
// thread and step, cost 14 % of the predictor on states after a step and 33
// % on the exact gauge wave, whose zero slots send it down its slow path
// (H100 80GB HBM3, 700 W; PERF.md, scripts/torch_z4_ab.py).  inv_dx is
// T(1) / dx_k.
template <typename T, int N>
__device__ __forceinline__ T z4_gradient(const T (&drow)[N], const T* x, int ik, int st,
                                         T inv_dx) {
  if constexpr (N == 3) {
    const T* x0 = x - ik * st;
    return (drow[0] * x0[0] + drow[1] * x0[st] + drow[2] * x0[2 * st]) * inv_dx;
  } else {
    return z4_contract<T, N>(drow, x, ik, st) * inv_dx;
  }
}

// One point's evaluations of the algebra: a flux system's share the
// recovery made when the object is built (Sys::recover, the con2prim Newton
// in it, once a point: the evaluations of a cancelling pair then see the
// same matter terms, and they cancel exactly); a fluxless system has none.
template <typename T, typename Sys, bool = Sys::kFlux>
struct Z4Eval {
  template <typename LoadQ>
  __device__ __forceinline__ Z4Eval(const LoadQ&, const typename Sys::P&) {}
  template <typename LoadQ, typename LoadDQ, typename Store>
  __device__ __forceinline__ void rhs(const LoadQ& q, const LoadDQ& dq, const typename Sys::P& p,
                                      const Store& out) const {
    Sys::template rhs<T>(q, dq, p, out);
  }
};

template <typename T, typename Sys>
struct Z4Eval<T, Sys, true> {
  typename Sys::template Rec<T> rec;
  template <typename LoadQ>
  __device__ __forceinline__ Z4Eval(const LoadQ& q, const typename Sys::P& p)
      : rec(Sys::template recover<T>(q, p)) {}
  template <typename LoadQ, typename LoadDQ, typename Store>
  __device__ __forceinline__ void rhs(const LoadQ& q, const LoadDQ& dq, const typename Sys::P& p,
                                      const Store& out) const {
    Sys::template rhs<T>(q, dq, p, rec, out);
  }
};

// Row k of a per-axis array of rows, k a thread-dependent axis.
template <typename T, int A, int N>
__device__ __forceinline__ void z4_axis_row(const T (&rows)[A][N], int k, T (&out)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if constexpr (A == 3) {
      out[j] = k == 0 ? rows[0][j] : (k == 1 ? rows[1][j] : rows[2][j]);
    } else {
      out[j] = k == 0 ? rows[0][j] : rows[1][j];
    }
  }
}

template <typename T, int CB, typename Sys, typename G = Z4Cell3, bool kPerAxis = false>
__global__ void __launch_bounds__(CB * G::kPoints, 1)
aderdg_predictor_volume_z4(const T* __restrict__ u, T* __restrict__ out, T* __restrict__ faces,
                           const T* __restrict__ dt_ptr, T dt_val,
                           const Z4Params<T, Sys, G::kN> P) {
  using S = Z4Smem<CB, Sys, G, kPerAxis>;
  constexpr int V = Sys::kVars;
  constexpr int GS = Sys::kGradSlots;
  constexpr int N = G::kN;
  constexpr int NT = CB * G::kPoints;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sU = reinterpret_cast<T*>(smem_raw);
  T* sQ = sU + S::kU;
  T* sG = sQ + S::kQ;

  const long long ncell = P.ncell;
  const long long cell0 = static_cast<long long>(blockIdx.x) * CB;
  const T dtv = dt_ptr != nullptr ? *dt_ptr : dt_val;

  // u into shared memory, and into q for every time slice (the first
  // iteration's q is u broadcast over time); the block's cells fastest.  All
  // of a thread's loads are issued before any is used, so that their
  // latencies overlap (8 warps an SM hide little of one).
  {
    constexpr int kLoads = (S::kU + NT - 1) / NT;
    T x[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = threadIdx.x + i * NT;
      if (e < S::kU) {
        const int c = e % CB, r = e / CB;  // r = node * V + v
        const long long cell = cell0 + c < ncell ? cell0 + c : ncell - 1;  // ragged tail: clamp
        x[i] = u[static_cast<long long>(r) * ncell + cell];
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = threadIdx.x + i * NT;
      if (e < S::kU) {
        const int c = e % CB, r = e / CB;
        const int node = r / V, v = r - node * V;
        sU[v * S::kNodes + c * G::kNodes + node] = x[i];
#pragma unroll
        for (int s = 0; s < N; ++s) {
          sQ[v * S::kPts + c * G::kPoints + s * G::kNodes + node] = x[i];
        }
      }
    }
  }

  // My point: cell c, time slice s, space node `node`.
  const int pt = threadIdx.x;
  const int c = pt / G::kPoints;
  const int s = (pt - c * G::kPoints) / G::kNodes;
  const int node = pt - c * G::kPoints - s * G::kNodes;
  const int cn = c * G::kNodes + node;  // my node among the block's nodes
  T drow[G::kAxes][N];                  // D's row of my digit along each axis
#pragma unroll
  for (int k = 0; k < G::kAxes; ++k) select_row<T, N>(P.D, G::digit(node, k), drow[k]);
  T inv_dx[G::kAxes];
#pragma unroll
  for (int k = 0; k < G::kAxes; ++k) inv_dx[k] = T(1) / P.dx[k];
  const T phi0_s = select<T, N>(P.PHI0, s);
  const T dtw = dtv * select<T, N>(P.W, s);
  const typename Sys::P zp = P.phys.p;
  __syncthreads();

  // Picard: q ← K1inv (φ0 u + dt w rhs(q, ∇q)); per-axis, q ← K1inv (φ0 u −
  // Σ_d λ_d w ncp_d(q, D_d q) + dt w source(q)).
  for (int it = 0; it < P.picard_iters; ++it) {
    // (1) the gradients of my point (per-axis: D·q unscaled, as the plain
    // version hands them to ncp_fn; λ_d scales the product).
#pragma unroll
    for (int k = 0; k < G::kAxes; ++k) {
      const int ik = G::digit(node, k), st = G::stride(k);
#pragma unroll 1
      for (int v = Sys::kGradFirst; v < V; ++v) {
        if (!Sys::reads_grad(v)) continue;
        if constexpr (kPerAxis) {
          sG[(k * GS + v - Sys::row_offset(v)) * S::kPts + pt] =
              z4_contract<T>(drow[k], sQ + v * S::kPts + pt, ik, st);
        } else {
          sG[(k * GS + v - Sys::row_offset(v)) * S::kPts + pt] =
              z4_gradient<T>(drow[k], sQ + v * S::kPts + pt, ik, st, inv_dx[k]);
        }
      }
    }
    __syncthreads();
    // (2) the right-hand side of my point, in place of its q.
    if constexpr (Sys::kFlux && !kPerAxis) {
      // (2a) my point's recovery and its flux rows; (2b), once every point's
      // are in, the right-hand side, the hydro rows φ0 u − Σ_d λ_d w_s
      // (D·F_d) + dt w_s rhs along my pencils, in the plain version's order.
      auto load_q = [&](int v) { return sQ[v * S::kPts + pt]; };
      const auto rec = Sys::template recover<T>(load_q, zp);
      T* sF = sG + S::kFOff;
#pragma unroll
      for (int d = 0; d < G::kAxes; ++d)
#pragma unroll
        for (int r = 0; r < Sys::kHydro; ++r)
          sF[(d * Sys::kHydro + r) * S::kPts + pt] = Sys::template flux<T>(rec, d, r);
      T lamw[G::kAxes];  // λ_d w_s, λ_d = dt / dx_d
#pragma unroll
      for (int d = 0; d < G::kAxes; ++d) lamw[d] = dtv / P.dx[d] * select<T, N>(P.W, s);
      __syncthreads();
      auto load_dq = [&](int k, int v) {
        if constexpr (G::kAxes == 3) {
          return sG[(k * GS + v - Sys::row_offset(v)) * S::kPts + pt];
        } else {  // the 2-D cell: the algebra's third gradient is zero
          return k < G::kAxes ? sG[(k * GS + v - Sys::row_offset(v)) * S::kPts + pt] : T(0);
        }
      };
      auto store = [&](int v, T r) {
        T x = phi0_s * sU[v * S::kNodes + cn];
        if (v >= Sys::kFluxFirst) {
#pragma unroll
          for (int d = 0; d < G::kAxes; ++d) {
            const T* f = sF + (d * Sys::kHydro + v - Sys::kFluxFirst) * S::kPts + pt;
            x = x - lamw[d] * z4_contract<T>(drow[d], f, G::digit(node, d), G::stride(d));
          }
        }
        sQ[v * S::kPts + pt] = x + dtw * r;
      };
      Sys::template rhs<T>(load_q, load_dq, zp, rec, store);
    } else if constexpr (kPerAxis) {
      // Pass 0 the source rhs(q, 0), pass d + 1 rhs(q, e_d D_d q), all one
      // code copy (the gradient selected at run time), so that each
      // ncp_d = rhs(q, 0) − rhs(q, e_d D_d q) cancels the gradient-free
      // terms exactly, as the plain version's does; the source waits in its
      // row, the sum φ0 u − Σ_d λ_d w ncp_d in the other, and the last pass
      // writes the sum + dt w source in place of q, in the plain order.
      // With a flux (Sys::kFlux), my point's recovery is made once (ev) for
      // its flux rows and the G::kAxes + 1 evaluations; once every point's
      // flux rows are in, pass d + 1 subtracts λ_d w_s (D·F_d) on the hydro
      // rows before the axis's NCP term, as the plain version orders them.
      T* sSrc = sG + S::kG;
      T* sAcc = sSrc + V * S::kPts;
      T lamw[G::kAxes];  // λ_d w_s, λ_d = dt / dx_d
#pragma unroll
      for (int d = 0; d < G::kAxes; ++d) lamw[d] = dtv / P.dx[d] * select<T, N>(P.W, s);
      auto load_q = [&](int v) { return sQ[v * S::kPts + pt]; };
      const Z4Eval<T, Sys> ev(load_q, zp);
      if constexpr (Sys::kFlux) {
        T* sF = sG + S::kFOff;
#pragma unroll
        for (int d = 0; d < G::kAxes; ++d)
#pragma unroll
          for (int r = 0; r < Sys::kHydro; ++r)
            sF[(d * Sys::kHydro + r) * S::kPts + pt] = Sys::template flux<T>(ev.rec, d, r);
        __syncthreads();
      }
#pragma unroll 1
      for (int pass = 0; pass <= G::kAxes; ++pass) {
        const int axis = pass - 1;
        const T lw = z4_axis_value<T, G::kAxes>(lamw, axis);
        auto load_dq = [&](int k, int v) {
          return k < G::kAxes && k == axis
                     ? sG[(k * GS + v - Sys::row_offset(v)) * S::kPts + pt]
                     : T(0);
        };
        auto store = [&](int v, T r) {
          T* src = sSrc + v * S::kPts + pt;
          if (pass == 0) {
            *src = r;
            return;
          }
          T* acc = sAcc + v * S::kPts + pt;
          T x = pass == 1 ? phi0_s * sU[v * S::kNodes + cn] : *acc;
          if constexpr (Sys::kFlux) {
            if (v >= Sys::kFluxFirst) {
              T dk[N];
              z4_axis_row<T, G::kAxes, N>(drow, axis, dk);
              const T* f =
                  sG + S::kFOff + (axis * Sys::kHydro + v - Sys::kFluxFirst) * S::kPts + pt;
              x = x - lw * z4_contract<T>(dk, f, G::digit(node, axis), G::stride(axis));
            }
          }
          x = x - lw * (*src - r);
          if (pass < G::kAxes) {
            *acc = x;
          } else {
            sQ[v * S::kPts + pt] = x + dtw * *src;
          }
        };
        ev.rhs(load_q, load_dq, zp, store);
      }
    } else {
      auto load_q = [&](int v) { return sQ[v * S::kPts + pt]; };
      auto load_dq = [&](int k, int v) {
        return k < G::kAxes ? sG[(k * GS + v - Sys::row_offset(v)) * S::kPts + pt] : T(0);
      };
      auto store = [&](int v, T r) {
        sQ[v * S::kPts + pt] = phi0_s * sU[v * S::kNodes + cn] + dtw * r;
      };
      Sys::template rhs<T>(load_q, load_dq, zp, store);
    }
    __syncthreads();
    // (3) q ← K1inv rhs over the time slices, one (node, slot) a thread.
    for (int e = threadIdx.x; e < S::kU; e += NT) {
      const int v = e / S::kNodes, m = e - v * S::kNodes;
      const int cc = m / G::kNodes;
      T* q = sQ + v * S::kPts + cc * G::kPoints + (m - cc * G::kNodes);
      if constexpr (N == 3) {
        const T r0 = q[0], r1 = q[G::kNodes], r2 = q[2 * G::kNodes];
#pragma unroll
        for (int t = 0; t < N; ++t) {
          q[t * G::kNodes] = P.K1inv[t][0] * r0 + P.K1inv[t][1] * r1 + P.K1inv[t][2] * r2;
        }
      } else {
        T r[N];
#pragma unroll
        for (int j = 0; j < N; ++j) r[j] = q[j * G::kNodes];
#pragma unroll
        for (int t = 0; t < N; ++t) {
          T x = P.K1inv[t][0] * r[0];
#pragma unroll
          for (int j = 1; j < N; ++j) x = x + P.K1inv[t][j] * r[j];
          q[t * G::kNodes] = x;
        }
      }
    }
    __syncthreads();
  }

  // q̄ = Σ_s w_s q_s, one (node, slot) a thread.
  T* sQbar = sG + S::kQbar;
  T* sGbar = sG + S::kGbar;
  T* sA = sG + S::kNcpA;
  T* sB = sG + S::kNcpB;
  for (int e = threadIdx.x; e < S::kU; e += NT) {
    const int v = e / S::kNodes, m = e - v * S::kNodes;
    const int cc = m / G::kNodes;
    const T* q = sQ + v * S::kPts + cc * G::kPoints + (m - cc * G::kNodes);
    if constexpr (N == 3) {
      sQbar[e] = P.W[0] * q[0] + P.W[1] * q[G::kNodes] + P.W[2] * q[2 * G::kNodes];
    } else {
      sQbar[e] = z4_contract<T>(P.W, q, 0, G::kNodes);
    }
  }
  __syncthreads();
  // ∇q̄ (per-axis: D·q̄ unscaled), one (axis, gradient row, node) a thread.
  for (int e = threadIdx.x; e < G::kAxes * GS * S::kNodes; e += NT) {
    const int row = e / S::kNodes, m = e - row * S::kNodes;
    const int k = row / GS;
    int v = Sys::kGradFirst + row - k * GS;
    v += Sys::slot_skip(v);
    const int nd = m % G::kNodes;
    const int ik = G::digit(nd, k);
    T dr[N];
    select_row<T, N>(P.D, ik, dr);
    if constexpr (kPerAxis) {
      sGbar[e] = z4_contract<T>(dr, sQbar + v * S::kNodes + m, ik, G::stride(k));
    } else {
      const T idx = z4_axis_value<T, G::kAxes>(inv_dx, k);
      sGbar[e] = z4_gradient<T>(dr, sQbar + v * S::kNodes + m, ik, G::stride(k), idx);
    }
  }
  __syncthreads();

  // The source terms rhs(q_s, 0) of every point, in place of q (their zero
  // gradients compile away); with a flux also F_d(q_s) into the flux rows.
  if constexpr (Sys::kFlux) {
    auto load_q = [&](int v) { return sQ[v * S::kPts + pt]; };
    const auto rec = Sys::template recover<T>(load_q, zp);
    T* sF = sG + S::kFOff;
#pragma unroll
    for (int d = 0; d < G::kAxes; ++d)
#pragma unroll
      for (int r = 0; r < Sys::kHydro; ++r)
        sF[(d * Sys::kHydro + r) * S::kPts + pt] = Sys::template flux<T>(rec, d, r);
    auto zero = [](int, int) { return T(0); };
    auto store = [&](int v, T r) { sQ[v * S::kPts + pt] = r; };
    Sys::template rhs<T>(load_q, zero, zp, rec, store);
  } else {
    auto load_q = [&](int v) { return sQ[v * S::kPts + pt]; };
    auto zero = [](int, int) { return T(0); };
    auto store = [&](int v, T r) { sQ[v * S::kPts + pt] = r; };
    Sys::template rhs<T>(load_q, zero, zp, store);
  }
  if constexpr (kPerAxis) {
    // The NCP volume term's evaluations at my node: E_0 = rhs(q̄, 0) and
    // E_{d+1} = rhs(q̄, e_d D_d q̄), evaluation e on the threads of slice e
    // (and e − N), one code copy with the gradient selected at run time, so
    // that each difference E_0 − E_{d+1} cancels the gradient-free terms
    // exactly, as the plain version's does (with a flux, all of them from
    // one recovery at q̄).
    auto load_qbar = [&](int v) { return sQbar[v * S::kNodes + cn]; };
    const Z4Eval<T, Sys> ev(load_qbar, zp);
#pragma unroll 1
    for (int e = s; e <= G::kAxes; e += N) {
      const int axis = e - 1;
      auto load_q = [&](int v) { return sQbar[v * S::kNodes + cn]; };
      auto load_dq = [&](int k, int v) {
        return k < G::kAxes && k == axis
                   ? sGbar[(k * GS + v - Sys::row_offset(v)) * S::kNodes + cn]
                   : T(0);
      };
      T* dst = sA + e * V * S::kNodes;
      auto store = [&](int v, T r) { dst[v * S::kNodes + cn] = r; };
      ev.rhs(load_q, load_dq, zp, store);
    }
  } else if (s < 2) {
    // rhs(q̄, ∇q̄) of my node on the slice-0 threads, rhs(q̄, 0) on the
    // slice-1 ones: one code copy with the gradient zeroed at run time, so
    // the two evaluations round their gradient-free terms alike and their
    // difference cancels them exactly, as the plain version's does.
    const bool grad = s == 0;
    auto load_q = [&](int v) { return sQbar[v * S::kNodes + cn]; };
    auto load_dq = [&](int k, int v) {
      return grad && k < G::kAxes ? sGbar[(k * GS + v - Sys::row_offset(v)) * S::kNodes + cn]
                                  : T(0);
    };
    T* dst = grad ? sA : sB;
    auto store = [&](int v, T r) { dst[v * S::kNodes + cn] = r; };
    if constexpr (Sys::kFlux) {
      // Both threads recover at q̄ alike, so the matter terms cancel.
      const auto rec = Sys::template recover<T>(load_q, zp);
      Sys::template rhs<T>(load_q, load_dq, zp, rec, store);
    } else {
      Sys::template rhs<T>(load_q, load_dq, zp, store);
    }
  }
  __syncthreads();
  if constexpr (Sys::kFlux) {
    // F̄_d = Σ_s w_s F_d(q_s), in place at the points of slice 0, one
    // (axis, hydro row, node) a thread.
    T* sF = sG + S::kFOff;
    for (int e = threadIdx.x; e < G::kAxes * Sys::kHydro * S::kNodes; e += NT) {
      const int row = e / S::kNodes, m = e - row * S::kNodes;
      const int cc = m / G::kNodes;
      T* f = sF + row * S::kPts + cc * G::kPoints + (m - cc * G::kNodes);
      if constexpr (N == 3) {
        f[0] = P.W[0] * f[0] + P.W[1] * f[G::kNodes] + P.W[2] * f[2 * G::kNodes];
      } else {
        f[0] = z4_contract<T>(P.W, f, 0, G::kNodes);
      }
    }
    __syncthreads();
  }

  // new = u + dt s̄ + dt (rhs(q̄, ∇q̄) − rhs(q̄, 0)); per-axis, new = u +
  // dt s̄ − Σ_d λ_d (E_0 − E_{d+1}) in the plain order (with a flux, each
  // axis's volume integral before its NCP term); the block's cells
  // fastest.
  for (int e = threadIdx.x; e < S::kU; e += NT) {
    const int cc = e % CB, r = e / CB;  // r = node * V + v
    const int nd = r / V, v = r - nd * V;
    if (cell0 + cc >= ncell) continue;
    const int m = cc * G::kNodes + nd;
    const T* src = sQ + v * S::kPts + cc * G::kPoints + nd;
    T sbar;
    if constexpr (N == 3) {
      sbar = P.W[0] * src[0] + P.W[1] * src[G::kNodes] + P.W[2] * src[2 * G::kNodes];
    } else {
      sbar = z4_contract<T>(P.W, src, 0, G::kNodes);
    }
    T nv = sU[v * S::kNodes + m] + dtv * sbar;
    if constexpr (kPerAxis) {
      const T e0 = sA[v * S::kNodes + m];
#pragma unroll
      for (int d = 0; d < G::kAxes; ++d) {
        if constexpr (Sys::kFlux) {
          if (v >= Sys::kFluxFirst) {  // + λ_d Kvol·F̄_d
            const int ik = G::digit(nd, d);
            T krow[N];
            select_row<T, N>(P.Kvol, ik, krow);
            const T* f = sG + S::kFOff + (d * Sys::kHydro + v - Sys::kFluxFirst) * S::kPts +
                         cc * G::kPoints + nd;
            nv = nv + dtv / P.dx[d] * z4_contract<T>(krow, f, ik, G::stride(d));
          }
        }
        nv = nv - dtv / P.dx[d] * (e0 - sA[((d + 1) * V + v) * S::kNodes + m]);
      }
    } else {
      nv = nv + dtv * (sA[v * S::kNodes + m] - sB[v * S::kNodes + m]);
    }
    if constexpr (Sys::kFlux && !kPerAxis) {
      // The volume integral of the hydro rows: + λ_d Kvol·F̄_d along each axis.
      if (v >= Sys::kFluxFirst) {
        const T* sF = sG + S::kFOff;
#pragma unroll
        for (int d = 0; d < G::kAxes; ++d) {
          const int ik = G::digit(nd, d);
          T krow[N];
          select_row<T, N>(P.Kvol, ik, krow);
          const T* f = sF + (d * Sys::kHydro + v - Sys::kFluxFirst) * S::kPts +
                       cc * G::kPoints + nd;
          nv = nv + dtv / P.dx[d] * z4_contract<T>(krow, f, ik, G::stride(d));
        }
      }
    }
    out[static_cast<long long>(r) * ncell + cell0 + cc] = nv;
  }

  // Face projections of q̄: faces[d][w][fm][v][cell], face node fm the other
  // node digits in order, w = 0 (q_lo) and 1 (q_hi) here; a block's rows
  // are CB cells long.
  const long long wstride = static_cast<long long>(G::kFaces * V) * ncell;
  for (int e = threadIdx.x; e < G::kAxes * G::kFaces * V * CB; e += NT) {
    const int cc = e % CB, r = e / CB;  // r = (d * kFaces + fm) * V + v
    const int v = r % V, df = r / V;
    const int d = df / G::kFaces, fm = df - d * G::kFaces;
    if (cell0 + cc >= ncell) continue;
    const int base = G::face_base(d, fm);
    const int st = G::stride(d);
    const T* x = sQbar + v * S::kNodes + cc * G::kNodes + base;
    T qlo, qhi;
    if constexpr (N == 3) {
      const T q0 = x[0], q1 = x[st], q2 = x[2 * st];
      qlo = P.PHI0[0] * q0 + P.PHI0[1] * q1 + P.PHI0[2] * q2;
      qhi = P.PHI1[0] * q0 + P.PHI1[1] * q1 + P.PHI1[2] * q2;
    } else {
      T qx[N];
#pragma unroll
      for (int j = 0; j < N; ++j) qx[j] = x[j * st];
      qlo = P.PHI0[0] * qx[0];
#pragma unroll
      for (int j = 1; j < N; ++j) qlo = qlo + P.PHI0[j] * qx[j];
      qhi = P.PHI1[0] * qx[0];
#pragma unroll
      for (int j = 1; j < N; ++j) qhi = qhi + P.PHI1[j] * qx[j];
    }
    const long long o =
        (static_cast<long long>(d * 4 * G::kFaces + fm) * V + v) * ncell + cell0 + cc;
    faces[o] = qlo;
    faces[o + wstride] = qhi;
    if constexpr (Sys::kFlux) {
      // f_lo, f_hi: the projections of F̄_d on the hydro rows, zero on the
      // others.
      T flo = T(0), fhi = T(0);
      if (v >= Sys::kFluxFirst) {
        const T* f = sG + S::kFOff + (d * Sys::kHydro + v - Sys::kFluxFirst) * S::kPts +
                     cc * G::kPoints + base;
        flo = z4_contract<T>(P.PHI0, f, 0, st);
        fhi = z4_contract<T>(P.PHI1, f, 0, st);
      }
      faces[o + 2 * wstride] = flo;
      faces[o + 3 * wstride] = fhi;
    }
  }
  if constexpr (Sys::kFlux) return;
  // The f rows (w = 2, 3) are zero for this physics, and adjacent: one slab
  // of 2 wstride values an axis.  They do not depend on the cell, so the
  // blocks split each slab into consecutive runs of 2 wstride / ncell x CB
  // values, the block's share, written as full lines (its own cells' rows
  // are CB values long).
  constexpr int kRun = 2 * G::kFaces * V * CB;
  const long long lo = static_cast<long long>(blockIdx.x) * kRun;
  const long long n = 2 * wstride - lo < kRun ? 2 * wstride - lo : kRun;
#pragma unroll
  for (int d = 0; d < G::kAxes; ++d) {
    T* slab = faces + (static_cast<long long>(d) * 4 + 2) * wstride + lo;
    for (int e = threadIdx.x; e < n; e += NT) slab[e] = T(0);
  }
}

// The NCP half-fluctuation ½ (rhs(q̃, 0) − rhs(q̃, e_D Δq)) for the axis D
// (compile time, so the gradient's two other rows compile away) into
// fhalf, from q̃ and Δq in the thread's words of shared memory (stride
// kTile).  Both evaluations run one code copy, the first with Δq zeroed at
// run time and its result parked in sR: they round their Δq-free terms
// alike, so the difference cancels them exactly, as the plain version's
// does (where Δq = 0 the half is exactly 0).
//
// With a flux (Sys::kFlux) the recovery at q̃ is made once, before both
// evaluations, which share it (so their matter terms cancel exactly too).
template <typename T, typename Sys, int D>
__device__ __forceinline__ void z4_face_half(const typename Sys::P& zp, const T* sMid, const T* sDq,
                                             T* sR, T* out, long long ncell) {
  if constexpr (Sys::kFlux) {
    auto load_mid = [&](int v) { return sMid[v * kTile]; };
    const auto rec = Sys::template recover<T>(load_mid, zp);
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      auto load_dq = [&](int k, int v) { return k == D && pass ? sDq[v * kTile] : T(0); };
      auto store = [&](int v, T r) {
        if (pass) {
          out[v * ncell] = T(0.5) * (sR[v * kTile] - r);
        } else {
          sR[v * kTile] = r;
        }
      };
      Sys::template rhs<T>(load_mid, load_dq, zp, rec, store);
    }
  } else {
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      auto load_q = [&](int v) { return sMid[v * kTile]; };
      auto load_dq = [&](int k, int v) { return k == D && pass ? sDq[v * kTile] : T(0); };
      auto store = [&](int v, T r) {
        if (pass) {
          out[v * ncell] = T(0.5) * (sR[v * kTile] - r);
        } else {
          sR[v * kTile] = r;
        }
      };
      Sys::template rhs<T>(load_q, load_dq, zp, store);
    }
  }
}

// The face stage, first launch: one thread per (cell, axis d, face node fm)
// solves the interface between the cell's high face and its +d neighbour's
// low face once: F̂ into fhat[d][fm][v][cell] and the NCP half-fluctuation
// into fhalf (the same layout).
template <typename T, typename Sys, typename G = Z4Cell3>
__global__ void __launch_bounds__(kTile, 8)
aderdg_face_flux_z4(const T* __restrict__ faces, T* __restrict__ fhat, T* __restrict__ fhalf,
                    const Z4Params<T, Sys, G::kN> P) {
  constexpr int V = Sys::kVars;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sMid = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  T* sDq = sMid + V * kTile;
  T* sR = sDq + V * kTile;
  const TileCell tc(blockIdx.x, P.g);
  if (!tc.inside) return;  // no barrier here
  const int d = blockIdx.y / G::kFaces;
  const int fm = blockIdx.y - d * G::kFaces;
  const long long ncell = P.ncell;
  const long long cell = tc.cell;
  const long long plus = tc.neighbour(G::kAxis0 + d, 1);
  // faces[d][w][fm][v][cell], w = q_lo, q_hi, f_lo, f_hi (the f rows are
  // zero for a fluxless system and are not read; with a flux, its rows).
  const T* base = faces + static_cast<long long>(d * 4 * G::kFaces + fm) * V * ncell;
  const long long wstride = static_cast<long long>(G::kFaces * V) * ncell;
  T qa[V], qb[V];  // a: my high face, b: the neighbour's low face
#pragma unroll
  for (int v = 0; v < V; ++v) {
    qa[v] = base[wstride + v * ncell + cell];
    qb[v] = base[v * ncell + plus];
  }
  const T s = dmax(Sys::template wave_speed<T>(qa, d, P.phys.p),
                   Sys::template wave_speed<T>(qb, d, P.phys.p));
  const long long o = static_cast<long long>(d * G::kFaces + fm) * V * ncell + cell;
  if constexpr (Sys::kFlux) {
    // F̂ = ½ (f_hi + f⁺) − ½ s (q⁺ − q_hi): the f rows of my high face
    // (w = 3) and the neighbour's low face (w = 2) on the hydro rows; the
    // others' f is zero, and 0 − ½ s Δq as the plain version's ½ (0 + 0) −
    // ½ s Δq.
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const T dq = qb[v] - qa[v];
      T fh = T(0) - T(0.5) * s * dq;
      if (v >= Sys::kFluxFirst) {
        const T fa = base[3 * wstride + v * ncell + cell];
        const T fb = base[2 * wstride + v * ncell + plus];
        fh = T(0.5) * (fa + fb) - T(0.5) * s * dq;
      }
      fhat[o + v * ncell] = fh;
      sMid[v * kTile] = T(0.5) * (qa[v] + qb[v]);
      sDq[v * kTile] = dq;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const T dq = qb[v] - qa[v];
      fhat[o + v * ncell] = T(0) - T(0.5) * s * dq;
      sMid[v * kTile] = T(0.5) * (qa[v] + qb[v]);
      sDq[v * kTile] = dq;
    }
  }
  const typename Sys::P zp = P.phys.p;
  if constexpr (G::kAxes == 3) {
    if (d == 0) {
      z4_face_half<T, Sys, 0>(zp, sMid, sDq, sR, fhalf + o, ncell);
    } else if (d == 1) {
      z4_face_half<T, Sys, 1>(zp, sMid, sDq, sR, fhalf + o, ncell);
    } else {
      z4_face_half<T, Sys, 2>(zp, sMid, sDq, sR, fhalf + o, ncell);
    }
  } else {
    if (d == 0) {
      z4_face_half<T, Sys, 0>(zp, sMid, sDq, sR, fhalf + o, ncell);
    } else {
      z4_face_half<T, Sys, 1>(zp, sMid, sDq, sR, fhalf + o, ncell);
    }
  }
}

// The face stage, second launch: one thread per (cell, space node) updates
// the node's V rows of `state` in place, axis by axis: the surface term
// −λ_d (ℓ_i(1)/w_i F̂_hi − ℓ_i(0)/w_i F̂_lo), then the NCP term
// −λ_d (ℓ_i(1)/w_i h_hi + ℓ_i(0)/w_i h_lo), the _hi values the cell's own
// entries of fhat and fhalf, the _lo ones its −d neighbour's.
template <typename T, typename Sys, typename G = Z4Cell3>
__global__ void __launch_bounds__(kTile * G::kUpdateNodes)
aderdg_surface_update_z4(T* __restrict__ state, const T* __restrict__ fhat,
                         const T* __restrict__ fhalf, const T* __restrict__ dt_ptr, T dt_val,
                         const Z4Params<T, Sys, G::kN> P) {
  constexpr int V = Sys::kVars;
  constexpr int N = G::kN;
  constexpr int NG = G::kNodes / G::kUpdateNodes;
  const int tile_index = blockIdx.x / NG;
  const TileCell tc(tile_index, P.g);
  if (!tc.inside) return;
  const int node = (blockIdx.x - tile_index * NG) * G::kUpdateNodes + threadIdx.y;
  const long long ncell = P.ncell;
  const long long cell = tc.cell;
  const T dtv = dt_ptr != nullptr ? *dt_ptr : dt_val;
  int ix[G::kAxes];
#pragma unroll
  for (int k = 0; k < G::kAxes; ++k) ix[k] = G::digit(node, k);
  T lam[G::kAxes], p1w[G::kAxes], p0w[G::kAxes];
  long long hi[G::kAxes], lo[G::kAxes];  // offsets of the _hi and _lo entries of row 0
#pragma unroll
  for (int d = 0; d < G::kAxes; ++d) {
    lam[d] = dtv / P.dx[d];
    p1w[d] = select<T, N>(P.PHI1W, ix[d]);
    p0w[d] = select<T, N>(P.PHI0W, ix[d]);
    const long long row0 = static_cast<long long>(d * G::kFaces + G::face_node(ix, d)) * V * ncell;
    hi[d] = row0 + cell;
    lo[d] = row0 + tc.neighbour(G::kAxis0 + d, -1);
  }
#pragma unroll 2
  for (int v = 0; v < V; ++v) {
    const long long o = static_cast<long long>(node * V + v) * ncell + cell;
    T x = state[o];
#pragma unroll
    for (int d = 0; d < G::kAxes; ++d) {
      const long long w = v * ncell;
      x = x - lam[d] * (p1w[d] * fhat[hi[d] + w] - p0w[d] * fhat[lo[d] + w]);
      x = x - lam[d] * (p1w[d] * fhalf[hi[d] + w] + p0w[d] * fhalf[lo[d] + w]);
    }
    state[o] = x;
  }
}

// Host side ---------------------------------------------------------------

// The face stage's shared memory: q̃, Δq and rhs(q̃, 0) of a warp's threads.
template <typename T, typename Sys>
constexpr size_t z4_face_smem() {
  return static_cast<size_t>(3 * Sys::kVars * kTile) * sizeof(T);
}

// Tiles of the face stage, or 0 if the order is not the cell's, the grid is
// empty or a block index would not fit a 32-bit int.
template <typename G = Z4Cell3>
long long z4_face_tiles(int order, long long g0, long long g1, long long g2) {
  constexpr long long kMax = 0x7fffffffLL;
  if (order != G::kN - 1 || g0 <= 0 || g1 <= 0 || g2 <= 0 || g0 > kMax || g1 > kMax ||
      g2 > kMax)
    return 0;
  const long long tiles = g0 * g1 * ((g2 + kTile - 1) / kTile);
  return tiles * (G::kNodes / G::kUpdateNodes) > kMax ? 0 : tiles;
}

template <typename Sys>
bool z4_bad_args(int physics, const double* params) {
  return physics != Sys::kPhysics || params == nullptr || Sys::bad(params);
}

template <typename T, typename Sys, typename G = Z4Cell3, bool kPerAxis = false>
Shape z4_predictor_shape() {
  constexpr int CB = z4_cells_per_block<T, Sys, G, kPerAxis>();
  return {reinterpret_cast<const void*>(aderdg_predictor_volume_z4<T, CB, Sys, G, kPerAxis>),
          dim3(CB * G::kPoints), z4_predictor_smem<T, Sys, G, kPerAxis>()};
}

template <typename T, typename Sys, typename G = Z4Cell3>
Shape z4_face_flux_shape() {
  return {reinterpret_cast<const void*>(aderdg_face_flux_z4<T, Sys, G>), dim3(kTile),
          z4_face_smem<T, Sys>()};
}

template <typename T, typename Sys, typename G = Z4Cell3>
Shape z4_surface_update_shape() {
  return {reinterpret_cast<const void*>(aderdg_surface_update_z4<T, Sys, G>),
          dim3(kTile, G::kUpdateNodes), 0};
}

// The launchers take the grid as the face stage tiles it ((1, g0, g1) for a
// 2-D cell, see Z4Cell).
template <typename T, typename Sys, typename G = Z4Cell3, bool kPerAxis = false>
int z4_predictor_volume(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                        const double* ops, const double* dx, int order, int picard_iters,
                        int physics, const double* params, long long g0, long long g1,
                        long long g2, void* stream) {
  constexpr int CB = z4_cells_per_block<T, Sys, G, kPerAxis>();
  static_assert(CB >= 1, "a cell's shared memory fits a block");
  if (z4_bad_args<Sys>(physics, params) || z4_face_tiles<G>(order, g0, g1, g2) == 0 ||
      picard_iters < 0)
    return cudaErrorInvalidValue;
  const auto P = make_params<T, G::kN, Z4Physics<T, Sys>>(ops, dx, picard_iters, params, g0, g1,
                                                           g2);
  const Shape sh = z4_predictor_shape<T, Sys, G, kPerAxis>();
  const cudaError_t attr = allow_smem(aderdg_predictor_volume_z4<T, CB, Sys, G, kPerAxis>, sh.smem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (P.ncell + CB - 1) / CB;
  aderdg_predictor_volume_z4<T, CB, Sys, G, kPerAxis>
      <<<static_cast<unsigned>(blocks), sh.block, sh.smem, static_cast<cudaStream_t>(stream)>>>(
          u, out, faces, dt_ptr, static_cast<T>(dt_val), P);
  return cudaGetLastError();
}

template <typename T, typename Sys, typename G = Z4Cell3>
int z4_face_flux(const T* faces, T* fhat, T* fhalf, const double* ops, const double* dx,
                 int order, int physics, const double* params, long long g0, long long g1,
                 long long g2, void* stream) {
  const long long tiles = z4_face_tiles<G>(order, g0, g1, g2);
  if (z4_bad_args<Sys>(physics, params) || tiles == 0) return cudaErrorInvalidValue;
  const auto P = make_params<T, G::kN, Z4Physics<T, Sys>>(ops, dx, 0, params, g0, g1, g2);
  const Shape sh = z4_face_flux_shape<T, Sys, G>();
  const dim3 grid(static_cast<unsigned>(tiles), G::kAxes * G::kFaces);
  aderdg_face_flux_z4<T, Sys, G><<<grid, sh.block, sh.smem, static_cast<cudaStream_t>(stream)>>>(
      faces, fhat, fhalf, P);
  return cudaGetLastError();
}

template <typename T, typename Sys, typename G = Z4Cell3>
int z4_surface_update(T* state, const T* fhat, const T* fhalf, const T* dt_ptr, double dt_val,
                      const double* ops, const double* dx, int order, int physics,
                      const double* params, long long g0, long long g1, long long g2,
                      void* stream) {
  const long long tiles = z4_face_tiles<G>(order, g0, g1, g2);
  if (z4_bad_args<Sys>(physics, params) || tiles == 0) return cudaErrorInvalidValue;
  const auto P = make_params<T, G::kN, Z4Physics<T, Sys>>(ops, dx, 0, params, g0, g1, g2);
  const Shape sh = z4_surface_update_shape<T, Sys, G>();
  const long long blocks = tiles * (G::kNodes / G::kUpdateNodes);
  aderdg_surface_update_z4<T, Sys, G>
      <<<static_cast<unsigned>(blocks), sh.block, 0, static_cast<cudaStream_t>(stream)>>>(
          state, fhat, fhalf, dt_ptr, static_cast<T>(dt_val), P);
  return cudaGetLastError();
}

// Occupancy of kernel `which` (0 predictor, 1 face flux, 2 update), as
// shape_info gives it.
template <typename T, typename Sys>
int z4_info(int which, int* out) {
  switch (which) {
    case 0:
      return shape_info(z4_predictor_shape<T, Sys>(), out);
    case 1:
      return shape_info(z4_face_flux_shape<T, Sys>(), out);
    case 2:
      return shape_info(z4_surface_update_shape<T, Sys>(), out);
    default:
      return cudaErrorInvalidValue;
  }
}

// A system on a 2-D cell of N nodes an axis (csrc/aderdg_z4_2d*.cu, the
// vacuum system; csrc/aderdg_z4_matter_2d*.cu, Z4+GRHD;
// csrc/aderdg_z4_grmhd_2d*.cu, Z4+GRMHD; csrc/aderdg_z4_shift_2d*.cu, the
// shifted one): the C interface's grid (g0, g1, 1) goes to the kernels as
// (1, g0, g1).
using Z4Cell2P2 = Z4Cell<2, 3>;
using Z4Cell2P3 = Z4Cell<2, 4>;

template <typename T, typename G, bool kPerAxis, typename Sys = Z4Vacuum>
int z4_2d_predictor_volume(const T* u, T* out, T* faces, const T* dt_ptr, double dt_val,
                           const double* ops, const double* dx, int order, int picard_iters,
                           int physics, const double* params, long long g0, long long g1,
                           long long g2, void* stream) {
  if (g2 != 1) return cudaErrorInvalidValue;
  return z4_predictor_volume<T, Sys, G, kPerAxis>(u, out, faces, dt_ptr, dt_val, ops, dx, order,
                                                  picard_iters, physics, params, 1, g0, g1,
                                                  stream);
}

template <typename T, typename G, typename Sys = Z4Vacuum>
int z4_2d_face_flux(const T* faces, T* fhat, T* fhalf, const double* ops, const double* dx,
                    int order, int physics, const double* params, long long g0, long long g1,
                    long long g2, void* stream) {
  if (g2 != 1) return cudaErrorInvalidValue;
  return z4_face_flux<T, Sys, G>(faces, fhat, fhalf, ops, dx, order, physics, params, 1, g0, g1,
                                 stream);
}

template <typename T, typename G, typename Sys = Z4Vacuum>
int z4_2d_surface_update(T* state, const T* fhat, const T* fhalf, const T* dt_ptr,
                         double dt_val, const double* ops, const double* dx, int order,
                         int physics, const double* params, long long g0, long long g1,
                         long long g2, void* stream) {
  if (g2 != 1) return cudaErrorInvalidValue;
  return z4_surface_update<T, Sys, G>(state, fhat, fhalf, dt_ptr, dt_val, ops, dx, order, physics,
                                      params, 1, g0, g1, stream);
}

// Occupancy of a system's kernels on cell G: `which` 0 the fused predictor,
// 1 face flux, 2 update, 3 the per-axis predictor.
template <typename T, typename G, typename Sys = Z4Vacuum>
int z4_form_info(int which, int* out) {
  switch (which) {
    case 0:
      return shape_info(z4_predictor_shape<T, Sys, G, false>(), out);
    case 1:
      return shape_info(z4_face_flux_shape<T, Sys, G>(), out);
    case 2:
      return shape_info(z4_surface_update_shape<T, Sys, G>(), out);
    case 3:
      return shape_info(z4_predictor_shape<T, Sys, G, true>(), out);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
