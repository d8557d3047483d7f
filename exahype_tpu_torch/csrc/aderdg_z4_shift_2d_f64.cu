// The shifted Z4 step on a 2-D grid at order 2 (csrc/aderdg_z4.cuh over the
// 53-variable system of csrc/z4_shift.cuh, on the cell Z4Cell2P2: 9 space
// nodes, 27 space-time points): its float64 instances and their C interface.
// The algebra stays the 3-D one, its third gradient a compile-time zero (β^z
// and the third rows of b and B still evolve); the wave speed adds |β^d| of
// the grid's two axes.  The C interface's grid is (g0, g1, 1): g2 must be 1.

#include "aderdg_z4.cuh"

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns the launch's
// cudaError_t; the arguments are the 3-D shifted launchers'
// (csrc/aderdg_z4_shift.cu): physics 4, order 2, faces [2][4][3][53][cell]
// (the f rows zero).
//
// The fused predictor (make_z4_shift_solver(2, 2, ..., fused_rhs="soa")).
int exahype_aderdg_predictor_volume_2d_z4_shift_f64(
    const double* u, double* out, double* faces, const double* dt_ptr, double dt_val,
    const double* ops, const double* dx, int order, int picard_iters, int physics,
    const double* params, long long g0, long long g1, long long g2, void* stream) {
  return z4_2d_predictor_volume<double, Z4Cell2P2, false, Z4Shift>(
      u, out, faces, dt_ptr, dt_val, ops, dx, order, picard_iters, physics, params, g0, g1, g2,
      stream);
}

// The per-axis predictor (fused_rhs=False, the JAX package's default: the
// solver every shifted test of the JAX package builds).
int exahype_aderdg_predictor_volume_per_axis_2d_z4_shift_f64(
    const double* u, double* out, double* faces, const double* dt_ptr, double dt_val,
    const double* ops, const double* dx, int order, int picard_iters, int physics,
    const double* params, long long g0, long long g1, long long g2, void* stream) {
  return z4_2d_predictor_volume<double, Z4Cell2P2, true, Z4Shift>(
      u, out, faces, dt_ptr, dt_val, ops, dx, order, picard_iters, physics, params, g0, g1, g2,
      stream);
}

// The face stage's first launch: fhat and fhalf, [2][3][53][cell] each, the
// Rusanov fluxes and the NCP half-fluctuations.
int exahype_aderdg_face_flux_2d_z4_shift_f64(
    const double* faces, double* fhat, double* fhalf, const double* ops, const double* dx,
    int order, int physics, const double* params, long long g0, long long g1, long long g2,
    void* stream) {
  return z4_2d_face_flux<double, Z4Cell2P2, Z4Shift>(
      faces, fhat, fhalf, ops, dx, order, physics, params, g0, g1, g2, stream);
}

// The face stage's second launch: the update of `state` in place.
int exahype_aderdg_surface_update_2d_z4_shift_f64(
    double* state, const double* fhat, const double* fhalf, const double* dt_ptr, double dt_val,
    const double* ops, const double* dx, int order, int physics, const double* params,
    long long g0, long long g1, long long g2, void* stream) {
  return z4_2d_surface_update<double, Z4Cell2P2, Z4Shift>(
      state, fhat, fhalf, dt_ptr, dt_val, ops, dx, order, physics, params, g0, g1, g2, stream);
}

}  // extern "C"

// Their occupancy, for exahype_aderdg_kernel_info (kernels 66-69 of physics
// 4, csrc/aderdg.cu): `which` 0 the fused predictor, 1 face flux, 2 update,
// 3 the per-axis predictor.
int z4_shift_2d_info_f64(int which, int* out) {
  return z4_form_info<double, Z4Cell2P2, Z4Shift>(which, out);
}
