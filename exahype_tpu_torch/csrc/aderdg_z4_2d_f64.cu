// The vacuum Z4 step on a 2-D grid at order 2 (csrc/aderdg_z4.cuh on the
// cell Z4Cell2P2: 9 space nodes, 27 space-time points): its float64
// instances and their C interface (csrc/aderdg_z4_2d_p3_f64.cu holds order 3).  The
// algebra stays the 3-D one, its third gradient a compile-time zero.  The C
// interface's grid is (g0, g1, 1): g2 must be 1.

#include "aderdg_z4.cuh"

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns the launch's
// cudaError_t; the arguments are the 3-D vacuum launchers'
// (csrc/aderdg_z4.cu): physics 3, order 2, faces [2][4][3][38][cell].
//
// The fused predictor (make_z4_solver(2, 2, ..., fused_rhs="soa")).
int exahype_aderdg_predictor_volume_2d_z4_f64(
    const double* u, double* out, double* faces, const double* dt_ptr, double dt_val,
    const double* ops, const double* dx, int order, int picard_iters, int physics,
    const double* params, long long g0, long long g1, long long g2, void* stream) {
  return z4_2d_predictor_volume<double, Z4Cell2P2, false>(
      u, out, faces, dt_ptr, dt_val, ops, dx, order, picard_iters, physics, params, g0, g1, g2,
      stream);
}

// The per-axis predictor (fused_rhs=False, the JAX package's default).
int exahype_aderdg_predictor_volume_per_axis_2d_z4_f64(
    const double* u, double* out, double* faces, const double* dt_ptr, double dt_val,
    const double* ops, const double* dx, int order, int picard_iters, int physics,
    const double* params, long long g0, long long g1, long long g2, void* stream) {
  return z4_2d_predictor_volume<double, Z4Cell2P2, true>(
      u, out, faces, dt_ptr, dt_val, ops, dx, order, picard_iters, physics, params, g0, g1, g2,
      stream);
}

// The face stage's first launch: fhat and fhalf, [2][3][38][cell] each.
int exahype_aderdg_face_flux_2d_z4_f64(
    const double* faces, double* fhat, double* fhalf, const double* ops, const double* dx,
    int order, int physics, const double* params, long long g0, long long g1, long long g2,
    void* stream) {
  return z4_2d_face_flux<double, Z4Cell2P2>(
      faces, fhat, fhalf, ops, dx, order, physics, params, g0, g1, g2, stream);
}

// The face stage's second launch: the update of `state` in place.
int exahype_aderdg_surface_update_2d_z4_f64(
    double* state, const double* fhat, const double* fhalf, const double* dt_ptr, double dt_val,
    const double* ops, const double* dx, int order, int physics, const double* params,
    long long g0, long long g1, long long g2, void* stream) {
  return z4_2d_surface_update<double, Z4Cell2P2>(
      state, fhat, fhalf, dt_ptr, dt_val, ops, dx, order, physics, params, g0, g1, g2, stream);
}

}  // extern "C"

// Their occupancy, for exahype_aderdg_kernel_info (kernels 47-50 of physics
// 3, csrc/aderdg.cu): `which` 0 the fused predictor, 1 face flux, 2 update,
// 3 the per-axis predictor.
int z4_2d_info_f64(int which, int* out) {
  return z4_form_info<double, Z4Cell2P2>(which, out);
}
