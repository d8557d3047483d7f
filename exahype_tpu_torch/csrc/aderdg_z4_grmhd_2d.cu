// The coupled Z4+GRMHD step on a 2-D grid at order 2 (csrc/aderdg_z4.cuh over
// the 47-variable system of csrc/z4_grmhd.cuh, with its conservative flux,
// on the cell Z4Cell2P2: 9 space nodes, 27 space-time points): its float32
// instances and their C interface.  The algebra stays the 3-D one, its
// third gradient a compile-time zero; the flux runs along the grid's two
// axes.  The C interface's grid is (g0, g1, 1): g2 must be 1.

#include "aderdg_z4.cuh"

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns the launch's
// cudaError_t; the arguments are the 3-D Z4+GRMHD launchers'
// (csrc/aderdg_z4_grmhd.cu): physics 6, order 2, faces [2][4][3][47][cell]
// (the f rows carry the matter flux's projections, zero on the Z4 rows).
//
// The fused predictor (make_z4_grmhd_solver(2, 2, ..., fused_rhs="soa")).
int exahype_aderdg_predictor_volume_2d_z4_grmhd_f32(
    const float* u, float* out, float* faces, const float* dt_ptr, double dt_val,
    const double* ops, const double* dx, int order, int picard_iters, int physics,
    const double* params, long long g0, long long g1, long long g2, void* stream) {
  return z4_2d_predictor_volume<float, Z4Cell2P2, false, Z4Grmhd>(
      u, out, faces, dt_ptr, dt_val, ops, dx, order, picard_iters, physics, params, g0, g1, g2,
      stream);
}

// The per-axis predictor (fused_rhs=False, the JAX package's default:
// the solver its Z4+GRMHD tests build).
int exahype_aderdg_predictor_volume_per_axis_2d_z4_grmhd_f32(
    const float* u, float* out, float* faces, const float* dt_ptr, double dt_val,
    const double* ops, const double* dx, int order, int picard_iters, int physics,
    const double* params, long long g0, long long g1, long long g2, void* stream) {
  return z4_2d_predictor_volume<float, Z4Cell2P2, true, Z4Grmhd>(
      u, out, faces, dt_ptr, dt_val, ops, dx, order, picard_iters, physics, params, g0, g1, g2,
      stream);
}

// The face stage's first launch: fhat and fhalf, [2][3][47][cell] each, the
// Rusanov fluxes (½ (f_hi + f⁺) on the 9 matter rows, the wave speed
// widened to the cleaning speed) and the NCP halves.
int exahype_aderdg_face_flux_2d_z4_grmhd_f32(
    const float* faces, float* fhat, float* fhalf, const double* ops, const double* dx,
    int order, int physics, const double* params, long long g0, long long g1, long long g2,
    void* stream) {
  return z4_2d_face_flux<float, Z4Cell2P2, Z4Grmhd>(
      faces, fhat, fhalf, ops, dx, order, physics, params, g0, g1, g2, stream);
}

// The face stage's second launch: the update of `state` in place.
int exahype_aderdg_surface_update_2d_z4_grmhd_f32(
    float* state, const float* fhat, const float* fhalf, const float* dt_ptr, double dt_val,
    const double* ops, const double* dx, int order, int physics, const double* params,
    long long g0, long long g1, long long g2, void* stream) {
  return z4_2d_surface_update<float, Z4Cell2P2, Z4Grmhd>(
      state, fhat, fhalf, dt_ptr, dt_val, ops, dx, order, physics, params, g0, g1, g2, stream);
}

}  // extern "C"

// Their occupancy, for exahype_aderdg_kernel_info (kernels 61-64 of physics
// 6, csrc/aderdg.cu): `which` 0 the fused predictor, 1 face flux, 2 update,
// 3 the per-axis predictor.
int z4_grmhd_2d_info_f32(int which, int* out) {
  return z4_form_info<float, Z4Cell2P2, Z4Grmhd>(which, out);
}
