// The coupled Z4+GRMHD step's kernels (csrc/aderdg_z4.cuh over the
// 47-variable system of csrc/z4_grmhd.cuh, with its conservative flux on the
// fluid, field and cleaning rows): their float32 instances and their C
// interface.

#include "aderdg_z4.cuh"

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns the launch's
// cudaError_t.  physics must be 6 (the Z4+GRMHD system), params its
// (slicing id: 0 harmonic, 1 1+log; f; m; kappa1; kappa2; gamma; the
// recovery's Newton iterations; c_h; glm_kappa), order 2.
//
// The predictor takes exahype_aderdg_predictor_volume_*'s arguments
// (csrc/aderdg.cu) and writes `out` (the state after the cell-local half
// of the step) and `faces` ([3][4][9][47][cell]; the f rows carry the
// matter flux's projections, zero on the Z4 rows).
int exahype_aderdg_predictor_volume_z4_grmhd_f32(const float* u, float* out, float* faces,
                                                 const float* dt_ptr, double dt_val,
                                                 const double* ops, const double* dx, int order,
                                                 int picard_iters, int physics,
                                                 const double* params, long long g0,
                                                 long long g1, long long g2, void* stream) {
  return z4_predictor_volume<float, Z4Grmhd>(u, out, faces, dt_ptr, dt_val, ops, dx, order,
                                             picard_iters, physics, params, g0, g1, g2, stream);
}

// The face stage's first launch: fhat and fhalf, [3][9][47][cell] each, the
// Rusanov fluxes and the NCP half-fluctuations of each cell's high faces.
int exahype_aderdg_face_flux_z4_grmhd_f32(const float* faces, float* fhat, float* fhalf,
                                          const double* ops, const double* dx, int order,
                                          int physics, const double* params, long long g0,
                                          long long g1, long long g2, void* stream) {
  return z4_face_flux<float, Z4Grmhd>(faces, fhat, fhalf, ops, dx, order, physics, params, g0,
                                      g1, g2, stream);
}

// The face stage's second launch: the update of `state` in place.
int exahype_aderdg_surface_update_z4_grmhd_f32(float* state, const float* fhat,
                                               const float* fhalf, const float* dt_ptr,
                                               double dt_val, const double* ops,
                                               const double* dx, int order, int physics,
                                               const double* params, long long g0, long long g1,
                                               long long g2, void* stream) {
  return z4_surface_update<float, Z4Grmhd>(state, fhat, fhalf, dt_ptr, dt_val, ops, dx, order,
                                           physics, params, g0, g1, g2, stream);
}

}  // extern "C"

// The float32 Z4+GRMHD kernels' occupancy, for exahype_aderdg_kernel_info
// (kernels 16-18 of physics 6, csrc/aderdg.cu): `which` 0 predictor, 1 face
// flux, 2 update.
int z4_grmhd_kernel_info_f32(int which, int* out) { return z4_info<float, Z4Grmhd>(which, out); }
