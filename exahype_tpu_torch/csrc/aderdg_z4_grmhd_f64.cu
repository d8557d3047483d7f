// The coupled Z4+GRMHD step's kernels (csrc/aderdg_z4.cuh over
// csrc/z4_grmhd.cuh): their float64 instances and their C interface (the
// float32 launchers' arguments, csrc/aderdg_z4_grmhd.cu, in double).

#include "aderdg_z4.cuh"

extern "C" {

int exahype_aderdg_predictor_volume_z4_grmhd_f64(const double* u, double* out, double* faces,
                                                 const double* dt_ptr, double dt_val,
                                                 const double* ops, const double* dx, int order,
                                                 int picard_iters, int physics,
                                                 const double* params, long long g0,
                                                 long long g1, long long g2, void* stream) {
  return z4_predictor_volume<double, Z4Grmhd>(u, out, faces, dt_ptr, dt_val, ops, dx, order,
                                              picard_iters, physics, params, g0, g1, g2, stream);
}

int exahype_aderdg_face_flux_z4_grmhd_f64(const double* faces, double* fhat, double* fhalf,
                                          const double* ops, const double* dx, int order,
                                          int physics, const double* params, long long g0,
                                          long long g1, long long g2, void* stream) {
  return z4_face_flux<double, Z4Grmhd>(faces, fhat, fhalf, ops, dx, order, physics, params, g0,
                                       g1, g2, stream);
}

int exahype_aderdg_surface_update_z4_grmhd_f64(double* state, const double* fhat,
                                               const double* fhalf, const double* dt_ptr,
                                               double dt_val, const double* ops,
                                               const double* dx, int order, int physics,
                                               const double* params, long long g0, long long g1,
                                               long long g2, void* stream) {
  return z4_surface_update<double, Z4Grmhd>(state, fhat, fhalf, dt_ptr, dt_val, ops, dx, order,
                                            physics, params, g0, g1, g2, stream);
}

}  // extern "C"

// The float64 Z4+GRMHD kernels' occupancy, for exahype_aderdg_kernel_info
// (kernels 16-18 of physics 6, csrc/aderdg.cu).
int z4_grmhd_kernel_info_f64(int which, int* out) {
  return z4_info<double, Z4Grmhd>(which, out);
}
