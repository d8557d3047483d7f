// The order-4 space-time predictor (csrc/aderdg_st.cuh): its float32
// instance for 3-D Euler (NN = 5) and its C interface.  The face stage of
// the order-4 step is csrc/aderdg.cu's (exahype_aderdg_face_flux_p4_*,
// exahype_aderdg_surface_update_p4_*, and their _walls_p4 variants).

#include "aderdg_st.cuh"

extern "C" {

// The launcher: exahype_aderdg_predictor_volume_*'s arguments
// (csrc/aderdg.cu); physics must be 0 (Euler, params = {gamma}), order 4.
// Writes `out` (the state after the cell-local half of the step) and
// `faces` ([3][4][25][5][cell]).  Returns the launch's cudaError_t.
int exahype_aderdg_predictor_volume_p4_f32(const float* u, float* out, float* faces,
                                           const float* dt_ptr, double dt_val,
                                           const double* ops, const double* dx, int order,
                                           int picard_iters, int physics, const double* params,
                                           long long g0, long long g1, long long g2,
                                           void* stream) {
  return st_predictor_volume<float, 5>(u, out, faces, dt_ptr, dt_val, ops, dx, order,
                                      picard_iters, physics, params, g0, g1, g2, stream);
}

}  // extern "C"

// The float32 predictor's occupancy, for exahype_aderdg_kernel_info (kernel
// 36 of physics 0, csrc/aderdg.cu).
int st_predictor_p4_info_f32(int* out) {
  return shape_info(st_predictor_shape<float, 5, EulerPhysics<float>>(), out);
}
