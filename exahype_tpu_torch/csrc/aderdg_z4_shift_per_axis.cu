// K1 d's per-axis NCP branch of the shifted system on the 3-D order-2 cell
// (csrc/aderdg_z4.cuh's predictor with kPerAxis over the 53-variable system
// of csrc/z4_shift.cuh): its float32 instance and its C interface.  Its face
// stage is the fused step's (csrc/aderdg_z4_shift.cu's
// exahype_aderdg_face_flux_z4_shift_f32 and
// exahype_aderdg_surface_update_z4_shift_f32): the Rusanov flux and the NCP
// halves do not depend on how the predictor splits the algebra.

#include "aderdg_z4.cuh"

extern "C" {

// The predictor of a make_z4_shift_solver(..., fused_rhs=False) solver, the
// JAX package's default build: per Picard iteration and point the source
// rhs(q, 0) and one evaluation rhs(q, e_d D_d q) an axis (the gradient rows
// of the 43 slots the algebra reads, β's skipped), then the source average
// and the per-axis NCP volume term;
// exahype_aderdg_predictor_volume_z4_shift_f32's arguments and outputs.
int exahype_aderdg_predictor_volume_per_axis_z4_shift_f32(
    const float* u, float* out, float* faces, const float* dt_ptr, double dt_val,
    const double* ops, const double* dx, int order, int picard_iters, int physics,
    const double* params, long long g0, long long g1, long long g2, void* stream) {
  return z4_predictor_volume<float, Z4Shift, Z4Cell3, true>(u, out, faces, dt_ptr, dt_val, ops,
                                                          dx, order, picard_iters, physics,
                                                          params, g0, g1, g2, stream);
}

}  // extern "C"

// Its occupancy, for exahype_aderdg_kernel_info (kernel 65 of physics 4,
// csrc/aderdg.cu).
int z4_shift_per_axis_info_f32(int* out) {
  return shape_info(z4_predictor_shape<float, Z4Shift, Z4Cell3, true>(), out);
}
