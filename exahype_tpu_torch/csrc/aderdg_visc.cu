// The viscous predictor (csrc/aderdg_visc.cuh): its float32 instances and
// their C interface.

#include "aderdg_visc.cuh"

extern "C" {

// The viscous predictor's launchers: the arguments of
// exahype_aderdg_predictor_volume_* (csrc/aderdg.cu; physics must be 2,
// params as the Navier–Stokes face stage takes them), then wall_mask (bit
// d: grid axis d walled; 0: periodic, no wall planes), planes (the
// viscous-only wall fluxes out, [side][wall axis][n²][n_vars][plane], axis
// d's block at element wall_off[d] of a side, side 1 at element
// wall_side), wall_off and wall_side.  Returns the launch's cudaError_t.
int exahype_aderdg_predictor_volume_visc_f32(const float* u, float* out, float* faces,
                                             const float* dt_ptr, double dt_val,
                                             const double* ops, const double* dx, int order,
                                             int picard_iters, int physics,
                                             const double* params, long long g0, long long g1,
                                             long long g2, int wall_mask, float* planes,
                                             const long long* wall_off, long long wall_side,
                                             void* stream) {
  return predictor_volume_visc<float>(u, out, faces, dt_ptr, dt_val, ops, dx, order,
                                      picard_iters, physics, params, g0, g1, g2, wall_mask,
                                      planes, wall_off, wall_side, stream);
}

}  // extern "C"

// The float32 viscous predictor's occupancy, for
// exahype_aderdg_kernel_info (kernels 6 and 7, csrc/aderdg.cu): out[0..4]
// without (wall_planes = 0) or with the wall planes.
int visc_predictor_info_f32(int wall_planes, int* out) {
  return shape_info(wall_planes ? visc_predictor_shape<float, true>()
                                : visc_predictor_shape<float, false>(),
                    out);
}
