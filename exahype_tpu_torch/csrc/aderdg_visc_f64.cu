// The viscous predictor (csrc/aderdg_visc.cuh): its float64 instances and
// their C interface.

#include "aderdg_visc.cuh"

extern "C" {

// The float64 launcher: the float32 one's arguments (csrc/aderdg_visc.cu)
// in double.
int exahype_aderdg_predictor_volume_visc_f64(const double* u, double* out, double* faces,
                                             const double* dt_ptr, double dt_val,
                                             const double* ops, const double* dx, int order,
                                             int picard_iters, int physics,
                                             const double* params, long long g0, long long g1,
                                             long long g2, int wall_mask, double* planes,
                                             const long long* wall_off, long long wall_side,
                                             void* stream) {
  return predictor_volume_visc<double>(u, out, faces, dt_ptr, dt_val, ops, dx, order,
                                       picard_iters, physics, params, g0, g1, g2, wall_mask,
                                       planes, wall_off, wall_side, stream);
}

}  // extern "C"

// The float64 viscous predictor's occupancy, for
// exahype_aderdg_kernel_info (kernels 6 and 7, csrc/aderdg.cu): out[0..4]
// without (wall_planes = 0) or with the wall planes.
int visc_predictor_info_f64(int wall_planes, int* out) {
  return shape_info(wall_planes ? visc_predictor_shape<double, true>()
                                : visc_predictor_shape<double, false>(),
                    out);
}
