// The limiter's subcell sweep over the 43-variable Z4+GRHD system
// (csrc/subcell_ncp.cuh over Z4MatterSweep, 3-D, n_sub = 5: order 2): its
// float32 instance and its C interface.

#include "subcell_ncp.cuh"

extern "C" {

// Enqueues one sweep along sub-axis d on `stream` and returns the launch's
// cudaError_t (0 = cudaSuccess), csrc/subcell.cu's arguments with the
// system's parameters in place of γ: params (slicing id: 0 harmonic, 1
// 1+log; f; m; kappa1; kappa2; gamma; the recovery's Newton iterations).
// s_out may be s (in place); h = dx_d / n_sub; n_active a device int64
// scalar.  Only dim 3, n_sub 5 and 43 variables are instantiated; anything
// else returns cudaErrorInvalidValue.
int exahype_subcell_row_sweep_z4_matter_f32(const float* s, float* s_out, const float* ghost_lo,
                                            const float* ghost_hi, float* g_lo, float* g_hi,
                                            const float* dt_ptr, double dt_val, double h,
                                            const double* params, int dim, int n_sub,
                                            int n_vars, int d, const long long* n_active,
                                            long long n_slots, long long L, void* stream) {
  return ncp_row_sweep<float, 5, Z4MatterSweep>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi,
                                                dt_ptr, dt_val, h, params, dim, n_sub, n_vars,
                                                d, n_active, n_slots, L, stream);
}

int subcell_z4_matter_info_f64(int d, int* out);

// How direction d's kernel launches on the current card (f64 0 or 1): out =
// {registers a thread, resident blocks an SM, threads a block, shared memory
// bytes a block, local (spill) bytes a thread, 0}.
int exahype_subcell_z4_matter_kernel_info(int f64, int d, int* out) {
  return f64 ? subcell_z4_matter_info_f64(d, out)
             : ncp_kernel_info<float, 5, Z4MatterSweep>(d, out);
}

}  // extern "C"
