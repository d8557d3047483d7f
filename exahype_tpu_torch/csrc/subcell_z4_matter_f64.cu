// The limiter's subcell sweep over the 43-variable Z4+GRHD system
// (csrc/subcell_ncp.cuh over Z4MatterSweep): its float64 instance and its C
// interface (csrc/subcell_z4_matter.cu's arguments, in double).

#include "subcell_ncp.cuh"

extern "C" {

int exahype_subcell_row_sweep_z4_matter_f64(const double* s, double* s_out,
                                            const double* ghost_lo, const double* ghost_hi,
                                            double* g_lo, double* g_hi, const double* dt_ptr,
                                            double dt_val, double h, const double* params,
                                            int dim, int n_sub, int n_vars, int d,
                                            const long long* n_active, long long n_slots,
                                            long long L, void* stream) {
  return ncp_row_sweep<double, 5, Z4MatterSweep>(s, s_out, ghost_lo, ghost_hi, g_lo, g_hi,
                                                 dt_ptr, dt_val, h, params, dim, n_sub, n_vars,
                                                 d, n_active, n_slots, L, stream);
}

int subcell_z4_matter_info_f64(int d, int* out) {
  return ncp_kernel_info<double, 5, Z4MatterSweep>(d, out);
}

}  // extern "C"
