// Entry point of the 2D row-column FFT's row pass on (B, H, W) planes (K4;
// see fft2.cu), on the tensor-core engine (in_place_row.cuh).
#include "in_place_row.cuh"

// Returns a cudaError_t code (or kErrClusterUnschedulable; cluster: CTAs
// per row; mats: the bf16 matrices, on one CTA and on a cluster,
// in_place_row_pass).
// n1 = H, n2 = W.

// Row pass: W-point FFTs of every row of `mid`, stored in place, so the
// output (B, H, W) is (B, kh, kw) in natural order.  Replaces the
// pallas_call at four_step_pallas.py:677.
extern "C" int tfft_fft2_row(const void* mid_re, const void* mid_im,
                             void* out_re, void* out_im, int dtype,
                             int data_terms, long long batch, int h, int w,
                             int T, int cluster, const void* tables,
                             const void* mats, const long long* meta,
                             void* stream) {
  return tfft::in_place_row_pass(mid_re, mid_im, out_re, out_im, dtype,
                                 data_terms, batch, h, w, T, cluster, tables,
                                 mats, meta, stream);
}
