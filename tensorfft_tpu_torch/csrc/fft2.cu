// Entry point of the 2D row-column FFT's column pass on (B, H, W) planes
// (the row pass is fft2_row.cu): the two passes of K4,
// tensorfft_tpu/ops/four_step_pallas.py:fft2_fused, as the kTwiddle = false
// column pass and the in-place row pass of four_step_passes.cuh.
//
// What bounds them on the H100: as kernels B and C, the stage products, on
// the tensor cores (four_step_tc.cuh; past one CTA, the twins of
// cluster_col_tc.cuh and cluster_tc.cuh).  Beyond that, the column
// pass reads and writes H-strided columns, T adjacent columns per CTA (T = 4
// at H = W = 4096, so 8-byte runs in bf16, a quarter of a 32-byte sector);
// the row pass reads and stores its rows contiguously.
#include "four_step_passes.cuh"

// Every entry point returns a cudaError_t code (or kErrClusterUnschedulable;
// cluster: CTAs per tile of T columns, four_step_passes.cuh; mats: the
// bf16 matrices, col_pass).  n1 = H, n2 = W.

// Column pass: H-point FFTs down every column, no twiddle -> `mid` (B, H, W)
// in the storage dtype.  Replaces the pallas_call at four_step_pallas.py:646.
extern "C" int tfft_fft2_col(const void* in_re, const void* in_im,
                             void* mid_re, void* mid_im, int dtype,
                             int data_terms, long long batch, int h, int w,
                             int T, int cluster, const void* tables,
                             const void* mats, const long long* meta,
                             void* stream) {
  return tfft::col_pass<false, false>(in_re, in_im, mid_re, mid_im, dtype,
                                      data_terms, batch, h, w, T, cluster,
                                      tables, mats, meta, nullptr, nullptr, 0,
                                      stream);
}
