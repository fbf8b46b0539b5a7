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

namespace tfft {

// K4's column pass on the scalar engine, one CTA per tile of T columns
// (col_pass_kernel, kTwiddle = false), reading the fp32 `tables`: each
// output summed by fmaf in r order, not in the tensor-core engine's chunk
// order, a reference the tests hold kernel A's cluster twin against at the
// fused bound.  Returns a cudaError_t code.
inline int col_pass_scalar(const void* in_re, const void* in_im, void* mid_re,
                           void* mid_im, int dtype, int data_terms,
                           long long batch, int n1, int n2, int T,
                           const void* tables, const long long* meta,
                           void* stream) {
  StagePlan plan;
  if (!read_plan(meta, &plan) || !lanes_ok(n1, n2, T, 1) || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* tab = static_cast<const float*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elems = n1 * T;
#define TFFT_COL_SCALAR(S, BT, E)                                             \
  return launch_stage_kernel(                                                 \
      &col_pass_kernel<S, BT, false, false, E>, batch * (n2 / T),             \
      elems < kThreads ? elems : kThreads,                                    \
      operand_bytes(elems, BT, plan.sum_plane), 1, s,                         \
      static_cast<const S*>(in_re), static_cast<const S*>(in_im),             \
      static_cast<S*>(mid_re), static_cast<S*>(mid_im), n1, n2, T, plan, tab, \
      nullptr, nullptr, 0)
#define TFFT_COL_SCALAR_ENGINE(S, BT)                                 \
  if (plan.engine == kEngPlanar) TFFT_COL_SCALAR(S, BT, kEngPlanar);  \
  if (plan.engine == kEngKnobs) TFFT_COL_SCALAR(S, BT, kEngKnobs);    \
  TFFT_COL_SCALAR(S, BT, kEngStacked)
  if (dtype == 0 && data_terms == 1) { TFFT_COL_SCALAR_ENGINE(__nv_bfloat16, 1); }
  if (dtype == 1 && data_terms == 2) { TFFT_COL_SCALAR_ENGINE(float, 2); }
  if (dtype == 1 && data_terms == 3) { TFFT_COL_SCALAR_ENGINE(float, 3); }
#undef TFFT_COL_SCALAR_ENGINE
#undef TFFT_COL_SCALAR
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tfft

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

// The same column pass, one CTA per tile, on the scalar engine
// (col_pass_scalar): the scalar engine's summation order on one CTA, a
// reference kernel A's twin is held against at the fused bound.
extern "C" int tfft_fft2_col_scalar(const void* in_re, const void* in_im,
                                    void* mid_re, void* mid_im, int dtype,
                                    int data_terms, long long batch, int h,
                                    int w, int T, const void* tables,
                                    const long long* meta, void* stream) {
  return tfft::col_pass_scalar(in_re, in_im, mid_re, mid_im, dtype,
                               data_terms, batch, h, w, T, tables, meta,
                               stream);
}
