// Kernels B and C: the two passes of the Bailey four-step FFT on batch-major
// (B, N) planes, N = n1 * n2, viewed as (B, n1, n2).  Templates shared by
// the C2C entry points (four_step_fft.cu, four_step_row.cu), the R2C ones
// (four_step_real.cu, four_step_real_row.cu) and the 2D ones (fft2.cu,
// fft2_row.cu), which nvcc compiles in parallel.
//
// Kernel B (column pass) replaces K2c, tensorfft_tpu/ops/four_step_pallas.py
// _col_kernel (pallas_call at :465), and K2cg, _col_kernel_gridslice (:422):
// n1-point FFTs down the columns, then the four-step twiddle
// w[k1, j2] = P[k1, j2 / t] * Q[k1, j2 % t] rebuilt from the same
// rank-separated fp32 tables, and a store of `mid` in the STORAGE dtype
// (bf16 under the bf16 policy), exactly where the TPU kernel rounds it.
//
// Kernel C (row pass) replaces K2r, _row_kernel (pallas_call at :551), and
// K2rg, _row_kernel_gridslice (:516): n2-point FFTs of each k1 row of `mid`,
// stored transposed at out[b, k2, k1], so the output (B, n2, n1) is the
// natural-order spectrum with no third pass.
//
// The real-to-complex path adds one variant of each, differing only in a
// load or a store map (the kPassPairs bit of four_step_tc_kernel and of
// kernel B's cluster twin, the kRowPairs bit of kernel C's):
//   K5 (four_step_pallas.py:four_step_fft_packed_real, pallas_call at :943,
//   _col_kernel_packed) is kernel B reading the half-length packed view of
//   a real (B, 2N) row: element (j1, j2) of the even and odd planes is
//   x[b, j1*2*n2 + 2*j2 + {0, 1}].  Its row pass is kernel C unchanged.
//   K6 (four_step_fft_to_real, pallas_call at :1229, _row_kernel_interleave)
//   is kernel C storing output bin (k2, k1) interleaved into a real (B, 2N)
//   row at x[b, k2*2*n1 + 2*k1 + {0, 1}], rounded to the storage dtype where
//   kernel C rounds it.  Its column pass is kernel B unchanged.
// The TPU kernels deinterleave and interleave with a permutation matmul per
// panel; here the map is folded into the addresses, so neither costs a pass.
//
// The 2D row-column FFT (K4, four_step_pallas.py:fft2_fused, pallas_calls at
// :646 and :677; entry points in fft2.cu) is the same two passes on (B, H, W)
// planes with n1 = H, n2 = W, minus the twiddle and the digit swap:
//   kTwiddle = false: kernel B stores the column FFTs as `mid` (B, H, W) with
//   no P/Q product (_col_kernel(twiddle=False));
//   the in-place row pass: kernel C stores row k1's bin k2 in place at
//   out[b, k1, k2] (_row_kernel(transposed=False), whose VMEM transpose
//   restores the (kh, kw) layout; in_place_row.cuh, row_pass_tc.cuh).
//
// Every pass runs the plan's stage engine: stacked, stacked with knobs, or
// planar (K1b), a template parameter chosen at launch from the plan; folds,
// roundings and mult3 are per stage.  The JAX package's gridslice passes
// (K2cg, K2rg and K6's column pass) defer a TPU interleave to strided
// stores; these passes store every output to its place already, so a
// gridslice plan runs them unchanged.
//
// K3 (four_step_pallas.py:fused_fft_batch_major, pallas_call at :768) is the
// in-place row pass over a (1, B, N) view: a tile of T adjacent rows per
// CTA, read row-contiguous and transposed into the shared-memory operand
// (the TPU's in-VMEM transpose), stored in place; entry point in
// fused_batch_major.cu.
//
// What bounds them on the H100.  Every pass runs on the tensor-core engine
// (fft_mma.cuh; kernels B and C through four_step_tc.cuh, K3 and K4's row
// pass through row_pass_tc.cuh): its shared-matrix stages are bf16 mma.sync
// products, as in kernel A.  Beyond them, kernel B reads and writes columns
// strided by n2 and kernel C writes strided by n1.  Each CTA therefore
// takes T adjacent columns (B) or rows (C), as many as one CTA's n*T <=
// 16384 elements allow (capped at 64), so the strided side moves T
// contiguous elements per row, in one access of up to 16 bytes (8 bytes at
// K4's T = 4 in bf16).  A pass longer than one CTA holds (n > 16384, or
// bf16x6 with mult3's third operand plane at n = 16384) takes a
// thread-block cluster of 2, 4 or 8 CTAs, as the JAX package runs a
// 32768-point pass in one VMEM panel; every kernel here, K3, K4, K5 and K6
// included, takes it, on the tensor-core engine's cluster mode: the row
// passes' twin one row per cluster (row_cluster_kernel, cluster_tc.cuh),
// kernel B's a tile of T adjacent columns per cluster (col_cluster_tc_kernel,
// cluster_col_tc.cuh), T and the cluster chosen by fused_cuda's
// column-cluster rule.
#pragma once

#include "cluster_col_tc.cuh"
#include "cluster_tc.cuh"
#include "four_step_tc.cuh"

namespace tfft {

// T transforms of length n per CTA (cluster == 1), or one per cluster of
// `cluster` CTAs: the one-CTA kernels and the row passes' twin (kernel B's
// takes T per cluster, col_pass).
inline bool lanes_ok(int n, int other, int T, int cluster) {
  return T >= 1 && other % T == 0 && (cluster == 1 || T == 1) &&
         cluster_ok(n, T, cluster);
}

// Launch a column pass for the storage/operand pair of a policy: dtype 0
// bf16 (with 1 data term), 1 fp32 (with 2 or 3), T columns per CTA
// (cluster 1, four_step_tc.cuh) or per cluster of 2, 4 or 8 CTAs
// (cluster_col_tc.cuh), both on the tensor-core engine, reading the bf16
// matrices `mats` (meta's offsets in bf16 units) and the twiddles of the
// fp32 `tables`.  p, q and t are read only with kTwiddle.  Returns a
// cudaError_t code, or kErrClusterUnschedulable.
template <bool kPacked, bool kTwiddle>
int col_pass(const void* in_re, const void* in_im, void* mid_re,
             void* mid_im, int dtype, int data_terms, long long batch, int n1,
             int n2, int T, int cluster, const void* tables, const void* mats,
             const long long* meta, const void* p, const void* q, int t,
             void* stream) {
  StagePlan plan;
  if (!read_plan(meta, &plan) || T < 1 || n2 % T != 0 ||
      !cluster_ok(n1, T, cluster) || batch < 1 ||
      (kTwiddle && (t < 1 || n2 % t != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* tab = static_cast<const float*>(tables);
  const __nv_bfloat16* m = static_cast<const __nv_bfloat16*>(mats);
  const float* pp = static_cast<const float*>(p);
  const float* qq = static_cast<const float*>(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int io = (kPacked ? kPassPairs : 0) | (kTwiddle ? kPassTwiddle : 0);
#define TFFT_COL(S, BT)                                                      \
  return cluster == 1                                                        \
             ? launch_four_step_tc<S, BT>(in_re, in_im, mid_re, mid_im,      \
                                          batch, n1, n2, T, io, plan, tab, m, \
                                          pp, qq, t, s)                       \
             : launch_col_cluster_tc<S, BT>(in_re, in_im, mid_re, mid_im,    \
                                            batch, n1, n2, T, cluster, io,   \
                                            plan, tab, m, pp, qq, t, s)
  if (dtype == 0 && data_terms == 1) TFFT_COL(__nv_bfloat16, 1);
  if (dtype == 1 && data_terms == 2) TFFT_COL(float, 2);
  if (dtype == 1 && data_terms == 3) TFFT_COL(float, 3);
#undef TFFT_COL
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launch a transposed row pass (kernel C; K6 with kInterleave): T rows per
// CTA, or `cluster` CTAs per row (T = 1, launch_row_cluster_tc), both on the
// tensor-core engine, reading the bf16 `mats` and the fp32 twiddles of
// `tables`.
template <bool kInterleave>
int row_pass(const void* mid_re, const void* mid_im, void* out_re,
             void* out_im, int dtype, int data_terms, long long batch, int n1,
             int n2, int T, int cluster, const void* tables, const void* mats,
             const long long* meta, void* stream) {
  StagePlan plan;
  if (!read_plan(meta, &plan) || !lanes_ok(n2, n1, T, cluster) || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* tab = static_cast<const float*>(tables);
  const __nv_bfloat16* m = static_cast<const __nv_bfloat16*>(mats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int io = kPassRow | (kInterleave ? kPassPairs : 0);
#define TFFT_ROW(S, BT)                                                       \
  return cluster == 1                                                         \
             ? launch_four_step_tc<S, BT>(mid_re, mid_im, out_re, out_im,     \
                                          batch, n1, n2, T, io, plan, tab, m, \
                                          nullptr, nullptr, 0, s)             \
             : launch_row_cluster_tc<S, BT>(                                  \
                   mid_re, mid_im, out_re, out_im, batch, n1, n2, cluster,    \
                   kRowTransposed | (kInterleave ? kRowPairs : 0), plan, tab, \
                   m, s)
  if (dtype == 0 && data_terms == 1) TFFT_ROW(__nv_bfloat16, 1);
  if (dtype == 1 && data_terms == 2) TFFT_ROW(float, 2);
  if (dtype == 1 && data_terms == 3) TFFT_ROW(float, 3);
#undef TFFT_ROW
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tfft

