// The in-place row pass's launcher (kernel C of four_step_passes.cuh
// storing in place, on the tensor-core engine: its one-CTA tiles and its
// cluster twin), shared by K3 (fused_batch_major.cu) and K4's row pass
// (fft2_row.cu).
#pragma once

#include "four_step_passes.cuh"
#include "row_pass_tc.cuh"

namespace tfft {

// One CTA per tile of T rows (launch_row_tc), or a cluster of `cluster`
// CTAs per row (T = 1; launch_row_cluster_tc, storing in place).
template <typename S, int BT>
int launch_in_place_row(const void* mid_re, const void* mid_im, void* out_re,
                        void* out_im, long long batch, int n1, int n2, int T,
                        int cluster, const StagePlan& plan,
                        const float* tables, const __nv_bfloat16* mats,
                        cudaStream_t stream) {
  if (cluster == 1)
    return launch_row_tc<S, BT>(mid_re, mid_im, out_re, out_im, batch, n1, n2,
                                T, plan, tables, mats, stream);
  return launch_row_cluster_tc<S, BT>(mid_re, mid_im, out_re, out_im, batch,
                                      n1, n2, cluster, 0, plan, tables, mats,
                                      stream);
}

// The in-place row pass: `mats` holds the bf16 matrices (meta's offsets in
// bf16 units), `tables` the fp32 twiddles.  Returns a cudaError_t code, or
// kErrClusterUnschedulable.
inline int in_place_row_pass(const void* mid_re, const void* mid_im,
                             void* out_re, void* out_im, int dtype,
                             int data_terms, long long batch, int n1, int n2,
                             int T, int cluster, const void* tables,
                             const void* mats, const long long* meta,
                             void* stream) {
  StagePlan plan;
  if (!read_plan(meta, &plan) || !lanes_ok(n2, n1, T, cluster) || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* tab = static_cast<const float*>(tables);
  const __nv_bfloat16* m = static_cast<const __nv_bfloat16*>(mats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFFT_ROW_IP(S, BT)                                                 \
  return launch_in_place_row<S, BT>(mid_re, mid_im, out_re, out_im, batch, \
                                    n1, n2, T, cluster, plan, tab, m, s)
  if (dtype == 0 && data_terms == 1) TFFT_ROW_IP(__nv_bfloat16, 1);
  if (dtype == 1 && data_terms == 2) TFFT_ROW_IP(float, 2);
  if (dtype == 1 && data_terms == 3) TFFT_ROW_IP(float, 3);
#undef TFFT_ROW_IP
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tfft
