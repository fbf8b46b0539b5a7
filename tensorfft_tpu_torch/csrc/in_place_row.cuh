// The in-place row pass's launcher (kernel C of four_step_passes.cuh
// storing in place, with its one-CTA tiles on the tensor-core engine),
// shared by K3 (fused_batch_major.cu) and K4's row pass (fft2_row.cu).
#pragma once

#include "four_step_passes.cuh"
#include "row_pass_tc.cuh"

namespace tfft {

// One CTA per tile of T rows on the tensor-core engine (launch_row_tc), or a
// cluster of `cluster` CTAs per row (T = 1) on row_cluster_kernel.
template <typename S, int BT, int kEngine>
int launch_in_place_row(const void* mid_re, const void* mid_im, void* out_re,
                        void* out_im, long long batch, int n1, int n2, int T,
                        int cluster, const StagePlan& plan,
                        const float* tables, const __nv_bfloat16* mats,
                        cudaStream_t stream) {
  if (cluster == 1)
    return launch_row_tc<S, BT>(mid_re, mid_im, out_re, out_im, batch, n1, n2,
                                T, plan, tables, mats, stream);
  const int elems = n2 * T / cluster;
  return launch_stage_kernel(
      &row_cluster_kernel<S, BT, false, false, cluster_engine<kEngine>()>,
      batch * (n1 / T), elems < kThreads ? elems : kThreads,
      operand_bytes(elems, BT, plan.sum_plane), cluster, stream,
      static_cast<const S*>(mid_re), static_cast<const S*>(mid_im),
      static_cast<S*>(out_re), static_cast<S*>(out_im), n1, n2, T, plan,
      tables);
}

// The in-place row pass with the one-CTA tiles on the tensor-core engine:
// `mats` holds their bf16 matrices (meta's offsets in bf16 units); a
// cluster reads the fp32 `tables` (offsets in fp32 units).  Returns a
// cudaError_t code, or kErrClusterUnschedulable.
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
#define TFFT_ROW_IP(S, BT, E)                                                 \
  return launch_in_place_row<S, BT, E>(mid_re, mid_im, out_re, out_im, batch, \
                                       n1, n2, T, cluster, plan, tab, m, s)
#define TFFT_ROW_IP_ENGINE(S, BT)                                \
  if (plan.engine == kEngPlanar) TFFT_ROW_IP(S, BT, kEngPlanar); \
  if (plan.engine == kEngKnobs) TFFT_ROW_IP(S, BT, kEngKnobs);   \
  TFFT_ROW_IP(S, BT, kEngStacked)
  if (dtype == 0 && data_terms == 1) { TFFT_ROW_IP_ENGINE(__nv_bfloat16, 1); }
  if (dtype == 1 && data_terms == 2) { TFFT_ROW_IP_ENGINE(float, 2); }
  if (dtype == 1 && data_terms == 3) { TFFT_ROW_IP_ENGINE(float, 3); }
#undef TFFT_ROW_IP_ENGINE
#undef TFFT_ROW_IP
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tfft
