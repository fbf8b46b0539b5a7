// The in-place row pass on the tensor-core engine: K3 (fused_batch_major.cu)
// and K4's row pass (fft2_row.cu), kernel C storing in place
// (four_step_passes.cuh).  A tile of T rows per CTA runs run_fft_tc
// (fft_mma.cuh) on its T consecutive rows, the maps of the in-place
// row_cluster_kernel (cluster_tc.cuh); launch_row_tc is compiled once
// per storage/operand pair, in row_pass_tc{1,2,3}.cu, so nvcc builds the
// three in parallel and the two entry points share them (in_place_row.cuh).
// Kernel C and K6 (the transposed and interleaving row passes) run
// four_step_tc_kernel (four_step_tc.cuh).
#pragma once

#include "fft_mma.cuh"

namespace tfft {

template <typename S, int BT, int kEngine>
__global__ void __launch_bounds__(kThreads)
    row_pass_tc_kernel(const S* __restrict__ mid_re,
                       const S* __restrict__ mid_im, S* __restrict__ out_re,
                       S* __restrict__ out_im, int n1, int n2, int T,
                       StagePlan plan, const __nv_bfloat16* __restrict__ mats,
                       const float* __restrict__ tables) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = n1 / T;
  const long long b = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - static_cast<int>(b) * tiles) * T;
  const long long base = b * n1 * n2;
  auto load = [&](int qi, int& idx, float& re, float& im) {
    // q runs along the row (i fastest) so the global read is contiguous.
    const int lane = qi / n2, i = qi - lane * n2;
    idx = i * T + lane;
    const long long at = base + static_cast<long long>(r0 + lane) * n2 + i;
    re = to_float(mid_re[at]);
    im = to_float(mid_im[at]);
  };
  auto store = [&](int k2, int lane, float re, float im) {
    const long long at = base + static_cast<long long>(r0 + lane) * n2 + k2;
    out_re[at] = from_float<S>(re);
    out_im[at] = from_float<S>(im);
  };
  // The tile's T rows are consecutive: row r0 + lane at lane * n2.
  const long long first = base + static_cast<long long>(r0) * n2;
  run_fft_tc<S, BT, kEngine>(reinterpret_cast<__nv_bfloat16*>(smem), n2, T,
                             plan, mats, tables, load, store, mid_re + first,
                             mid_im + first, out_re + first, out_im + first);
}

// One CTA per tile of T rows: the plan's engine, its bf16 matrices `mats`
// and the fp32 twiddles in `tables`.  Returns a cudaError_t code.
template <typename S, int BT>
int launch_row_tc(const void* mid_re, const void* mid_im, void* out_re,
                  void* out_im, long long batch, int n1, int n2, int T,
                  const StagePlan& plan, const float* tables,
                  const __nv_bfloat16* mats, cudaStream_t stream) {
  if (mats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int elems = n2 * T;
#define TFFT_ROW_TC(E)                                                        \
  return launch_stage_kernel(&row_pass_tc_kernel<S, BT, E>, batch * (n1 / T), \
                             tc_threads(elems),                               \
                             operand_bytes(elems, BT, plan.sum_plane), 1,     \
                             stream, static_cast<const S*>(mid_re),           \
                             static_cast<const S*>(mid_im),                   \
                             static_cast<S*>(out_re), static_cast<S*>(out_im), \
                             n1, n2, T, plan, mats, tables)
  if (plan.engine == kEngPlanar) TFFT_ROW_TC(kEngPlanar);
  if (plan.engine == kEngKnobs) TFFT_ROW_TC(kEngKnobs);
  TFFT_ROW_TC(kEngStacked);
#undef TFFT_ROW_TC
}

#define TFFT_ROW_TC_PAIR(S, BT)                                            \
  int launch_row_tc<S, BT>(const void*, const void*, void*, void*,         \
                           long long, int, int, int, const StagePlan&,     \
                           const float*, const __nv_bfloat16*, cudaStream_t)
extern template TFFT_ROW_TC_PAIR(__nv_bfloat16, 1);
extern template TFFT_ROW_TC_PAIR(float, 2);
extern template TFFT_ROW_TC_PAIR(float, 3);

}  // namespace tfft
