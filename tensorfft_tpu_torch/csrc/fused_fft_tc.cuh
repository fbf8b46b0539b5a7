// Kernel A's one-CTA kernel on the tensor-core engine (fft_mma.cuh; see
// fused_fft.cu).  launch_fused_tc is compiled once per storage/operand
// pair, in fused_fft_tc1.cu (bf16, 1 data term), fused_fft_tc2.cu and
// fused_fft_tc3.cu (fp32, 2 and 3), so nvcc builds the three in parallel;
// fused_fft.cu calls them.
#pragma once

#include "fft_mma.cuh"

namespace tfft {

template <typename S, int BT, int kEngine>
__global__ void __launch_bounds__(kThreads)
    fused_fft_tc_kernel(const S* __restrict__ in_re,
                        const S* __restrict__ in_im, S* __restrict__ out_re,
                        S* __restrict__ out_im, int n, StagePlan plan,
                        const __nv_bfloat16* __restrict__ mats,
                        const float* __restrict__ tables) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long base = static_cast<long long>(blockIdx.x) * n;
  auto load = [&](int q, int& idx, float& re, float& im) {
    idx = q;
    re = to_float(in_re[base + q]);
    im = to_float(in_im[base + q]);
  };
  auto store = [&](int k, int lane, float re, float im) {
    out_re[base + k] = from_float<S>(re);
    out_im[base + k] = from_float<S>(im);
  };
  run_fft_tc<S, BT, kEngine>(reinterpret_cast<__nv_bfloat16*>(smem), n, 1,
                             plan, mats, tables, load, store, in_re + base,
                             in_im + base, out_re + base, out_im + base);
}

// One CTA per row: the plan's engine, its bf16 matrices `mats` and the
// fp32 twiddles in `tables`.  Returns a cudaError_t code.
template <typename S, int BT>
int launch_fused_tc(const void* in_re, const void* in_im, void* out_re,
                    void* out_im, long long batch, int n, const StagePlan& plan,
                    const float* tables, const __nv_bfloat16* mats,
                    cudaStream_t stream) {
  if (mats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define TFFT_FUSED_TC(E)                                                      \
  return launch_stage_kernel(&fused_fft_tc_kernel<S, BT, E>, batch,           \
                             tc_threads(n),                                   \
                             operand_bytes(n, BT, plan.sum_plane), 1, stream, \
                             static_cast<const S*>(in_re),                    \
                             static_cast<const S*>(in_im),                    \
                             static_cast<S*>(out_re), static_cast<S*>(out_im), \
                             n, plan, mats, tables)
  if (plan.engine == kEngPlanar) TFFT_FUSED_TC(kEngPlanar);
  if (plan.engine == kEngKnobs) TFFT_FUSED_TC(kEngKnobs);
  TFFT_FUSED_TC(kEngStacked);
#undef TFFT_FUSED_TC
}

#define TFFT_FUSED_TC_PAIR(S, BT)                                          \
  int launch_fused_tc<S, BT>(const void*, const void*, void*, void*,       \
                             long long, int, const StagePlan&, const float*, \
                             const __nv_bfloat16*, cudaStream_t)
extern template TFFT_FUSED_TC_PAIR(__nv_bfloat16, 1);
extern template TFFT_FUSED_TC_PAIR(float, 2);
extern template TFFT_FUSED_TC_PAIR(float, 3);

}  // namespace tfft
