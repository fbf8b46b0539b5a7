// Kernel B's cluster twin on the tensor-core engine's cluster mode
// (fft_mma_cluster.cuh, kTile): every column pass past one CTA, a column
// tile of T adjacent columns of (B, n1, n2) planes per thread-block cluster
// of 2, 4 or 8 CTAs.  It replaces, past one CTA, K2c
// (tensorfft_tpu/ops/four_step_pallas.py:_col_kernel, pallas_call at :465,
// and K6's column pass at :1190), K4's column pass (fft2_fused, :646, no
// twiddle) and K5's packed column pass (_col_kernel_packed, :943), as the
// one-CTA four_step_tc_kernel (four_step_tc.cuh) does on one CTA:
//   col_cluster_tc_kernel: columns c0 .. c0+T-1 of batch b per cluster
//     (`cluster_index`), element (i, lane) at i*n2 + lane (kTileCols; K5,
//     kPassPairs: kTilePairs, pair i*n2 + lane of the real row); bin k1 of
//     column lane back to k1*n2 + lane, multiplied by the four-step twiddle
//     P[k1, j2 / t] * Q[k1, j2 % t] (kPassTwiddle; j2 = c0 + lane) in fp32
//     after the bf16 state's rounding and before the one rounding to the
//     storage dtype, as the one-CTA kernel and the TPU's _col_kernel round
//     `mid`.
// Each rank owns ntl = n1*T/R/C consecutive columns of every stage, the T
// lanes innermost, so each output is one CTA's bit for bit.  The launchers
// are compiled once per storage/operand pair, in cluster_col_tc{1,2,3}.cu,
// so nvcc builds the three in parallel.
//
// What bounds it on the H100: the stage products, on the tensor cores as in
// one CTA, and the exchange between stages (one distributed-shared-memory
// store per split term per element per stage boundary, (C-1)/C of them
// remote); beyond them, both sides are strided by n2, so each row of the
// tile moves T contiguous elements (2T bytes in bf16) per access.  A wider
// T buys longer runs at the price of a larger cluster (fused_cuda's
// column-cluster rule picks (T, C)).
#pragma once

#include "four_step_tc.cuh"
#include "fft_mma_cluster.cuh"

namespace tfft {

template <typename S, int BT, int kEngine>
__global__ void __launch_bounds__(kThreads)
    col_cluster_tc_kernel(const S* __restrict__ in_re,
                          const S* __restrict__ in_im, S* __restrict__ out_re,
                          S* __restrict__ out_im, int n1, int n2, int T,
                          int io, StagePlan plan,
                          const __nv_bfloat16* __restrict__ mats,
                          const float* __restrict__ tables,
                          const float* __restrict__ p,
                          const float* __restrict__ q, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool pairs = (io & kPassPairs) != 0;
  const bool twiddle = (io & kPassTwiddle) != 0;
  const int tiles = n2 / T;
  const unsigned tile = cluster_index();
  const long long b = tile / tiles;
  const int c0 = static_cast<int>(tile - b * tiles) * T;
  const long long at = b * n1 * n2 + c0;
  const TileMap map = {pairs ? kTilePairs : kTileCols, kTileCols, n2, n2};
  // The four-step twiddle of bin k1 of column j2 = c0 + lane, as
  // four_step_tc_kernel's epilogue computes it.
  auto epilogue = [&](int k1, int lane, float& re, float& im) {
    if (!twiddle) return;
    const int j2 = c0 + lane;
    const int a = j2 / t, bb = j2 - a * t;
    float w_re, w_im;
    cmul(__ldg(p + (2 * a) * n1 + k1), __ldg(p + (2 * a + 1) * n1 + k1),
         __ldg(q + k1 * t + bb), __ldg(q + (n1 + k1) * t + bb), w_re, w_im);
    cmul(re, im, w_re, w_im, re, im);
  };
  run_fft_tc_cluster<S, BT, kEngine, true>(
      reinterpret_cast<__nv_bfloat16*>(smem), n1, plan, mats, tables,
      in_re + (pairs ? 2 * at : at), pairs ? nullptr : in_im + at,
      out_re + at, out_im + at, {}, T, map, epilogue);
}

// Whether a column pass of T columns of n1 elements runs on `cluster` CTAs:
// T a power of two, each CTA's n1*T/cluster elements (cluster_ok) and every
// stage's columns split into `cluster` blocks.
inline bool col_cluster_tc_ok(int n1, int T, int cluster,
                              const StagePlan& plan) {
  return cluster > 1 && T >= 1 && (T & (T - 1)) == 0 &&
         cluster_ok(n1, T, cluster) && cluster_tc_ok(n1 * T, cluster, plan);
}

// Kernel B on a cluster of `cluster` CTAs per tile of T columns of (batch,
// n1, n2) planes, as `io` (PassIo: kPassPairs, kPassTwiddle) says: the
// plan's engine, its bf16 matrices `mats` (meta's offsets in bf16 units),
// the fp32 twiddles in `tables`, and p, q, t with kPassTwiddle.  Returns a
// cudaError_t code, or kErrClusterUnschedulable.
template <typename S, int BT>
int launch_col_cluster_tc(const void* in_re, const void* in_im, void* out_re,
                          void* out_im, long long batch, int n1, int n2,
                          int T, int cluster, int io, const StagePlan& plan,
                          const float* tables, const __nv_bfloat16* mats,
                          const float* p, const float* q, int t,
                          cudaStream_t stream) {
  if (mats == nullptr || !col_cluster_tc_ok(n1, T, cluster, plan) ||
      ((io & kPassTwiddle) && (p == nullptr || q == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elems = n1 * T / cluster;
  auto kern = plan.engine == kEngPlanar
                  ? &col_cluster_tc_kernel<S, BT, kEngPlanar>
                  : &col_cluster_tc_kernel<S, BT, kEngKnobs>;
  return launch_stage_kernel(
      kern, batch * (n2 / T), tc_threads(elems),
      operand_bytes(elems, BT, plan.sum_plane), cluster, stream,
      static_cast<const S*>(in_re), static_cast<const S*>(in_im),
      static_cast<S*>(out_re), static_cast<S*>(out_im), n1, n2, T, io, plan,
      mats, tables, p, q, t);
}

#define TFFT_CLUSTER_COL_TC_PAIR(PREFIX, S, BT)                               \
  PREFIX int launch_col_cluster_tc<S, BT>(                                    \
      const void*, const void*, void*, void*, long long, int, int, int, int,  \
      int, const StagePlan&, const float*, const __nv_bfloat16*,              \
      const float*, const float*, int, cudaStream_t)
TFFT_CLUSTER_COL_TC_PAIR(extern template, __nv_bfloat16, 1);
TFFT_CLUSTER_COL_TC_PAIR(extern template, float, 2);
TFFT_CLUSTER_COL_TC_PAIR(extern template, float, 3);

}  // namespace tfft
