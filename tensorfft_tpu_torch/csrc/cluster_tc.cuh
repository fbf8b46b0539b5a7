// The cluster twin of kernel A and of the row passes on the tensor-core
// engine's cluster mode (fft_mma_cluster.cuh): a transform longer than one
// CTA holds, one per thread-block cluster of 2, 4 or 8 CTAs.
// row_cluster_kernel runs the row pass of (B, n1, n2) planes, row r0 of
// batch b per cluster, read from `mid` and stored in place (kernel A,
// fused_fft.cu, on (B, 1, N) planes; K3, K4's row pass; in_place_row.cuh),
// transposed at k2*n1 + r0 (kernel C, kRowTransposed) or as interleaved
// pairs of a real row (K6, kRowTransposed | kRowPairs; four_step_passes.cuh).
// The launcher is compiled once per storage/operand pair, in
// cluster_tc{1,2,3}.cu, so nvcc builds the three in parallel.  Kernel B's
// twin, a tile of T columns per cluster, is cluster_col_tc.cuh.
//
// What bounds them on the H100: the stage products, on the tensor cores as
// in one CTA, and the exchange between stages, one distributed-shared-
// memory store per split term per element per stage boundary; kernel C's
// transposed store writes 2 or 4 bytes per bin at a pitch of n1.
#pragma once

#include "fft_mma_cluster.cuh"

namespace tfft {

// The store of a row_cluster_kernel launch (bits of `io`).
enum RowClusterIo {
  kRowTransposed = 1,  // bin k2 of row r0 at k2*n1 + r0 (else r0*n2 + k2)
  kRowPairs = 2,       // the interleaved real row (K6)
};

template <typename S, int BT, int kEngine>
__global__ void __launch_bounds__(kThreads)
    row_cluster_kernel(const S* __restrict__ mid_re,
                       const S* __restrict__ mid_im, S* __restrict__ out_re,
                       S* __restrict__ out_im, int n1, int n2, int io,
                       StagePlan plan, const __nv_bfloat16* __restrict__ mats,
                       const float* __restrict__ tables) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool transposed = (io & kRowTransposed) != 0;
  const bool pairs = (io & kRowPairs) != 0;
  const unsigned tile = cluster_index();
  const long long b = tile / n1;
  const int r0 = static_cast<int>(tile - b * n1);
  const long long base = b * n1 * n2;
  const long long in = base + static_cast<long long>(r0) * n2;
  const long long out = transposed ? base + r0 : in;
  run_fft_tc_cluster<S, BT, kEngine>(
      reinterpret_cast<__nv_bfloat16*>(smem), n2, plan, mats, tables,
      mid_re + in, mid_im + in, out_re + (pairs ? 2 * out : out),
      pairs ? nullptr : out_im + out,
      {transposed ? static_cast<long long>(n1) : 1, pairs});
}

// A row pass over (batch, n1, n2) planes on a cluster of `cluster` CTAs per
// row, storing as `io` (RowClusterIo) says: the plan's engine, its bf16
// matrices `mats` (meta's offsets in bf16 units) and the fp32 twiddles in
// `tables`.  Returns a cudaError_t code, or kErrClusterUnschedulable.
template <typename S, int BT>
int launch_row_cluster_tc(const void* mid_re, const void* mid_im,
                          void* out_re, void* out_im, long long batch, int n1,
                          int n2, int cluster, int io, const StagePlan& plan,
                          const float* tables, const __nv_bfloat16* mats,
                          cudaStream_t stream) {
  if (mats == nullptr || cluster < 2 || !cluster_ok(n2, 1, cluster) ||
      !cluster_tc_ok(n2, cluster, plan))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elems = n2 / cluster;
  auto kern = plan.engine == kEngPlanar
                  ? &row_cluster_kernel<S, BT, kEngPlanar>
                  : &row_cluster_kernel<S, BT, kEngKnobs>;
  return launch_stage_kernel(
      kern, batch * n1, tc_threads(elems),
      operand_bytes(elems, BT, plan.sum_plane), cluster, stream,
      static_cast<const S*>(mid_re), static_cast<const S*>(mid_im),
      static_cast<S*>(out_re), static_cast<S*>(out_im), n1, n2, io, plan,
      mats, tables);
}

// The launcher of one storage/operand pair, declared (PREFIX = extern
// template) or instantiated (PREFIX = template).
#define TFFT_CLUSTER_TC_PAIR(PREFIX, S, BT)                                    \
  PREFIX int launch_row_cluster_tc<S, BT>(                                     \
      const void*, const void*, void*, void*, long long, int, int, int, int,   \
      const StagePlan&, const float*, const __nv_bfloat16*, cudaStream_t)
TFFT_CLUSTER_TC_PAIR(extern template, __nv_bfloat16, 1);
TFFT_CLUSTER_TC_PAIR(extern template, float, 2);
TFFT_CLUSTER_TC_PAIR(extern template, float, 3);

}  // namespace tfft
