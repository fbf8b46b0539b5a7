// Kernels B and C (four_step_passes.cuh) on the tensor-core engine, one CTA
// per tile: every one-CTA launch of a four-step column or row pass, K4's
// column pass, K5's packed column pass and K6's interleaving row pass.
// four_step_tc_kernel runs run_fft_tc (fft_mma.cuh) in its tile mode, with
// the pass's maps as tile layouts:
//   kernel B: T adjacent columns of (B, n1, n2) planes, element (i, lane) at
//     i*n2 + lane (kTileCols; K5: kTilePairs, pair i*n2 + lane of the real
//     row), in accesses of up to 16 bytes per row; bin k1 of column lane
//     back to k1*n2 + lane, multiplied by the four-step twiddle
//     P[k1, j2 / t] * Q[k1, j2 % t] in fp32 in the last stage's epilogue,
//     before the one rounding to the storage dtype, as the TPU's
//     _col_kernel rounds it (K4's column pass: no twiddle);
//   kernel C: T consecutive rows of `mid` (kTileRows, the in-place row
//     pass's loads), bin k2 of row r0 + lane stored transposed at
//     k2*n1 + r0 + lane (kTileCols; K6: kTilePairs into the real row).
// The last stage is staged in shared memory as [k][lane], so a warp's
// stores are runs of T (2T) elements per bin, not element by element.  The one kernel per storage/operand pair and
// engine serves every variant (the `io` bits say which), compiled once per
// pair in four_step_tc{1,2,3}.cu so nvcc builds the three in parallel.
// A pass past one CTA takes a cluster twin on the tensor-core engine's
// cluster mode: kernel C's (row_cluster_kernel, cluster_tc.cuh) one row per
// cluster, kernel B's (col_cluster_tc_kernel, cluster_col_tc.cuh) a tile of
// T columns per cluster with the same epilogue.
//
// What bounds them on the H100: the stage products, as in kernel A (kernel
// B's radix-256 stage runs at kernel A's rate, about 9x its HBM bound,
// PERF.md); a column tile's strided side moves T elements per row, so at
// T = 4 (K4c, kernel C at 2^20) its runs are 8 bytes, a quarter sector.
#pragma once

#include "fft_mma.cuh"

namespace tfft {

// The variant a four_step_tc_kernel launch runs (bits of `io`).
enum PassIo {
  kPassRow = 1,      // kernel C (else kernel B)
  kPassPairs = 2,    // B: the packed real input (K5); C: the interleaved
                     // real output (K6)
  kPassTwiddle = 4,  // B: the four-step P.Q twiddle (off: K4's column pass)
};

template <typename S, int BT, int kEngine>
__global__ void __launch_bounds__(kThreads)
    four_step_tc_kernel(const S* __restrict__ in_re,
                        const S* __restrict__ in_im, S* __restrict__ out_re,
                        S* __restrict__ out_im, int n1, int n2, int T, int io,
                        StagePlan plan, const __nv_bfloat16* __restrict__ mats,
                        const float* __restrict__ tables,
                        const float* __restrict__ p,
                        const float* __restrict__ q, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool row = (io & kPassRow) != 0, pairs = (io & kPassPairs) != 0;
  const bool twiddle = (io & kPassTwiddle) != 0;
  const int tiles = (row ? n1 : n2) / T;
  const long long b = blockIdx.x / tiles;
  const int x0 = (blockIdx.x - static_cast<int>(b) * tiles) * T;
  const long long base = b * n1 * n2;
  const S* src_re;
  const S* src_im;
  S* dst_re;
  S* dst_im;
  TileMap map;
  if (row) {  // rows x0 .. x0+T-1 in; bin k2 of row x0 + lane at k2*n1 + x0 + lane
    const long long in = base + static_cast<long long>(x0) * n2, out = base + x0;
    src_re = in_re + in;
    src_im = in_im + in;
    dst_re = out_re + (pairs ? 2 * out : out);
    dst_im = pairs ? nullptr : out_im + out;
    map = {kTileRows, pairs ? kTilePairs : kTileCols, n2, n1};
  } else {  // columns x0 .. x0+T-1 in and out
    const long long at = base + x0;
    src_re = in_re + (pairs ? 2 * at : at);
    src_im = pairs ? nullptr : in_im + at;
    dst_re = out_re + at;
    dst_im = out_im + at;
    map = {pairs ? kTilePairs : kTileCols, kTileCols, n2, n2};
  }
  // Kernel C's rows element by element (fp32 rows): q runs along the row.
  auto load = [&](int qi, int& idx, float& re, float& im) {
    const int lane = qi / n2, i = qi - lane * n2;
    idx = i * T + lane;
    const long long at = static_cast<long long>(lane) * n2 + i;
    re = to_float(src_re[at]);
    im = to_float(src_im[at]);
  };
  auto unused = [](int, int, float, float) {};
  // Kernel B's twiddle of bin k1 of column j2 = x0 + lane: P[k1, j2 / t] *
  // Q[k1, j2 % t] (four_step_passes.cuh), then the product with the output.
  auto epilogue = [&](int k1, int lane, float& re, float& im) {
    if (!twiddle) return;
    const int j2 = x0 + lane;
    const int a = j2 / t, bb = j2 - a * t;
    float w_re, w_im;
    cmul(__ldg(p + (2 * a) * n1 + k1), __ldg(p + (2 * a + 1) * n1 + k1),
         __ldg(q + k1 * t + bb), __ldg(q + (n1 + k1) * t + bb), w_re, w_im);
    cmul(re, im, w_re, w_im, re, im);
  };
  run_fft_tc<S, BT, kEngine, decltype(load), decltype(unused), true>(
      reinterpret_cast<__nv_bfloat16*>(smem), row ? n2 : n1, T, plan, mats,
      tables, load, unused, src_re, src_im, dst_re, dst_im, map, epilogue);
}

// One CTA per tile of T columns (kernel B) or rows (kernel C, kPassRow) of
// (batch, n1, n2) planes: the plan's engine, its bf16 matrices `mats` and
// the fp32 twiddles in `tables`; p, q and t are read with kPassTwiddle.
// Returns a cudaError_t code.
template <typename S, int BT>
int launch_four_step_tc(const void* in_re, const void* in_im, void* out_re,
                        void* out_im, long long batch, int n1, int n2, int T,
                        int io, const StagePlan& plan, const float* tables,
                        const __nv_bfloat16* mats, const float* p,
                        const float* q, int t, cudaStream_t stream) {
  if (mats == nullptr || ((io & kPassTwiddle) && (p == nullptr || q == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool row = (io & kPassRow) != 0;
  const int elems = (row ? n2 : n1) * T;
  const long long tiles = batch * ((row ? n1 : n2) / T);
#define TFFT_FOUR_STEP_TC(E)                                                  \
  return launch_stage_kernel(&four_step_tc_kernel<S, BT, E>, tiles,           \
                             tc_threads(elems),                               \
                             operand_bytes(elems, BT, plan.sum_plane), 1,     \
                             stream, static_cast<const S*>(in_re),            \
                             static_cast<const S*>(in_im),                    \
                             static_cast<S*>(out_re), static_cast<S*>(out_im), \
                             n1, n2, T, io, plan, mats, tables, p, q, t)
  if (plan.engine == kEngPlanar) TFFT_FOUR_STEP_TC(kEngPlanar);
  if (plan.engine == kEngKnobs) TFFT_FOUR_STEP_TC(kEngKnobs);
  TFFT_FOUR_STEP_TC(kEngStacked);
#undef TFFT_FOUR_STEP_TC
}

#define TFFT_FOUR_STEP_TC_PAIR(S, BT)                                         \
  int launch_four_step_tc<S, BT>(const void*, const void*, void*, void*,      \
                                 long long, int, int, int, int,               \
                                 const StagePlan&, const float*,              \
                                 const __nv_bfloat16*, const float*,          \
                                 const float*, int, cudaStream_t)
extern template TFFT_FOUR_STEP_TC_PAIR(__nv_bfloat16, 1);
extern template TFFT_FOUR_STEP_TC_PAIR(float, 2);
extern template TFFT_FOUR_STEP_TC_PAIR(float, 3);

}  // namespace tfft
