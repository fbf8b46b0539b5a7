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
// load or a store map (the `kPacked` / `kInterleave` template flags):
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
//   kTransposed = false: kernel C stores row k1's bin k2 in place at
//   out[b, k1, k2] (_row_kernel(transposed=False), whose VMEM transpose
//   restores the (kh, kw) layout).  A warp's 32 outputs are T rows times
//   32/T consecutive k2, so each row's store is a contiguous run of 32/T
//   elements, where the transposed store writes runs of T.
//
// Every pass runs the plan's stage engine (fft_stages.cuh): stacked, stacked
// with knobs, or planar (K1b), a template parameter chosen at launch
// from the plan; folds, roundings and mult3 are per stage.  The JAX
// package's gridslice passes (K2cg, K2rg and K6's column pass) defer a TPU
// interleave to strided stores; these passes store every output from
// registers to its place already, so a gridslice plan runs them unchanged.
//
// K3 (four_step_pallas.py:fused_fft_batch_major, pallas_call at :768) is the
// kTransposed = false row pass over a (1, B, N) view: a tile of T adjacent
// rows per CTA, read row-contiguous and transposed into the shared-memory
// operand (the TPU's in-VMEM transpose), stored in place; entry point in
// fused_batch_major.cu.  K3 and K4's row pass run their one-CTA tiles on
// the tensor-core engine (in_place_row.cuh, fft_mma.cuh), not on
// row_pass_kernel; their clusters take row_cluster_kernel below.
//
// What bounds them on the H100: as kernel A, scalar-FMA stage matmuls bound
// by load-instruction throughput; beyond that, kernel B reads columns
// strided by n2 and kernel C writes strided by n1.  Each CTA therefore takes
// T adjacent columns (B) or rows (C), as many as one CTA's n*T <= 16384
// elements allow (capped at 64), so the strided side moves T contiguous
// elements per row.  A pass longer than one CTA holds (n > 16384, or bf16x6
// with mult3's third operand plane at n = 16384) takes one column or row
// (T = 1) per thread-block cluster of 2, 4 or 8 CTAs (col_cluster_kernel,
// row_cluster_kernel: the same maps through run_fft_cluster), as the JAX
// package runs a 32768-point pass in one VMEM panel; every kernel here, K3,
// K4, K5 and K6 included, takes it.
#pragma once

#include "fft_stages.cuh"

namespace tfft {

template <typename S, int BT, bool kPacked, bool kTwiddle, int kEngine>
__global__ void __launch_bounds__(kThreads)
    col_pass_kernel(const S* __restrict__ in_re, const S* __restrict__ in_im,
                    S* __restrict__ mid_re, S* __restrict__ mid_im, int n1,
                    int n2, int T, StagePlan plan,
                    const float* __restrict__ tables,
                    const float* __restrict__ p, const float* __restrict__ q,
                    int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* op = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tiles = n2 / T;
  const long long b = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - static_cast<int>(b) * tiles) * T;
  const long long base = b * n1 * n2 + c0;
  auto load = [&](int qi, int& idx, float& re, float& im) {
    const int i = qi / T, lane = qi - i * T;
    idx = qi;
    const long long at = base + static_cast<long long>(i) * n2 + lane;
    if constexpr (kPacked) {
      // in_re is the real (B, 2N) row; half-length element `at` is a pair.
      re = to_float(in_re[2 * at]);
      im = to_float(in_re[2 * at + 1]);
    } else {
      re = to_float(in_re[at]);
      im = to_float(in_im[at]);
    }
  };
  auto store = [&](int k1, int lane, float re, float im) {
    float o_re = re, o_im = im;
    if constexpr (kTwiddle) {
      const int j2 = c0 + lane;
      const int a = j2 / t, bb = j2 - a * t;
      float w_re, w_im;
      cmul(__ldg(p + (2 * a) * n1 + k1), __ldg(p + (2 * a + 1) * n1 + k1),
           __ldg(q + k1 * t + bb), __ldg(q + (n1 + k1) * t + bb), w_re, w_im);
      cmul(re, im, w_re, w_im, o_re, o_im);
    }
    const long long at = base + static_cast<long long>(k1) * n2 + lane;
    mid_re[at] = from_float<S>(o_re);
    mid_im[at] = from_float<S>(o_im);
  };
  run_fft<BT, kEngine>(op, n1, T, plan, tables, load, store);
}

template <typename S, int BT, bool kInterleave, bool kTransposed, int kEngine>
__global__ void __launch_bounds__(kThreads)
    row_pass_kernel(const S* __restrict__ mid_re, const S* __restrict__ mid_im,
                    S* __restrict__ out_re, S* __restrict__ out_im, int n1,
                    int n2, int T, StagePlan plan,
                    const float* __restrict__ tables) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* op = reinterpret_cast<__nv_bfloat16*>(smem);
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
    const long long at =
        kTransposed ? base + static_cast<long long>(k2) * n1 + r0 + lane
                    : base + static_cast<long long>(r0 + lane) * n2 + k2;
    if constexpr (kInterleave) {
      // out_re is the real (B, 2N) row; natural bin `at` is a pair.
      out_re[2 * at] = from_float<S>(re);
      out_re[2 * at + 1] = from_float<S>(im);
    } else {
      out_re[at] = from_float<S>(re);
      out_im[at] = from_float<S>(im);
    }
  };
  run_fft<BT, kEngine>(op, n2, T, plan, tables, load, store);
}

// Kernels B and C on a cluster of C CTAs per column or row (T = 1,
// cluster_index): the same maps, through run_fft_cluster.
template <typename S, int BT, bool kPacked, bool kTwiddle, int kEngine>
__global__ void __launch_bounds__(kThreads)
    col_cluster_kernel(const S* __restrict__ in_re,
                       const S* __restrict__ in_im, S* __restrict__ mid_re,
                       S* __restrict__ mid_im, int n1, int n2, int T,
                       StagePlan plan, const float* __restrict__ tables,
                       const float* __restrict__ p,
                       const float* __restrict__ q, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* op = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tiles = n2 / T;
  const unsigned tile = cluster_index();
  const long long b = tile / tiles;
  const int c0 = (tile - static_cast<int>(b) * tiles) * T;
  const long long base = b * n1 * n2 + c0;
  auto load = [&](int qi, int& idx, float& re, float& im) {
    const int i = qi / T, lane = qi - i * T;
    idx = qi;
    const long long at = base + static_cast<long long>(i) * n2 + lane;
    if constexpr (kPacked) {
      // in_re is the real (B, 2N) row; half-length element `at` is a pair.
      re = to_float(in_re[2 * at]);
      im = to_float(in_re[2 * at + 1]);
    } else {
      re = to_float(in_re[at]);
      im = to_float(in_im[at]);
    }
  };
  auto store = [&](int k1, int lane, float re, float im) {
    float o_re = re, o_im = im;
    if constexpr (kTwiddle) {
      const int j2 = c0 + lane;
      const int a = j2 / t, bb = j2 - a * t;
      float w_re, w_im;
      cmul(__ldg(p + (2 * a) * n1 + k1), __ldg(p + (2 * a + 1) * n1 + k1),
           __ldg(q + k1 * t + bb), __ldg(q + (n1 + k1) * t + bb), w_re, w_im);
      cmul(re, im, w_re, w_im, o_re, o_im);
    }
    const long long at = base + static_cast<long long>(k1) * n2 + lane;
    mid_re[at] = from_float<S>(o_re);
    mid_im[at] = from_float<S>(o_im);
  };
  run_fft_cluster<BT, kEngine>(op, n1, plan, tables, load, store);
}

template <typename S, int BT, bool kInterleave, bool kTransposed, int kEngine>
__global__ void __launch_bounds__(kThreads)
    row_cluster_kernel(const S* __restrict__ mid_re,
                       const S* __restrict__ mid_im, S* __restrict__ out_re,
                       S* __restrict__ out_im, int n1, int n2, int T,
                       StagePlan plan, const float* __restrict__ tables) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* op = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tiles = n1 / T;
  const unsigned tile = cluster_index();
  const long long b = tile / tiles;
  const int r0 = (tile - static_cast<int>(b) * tiles) * T;
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
    const long long at =
        kTransposed ? base + static_cast<long long>(k2) * n1 + r0 + lane
                    : base + static_cast<long long>(r0 + lane) * n2 + k2;
    if constexpr (kInterleave) {
      // out_re is the real (B, 2N) row; natural bin `at` is a pair.
      out_re[2 * at] = from_float<S>(re);
      out_re[2 * at + 1] = from_float<S>(im);
    } else {
      out_re[at] = from_float<S>(re);
      out_im[at] = from_float<S>(im);
    }
  };
  run_fft_cluster<BT, kEngine>(op, n2, plan, tables, load, store);
}


// One CTA per tile of T columns, or a cluster of `cluster` CTAs per column.
template <typename S, int BT, bool kPacked, bool kTwiddle, int kEngine>
int launch_col(const void* in_re, const void* in_im, void* mid_re,
               void* mid_im, long long batch, int n1, int n2, int T,
               int cluster, const StagePlan& plan, const float* tables,
               const float* p, const float* q, int t, cudaStream_t stream) {
  const int elems = n1 * T / cluster;
  const int threads = elems < kThreads ? elems : kThreads;
  const size_t smem = operand_bytes(elems, BT, plan.sum_plane);
  return launch_stage_kernel(
      cluster > 1 ? &col_cluster_kernel<S, BT, kPacked, kTwiddle,
                                        cluster_engine<kEngine>()>
                  : &col_pass_kernel<S, BT, kPacked, kTwiddle, kEngine>,
      batch * (n2 / T), threads, smem, cluster, stream,
      static_cast<const S*>(in_re), static_cast<const S*>(in_im),
      static_cast<S*>(mid_re), static_cast<S*>(mid_im), n1, n2, T, plan,
      tables, p, q, t);
}

// One CTA per tile of T rows, or a cluster of `cluster` CTAs per row.
template <typename S, int BT, bool kInterleave, bool kTransposed, int kEngine>
int launch_row(const void* mid_re, const void* mid_im, void* out_re,
               void* out_im, long long batch, int n1, int n2, int T,
               int cluster, const StagePlan& plan, const float* tables,
               cudaStream_t stream) {
  const int elems = n2 * T / cluster;
  const int threads = elems < kThreads ? elems : kThreads;
  const size_t smem = operand_bytes(elems, BT, plan.sum_plane);
  return launch_stage_kernel(
      cluster > 1 ? &row_cluster_kernel<S, BT, kInterleave, kTransposed,
                                        cluster_engine<kEngine>()>
                  : &row_pass_kernel<S, BT, kInterleave, kTransposed, kEngine>,
      batch * (n1 / T), threads, smem, cluster, stream,
      static_cast<const S*>(mid_re), static_cast<const S*>(mid_im),
      static_cast<S*>(out_re), static_cast<S*>(out_im), n1, n2, T, plan,
      tables);
}

// The plan's engine: stacked, stacked with knobs, or planar.
template <typename S, int BT, bool kPacked, bool kTwiddle>
int launch_col_engine(const void* in_re, const void* in_im, void* mid_re,
                      void* mid_im, long long batch, int n1, int n2, int T,
                      int cluster, const StagePlan& plan, const float* tables,
                      const float* p, const float* q, int t,
                      cudaStream_t stream) {
#define TFFT_COL_ENGINE(E)                                                  \
  return launch_col<S, BT, kPacked, kTwiddle, E>(in_re, in_im, mid_re,     \
                                                 mid_im, batch, n1, n2, T, \
                                                 cluster, plan, tables, p, \
                                                 q, t, stream)
  if (plan.engine == kEngPlanar) TFFT_COL_ENGINE(kEngPlanar);
  if (plan.engine == kEngKnobs) TFFT_COL_ENGINE(kEngKnobs);
  TFFT_COL_ENGINE(kEngStacked);
#undef TFFT_COL_ENGINE
}

template <typename S, int BT, bool kInterleave, bool kTransposed>
int launch_row_engine(const void* mid_re, const void* mid_im, void* out_re,
                      void* out_im, long long batch, int n1, int n2, int T,
                      int cluster, const StagePlan& plan, const float* tables,
                      cudaStream_t stream) {
#define TFFT_ROW_ENGINE(E)                                                 \
  return launch_row<S, BT, kInterleave, kTransposed, E>(                  \
      mid_re, mid_im, out_re, out_im, batch, n1, n2, T, cluster, plan,    \
      tables, stream)
  if (plan.engine == kEngPlanar) TFFT_ROW_ENGINE(kEngPlanar);
  if (plan.engine == kEngKnobs) TFFT_ROW_ENGINE(kEngKnobs);
  TFFT_ROW_ENGINE(kEngStacked);
#undef TFFT_ROW_ENGINE
}

// T transforms of length n per CTA (cluster == 1), or one per cluster.
inline bool lanes_ok(int n, int other, int T, int cluster) {
  return T >= 1 && other % T == 0 && cluster_ok(n, T, cluster);
}

// Launch a column pass for the storage/operand pair of a policy: dtype 0
// bf16 (with 1 data term), 1 fp32 (with 2 or 3).  p, q and t are read only
// with kTwiddle.  cluster: CTAs per column (1 with T columns per CTA, else
// 2, 4 or 8 with T = 1).  Returns a cudaError_t code, or
// kErrClusterUnschedulable.
template <bool kPacked, bool kTwiddle>
int col_pass(const void* in_re, const void* in_im, void* mid_re,
             void* mid_im, int dtype, int data_terms, long long batch, int n1,
             int n2, int T, int cluster, const void* tables,
             const long long* meta, const void* p, const void* q, int t,
             void* stream) {
  StagePlan plan;
  if (!read_plan(meta, &plan) || !lanes_ok(n1, n2, T, cluster) || batch < 1 ||
      (kTwiddle && (t < 1 || n2 % t != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* tab = static_cast<const float*>(tables);
  const float* pp = static_cast<const float*>(p);
  const float* qq = static_cast<const float*>(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFFT_COL(S, BT)                                                   \
  return launch_col_engine<S, BT, kPacked, kTwiddle>(                    \
      in_re, in_im, mid_re, mid_im, batch, n1, n2, T, cluster, plan, tab, \
      pp, qq, t, s)
  if (dtype == 0 && data_terms == 1) TFFT_COL(__nv_bfloat16, 1);
  if (dtype == 1 && data_terms == 2) TFFT_COL(float, 2);
  if (dtype == 1 && data_terms == 3) TFFT_COL(float, 3);
#undef TFFT_COL
  return static_cast<int>(cudaErrorInvalidValue);
}

// cluster: CTAs per row, as col_pass's per column.
template <bool kInterleave, bool kTransposed>
int row_pass(const void* mid_re, const void* mid_im, void* out_re,
             void* out_im, int dtype, int data_terms, long long batch, int n1,
             int n2, int T, int cluster, const void* tables,
             const long long* meta, void* stream) {
  StagePlan plan;
  if (!read_plan(meta, &plan) || !lanes_ok(n2, n1, T, cluster) || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* tab = static_cast<const float*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFFT_ROW(S, BT)                                           \
  return launch_row_engine<S, BT, kInterleave, kTransposed>(     \
      mid_re, mid_im, out_re, out_im, batch, n1, n2, T, cluster, \
      plan, tab, s)
  if (dtype == 0 && data_terms == 1) TFFT_ROW(__nv_bfloat16, 1);
  if (dtype == 1 && data_terms == 2) TFFT_ROW(float, 2);
  if (dtype == 1 && data_terms == 3) TFFT_ROW(float, 3);
#undef TFFT_ROW
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tfft

