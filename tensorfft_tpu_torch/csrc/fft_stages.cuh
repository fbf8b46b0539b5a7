// Shared Stockham stage engine of the port's CUDA kernels (sm_90a).
//
// One CTA holds T transforms of length n ("lanes") in shared memory and runs
// the whole stage sequence on them: the math of stage_loop's 'first' and
// 'kloop'/'big' stages (tensorfft_tpu/ops/fused_pallas.py), which differ only
// in TPU layout.  Per stage of radix R over K sub-transforms built so far:
//
//   z[r]  = state[(kk*R + r)*M + mm] * W[r, kk]        (fp32, unfused; stage
//                                                       0 has no twiddle)
//   out[(r_out*K + kk)*M + mm] = sum_r D[r_out, r] z[r]  (fp32 accumulate)
//
// with the 1/R scale folded into D.  That is the stacked engine; the planar
// engines (K1b, fused_pallas.py:stage_loop_planar) keep the four real
// products apart, with the matrix A = [A_re; A_im]:
//
//   out_re = (A_re . z_re) - (A_im . z_im),  out_im = (A_im . z_re) + (A_re . z_im)
//
// each product combined over its dot levels on its own, then one rounded
// subtract and one rounded add, as the plain version's u[:R] - v[R:] and
// u[R:] + v[:R] are.  A is [D_re; D_im] after the twiddle (planar_vpu, the
// first stage, and stages with K > 128), or on a folded stage the per-slice
// A_kk = D diag(W[:, kk]) built in fp64 on the host and applied to the
// untwiddled state, so that stage skips the twiddle multiply.
//
// The stacked engine takes the numeric knobs of stage_loop as runtime
// fields of the pass's plan:
//   a folded stacked stage ('grouped') reads slice kk of per-slice tables
//   M_kk = D diag(W[:, kk]) and takes the untwiddled state, as a folded
//   planar stage does, with the stacked summation;
//   a mult3 stage (complex_mult='mult3', radix >= 128) runs three real
//   products, t1 = M_re.z_re, t2 = M_im.z_im, t3 = S.(z_re + z_im), each
//   combined over its dot levels, then out_re = t1 - t2 and
//   out_im = (t3 - t1) - t2.  z_re + z_im is formed from the unsplit
//   operand and kept as a third operand plane of BT terms, so a pass with a
//   mult3 stage takes 6*BT bytes of shared memory per element, not 4*BT;
//   a bf16 state rounds each stage's outputs to bf16, the last included,
//   and, per stage, the twiddled operand and mult3's sum (the flags say
//   which), as stage_loop rounds them; the load rounds the input to it.
// A pass with none of these knobs runs the kEngStacked variant, which
// compiles every per-stage knob test away: the knobs' runtime branches cost
// the stacked bf16x3 kernel A 21 % on the H100 (8 more registers, spills).
//
// Operands are rounded per the dot
// algorithm of tensorfft_tpu_torch/ops/dots.py: the matrix D arrives from
// the host already split into AT bf16 terms (stored as fp32), the data is
// split here into BT bf16 terms (hi = bits & 0xFFFF0000, last term rounded
// to nearest).  bf16 x bf16 products are exact in fp32, so an FMA
// accumulation equals the plain-torch matmul up to summation order.
//
// Shared-memory plan.  Only the matmul OPERAND lives in shared memory, as
// BT bf16 terms per plane: 4*BT bytes per complex element.  The fp32 stage
// outputs are held in registers (kMaxEpt per thread) until every thread has
// read the operand, then the next stage's twiddle is applied to them and
// they are split back into the operand buffer.  The fp32 state therefore
// never needs a second shared buffer: at n*T = 16384 the bf16 policy takes
// 64 KiB, bf16x3 128 KiB and bf16x6 192 KiB of the 227 KB a block can have.
// The last stage writes straight to global memory through the kernel's
// store functor; stage 0 reads through its load functor.
//
// Clusters.  A pass larger than one CTA holds runs on a thread-block
// cluster of 2, 4 or 8 CTAs, on the tensor-core engine's cluster mode
// (fft_mma_cluster.cuh); this file supplies its launch (launch_stage_kernel,
// check_cluster) and the cluster's tile index (cluster_index).
//
// Tables (D terms, twiddles) stay in global memory and are read through the
// caches: a radix-128 stage's D is 64 KiB per term and cannot share the CTA's
// shared memory with the operand.  A folded planar stage reads K slices of
// 2*R*R entries per term, indexed by each output's kk: at N = 16384, radices
// (128, 128), that is 16.8 MB per term, which no L1 holds, and a warp's 32
// outputs of the last stage read 32 different slices.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>
#include <tuple>
#include <vector>

namespace tfft {

namespace cg = cooperative_groups;

constexpr int kMaxStages = 16;
constexpr int kThreads = 512;                      // threads per CTA, at most
constexpr int kMaxEpt = 32;                        // outputs per thread
constexpr int kMaxCtaElems = kThreads * kMaxEpt;   // complex elements per CTA
constexpr int kMaxCluster = 8;                     // CTAs per cluster (portable)
// Launcher return code (not a cudaError_t) for a cluster the card cannot
// schedule: cudaOccupancyMaxActiveClusters found no place for one.
constexpr int kErrClusterUnschedulable = 0x10000;

// Stage modes: the stacked engine, a planar stage with the shared [D_re;
// D_im] after the twiddle, a planar stage with per-slice folded tables, a
// stacked stage with per-slice folded tables ('grouped').
enum StageMode {
  kStacked = 0, kPlanarShared = 1, kPlanarFolded = 2, kStackedFolded = 3
};
// Per-stage flags: mult3, round the twiddled operand to bf16, round mult3's
// z_re + z_im to bf16.  Pass flags: bf16 state, round the input to it.
enum StageFlag { kFlagMult3 = 1, kFlagRoundTw = 2, kFlagRoundSum = 4 };
enum PassFlag { kFlagBf16State = 1, kFlagRoundInput = 2 };
// Kernel variants (a template parameter): the stacked engine with no knob,
// the stacked engine with the knobs (folded stages, mult3 stages and their
// third operand plane, bf16 state), the planar engines.
enum Engine { kEngStacked = 0, kEngKnobs = 1, kEngPlanar = 2 };

// Stage sequence of one pass.  Offsets index the fp32 table buffer:
// the matrices at d_off: [term][slice][matrix][R][R], matrix re, im (and
// mult3's S), with one slice, or K on a folded stage; twiddle at w_off:
// [re, im][R][K] (none on a folded stage).
struct StagePlan {
  int n_stages;
  int engine;       // Engine the pass needs
  bool sum_plane;   // a mult3 stage: the third operand plane
  bool bf16_state;  // round each stage's outputs to bf16
  bool round_input; // round the loaded input to bf16
  int radix[kMaxStages];
  int a_terms[kMaxStages];
  int mode[kMaxStages];
  int flags[kMaxStages];
  long long d_off[kMaxStages];
  long long w_off[kMaxStages];
};

__host__ __device__ inline bool folded(int mode) {
  return mode == kPlanarFolded || mode == kStackedFolded;
}

// meta (host memory): n_stages, then per stage radix, a_terms, d_off,
// w_off, then per stage its StageMode, then per stage its StageFlags, then
// the PassFlags.
inline bool read_plan(const long long* meta, StagePlan* plan) {
  const long long n = meta[0];
  if (n < 1 || n > kMaxStages) return false;
  plan->n_stages = static_cast<int>(n);
  for (int s = 0; s < plan->n_stages; ++s) {
    plan->radix[s] = static_cast<int>(meta[1 + 4 * s]);
    plan->a_terms[s] = static_cast<int>(meta[2 + 4 * s]);
    plan->d_off[s] = meta[3 + 4 * s];
    plan->w_off[s] = meta[4 + 4 * s];
    plan->mode[s] = static_cast<int>(meta[1 + 4 * n + s]);
    plan->flags[s] = static_cast<int>(meta[1 + 5 * n + s]);
  }
  const long long pass = meta[1 + 6 * n];
  plan->bf16_state = (pass & kFlagBf16State) != 0;
  plan->round_input = (pass & kFlagRoundInput) != 0;
  const bool planar =
      plan->mode[0] == kPlanarShared || plan->mode[0] == kPlanarFolded;
  bool knobs = plan->bf16_state || plan->round_input;
  plan->sum_plane = false;
  for (int s = 0; s < plan->n_stages; ++s) {
    const int m = plan->mode[s];
    const bool p = m == kPlanarShared || m == kPlanarFolded;
    if (m < kStacked || m > kStackedFolded || p != planar ||
        (s == 0 && folded(m)) || plan->flags[s] < 0 || plan->flags[s] > 7 ||
        (p && (plan->flags[s] & kFlagMult3)))
      return false;
    plan->sum_plane = plan->sum_plane || (plan->flags[s] & kFlagMult3);
    knobs = knobs || m == kStackedFolded || plan->flags[s] != 0;
  }
  plan->engine = planar ? kEngPlanar : (knobs ? kEngKnobs : kEngStacked);
  return true;
}

// Dynamic shared memory of one CTA: the split operand of n*T elements, and
// the split z_re + z_im plane of a pass with a mult3 stage.
inline size_t operand_bytes(int elems, int data_terms, bool sum_plane) {
  const int planes = sum_plane ? 3 : 2;
  return static_cast<size_t>(elems) * planes * data_terms *
         sizeof(__nv_bfloat16);
}

// The engine a cluster kernel is instantiated for: a knob-free stacked pass
// runs on the kEngKnobs kernel, whose per-stage tests it passes through
// with the same arithmetic, so the build carries two cluster kernels per
// storage type and kernel, not three.
template <int kEngine>
constexpr int cluster_engine() {
  return kEngine == kEngStacked ? kEngKnobs : kEngine;
}

// Whether `cluster` (1, 2, 4 or 8) CTAs can run one pass of T transforms
// of n elements: each CTA's slice of n*T/cluster elements at most one CTA's
// and, in a cluster, a power of two, so that a rank is an index's top bits.
// Only kernel B's twin takes T > 1 on a cluster (lanes_ok).
inline bool cluster_ok(long long n, int T, int cluster) {
  if (cluster == 1) return T >= 1 && n * T <= kMaxCtaElems;
  if (cluster != 2 && cluster != 4 && cluster != kMaxCluster) return false;
  const long long e = n * T / cluster;
  return T >= 1 && (n * T) % cluster == 0 && e <= kMaxCtaElems &&
         (e & (e - 1)) == 0;
}

// Whether the card can place one cluster of `config` of kernel `kern`:
// cudaOccupancyMaxActiveClusters, asked once per kernel, cluster size and
// shared memory size.  Returns a cudaError_t code, or
// kErrClusterUnschedulable where no cluster fits.
inline int check_cluster(const void* kern, const cudaLaunchConfig_t& config,
                         int cluster) {
  static std::mutex mu;
  static std::vector<std::tuple<const void*, int, size_t>> fits;
  const auto key = std::make_tuple(kern, cluster, config.dynamicSmemBytes);
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const auto& f : fits)
      if (f == key) return 0;
  }
  int count = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&count, kern, &config);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count < 1) return kErrClusterUnschedulable;
  std::lock_guard<std::mutex> lock(mu);
  fits.push_back(key);
  return 0;
}

// Launch a stage kernel over `tiles` tiles of `threads` threads with `smem`
// bytes of dynamic shared memory: one CTA per tile, or with cluster > 1 a
// cluster of that many CTAs per tile (cudaLaunchKernelEx with the cluster
// dimension attribute, after check_cluster).  Returns a cudaError_t code
// or kErrClusterUnschedulable.
template <typename... Params, typename... Args>
int launch_stage_kernel(void (*kern)(Params...), long long tiles, int threads,
                        size_t smem, int cluster, cudaStream_t stream,
                        Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster == 1) {
    kern<<<static_cast<unsigned>(tiles), threads, smem, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles * cluster));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  const int fits =
      check_cluster(reinterpret_cast<const void*>(kern), config, cluster);
  if (fits != 0) return fits;
  err = cudaLaunchKernelEx(&config, kern, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename S>
__device__ __forceinline__ S from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float bf16_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

// x rounded to bf16 (to nearest even) and back: a bf16 state value.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Complex multiply without FMA contraction, rounding each product as the
// plain-torch version does.
__device__ __forceinline__ void cmul(float a_re, float a_im, float b_re,
                                     float b_im, float& o_re, float& o_im) {
  o_re = __fsub_rn(__fmul_rn(a_re, b_re), __fmul_rn(a_im, b_im));
  o_im = __fadd_rn(__fmul_rn(a_re, b_im), __fmul_rn(a_im, b_re));
}

// Split (re, im) into BT bf16 terms and store them at operand index idx.
template <int BT>
__device__ __forceinline__ void put_operand(__nv_bfloat16* op, int elems,
                                            int idx, float re, float im) {
#pragma unroll
  for (int t = 0; t < BT - 1; ++t) {
    const float h_re = bf16_trunc(re), h_im = bf16_trunc(im);
    op[(2 * t) * elems + idx] = __float2bfloat16_rn(h_re);  // exact
    op[(2 * t + 1) * elems + idx] = __float2bfloat16_rn(h_im);
    re = __fsub_rn(re, h_re);                               // exact
    im = __fsub_rn(im, h_im);
  }
  op[(2 * (BT - 1)) * elems + idx] = __float2bfloat16_rn(re);
  op[(2 * (BT - 1) + 1) * elems + idx] = __float2bfloat16_rn(im);
}

// Split mult3's z_re + z_im into BT bf16 terms in the third operand plane.
template <int BT>
__device__ __forceinline__ void put_sum(__nv_bfloat16* op, int elems, int idx,
                                        float x) {
  __nv_bfloat16* plane = op + 2 * BT * elems;
#pragma unroll
  for (int t = 0; t < BT - 1; ++t) {
    const float h = bf16_trunc(x);
    plane[t * elems + idx] = __float2bfloat16_rn(h);  // exact
    x = __fsub_rn(x, h);                               // exact
  }
  plane[(BT - 1) * elems + idx] = __float2bfloat16_rn(x);
}

// One element's operands for a stage: (re, im) split into the operand and,
// on a mult3 stage of a kEngKnobs pass, their sum (rounded to bf16 where the
// stage's flag says) into the third plane.
template <int BT, int kEngine>
__device__ __forceinline__ void put_stage_operand(__nv_bfloat16* op, int elems,
                                                  int idx, float re, float im,
                                                  int flags) {
  put_operand<BT>(op, elems, idx, re, im);
  if constexpr (kEngine == kEngKnobs) {
    if (flags & kFlagMult3) {
      const float sum = __fadd_rn(re, im);
      put_sum<BT>(op, elems, idx,
                  (flags & kFlagRoundSum) ? bf16_round(sum) : sum);
    }
  }
}

// One output of one stage of the stacked engine: sum over r of
// D[r_out, r] * z[r] for every partial product (i, j) of the dot algorithm
// (matrix term i, data term j, i + j < levels), combined level by level as
// ops/dots.py adds them:
// bf16: S00; bf16ax2: S00 + S10; bf16x3: S00 + (S01 + S10);
// bf16x6: (S00 + (S01 + S10)) + ((S02 + S11) + S20).
// Kept apart from the planar product below: one template for both cost the
// stacked bf16x3 kernel 18 % on the H100.
// The matrix's term i holds D_re at d + i*ts and D_im R*R entries later
// (ts: the term stride, slices * matrices * R*R).  kShared: one [D_re,
// D_im] slice, so ts = 2*R*R, written as the knob-free engine has always
// indexed it; its multi-term kernels (bf16ax2, bf16x3, bf16x6) ran 9-18 %
// slower on the H100 with the stride passed in.
template <int AT, int BT, bool kShared = false>
__device__ __forceinline__ void stage_dot(const __nv_bfloat16* op, int elems,
                                          int nt, int R,
                                          const float* __restrict__ d, int ts,
                                          int r_out, int g, float& out_re,
                                          float& out_im) {
  constexpr int L = AT > BT ? AT : BT;
  float acc_re[AT][BT], acc_im[AT][BT];
#pragma unroll
  for (int i = 0; i < AT; ++i)
#pragma unroll
    for (int j = 0; j < BT; ++j) acc_re[i][j] = acc_im[i][j] = 0.0f;
  const int rr = R * R;
  const float* drow = d + r_out * R;
  for (int r = 0; r < R; ++r) {
    const int zi = r * nt + g;
    float z_re[BT], z_im[BT];
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      z_re[j] = __bfloat162float(op[(2 * j) * elems + zi]);
      z_im[j] = __bfloat162float(op[(2 * j + 1) * elems + zi]);
    }
#pragma unroll
    for (int i = 0; i < AT; ++i) {
      const float d_re =
          __ldg(drow + (kShared ? (2 * i) * rr : i * ts) + r);
      const float d_im =
          __ldg(drow + (kShared ? (2 * i + 1) * rr : i * ts + rr) + r);
#pragma unroll
      for (int j = 0; j < BT; ++j) {
        if (i + j < L) {
          acc_re[i][j] = fmaf(d_re, z_re[j], acc_re[i][j]);
          acc_re[i][j] = fmaf(-d_im, z_im[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(d_im, z_re[j], acc_im[i][j]);
          acc_im[i][j] = fmaf(d_re, z_im[j], acc_im[i][j]);
        }
      }
    }
  }
  float res_re = acc_re[0][0], res_im = acc_im[0][0];
#pragma unroll
  for (int lvl = 1; lvl < L; ++lvl) {
    float l_re = 0.0f, l_im = 0.0f;
    bool first = true;
#pragma unroll
    for (int i = 0; i <= lvl; ++i) {
      const int j = lvl - i;
      if (i < AT && j < BT) {
        l_re = first ? acc_re[i][j] : __fadd_rn(l_re, acc_re[i][j]);
        l_im = first ? acc_im[i][j] : __fadd_rn(l_im, acc_im[i][j]);
        first = false;
      }
    }
    res_re = __fadd_rn(res_re, l_re);
    res_im = __fadd_rn(res_im, l_im);
  }
  out_re = res_re;
  out_im = res_im;
}

// The partial products of one real dot combined level by level, as in
// stage_dot.
template <int AT, int BT>
__device__ __forceinline__ float combine_levels(const float (&acc)[AT][BT]) {
  constexpr int L = AT > BT ? AT : BT;
  float res = acc[0][0];
#pragma unroll
  for (int lvl = 1; lvl < L; ++lvl) {
    float l = 0.0f;
    bool first = true;
#pragma unroll
    for (int i = 0; i <= lvl; ++i) {
      const int j = lvl - i;
      if (i < AT && j < BT) {
        l = first ? acc[i][j] : __fadd_rn(l, acc[i][j]);
        first = false;
      }
    }
    res = __fadd_rn(res, l);
  }
  return res;
}

// One output of one planar stage: four accumulators per partial product,
// one per real product of A = [A_re; A_im] with the state, each combined
// over its levels, then out_re = A_re.re - A_im.im and
// out_im = A_im.re + A_re.im.  The matrix's term i holds A_re at d + i*ts
// and A_im R*R entries later (ts: the term stride, K*2*R*R on a folded
// stage).
template <int AT, int BT>
__device__ __forceinline__ void stage_dot_planar(
    const __nv_bfloat16* op, int elems, int nt, int R,
    const float* __restrict__ d, int ts, int r_out, int g, float& out_re,
    float& out_im) {
  constexpr int L = AT > BT ? AT : BT;
  float acc[4][AT][BT];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int i = 0; i < AT; ++i)
#pragma unroll
      for (int j = 0; j < BT; ++j) acc[p][i][j] = 0.0f;
  const int rr = R * R;
  const float* drow = d + r_out * R;
  for (int r = 0; r < R; ++r) {
    const int zi = r * nt + g;
    float z_re[BT], z_im[BT];
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      z_re[j] = __bfloat162float(op[(2 * j) * elems + zi]);
      z_im[j] = __bfloat162float(op[(2 * j + 1) * elems + zi]);
    }
#pragma unroll
    for (int i = 0; i < AT; ++i) {
      const float a_re = __ldg(drow + i * ts + r);
      const float a_im = __ldg(drow + i * ts + rr + r);
#pragma unroll
      for (int j = 0; j < BT; ++j) {
        if (i + j < L) {
          acc[0][i][j] = fmaf(a_re, z_re[j], acc[0][i][j]);  // A_re . re
          acc[1][i][j] = fmaf(a_im, z_im[j], acc[1][i][j]);  // A_im . im
          acc[2][i][j] = fmaf(a_im, z_re[j], acc[2][i][j]);  // A_im . re
          acc[3][i][j] = fmaf(a_re, z_im[j], acc[3][i][j]);  // A_re . im
        }
      }
    }
  }
  out_re = __fsub_rn(combine_levels<AT, BT>(acc[0]),
                     combine_levels<AT, BT>(acc[1]));
  out_im = __fadd_rn(combine_levels<AT, BT>(acc[2]),
                     combine_levels<AT, BT>(acc[3]));
}

// One output of one mult3 stage: t1 = M_re . z_re, t2 = M_im . z_im and
// t3 = S . (z_re + z_im) (the third operand plane), each combined over its
// levels, then out_re = t1 - t2, out_im = (t3 - t1) - t2, as
// fused_pallas._mult3 and the plain version subtract them.  The matrix's
// term i holds M_re at d + i*ts, M_im and S R*R and 2*R*R entries later.
template <int AT, int BT>
__device__ __forceinline__ void stage_dot_mult3(
    const __nv_bfloat16* op, int elems, int nt, int R,
    const float* __restrict__ d, int ts, int r_out, int g, float& out_re,
    float& out_im) {
  constexpr int L = AT > BT ? AT : BT;
  float acc[3][AT][BT];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < AT; ++i)
#pragma unroll
      for (int j = 0; j < BT; ++j) acc[p][i][j] = 0.0f;
  const int rr = R * R;
  const float* drow = d + r_out * R;
  const __nv_bfloat16* sum = op + 2 * BT * elems;
  for (int r = 0; r < R; ++r) {
    const int zi = r * nt + g;
    float z_re[BT], z_im[BT], z_s[BT];
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      z_re[j] = __bfloat162float(op[(2 * j) * elems + zi]);
      z_im[j] = __bfloat162float(op[(2 * j + 1) * elems + zi]);
      z_s[j] = __bfloat162float(sum[j * elems + zi]);
    }
#pragma unroll
    for (int i = 0; i < AT; ++i) {
      const float m_re = __ldg(drow + i * ts + r);
      const float m_im = __ldg(drow + i * ts + rr + r);
      const float m_s = __ldg(drow + i * ts + 2 * rr + r);
#pragma unroll
      for (int j = 0; j < BT; ++j) {
        if (i + j < L) {
          acc[0][i][j] = fmaf(m_re, z_re[j], acc[0][i][j]);
          acc[1][i][j] = fmaf(m_im, z_im[j], acc[1][i][j]);
          acc[2][i][j] = fmaf(m_s, z_s[j], acc[2][i][j]);
        }
      }
    }
  }
  const float t1 = combine_levels<AT, BT>(acc[0]);
  const float t2 = combine_levels<AT, BT>(acc[1]);
  const float t3 = combine_levels<AT, BT>(acc[2]);
  out_re = __fsub_rn(t1, t2);
  out_im = __fsub_rn(__fsub_rn(t3, t1), t2);
}

// Every output this thread owns in one stage: o = tid + e * blockDim,
// r_out = o / nt, g = o % nt with g = (kk*M + mm)*T + lane.  On a folded
// stage (slice_elems = M*T, else 0) output g reads slice kk = g / (M*T),
// slice_stride entries after slice 0.
template <int AT, int BT, int kEngine>
__device__ __forceinline__ void stage_outputs(const __nv_bfloat16* op,
                                              int elems, int ept, int nt,
                                              int R, const float* d, int ts,
                                              int slice_elems,
                                              int slice_stride, bool mult3,
                                              float (&o_re)[kMaxEpt],
                                              float (&o_im)[kMaxEpt]) {
#pragma unroll
  for (int e = 0; e < kMaxEpt; ++e) {
    if (e < ept) {
      const int o = threadIdx.x + e * blockDim.x;
      const int r_out = o / nt, g = o - r_out * nt;
      if constexpr (kEngine == kEngStacked) {
        stage_dot<AT, BT, true>(op, elems, nt, R, d, 0, r_out, g, o_re[e],
                                o_im[e]);
      } else {
        const float* dd =
            slice_elems > 0 ? d + (g / slice_elems) * slice_stride : d;
        if constexpr (kEngine == kEngPlanar) {
          stage_dot_planar<AT, BT>(op, elems, nt, R, dd, ts, r_out, g,
                                   o_re[e], o_im[e]);
        } else if (mult3) {
          stage_dot_mult3<AT, BT>(op, elems, nt, R, dd, ts, r_out, g,
                                  o_re[e], o_im[e]);
        } else {
          stage_dot<AT, BT>(op, elems, nt, R, dd, ts, r_out, g, o_re[e],
                            o_im[e]);
        }
      }
    }
  }
}

// Run the whole stage sequence of one pass on the CTA's T transforms.
//   load(q, idx, re, im): the q-th input element (q in [0, n*T), in the
//     order best for the global read) and its operand index idx = i*T + lane.
//   store(k, lane, re, im): output bin k of transform `lane`, fp32.
// The bf16 policy (BT == 1) may pair a bf16ax2 first stage (AT == 2) with
// bf16 later stages (AT == 1); bf16x3 and bf16x6 use AT == BT throughout.
// kEngine is plan.engine: the planar engines, the stacked one, or the
// stacked one with knobs; folds, mult3 and roundings are per stage, and
// kEngStacked compiles their tests away.
template <int BT, int kEngine, class Load, class Store>
__device__ void run_fft(__nv_bfloat16* op, int n, int T,
                        const StagePlan& plan, const float* tables,
                        const Load& load, const Store& store) {
  const int elems = n * T;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int ept = elems / nthr;

  for (int q = tid; q < elems; q += nthr) {
    int idx;
    float re, im;
    load(q, idx, re, im);
    if constexpr (kEngine != kEngStacked) {
      if (plan.round_input) {
        re = bf16_round(re);
        im = bf16_round(im);
      }
    }
    put_stage_operand<BT, kEngine>(op, elems, idx, re, im, plan.flags[0]);
  }
  __syncthreads();

  int K = 1, M = n;
  for (int s = 0; s < plan.n_stages; ++s) {
    const int R = plan.radix[s];
    M /= R;
    const int nt = elems / R;
    const float* d = tables + plan.d_off[s];
    const bool fold = kEngine != kEngStacked && folded(plan.mode[s]);
    const bool mult3 =
        kEngine == kEngKnobs && (plan.flags[s] & kFlagMult3) != 0;
    const int slice_stride = (mult3 ? 3 : 2) * R * R;
    const int ts = (fold ? K : 1) * slice_stride;
    const int slice_elems = fold ? M * T : 0;
    float o_re[kMaxEpt], o_im[kMaxEpt];
    if constexpr (BT == 1) {
      if (plan.a_terms[s] == 2)
        stage_outputs<2, 1, kEngine>(op, elems, ept, nt, R, d, ts, slice_elems,
                                     slice_stride, mult3, o_re, o_im);
      else
        stage_outputs<1, 1, kEngine>(op, elems, ept, nt, R, d, ts, slice_elems,
                                     slice_stride, mult3, o_re, o_im);
    } else {
      stage_outputs<BT, BT, kEngine>(op, elems, ept, nt, R, d, ts,
                                     slice_elems, slice_stride, mult3, o_re,
                                     o_im);
    }
    __syncthreads();  // every operand read before it is overwritten
    if constexpr (kEngine != kEngStacked) {
      if (plan.bf16_state) {
#pragma unroll
        for (int e = 0; e < kMaxEpt; ++e) {
          if (e < ept) {
            o_re[e] = bf16_round(o_re[e]);
            o_im[e] = bf16_round(o_im[e]);
          }
        }
      }
    }

    if (s + 1 == plan.n_stages) {
      // M == 1 here: g = kk*T + lane, natural bin k = r_out*K + kk.
#pragma unroll
      for (int e = 0; e < kMaxEpt; ++e) {
        if (e < ept) {
          const int o = tid + e * nthr;
          const int r_out = o / nt, g = o - r_out * nt;
          const int kk = g / T;
          store(r_out * K + kk, g - kk * T, o_re[e], o_im[e]);
        }
      }
    } else {
      const int R2 = plan.radix[s + 1], K2 = K * R, M2 = M / R2;
      const float* w = tables + plan.w_off[s + 1];
      const int flags2 = plan.flags[s + 1];
      // A folded next stage takes the untwiddled state.
      const bool twiddle =
          kEngine == kEngStacked || !folded(plan.mode[s + 1]);
      const bool round_tw =
          kEngine != kEngStacked && (flags2 & kFlagRoundTw) != 0;
#pragma unroll
      for (int e = 0; e < kMaxEpt; ++e) {
        if (e < ept) {
          const int o = tid + e * nthr;
          const int r_out = o / nt, g = o - r_out * nt;
          const int gm = g / T, lane = g - gm * T;
          const int kk = gm / M, mm = gm - kk * M;
          const int kk2 = r_out * K + kk;
          const int r2 = mm / M2, mm2 = mm - r2 * M2;
          float z_re = o_re[e], z_im = o_im[e];
          if (twiddle) {
            cmul(o_re[e], o_im[e], __ldg(w + r2 * K2 + kk2),
                 __ldg(w + (R2 + r2) * K2 + kk2), z_re, z_im);
            if (round_tw) {
              z_re = bf16_round(z_re);
              z_im = bf16_round(z_im);
            }
          }
          put_stage_operand<BT, kEngine>(
              op, elems, ((r2 * K2 + kk2) * M2 + mm2) * T + lane, z_re, z_im,
              flags2);
        }
      }
    }
    __syncthreads();
    K *= R;
  }
}

// The index of the cluster among the launch's: every rank of a cluster
// shares one tile (kernel A: one row).
__device__ __forceinline__ unsigned cluster_index() {
  return blockIdx.x / cg::this_cluster().num_blocks();
}

}  // namespace tfft
