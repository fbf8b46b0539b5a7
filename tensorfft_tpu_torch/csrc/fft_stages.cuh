// The plan, operands and launch that every CUDA kernel of the port shares
// (sm_90a): the stage plan read from the host's meta (StagePlan,
// read_plan), the operand's split into bf16 terms (put_operand, put_sum,
// put_stage_operand), the combination of a dot's partial products
// (combine_levels), the unfused complex multiply (cmul), the shared-memory
// sizes, and the launch of a stage kernel on one CTA or a thread-block
// cluster (launch_stage_kernel, check_cluster, cluster_index).  The stage
// engine that runs on them is the tensor-core one: fft_mma.cuh on one CTA,
// fft_mma_cluster.cuh on a cluster.
//
// The stage every engine computes is the math of stage_loop's 'first' and
// 'kloop'/'big' stages (tensorfft_tpu/ops/fused_pallas.py), which differ
// only in TPU layout.  One CTA holds T transforms of length n ("lanes") in
// shared memory; per stage of radix R over K sub-transforms built so far:
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
// Operands are rounded per the dot algorithm of
// tensorfft_tpu_torch/ops/dots.py: the matrix D arrives from the host
// already split into AT bf16 terms, the data is split here into BT bf16
// terms (hi = bits & 0xFFFF0000, last term rounded to nearest).  bf16 x
// bf16 products are exact in fp32, so the engines equal the plain-torch
// matmul up to summation order.
//
// Shared-memory plan.  Only the matmul OPERAND lives in shared memory, as
// BT bf16 terms per plane: 4*BT bytes per complex element.  The fp32 stage
// outputs are held in registers (kMaxEpt per thread) until every thread has
// read the operand, then the next stage's twiddle is applied to them and
// they are split back into the operand buffer: at n*T = 16384 the bf16
// policy takes 64 KiB, bf16x3 128 KiB and bf16x6 192 KiB of the 227 KB a
// block can have.  A pass larger than one CTA holds runs on a thread-block
// cluster of 2, 4 or 8 CTAs.
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

// The partial products (i, j) of one real dot (matrix term i, data term j,
// i + j < levels) combined level by level as ops/dots.py adds them:
// bf16: S00; bf16ax2: S00 + S10; bf16x3: S00 + (S01 + S10);
// bf16x6: (S00 + (S01 + S10)) + ((S02 + S11) + S20).
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

// The index of the cluster among the launch's: every rank of a cluster
// shares one tile (kernel A: one row).
__device__ __forceinline__ unsigned cluster_index() {
  return blockIdx.x / cg::this_cluster().num_blocks();
}

}  // namespace tfft
