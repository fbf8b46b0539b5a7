// Kernel A, pipelined: the whole-transform FFT of batch-major (B, N) bf16
// rows on a persistent grid, each CTA walking tiles of T = 2^lg_t
// consecutive rows (T = 1 at n = 16384), tiles blockIdx.x + i * gridDim.x,
// while the next tile's input and the last tile's output move by bulk
// async copies; or of T lines of an N-D axis that is not last, landed from
// the strided planes (the strided landing, below).
//
// Replaces the TPU kernel K1, tensorfft_tpu/ops/fused_pallas.py:fused_fft
// (pallas_call at :971), for the calls whose rows it can feed: bf16 storage
// with one data term on the knob-free stacked engine (kEngStacked), one CTA
// a row, a power-of-two n from 128 to 16384, 16-byte aligned planes and
// more rows than SMs (the rule is ops/fused_cuda.py:takes_pipeline, T is
// pipeline_tile's: a tile of 16384 elements from n = 2048 on, of 8192
// below, where it ran faster on the H100; halved while the batch still
// gives at most one tile an SM).  Every other call runs fused_fft_tc_kernel
// (fused_fft_tc.cuh).  Both run the same stage functions of fft_mma.cuh
// (stage_products, the warp blocking, the fp32 twiddles, the swizzles, the
// roundings, in the same order), so their outputs are equal bit for bit.
// The loop over the stages is tile_stages below, run_fft_tc's loop for this
// one case (shifts for the power-of-two index arithmetic): run_fft_tc keeps
// its text, since the one-CTA kernels sit at the 128-register cap and ptxas
// moves their spills with rewrites that compute the same values.
//
// What bounds one CTA a row on the H100: at 16384 x 4096 the transform's one
// read and one write of HBM take 0.16 ms and its bf16 products 0.14 ms at
// the peaks, but fused_fft_tc_kernel takes 1.43 ms: one 512-thread CTA fills
// an SM (128 registers a thread), and inside it the phases of a row run back
// to back between barriers, with nothing else on the SM to hide them: the
// load waits on HBM before the first stage, the last stage stages its
// outputs in 2-byte stores 8-way bank-conflicted, the store drains, and the
// next CTA starts on an empty SM.  Short rows pay the same per-step costs
// (the mbarrier wait, four __syncthreads, a bulk copy per plane in and out)
// on little work: at 512 x 262,144 (the 512^3 grid's axis 0) a row a step
// took 13.5 ms, 42x the pass's 0.32 ms HBM bound.
//
// What the design does about it (16384 x 4096: 1.47 -> 1.29 ms; 512 x
// 262,144: 13.5 -> 1.93 ms at T = 16; PERF.md):
//   * the grid is persistent (one CTA an SM, each walking tiles), so a CTA
//     starts once, not once a tile;
//   * T consecutive rows are one contiguous run of n*T elements a plane, so
//     a tile lands by one cp.async.bulk per plane, and every per-step cost
//     is paid once per T rows;
//   * three shared buffers of 4nT bytes: a landing buffer, the operand and a
//     staging buffer.  Once a tile has been scattered from the landing
//     buffer into the swizzled operand, one thread arms an mbarrier and
//     starts the bulk copies of the next tile into it, which land while this
//     tile's stages run.  At T = 1 the scatter is a 16-byte shared-memory
//     copy (the swizzle permutes 16-byte chunks within 128 bytes); at T > 1
//     the rows go to K3's operand layout (element i of row lane at i*T +
//     lane, run_fft_tc's T-row tile), each thread gathering 8 landed
//     elements into one 16-byte operand chunk;
//   * the last stage writes natural rows into the staging buffer.  At T = 1
//     under a warp blocking each quad's lanes hold a row's outputs of 4 (or
//     2) column tiles, so four shuffles transpose them into whole 16-byte
//     chunks, stored at most 2-way conflicted (the im plane sits kImPad
//     elements after the re plane so that the 2-column blocking's two planes
//     fall on other banks).  At T > 1 no warp of the last stage holds
//     consecutive bins of a row, so the outputs are staged in 2-byte stores
//     into rows kRowPad elements apart, which spreads adjacent rows' stores
//     over more banks;
//   * thread `lane` stores row lane of the staged tile with cp.async.bulk
//     and commits the group; those threads wait for the reads
//     (wait_group.read) only before the next tile's last stage writes the
//     staging buffer, and for the writes once, before they exit;
//   * at T > 1 a two-term stage of radix 256 (the default plan's one
//     stage at n = 256, bf16ax2) reads its A fragments from the stage's R
//     roots, copied into shared memory once a CTA, not from its 512 KiB
//     fragment table (roots_route, below; the kernels
//     fused_fft_pipe_roots_kernel and fused_fft_pipe_cols_roots_kernel):
//     the table streamed from L2 every step, and 256 x 262,144 took 4.9 ms
//     on the H100, 1.5 ms from the roots (PERF.md §6).
//
// T = 1 is a template flag (kRow) of the one kernel, not a runtime test:
// the T = 1 instance keeps the 16-byte scatter and staging and its
// layout, the T > 1 instance the gathers and the padded rows.  Both run the
// shift arithmetic: at T = 1 it compiles without the spills of a loop that
// divides by M (20 B of spill stores on the H100 build; PERF.md §6).
//
// The strided landing (kCols, fused_fft_pipe_cols_kernel): an N-D pass
// along an axis that is not last sees its planes as (outer, n, inner),
// inner contiguous, and would first copy them with the axis moved last
// (at the 512^3 grid's axis 0 on the H100, a read and a write of the grid
// at 0.59 TB/s: 1.8 ms a call beside this kernel's 2.0 ms; PERF.md §5).  T consecutive
// lines of inner are exactly the T-row tile's operand order: element i of
// line lane sits at i * inner + lane, a run of T elements for each i, and
// the operand wants it at i * T + lane.  So a tile lands straight from the
// grid by tensor copies (cp.async.bulk.tensor, one 3-D tensor map a plane,
// boxes of T x min(n, 256) x 1) in that order, and goes to the operand by
// the T = 1 instance's 16-byte chunk copy through the swizzle, with no
// gather.  T >= 8 and T | inner keep every run whole 16-byte chunks and
// every tile whole; the stages, the staging and the row stores are the T >
// 1 instance's, and a tile's lines leave as output rows tT + lane of the
// (outer * inner, n) rows the copy would have given, so the outputs are the
// same bits.  What bounds it is the row instance's stages: its loads, 32
// bytes a line at T = 16 with lines 2 * inner bytes apart, stay off the
// critical path as the contiguous ones do (512 x 262,144 at T = 16: 1.96
// ms, the row instance on the copied rows 1.94; promoting each read to 64,
// 128 or 256 bytes of L2 moved nothing; PERF.md §6).
#include <cuda.h>  // CUtensorMap and its encoding's types

#include <climits>

#include "fft_mma.cuh"

namespace tfft {

// Elements between the staged re and im planes at T = 1 (see the note
// above).
constexpr int kImPad = 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Order this thread's generic-proxy shared-memory accesses before later
// bulk (async-proxy) copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arm `bar` for two planes of `bytes` each and copy them from global memory
// into shared memory at dst_re and dst_im.
__device__ __forceinline__ void bulk_load(void* dst_re, void* dst_im,
                                          const void* re, const void* im,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(2 * bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst_re)),
      "l"(re), "r"(bytes), "r"(b)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst_im)),
      "l"(im), "r"(bytes), "r"(b)
      : "memory");
}

// Arm `bar` for `bytes` of copies still to land.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Lines of i in one box of the strided landing: a tensor map's box is at
// most 256 elements along each dimension.
constexpr int kBoxLines = 256;

// Copy the box at coordinates (c, i, o) of the 3-D tensor map `map` into
// shared memory at dst, completing on `bar`.
__device__ __forceinline__ void tensor_load(void* dst, const CUtensorMap* map,
                                            int c, int i, int o,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(i), "r"(o),
      "r"(smem_u32(bar))
      : "memory");
}

// Wait for the phase of `bar` with the given parity to complete.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy two planes of `bytes` each from shared memory to global memory, as
// one bulk async-group.
__device__ __forceinline__ void bulk_store(void* re, void* im,
                                           const void* src_re,
                                           const void* src_im, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(re),
               "r"(smem_u32(src_re)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(im),
               "r"(smem_u32(src_im)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The 4 x 4 matrix of words whose row p is x on lane p of a quad (lane % 4):
// afterwards lane p holds its column p, x[j] from lane j.
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4]) {
  const int lane = threadIdx.x & 31;
  const bool b1 = (lane & 2) != 0, b0 = (lane & 1) != 0;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, b1 ? x[0] : x[2], 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, b1 ? x[1] : x[3], 2);
  // Rows lane & 1 and (lane & 1) + 2, columns 2 * b1 and 2 * b1 + 1.
  const uint32_t z00 = b1 ? r0 : x[0], z01 = b1 ? r1 : x[1];
  const uint32_t z10 = b1 ? x[2] : r0, z11 = b1 ? x[3] : r1;
  r0 = __shfl_xor_sync(0xffffffffu, b0 ? z00 : z01, 1);
  r1 = __shfl_xor_sync(0xffffffffu, b0 ? z10 : z11, 1);
  const uint32_t k0 = b0 ? z01 : z00, k1 = b0 ? z11 : z10;
  x[0] = b0 ? r0 : k0;
  x[1] = b0 ? k0 : r0;
  x[2] = b0 ? r1 : k1;
  x[3] = b0 ? k1 : r1;
}

__device__ __forceinline__ uint32_t pack_out(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// The last stage's outputs under a warp blocking of QW x JW tiles (slot t =
// qi * JW + ji, stage_mma_blocked) into the staging buffer: bin k = r_out *
// K + g of re at st[k], of im at im[k].  The quad of lanes sharing r_out
// holds its JW * 8 columns g as two per lane per tile; quad_transpose gives
// each lane one 16-byte chunk, JW = 4: of re and then of im, JW = 2: of re
// (lanes 0, 1) or im (lanes 2, 3).
template <int QW, int JW>
__device__ __forceinline__ void stage_out_blocked(const float (&o_re)[kMaxEpt],
                                                  const float (&o_im)[kMaxEpt],
                                                  __nv_bfloat16* st,
                                                  __nv_bfloat16* im, int R,
                                                  int K) {
  const int lane = threadIdx.x & 31, p = lane & 3;
  int qw, jw, q0, j0;
  block_origin(QW * JW, R >> 3, qw, jw, q0, j0);
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    const int row = (8 * (q0 + qi) + (lane >> 2)) * K;
    if constexpr (JW == 4) {
      uint32_t x[4], y[4];
#pragma unroll
      for (int ji = 0; ji < 4; ++ji) {
        const int t = qi * 4 + ji;
        x[ji] = pack_out(o_re[2 * t], o_re[2 * t + 1]);
        y[ji] = pack_out(o_im[2 * t], o_im[2 * t + 1]);
      }
      quad_transpose(x);
      quad_transpose(y);
      const int at = row + 8 * (j0 + p);
      *reinterpret_cast<uint4*>(st + at) = make_uint4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<uint4*>(im + at) = make_uint4(y[0], y[1], y[2], y[3]);
    } else {
      const int t = qi * 2;
      uint32_t x[4] = {pack_out(o_re[2 * t], o_re[2 * t + 1]),
                       pack_out(o_re[2 * t + 2], o_re[2 * t + 3]),
                       pack_out(o_im[2 * t], o_im[2 * t + 1]),
                       pack_out(o_im[2 * t + 2], o_im[2 * t + 3])};
      quad_transpose(x);
      *reinterpret_cast<uint4*>((p & 2 ? im : st) + row + 8 * (j0 + (p & 1))) =
          make_uint4(x[0], x[1], x[2], x[3]);
    }
  }
}


// Elements between the staged rows of a tile: each row starts on a 16-byte
// boundary (a bulk copy's), and the last stage's 2-byte stores of adjacent
// rows fall on other banks.
constexpr int kRowPad = 8;

// The landed tile (row `lane` at land[lane * n], re then im `elems` on) into
// the operand, element i of row lane at operand index swz(i * T + lane):
// one 16-byte operand chunk c (indices 8c .. 8c + 7) per thread and plane,
// gathered from 8 landed elements.  With T >= 8 a chunk is 8 lanes of one
// i; a warp takes 32 consecutive i of one block of 8 lanes, so each gather
// reads 64 contiguous bytes.
__device__ __forceinline__ void tile_scatter(const __nv_bfloat16* land,
                                             __nv_bfloat16* op, int n, int lg_t,
                                             Swizzle sw) {
  const int elems = n << lg_t, tm = (1 << lg_t) - 1;
  const int lg_g = lg_t > 3 ? lg_t - 3 : 0;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(land);
  for (int u = threadIdx.x; u < (elems >> 3); u += blockDim.x) {
    const int rest = u >> 5;
    const int c = lg_g ? (((((rest >> lg_g) << 5) | (u & 31)) << lg_g) |
                          (rest & ((1 << lg_g) - 1)))
                       : u;
    uint32_t w_re[4], w_im[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int a = 8 * c + e, b = a + 1;
      const int sa = (a & tm) * n + (a >> lg_t), sb = (b & tm) * n + (b >> lg_t);
      w_re[e / 2] = src[sa] | (static_cast<uint32_t>(src[sb]) << 16);
      w_im[e / 2] = src[elems + sa] | (static_cast<uint32_t>(src[elems + sb]) << 16);
    }
    const int at = swz(8 * c, sw);
    *reinterpret_cast<uint4*>(op + at) = make_uint4(w_re[0], w_re[1], w_re[2], w_re[3]);
    *reinterpret_cast<uint4*>(op + elems + at) =
        make_uint4(w_im[0], w_im[1], w_im[2], w_im[3]);
  }
}

// The roots route (tile_stages at T > 1; ops/fused_cuda.py:roots_route
// mirrors it): a two-term stage of radix kRootsRadix on the mma route
// gathers its A fragments from a per-CTA copy of its R roots in shared
// memory (stage_mma_roots).  Its fragment table, terms x matrices x R x R
// bf16, is 512 KiB at R = 256: beside the tile's buffers it does not stay in
// L1, and stage_mma, whose tile order gives a warp 8 row tiles of one column
// tile, read it from L2 again every step (about 17 GB a call at 256 x
// 262,144, against the rows' 0.54 GB of HBM).  The roots are 2 KiB.  Only
// R = 256 takes it: the radix measured and tested; a larger radix's roots
// beside a tile's buffers can pass the card's shared memory a block (R =
// 8192 at T = 2: 264,264 bytes).
constexpr int kRootsRadix = 256;

__host__ __device__ inline bool roots_route(int mode, int radix, int a_terms) {
  return mma_route(mode, radix) && radix == kRootsRadix && a_terms == 2;
}

// The stage of `plan` that takes the roots route, or -1.  At most one: two
// stages of radix 256 make n >= 65536, and a tile of T > 1 rows holds at
// most 16384.
__host__ __device__ inline int roots_stage(const StagePlan& plan) {
  for (int s = 0; s < plan.n_stages; ++s)
    if (roots_route(plan.mode[s], plan.radix[s], plan.a_terms[s])) return s;
  return -1;
}

// Row r_out = 1 of the roots stage's table into the roots' shared copy:
// entry (i, m, 1, r) of the fragment order (ops/fused_cuda.py:
// mma_table_index: lane 4 + (r % 8) / 2, pair r % 2) lies at ((i * 2 + m)
// * chunks^2 + r / 8) * 64 + 8 + r % 8, so each chunk of 8 roots of one term
// and matrix is one 16-byte load; root r of term i, matrix m (re, im) goes
// to bf16 (root_slot(r) * 2 + i) * 2 + m.
__device__ __forceinline__ void load_roots(unsigned short* roots,
                                           const StagePlan& plan,
                                           const __nv_bfloat16* __restrict__ mats) {
  const int s = roots_stage(plan);
  if (s < 0) return;
  const int chunks = plan.radix[s] >> 3;
  const __nv_bfloat16* d = mats + plan.d_off[s];
  for (int u = threadIdx.x; u < 4 * chunks; u += blockDim.x) {
    const int tm = u / chunks, c = u - tm * chunks;  // tm = i * 2 + m
    const uint4 v =
        __ldg(reinterpret_cast<const uint4*>(d + (tm * chunks * chunks + c) * 64 + 8));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      roots[(root_slot(8 * c + e) * 2 + (tm >> 1)) * 2 + (tm & 1)] =
          static_cast<unsigned short>(w[e >> 1] >> (16 * (e & 1)));
  }
}

// run_fft_tc's stages for a tile of T = 2^lg_t consecutive rows (bf16
// storage, one data term, the knob-free stacked engine; every radix a power
// of two) on the operand `op`, with the last stage's outputs in the staging
// buffer as natural rows `pitch` elements apart (re at st, im at im).  The
// same stage functions, twiddles and roundings in the same order as
// run_fft_tc with T rows (K3 at T > 1, kernel A at T = 1), so each output
// equals theirs bit for bit; the index arithmetic uses shifts.  kRow (T =
// 1) stages the blocked stages' outputs in 16-byte chunks
// (stage_out_blocked); kRoots (T > 1) gathers a roots-route stage's A
// fragments from `roots` (stage_mma_roots, under mma_block's blocking: the
// same bits).  Threads below T first wait until the staging buffer's
// previous bulk stores have read it.
template <bool kRow, bool kRoots>
__device__ __forceinline__ void tile_stages(__nv_bfloat16* op,
                                            __nv_bfloat16* st,
                                            __nv_bfloat16* im, int pitch,
                                            int n, int lg_t,
                                            const StagePlan& plan,
                                            const __nv_bfloat16* __restrict__ mats,
                                            const float* __restrict__ tw,
                                            const uint2* roots) {
  const int elems = n << lg_t, tm = (1 << lg_t) - 1;
  Swizzle sw = stage_swizzle(elems / plan.radix[0]);
  int K = 1, lg_m = __ffs(n) - 1;
  for (int s = 0; s < plan.n_stages; ++s) {
    const int R = plan.radix[s];
    const int lg_r = __ffs(R) - 1;
    lg_m -= lg_r;
    const int nt = elems >> lg_r;
    const __nv_bfloat16* d = mats + plan.d_off[s];
    const bool mma = mma_route(plan.mode[s], R);
    // The roots stage by its index: where the test names R = 256, the
    // compiler folds R into the route and the instance spills.
    bool from_roots = false;
    if constexpr (kRoots) from_roots = s == roots_stage(plan);
    const int blk = (mma && (plan.a_terms[s] == 1 || from_roots))
                        ? mma_block(R >> 3, nt)
                        : 0;
    const int slice_stride = R * R * 2;
    float o_re[kMaxEpt], o_im[kMaxEpt];
    int vv = 0;
    if (from_roots) {
      if constexpr (kRoots) {
        if (blk == 16)
          stage_mma_roots<8, 2, 4>(op, elems, nt, R, sw, blk, roots, o_re, o_im);
        else if (blk == 8)
          stage_mma_roots<4, 2, 4>(op, elems, nt, R, sw, blk, roots, o_re, o_im);
        else if (blk == 4)
          stage_mma_roots<2, 2, 2>(op, elems, nt, R, sw, blk, roots, o_re, o_im);
        else
          stage_mma_roots<kMaxEpt / 2, 1, 0>(op, elems, nt, R, sw, 0, roots,
                                             o_re, o_im);
      }
    } else if (plan.a_terms[s] == 2) {
      vv = stage_products<2, 1, kEngStacked>(op, elems, nt, R, lg_r, sw, mma,
                                             blk, false, d, slice_stride, 0,
                                             slice_stride, o_re, o_im);
    } else {
      vv = stage_products<1, 1, kEngStacked>(op, elems, nt, R, lg_r, sw, mma,
                                             blk, false, d, slice_stride, 0,
                                             slice_stride, o_re, o_im);
    }
    if (s + 1 == plan.n_stages) {
      if (threadIdx.x <= tm)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncthreads();  // the staging buffer is free
      // g = kk * T + lane, natural bin k = r_out * K + kk of row lane.
      if (kRow && blk == 16) {
        stage_out_blocked<4, 4>(o_re, o_im, st, im, R, K);
      } else if (kRow && blk == 8) {
        stage_out_blocked<2, 4>(o_re, o_im, st, im, R, K);
      } else if (kRow && blk == 4) {
        stage_out_blocked<2, 2>(o_re, o_im, st, im, R, K);
      } else {
        for_outputs(mma, blk, vv, elems, nt, R, lg_r, [&](int e, int r_out, int g) {
          const int at = (g & tm) * pitch + r_out * K + (g >> lg_t);
          st[at] = __float2bfloat16_rn(o_re[e]);
          im[at] = __float2bfloat16_rn(o_im[e]);
        });
      }
      return;
    }
    __syncthreads();  // every operand read before it is overwritten
    const int R2 = plan.radix[s + 1], K2 = K * R;
    const int lg_m2 = lg_m - (__ffs(R2) - 1);
    const float* w = tw + plan.w_off[s + 1];
    const int flags2 = plan.flags[s + 1];
    const Swizzle sw2 = stage_swizzle(elems / R2);
    for_outputs(mma, blk, vv, elems, nt, R, lg_r, [&](int e, int r_out, int g) {
      const int gm = g >> lg_t, lane = g & tm;
      const int kk = gm >> lg_m, mm = gm & ((1 << lg_m) - 1);
      const int kk2 = r_out * K + kk;
      const int r2 = mm >> lg_m2, mm2 = mm & ((1 << lg_m2) - 1);
      float z_re, z_im;
      cmul(o_re[e], o_im[e], __ldg(w + r2 * K2 + kk2),
           __ldg(w + (R2 + r2) * K2 + kk2), z_re, z_im);
      put_stage_operand<1, kEngStacked>(
          op, elems, swz((((r2 * K2 + kk2) << lg_m2) + mm2) << lg_t | lane, sw2),
          z_re, z_im, flags2);
    });
    sw = sw2;
    __syncthreads();
    K *= R;
  }
}

// Dynamic shared memory: landing and operand buffers of 4nT bytes, the
// staging buffer of T rows per plane, n + kImPad (T = 1) or n + kRowPad
// elements apart, the mbarrier, then at T > 1 the roots stage's roots, 8
// bytes a slot.
inline size_t pipe_smem_bytes(int n, int T, const StagePlan& plan) {
  const size_t pitch = n + (T == 1 ? kImPad : kRowPad);
  const int rs = T > 1 ? roots_stage(plan) : -1;
  return (4 * static_cast<size_t>(n) * T + 2 * pitch * T) *
             sizeof(__nv_bfloat16) +
         sizeof(uint64_t) +
         (rs < 0 ? 0 : root_slot(plan.radix[rs]) * sizeof(uint2));
}

// One CTA's walk over the tiles blockIdx.x + i * gridDim.x (gridDim.x at
// most the tile count) of T = 2^lg_t lines of n (a power of two; kRow: T =
// 1, lg_t unread), `batch` lines in all: kRoots (T > 1) first copies the
// roots stage's roots (load_roots); thread 0 lands tile t in the
// landing buffer by fetch(land, bar, t), arming `bar`; the tile goes to the
// operand (kRow and kCols: landed in operand order, so whole 16-byte chunks
// through the swizzle; else T consecutive rows, gathered by tile_scatter),
// the next tile's fetch starts, the stages run, and each line leaves as
// output row tT + lane by its own bulk copies, issued by thread `lane`.
template <bool kRow, bool kCols, bool kRoots, typename Fetch>
__device__ __forceinline__ void pipe_tiles(unsigned char* smem,
                                           const Fetch& fetch,
                                           __nv_bfloat16* __restrict__ out_re,
                                           __nv_bfloat16* __restrict__ out_im,
                                           long long batch, int n, int lg_t,
                                           const StagePlan& plan,
                                           const __nv_bfloat16* __restrict__ mats,
                                           const float* __restrict__ tables) {
  const int lg = kRow ? 0 : lg_t;
  const int T = 1 << lg, elems = n << lg;
  const int pitch = n + (kRow ? kImPad : kRowPad);
  __nv_bfloat16* land = reinterpret_cast<__nv_bfloat16*>(smem);  // [re | im]
  __nv_bfloat16* op = land + 2 * elems;
  __nv_bfloat16* st = op + 2 * elems;  // [re | im], T rows of pitch each
  __nv_bfloat16* st_im = st + T * pitch;
  uint64_t* bar = reinterpret_cast<uint64_t*>(st_im + T * pitch);
  const uint2* roots = reinterpret_cast<const uint2*>(bar + 1);
  const long long tiles = (batch + T - 1) >> lg, step = gridDim.x;
  const Swizzle sw0 = stage_swizzle(elems / plan.radix[0]);
  if (threadIdx.x == 0) {
    bar_init(bar);
    fetch(land, bar, blockIdx.x);
  }
  // Once for the CTA's whole walk.
  if constexpr (kRoots)
    load_roots(reinterpret_cast<unsigned short*>(bar + 1), plan, mats);
  __syncthreads();
  uint32_t parity = 0;
  for (long long t = blockIdx.x; t < tiles; t += step, parity ^= 1) {
    bar_wait(bar, parity);
    if constexpr (kRow || kCols) {
      // Landed index q to operand index swz(q): whole 16-byte chunks.
      for (int q = threadIdx.x * 8; q < elems; q += blockDim.x * 8) {
        const int at = swz(q, sw0);
        *reinterpret_cast<uint4*>(op + at) =
            *reinterpret_cast<const uint4*>(land + q);
        *reinterpret_cast<uint4*>(op + elems + at) =
            *reinterpret_cast<const uint4*>(land + elems + q);
      }
    } else {
      tile_scatter(land, op, n, lg, sw0);
    }
    __syncthreads();  // the landing buffer is free
    if (threadIdx.x == 0 && t + step < tiles) {
      fence_async_shared();
      fetch(land, bar, t + step);
    }
    tile_stages<kRow, kRoots>(op, st, st_im, pitch, n, lg, plan, mats, tables,
                              roots);
    fence_async_shared();
    __syncthreads();  // the tile is staged
    const long long row = (t << lg) + threadIdx.x;
    if (threadIdx.x < T && row < batch)
      bulk_store(out_re + row * n, out_im + row * n, st + threadIdx.x * pitch,
                 st_im + threadIdx.x * pitch, 2u * static_cast<uint32_t>(n));
  }
  if (threadIdx.x < T)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The pipelined kernel on tiles of T = 2^lg_t consecutive rows of n (kRow:
// T = 1): tile t holds rows tT .. tT + T - 1 (the last tile may be short),
// one contiguous run of each plane, which lands by one bulk copy per plane.
template <bool kRow, bool kRoots>
__device__ __forceinline__ void pipe_rows(unsigned char* smem,
                                          const __nv_bfloat16* __restrict__ in_re,
                                          const __nv_bfloat16* __restrict__ in_im,
                                          __nv_bfloat16* __restrict__ out_re,
                                          __nv_bfloat16* __restrict__ out_im,
                                          long long batch, int n, int lg_t,
                                          const StagePlan& plan,
                                          const __nv_bfloat16* __restrict__ mats,
                                          const float* __restrict__ tables) {
  const int lg = kRow ? 0 : lg_t;
  const int T = 1 << lg;
  // Thread 0: the rows of tile t into the landing buffer.
  auto fetch = [&](__nv_bfloat16* land, uint64_t* bar, long long t) {
    const long long r0 = t << lg;
    const long long rows = batch - r0 < T ? batch - r0 : T;
    const long long at = r0 * n;
    bulk_load(land, land + (n << lg), in_re + at, in_im + at,
              static_cast<uint32_t>(2 * rows * n), bar);
  };
  pipe_tiles<kRow, false, kRoots>(smem, fetch, out_re, out_im, batch, n, lg_t,
                                  plan, mats, tables);
}

template <bool kRow>
__global__ void __launch_bounds__(kThreads)
    fused_fft_pipe_kernel(const __nv_bfloat16* __restrict__ in_re,
                          const __nv_bfloat16* __restrict__ in_im,
                          __nv_bfloat16* __restrict__ out_re,
                          __nv_bfloat16* __restrict__ out_im, long long batch,
                          int n, int lg_t, StagePlan plan,
                          const __nv_bfloat16* __restrict__ mats,
                          const float* __restrict__ tables) {
  extern __shared__ __align__(16) unsigned char smem[];
  pipe_rows<kRow, false>(smem, in_re, in_im, out_re, out_im, batch, n, lg_t,
                         plan, mats, tables);
}

// The roots route's instance (tiles of T > 1 rows of a plan with a
// roots_stage): its own kernel, so that every other plan keeps the code it
// had (with the route inside fused_fft_pipe_kernel<false>, the 512^3 grid's
// 512-point rows took 3 % longer on the H100, with no spills).
__global__ void __launch_bounds__(kThreads)
    fused_fft_pipe_roots_kernel(const __nv_bfloat16* __restrict__ in_re,
                                const __nv_bfloat16* __restrict__ in_im,
                                __nv_bfloat16* __restrict__ out_re,
                                __nv_bfloat16* __restrict__ out_im,
                                long long batch, int n, int lg_t, StagePlan plan,
                                const __nv_bfloat16* __restrict__ mats,
                                const float* __restrict__ tables) {
  extern __shared__ __align__(16) unsigned char smem[];
  pipe_rows<false, true>(smem, in_re, in_im, out_re, out_im, batch, n, lg_t,
                         plan, mats, tables);
}

// The strided landing: the input seen as (outer, n, inner) with inner
// contiguous, one tensor map a plane (column_map); tile t covers the T
// lines c0 .. c0 + T - 1 of outer block o (t = o * per_outer + c0 / T,
// per_outer = inner / T), which are output rows tT .. tT + T - 1.  Each
// plane of the tile lands as n runs of T elements, i-major, in boxes of at
// most kBoxLines lines of i: element i of line lane at i * T + lane, the
// operand's order before the swizzle.  The tiles number at most INT_MAX, so
// t splits by a 32-bit division (a 64-bit one is a call, whose saved
// registers spill at the 128-register cap).
template <bool kRoots>
__device__ __forceinline__ void pipe_cols(unsigned char* cols_smem,
                                          const CUtensorMap& map_re,
                                          const CUtensorMap& map_im,
                                          __nv_bfloat16* __restrict__ out_re,
                                          __nv_bfloat16* __restrict__ out_im,
                                          long long batch, uint32_t per_outer,
                                          int n, int lg_t, const StagePlan& plan,
                                          const __nv_bfloat16* __restrict__ mats,
                                          const float* __restrict__ tables) {
  const int elems = n << lg_t, box = n < kBoxLines ? n : kBoxLines;
  auto fetch = [&](__nv_bfloat16* land, uint64_t* bar, long long t) {
    const uint32_t o = static_cast<uint32_t>(t) / per_outer;
    const int c0 = static_cast<int>((static_cast<uint32_t>(t) - o * per_outer)
                                    << lg_t);
    bar_expect(bar, 4u * static_cast<uint32_t>(elems));
    for (int i = 0; i < n; i += box) {
      tensor_load(land + (i << lg_t), &map_re, c0, i, static_cast<int>(o), bar);
      tensor_load(land + elems + (i << lg_t), &map_im, c0, i,
                  static_cast<int>(o), bar);
    }
  };
  pipe_tiles<false, true, kRoots>(cols_smem, fetch, out_re, out_im, batch, n,
                                  lg_t, plan, mats, tables);
}

__global__ void __launch_bounds__(kThreads)
    fused_fft_pipe_cols_kernel(const __grid_constant__ CUtensorMap map_re,
                               const __grid_constant__ CUtensorMap map_im,
                               __nv_bfloat16* __restrict__ out_re,
                               __nv_bfloat16* __restrict__ out_im,
                               long long batch, uint32_t per_outer, int n,
                               int lg_t, StagePlan plan,
                               const __nv_bfloat16* __restrict__ mats,
                               const float* __restrict__ tables) {
  // A tensor copy lands at a 128-byte aligned address.
  extern __shared__ __align__(128) unsigned char cols_smem[];
  pipe_cols<false>(cols_smem, map_re, map_im, out_re, out_im, batch, per_outer,
                   n, lg_t, plan, mats, tables);
}

// The strided landing's roots instance (fused_fft_pipe_roots_kernel's).
__global__ void __launch_bounds__(kThreads)
    fused_fft_pipe_cols_roots_kernel(const __grid_constant__ CUtensorMap map_re,
                                     const __grid_constant__ CUtensorMap map_im,
                                     __nv_bfloat16* __restrict__ out_re,
                                     __nv_bfloat16* __restrict__ out_im,
                                     long long batch, uint32_t per_outer, int n,
                                     int lg_t, StagePlan plan,
                                     const __nv_bfloat16* __restrict__ mats,
                                     const float* __restrict__ tables) {
  extern __shared__ __align__(128) unsigned char cols_smem[];
  pipe_cols<true>(cols_smem, map_re, map_im, out_re, out_im, batch, per_outer,
                  n, lg_t, plan, mats, tables);
}

int launch_fused_pipe(const void* in_re, const void* in_im, void* out_re,
                      void* out_im, long long batch, int n, int T, int sms,
                      const StagePlan& plan, const float* tables,
                      const __nv_bfloat16* mats, cudaStream_t stream) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(in_re) |
                       reinterpret_cast<uintptr_t>(in_im) |
                       reinterpret_cast<uintptr_t>(out_re) |
                       reinterpret_cast<uintptr_t>(out_im);
  if (mats == nullptr || plan.engine != kEngStacked || n < 32 ||
      (n & (n - 1)) != 0 || T < 1 || (T & (T - 1)) != 0 ||
      static_cast<long long>(n) * T > kMaxCtaElems || (at & 15) != 0 ||
      sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (batch + T - 1) / T;
  return launch_stage_kernel(
      T == 1 ? &fused_fft_pipe_kernel<true>
             : (roots_stage(plan) >= 0 ? &fused_fft_pipe_roots_kernel
                                       : &fused_fft_pipe_kernel<false>),
      tiles < sms ? tiles : sms, tc_threads(n * T), pipe_smem_bytes(n, T, plan),
      1, stream, static_cast<const __nv_bfloat16*>(in_re),
      static_cast<const __nv_bfloat16*>(in_im),
      static_cast<__nv_bfloat16*>(out_re), static_cast<__nv_bfloat16*>(out_im),
      batch, n, __builtin_ctz(T), plan, mats, tables);
}


// cuTensorMapEncodeTiled, from the driver through the runtime (so the
// library links nothing beyond the runtime), looked up once; null where
// the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of one bf16 plane seen as (outer, n, inner), inner
// contiguous (dimensions innermost first), whose box is T lines of inner by
// min(n, kBoxLines) of n by one of outer.
inline bool column_map(CUtensorMap* map, const void* plane, long long outer,
                       int n, long long inner, int T) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner) * n * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(T),
                             static_cast<cuuint32_t>(n < kBoxLines ? n : kBoxLines),
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(plane), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_fused_pipe_cols(const void* in_re, const void* in_im, void* out_re,
                           void* out_im, long long outer, int n,
                           long long inner, int T, int sms,
                           const StagePlan& plan, const float* tables,
                           const __nv_bfloat16* mats, cudaStream_t stream) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(in_re) |
                       reinterpret_cast<uintptr_t>(in_im) |
                       reinterpret_cast<uintptr_t>(out_re) |
                       reinterpret_cast<uintptr_t>(out_im);
  if (mats == nullptr || plan.engine != kEngStacked || n < 32 ||
      (n & (n - 1)) != 0 || T < 8 || (T & (T - 1)) != 0 ||
      static_cast<long long>(n) * T > kMaxCtaElems || (at & 15) != 0 ||
      sms < 1 || outer < 1 || inner < T || inner > INT_MAX ||
      inner % T != 0 || outer * (inner / T) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_re, map_im;
  if (!column_map(&map_re, in_re, outer, n, inner, T) ||
      !column_map(&map_im, in_im, outer, n, inner, T))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = outer * (inner / T);
  return launch_stage_kernel(
      roots_stage(plan) >= 0 ? &fused_fft_pipe_cols_roots_kernel
                             : &fused_fft_pipe_cols_kernel,
      tiles < sms ? tiles : sms,
      tc_threads(n * T), pipe_smem_bytes(n, T, plan), 1, stream, map_re, map_im,
      static_cast<__nv_bfloat16*>(out_re), static_cast<__nv_bfloat16*>(out_im),
      outer * inner, static_cast<uint32_t>(inner / T), n, __builtin_ctz(T),
      plan, mats, tables);
}

}  // namespace tfft
