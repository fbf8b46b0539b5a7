// Tensor-core stage engine of every one-CTA pass (sm_90a): kernel A
// (fused_fft_tc.cuh), the in-place row pass (row_pass_tc.cuh: K3 and K4's
// row pass), and kernels B and C (four_step_tc.cuh: the four-step column
// and row passes, K4's column pass, K5's packed column pass and K6's
// interleaving row pass, through the tile mode of run_fft_tc).  A pass past
// one CTA runs this engine's cluster mode (fft_mma_cluster.cuh: the twins of
// kernel A, of the row passes and, on column tiles, of kernel B).
//
// The stage of fft_stages.cuh's header, with its twiddles, splits,
// roundings and knobs (the helpers there), on two product routes:
//
//   * mma (a stage whose matrix every output shares, radix >= 8): the stage
//     product runs as mma.sync.aligned.m16n8k16 with bf16 operands and fp32
//     accumulation.  A warp takes output tiles of 8 r_out x 8 columns g;
//     the tile's 16 MMA rows are those 8 outputs' real parts, then their
//     imaginary parts, so a thread's accumulator holds re and im of the same
//     output (c0/c1 and c2/c3).  The k dimension walks chunks of 8 r, each
//     chunk 8 rows of one operand plane then 8 of another:
//       stacked: [[D_re, -D_im], [D_im, D_re]] on (z_re; z_im), one product;
//       planar:  [[A_re, 0], [0, A_im]] and [[A_im, 0], [0, A_re]] on
//                (z_re; z_im): A_re.z_re, A_im.z_im, A_im.z_re, A_re.z_im;
//       mult3:   [[M_re, 0], [0, M_im]] on (z_re; z_im) (t1, t2), and
//                [[S, 0], [0, 0]] on the z_re + z_im plane (t3).
//     Every partial product (i, j) of the dot algorithm (matrix term i,
//     data term j, i + j < levels) has its own fp32 accumulator, to which
//     each chunk's product (from a zero accumulator, mma_add) is added in
//     chunk order; the accumulators are then combined level by level as
//     combine_levels does.  bf16 x bf16 products are exact in fp32,
//     so the route changes only the order of the fp32 sums (the tensor
//     cores' sum of a k-chunk is not IEEE fmaf's).  An output's value
//     depends on its own row and column alone, so kernel A (T = 1) and the
//     row pass (T rows) compute it bit for bit alike.
//     B fragments come from the operand with ldmatrix.trans; the operand is
//     swizzled (stage_swizzle: the 16-byte column chunk XOR the row's low
//     bits) so that the 8 rows of one ldmatrix land on 8 bank groups.  A
//     fragments come from the global table in fragment order (one 32-bit
//     load per lane and matrix, 128 bytes per warp) through L1: the table
//     is the same for every CTA.  The bf16 policy's one-term stacked
//     stages take a warp blocking (mma_block) that shares each chunk's A
//     and B fragments across a block of tiles.  The pipelined kernel A
//     gathers a two-term stage of radix 256 from the stage's roots in
//     shared memory instead (stage_mma_roots, fused_fft_pipe.cu).
//   * vector (a folded stage, whose per-slice tables M_kk differ by output
//     column, and a stage of radix < 8): each output is a scalar loop over
//     r, fmaf in order, with an accumulator per partial product and real
//     product (stacked: re and im; planar: A_re.z_re, A_im.z_im, A_im.z_re,
//     A_re.z_im; mult3: t1, t2, t3), combined as on the mma route.  A lane
//     takes V consecutive r_out of one column (vec_width), so a warp's lanes
//     share a column and slice, and the tables are bf16, transposed within
//     a slice ([term][slice][r][r_out][re, im] or [re, im, S, 0]): a warp's
//     table read is one contiguous run in 16-byte loads, each entry read
//     once per CTA.
// The route is a static function of the stage (mma_route; the host builds
// each stage's table in its route's layout, ops/fused_cuda.py:mma_tables).
//
// Kernel A's and the row pass's transforms are consecutive rows, read in
// 16-byte loads (bf16 rows); kernels B and C read and write column tiles
// (T elements per row, in accesses of up to 16 bytes).  The last stage's
// outputs go to shared memory first (the operand is free by then), in
// natural order per transform (rows) or per bin (column tiles), and leave
// from there in contiguous runs.
#pragma once

#include <cstdint>

#include "fft_stages.cuh"

namespace tfft {

enum ProductKind { kProdStacked = 0, kProdPlanar = 1, kProdMult3 = 2 };

// Which route a stage takes (ops/fused_cuda.py:mma_route mirrors it).
__host__ __device__ inline bool mma_route(int mode, int radix) {
  return !folded(mode) && radix >= 8;
}

// Operand swizzle of a stage with nt = elems / R columns (a power of two):
// index r*nt + g is stored at r*nt + (g ^ x), x flipping bits 3..5 of g
// by the row's low bits, so the rows r..r+7 of one ldmatrix (pitch 2*nt
// bytes) fall on 8 different 16-byte bank groups.
struct Swizzle {
  int shift, mask;
};

__device__ __forceinline__ Swizzle stage_swizzle(int nt) {
  const int lg = __ffs(nt) - 1;
  if (nt >= 64) return {lg, 7};
  if (nt == 32) return {lg + 1, 3};
  if (nt == 16) return {lg + 2, 1};
  return {0, 0};
}

__device__ __forceinline__ int swz(int idx, Swizzle s) {
  return idx ^ (((idx >> s.shift) & s.mask) << 3);
}

// D += A.B, m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc += A.B for one k-chunk: the chunk's sum from a zero accumulator, then
// one IEEE fp32 add.  The tensor cores align and cut a chunk's sum without
// rounding to nearest, accumulator included; kept out of it, the running
// sum rounds as an fmaf chain does, and the kernels stay within the
// agreement bounds of an fmaf-in-r-order engine (fused bf16: one bf16 ulp of
// the output scale on at most 0.1 % of elements).
__device__ __forceinline__ void mma_add(float (&acc)[4], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint32_t b0, uint32_t b1) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(t, a0, a1, a2, a3, b0, b1);
#pragma unroll
  for (int x = 0; x < 4; ++x) acc[x] = __fadd_rn(acc[x], t[x]);
}

// Two transposed 8x8 bf16 matrices from shared memory: lanes 0-7 give the
// rows of the first, 8-15 those of the second.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a)
               : "memory");
}

// ldsm_x2_trans at a shared-memory address.
__device__ __forceinline__ void ldsm_x2_trans_at(uint32_t& r0, uint32_t& r1,
                                                 uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float lo_bf16(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// The B fragment (k 16 x n 8) of one chunk: rows 8c..8c+7 of plane p0 (k
// 0-7) and of plane p1 (k 8-15), columns g0..g0+7.  Below 8 columns per
// row (nt < 8, no swizzle) columns past nt read as zero.
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const __nv_bfloat16* p0,
                                       const __nv_bfloat16* p1, int c, int g0,
                                       int nt, Swizzle sw) {
  const int lane = threadIdx.x & 31;
  if (nt >= 8) {
    const int row = 8 * c + (lane & 7);
    ldsm_x2_trans(b0, b1, ((lane & 8) ? p1 : p0) + swz(row * nt + g0, sw));
  } else {
    const int col = lane >> 2, k = 8 * c + 2 * (lane & 3);
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    const bool ok = col < nt;
    b0 = pack_bf16(ok ? p0[k * nt + col] : zero, ok ? p0[(k + 1) * nt + col] : zero);
    b1 = pack_bf16(ok ? p1[k * nt + col] : zero, ok ? p1[(k + 1) * nt + col] : zero);
  }
}

// Element x (0..3) of a tile's partial products, combined level by level.
template <int AT, int BT>
__device__ __forceinline__ float combine_tile(const float (&acc)[AT][BT][4],
                                              int x) {
  float a[AT][BT];
#pragma unroll
  for (int i = 0; i < AT; ++i)
#pragma unroll
    for (int j = 0; j < BT; ++j) a[i][j] = acc[i][j][x];
  return combine_levels<AT, BT>(a);
}

// The mma route of one stage: this warp's tiles t = warp + tt * warps,
// tile t = q * ntiles + j covering r_out 8q..8q+7 and columns 8j..8j+7;
// the thread's outputs (r_out 8q + lane/4, columns 8j + 2(lane%4) + h)
// land in o[2tt + h].  frag: the stage's table in fragment order,
// [term][matrix][q][c][lane] pairs (entries r = 8c + 2(lane%4) + {0, 1} of
// row r_out = 8q + lane/4).
template <int AT, int BT, int kKind>
__device__ __forceinline__ void stage_mma(const __nv_bfloat16* op, int elems,
                                          int nt, int R, Swizzle sw,
                                          const uint32_t* __restrict__ frag,
                                          float (&o_re)[kMaxEpt],
                                          float (&o_im)[kMaxEpt]) {
  constexpr int L = AT > BT ? AT : BT;
  constexpr int kMats = kKind == kProdMult3 ? 3 : 2;
  constexpr int kProds = kKind == kProdStacked ? 1 : 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int chunks = R >> 3;
  const int ntiles = (nt + 7) >> 3;
  const int tiles = chunks * ntiles;
  const int mat_stride = chunks * chunks * 32;
#pragma unroll
  for (int tt = 0; tt < kMaxEpt / 2; ++tt) {
    const int tile = warp + tt * warps;
    if (tile < tiles) {
      const int q = tile / ntiles, g0 = (tile - q * ntiles) << 3;
      float acc[kProds][AT][BT][4];
#pragma unroll
      for (int p = 0; p < kProds; ++p)
#pragma unroll
        for (int i = 0; i < AT; ++i)
#pragma unroll
          for (int j = 0; j < BT; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) acc[p][i][j][x] = 0.0f;
      const uint32_t* fq = frag + q * chunks * 32 + lane;
#pragma unroll 2
      for (int c = 0; c < chunks; ++c) {
        uint32_t b[BT][2], s[BT][2];
#pragma unroll
        for (int j = 0; j < BT; ++j) {
          load_b(b[j][0], b[j][1], op + (2 * j) * elems,
                 op + (2 * j + 1) * elems, c, g0, nt, sw);
          if constexpr (kKind == kProdMult3) {
            const __nv_bfloat16* sp = op + (2 * BT + j) * elems;
            load_b(s[j][0], s[j][1], sp, sp, c, g0, nt, sw);
          }
        }
#pragma unroll
        for (int i = 0; i < AT; ++i) {
          const uint32_t* f = fq + (i * kMats) * mat_stride + c * 32;
          const uint32_t m0 = __ldg(f), m1 = __ldg(f + mat_stride);
          uint32_t m2 = 0;
          if constexpr (kKind == kProdMult3) m2 = __ldg(f + 2 * mat_stride);
#pragma unroll
          for (int j = 0; j < BT; ++j) {
            if (i + j < L) {
              if constexpr (kKind == kProdStacked) {
                mma_add(acc[0][i][j], m0, m1, m1 ^ 0x80008000u, m0, b[j][0],
                        b[j][1]);
              } else if constexpr (kKind == kProdPlanar) {
                mma_add(acc[0][i][j], m0, 0u, 0u, m1, b[j][0], b[j][1]);
                mma_add(acc[1][i][j], m1, 0u, 0u, m0, b[j][0], b[j][1]);
              } else {
                mma_add(acc[0][i][j], m0, 0u, 0u, m1, b[j][0], b[j][1]);
                mma_add(acc[1][i][j], m2, 0u, 0u, 0u, s[j][0], s[j][1]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (kKind == kProdStacked) {
          o_re[2 * tt + h] = combine_tile<AT, BT>(acc[0], h);
          o_im[2 * tt + h] = combine_tile<AT, BT>(acc[0], 2 + h);
        } else if constexpr (kKind == kProdPlanar) {
          o_re[2 * tt + h] = __fsub_rn(combine_tile<AT, BT>(acc[0], h),
                                       combine_tile<AT, BT>(acc[0], 2 + h));
          o_im[2 * tt + h] = __fadd_rn(combine_tile<AT, BT>(acc[1], h),
                                       combine_tile<AT, BT>(acc[1], 2 + h));
        } else {
          const float t1 = combine_tile<AT, BT>(acc[0], h);
          const float t2 = combine_tile<AT, BT>(acc[0], 2 + h);
          const float t3 = combine_tile<AT, BT>(acc[1], h);
          o_re[2 * tt + h] = __fsub_rn(t1, t2);
          o_im[2 * tt + h] = __fsub_rn(__fsub_rn(t3, t1), t2);
        }
      }
    }
  }
}

// The warp blocking of a one-term stacked mma stage (bf16 policy, AT = BT
// = 1), or 0 where the stage takes stage_mma's tile loop: with 16, 8 or 4
// tiles per warp, warp w takes a block of QW r_out tiles by JW column tiles
// ((4, 4), (2, 4), (2, 2)), so each k-chunk loads QW A fragments and JW B
// fragments for QW * JW independent mma.  An output's sum is the same
// whichever warp computes it.
__device__ __forceinline__ int mma_block(int chunks, int nt) {
  const int warps = blockDim.x >> 5;
  const int ntiles = nt >> 3;
  if (nt < 8 || chunks * ntiles < warps) return 0;
  const int tpw = chunks * ntiles / warps;
  if (tpw == 16 && chunks % 4 == 0 && ntiles % 4 == 0) return 16;
  if (tpw == 8 && chunks % 2 == 0 && ntiles % 4 == 0) return 8;
  if (tpw == 4 && chunks % 2 == 0 && ntiles % 2 == 0) return 4;
  return 0;
}

// (QW, JW) of a blocking, and this warp's first r_out tile and column tile.
__device__ __forceinline__ void block_origin(int blk, int chunks, int& qw,
                                             int& jw, int& q0, int& j0) {
  qw = blk == 16 ? 4 : 2;
  jw = blk == 4 ? 2 : 4;
  const int warp = threadIdx.x >> 5, bq = chunks / qw;
  q0 = (warp % bq) * qw;
  j0 = (warp / bq) * jw;
}

// stage_mma for a one-term stacked stage under a blocking: slot tt = qi *
// JW + ji holds tile (q0 + qi, j0 + ji), its outputs in o[2tt + h].
template <int QW, int JW>
__device__ __forceinline__ void stage_mma_blocked(
    const __nv_bfloat16* op, int elems, int nt, int R, Swizzle sw,
    const uint32_t* __restrict__ frag, float (&o_re)[kMaxEpt],
    float (&o_im)[kMaxEpt]) {
  const int lane = threadIdx.x & 31;
  const int chunks = R >> 3;
  const int mat_stride = chunks * chunks * 32;
  int qw, jw, q0, j0;
  block_origin(QW * JW, chunks, qw, jw, q0, j0);
  // The outputs accumulate in place: slot t's c0..c3 are o_re[2t],
  // o_re[2t + 1], o_im[2t], o_im[2t + 1].
#pragma unroll
  for (int t = 0; t < 2 * QW * JW; ++t) o_re[t] = o_im[t] = 0.0f;
  const uint32_t* fq = frag + q0 * chunks * 32 + lane;
  for (int c = 0; c < chunks; ++c) {
    uint32_t a[QW][2];
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      const uint32_t* f = fq + qi * chunks * 32 + c * 32;
      a[qi][0] = __ldg(f);
      a[qi][1] = __ldg(f + mat_stride);
    }
#pragma unroll
    for (int ji = 0; ji < JW; ++ji) {
      uint32_t b0, b1;
      load_b(b0, b1, op, op + elems, c, (j0 + ji) << 3, nt, sw);
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
        const int t = qi * JW + ji;
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(c, a[qi][0], a[qi][1], a[qi][1] ^ 0x80008000u, a[qi][0], b0,
                 b1);
        o_re[2 * t] = __fadd_rn(o_re[2 * t], c[0]);  // as mma_add
        o_re[2 * t + 1] = __fadd_rn(o_re[2 * t + 1], c[1]);
        o_im[2 * t] = __fadd_rn(o_im[2 * t], c[2]);
        o_im[2 * t + 1] = __fadd_rn(o_im[2 * t + 1], c[3]);
      }
    }
  }
}

// The slot of root k in a stage's copy of its R roots in shared memory
// (stage_mma_roots): a pad after every 32 roots spreads a warp's gathers
// over more banks (by a bank model of the fragment's indices at R = 256, 4.2
// wavefronts a 64-bit gather on average against 6.0 unpadded).  R + R / 32
// slots hold R roots.
__host__ __device__ constexpr int root_slot(int k) { return k + (k >> 5); }

// stage_mma for a two-term stacked stage of radix R (a power of two) whose
// entry (r_out, r) is its entry (1, (r_out * r) mod R), as every entry of the
// stacked DFT matrix is (ops/fused_cuda.py:roots_route), with the A
// fragments gathered from the stage's R roots in shared memory instead of
// read from its R x R fragment table: roots[root_slot(k)] holds root k as a
// bf16 pair (re | im << 16) per term, x term 0 and y term 1.  Lane l of
// chunk c takes entries r = 8c + 2(l % 4) + {0, 1} of row r_out = 8q + l / 4,
// roots k0 = r_out (8c + 2(l % 4)) and k0 + r_out (mod R): two 64-bit
// gathers and four permutes give the words m0 (both entries' re) and m1
// (their im) of each term that stage_mma loads.
//
// Tiles: under a warp blocking (blk = mma_block's, block_origin's QW x JB
// tiles, slot qi * JB + ji) G groups of JW column tiles that share their
// r_out tile, slot gi * JW + ji, so a chunk's gathers serve JW tiles; with
// none (blk = 0: JB = 0, JW = 1, G = kMaxEpt / 2) stage_mma's tile order,
// slot tt.  Each output's sum is stage_mma's: per term, each chunk's product
// from a zero accumulator added in chunk order, then the terms added as
// combine_levels<2, 1> does, so the outputs equal stage_mma's bit for bit.
template <int G, int JW, int JB>
__device__ __forceinline__ void stage_mma_roots(const __nv_bfloat16* op,
                                                int elems, int nt, int R,
                                                Swizzle sw, int blk,
                                                const uint2* roots,
                                                float (&o_re)[kMaxEpt],
                                                float (&o_im)[kMaxEpt]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, chunks = R >> 3, mask = R - 1;
  const int ntiles = (nt + 7) >> 3;
  int qw, jw, q0 = 0, j0 = 0;
  if constexpr (JB > 0) block_origin(blk, chunks, qw, jw, q0, j0);
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    int q, g0;
    bool on = true;
    if constexpr (JB > 0) {
      q = q0 + gi * JW / JB;
      g0 = (j0 + gi * JW % JB) << 3;
    } else {
      const int tile = warp + gi * warps;
      on = tile < chunks * ntiles;
      q = tile / ntiles;
      g0 = (tile - q * ntiles) << 3;
    }
    if (on) {
      const int r_out = 8 * q + (lane >> 2);
      const int step = (8 * r_out) & mask;
      int k = (2 * (lane & 3) * r_out) & mask;
      // Under a blocking nt >= 16, and the swizzle of operand row 8c + l
      // (l < 8) is row l's, so a column tile's ldmatrix address steps by 8
      // rows a chunk.
      uint32_t b_at[JW];
      if constexpr (JB > 0) {
#pragma unroll
        for (int ji = 0; ji < JW; ++ji)
          b_at[ji] = static_cast<uint32_t>(__cvta_generic_to_shared(
              ((lane & 8) ? op + elems : op) +
              swz((lane & 7) * nt + g0 + (ji << 3), sw)));
      }
      // Term 0 accumulates in the output slots, term 1 here.
      float hi[JW][4];
#pragma unroll
      for (int ji = 0; ji < JW; ++ji) {
        const int t = gi * JW + ji;
        o_re[2 * t] = o_re[2 * t + 1] = o_im[2 * t] = o_im[2 * t + 1] = 0.0f;
#pragma unroll
        for (int x = 0; x < 4; ++x) hi[ji][x] = 0.0f;
      }
#pragma unroll 1
      for (int c = 0; c < chunks; ++c) {
        const uint2 w0 = roots[root_slot(k)];
        const uint2 w1 = roots[root_slot((k + r_out) & mask)];
        const uint32_t a0 = __byte_perm(w0.x, w1.x, 0x5410);
        const uint32_t a1 = __byte_perm(w0.x, w1.x, 0x7632);
        const uint32_t e0 = __byte_perm(w0.y, w1.y, 0x5410);
        const uint32_t e1 = __byte_perm(w0.y, w1.y, 0x7632);
#pragma unroll
        for (int ji = 0; ji < JW; ++ji) {
          const int t = gi * JW + ji;
          uint32_t b0, b1;
          if constexpr (JB > 0)
            ldsm_x2_trans_at(b0, b1, b_at[ji] + c * 16 * nt);
          else
            load_b(b0, b1, op, op + elems, c, g0 + (ji << 3), nt, sw);
          float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(p, a0, a1, a1 ^ 0x80008000u, a0, b0, b1);
          o_re[2 * t] = __fadd_rn(o_re[2 * t], p[0]);  // as mma_add
          o_re[2 * t + 1] = __fadd_rn(o_re[2 * t + 1], p[1]);
          o_im[2 * t] = __fadd_rn(o_im[2 * t], p[2]);
          o_im[2 * t + 1] = __fadd_rn(o_im[2 * t + 1], p[3]);
          mma_add(hi[ji], e0, e1, e1 ^ 0x80008000u, e0, b0, b1);
        }
        k = (k + step) & mask;
      }
#pragma unroll
      for (int ji = 0; ji < JW; ++ji) {
        const int t = gi * JW + ji;
        o_re[2 * t] = __fadd_rn(o_re[2 * t], hi[ji][0]);
        o_re[2 * t + 1] = __fadd_rn(o_re[2 * t + 1], hi[ji][1]);
        o_im[2 * t] = __fadd_rn(o_im[2 * t], hi[ji][2]);
        o_im[2 * t + 1] = __fadd_rn(o_im[2 * t + 1], hi[ji][3]);
      }
    }
  }
}

// kWords 32-bit words of a vector-route table row from global memory, in
// 16-byte loads where they fill one.
template <int kWords>
__device__ __forceinline__ void ldg_words(const __nv_bfloat16* p,
                                          uint32_t (&w)[kWords]) {
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int k = 0; k < kWords / 4; ++k) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + k);
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
  } else if constexpr (kWords == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// Partial products (i, j) of the dot algorithm: i < AT, j < BT, i + j <
// levels.
template <int AT, int BT>
__host__ __device__ constexpr int dot_pairs() {
  int n = 0;
  for (int i = 0; i < AT; ++i)
    for (int j = 0; j < BT; ++j)
      if (i + j < (AT > BT ? AT : BT)) ++n;
  return n;
}

// Outputs per lane of the vector route (consecutive r_out of one column):
// as many as keep the accumulators within 16 registers, at most 4.
template <int AT, int BT, int kKind>
__host__ __device__ constexpr int vec_width() {
  constexpr int acc = (kKind == kProdStacked ? 2 : (kKind == kProdPlanar ? 4 : 3)) *
                      dot_pairs<AT, BT>();
  return acc <= 4 ? 4 : (acc <= 8 ? 2 : 1);
}

// The vector route of one stage: items o = tid + e * blockDim of V
// outputs each, r_out = (o % (R/V)) * V + v and column g = o / (R/V),
// output v of item e in slot e*V + v; each output is a scalar product,
// fmaf over r in order.  d: the stage's table,
// [term][slice][r][r_out][W] (W = 2, or 4 for mult3), ts its term stride
// and, on a folded stage (slice_elems = M*T), slice g / slice_elems at
// slice_stride entries per slice; a lane reads the V entries of its row r
// in one load.
template <int AT, int BT, int kKind, int V>
__device__ __forceinline__ void stage_vec(const __nv_bfloat16* op, int elems,
                                          int nt, int R, int lg_r, Swizzle sw,
                                          const __nv_bfloat16* __restrict__ d,
                                          int ts, int slice_elems,
                                          int slice_stride,
                                          float (&o_re)[kMaxEpt],
                                          float (&o_im)[kMaxEpt]) {
  constexpr int L = AT > BT ? AT : BT;
  constexpr int W = kKind == kProdMult3 ? 4 : 2;
  constexpr int kWords = V * W / 2;
  constexpr int kAcc = kKind == kProdStacked ? 2 : (kKind == kProdPlanar ? 4 : 3);
  constexpr int lg_v = V == 4 ? 2 : (V == 2 ? 1 : 0);
  const int items = elems >> lg_v;
#pragma unroll
  for (int e = 0; e < kMaxEpt / V; ++e) {
    const int o = threadIdx.x + e * blockDim.x;
    if (o < items) {
      const int rb = o & ((R >> lg_v) - 1), g = o >> (lg_r - lg_v);
      const __nv_bfloat16* dd =
          d + (slice_elems > 0 ? (g / slice_elems) * slice_stride : 0) +
          rb * V * W;
      float acc[V][kAcc][AT][BT];
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int p = 0; p < kAcc; ++p)
#pragma unroll
          for (int i = 0; i < AT; ++i)
#pragma unroll
            for (int j = 0; j < BT; ++j) acc[v][p][i][j] = 0.0f;
      for (int r = 0; r < R; ++r) {
        const int zi = swz(r * nt + g, sw);
        float z_re[BT], z_im[BT], z_s[BT];
#pragma unroll
        for (int j = 0; j < BT; ++j) {
          z_re[j] = __bfloat162float(op[(2 * j) * elems + zi]);
          z_im[j] = __bfloat162float(op[(2 * j + 1) * elems + zi]);
          if constexpr (kKind == kProdMult3)
            z_s[j] = __bfloat162float(op[(2 * BT + j) * elems + zi]);
        }
#pragma unroll
        for (int i = 0; i < AT; ++i) {
          uint32_t w[kWords];
          ldg_words<kWords>(dd + i * ts + r * R * W, w);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const uint32_t w0 = w[v * W / 2];
            const float d_re = lo_bf16(w0), d_im = hi_bf16(w0);
            float d_s = 0.0f;
            if constexpr (kKind == kProdMult3) d_s = lo_bf16(w[v * W / 2 + 1]);
            float (&a)[kAcc][AT][BT] = acc[v];
#pragma unroll
            for (int j = 0; j < BT; ++j) {
              if (i + j < L) {
                if constexpr (kKind == kProdStacked) {
                  a[0][i][j] = fmaf(d_re, z_re[j], a[0][i][j]);
                  a[0][i][j] = fmaf(-d_im, z_im[j], a[0][i][j]);
                  a[1][i][j] = fmaf(d_im, z_re[j], a[1][i][j]);
                  a[1][i][j] = fmaf(d_re, z_im[j], a[1][i][j]);
                } else if constexpr (kKind == kProdPlanar) {
                  a[0][i][j] = fmaf(d_re, z_re[j], a[0][i][j]);
                  a[1][i][j] = fmaf(d_im, z_im[j], a[1][i][j]);
                  a[2][i][j] = fmaf(d_im, z_re[j], a[2][i][j]);
                  a[3][i][j] = fmaf(d_re, z_im[j], a[3][i][j]);
                } else {  // mult3
                  a[0][i][j] = fmaf(d_re, z_re[j], a[0][i][j]);
                  a[1][i][j] = fmaf(d_im, z_im[j], a[1][i][j]);
                  a[2][i][j] = fmaf(d_s, z_s[j], a[2][i][j]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int x = e * V + v;
        if constexpr (kKind == kProdStacked) {
          o_re[x] = combine_levels<AT, BT>(acc[v][0]);
          o_im[x] = combine_levels<AT, BT>(acc[v][1]);
        } else if constexpr (kKind == kProdPlanar) {
          o_re[x] = __fsub_rn(combine_levels<AT, BT>(acc[v][0]),
                              combine_levels<AT, BT>(acc[v][1]));
          o_im[x] = __fadd_rn(combine_levels<AT, BT>(acc[v][2]),
                              combine_levels<AT, BT>(acc[v][3]));
        } else {
          const float t1 = combine_levels<AT, BT>(acc[v][0]);
          const float t2 = combine_levels<AT, BT>(acc[v][1]);
          const float t3 = combine_levels<AT, BT>(acc[v][2]);
          o_re[x] = __fsub_rn(t1, t2);
          o_im[x] = __fsub_rn(__fsub_rn(t3, t1), t2);
        }
      }
    }
  }
}

// The vector route at its width: vec_width, or 1 on a stage of radix
// below it.  Returns the width taken.
template <int AT, int BT, int kKind>
__device__ __forceinline__ int stage_vec_any(
    const __nv_bfloat16* op, int elems, int nt, int R, int lg_r, Swizzle sw,
    const __nv_bfloat16* d, int ts, int slice_elems, int slice_stride,
    float (&o_re)[kMaxEpt], float (&o_im)[kMaxEpt]) {
  constexpr int V = vec_width<AT, BT, kKind>();
  if constexpr (V > 1) {
    if (R >= V) {
      stage_vec<AT, BT, kKind, V>(op, elems, nt, R, lg_r, sw, d, ts,
                                  slice_elems, slice_stride, o_re, o_im);
      return V;
    }
  }
  stage_vec<AT, BT, kKind, 1>(op, elems, nt, R, lg_r, sw, d, ts, slice_elems,
                              slice_stride, o_re, o_im);
  return 1;
}

// f(slot, r_out, g) for the outputs of a vector-route stage of width V.
template <int V, class F>
__device__ __forceinline__ void for_vec_outputs(int elems, int R, int lg_r,
                                                const F& f) {
  constexpr int lg_v = V == 4 ? 2 : (V == 2 ? 1 : 0);
  const int items = elems >> lg_v;
#pragma unroll
  for (int e = 0; e < kMaxEpt / V; ++e) {
    const int o = threadIdx.x + e * blockDim.x;
    if (o < items) {
      const int rb = o & ((R >> lg_v) - 1), g = o >> (lg_r - lg_v);
#pragma unroll
      for (int v = 0; v < V; ++v) f(e * V + v, rb * V + v, g);
    }
  }
}

// Call f(e, r_out, g) for every output this thread holds after a stage of
// the given route.
template <class F>
__device__ __forceinline__ void for_outputs(bool mma, int blk, int vv,
                                            int elems, int nt, int R, int lg_r,
                                            const F& f) {
  if (blk) {
    const int lane = threadIdx.x & 31;
    int qw, jw, q0, j0;
    block_origin(blk, R >> 3, qw, jw, q0, j0);
#pragma unroll
    for (int t = 0; t < kMaxEpt / 2; ++t) {
      if (t < blk) {
        const int qi = t / jw, ji = t - qi * jw;
        const int r_out = 8 * (q0 + qi) + (lane >> 2);
        const int g = ((j0 + ji) << 3) + 2 * (lane & 3);
        f(2 * t, r_out, g);
        f(2 * t + 1, r_out, g + 1);
      }
    }
  } else if (mma) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const int ntiles = (nt + 7) >> 3;
    const int tiles = (R >> 3) * ntiles;
#pragma unroll
    for (int tt = 0; tt < kMaxEpt / 2; ++tt) {
      const int tile = warp + tt * warps;
      if (tile < tiles) {
        const int q = tile / ntiles;
        const int r_out = 8 * q + (lane >> 2);
        const int g = ((tile - q * ntiles) << 3) + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (g + h < nt) f(2 * tt + h, r_out, g + h);
      }
    }
  } else if (vv == 4) {
    for_vec_outputs<4>(elems, R, lg_r, f);
  } else if (vv == 2) {
    for_vec_outputs<2>(elems, R, lg_r, f);
  } else {
    for_vec_outputs<1>(elems, R, lg_r, f);
  }
}

// One stage's products on either route, for the matrix terms AT; returns
// the vector route's width (0 on the mma route).
template <int AT, int BT, int kEngine>
__device__ __forceinline__ int stage_products(
    const __nv_bfloat16* op, int elems, int nt, int R, int lg_r, Swizzle sw,
    bool mma, int blk, bool mult3, const __nv_bfloat16* d, int ts,
    int slice_elems, int slice_stride, float (&o_re)[kMaxEpt],
    float (&o_im)[kMaxEpt]) {
  constexpr int kBase = kEngine == kEngPlanar ? kProdPlanar : kProdStacked;
  const uint32_t* frag = reinterpret_cast<const uint32_t*>(d);
  if constexpr (AT == 1 && BT == 1 && kBase == kProdStacked) {
    if (blk == 16) {
      stage_mma_blocked<4, 4>(op, elems, nt, R, sw, frag, o_re, o_im);
      return 0;
    }
    if (blk == 8) {
      stage_mma_blocked<2, 4>(op, elems, nt, R, sw, frag, o_re, o_im);
      return 0;
    }
    if (blk == 4) {
      stage_mma_blocked<2, 2>(op, elems, nt, R, sw, frag, o_re, o_im);
      return 0;
    }
  }
  if constexpr (kEngine == kEngKnobs) {
    if (mult3) {
      if (!mma)
        return stage_vec_any<AT, BT, kProdMult3>(op, elems, nt, R, lg_r, sw, d,
                                                 ts, slice_elems, slice_stride,
                                                 o_re, o_im);
      stage_mma<AT, BT, kProdMult3>(op, elems, nt, R, sw, frag, o_re, o_im);
      return 0;
    }
  }
  if (!mma)
    return stage_vec_any<AT, BT, kBase>(op, elems, nt, R, lg_r, sw, d, ts,
                                        slice_elems, slice_stride, o_re, o_im);
  stage_mma<AT, BT, kBase>(op, elems, nt, R, sw, frag, o_re, o_im);
  return 0;
}

// 16 bytes of a row: VEC = 16 / sizeof(S) elements, as floats.
template <typename S>
__device__ __forceinline__ void ld_vec(const S* p, float (&x)[16 / sizeof(S)]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(S) == 2) {
      x[2 * k] = lo_bf16(w[k]);
      x[2 * k + 1] = hi_bf16(w[k]);
    } else {
      x[k] = __uint_as_float(w[k]);
    }
  }
}

// Where a CTA's T transforms of n elements lie in global memory (element i
// of transform lane; a pitch counts complex elements):
//   kTileRows:  T consecutive rows, re[lane * n + i] and im[lane * n + i];
//   kTileCols:  T adjacent columns, re[i * pitch + lane] and im[...];
//   kTilePairs: T adjacent columns of one real array holding (re, im) side
//               by side, x[2 * (i * pitch + lane) + {0, 1}].
enum TileLayout { kTileRows = 0, kTileCols = 1, kTilePairs = 2 };

// How a tile run (run_fft_tc with kTile) lays out its input and its
// output; a kTilePairs side reads or writes only the `re` pointer.
struct TileMap {
  int in_layout, out_layout;
  long long in_pitch, out_pitch;
};

// An epilogue that leaves the outputs as they are.
struct NoEpilogue {
  __device__ __forceinline__ void operator()(int, int, float&, float&) const {}
};

template <int B>
struct Bytes;
template <>
struct Bytes<16> {
  using T = uint4;
};
template <>
struct Bytes<8> {
  using T = uint2;
};
template <>
struct Bytes<4> {
  using T = unsigned int;
};
template <>
struct Bytes<2> {
  using T = unsigned short;
};

// B bytes of S at p (B / sizeof(S) elements), as floats.
template <typename S, int B>
__device__ __forceinline__ void ld_floats(const S* p,
                                          float (&x)[B / sizeof(S)]) {
  if constexpr (B == 16) {
    ld_vec<S>(p, x);
  } else if constexpr (B == 2) {
    x[0] = __uint_as_float(
        static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p))
        << 16);
  } else {
    uint32_t w[B / 4];
    if constexpr (B == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const unsigned int*>(p);
    }
#pragma unroll
    for (int k = 0; k < B / 4; ++k) {
      if constexpr (sizeof(S) == 2) {
        x[2 * k] = lo_bf16(w[k]);
        x[2 * k + 1] = hi_bf16(w[k]);
      } else {
        x[k] = __uint_as_float(w[k]);
      }
    }
  }
}

// The widest access of 16, 8, 4 or 2 bytes, at least `least`, on which
// every row of a column tile starts and ends: rows `row_bytes` long,
// `pitch_bytes` apart from the addresses `at` (the OR of the tile's
// pointers, and of anything else that must align).  0 where none.
__device__ __forceinline__ int tile_access(uintptr_t at, long long pitch_bytes,
                                           int row_bytes, int least) {
  const unsigned long long a = at | static_cast<unsigned long long>(pitch_bytes) |
                               static_cast<unsigned>(row_bytes);
  int w = 16;
  while (w > least && (a & (w - 1))) w >>= 1;
  return (a & (w - 1)) ? 0 : w;
}

// Load a column tile of n rows i (elems = n*T elements) in accesses of B
// bytes, putting element (i, lane) at operand index i*T + lane:
// kTileCols reads T elements of re and of im per row, kTilePairs 2T
// scalars of re.
template <typename S, int B, bool kPairs, class Put>
__device__ __forceinline__ void load_cols(const S* re, const S* im,
                                          long long pitch, int T, int elems,
                                          const Put& put) {
  constexpr int E = B / sizeof(S);  // scalars per access
  const int width = kPairs ? 2 * T : T;
  const long long row = kPairs ? 2 * pitch : pitch;
  const int total = kPairs ? 2 * elems : elems;
  for (int s = threadIdx.x * E; s < total; s += blockDim.x * E) {
    const int i = s / width, c = s - i * width;
    const long long at = i * row + c;
    float x[E];
    ld_floats<S, B>(re + at, x);
    if constexpr (kPairs) {
#pragma unroll
      for (int k = 0; k < E / 2; ++k) put(s / 2 + k, x[2 * k], x[2 * k + 1]);
    } else {
      float y[E];
      ld_floats<S, B>(im + at, y);
#pragma unroll
      for (int k = 0; k < E; ++k) put(s + k, x[k], y[k]);
    }
  }
}

// load_cols at the widest access the tile's alignment allows; a pair tile
// whose pairs do not align is read element by element.
template <typename S, bool kPairs, class Put>
__device__ __forceinline__ void load_tile(const S* re, const S* im,
                                          long long pitch, int T, int elems,
                                          const Put& put) {
  constexpr int kLeast = (kPairs ? 2 : 1) * static_cast<int>(sizeof(S));
  const uintptr_t at = reinterpret_cast<uintptr_t>(re) |
                       (kPairs ? 0 : reinterpret_cast<uintptr_t>(im));
  const int b = tile_access(at, (kPairs ? 2 : 1) * pitch * sizeof(S),
                            T * kLeast, kLeast);
  if (b == 16) return load_cols<S, 16, kPairs>(re, im, pitch, T, elems, put);
  if (b == 8) return load_cols<S, 8, kPairs>(re, im, pitch, T, elems, put);
  if constexpr (kLeast <= 4) {
    if (b == 4) return load_cols<S, 4, kPairs>(re, im, pitch, T, elems, put);
  }
  if constexpr (kLeast <= 2) {
    if (b == 2) return load_cols<S, 2, kPairs>(re, im, pitch, T, elems, put);
  }
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int i = e / T, lane = e - i * T;
    const long long at2 = 2 * (i * pitch + lane);
    put(e, to_float(re[at2]), to_float(re[at2 + 1]));
  }
}

// Copy staged rows of `width` scalars (`total` in all, from `st`; the im
// plane `plane` scalars on) to row k at k*pitch of re (and of im with
// kTwo), in accesses of B bytes.
template <typename S, int B, bool kTwo>
__device__ __forceinline__ void store_rows(const S* st, S* re, S* im,
                                           long long pitch, int width,
                                           int total, int plane) {
  using V = typename Bytes<B>::T;
  constexpr int E = B / sizeof(S);
  for (int s = threadIdx.x * E; s < total; s += blockDim.x * E) {
    const int k = s / width, c = s - k * width;
    const long long at = k * pitch + c;
    *reinterpret_cast<V*>(re + at) = *reinterpret_cast<const V*>(st + s);
    if constexpr (kTwo)
      *reinterpret_cast<V*>(im + at) =
          *reinterpret_cast<const V*>(st + plane + s);
  }
}

// The staged outputs of a tile (kTileCols: planes [re | im] of [k][lane];
// kTilePairs: [k][lane][re, im]) to their column tile.
template <typename S, bool kPairs>
__device__ __forceinline__ void store_tile(const S* st, S* re, S* im,
                                           long long pitch, int T, int elems) {
  constexpr int kE = static_cast<int>(sizeof(S));
  const int width = (kPairs ? 2 : 1) * T;
  const uintptr_t at = reinterpret_cast<uintptr_t>(re) |
                       (kPairs ? 0 : reinterpret_cast<uintptr_t>(im)) |
                       static_cast<uintptr_t>(elems) * kE;
  const int b = tile_access(at, (kPairs ? 2 : 1) * pitch * kE, width * kE, kE);
  const long long row = (kPairs ? 2 : 1) * pitch;
  const int total = (kPairs ? 2 : 1) * elems;
#define TFFT_STORE_ROWS(B)                                                  \
  if constexpr (B >= kE) {                                                  \
    if (b == B)                                                             \
      return store_rows<S, B, !kPairs>(st, re, im, row, width, total, elems); \
  }
  TFFT_STORE_ROWS(16)
  TFFT_STORE_ROWS(8)
  TFFT_STORE_ROWS(4)
  TFFT_STORE_ROWS(2)
#undef TFFT_STORE_ROWS
}

// The whole stage sequence of one pass on the tensor-core engine (the stage,
// knobs and roundings of fft_stages.cuh), with the matrices from `mats`
// (bf16, each stage in its route's layout at plan.d_off, in bf16 units) and
// the twiddles from `tw` (fp32, at plan.w_off).  The block has at least one
// warp.
//
// kTile = false (kernel A, the in-place row pass): the CTA's T transforms
// are T consecutive rows of n elements at in_re/in_im (row `lane` at
// lane * n), stored in place at out_re/out_im: bf16 rows whose starts are
// 16-byte aligned move in 16-byte loads and stores; others through the
// functors
//   load(q, idx, re, im): element q of the rows and its operand index,
//   store(k, lane, re, im): output bin k of row `lane`,
// which the fp32 kernels keep (moving them onto the row pointers slowed the
// 16384-point bf16x3 kernel on the H100).  The last stage's outputs are
// staged in the operand buffer as S, [re | im][lane][k], then stored in
// that order.
//
// kTile = true (kernels B and C, four_step_tc.cuh): the input and output
// lie as `map` says.  A kTileRows input loads as above (through the
// functor for fp32 rows); a column tile loads in the widest access its
// alignment allows, T (or 2T pair) elements per row i.  Each output passes
// through epi(k, lane, re, im) in fp32, after the bf16 state's rounding and
// before the one rounding to S (kernel B's four-step twiddle), and is
// staged as [re | im][k][lane] (kTileCols) or [k][lane][re, im]
// (kTilePairs), so that the stores are runs of T (2T) elements per bin k.
// The kTile = false code is kept as it was written before the tile mode:
// the one-CTA kernels sit at the 128-register cap, and ptxas's spills move
// with rewrites that compute the same values.
template <typename S, int BT, int kEngine, class Load, class Store,
          bool kTile = false, class Epi = NoEpilogue>
__device__ void run_fft_tc(__nv_bfloat16* op, int n, int T,
                           const StagePlan& plan,
                           const __nv_bfloat16* __restrict__ mats,
                           const float* __restrict__ tw, const Load& load,
                           const Store& store, const S* __restrict__ in_re,
                           const S* __restrict__ in_im, S* __restrict__ out_re,
                           S* __restrict__ out_im, const TileMap& map = {},
                           const Epi& epi = Epi{}) {
  constexpr int VEC = 16 / sizeof(S);
  const int elems = n * T;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  bool vec = false;
  if constexpr (sizeof(S) == 2 && kTile)
    vec = n % VEC == 0 && ((reinterpret_cast<uintptr_t>(in_re) |
                            reinterpret_cast<uintptr_t>(in_im)) & 15) == 0;
  else if constexpr (sizeof(S) == 2)
    vec = n % VEC == 0 &&
          ((reinterpret_cast<uintptr_t>(in_re) |
            reinterpret_cast<uintptr_t>(in_im) |
            reinterpret_cast<uintptr_t>(out_re) |
            reinterpret_cast<uintptr_t>(out_im)) & 15) == 0;

  Swizzle sw = stage_swizzle(elems / plan.radix[0]);
  // Element i of row lane goes to operand index i*T + lane.
  auto put_input = [&](int idx, float re, float im) {
    if constexpr (kEngine != kEngStacked) {
      if (plan.round_input) {
        re = bf16_round(re);
        im = bf16_round(im);
      }
    }
    put_stage_operand<BT, kEngine>(op, elems, swz(idx, sw), re, im,
                                   plan.flags[0]);
  };
  if (kTile && map.in_layout != kTileRows) {
    if constexpr (kTile) {
      if (map.in_layout == kTileCols)
        load_tile<S, false>(in_re, in_im, map.in_pitch, T, elems, put_input);
      else
        load_tile<S, true>(in_re, in_im, map.in_pitch, T, elems, put_input);
    }
  } else if (vec) {
    for (int q = tid * VEC; q < elems; q += nthr * VEC) {
      float re[VEC], im[VEC];
      ld_vec<S>(in_re + q, re);
      ld_vec<S>(in_im + q, im);
      const int lane = q / n, i = q - lane * n;
#pragma unroll
      for (int k = 0; k < VEC; ++k) put_input((i + k) * T + lane, re[k], im[k]);
    }
  } else {
    for (int q = tid; q < elems; q += nthr) {
      int idx;
      float re, im;
      load(q, idx, re, im);
      put_input(idx, re, im);
    }
  }
  __syncthreads();

  S* out = reinterpret_cast<S*>(op);
  int K = 1, M = n;
  for (int s = 0; s < plan.n_stages; ++s) {
    const int R = plan.radix[s];
    const int lg_r = __ffs(R) - 1;
    M /= R;
    const int nt = elems / R;
    const __nv_bfloat16* d = mats + plan.d_off[s];
    const bool fold = kEngine != kEngStacked && folded(plan.mode[s]);
    const bool mult3 =
        kEngine == kEngKnobs && (plan.flags[s] & kFlagMult3) != 0;
    const bool mma = mma_route(plan.mode[s], R);
    const int blk = (mma && BT == 1 && plan.a_terms[s] == 1 && !mult3 &&
                     kEngine != kEngPlanar)
                        ? mma_block(R >> 3, nt)
                        : 0;
    const int slice_stride = R * R * (mult3 ? 4 : 2);
    const int ts = (fold ? K : 1) * slice_stride;
    const int slice_elems = fold ? M * T : 0;
    float o_re[kMaxEpt], o_im[kMaxEpt];
    int vv;
    if constexpr (BT == 1) {
      if (plan.a_terms[s] == 2)
        vv = stage_products<2, 1, kEngine>(op, elems, nt, R, lg_r, sw, mma, blk, mult3,
                                      d, ts, slice_elems, slice_stride, o_re,
                                      o_im);
      else
        vv = stage_products<1, 1, kEngine>(op, elems, nt, R, lg_r, sw, mma, blk, mult3,
                                      d, ts, slice_elems, slice_stride, o_re,
                                      o_im);
    } else {
      vv = stage_products<BT, BT, kEngine>(op, elems, nt, R, lg_r, sw, mma, blk, mult3,
                                      d, ts, slice_elems, slice_stride, o_re,
                                      o_im);
    }
    __syncthreads();  // every operand read before it is overwritten
    const bool round_state = kEngine != kEngStacked && plan.bf16_state;

    if (s + 1 == plan.n_stages) {
      // M == 1 here: g = kk*T + lane, natural bin k = r_out*K + kk.
      for_outputs(mma, blk, vv, elems, nt, R, lg_r, [&](int e, int r_out, int g) {
        float re = o_re[e], im = o_im[e];
        if (round_state) {
          re = bf16_round(re);
          im = bf16_round(im);
        }
        const int kk = g / T;
        if constexpr (kTile) {
          const int lane = g - kk * T, k = r_out * K + kk;
          epi(k, lane, re, im);
          const int at = k * T + lane;
          if (map.out_layout == kTilePairs) {
            out[2 * at] = from_float<S>(re);
            out[2 * at + 1] = from_float<S>(im);
          } else {
            out[at] = from_float<S>(re);
            out[elems + at] = from_float<S>(im);
          }
        } else {
          const int at = (g - kk * T) * n + r_out * K + kk;
          out[at] = from_float<S>(re);
          out[elems + at] = from_float<S>(im);
        }
      });
    } else {
      const int R2 = plan.radix[s + 1], K2 = K * R, M2 = M / R2;
      const float* w = tw + plan.w_off[s + 1];
      const int flags2 = plan.flags[s + 1];
      const Swizzle sw2 = stage_swizzle(elems / R2);
      // A folded next stage takes the untwiddled state.
      const bool twiddle =
          kEngine == kEngStacked || !folded(plan.mode[s + 1]);
      const bool round_tw =
          kEngine != kEngStacked && (flags2 & kFlagRoundTw) != 0;
      for_outputs(mma, blk, vv, elems, nt, R, lg_r, [&](int e, int r_out, int g) {
        float re = o_re[e], im = o_im[e];
        if (round_state) {
          re = bf16_round(re);
          im = bf16_round(im);
        }
        const int gm = g / T, lane = g - gm * T;
        const int kk = gm / M, mm = gm - kk * M;
        const int kk2 = r_out * K + kk;
        const int r2 = mm / M2, mm2 = mm - r2 * M2;
        float z_re = re, z_im = im;
        if (twiddle) {
          cmul(re, im, __ldg(w + r2 * K2 + kk2),
               __ldg(w + (R2 + r2) * K2 + kk2), z_re, z_im);
          if (round_tw) {
            z_re = bf16_round(z_re);
            z_im = bf16_round(z_im);
          }
        }
        put_stage_operand<BT, kEngine>(
            op, elems, swz(((r2 * K2 + kk2) * M2 + mm2) * T + lane, sw2),
            z_re, z_im, flags2);
      });
      sw = sw2;
    }
    __syncthreads();
    K *= R;
  }

  if constexpr (kTile) {
    if (map.out_layout == kTilePairs)
      store_tile<S, true>(out, out_re, out_im, map.out_pitch, T, elems);
    else
      store_tile<S, false>(out, out_re, out_im, map.out_pitch, T, elems);
  } else if (vec) {
    for (int q = tid * VEC; q < elems; q += nthr * VEC) {
      *reinterpret_cast<uint4*>(out_re + q) =
          *reinterpret_cast<const uint4*>(out + q);
      *reinterpret_cast<uint4*>(out_im + q) =
          *reinterpret_cast<const uint4*>(out + elems + q);
    }
  } else {
    for (int q = tid; q < elems; q += nthr) {
      const int lane = q / n;
      store(q - lane * n, lane, to_float(out[q]), to_float(out[elems + q]));
    }
  }
}

// Threads of a tensor-core engine CTA holding `elems` elements: one per
// element up to kThreads, and at least one warp.
inline int tc_threads(int elems) {
  return elems < 32 ? 32 : (elems < kThreads ? elems : kThreads);
}

}  // namespace tfft
