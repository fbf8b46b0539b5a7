// Cluster mode of the tensor-core stage engine (fft_mma.cuh): one transform
// of n elements, or a column tile of T adjacent transforms, on a
// thread-block cluster of C = 2, 4 or 8 CTAs, for the passes one CTA cannot
// hold (n*T > 16384, or bf16x6 with mult3's third operand plane at n =
// 16384).  Kernel A's twin and the row passes' twin (K3, K4's row pass,
// kernel C and K6; cluster_tc.cuh) run it on one transform (T = 1), kernel
// B's twin (K2c, K4's column pass, K5; cluster_col_tc.cuh) on a column tile.
//
// Column-block ownership.  A stage of radix R reads operand index r*nt + g
// (nt = n*T/R columns g, R rows r) and computes output (r_out, g) from
// column g alone.  Each CTA owns a block of ntl = nt/C columns of every
// stage: rank g / ntl holds index r*nt + g at local index r*ntl + (g mod
// ntl), under stage_swizzle(ntl).  So a CTA's buffer is exactly the
// [R][ntl] operand that one-CTA run_fft_tc takes with elems = E = n*T/C and
// nt = ntl, and every read of a stage's products is local: the mma route
// (ldmatrix, the warp blocking, mma_add) and the vector route (folded
// stages, radix < 8) run unchanged on it (stage_products).  The next stage's
// index is r2*nt2 + g2, so each output is written once, to rank g2 / ntl2,
// through distributed shared memory: the writes between stages are the
// cluster's only exchange.
//
// Column tiles (kTile).  As in one-CTA tile mode, element i of transform
// `lane` sits at operand index i*T + lane, so a stage's column is g =
// gm*T + lane with gm the column of one transform (M columns per slice,
// K sub-transforms): the lanes are extra innermost columns, and each rank
// owns ntl consecutive ones.  The twiddle, a folded stage's slice and the
// output bin read gm = g / T; with T = 1 (kTile = false) g is gm.
//
// Tables.  The mma route's table is shared by every column.  A folded
// stage's output column g reads slice g / (M*T); the CTA's first column
// rank*ntl lies at a slice boundary (ntl >= M*T) or inside one slice (ntl <
// M*T), both powers of two, so its slices start at slice (rank*ntl) /
// (M*T) and the local column gl reads slice gl / (M*T) after it, as one
// CTA's do.  The twiddle of the next stage and the output bins use the
// global column rank*ntl + gl.
//
// Each output is the same sum, in the same chunk order, with the same
// twiddle, split and rounding as in one-CTA run_fft_tc; a row or column
// tile one CTA holds gives one CTA's output bit for bit on any cluster.
//
// Per stage: local reads; a cluster barrier (no peer still reads the buffer
// about to be written); the remote writes; a cluster barrier.  Stage 0's
// owned inputs are R0 runs of ntl0 consecutive columns, loaded from global
// memory straight into the CTA's own buffer (a column tile: T contiguous
// elements per row, in the widest access the pointers and pitch allow); the
// last stage's outputs are, per r_out, ntl consecutive columns, staged in
// the (by then free) local operand and stored from there in runs (a column
// tile: the fp32 epilogue, kernel B's four-step twiddle, before the one
// rounding to storage, and T contiguous elements per bin; strided, one by
// one: kernel C's transposed store, K6's interleaved pairs).
#pragma once

#include "fft_mma.cuh"

namespace tfft {

// How run_fft_tc_cluster stores bin k: at out_re[k * pitch] and
// out_im[k * pitch], or with `pairs` at out_re[2 * k * pitch + {0, 1}].
struct ClusterOut {
  long long pitch;
  bool pairs;
};

// Whether a cluster of `cluster` CTAs can run the plan's stages on n
// elements (a column tile: n*T): every stage's nt = n / R columns split
// into `cluster` blocks.
inline bool cluster_tc_ok(int n, int cluster, const StagePlan& plan) {
  for (int s = 0; s < plan.n_stages; ++s)
    if (static_cast<long long>(plan.radix[s]) * cluster > n) return false;
  return true;
}

// This rank's stage-0 block of a column tile in accesses of B bytes: local
// index q = r*ntl + gl holds element (r*rows + gm, lane) of the tile, where
// col0 + gl = gm*T + lane (T = 2^lg_t, ntl = 2^lg_ntl); a kTileCols tile
// reads re and im at i*pitch + lane, a kTilePairs one the (re, im) pair at
// 2*(i*pitch + lane) of re.  An access stays inside one run of min(T, ntl)
// elements.
template <typename S, int B, bool kPairs, class Put>
__device__ __forceinline__ void load_cluster_cols(const S* re, const S* im,
                                                  long long pitch, int lg_t,
                                                  int rows, int col0,
                                                  int lg_ntl, int E,
                                                  const Put& put) {
  constexpr int P = kPairs ? 2 : 1;
  constexpr int V = B / sizeof(S);  // scalars per access
  const long long row = P * pitch;
  const int ntl_mask = (1 << lg_ntl) - 1, t_mask = (1 << lg_t) - 1;
  for (int s = threadIdx.x * V; s < P * E; s += blockDim.x * V) {
    const int q = s / P;
    const int g = col0 + (q & ntl_mask);
    const long long at =
        static_cast<long long>((q >> lg_ntl) * rows + (g >> lg_t)) * row +
        P * (g & t_mask);
    float x[V];
    ld_floats<S, B>(re + at, x);
    if constexpr (kPairs) {
#pragma unroll
      for (int k = 0; k < V / 2; ++k) put(q + k, x[2 * k], x[2 * k + 1]);
    } else {
      float y[V];
      ld_floats<S, B>(im + at, y);
#pragma unroll
      for (int k = 0; k < V; ++k) put(q + k, x[k], y[k]);
    }
  }
}

// load_cluster_cols at the widest access the tile's alignment allows; a
// pair tile whose pairs do not align is read element by element.
template <typename S, bool kPairs, class Put>
__device__ __forceinline__ void load_cluster_tile(const S* re, const S* im,
                                                  long long pitch, int lg_t,
                                                  int rows, int col0,
                                                  int lg_ntl, int E,
                                                  const Put& put) {
  constexpr int kLeast = (kPairs ? 2 : 1) * static_cast<int>(sizeof(S));
  const uintptr_t at = reinterpret_cast<uintptr_t>(re) |
                       (kPairs ? 0 : reinterpret_cast<uintptr_t>(im));
  const int run = 1 << (lg_t < lg_ntl ? lg_t : lg_ntl);
  const int b = tile_access(at, (kPairs ? 2 : 1) * pitch * sizeof(S),
                            run * kLeast, kLeast);
#define TFFT_LOAD_CLUSTER(B)                                                \
  if constexpr (B >= kLeast) {                                              \
    if (b == B)                                                             \
      return load_cluster_cols<S, B, kPairs>(re, im, pitch, lg_t, rows,     \
                                             col0, lg_ntl, E, put);         \
  }
  TFFT_LOAD_CLUSTER(16)
  TFFT_LOAD_CLUSTER(8)
  TFFT_LOAD_CLUSTER(4)
  TFFT_LOAD_CLUSTER(2)
#undef TFFT_LOAD_CLUSTER
  for (int q = threadIdx.x; q < E; q += blockDim.x) {
    const int g = col0 + (q & ((1 << lg_ntl) - 1));
    const long long at2 =
        2 * (static_cast<long long>((q >> lg_ntl) * rows + (g >> lg_t)) *
                 pitch +
             (g & ((1 << lg_t) - 1)));
    put(q, to_float(re[at2]), to_float(re[at2 + 1]));
  }
}

// The staged [re | im][r_out][gl] of a column tile to bin k = r_out*K + gm
// of column lane, at k*pitch + lane (col0 + gl = gm*T + lane), in accesses
// of B bytes, each inside one run of min(T, ntl) elements.
template <typename S, int B>
__device__ __forceinline__ void store_cluster_cols(const S* st, S* re, S* im,
                                                   long long pitch, int lg_t,
                                                   int K, int col0,
                                                   int lg_ntl, int E) {
  using Vt = typename Bytes<B>::T;
  constexpr int V = B / sizeof(S);
  const int ntl_mask = (1 << lg_ntl) - 1, t_mask = (1 << lg_t) - 1;
  for (int q = threadIdx.x * V; q < E; q += blockDim.x * V) {
    const int g = col0 + (q & ntl_mask);
    const long long at =
        static_cast<long long>((q >> lg_ntl) * K + (g >> lg_t)) * pitch +
        (g & t_mask);
    *reinterpret_cast<Vt*>(re + at) = *reinterpret_cast<const Vt*>(st + q);
    *reinterpret_cast<Vt*>(im + at) =
        *reinterpret_cast<const Vt*>(st + E + q);
  }
}

// store_cluster_cols at the widest access the tile's alignment allows.
template <typename S>
__device__ __forceinline__ void store_cluster_tile(const S* st, S* re, S* im,
                                                   long long pitch, int lg_t,
                                                   int K, int col0,
                                                   int lg_ntl, int E) {
  constexpr int kE = static_cast<int>(sizeof(S));
  const uintptr_t at = reinterpret_cast<uintptr_t>(re) |
                       reinterpret_cast<uintptr_t>(im) |
                       static_cast<uintptr_t>(E) * kE;
  const int run = 1 << (lg_t < lg_ntl ? lg_t : lg_ntl);
  const int b = tile_access(at, pitch * kE, run * kE, kE);
#define TFFT_STORE_CLUSTER(B)                                               \
  if constexpr (B >= kE) {                                                  \
    if (b == B)                                                             \
      return store_cluster_cols<S, B>(st, re, im, pitch, lg_t, K, col0,     \
                                      lg_ntl, E);                           \
  }
  TFFT_STORE_CLUSTER(16)
  TFFT_STORE_CLUSTER(8)
  TFFT_STORE_CLUSTER(4)
  TFFT_STORE_CLUSTER(2)
#undef TFFT_STORE_CLUSTER
}

// run_fft_tc on this CTA's column blocks of a cluster (cg::this_cluster()):
// the same stage sequence, knobs and roundings, with the matrices from
// `mats` (bf16, at plan.d_off) and the twiddles from `tw` (fp32, at
// plan.w_off).  The engine is kEngKnobs or kEngPlanar: a knob-free stacked
// pass takes kEngKnobs's per-stage tests with the same arithmetic, so the
// build carries two cluster kernels per storage type and kernel, not three.
//   kTile = false: one transform, in_re/in_im its n elements, consecutive;
//     the output as `out` says (`map`, T and `epi` unused).
//   kTile = true: a column tile of T transforms (a power of two) laid out
//     as `map` says (input kTileCols or kTilePairs, output kTileCols; `out`
//     unused); each output passes through epi(k, lane, re, im) in fp32,
//     after the bf16 state's rounding and before the one rounding to S, as
//     in one-CTA tile mode.
template <typename S, int BT, int kEngine, bool kTile = false,
          class Epi = NoEpilogue>
__device__ void run_fft_tc_cluster(__nv_bfloat16* op, int n,
                                   const StagePlan& plan,
                                   const __nv_bfloat16* __restrict__ mats,
                                   const float* __restrict__ tw,
                                   const S* __restrict__ in_re,
                                   const S* __restrict__ in_im,
                                   S* __restrict__ out_re,
                                   S* __restrict__ out_im,
                                   const ClusterOut& out, int T = 1,
                                   const TileMap& map = {},
                                   const Epi& epi = Epi{}) {
  static_assert(kEngine != kEngStacked, "a cluster runs kEngKnobs");
  constexpr int VEC = 16 / sizeof(S);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // Transforms side by side: column g of a stage is gm*lanes + lane.
  const int lanes = kTile ? T : 1;
  const int lg_t = kTile ? __ffs(T) - 1 : 0;
  const int E = n * lanes / C;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  // Each rank's operand buffer, resolved once.
  __shared__ __nv_bfloat16* peer[kMaxCluster];
  if (tid < C) peer[tid] = cluster.map_shared_rank(op, tid);

  // Stage 0: local index q = r*ntl + gl holds input r*nt + rank*ntl + gl.
  int ntl = E / plan.radix[0];
  int lg_ntl = __ffs(ntl) - 1;
  Swizzle sw = stage_swizzle(ntl);
  auto put_input = [&](int idx, float re, float im) {
    if (plan.round_input) {
      re = bf16_round(re);
      im = bf16_round(im);
    }
    put_stage_operand<BT, kEngine>(op, E, swz(idx, sw), re, im, plan.flags[0]);
  };
  const int col0 = rank * ntl;
  const int nt0 = n / plan.radix[0];
  if constexpr (kTile) {
    if (map.in_layout == kTilePairs)
      load_cluster_tile<S, true>(in_re, in_im, map.in_pitch, lg_t, nt0, col0,
                                 lg_ntl, E, put_input);
    else
      load_cluster_tile<S, false>(in_re, in_im, map.in_pitch, lg_t, nt0,
                                  col0, lg_ntl, E, put_input);
  } else if (ntl % VEC == 0 && ((reinterpret_cast<uintptr_t>(in_re) |
                                 reinterpret_cast<uintptr_t>(in_im)) & 15) == 0) {
    for (int q = tid * VEC; q < E; q += nthr * VEC) {
      const int at = (q >> lg_ntl) * nt0 + col0 + (q & (ntl - 1));
      float re[VEC], im[VEC];
      ld_vec<S>(in_re + at, re);
      ld_vec<S>(in_im + at, im);
#pragma unroll
      for (int k = 0; k < VEC; ++k) put_input(q + k, re[k], im[k]);
    }
  } else {
    for (int q = tid; q < E; q += nthr) {
      const int at = (q >> lg_ntl) * nt0 + col0 + (q & (ntl - 1));
      put_input(q, to_float(in_re[at]), to_float(in_im[at]));
    }
  }
  __syncthreads();

  S* st = reinterpret_cast<S*>(op);
  int K = 1, M = n;
  for (int s = 0; s < plan.n_stages; ++s) {
    const int R = plan.radix[s];
    const int lg_r = __ffs(R) - 1;
    M /= R;
    ntl = E / R;
    const bool fold = folded(plan.mode[s]);
    const bool mult3 =
        kEngine == kEngKnobs && (plan.flags[s] & kFlagMult3) != 0;
    const bool mma = mma_route(plan.mode[s], R);
    const int blk = (mma && BT == 1 && plan.a_terms[s] == 1 && !mult3 &&
                     kEngine != kEngPlanar)
                        ? mma_block(R >> 3, ntl)
                        : 0;
    const int slice_stride = R * R * (mult3 ? 4 : 2);
    const int ts = (fold ? K : 1) * slice_stride;
    const int slice_elems = fold ? M * lanes : 0;
    // A folded stage's local column gl reads slice
    // (rank*ntl)/(M*lanes) + gl/(M*lanes).
    const __nv_bfloat16* d =
        mats + plan.d_off[s] +
        (fold ? static_cast<long long>((rank * ntl) / (M * lanes)) *
                    slice_stride
              : 0);
    float o_re[kMaxEpt], o_im[kMaxEpt];
    int vv;
    if constexpr (BT == 1) {
      if (plan.a_terms[s] == 2)
        vv = stage_products<2, 1, kEngine>(op, E, ntl, R, lg_r, sw, mma, blk,
                                           mult3, d, ts, slice_elems,
                                           slice_stride, o_re, o_im);
      else
        vv = stage_products<1, 1, kEngine>(op, E, ntl, R, lg_r, sw, mma, blk,
                                           mult3, d, ts, slice_elems,
                                           slice_stride, o_re, o_im);
    } else {
      vv = stage_products<BT, BT, kEngine>(op, E, ntl, R, lg_r, sw, mma, blk,
                                           mult3, d, ts, slice_elems,
                                           slice_stride, o_re, o_im);
    }
    const bool round_state = plan.bf16_state;

    if (s + 1 == plan.n_stages) {
      __syncthreads();  // every local operand read before it is overwritten
      // M == 1 here: output (r_out, gl) is bin r_out*K + gm of column lane,
      // rank*ntl + gl = gm*lanes + lane, staged at r_out*ntl + gl.
      const int g0 = rank * ntl;
      for_outputs(mma, blk, vv, E, ntl, R, lg_r, [&](int e, int r_out, int g) {
        float re = o_re[e], im = o_im[e];
        if (round_state) {
          re = bf16_round(re);
          im = bf16_round(im);
        }
        if constexpr (kTile) {
          const int gt = g0 + g;
          epi(r_out * K + (gt >> lg_t), gt & (lanes - 1), re, im);
        }
        const int at = r_out * ntl + g;
        st[at] = from_float<S>(re);
        st[E + at] = from_float<S>(im);
      });
    } else {
      // No peer still reads the buffer this stage's outputs go to.
      cluster.sync();
      const int R2 = plan.radix[s + 1], K2 = K * R, M2 = M / R2;
      const int ntl2 = E / R2, lg2 = __ffs(ntl2) - 1;
      const float* w = tw + plan.w_off[s + 1];
      const int flags2 = plan.flags[s + 1];
      const Swizzle sw2 = stage_swizzle(ntl2);
      // A folded next stage takes the untwiddled state.
      const bool twiddle = !folded(plan.mode[s + 1]);
      const bool round_tw = (flags2 & kFlagRoundTw) != 0;
      const int g0 = rank * ntl;
      for_outputs(mma, blk, vv, E, ntl, R, lg_r, [&](int e, int r_out, int gl) {
        float re = o_re[e], im = o_im[e];
        if (round_state) {
          re = bf16_round(re);
          im = bf16_round(im);
        }
        const int gt = g0 + gl, g = gt >> lg_t;
        const int kk = g / M, mm = g - kk * M;
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
        // Index r2*nt2 + g2 of the next stage, on rank g2 / ntl2.
        const int g2 = ((kk2 * M2 + mm2) << lg_t) + (gt & (lanes - 1));
        put_stage_operand<BT, kEngine>(
            peer[g2 >> lg2], E, swz(r2 * ntl2 + (g2 & (ntl2 - 1)), sw2), z_re,
            z_im, flags2);
      });
      sw = sw2;
      cluster.sync();  // every write landed before the next stage reads
    }
    K *= R;
  }
  __syncthreads();

  // The staged [re | im][r_out][gl] to bins r_out*nt + rank*ntl + gl.
  const int nt = ntl * C, col = rank * ntl;
  lg_ntl = __ffs(ntl) - 1;
  if constexpr (kTile) {
    store_cluster_tile<S>(st, out_re, out_im, map.out_pitch, lg_t,
                          n / plan.radix[plan.n_stages - 1], col, lg_ntl, E);
  } else if (out.pitch == 1 && !out.pairs && ntl % VEC == 0 &&
             ((reinterpret_cast<uintptr_t>(out_re) |
               reinterpret_cast<uintptr_t>(out_im)) & 15) == 0) {
    for (int q = tid * VEC; q < E; q += nthr * VEC) {
      const int at = (q >> lg_ntl) * nt + col + (q & (ntl - 1));
      *reinterpret_cast<uint4*>(out_re + at) =
          *reinterpret_cast<const uint4*>(st + q);
      *reinterpret_cast<uint4*>(out_im + at) =
          *reinterpret_cast<const uint4*>(st + E + q);
    }
  } else {
    for (int q = tid; q < E; q += nthr) {
      const long long at =
          ((q >> lg_ntl) * nt + col + (q & (ntl - 1))) * out.pitch;
      if (out.pairs) {
        out_re[2 * at] = st[q];
        out_re[2 * at + 1] = st[E + q];
      } else {
        out_re[at] = st[q];
        out_im[at] = st[E + q];
      }
    }
  }
}

}  // namespace tfft
