// Cluster mode of the tensor-core stage engine (fft_mma.cuh): one transform
// of n elements (T = 1) on a thread-block cluster of C = 2, 4 or 8 CTAs, for
// the passes one CTA cannot hold (n > 16384, or bf16x6 with mult3's third
// operand plane at n = 16384).  Kernel A's twin and the row passes' twin
// (K3, K4's row pass, kernel C and K6; cluster_tc.cuh) run it.
//
// Column-block ownership.  A stage of radix R reads operand index r*nt + g
// (nt = n/R columns g, R rows r) and computes output (r_out, g) from column
// g alone.  Each CTA owns a block of ntl = nt/C columns of every stage:
// rank g / ntl holds index r*nt + g at local index r*ntl + (g mod ntl),
// under stage_swizzle(ntl).  So a CTA's buffer is exactly the [R][ntl]
// operand that one-CTA run_fft_tc takes with elems = E = n/C and nt = ntl,
// and every read of a stage's products is local: the mma route (ldmatrix,
// the warp blocking, mma_add) and the vector route (folded stages, radix
// < 8) run unchanged on it (stage_products).  The next stage's index
// (r2*K2 + kk2)*M2 + mm2 is r2*nt2 + g2, so each output is written once, to
// rank g2 / ntl2, through distributed shared memory: the writes between
// stages are the cluster's only exchange.
//
// Tables.  The mma route's table is shared by every column.  A folded
// stage's output column g reads slice g / M; the CTA's first column rank*ntl
// lies at a slice boundary (ntl >= M) or inside one slice (ntl < M), both
// powers of two, so its slices start at slice (rank*ntl) / M and the local
// column gl reads slice gl / M after it, as one CTA's do.  The twiddle of the
// next stage and the output bins use the global column rank*ntl + gl.
//
// Each output is the same sum, in the same chunk order, with the same
// twiddle, split and rounding as in one-CTA run_fft_tc; a row one CTA holds
// gives one CTA's output bit for bit on any cluster.
//
// Per stage: local reads; a cluster barrier (no peer still reads the buffer
// about to be written); the remote writes; a cluster barrier.  Stage 0's
// owned inputs are R0 runs of ntl0 consecutive elements, loaded from global
// memory straight into the CTA's own buffer; the last stage's outputs are,
// per r_out, ntl consecutive bins, staged in the (by then free) local
// operand and stored from there in runs (or, strided, one by one: kernel C's
// transposed store, K6's interleaved pairs).
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
// elements: every stage's nt = n / R columns split into `cluster` blocks.
inline bool cluster_tc_ok(int n, int cluster, const StagePlan& plan) {
  for (int s = 0; s < plan.n_stages; ++s)
    if (static_cast<long long>(plan.radix[s]) * cluster > n) return false;
  return true;
}

// run_fft_tc on this CTA's column blocks of a cluster (cg::this_cluster()):
// the same stage sequence, knobs and roundings, with the matrices from
// `mats` (bf16, at plan.d_off) and the twiddles from `tw` (fp32, at
// plan.w_off).  in_re/in_im: the transform's n elements, consecutive; the
// output as `out` says.  The engine is kEngKnobs or kEngPlanar
// (cluster_engine): a knob-free stacked pass takes kEngKnobs's per-stage
// tests with the same arithmetic.
template <typename S, int BT, int kEngine>
__device__ void run_fft_tc_cluster(__nv_bfloat16* op, int n,
                                   const StagePlan& plan,
                                   const __nv_bfloat16* __restrict__ mats,
                                   const float* __restrict__ tw,
                                   const S* __restrict__ in_re,
                                   const S* __restrict__ in_im,
                                   S* __restrict__ out_re,
                                   S* __restrict__ out_im,
                                   const ClusterOut& out) {
  static_assert(kEngine != kEngStacked, "a cluster runs cluster_engine()");
  constexpr int VEC = 16 / sizeof(S);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int E = n / C;
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
  if (ntl % VEC == 0 && ((reinterpret_cast<uintptr_t>(in_re) |
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
    const int slice_elems = fold ? M : 0;
    // A folded stage's local column gl reads slice (rank*ntl)/M + gl/M.
    const __nv_bfloat16* d =
        mats + plan.d_off[s] +
        (fold ? static_cast<long long>((rank * ntl) / M) * slice_stride : 0);
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
      // M == 1 here: output (r_out, gl) is bin r_out*K + rank*ntl + gl,
      // staged at r_out*ntl + gl.
      for_outputs(mma, blk, vv, E, ntl, R, lg_r, [&](int e, int r_out, int g) {
        float re = o_re[e], im = o_im[e];
        if (round_state) {
          re = bf16_round(re);
          im = bf16_round(im);
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
        const int g = g0 + gl;
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
        const int g2 = kk2 * M2 + mm2;
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
  if (out.pitch == 1 && !out.pairs && ntl % VEC == 0 &&
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
