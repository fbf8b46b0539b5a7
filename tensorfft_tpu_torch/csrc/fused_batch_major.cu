// K3: whole-transform FFT of batch-major (B, N) rows, a tile of T adjacent
// rows per CTA.  Replaces tensorfft_tpu/ops/four_step_pallas.py
// :fused_fft_batch_major (pallas_call at :768), which reads a (row_tile, N)
// block, transposes it in VMEM so lanes run across transforms, runs every
// stage and transposes back.  Here that is kernel C's in-place row pass
// (four_step_passes.cuh, kTransposed = false) over a (1, B, N) view: each
// CTA reads its T rows contiguously and writes them transposed into the
// shared-memory operand ([i][lane], lanes across transforms), runs the
// plan's stage engine (stacked or planar) with the plan's first_dot, and
// stores each row's bins in place.
//
// What bounds it on the H100: as kernel A, the tensor-core engine
// (fft_mma.cuh, through row_pass_tc.cuh): bf16 mma.sync products on the
// shared-matrix stages, the bf16 per-slice table stream on folded ones.
// The tile lets one CTA hold T rows, so a short transform (N = 512 takes
// T = 32) keeps 512 threads busy where kernel A gives each row its own
// CTA; the last stage's outputs are staged in shared memory and leave as
// contiguous runs of each row.  Each output is computed as kernel A
// computes it, so the two agree bit for bit.
#include "in_place_row.cuh"

// Returns a cudaError_t code, or kErrClusterUnschedulable.  T: rows per
// CTA, dividing batch, with n*T <= 16384; or, for a row longer than one CTA
// holds, T = 1 and `cluster` (2, 4 or 8) CTAs per row.  mats: the bf16
// matrices, on one CTA and on a cluster (in_place_row_pass).
extern "C" int tfft_fused_batch_major(const void* in_re, const void* in_im,
                                      void* out_re, void* out_im, int dtype,
                                      int data_terms, long long batch, int n,
                                      int T, int cluster, const void* tables,
                                      const void* mats, const long long* meta,
                                      void* stream) {
  if (batch < 1 || batch > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  return tfft::in_place_row_pass(in_re, in_im, out_re, out_im, dtype,
                                 data_terms, 1, static_cast<int>(batch), n, T,
                                 cluster, tables, mats, meta, stream);
}
