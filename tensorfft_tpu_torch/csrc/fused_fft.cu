// Kernel A: whole-transform FFT of batch-major (B, N) rows, one CTA per row.
//
// Replaces the TPU kernel K1, tensorfft_tpu/ops/fused_pallas.py:fused_fft
// (pallas_call at :971, body fused_fft_kernel_body / stage_loop), under the
// stacked engine with every numeric knob (grouped, mult3, bf16 state), its
// pretwiddle variant and, as K1b, the planar and planar_vpu engines
// (stage_loop_planar; fft_stages.cuh).  It also replaces K1a, the gridslice
// pallas_call at :923 (gridslice_kernel_body), which computes the stacked
// function and defers the last stage's K-way interleave to strided output
// stores: here the last stage already stores each output to its natural
// bin, so a gridslice plan runs this kernel unchanged.  The TPU
// kernel runs on transform-major (N, B) panels behind two XLA transposes;
// here a CTA reads its (B, N) row directly, so no transpose exists.
// A row longer than one CTA holds (N > 16384, or bf16x6 with mult3's third
// operand plane at N = 16384) takes a thread-block cluster of 2, 4 or 8
// CTAs, each holding a block of every stage's columns
// (row_cluster_kernel, cluster_tc.cuh, on run_fft_tc_cluster in
// fft_mma_cluster.cuh); the JAX package runs those lengths (its tuner's
// single-pass challengers at N = 32768 and 65536) in one VMEM panel.
//
// What bounds it on the H100: a one-CTA row runs the
// tensor-core engine (fft_mma.cuh).  The shared-matrix stages are bf16
// mma.sync products (137 GFLOP at 16384 x 4096 is 0.14 ms at the 989
// TFLOP/s bf16 peak, under the 0.16 ms HBM floor of one read and one write
// per element), fed by ldmatrix from the swizzled operand and by A
// fragments through L1; a folded stage (grouped, folded planar) is bound by
// its per-slice table stream, bf16 and read once per CTA in contiguous
// runs: at (64, 256) 16.8 MB per term per row, from L2.  The whole
// transform stays in shared memory and the fp32 state in registers, as
// before.  The cluster twin runs the same products on its own CTA's column
// blocks (ldmatrix reads only local shared memory); the stage boundaries
// exchange the state through distributed shared memory.
#include "cluster_tc.cuh"
#include "fused_fft_tc.cuh"

namespace tfft {

// The pipelined kernel on a persistent grid of at most `sms` CTAs walking
// tiles of T consecutive rows (fused_fft_pipe.cu): bf16 storage, one data
// term, the knob-free stacked engine, one CTA a tile, n a power of two of
// at least 32, T a power of two with n * T <= kMaxCtaElems and 16-byte
// aligned planes; anything else returns cudaErrorInvalidValue.
int launch_fused_pipe(const void* in_re, const void* in_im, void* out_re,
                      void* out_im, long long batch, int n, int T, int sms,
                      const StagePlan& plan, const float* tables,
                      const __nv_bfloat16* mats, cudaStream_t stream);

// The same kernel with the strided landing, along the middle axis of
// (outer, n, inner) planes, inner contiguous: tiles of T lines of inner
// (T >= 8 dividing inner, so that a line's run is whole 16-byte chunks),
// each plane's tile landed by tensor copies; the output is the (outer *
// inner, n) rows the same kernel gives on the planes with that axis moved
// last.  Anything else returns cudaErrorInvalidValue.
int launch_fused_pipe_cols(const void* in_re, const void* in_im, void* out_re,
                           void* out_im, long long outer, int n,
                           long long inner, int T, int sms,
                           const StagePlan& plan, const float* tables,
                           const __nv_bfloat16* mats, cudaStream_t stream);

// One CTA per row (launch_fused_tc, compiled in fused_fft_tc{1,2,3}.cu), or
// a cluster of `cluster` CTAs per row (the row passes' twin with one row of
// n per batch, stored in place: launch_row_cluster_tc, compiled in
// cluster_tc{1,2,3}.cu), both on the tensor-core engine.
template <typename S, int BT>
int launch_fused(const void* in_re, const void* in_im, void* out_re,
                 void* out_im, long long batch, int n, int cluster,
                 const StagePlan& plan, const float* tables,
                 const __nv_bfloat16* mats, cudaStream_t stream) {
  if (cluster == 1)
    return launch_fused_tc<S, BT>(in_re, in_im, out_re, out_im, batch, n,
                                  plan, tables, mats, stream);
  return launch_row_cluster_tc<S, BT>(in_re, in_im, out_re, out_im, batch, 1,
                                      n, cluster, 0, plan, tables, mats,
                                      stream);
}

}  // namespace tfft

extern "C" const char* tfft_error_string(int err) {
  if (err == tfft::kErrClusterUnschedulable)
    return "no cluster of this kernel's CTAs fits the card "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns a cudaError_t code (0 on success), or kErrClusterUnschedulable.
// dtype: 0 bf16 (with 1 data term), 1 fp32 (with 2 or 3): the
// storage/operand pairs of the policies.  The engine is the plan's (meta's
// stage modes).  cluster: CTAs per row (1, 2, 4 or 8; cluster_ok).  The
// matrices come from the bf16 `mats` (meta's matrix offsets in bf16 units,
// each stage in its route's layout), the twiddles from the fp32 `tables`,
// on one CTA and on a cluster alike.  sms: 0 for one CTA (or cluster) per
// row, else the card's SMs, over which the pipelined kernel
// (launch_fused_pipe) walks the tiles of `tile` consecutive rows.
extern "C" int tfft_fused_fft(const void* in_re, const void* in_im,
                              void* out_re, void* out_im, int dtype,
                              int data_terms, long long batch, int n,
                              int cluster, int sms, int tile,
                              const void* tables, const void* mats,
                              const long long* meta, void* stream) {
  using namespace tfft;
  StagePlan plan;
  if (!read_plan(meta, &plan) || !cluster_ok(n, 1, cluster) || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* t = static_cast<const float*>(tables);
  const __nv_bfloat16* m = static_cast<const __nv_bfloat16*>(mats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sms != 0) {
    if (dtype != 0 || data_terms != 1 || cluster != 1 || tile < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_fused_pipe(in_re, in_im, out_re, out_im, batch, n, tile,
                             sms, plan, t, m, s);
  }
#define TFFT_FUSED(S, BT)                                              \
  return launch_fused<S, BT>(in_re, in_im, out_re, out_im, batch, n,   \
                             cluster, plan, t, m, s)
  if (dtype == 0 && data_terms == 1) TFFT_FUSED(__nv_bfloat16, 1);
  if (dtype == 1 && data_terms == 2) TFFT_FUSED(float, 2);
  if (dtype == 1 && data_terms == 3) TFFT_FUSED(float, 3);
#undef TFFT_FUSED
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel A along the middle axis of bf16 (outer, n, inner) planes
// (launch_fused_pipe_cols) into (outer * inner, n) rows: bf16 storage with
// one data term (dtype 0, data_terms 1), the pipelined kernel over `sms`
// CTAs, on tiles of `tile` lines.  Returns a cudaError_t code.
extern "C" int tfft_fused_fft_cols(const void* in_re, const void* in_im,
                                   void* out_re, void* out_im, int dtype,
                                   int data_terms, long long outer, int n,
                                   long long inner, int sms, int tile,
                                   const void* tables, const void* mats,
                                   const long long* meta, void* stream) {
  using namespace tfft;
  StagePlan plan;
  if (!read_plan(meta, &plan) || dtype != 0 || data_terms != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_fused_pipe_cols(in_re, in_im, out_re, out_im, outer, n, inner,
                                tile, sms, plan, static_cast<const float*>(tables),
                                static_cast<const __nv_bfloat16*>(mats),
                                static_cast<cudaStream_t>(stream));
}
