// R2C entry point of the interleaving row pass of K6 (four_step_passes.cuh).
#include "four_step_passes.cuh"

// Returns a cudaError_t code (or kErrClusterUnschedulable; cluster: CTAs
// per row, four_step_passes.cuh; mats: the bf16 matrices, on one CTA
// and on a cluster, row_pass).

// Interleaving row pass (K6's second pass): `mid` (B, N) planes -> real
// (B, 2N), natural bin k at x[b, 2k] (re) and x[b, 2k + 1] (im).
extern "C" int tfft_four_step_row_interleave(const void* mid_re,
                                             const void* mid_im, void* x,
                                             int dtype, int data_terms,
                                             long long batch, int n1, int n2,
                                             int T, int cluster,
                                             const void* tables,
                                             const void* mats,
                                             const long long* meta,
                                             void* stream) {
  return tfft::row_pass<true>(mid_re, mid_im, x, nullptr, dtype, data_terms,
                              batch, n1, n2, T, cluster, tables, mats, meta,
                              stream);
}
