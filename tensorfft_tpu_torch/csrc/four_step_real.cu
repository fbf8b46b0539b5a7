// R2C entry points of the four-step passes (four_step_passes.cuh): the
// packed column pass of K5 and the interleaving row pass of K6, compiled
// apart from four_step_fft.cu so that nvcc builds the two in parallel.
#include "four_step_passes.cuh"

// Every entry point returns a cudaError_t code.  p: (n2/t, 2, n1) fp32,
// q: (2, n1, t) fp32.

// Packed column pass (K5's first pass): real (B, 2N) -> `mid` (B, N) planes.
extern "C" int tfft_four_step_col_packed(const void* x, void* mid_re,
                                         void* mid_im, int dtype,
                                         int data_terms, long long batch,
                                         int n1, int n2, int T,
                                         const void* tables,
                                         const long long* meta, const void* p,
                                         const void* q, int t, void* stream) {
  return tfft::col_pass<true, true>(x, nullptr, mid_re, mid_im, dtype, data_terms,
                              batch, n1, n2, T, tables, meta, p, q, t, stream);
}

// Interleaving row pass (K6's second pass): `mid` (B, N) planes -> real
// (B, 2N), natural bin k at x[b, 2k] (re) and x[b, 2k + 1] (im).
extern "C" int tfft_four_step_row_interleave(const void* mid_re,
                                             const void* mid_im, void* x,
                                             int dtype, int data_terms,
                                             long long batch, int n1, int n2,
                                             int T, const void* tables,
                                             const long long* meta,
                                             void* stream) {
  return tfft::row_pass<true, true>(mid_re, mid_im, x, nullptr, dtype, data_terms,
                              batch, n1, n2, T, tables, meta, stream);
}
