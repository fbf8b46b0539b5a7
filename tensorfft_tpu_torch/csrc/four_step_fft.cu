// C2C entry point of kernel B, the column pass (four_step_passes.cuh); kernel
// C's is four_step_row.cu, compiled in parallel with it.
#include "four_step_passes.cuh"

// Every entry point returns a cudaError_t code (or kErrClusterUnschedulable;
// cluster: CTAs per tile of T columns, four_step_passes.cuh).  mats: the
// bf16 matrices (col_pass).  p: (n2/t, 2, n1) fp32, q: (2, n1, t) fp32.

// Column pass (kernel B): (B, N) planes -> `mid` (B, N) planes.
extern "C" int tfft_four_step_col(const void* in_re, const void* in_im,
                                  void* mid_re, void* mid_im, int dtype,
                                  int data_terms, long long batch, int n1,
                                  int n2, int T, int cluster,
                                  const void* tables, const void* mats,
                                  const long long* meta, const void* p,
                                  const void* q, int t, void* stream) {
  return tfft::col_pass<false, true>(in_re, in_im, mid_re, mid_im, dtype,
                                     data_terms, batch, n1, n2, T, cluster,
                                     tables, mats, meta, p, q, t, stream);
}
