// R2C entry point of the packed column pass of K5 (four_step_passes.cuh);
// the interleaving row pass of K6 is four_step_real_row.cu.  Each entry
// point is a file of its own so that nvcc builds them in parallel.
#include "four_step_passes.cuh"

// Every entry point returns a cudaError_t code (or kErrClusterUnschedulable;
// cluster: CTAs per tile of T columns, four_step_passes.cuh).  mats: the
// bf16 matrices (col_pass).  p: (n2/t, 2, n1) fp32, q: (2, n1, t) fp32.

// Packed column pass (K5's first pass): real (B, 2N) -> `mid` (B, N) planes.
extern "C" int tfft_four_step_col_packed(const void* x, void* mid_re,
                                         void* mid_im, int dtype,
                                         int data_terms, long long batch,
                                         int n1, int n2, int T, int cluster,
                                         const void* tables, const void* mats,
                                         const long long* meta, const void* p,
                                         const void* q, int t, void* stream) {
  return tfft::col_pass<true, true>(x, nullptr, mid_re, mid_im, dtype,
                                    data_terms, batch, n1, n2, T, cluster,
                                    tables, mats, meta, p, q, t, stream);
}
