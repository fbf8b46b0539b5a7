// C2C entry point of kernel C, the row pass (four_step_passes.cuh).
#include "four_step_passes.cuh"

// Returns a cudaError_t code (or kErrClusterUnschedulable; cluster: CTAs
// per row, four_step_passes.cuh; mats: the bf16 matrices, on one CTA
// and on a cluster, row_pass).

// Row pass (kernel C): `mid` (B, N) planes -> natural-order (B, N) planes.
extern "C" int tfft_four_step_row(const void* mid_re, const void* mid_im,
                                  void* out_re, void* out_im, int dtype,
                                  int data_terms, long long batch, int n1,
                                  int n2, int T, int cluster,
                                  const void* tables, const void* mats,
                                  const long long* meta, void* stream) {
  return tfft::row_pass<false>(mid_re, mid_im, out_re, out_im, dtype,
                               data_terms, batch, n1, n2, T, cluster, tables,
                               mats, meta, stream);
}
