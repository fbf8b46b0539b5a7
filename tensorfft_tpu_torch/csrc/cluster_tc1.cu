// The cluster twins' tensor-core kernels for bf16 storage with 1 data term
// (cluster_tc.cuh).
#include "cluster_tc.cuh"

namespace tfft {
TFFT_CLUSTER_TC_PAIR(template, __nv_bfloat16, 1);
}  // namespace tfft
