// The cluster twins' tensor-core kernels for fp32 storage with 2 data terms
// (cluster_tc.cuh).
#include "cluster_tc.cuh"

namespace tfft {
TFFT_CLUSTER_TC_PAIR(template, float, 2);
}  // namespace tfft
