// Kernel B's tensor-core cluster twin for fp32 storage with 3 data terms
// (cluster_col_tc.cuh).
#include "cluster_col_tc.cuh"

namespace tfft {
TFFT_CLUSTER_COL_TC_PAIR(template, float, 3);
}  // namespace tfft
