// Kernel B's tensor-core cluster twin for bf16 storage with 1 data term
// (cluster_col_tc.cuh).
#include "cluster_col_tc.cuh"

namespace tfft {
TFFT_CLUSTER_COL_TC_PAIR(template, __nv_bfloat16, 1);
}  // namespace tfft
