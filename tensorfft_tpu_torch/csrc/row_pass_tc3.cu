// The in-place row pass's one-CTA tensor-core kernels for fp32 storage
// with 3 data terms (row_pass_tc.cuh).
#include "row_pass_tc.cuh"

namespace tfft {
template TFFT_ROW_TC_PAIR(float, 3);
}  // namespace tfft
