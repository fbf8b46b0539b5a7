// The in-place row pass's one-CTA tensor-core kernels for bf16 storage
// with 1 data term (row_pass_tc.cuh).
#include "row_pass_tc.cuh"

namespace tfft {
template TFFT_ROW_TC_PAIR(__nv_bfloat16, 1);
}  // namespace tfft
