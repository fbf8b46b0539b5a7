// The four-step passes' one-CTA tensor-core kernels for bf16 storage
// with 1 data term (four_step_tc.cuh).
#include "four_step_tc.cuh"

namespace tfft {
template TFFT_FOUR_STEP_TC_PAIR(__nv_bfloat16, 1);
}  // namespace tfft
