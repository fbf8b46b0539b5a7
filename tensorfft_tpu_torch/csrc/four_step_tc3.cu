// The four-step passes' one-CTA tensor-core kernels for fp32 storage
// with 3 data terms (four_step_tc.cuh).
#include "four_step_tc.cuh"

namespace tfft {
template TFFT_FOUR_STEP_TC_PAIR(float, 3);
}  // namespace tfft
