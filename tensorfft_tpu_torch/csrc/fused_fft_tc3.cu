// Kernel A's one-CTA tensor-core kernels for fp32 storage with 3 data terms
// (fused_fft_tc.cuh).
#include "fused_fft_tc.cuh"

namespace tfft {
template TFFT_FUSED_TC_PAIR(float, 3);
}  // namespace tfft
