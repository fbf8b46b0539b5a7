// Kernel A's one-CTA tensor-core kernels for bf16 storage with 1 data term
// (fused_fft_tc.cuh).
#include "fused_fft_tc.cuh"

namespace tfft {
template TFFT_FUSED_TC_PAIR(__nv_bfloat16, 1);
}  // namespace tfft
