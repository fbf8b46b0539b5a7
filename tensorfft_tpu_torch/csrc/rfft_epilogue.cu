// Epilogue kernels of the real-to-complex path: the half-length packing of a
// real (B, N) signal as a complex (B, M) one, M = N/2, and its spectral
// untangling.
//
//   pack_split       (B, 2M) real -> even/odd planes (B, M)
//                    replaces K7, tensorfft_tpu/ops/rfft_pallas.py:pack_split
//                    (pallas_call at :236);
//   interleave_split even/odd planes (B, M) -> (B, 2M) real
//                    replaces K8, rfft_pallas.py:interleave_split (:288);
//   untangle_fwd     half-length spectrum Z (B, M) -> R2C spectrum X (B, M+1)
//                    replaces K9, rfft_pallas.py:untangle_fwd (:421);
//   retangle_inv     X (B, M+1) -> Z (B, M), the inverse pairing
//                    replaces K10, rfft_pallas.py:retangle_inv (:513).
//
// The TPU kernels move data with constant permutation matmuls on the matrix
// unit (the lane deinterleave, and the three-stream [J_shift; E_00] reversal
// V[k] = conj(Z[(M-k) mod M])), padded to sublane and lane tiles.  None of
// that exists here: one thread owns one output bin k of one row and reads
// its operands directly.  The mirrored read Z[b, M-k] is a descending
// contiguous run across a warp, so it coalesces like the forward one.
//
// What bounds them on the H100: bytes.  Each is a single pass of a few fp32
// operations per element, so the floor is one read of the inputs and one
// write of the outputs at 3.35 TB/s.  The design reads each input element
// once per use (the mirrored element comes through L1/L2, touched by the
// neighbouring warp) and writes each output once.  The (B, M+1) rows of X
// start at odd element offsets, so nothing here assumes more than the
// element's own alignment: scalar loads and stores only.
//
// Numerics: the phase tables w[k] = exp(sign 2 pi i k / N) are fp64 cos/sin
// rounded once to fp32 on the host (no sincosf here), and the complex
// products are written with __fmul_rn/__fadd_rn/__fsub_rn in the order of
// _untangle_kernel (rfft_pallas.py:352-358) and _retangle_kernel (:462-468),
// so nvcc contracts nothing into an FMA and every step rounds where the
// plain torch version rounds.
#include "fft_stages.cuh"

namespace tfft {

constexpr int kEpilogueThreads = 256;
constexpr long long kMaxGridY = 65535;

inline dim3 epilogue_grid(long long cols, long long batch) {
  const long long x = (cols + kEpilogueThreads - 1) / kEpilogueThreads;
  const long long y = batch < kMaxGridY ? batch : kMaxGridY;
  return dim3(static_cast<unsigned>(x), static_cast<unsigned>(y));
}

template <typename S>
__global__ void __launch_bounds__(kEpilogueThreads)
    pack_kernel(const S* __restrict__ x, S* __restrict__ re,
                S* __restrict__ im, long long batch, int m) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= m) return;
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    const long long at = b * m + k;
    re[at] = x[2 * at];
    im[at] = x[2 * at + 1];
  }
}

template <typename S>
__global__ void __launch_bounds__(kEpilogueThreads)
    interleave_kernel(const S* __restrict__ re, const S* __restrict__ im,
                      S* __restrict__ x, long long batch, int m) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= m) return;
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    const long long at = b * m + k;
    x[2 * at] = re[at];
    x[2 * at + 1] = im[at];
  }
}

// X[k] = ((U + V) - i w[k] (U - V)) * scale, U = Z[k], V = conj(Z[(M-k) mod
// M]), w = exp(-2 pi i k / N) for k < M; X[M] = 2 scale (Re Z0 - Im Z0) with
// an imaginary part of exactly 0.  w holds [cos; sin] as (2, M) fp32.
template <typename S>
__global__ void __launch_bounds__(kEpilogueThreads)
    untangle_kernel(const S* __restrict__ z_re, const S* __restrict__ z_im,
                    S* __restrict__ x_re, S* __restrict__ x_im,
                    long long batch, int m, const float* __restrict__ w,
                    float scale) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k > m) return;
  if (k == m) {
    const float two_scale = 2.0f * scale;  // exact: a power-of-two multiple
    for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
      const long long z0 = b * m, at = b * (m + 1) + m;
      x_re[at] = from_float<S>(__fmul_rn(
          two_scale, __fsub_rn(to_float(z_re[z0]), to_float(z_im[z0]))));
      x_im[at] = from_float<S>(0.0f);
    }
    return;
  }
  const float w_re = __ldg(w + k), w_im = __ldg(w + m + k);
  const int j = k == 0 ? 0 : m - k;
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    const long long row = b * m;
    const float u_re = to_float(z_re[row + k]), u_im = to_float(z_im[row + k]);
    const float v_re = to_float(z_re[row + j]), v_im = -to_float(z_im[row + j]);
    const float a_re = __fadd_rn(u_re, v_re), a_im = __fadd_rn(u_im, v_im);
    const float b_re = __fsub_rn(u_re, v_re), b_im = __fsub_rn(u_im, v_im);
    // -i * w * b
    const float c_re = __fadd_rn(__fmul_rn(w_re, b_im), __fmul_rn(w_im, b_re));
    const float c_im = -__fsub_rn(__fmul_rn(w_re, b_re), __fmul_rn(w_im, b_im));
    const long long at = b * (m + 1) + k;
    x_re[at] = from_float<S>(__fmul_rn(__fadd_rn(a_re, c_re), scale));
    x_im[at] = from_float<S>(__fmul_rn(__fadd_rn(a_im, c_im), scale));
  }
}

// Z[k] = (A + i w[k] B) * scale, A = X[k] + conj(X[M-k]), B = X[k] -
// conj(X[M-k]), w = exp(+2 pi i k / N), k < M (k = 0 pairs with the Nyquist
// bin X[M]).  Input and output dtypes are independent: the caller's planes
// come in uncast and Z leaves in the plan's storage dtype.
template <typename Si, typename So>
__global__ void __launch_bounds__(kEpilogueThreads)
    retangle_kernel(const Si* __restrict__ x_re, const Si* __restrict__ x_im,
                    So* __restrict__ z_re, So* __restrict__ z_im,
                    long long batch, int m, const float* __restrict__ w,
                    float scale) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= m) return;
  const float w_re = __ldg(w + k), w_im = __ldg(w + m + k);
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    const long long row = b * (m + 1);
    const float xk_re = to_float(x_re[row + k]), xk_im = to_float(x_im[row + k]);
    const float r_re = to_float(x_re[row + m - k]);
    const float r_im = -to_float(x_im[row + m - k]);
    const float a_re = __fadd_rn(xk_re, r_re), a_im = __fadd_rn(xk_im, r_im);
    const float b_re = __fsub_rn(xk_re, r_re), b_im = __fsub_rn(xk_im, r_im);
    // i * w * b
    const float c_re = -__fadd_rn(__fmul_rn(w_re, b_im), __fmul_rn(w_im, b_re));
    const float c_im = __fsub_rn(__fmul_rn(w_re, b_re), __fmul_rn(w_im, b_im));
    const long long at = b * m + k;
    z_re[at] = from_float<So>(__fmul_rn(__fadd_rn(a_re, c_re), scale));
    z_im[at] = from_float<So>(__fmul_rn(__fadd_rn(a_im, c_im), scale));
  }
}

}  // namespace tfft

// Every launcher returns a cudaError_t code (0 on success).  dtype codes:
// 0 bf16, 1 fp32.  batch >= 1 and m >= 1; rows are contiguous.

extern "C" int tfft_pack_split(const void* x, void* re, void* im, int dtype,
                               long long batch, int m, void* stream) {
  using namespace tfft;
  if (batch < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = epilogue_grid(m, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFFT_PACK(S)                                                      \
  pack_kernel<S><<<grid, kEpilogueThreads, 0, s>>>(                        \
      static_cast<const S*>(x), static_cast<S*>(re), static_cast<S*>(im), \
      batch, m);                                                          \
  return static_cast<int>(cudaGetLastError())
  if (dtype == 0) { TFFT_PACK(__nv_bfloat16); }
  if (dtype == 1) { TFFT_PACK(float); }
#undef TFFT_PACK
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tfft_interleave_split(const void* re, const void* im, void* x,
                                     int dtype, long long batch, int m,
                                     void* stream) {
  using namespace tfft;
  if (batch < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = epilogue_grid(m, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFFT_INTERLEAVE(S)                                                  \
  interleave_kernel<S><<<grid, kEpilogueThreads, 0, s>>>(                    \
      static_cast<const S*>(re), static_cast<const S*>(im),                 \
      static_cast<S*>(x), batch, m);                                        \
  return static_cast<int>(cudaGetLastError())
  if (dtype == 0) { TFFT_INTERLEAVE(__nv_bfloat16); }
  if (dtype == 1) { TFFT_INTERLEAVE(float); }
#undef TFFT_INTERLEAVE
  return static_cast<int>(cudaErrorInvalidValue);
}

// w: (2, m) fp32 [cos; sin] of -2 pi k / (2m).  Output in Z's dtype.
extern "C" int tfft_untangle_fwd(const void* z_re, const void* z_im,
                                 void* x_re, void* x_im, int dtype,
                                 long long batch, int m, const void* w,
                                 float scale, void* stream) {
  using namespace tfft;
  if (batch < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = epilogue_grid(static_cast<long long>(m) + 1, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wt = static_cast<const float*>(w);
#define TFFT_UNTANGLE(S)                                                    \
  untangle_kernel<S><<<grid, kEpilogueThreads, 0, s>>>(                      \
      static_cast<const S*>(z_re), static_cast<const S*>(z_im),             \
      static_cast<S*>(x_re), static_cast<S*>(x_im), batch, m, wt, scale);   \
  return static_cast<int>(cudaGetLastError())
  if (dtype == 0) { TFFT_UNTANGLE(__nv_bfloat16); }
  if (dtype == 1) { TFFT_UNTANGLE(float); }
#undef TFFT_UNTANGLE
  return static_cast<int>(cudaErrorInvalidValue);
}

// w: (2, m) fp32 [cos; sin] of +2 pi k / (2m).  in_dtype and out_dtype are
// each 0 (bf16) or 1 (fp32).
extern "C" int tfft_retangle_inv(const void* x_re, const void* x_im,
                                 void* z_re, void* z_im, int in_dtype,
                                 int out_dtype, long long batch, int m,
                                 const void* w, float scale, void* stream) {
  using namespace tfft;
  if (batch < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = epilogue_grid(m, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wt = static_cast<const float*>(w);
#define TFFT_RETANGLE(Si, So)                                                \
  retangle_kernel<Si, So><<<grid, kEpilogueThreads, 0, s>>>(                  \
      static_cast<const Si*>(x_re), static_cast<const Si*>(x_im),            \
      static_cast<So*>(z_re), static_cast<So*>(z_im), batch, m, wt, scale);  \
  return static_cast<int>(cudaGetLastError())
  if (in_dtype == 0 && out_dtype == 0) { TFFT_RETANGLE(__nv_bfloat16, __nv_bfloat16); }
  if (in_dtype == 0 && out_dtype == 1) { TFFT_RETANGLE(__nv_bfloat16, float); }
  if (in_dtype == 1 && out_dtype == 0) { TFFT_RETANGLE(float, __nv_bfloat16); }
  if (in_dtype == 1 && out_dtype == 1) { TFFT_RETANGLE(float, float); }
#undef TFFT_RETANGLE
  return static_cast<int>(cudaErrorInvalidValue);
}
