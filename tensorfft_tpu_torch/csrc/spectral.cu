// The spectral operator of the periodic Poisson solve
// (tensorfft_tpu_torch/models/poisson.py): the half spectrum F (nx, ny,
// nz/2+1) of rfftn_split, in whatever strides the forward pass leaves it,
// times 1/lambda with the mean mode zeroed, written as dense C-order planes
// that irfftn_split's first axis pass reads with no relayout.
//
//   poisson_scale   U[i, j, k] = F[i, j, k] / (k0[i] + k1[j] + k2[k]),
//                   U[0, 0, 0] = 0
//
// The JAX package has no kernel here: tensorfft_tpu/models/poisson.py
// multiplies the full (nx, ny, nz) spectrum by a float32 table of 1/lambda
// and by a mask, both as large as the grid (512 MiB each at 512^3, read every
// solve).  Here lambda is the sum of three 1-D eigenvalue tables, one per
// axis (a few KiB, cached), computed in fp32 per element.
//
// What bounds it on the H100: bytes, one read and one write of both planes.
// The forward pass leaves the spectrum with the y axis innermost (the second
// axis pass's kernel A output, moved back), while the output wants z
// innermost, so each CTA moves a 64 x 64 tile of the (a, k) plane through
// shared memory: a is the input's innermost axis of i and j (the launcher
// picks it from the strides), loaded with the lanes along a and stored with
// the lanes along k.  Where a is unit-stride and aligned, each lane loads a
// pair of adjacent elements in one access (`mode` 2), so a warp reads 128
// contiguous bytes of a bf16 plane a row; otherwise one element
// (`mode` 1).  When the input already has k innermost the lanes run along k
// both ways (`mode` 0).  Each thread keeps 16 loads of each plane in flight.
//
// Numerics: lambda = (ta[a] + tc[c]) + tk[k] and its reciprocal, then one
// product per plane, each rounded once in fp32 (__fadd_rn, __frcp_rn,
// __fmul_rn: nothing contracted), then to the storage dtype; the plain
// version (ops/spectral_cuda.py:poisson_scale_reference) rounds at the same
// steps, so the two agree bit for bit.  Addition is commutative, so which of
// k0 and k1 is ta does not move a bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tfft {

constexpr int kScaleTile = 64;   // a and k extent of a CTA's tile
constexpr int kScaleLanes = 32;
constexpr int kScaleRows = 8;
constexpr long long kMaxGridZ = 65535;

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

template <typename S>
struct alignas(2 * sizeof(S)) ScalePair {
  S x, y;
};

// Axes: c outer (blockIdx.z), a (blockIdx.y tiles), k (blockIdx.x tiles).
// Input strides per plane in elements; the output is dense with stride 1
// along k and oa, oc along a and c.  Mode 2 needs sa == 1 for both planes,
// even sc, sk and na, and planes aligned to a pair.
template <typename S>
__global__ void __launch_bounds__(kScaleLanes * kScaleRows)
    poisson_scale_kernel(const S* __restrict__ re, const S* __restrict__ im,
                         S* __restrict__ out_re, S* __restrict__ out_im,
                         const float* __restrict__ ta, const float* __restrict__ tc,
                         const float* __restrict__ tk, int na, int nc, int nk,
                         long long sa_re, long long sc_re, long long sk_re,
                         long long sa_im, long long sc_im, long long sk_im,
                         long long oa, long long oc, int mode) {
  // [a][k], padded so a row starts on a 4-byte boundary and the transposed
  // stores of a warp fall in distinct banks.
  __shared__ S t_re[kScaleTile][kScaleTile + 2];
  __shared__ S t_im[kScaleTile][kScaleTile + 2];
  const int a0 = blockIdx.y * kScaleTile, k0 = blockIdx.x * kScaleTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (long long c = blockIdx.z; c < nc; c += gridDim.z) {
    const S* p_re = re + c * sc_re;
    const S* p_im = im + c * sc_im;
    if (mode == 0) {
      for (int r = ty; r < kScaleTile && a0 + r < na; r += kScaleRows) {
        const long long a = a0 + r;
        for (int kl = tx; kl < kScaleTile; kl += kScaleLanes) {
          const long long k = k0 + kl;
          if (k < nk) {
            t_re[r][kl] = p_re[a * sa_re + k * sk_re];
            t_im[r][kl] = p_im[a * sa_im + k * sk_im];
          }
        }
      }
    } else {
      for (int r = ty; r < kScaleTile && k0 + r < nk; r += kScaleRows) {
        const long long k = k0 + r;
        if (mode == 2) {
          const int al = 2 * tx;
          const long long a = a0 + al;
          if (a < na) {
            const ScalePair<S> v_re = *reinterpret_cast<const ScalePair<S>*>(p_re + a + k * sk_re);
            const ScalePair<S> v_im = *reinterpret_cast<const ScalePair<S>*>(p_im + a + k * sk_im);
            t_re[al][r] = v_re.x;
            t_re[al + 1][r] = v_re.y;
            t_im[al][r] = v_im.x;
            t_im[al + 1][r] = v_im.y;
          }
        } else {
          for (int al = tx; al < kScaleTile; al += kScaleLanes) {
            const long long a = a0 + al;
            if (a < na) {
              t_re[al][r] = p_re[a * sa_re + k * sk_re];
              t_im[al][r] = p_im[a * sa_im + k * sk_im];
            }
          }
        }
      }
    }
    __syncthreads();
    const float lc = tc[c];
    float lk[kScaleTile / kScaleLanes];
#pragma unroll
    for (int h = 0; h < kScaleTile / kScaleLanes; ++h) {
      const int k = k0 + tx + h * kScaleLanes;
      lk[h] = k < nk ? tk[k] : 0.0f;
    }
    for (int r = ty; r < kScaleTile && a0 + r < na; r += kScaleRows) {
      const int a = a0 + r;
      const float lac = __fadd_rn(ta[a], lc);
      S* o_re = out_re + c * oc + a * oa;
      S* o_im = out_im + c * oc + a * oa;
#pragma unroll
      for (int h = 0; h < kScaleTile / kScaleLanes; ++h) {
        const int kl = tx + h * kScaleLanes, k = k0 + kl;
        if (k < nk) {
          const float inv = __frcp_rn(__fadd_rn(lac, lk[h]));
          const bool mean = c == 0 && a == 0 && k == 0;
          store_f(o_re + k, mean ? 0.0f : __fmul_rn(to_f(t_re[r][kl]), inv));
          store_f(o_im + k, mean ? 0.0f : __fmul_rn(to_f(t_im[r][kl]), inv));
        }
      }
    }
    __syncthreads();
  }
}

template <typename S>
int launch_poisson_scale(const void* re, const void* im, void* out_re, void* out_im,
                         const float* ta, const float* tc, const float* tk, int na,
                         int nc, int nk, long long sa_re, long long sc_re,
                         long long sk_re, long long sa_im, long long sc_im,
                         long long sk_im, long long oa, long long oc, int mode,
                         cudaStream_t stream) {
  const dim3 grid((nk + kScaleTile - 1) / kScaleTile, (na + kScaleTile - 1) / kScaleTile,
                  static_cast<unsigned>(nc < kMaxGridZ ? nc : kMaxGridZ));
  poisson_scale_kernel<S><<<grid, dim3(kScaleLanes, kScaleRows), 0, stream>>>(
      static_cast<const S*>(re), static_cast<const S*>(im), static_cast<S*>(out_re),
      static_cast<S*>(out_im), ta, tc, tk, na, nc, nk, sa_re, sc_re, sk_re, sa_im,
      sc_im, sk_im, oa, oc, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tfft

// Returns a cudaError_t code (0 on success).  dtype: 0 bf16, 1 fp32, both
// planes in and out.  ta, tc, tk: fp32 eigenvalue tables of na, nc, nk
// entries.  na, nk, nc >= 1; mode 0, 1 or 2 (the kernel's comment).
extern "C" int tfft_poisson_scale(const void* re, const void* im, void* out_re,
                                  void* out_im, const void* ta, const void* tc,
                                  const void* tk, int dtype, int na, int nc, int nk,
                                  long long sa_re, long long sc_re, long long sk_re,
                                  long long sa_im, long long sc_im, long long sk_im,
                                  long long oa, long long oc, int mode,
                                  void* stream) {
  using namespace tfft;
  if (na < 1 || nc < 1 || nk < 1 || (na + kScaleTile - 1) / kScaleTile > 65535 ||
      mode < 0 || mode > 2 || (mode == 2 && (na % 2 || sa_re != 1 || sa_im != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(ta);
  const float* c = static_cast<const float*>(tc);
  const float* k = static_cast<const float*>(tk);
#define TFFT_SCALE(S)                                                                 \
  return launch_poisson_scale<S>(re, im, out_re, out_im, a, c, k, na, nc, nk, sa_re,  \
                                 sc_re, sk_re, sa_im, sc_im, sk_im, oa, oc, mode,      \
                                 s)
  if (dtype == 0) { TFFT_SCALE(__nv_bfloat16); }
  if (dtype == 1) { TFFT_SCALE(float); }
#undef TFFT_SCALE
  return static_cast<int>(cudaErrorInvalidValue);
}
