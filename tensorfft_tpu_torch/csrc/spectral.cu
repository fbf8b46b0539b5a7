// The spectral operators of the models (tensorfft_tpu_torch/models/):
//
//   poisson_scale     the periodic Poisson solve's (models/poisson.py): the
//                     half spectrum F (nx, ny, nz/2+1) of rfftn_split, in
//                     whatever strides the forward pass leaves it, times
//                     1/lambda with the mean mode zeroed, written as dense
//                     C-order planes that irfftn_split's first axis pass
//                     reads with no relayout:
//                     U[i, j, k] = F[i, j, k] / (k0[i] + k1[j] + k2[k]),
//                     U[0, 0, 0] = 0
//   spectral_product  the convolutions' (models/fft_conv.py): P = A * B,
//                     complex, elementwise, over B planes of M elements,
//                     written as dense fp32 planes
//
// poisson_scale.  The JAX package has no kernel here:
// tensorfft_tpu/models/poisson.py multiplies the full (nx, ny, nz) spectrum
// by a float32 table of 1/lambda and by a mask, both as large as the grid
// (512 MiB each at 512^3, read every solve).  Here lambda is the sum of
// three 1-D eigenvalue tables, one per axis (a few KiB, cached), computed in
// fp32 per element.
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
constexpr long long kMaxGridYZ = 65535;  // a grid's y and z limit

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
                  static_cast<unsigned>(nc < kMaxGridYZ ? nc : kMaxGridYZ));
  poisson_scale_kernel<S><<<grid, dim3(kScaleLanes, kScaleRows), 0, stream>>>(
      static_cast<const S*>(re), static_cast<const S*>(im), static_cast<S*>(out_re),
      static_cast<S*>(out_im), ta, tc, tk, na, nc, nk, sa_re, sc_re, sk_re, sa_im,
      sc_im, sk_im, oa, oc, mode);
  return static_cast<int>(cudaGetLastError());
}


// spectral_product.  The JAX package multiplies the two spectra in XLA
// (tensorfft_tpu/models/fft_conv.py:_cmul: four products, a difference and
// a sum, each an array pass), and so did the port's plain torch before this
// kernel: six launches reading 16 and writing 8 plane-sized arrays where
// the product needs the four input planes read once and the two output
// planes written once.  Here one launch streams them.
//
// What bounds it on the H100: bytes (at 4096^2 fp32, 402 MB, 0.120 ms at
// 3.35 TB/s).  Each thread handles kProductWidth adjacent elements of one
// plane: with `vec` (M, both batch strides a multiple of kProductWidth, and
// every plane aligned to its width) one 16-byte load of each fp32 input
// plane (8 bytes of a bf16 one) and one 16-byte store of each output plane;
// without it one element a thread.  A's or B's batch stride may be 0: one
// spectrum multiplies every plane of the other (a kernel broadcast over a
// batch of images).
//
// Numerics: the inputs widened to fp32 (exact from bf16), then
// re = ar * br - ai * bi and im = ar * bi + ai * br, each product and the
// sum or difference rounded once in fp32 (__fmul_rn, __fsub_rn, __fadd_rn:
// nothing contracted), as the plain version
// (ops/spectral_cuda.py:spectral_product_reference) rounds them, so the two
// agree bit for bit.
constexpr int kProductThreads = 256;
constexpr int kProductWidth = 4;

template <typename S>
struct alignas(kProductWidth * sizeof(S)) ProductQuad {
  S v[kProductWidth];
};

__device__ __forceinline__ void complex_product(float ar, float ai, float br, float bi,
                                                float& pr, float& pi) {
  pr = __fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
  pi = __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br));
}

// Axes: planes (blockIdx.y, striding by gridDim.y), elements of a plane
// (blockIdx.x, threadIdx.x).  Plane b of A starts at b * sa, of B at b * sb,
// of P at b * m.
template <typename S, bool kVec>
__global__ void __launch_bounds__(kProductThreads)
    spectral_product_kernel(const S* __restrict__ a_re, const S* __restrict__ a_im,
                            const S* __restrict__ b_re, const S* __restrict__ b_im,
                            float* __restrict__ p_re, float* __restrict__ p_im,
                            long long m, long long planes, long long sa, long long sb) {
  constexpr int kW = kVec ? kProductWidth : 1;
  const long long i = (static_cast<long long>(blockIdx.x) * kProductThreads + threadIdx.x) * kW;
  if (i >= m) return;
  for (long long b = blockIdx.y; b < planes; b += gridDim.y) {
    const long long ia = b * sa + i, ib = b * sb + i, ip = b * m + i;
    if constexpr (kVec) {
      using Q = ProductQuad<S>;
      const Q ar = *reinterpret_cast<const Q*>(a_re + ia);
      const Q ai = *reinterpret_cast<const Q*>(a_im + ia);
      const Q br = *reinterpret_cast<const Q*>(b_re + ib);
      const Q bi = *reinterpret_cast<const Q*>(b_im + ib);
      float4 pr, pi;
      complex_product(to_f(ar.v[0]), to_f(ai.v[0]), to_f(br.v[0]), to_f(bi.v[0]), pr.x, pi.x);
      complex_product(to_f(ar.v[1]), to_f(ai.v[1]), to_f(br.v[1]), to_f(bi.v[1]), pr.y, pi.y);
      complex_product(to_f(ar.v[2]), to_f(ai.v[2]), to_f(br.v[2]), to_f(bi.v[2]), pr.z, pi.z);
      complex_product(to_f(ar.v[3]), to_f(ai.v[3]), to_f(br.v[3]), to_f(bi.v[3]), pr.w, pi.w);
      *reinterpret_cast<float4*>(p_re + ip) = pr;
      *reinterpret_cast<float4*>(p_im + ip) = pi;
    } else {
      complex_product(to_f(a_re[ia]), to_f(a_im[ia]), to_f(b_re[ib]), to_f(b_im[ib]),
                      p_re[ip], p_im[ip]);
    }
  }
}

template <typename S, bool kVec>
int launch_spectral_product(const void* a_re, const void* a_im, const void* b_re,
                            const void* b_im, void* p_re, void* p_im, long long m,
                            long long planes, long long sa, long long sb,
                            cudaStream_t stream) {
  constexpr int kW = kVec ? kProductWidth : 1;
  const long long threads = (m + kW - 1) / kW;
  const dim3 grid(static_cast<unsigned>((threads + kProductThreads - 1) / kProductThreads),
                  static_cast<unsigned>(planes < kMaxGridYZ ? planes : kMaxGridYZ));
  spectral_product_kernel<S, kVec><<<grid, kProductThreads, 0, stream>>>(
      static_cast<const S*>(a_re), static_cast<const S*>(a_im), static_cast<const S*>(b_re),
      static_cast<const S*>(b_im), static_cast<float*>(p_re), static_cast<float*>(p_im), m,
      planes, sa, sb);
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

// Returns a cudaError_t code (0 on success).  dtype: 0 bf16, 1 fp32, the four
// input planes; the two output planes are fp32, dense (planes, m).  m >= 1,
// planes >= 1, batch strides sa, sb >= 0 in elements; vec 1 needs m, sa and
// sb multiples of 4 and every plane aligned to 4 of its elements (the
// kernel's comment).
extern "C" int tfft_spectral_product(const void* a_re, const void* a_im, const void* b_re,
                                     const void* b_im, void* p_re, void* p_im, int dtype,
                                     long long m, long long planes, long long sa,
                                     long long sb, int vec, void* stream) {
  using namespace tfft;
  if (m < 1 || planes < 1 || sa < 0 || sb < 0 || vec < 0 || vec > 1 ||
      (m + kProductThreads - 1) / kProductThreads > 0x7fffffffLL ||
      (vec && (m % kProductWidth || sa % kProductWidth || sb % kProductWidth)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFFT_PRODUCT(S, V) \
  return launch_spectral_product<S, V>(a_re, a_im, b_re, b_im, p_re, p_im, m, planes, sa, sb, s)
  if (dtype == 0) {
    if (vec) { TFFT_PRODUCT(__nv_bfloat16, true); }
    TFFT_PRODUCT(__nv_bfloat16, false);
  }
  if (dtype == 1) {
    if (vec) { TFFT_PRODUCT(float, true); }
    TFFT_PRODUCT(float, false);
  }
#undef TFFT_PRODUCT
  return static_cast<int>(cudaErrorInvalidValue);
}
