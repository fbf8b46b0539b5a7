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
// that exists here.  Pack and interleave give one thread one element of one
// row.  The untangle pair is built around the mirror pairing instead (see
// the section before untangle_pairs_kernel): X[k] and X[M-k] need only Z[k]
// and Z[M-k], so one thread owns a 16-byte run of bins and the mirrored run,
// reads each input element once, keeps its phase-table entries in registers
// over a group of rows, and moves every aligned interior in 16-byte accesses.
//
// What bounds them on the H100: bytes.  Each is a single pass of a few fp32
// operations per element, so the floor is one read of the inputs and one
// write of the outputs at 3.35 TB/s.
//
// Numerics: the phase tables w[k] = exp(sign 2 pi i k / N) are fp64 cos/sin
// rounded once to fp32 on the host (no sincosf here), and the complex
// products are written with __fmul_rn/__fadd_rn/__fsub_rn in the order of
// _untangle_kernel (rfft_pallas.py:352-358) and _retangle_kernel (:462-468),
// so nvcc contracts nothing into an FMA and every step rounds where the
// plain torch version rounds: the kernels equal their plain versions bit for
// bit.
#include <cstdint>

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

// -- K9 / K10: the untangle pair ---------------------------------------------
//
// Bin k of X depends on Z[k] and Z[(M-k) mod M] only, and bin M-k on the same
// two elements, so the kernels work on mirrored runs.  With V = 16 bytes of
// storage elements (8 bf16, 4 fp32; K10 takes V = 8 when either side is
// bf16) and q = M/V, thread t of a row owns the low run [Vt, Vt+V) for t <
// ceil(q/2) and the high run [M-V(t+1), M-Vt) for t < floor(q/2).  Both are
// aligned in the pitch-M rows of Z, so their inputs (K9) or outputs (K10)
// move in 16-byte accesses, and the runs cover [0, M) once: for odd q the
// middle thread's two runs coincide and it writes the low one only.
//
// The mirror of an aligned run is one element off alignment (the (M-k) mod M
// roll): low bin Vt+j pairs with M-Vt-j, the high run's element V-j for j >=
// 1 and, for j = 0, element 0 of the run above (thread t-1's high run;
// thread 0 pairs bin 0 with itself and also writes the Nyquist bin X[M] =
// 2 scale (Re Z0 - Im Z0), Im X[M] = 0).  High bin M-V(t+1)+j pairs with
// Vt+V-j: the low run's element V-j, or for j = 0 element 0 of the next low
// run (thread t+1's; the thread's own high element 0 when that run is the
// last, for even q the self-paired bin M/2).  A warp shuffle brings the
// neighbour's element; a thread at the edge of its warp loads it.
//
// X has a pitch of M+1, so row b starts b mod V elements off alignment (K10
// adds its input pointer's own phase, x_off).  K9 shifts each run's outputs
// through the neighbour lane's (shuffled) run so that the interior of every row
// leaves in aligned 16-byte stores and only the elements before the first
// and after the last aligned chunk of a warp's span go out one by one.  K10
// loads the aligned chunk that holds a run's first element and takes the
// next chunk from the neighbour lane (or loads it at a warp edge, masked at
// the ends of the allocation), then shifts.  The shift is uniform per row: a
// barrel of word selects and one 16-bit funnel shift for bf16.
//
// Tables are read once per CTA: a thread loads the phase entries of its two
// runs into registers and loops over a group of rows (pair_grid sizes the
// groups so the grid is at most one wave of resident CTAs; rows past 65535
// are only more rows per group).  Rows shorter than a CTA share it: P = the
// power of two >= the threads a row needs, 256/P rows per pass.
//
// M not a multiple of V, or operands off 16-byte alignment, take a branch of
// the same kernels (kVec = false) with the same arithmetic: thread t owns the
// pairs (k, M-k) for k in [Vt, Vt+V), k <= M/2, each element loaded and
// stored alone.

constexpr int kPairThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;

// kV storage elements of one plane as 32-bit words, element 0 in the low
// half of word 0 for bf16.
template <typename S, int kV>
struct Run {
  static constexpr int kE = 4 / static_cast<int>(sizeof(S));  // per word
  static constexpr int kW = kV / kE;
  uint32_t w[kW];
};

template <typename S>
__device__ __forceinline__ float word_elem(const uint32_t* w, int i) {
  if constexpr (sizeof(S) == 2)
    return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
  else
    return __uint_as_float(w[i]);
}

template <typename S>
__device__ __forceinline__ uint32_t elem_bits(const uint32_t* w, int i) {
  if constexpr (sizeof(S) == 2)
    return (i & 1) ? (w[i >> 1] >> 16) : (w[i >> 1] & 0xffffu);
  else
    return w[i];
}

template <typename S>
__device__ __forceinline__ void put_bits(uint32_t* w, int i, uint32_t bits) {
  if constexpr (sizeof(S) == 2)
    w[i >> 1] = (i & 1) ? ((w[i >> 1] & 0xffffu) | (bits << 16))
                        : ((w[i >> 1] & 0xffff0000u) | bits);
  else
    w[i] = bits;
}

// The element rounded once to the storage dtype (from_float's rounding).
template <typename S>
__device__ __forceinline__ void put_elem(uint32_t* w, int i, float x) {
  if constexpr (sizeof(S) == 2)
    put_bits<S>(w, i, __bfloat16_as_ushort(from_float<S>(x)));
  else
    put_bits<S>(w, i, __float_as_uint(x));
}

template <typename S>
__device__ __forceinline__ uint32_t load_bits(const S* p) {
  if constexpr (sizeof(S) == 2)
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  else
    return __ldg(reinterpret_cast<const unsigned int*>(p));
}

template <typename S>
__device__ __forceinline__ void store_bits(S* p, uint32_t bits) {
  if constexpr (sizeof(S) == 2)
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(bits);
  else
    *reinterpret_cast<unsigned int*>(p) = bits;
}

// p is 16-byte aligned.
template <typename S, int kV>
__device__ __forceinline__ Run<S, kV> load_run(const S* p) {
  Run<S, kV> r;
#pragma unroll
  for (int i = 0; i < Run<S, kV>::kW / 4; ++i) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
    r.w[4 * i] = v.x;
    r.w[4 * i + 1] = v.y;
    r.w[4 * i + 2] = v.z;
    r.w[4 * i + 3] = v.w;
  }
  return r;
}

template <int kW>
__device__ __forceinline__ void store_words(void* p, const uint32_t* w) {
#pragma unroll
  for (int i = 0; i < kW / 4; ++i)
    reinterpret_cast<uint4*>(p)[i] =
        make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

// Elements [a, a + kV) of p, a aligned to kV elements: one 16-byte access
// each when all lie in [0, total), else element by element, zero outside.
template <typename S, int kV>
__device__ __forceinline__ Run<S, kV> load_chunk(const S* p, long long a,
                                                 long long total) {
  if (a >= 0 && a + kV <= total) return load_run<S, kV>(p + a);
  Run<S, kV> r = {};
#pragma unroll
  for (int i = 0; i < kV; ++i)
    if (a + i >= 0 && a + i < total) put_bits<S>(r.w, i, load_bits(p + a + i));
  return r;
}

template <typename S, int kV>
__device__ __forceinline__ Run<S, kV> shfl_down_run(const Run<S, kV>& r) {
  Run<S, kV> o;
#pragma unroll
  for (int i = 0; i < Run<S, kV>::kW; ++i) o.w[i] = __shfl_down_sync(kFullWarp, r.w[i], 1);
  return o;
}

template <typename S, int kV>
__device__ __forceinline__ Run<S, kV> shfl_up_run(const Run<S, kV>& r) {
  Run<S, kV> o;
#pragma unroll
  for (int i = 0; i < Run<S, kV>::kW; ++i) o.w[i] = __shfl_up_sync(kFullWarp, r.w[i], 1);
  return o;
}

// out = elements [s, s + kOut*kE) of a ++ b, 0 <= s < kV: a barrel of word
// selects on s / kE, then for bf16 a 16-bit funnel shift when s is odd.
template <typename S, int kV, int kOut>
__device__ __forceinline__ void shift_window(const Run<S, kV>& a, const Run<S, kV>& b,
                                             int s, uint32_t (&out)[kOut]) {
  constexpr int kE = Run<S, kV>::kE, kW = Run<S, kV>::kW, kN = 2 * kW;
  static_assert(kOut + (kE == 2 ? 1 : 0) <= kN, "window past the pair");
  uint32_t x[kN];
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    x[i] = a.w[i];
    x[kW + i] = b.w[i];
  }
  const int ws = s / kE;
#pragma unroll
  for (int bit = 1; bit < kW; bit <<= 1) {
    if (ws & bit) {
#pragma unroll
      for (int i = 0; i + bit < kN; ++i) x[i] = x[i + bit];
    }
  }
  if constexpr (kE == 2) {
    const bool odd = s & 1;
#pragma unroll
    for (int i = 0; i < kOut; ++i) out[i] = odd ? __funnelshift_r(x[i], x[i + 1], 16) : x[i];
  } else {
#pragma unroll
    for (int i = 0; i < kOut; ++i) out[i] = x[i];
  }
}

// One plane of a K9 run whose first element is p, p + st 16-byte aligned:
// the aligned chunk [st, st + kV) from this run and the neighbour's (nb, the
// run that follows in memory) in one store when with_nb, else this run's
// [st, kV) one by one; [0, st) one by one when head (no lane before stores
// it).
template <typename S, int kV>
__device__ __forceinline__ void store_shifted(S* p, const Run<S, kV>& own,
                                              const Run<S, kV>& nb, int st,
                                              bool with_nb, bool head) {
  if (st == 0) {
    store_words<Run<S, kV>::kW>(p, own.w);
    return;
  }
  if (with_nb) {
    uint32_t c[Run<S, kV>::kW];
    shift_window<S, kV>(own, nb, st, c);
    store_words<Run<S, kV>::kW>(p + st, c);
  } else {
#pragma unroll
    for (int j = 1; j < kV; ++j)
      if (j >= st) store_bits(p + j, elem_bits<S>(own.w, j));
  }
  if (head) {
#pragma unroll
    for (int j = 0; j < kV - 1; ++j)
      if (j < st) store_bits(p + j, elem_bits<S>(own.w, j));
  }
}

template <int kV>
__device__ __forceinline__ void load_table(const float* p, float (&out)[kV]) {
#pragma unroll
  for (int i = 0; i < kV / 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    out[4 * i] = v.x;
    out[4 * i + 1] = v.y;
    out[4 * i + 2] = v.z;
    out[4 * i + 3] = v.w;
  }
}

// X[k] = ((U + V) - i w (U - V)) * scale, U = Z[k] (u), V = conj(z), z =
// Z[(M-k) mod M], w = exp(-2 pi i k / N): _untangle_kernel's order.
__device__ __forceinline__ void untangle_bin(float u_re, float u_im, float z_re,
                                             float z_im, float w_re, float w_im,
                                             float scale, float& o_re, float& o_im) {
  const float v_re = z_re, v_im = -z_im;
  const float a_re = __fadd_rn(u_re, v_re), a_im = __fadd_rn(u_im, v_im);
  const float b_re = __fsub_rn(u_re, v_re), b_im = __fsub_rn(u_im, v_im);
  // -i * w * b
  const float c_re = __fadd_rn(__fmul_rn(w_re, b_im), __fmul_rn(w_im, b_re));
  const float c_im = -__fsub_rn(__fmul_rn(w_re, b_re), __fmul_rn(w_im, b_im));
  o_re = __fmul_rn(__fadd_rn(a_re, c_re), scale);
  o_im = __fmul_rn(__fadd_rn(a_im, c_im), scale);
}

// Z[k] = (A + i w B) * scale, A = X[k] + conj(x), B = X[k] - conj(x), x =
// X[M-k], w = exp(+2 pi i k / N): _retangle_kernel's order.
__device__ __forceinline__ void retangle_bin(float k_re, float k_im, float x_re,
                                             float x_im, float w_re, float w_im,
                                             float scale, float& o_re, float& o_im) {
  const float r_re = x_re, r_im = -x_im;
  const float a_re = __fadd_rn(k_re, r_re), a_im = __fadd_rn(k_im, r_im);
  const float b_re = __fsub_rn(k_re, r_re), b_im = __fsub_rn(k_im, r_im);
  // i * w * b
  const float c_re = -__fadd_rn(__fmul_rn(w_re, b_im), __fmul_rn(w_im, b_re));
  const float c_im = __fsub_rn(__fmul_rn(w_re, b_re), __fmul_rn(w_im, b_im));
  o_re = __fmul_rn(__fadd_rn(a_re, c_re), scale);
  o_im = __fmul_rn(__fadd_rn(a_im, c_im), scale);
}

// A thread's place: run index t of its row segment (P = 2^log2p threads),
// the row it starts on within a pass, the rows per pass, and whether it is
// the first or last lane of its warp's share of the segment.
struct PairLane {
  int t, row, step;
  bool first, last;
};

__device__ __forceinline__ PairLane pair_lane(int log2p) {
  const int p = 1 << log2p, span = p < 32 ? p : 32;
  const int wl = threadIdx.x & (span - 1);
  return {static_cast<int>(blockIdx.x) * p + static_cast<int>(threadIdx.x & (p - 1)),
          static_cast<int>(threadIdx.x >> log2p), kPairThreads >> log2p, wl == 0,
          wl == span - 1};
}

template <typename S, bool kVec>
__global__ void __launch_bounds__(kPairThreads)
    untangle_pairs_kernel(const S* __restrict__ z_re, const S* __restrict__ z_im,
                          S* __restrict__ x_re, S* __restrict__ x_im,
                          long long batch, int m, const float* __restrict__ w,
                          float scale, int log2p, long long rows_per_cta) {
  constexpr int kV = 16 / static_cast<int>(sizeof(S));
  using R = Run<S, kV>;
  const PairLane ln = pair_lane(log2p);
  const int t = ln.t;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_cta;
  const long long r1 = r0 + rows_per_cta < batch ? r0 + rows_per_cta : batch;
  const float two_scale = 2.0f * scale;  // exact: a power-of-two multiple
  float wl_re[kV] = {}, wl_im[kV] = {}, wh_re[kV] = {}, wh_im[kV] = {};
  if constexpr (kVec) {
    const int q = m / kV, n_lo = (q + 1) / 2, n_hi = q / 2;
    const bool act_lo = t < n_lo, act_hi = t < n_hi;
    const int k_lo = kV * t, k_hi = m - kV * (t + 1);
    if (act_lo) {
      load_table<kV>(w + k_lo, wl_re);
      load_table<kV>(w + m + k_lo, wl_im);
      load_table<kV>(w + k_hi, wh_re);
      load_table<kV>(w + m + k_hi, wh_im);
    }
    // Every lane runs every pass (the shuffles take the whole warp).
    for (long long b0 = r0; b0 < r1; b0 += ln.step) {
      const long long b = b0 + ln.row;
      const bool lo = b < r1 && act_lo, hi = b < r1 && act_hi;
      const S* zr = z_re + b * m;
      const S* zi = z_im + b * m;
      R lre = {}, lim = {}, hre = {}, him = {};
      if (lo) {
        lre = load_run<S, kV>(zr + k_lo);
        lim = load_run<S, kV>(zi + k_lo);
        hre = load_run<S, kV>(zr + k_hi);
        him = load_run<S, kV>(zi + k_hi);
      }
      const uint32_t up_re = __shfl_up_sync(kFullWarp, hre.w[0], 1);
      const uint32_t up_im = __shfl_up_sync(kFullWarp, him.w[0], 1);
      const uint32_t dn_re = __shfl_down_sync(kFullWarp, lre.w[0], 1);
      const uint32_t dn_im = __shfl_down_sync(kFullWarp, lim.w[0], 1);
      // Z[(M - Vt) mod M] and Z[Vt + V], the one-element shift.
      float pv_re = 0.0f, pv_im = 0.0f, nx_re = 0.0f, nx_im = 0.0f;
      if (lo) {
        if (t == 0) {
          pv_re = word_elem<S>(lre.w, 0);
          pv_im = word_elem<S>(lim.w, 0);
        } else if (ln.first) {
          pv_re = to_float(zr[m - k_lo]);
          pv_im = to_float(zi[m - k_lo]);
        } else {
          pv_re = word_elem<S>(&up_re, 0);
          pv_im = word_elem<S>(&up_im, 0);
        }
        if (t + 1 >= n_lo) {
          nx_re = word_elem<S>(hre.w, 0);
          nx_im = word_elem<S>(him.w, 0);
        } else if (ln.last) {
          nx_re = to_float(zr[k_lo + kV]);
          nx_im = to_float(zi[k_lo + kV]);
        } else {
          nx_re = word_elem<S>(&dn_re, 0);
          nx_im = word_elem<S>(&dn_im, 0);
        }
      }
      R olr = {}, oli = {}, ohr = {}, ohi = {};
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const int jm = (kV - j) & (kV - 1);
        float o_re, o_im;
        untangle_bin(word_elem<S>(lre.w, j), word_elem<S>(lim.w, j),
                     j == 0 ? pv_re : word_elem<S>(hre.w, jm),
                     j == 0 ? pv_im : word_elem<S>(him.w, jm), wl_re[j], wl_im[j],
                     scale, o_re, o_im);
        put_elem<S>(olr.w, j, o_re);
        put_elem<S>(oli.w, j, o_im);
        untangle_bin(word_elem<S>(hre.w, j), word_elem<S>(him.w, j),
                     j == 0 ? nx_re : word_elem<S>(lre.w, jm),
                     j == 0 ? nx_im : word_elem<S>(lim.w, jm), wh_re[j], wh_im[j],
                     scale, o_re, o_im);
        put_elem<S>(ohr.w, j, o_re);
        put_elem<S>(ohi.w, j, o_im);
      }
      // The low runs follow each other upwards in memory, the high runs
      // downwards: a low run's aligned chunk continues into lane t+1's run,
      // a high run's into lane t-1's.
      const R nlr = shfl_down_run(olr), nli = shfl_down_run(oli);
      const R uhr = shfl_up_run(ohr), uhi = shfl_up_run(ohi);
      S* xr = x_re + b * (m + 1);
      S* xi = x_im + b * (m + 1);
      const int st = (kV - static_cast<int>(b & (kV - 1))) & (kV - 1);
      if (lo) {
        const bool with_nb = t + 1 < n_lo && !ln.last;
        store_shifted<S, kV>(xr + k_lo, olr, nlr, st, with_nb, ln.first);
        store_shifted<S, kV>(xi + k_lo, oli, nli, st, with_nb, ln.first);
        if (t == 0) {
          xr[m] = from_float<S>(__fmul_rn(
              two_scale, __fsub_rn(word_elem<S>(lre.w, 0), word_elem<S>(lim.w, 0))));
          xi[m] = from_float<S>(0.0f);
        }
      }
      if (hi) {
        const bool with_nb = t >= 1 && !ln.first;
        const bool head = !(t + 1 < n_hi && !ln.last);
        store_shifted<S, kV>(xr + k_hi, ohr, uhr, st, with_nb, head);
        store_shifted<S, kV>(xi + k_hi, ohi, uhi, st, with_nb, head);
      }
    }
  } else {
    const int half = m / 2, k0 = kV * t;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int k = k0 + j;
      if (k <= half) {
        wl_re[j] = __ldg(w + k);
        wl_im[j] = __ldg(w + m + k);
        if (k > 0) {
          wh_re[j] = __ldg(w + m - k);
          wh_im[j] = __ldg(w + 2 * m - k);
        }
      }
    }
    for (long long b = r0 + ln.row; b < r1; b += ln.step) {
      const S* zr = z_re + b * m;
      const S* zi = z_im + b * m;
      S* xr = x_re + b * (m + 1);
      S* xi = x_im + b * (m + 1);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const int k = k0 + j, km = k == 0 ? 0 : m - k;
        if (k > half) continue;
        const float u_re = to_float(zr[k]), u_im = to_float(zi[k]);
        const float v_re = to_float(zr[km]), v_im = to_float(zi[km]);
        float o_re, o_im;
        untangle_bin(u_re, u_im, v_re, v_im, wl_re[j], wl_im[j], scale, o_re, o_im);
        xr[k] = from_float<S>(o_re);
        xi[k] = from_float<S>(o_im);
        if (k == 0) {
          xr[m] = from_float<S>(__fmul_rn(two_scale, __fsub_rn(u_re, u_im)));
          xi[m] = from_float<S>(0.0f);
        } else if (km != k) {
          untangle_bin(v_re, v_im, u_re, u_im, wh_re[j], wh_im[j], scale, o_re, o_im);
          xr[km] = from_float<S>(o_re);
          xi[km] = from_float<S>(o_im);
        }
      }
    }
  }
}

// Input and output dtypes are independent: the caller's planes come in
// uncast and Z leaves in the plan's storage dtype.
template <typename Si, typename So, bool kVec>
__global__ void __launch_bounds__(kPairThreads)
    retangle_pairs_kernel(const Si* __restrict__ x_re, const Si* __restrict__ x_im,
                          So* __restrict__ z_re, So* __restrict__ z_im,
                          long long batch, int m, const float* __restrict__ w,
                          float scale, int log2p, long long rows_per_cta,
                          int x_off) {
  constexpr int kV = (sizeof(Si) == 2 || sizeof(So) == 2) ? 8 : 4;
  using RI = Run<Si, kV>;
  using RO = Run<So, kV>;
  const PairLane ln = pair_lane(log2p);
  const int t = ln.t;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_cta;
  const long long r1 = r0 + rows_per_cta < batch ? r0 + rows_per_cta : batch;
  float wl_re[kV] = {}, wl_im[kV] = {}, wh_re[kV] = {}, wh_im[kV] = {};
  if constexpr (kVec) {
    const int q = m / kV, n_lo = (q + 1) / 2, n_hi = q / 2;
    const bool act_lo = t < n_lo, act_hi = t < n_hi;
    const int k_lo = kV * t, k_hi = m - kV * (t + 1);
    if (act_lo) {
      load_table<kV>(w + k_lo, wl_re);
      load_table<kV>(w + m + k_lo, wl_im);
      load_table<kV>(w + k_hi, wh_re);
      load_table<kV>(w + m + k_hi, wh_im);
    }
    const long long total = batch * (m + 1);
    for (long long b0 = r0; b0 < r1; b0 += ln.step) {
      const long long b = b0 + ln.row;
      const bool lo = b < r1 && act_lo, hi = b < r1 && act_hi;
      // Run [k, k + V] of X starts s elements into the aligned chunk at a.
      const int s = static_cast<int>((x_off + b) & (kV - 1));
      const long long a_lo = b * (m + 1) + k_lo - s, a_hi = b * (m + 1) + k_hi - s;
      RI clr = {}, cli = {}, chr = {}, chi = {};
      if (lo) {
        clr = load_chunk<Si, kV>(x_re, a_lo, total);
        cli = load_chunk<Si, kV>(x_im, a_lo, total);
        chr = load_chunk<Si, kV>(x_re, a_hi, total);
        chi = load_chunk<Si, kV>(x_im, a_hi, total);
      }
      RI nlr = shfl_down_run(clr), nli = shfl_down_run(cli);
      RI uhr = shfl_up_run(chr), uhi = shfl_up_run(chi);
      if (lo) {
        if (!(t + 1 < n_lo && !ln.last)) {
          nlr = load_chunk<Si, kV>(x_re, a_lo + kV, total);
          nli = load_chunk<Si, kV>(x_im, a_lo + kV, total);
        }
        if (!(t >= 1 && !ln.first)) {
          uhr = load_chunk<Si, kV>(x_re, a_hi + kV, total);
          uhi = load_chunk<Si, kV>(x_im, a_hi + kV, total);
        }
      }
      // X[Vt .. Vt+V] and X[M-V(t+1) .. M-Vt], V+1 elements each.
      constexpr int kOut = RI::kW + 1;
      uint32_t lr[kOut], li[kOut], hr[kOut], hi_[kOut];
      shift_window<Si, kV>(clr, nlr, s, lr);
      shift_window<Si, kV>(cli, nli, s, li);
      shift_window<Si, kV>(chr, uhr, s, hr);
      shift_window<Si, kV>(chi, uhi, s, hi_);
      RO olr = {}, oli = {}, ohr = {}, ohi = {};
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        float o_re, o_im;
        retangle_bin(word_elem<Si>(lr, j), word_elem<Si>(li, j), word_elem<Si>(hr, kV - j),
                     word_elem<Si>(hi_, kV - j), wl_re[j], wl_im[j], scale, o_re, o_im);
        put_elem<So>(olr.w, j, o_re);
        put_elem<So>(oli.w, j, o_im);
        retangle_bin(word_elem<Si>(hr, j), word_elem<Si>(hi_, j), word_elem<Si>(lr, kV - j),
                     word_elem<Si>(li, kV - j), wh_re[j], wh_im[j], scale, o_re, o_im);
        put_elem<So>(ohr.w, j, o_re);
        put_elem<So>(ohi.w, j, o_im);
      }
      So* zr = z_re + b * m;
      So* zi = z_im + b * m;
      if (lo) {
        store_words<RO::kW>(zr + k_lo, olr.w);
        store_words<RO::kW>(zi + k_lo, oli.w);
      }
      if (hi) {
        store_words<RO::kW>(zr + k_hi, ohr.w);
        store_words<RO::kW>(zi + k_hi, ohi.w);
      }
    }
  } else {
    const int half = m / 2, k0 = kV * t;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int k = k0 + j;
      if (k <= half) {
        wl_re[j] = __ldg(w + k);
        wl_im[j] = __ldg(w + m + k);
        if (k > 0) {
          wh_re[j] = __ldg(w + m - k);
          wh_im[j] = __ldg(w + 2 * m - k);
        }
      }
    }
    for (long long b = r0 + ln.row; b < r1; b += ln.step) {
      const Si* xr = x_re + b * (m + 1);
      const Si* xi = x_im + b * (m + 1);
      So* zr = z_re + b * m;
      So* zi = z_im + b * m;
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const int k = k0 + j, km = m - k;  // k = 0 pairs with X[M]
        if (k > half) continue;
        const float k_re = to_float(xr[k]), k_im = to_float(xi[k]);
        const float x_re_m = to_float(xr[km]), x_im_m = to_float(xi[km]);
        float o_re, o_im;
        retangle_bin(k_re, k_im, x_re_m, x_im_m, wl_re[j], wl_im[j], scale, o_re, o_im);
        zr[k] = from_float<So>(o_re);
        zi[k] = from_float<So>(o_im);
        if (k > 0 && km != k) {
          retangle_bin(x_re_m, x_im_m, k_re, k_im, wh_re[j], wh_im[j], scale, o_re, o_im);
          zr[km] = from_float<So>(o_re);
          zi[km] = from_float<So>(o_im);
        }
      }
    }
  }
}

// Grid of a pair kernel: P = 2^log2p threads per row segment (the power of
// two >= the threads a row needs, at most a CTA), 256/P rows per pass, and
// the rows split into groups so that the grid is at most `target` CTAs (one
// wave of resident CTAs) unless one row alone needs more.  Each CTA loops
// over its group's rows.
struct PairGrid {
  dim3 grid;
  int log2p;
  long long rows_per_cta;
};

inline PairGrid pair_grid(long long per_row, long long batch, long long target) {
  int log2p = 0;
  while ((1LL << log2p) < per_row && (1 << log2p) < kPairThreads) ++log2p;
  const long long p = 1LL << log2p, per_pass = kPairThreads / p;
  const long long gx = (per_row + p - 1) / p;
  const long long passes = (batch + per_pass - 1) / per_pass;
  long long groups = target / gx;
  if (groups > passes) groups = passes;
  if (groups < 1) groups = 1;
  const long long rows = (passes + groups - 1) / groups * per_pass;
  groups = (batch + rows - 1) / rows;
  return {dim3(static_cast<unsigned>(gx), static_cast<unsigned>(groups)), log2p, rows};
}

// CTAs of `kernel` the card holds at once (SMs x resident CTAs per SM).
template <typename K>
cudaError_t pair_target(K kernel, long long* target) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPairThreads, 0);
  *target = static_cast<long long>(sms > 1 ? sms : 1) * (per_sm > 1 ? per_sm : 1);
  return err;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Element offset of p past the last kV-element boundary.
template <typename S>
inline int elem_phase(const void* p, int kv) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) / sizeof(S)) %
                          static_cast<uintptr_t>(kv));
}

template <typename S>
int launch_untangle(const void* z_re, const void* z_im, void* x_re, void* x_im,
                    long long batch, int m, const float* w, float scale,
                    cudaStream_t stream) {
  constexpr int kV = 16 / static_cast<int>(sizeof(S));
  const bool vec = m % kV == 0 && aligned16(z_re) && aligned16(z_im) && aligned16(w) &&
                   aligned16(x_re) && aligned16(x_im);
  auto kernel = vec ? untangle_pairs_kernel<S, true> : untangle_pairs_kernel<S, false>;
  const long long per_row = vec ? (m / kV + 1) / 2 : (m / 2) / kV + 1;
  long long target = 0;
  const cudaError_t err = pair_target(kernel, &target);
  if (err != cudaSuccess) return static_cast<int>(err);
  const PairGrid g = pair_grid(per_row, batch, target);
  kernel<<<g.grid, kPairThreads, 0, stream>>>(
      static_cast<const S*>(z_re), static_cast<const S*>(z_im), static_cast<S*>(x_re),
      static_cast<S*>(x_im), batch, m, w, scale, g.log2p, g.rows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

template <typename Si, typename So>
int launch_retangle(const void* x_re, const void* x_im, void* z_re, void* z_im,
                    long long batch, int m, const float* w, float scale,
                    cudaStream_t stream) {
  constexpr int kV = (sizeof(Si) == 2 || sizeof(So) == 2) ? 8 : 4;
  const int x_off = elem_phase<Si>(x_re, kV);
  const bool vec = m % kV == 0 && aligned16(z_re) && aligned16(z_im) && aligned16(w) &&
                   elem_phase<Si>(x_im, kV) == x_off;
  auto kernel = vec ? retangle_pairs_kernel<Si, So, true>
                    : retangle_pairs_kernel<Si, So, false>;
  const long long per_row = vec ? (m / kV + 1) / 2 : (m / 2) / kV + 1;
  long long target = 0;
  const cudaError_t err = pair_target(kernel, &target);
  if (err != cudaSuccess) return static_cast<int>(err);
  const PairGrid g = pair_grid(per_row, batch, target);
  kernel<<<g.grid, kPairThreads, 0, stream>>>(
      static_cast<const Si*>(x_re), static_cast<const Si*>(x_im), static_cast<So*>(z_re),
      static_cast<So*>(z_im), batch, m, w, scale, g.log2p, g.rows_per_cta, x_off);
  return static_cast<int>(cudaGetLastError());
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wt = static_cast<const float*>(w);
  if (dtype == 0)
    return launch_untangle<__nv_bfloat16>(z_re, z_im, x_re, x_im, batch, m, wt, scale, s);
  if (dtype == 1)
    return launch_untangle<float>(z_re, z_im, x_re, x_im, batch, m, wt, scale, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wt = static_cast<const float*>(w);
#define TFFT_RETANGLE(Si, So) \
  return launch_retangle<Si, So>(x_re, x_im, z_re, z_im, batch, m, wt, scale, s)
  if (in_dtype == 0 && out_dtype == 0) { TFFT_RETANGLE(__nv_bfloat16, __nv_bfloat16); }
  if (in_dtype == 0 && out_dtype == 1) { TFFT_RETANGLE(__nv_bfloat16, float); }
  if (in_dtype == 1 && out_dtype == 0) { TFFT_RETANGLE(float, __nv_bfloat16); }
  if (in_dtype == 1 && out_dtype == 1) { TFFT_RETANGLE(float, float); }
#undef TFFT_RETANGLE
  return static_cast<int>(cudaErrorInvalidValue);
}
