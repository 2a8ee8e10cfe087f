// Shared building blocks of the port's FFT-based kernels: complex helpers,
// small DFTs wholly in registers (radix 2 from a table, 16 with constant
// twiddles, any odd radix in the symmetric form), twiddles from a host-made
// table, a deterministic block sum and windowed sums.
//
// The TPU kernels ran their FFTs as four-step DFT contractions on the MXU,
// with every f32 operand split into bf16 hi/lo halves by hand. Hopper runs
// f32 FMAs at full precision, so here the kernels split each transform into
// passes of at most 32 points, each a radix-2 DFT in registers (dft_reg,
// forward or inverse), with shared memory only to transpose between passes.
// Twiddles come from a table computed in float64 on the host and rounded
// once to f32.
#pragma once

#include <cuda_runtime.h>

// Dynamic shared memory of every kernel (16-byte aligned).
extern __shared__ float4 nis_smem[];

namespace nis {

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

static __device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// tw[k] = exp(-2 pi i k / n), k < n/2; the inverse transform uses conj.
static __device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw,
                                                 int k, bool inverse) {
  float2 w = __ldg(tw + k);
  if (inverse) w.y = -w.y;
  return w;
}

// k with its low `bits` bits reversed, at compile time (the register FFTs'
// output permutation is a renaming of registers).
__host__ __device__ constexpr int bitrev_const(int k, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r = (r << 1) | ((k >> i) & 1);
  return r;
}

__host__ __device__ constexpr int log2_const(int n) {
  return n <= 1 ? 0 : 1 + log2_const(n / 2);
}

// exp(-2 pi i m / n) for 0 <= m < n (the forward transform's twiddle at any
// power), or its conjugate for the inverse transform (INV), from the n-point
// table `tw` (k < n/2).
template <bool INV>
static __device__ __forceinline__ float2 twiddle_pow(
    const float2* __restrict__ tw, int m, int n) {
  const int h = n >> 1;
  float2 w = __ldg(tw + (m < h ? m : m - h));
  if (m >= h) w = make_float2(-w.x, -w.y);
  return INV ? make_float2(w.x, -w.y) : w;
}

// One radix-2 decimation-in-frequency stage of dft_reg (butterflies HALF
// apart), then the stages below it. Every index is a compile-time constant,
// so v stays in registers.
template <bool INV, int R, int HALF>
static __device__ __forceinline__ void dft_reg_stage(
    float2 (&v)[R], const float2* __restrict__ tw, int stride) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int p = i % HALF, lo = (i / HALF) * 2 * HALF + p, hi = lo + HALF;
    const float2 u = v[lo], w = v[hi];
    v[lo] = make_float2(u.x + w.x, u.y + w.y);
    const float2 d = make_float2(u.x - w.x, u.y - w.y);
    v[hi] = p == 0 ? d
                   : cmul(d, twiddle(tw, p * (R / (2 * HALF)) * stride, INV));
  }
  if constexpr (HALF > 1) dft_reg_stage<INV, R, HALF / 2>(v, tw, stride);
}

// Unnormalised DFT of the R points in v (R a power of two, up to 32),
// forward or inverse (INV), natural order in and out, wholly in registers:
// radix-2 decimation in frequency, then the bit-reversal as a compile-time
// renaming. `stride` is n / R for the n-point table `tw`, so W_R^k is
// tw[k * stride]. No barrier.
template <bool INV, int R>
static __device__ __forceinline__ void dft_reg(
    float2 (&v)[R], const float2* __restrict__ tw, int stride) {
  if constexpr (R > 1) {
    dft_reg_stage<INV, R, R / 2>(v, tw, stride);
    constexpr int kLog = log2_const(R);
    float2 t[R];
#pragma unroll
    for (int k = 0; k < R; ++k) t[k] = v[bitrev_const(k, kLog)];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = t[k];
  }
}

// Sum of one value per thread over the block, as a fixed tree: each warp's
// lanes by shuffles, then the warps' sums by warp 0 through `red` (32
// floats). The same association on every run, no atomics. The result is
// valid in thread 0; synchronises on entry, so `red` may be reused.
static __device__ __forceinline__ float block_sum(float* red, float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = (int)threadIdx.x >> 5, lane = (int)threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// Sum of v[i - half .. i + half] clipped to [0, n): a locally windowed sum
// (never a difference of running sums, which float32 cannot afford on power
// maps spanning 80-100 dB).
static __device__ __forceinline__ float window_sum(const float* v, int n,
                                                   int i, int half) {
  const int lo = i - half > 0 ? i - half : 0;
  const int hi = i + half < n - 1 ? i + half : n - 1;
  float s = 0.0f;
  for (int q = lo; q <= hi; ++q) s += v[q];
  return s;
}

// Threads per block for a pass over sequences of n points (a power of two).
static inline int threads_for(int n) {
  return n >= 1024 ? 512 : (n / 2 > 32 ? n / 2 : 32);
}

static inline int log2_of(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// ---- small DFTs of any radix the mixed-radix passes take (K2's
// mixed-radix plan, the factored column pass) ------------------------------

// cos and sin of 2 pi e / 16 rounded to float32: the 16-point DFT's
// twiddles as constants
__host__ __device__ constexpr float cos16(int e) {
  switch (e % 16) {
    case 0: return 1.0f;
    case 1: case 15: return 0.923879533f;
    case 2: case 14: return 0.707106781f;
    case 3: case 13: return 0.382683432f;
    case 4: case 12: return 0.0f;
    case 5: case 11: return -0.382683432f;
    case 6: case 10: return -0.707106781f;
    case 7: case 9: return -0.923879533f;
    default: return -1.0f;
  }
}
__host__ __device__ constexpr float sin16(int e) { return cos16(e + 12); }

// x W_4 of the direction: x (-j) forward, x (+j) inverse
template <bool INV>
__device__ __forceinline__ float2 rot4(float2 x) {
  return INV ? make_float2(-x.y, x.x) : make_float2(x.y, -x.x);
}

// x W_16^E of the direction (E < 16, E != 0)
template <bool INV, int E>
__device__ __forceinline__ float2 rot16(float2 x) {
  if constexpr (E == 4) {
    return rot4<INV>(x);
  } else {
    constexpr float c = cos16(E), s = INV ? sin16(E) : -sin16(E);
    return make_float2(x.x * c - x.y * s, x.x * s + x.y * c);
  }
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2,
                                     float2& x3) {
  const float2 a0 = make_float2(x0.x + x2.x, x0.y + x2.y);
  const float2 a1 = make_float2(x0.x - x2.x, x0.y - x2.y);
  const float2 b0 = make_float2(x1.x + x3.x, x1.y + x3.y);
  const float2 b1 = rot4<INV>(make_float2(x1.x - x3.x, x1.y - x3.y));
  x0 = make_float2(a0.x + b0.x, a0.y + b0.y);
  x2 = make_float2(a0.x - b0.x, a0.y - b0.y);
  x1 = make_float2(a1.x + b1.x, a1.y + b1.y);
  x3 = make_float2(a1.x - b1.x, a1.y - b1.y);
}

// Unnormalised 16-point DFT of u (INV: inverse), natural order in and out,
// as 4 x 4: the 4-point DFTs over n2 of n = n1 + 4 n2, W_16^(n1 k1) as
// constants, the 4-point DFTs over n1, the output k1 + 4 k2 a renaming.
template <bool INV>
__device__ __forceinline__ void dft16(float2 (&u)[16]) {
#pragma unroll
  for (int n1 = 0; n1 < 4; ++n1)
    dft4<INV>(u[n1], u[n1 + 4], u[n1 + 8], u[n1 + 12]);
  u[5] = rot16<INV, 1>(u[5]);
  u[6] = rot16<INV, 2>(u[6]);
  u[7] = rot16<INV, 3>(u[7]);
  u[9] = rot16<INV, 2>(u[9]);
  u[10] = rot16<INV, 4>(u[10]);
  u[11] = rot16<INV, 6>(u[11]);
  u[13] = rot16<INV, 3>(u[13]);
  u[14] = rot16<INV, 6>(u[14]);
  u[15] = rot16<INV, 9>(u[15]);
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1)
    dft4<INV>(u[4 * k1], u[4 * k1 + 1], u[4 * k1 + 2], u[4 * k1 + 3]);
  float2 t[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) t[k] = u[4 * (k % 4) + k / 4];
#pragma unroll
  for (int k = 0; k < 16; ++k) u[k] = t[k];
}

// W_n^m of the direction from the full n-point table (0 <= m < n)
template <bool INV>
__device__ __forceinline__ float2 twf_pow(const float2* __restrict__ twf,
                                          int m) {
  const float2 w = __ldg(twf + m);
  return INV ? make_float2(w.x, -w.y) : w;
}

// The R-point DFT (R odd: a prime, or 9 or 15, which the factored column
// pass's local passes merge) of u, natural order in and out, with
// W_R^q = twf[q n / R]: in the symmetric form, a_m = u_m + u_(R-m) and b_m =
// u_m - u_(R-m) for m <= H = (R - 1) / 2, X_k = u_0 + sum_m a_m cos(2 pi m k /
// R) - j sum_m b_m sin(2 pi m k / R) and X_(R-k) with + j (the signs swapped
// for the inverse).
template <bool INV, int R>
__device__ __forceinline__ void dft_odd(float2 (&u)[R],
                                        const float2* __restrict__ twf,
                                        int n) {
  constexpr int H = (R - 1) / 2;
  float c[H + 1], s[H + 1];              // cos, sin of 2 pi q / R, q <= H
#pragma unroll
  for (int q = 1; q <= H; ++q) {
    const float2 w = __ldg(twf + q * (n / R));
    c[q] = w.x;
    s[q] = -w.y;
  }
  float2 a[H + 1], b[H + 1];
  const float2 x0 = u[0];
  float2 sum = x0;
#pragma unroll
  for (int m = 1; m <= H; ++m) {
    a[m] = make_float2(u[m].x + u[R - m].x, u[m].y + u[R - m].y);
    b[m] = make_float2(u[m].x - u[R - m].x, u[m].y - u[R - m].y);
    sum = make_float2(sum.x + a[m].x, sum.y + a[m].y);
  }
  u[0] = sum;
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 re = x0, im = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int m = 1; m <= H; ++m) {
      const int q = (m * k) % R;   // 0 only for a composite R (9, 15)
      const float cq = q == 0 ? 1.0f : q <= H ? c[q] : c[R - q];
      const float sq = q == 0 ? 0.0f : q <= H ? s[q] : -s[R - q];
      re = make_float2(re.x + a[m].x * cq, re.y + a[m].y * cq);
      im = make_float2(im.x + b[m].x * sq, im.y + b[m].y * sq);
    }
    // -j im for the forward X_k, + j im for X_(R-k)
    const float2 lo = make_float2(re.x + im.y, re.y - im.x);
    const float2 hi = make_float2(re.x - im.y, re.y + im.x);
    u[k] = INV ? hi : lo;
    u[R - k] = INV ? lo : hi;
  }
}

// The R-point DFT of one butterfly of the mixed-radix plan
template <bool INV, int R>
__device__ __forceinline__ void mixed_dft(float2 (&u)[R],
                                          const float2* __restrict__ twf,
                                          int n) {
  if constexpr (R == 16) dft16<INV>(u);
  else if constexpr ((R & (R - 1)) == 0) nis::dft_reg<INV, R>(u, twf, n / R);
  else dft_odd<INV, R>(u, twf, n);
}

// u[k] x W^(m k) of the direction for 0 < k < R from the full table (m k <
// n): W^m and, for R > 4, W^(4 m) loaded, the other powers as products (at
// most five roundings a twiddle, as twiddle_row).
template <bool INV, int R>
__device__ __forceinline__ void mixed_twiddle(float2 (&u)[R],
                                              const float2* __restrict__ twf,
                                              int m) {
  constexpr int A = R < 4 ? R : 4, B = (R + 3) / 4;
  float2 wa[4], wb[4];
  wa[1] = twf_pow<INV>(twf, m);
#pragma unroll
  for (int q = 2; q < A; ++q) wa[q] = nis::cmul(wa[q - 1], wa[1]);
  if constexpr (B > 1) wb[1] = twf_pow<INV>(twf, 4 * m);
#pragma unroll
  for (int q = 2; q < B; ++q) wb[q] = nis::cmul(wb[q - 1], wb[1]);
#pragma unroll
  for (int k = 1; k < R; ++k) {
    const int a = k % 4, b = k / 4;
    const float2 w = b == 0 ? wa[a] : a == 0 ? wb[b] : nis::cmul(wa[a], wb[b]);
    u[k] = nis::cmul(u[k], w);
  }
}

}  // namespace nis
