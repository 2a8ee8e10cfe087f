// Shared building blocks of the port's FFT-based kernels: complex helpers,
// small DFTs wholly in registers, twiddles from a host-made table, a
// deterministic block sum and windowed sums.
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

}  // namespace nis
