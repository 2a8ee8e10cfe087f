// K2: the range pass of CSA focusing, for one channel or both GMTI channels.
//
// Replaces the TPU kernels nis_sar_amtigmti_video_tpu/ops/pallas/csa_kernel.py
// :: _k2_call / _k2_body (one channel, k2_launch) and k2_pair_call /
// _k2g_body (both channels, k2_pair_launch). Per azimuth row a:
//
//   range FFT -> x Phi2 = exp(j (alpha(a) fr + beta(a)) fr)
//             -> range IFFT (1/N) -> x Phi3 = exp(j (rphase(a) + cphase(r)
//                                       + g(a) dr(r) - c3(a) u(r)^2))
//
// What bounds it on the H100: by bytes, one read and one write of the
// planes (2 or 4 x 64 MB each way at 4096^2, 0.080 / 0.160 ms at 3.35
// TB/s); by operations, ~2 x 5 N log2 N flops a row and channel and 2
// accurate sincosf a point, less. What holds it above that
// (scripts/probe_torch_k2_phases.py, SM cycles by phase): the two sincosf
// take about half of a block's cycles, the transforms most of the rest.
//
// The plan (K2Plan<N>, one instantiation per row length N, a power of two
// in [64, 4096]). A thread holds 16 points of a row in registers, v[m] =
// x[tau + T m] (T = N / 16 threads a row, tau < T), so a warp's load of one
// m reads whole 128-byte lines of the real and the imaginary plane (at N <
// 512 a warp spans several rows, and its 16 loads still cover whole lines).
// The N-point DFT splits into passes of at most 16 points, each run in
// registers: R1 x 16 x ... x 16 with R1 = 2^(log2 N mod 4) (16 when that is
// 0): 16 x 16 x 16 at 4096, 8 x 16 x 16 at 2048, 4 x 16 at 64; dft16 (4 x 4,
// constant twiddles) at 16 points, nis::dft_reg below. Each pass is a
// decimation-in-frequency step: it splits the sequence of length L it works
// on as t = s + (L / R) j, takes the R-point DFT over j, multiplies by
// W_L^(s k) (twiddle_row) and leaves R sequences of length L / R, one per
// output digit k. Shared memory only transposes between passes, a buffer
// of 17 N / 16 complex slots a row (pitch L between the wide passes, 17
// before the last, so no two threads of a half-warp meet in a bank): two
// transposes a direction at 4096, one at 256 and below. The thread that
// made the last pass holds X[tau + T m] in v[m], the input's own layout: the
// output digits come out in natural order by the choice of which thread
// takes which item, so Phi2 reads fr[tau + T m] in whole lines and no
// permutation pass exists. The inverse is the same plan on conjugate
// twiddles, from that layout back to x[tau + T m]; 1/N is folded into the
// Phi3 multiply. Barriers: one after each transpose's writes, one before
// each transpose's writes but the forward's first (one buffer): 7 a row at
// 4096, 3 at 256 and below, against the radix-2 design's 24. 256 threads a
// block (4096 / N rows), 34 KB of shared memory, at most 80 registers and
// no spills: three blocks an SM, so one block's loads and stores overlap
// the others' transforms (at four, 64 registers, it spilled and ran 2-5 %
// slower).
//
// The pair is the single on a grid twice as tall: blockIdx.y picks the
// channel, and each block runs the one channel's pass (row_pass) with its
// own trig. So K2 on one channel gives the pair's bits for it by
// construction (the same instructions), and Phi2 / Phi3 are evaluated once
// per channel, by sincosf's accurate routine (no fast math) on the radix-2
// design's argument expressions: Phi2 reaches ~1.1e4 rad at the 600 MHz
// waveform. Evaluating the trig once for the two lost to this in the
// probe, both with each thread holding both channels' points (128
// registers, two blocks an SM) and with the pair's 512 threads split by
// channel and the row's phases staged in shared memory.
//
// Every other row length (any n in [64, 16384] whose prime factors are 2,
// 3, 5, 7, 11 or 13 and that is not a power of two up to 4096; the
// upstream's 13,200 = 16 x 11 x 5 x 5 x 3) runs the mixed-radix plan,
// k2_kernel<0>: one row a block, whole in shared memory (n complex slots,
// 105.6 KB at 13,200: two blocks an SM), 512 threads. The forward
// transform is one in-place pass per radix (ops/cuda/csa_kernel.py::
// mixed_radices, read from a device table: 16s, then the rest of the power
// of two, then the odd primes, largest first), each a
// decimation-in-frequency step like the register plan's: the R points s +
// (L / R) j of each sequence of length L, the R-point DFT over j in
// registers (dft16, nis::dft_reg for 2, 4 and 8, dft_odd for the odd
// primes), x W_L^(s k), written back to the slots they came from. A
// butterfly reads and writes only its own slots, so a pass needs one
// barrier and no second buffer. The spectrum is left in digit-reversed
// order; Phi2 reads fr at each position's frequency (a table of the
// order, ops/cuda/csa_kernel.py::mixed_order), and the inverse runs the
// passes backwards with conjugate twiddles (x conj W first, then the
// inverse DFT), which takes that order back to the natural one: no
// permutation pass. The twiddles come from the full n-point table (n may
// be odd), two loads a butterfly and products for the other powers, as in
// twiddle_row. Phi2 and Phi3 are the register plan's expressions, so the
// two plans differ only in the order of the transforms' sums.
#include "fft_smem.cuh"

namespace {

using nis::dft16;
using nis::mixed_dft;
using nis::mixed_twiddle;

template <int N>
struct K2Plan {
  static constexpr int kLog = nis::log2_const(N);
  // the first pass's radix; every later pass takes 16
  static constexpr int R1 = kLog % 4 ? 1 << (kLog % 4) : 16;
  static constexpr int kPasses = 1 + (kLog - nis::log2_const(R1)) / 4;
  static constexpr int T = N / 16;                // threads a row
  static constexpr int kThreads = 256;
  static constexpr int kRows = kThreads / T;      // rows a block
  static constexpr int kRowSlots = 17 * N / 16;   // a row's buffer, float2
  static constexpr int kSmem = kRows * kRowSlots * (int)sizeof(float2);
  static constexpr int kBlocksPerSm = 3;
  static_assert(N >= 64 && N <= 4096 && (N & (N - 1)) == 0, "");
  // kBlocksPerSm blocks fit an H100 SM: 228 KB of shared memory (1 KB of it
  // the runtime's for each block) and 2,048 threads
  static_assert(kBlocksPerSm * (kSmem + 1024) <= 233472 &&
                kBlocksPerSm * kThreads <= 2048, "");
  // length of the sequences pass p (from 1) transforms, and the pitch of
  // the buffer it reads them from (p >= 2)
  static __host__ __device__ constexpr int len(int p) {
    return p == 1 ? N : (N / R1) >> (4 * (p - 2));
  }
  static __host__ __device__ constexpr int pitch(int p) {
    return p == kPasses ? 17 : len(p);
  }
};

// The mixed-radix plan's block
constexpr int kMixThreads = 512;
constexpr int kMixBlocksPerSm = 2;

struct K2Args {
  const float *x1r, *x1i, *x2r, *x2i;   // x2*, o2*: the pair's second channel
  const float *fr, *alpha, *beta, *cphase, *dr, *usq, *rphase, *g, *c3;
  const float2* tw;                     // exp(-2 pi i k / N), k < N / 2
  float *o1r, *o1i, *o2r, *o2i;
  // the mixed-radix plan (k2_kernel<0>): exp(-2 pi i k / n) for k < n, the
  // forward transform's frequency at each position, the passes' radices in
  // the forward order (npass of them), the row length
  const float2* twf;
  const int* order;
  const int* radix;
  int n, npass;
};

// Threads and blocks an SM of k2_kernel<N>: the register plan's, or the
// mixed-radix plan's for N = 0
template <int N>
struct K2Bounds {
  static constexpr int kThreads = K2Plan<N>::kThreads;
  static constexpr int kBlocks = K2Plan<N>::kBlocksPerSm;
};
template <>
struct K2Bounds<0> {
  static constexpr int kThreads = kMixThreads;
  static constexpr int kBlocks = kMixBlocksPerSm;
};

// The R-point DFT of a pass: the constant-twiddle dft16 at 16 points, the
// table's radix-2 nis::dft_reg below
template <int N, bool INV, int R>
__device__ __forceinline__ void pass_dft(float2 (&u)[R],
                                         const float2* __restrict__ tw) {
  if constexpr (R == 16) dft16<INV>(u);
  else nis::dft_reg<INV, R>(u, tw, N / R);
}

// u[k] x W_N^(m k) of the direction for 0 < k < R, with 4 m < N. With k =
// a + 4 b, W^(m k) = W^(m a) W^(4 m b): two loads of the table
// (nis::twiddle_pow: W^m and W^(4 m)) and products for the other powers, at
// most five roundings a twiddle. A warp's load of W^(m k) spreads over ~2k
// 128-byte lines as m runs over its threads, so loads cost more than the
// products: with six loads a pass the kernel took 11 % longer, with fifteen
// twice as long (timed on the H100 when K2 was redesigned; CHANGES.md).
template <int N, bool INV, int R>
__device__ __forceinline__ void twiddle_row(float2 (&u)[R],
                                            const float2* __restrict__ tw,
                                            int m) {
  constexpr int A = R < 4 ? R : 4, B = R / 4;
  float2 wa[4], wb[4];
  wa[1] = nis::twiddle_pow<INV>(tw, m, N);
#pragma unroll
  for (int a = 2; a < A; ++a) wa[a] = nis::cmul(wa[a - 1], wa[1]);
  if constexpr (B > 1) wb[1] = nis::twiddle_pow<INV>(tw, 4 * m, N);
#pragma unroll
  for (int b = 2; b < B; ++b) wb[b] = nis::cmul(wb[b - 1], wb[1]);
#pragma unroll
  for (int k = 1; k < R; ++k) {
    const int a = k % 4, b = k / 4;
    const float2 w = b == 0 ? wa[a] : a == 0 ? wb[b] : nis::cmul(wa[a], wb[b]);
    u[k] = nis::cmul(u[k], w);
  }
}

// Passes PASS.. (PASS >= 2) of a row's transform: the 16-point DFT of item
// (prefix, s) over j from the buffer (pitch(PASS)); then, before the last
// pass, x W_L^(s k) into the buffer as sequence prefix + Q k; the last pass
// leaves X[tau + T k] in v[k].
template <int N, bool INV, int PASS>
__device__ __forceinline__ void passes_from(float2 (&v)[16], float2* buf,
                                            const float2* __restrict__ tw,
                                            int tau) {
  using P = K2Plan<N>;
  constexpr int L = P::len(PASS), S = L / 16, Q = N / L;
  constexpr int kPitch = P::pitch(PASS);
  const int prefix = tau / S, s = tau % S;
  float2 u[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) u[j] = buf[prefix * kPitch + s + S * j];
  pass_dft<N, INV, 16>(u, tw);
  if constexpr (PASS == P::kPasses) {
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = u[k];
  } else {
    constexpr int kNext = P::pitch(PASS + 1);
    twiddle_row<N, INV, 16>(u, tw, Q * s);
    __syncthreads();  // every thread is past its reads of the buffer
#pragma unroll
    for (int k = 0; k < 16; ++k) buf[(prefix + Q * k) * kNext + s] = u[k];
    __syncthreads();
    passes_from<N, INV, PASS + 1>(v, buf, tw, tau);
  }
}

// The N-point DFT (forward, or inverse unnormalised: INV) of the row whose
// points x[tau + T m] this thread and its T - 1 neighbours hold in v[m];
// leaves X[tau + T m] in v[m]. Pass 1 takes the thread's 16 / R1 items s =
// tau + T i, whose points s + (N / R1) j are v[i + (16 / R1) j]. The
// inverse follows the forward's reads of the buffer, so it waits first.
template <int N, bool INV>
__device__ __forceinline__ void transform(float2 (&v)[16], float2* buf,
                                          const float2* __restrict__ tw,
                                          int tau) {
  using P = K2Plan<N>;
  constexpr int R = P::R1, G = 16 / R, kPitch = P::pitch(2);
  if constexpr (INV) __syncthreads();
#pragma unroll
  for (int i = 0; i < G; ++i) {
    float2 u[R];
#pragma unroll
    for (int j = 0; j < R; ++j) u[j] = v[i + G * j];
    pass_dft<N, INV, R>(u, tw);
    const int s = tau + P::T * i;
    twiddle_row<N, INV, R>(u, tw, s);
#pragma unroll
    for (int k = 0; k < R; ++k) buf[k * kPitch + s] = u[k];
  }
  __syncthreads();
  passes_from<N, INV, 2>(v, buf, tw, tau);
}

// A row's pass from its points v[m] = x[tau + T m] (this thread's) to its
// output: forward transform, x Phi2, inverse transform, x Phi3 / N, stores
// to o_re / o_im at row n + tau + T m. The one channel's arithmetic, the
// same instructions for each channel of the pair.
template <int N>
__device__ __forceinline__ void row_pass(float2 (&v)[16], float2* buf,
                                         const K2Args& a, int row, int tau,
                                         float* o_re, float* o_im) {
  constexpr int T = K2Plan<N>::T;
  transform<N, false>(v, buf, a.tw, tau);

  const float al = a.alpha[row];
  const float be = a.beta[row];
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const float f = __ldg(a.fr + tau + T * m);
    float sn, cs;
    sincosf((al * f + be) * f, &sn, &cs);
    v[m] = nis::cmul(v[m], make_float2(cs, sn));
  }
  transform<N, true>(v, buf, a.tw, tau);

  const float rp = a.rphase[row];
  const float gg = a.g[row];
  const float cc = a.c3[row];
  const float inv_n = 1.0f / (float)N;
  const size_t at = (size_t)row * N + tau;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int i = tau + T * m;
    float sn, cs;
    sincosf(rp + __ldg(a.cphase + i) + gg * __ldg(a.dr + i) -
                cc * __ldg(a.usq + i),
            &sn, &cs);
    const float2 y = nis::cmul(nis::cscale(v[m], inv_n), make_float2(cs, sn));
    __stcs(o_re + at + T * m, y.x);
    __stcs(o_im + at + T * m, y.y);
  }
}

// ---- the mixed-radix plan ---------------------------------------------

// One pass of radix R over the row in buf, whose sequences have length
// len: butterfly (block, s) holds the R slots block len + s + (len / R) j.
// Forward: the DFT over j, x W_len^(s k), back to slot k. Inverse: x conj
// W_len^(s k), the inverse DFT, back in place. Ends with a block barrier.
template <bool INV, int R>
__device__ void mixed_pass(float2* buf, const float2* __restrict__ twf,
                           int n, int len) {
  const int sl = len / R, stride = n / len;
  for (int b = threadIdx.x; b < n / R; b += blockDim.x) {
    const int blk = b / sl, s = b - blk * sl;
    float2* p = buf + blk * len + s;
    float2 u[R];
#pragma unroll
    for (int j = 0; j < R; ++j) u[j] = p[j * sl];
    if constexpr (INV) {
      if (s) mixed_twiddle<true, R>(u, twf, s * stride);
      mixed_dft<true, R>(u, twf, n);
    } else {
      mixed_dft<false, R>(u, twf, n);
      if (s) mixed_twiddle<false, R>(u, twf, s * stride);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) p[j * sl] = u[j];
  }
  __syncthreads();
}

template <bool INV>
__device__ void mixed_pass_of(int r, float2* buf,
                              const float2* __restrict__ twf, int n,
                              int len) {
  switch (r) {
    case 16: mixed_pass<INV, 16>(buf, twf, n, len); break;
    case 8: mixed_pass<INV, 8>(buf, twf, n, len); break;
    case 4: mixed_pass<INV, 4>(buf, twf, n, len); break;
    case 2: mixed_pass<INV, 2>(buf, twf, n, len); break;
    case 13: mixed_pass<INV, 13>(buf, twf, n, len); break;
    case 11: mixed_pass<INV, 11>(buf, twf, n, len); break;
    case 7: mixed_pass<INV, 7>(buf, twf, n, len); break;
    case 5: mixed_pass<INV, 5>(buf, twf, n, len); break;
    default: mixed_pass<INV, 3>(buf, twf, n, len); break;
  }
}

// The row's transform in buf: forward, natural order -> the plan's order;
// or inverse (unnormalised), back to the natural order.
template <bool INV>
__device__ void mixed_transform(float2* buf, const K2Args& a) {
  if constexpr (!INV) {
    int len = a.n;
    for (int p = 0; p < a.npass; ++p) {
      const int r = __ldg(a.radix + p);
      mixed_pass_of<false>(r, buf, a.twf, a.n, len);
      len /= r;
    }
  } else {
    int len = __ldg(a.radix + a.npass - 1);
    for (int p = a.npass - 1; p >= 0; --p) {
      mixed_pass_of<true>(__ldg(a.radix + p), buf, a.twf, a.n, len);
      if (p > 0) len *= __ldg(a.radix + p - 1);
    }
  }
}

// A row of the mixed-radix plan (one block): loads, forward transform, x
// Phi2 at each position's frequency, inverse transform, x Phi3 / n,
// stores. The same Phi2 and Phi3 expressions as row_pass.
__device__ __forceinline__ void mixed_row(const K2Args& a, const float* xr,
                                          const float* xi, float* o_re,
                                          float* o_im) {
  const int n = a.n, row = (int)blockIdx.x;
  float2* buf = reinterpret_cast<float2*>(nis_smem);
  const size_t at = (size_t)row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    buf[i] = make_float2(__ldcs(xr + at + i), __ldcs(xi + at + i));
  __syncthreads();
  mixed_transform<false>(buf, a);
  const float al = a.alpha[row];
  const float be = a.beta[row];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float f = __ldg(a.fr + __ldg(a.order + i));
    float sn, cs;
    sincosf((al * f + be) * f, &sn, &cs);
    buf[i] = nis::cmul(buf[i], make_float2(cs, sn));
  }
  __syncthreads();
  mixed_transform<true>(buf, a);
  const float rp = a.rphase[row];
  const float gg = a.g[row];
  const float cc = a.c3[row];
  const float inv_n = 1.0f / (float)n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float sn, cs;
    sincosf(rp + __ldg(a.cphase + i) + gg * __ldg(a.dr + i) -
                cc * __ldg(a.usq + i),
            &sn, &cs);
    const float2 y = nis::cmul(nis::cscale(buf[i], inv_n), make_float2(cs, sn));
    __stcs(o_re + at + i, y.x);
    __stcs(o_im + at + i, y.y);
  }
}

// One block: K2Plan<N>::kRows rows of channel blockIdx.y (0: x1 -> o1, 1: x2
// -> o2), T threads a row; for N = 0 one row of the mixed-radix plan.
template <int N>
__global__ void __launch_bounds__(K2Bounds<N>::kThreads,
                                  K2Bounds<N>::kBlocks)
    k2_kernel(K2Args a) {
  const bool second = blockIdx.y != 0;
  const float* xr = second ? a.x2r : a.x1r;
  const float* xi = second ? a.x2i : a.x1i;
  if constexpr (N == 0) {
    mixed_row(a, xr, xi, second ? a.o2r : a.o1r, second ? a.o2i : a.o1i);
  } else {
    using P = K2Plan<N>;
    constexpr int T = P::T;
    const int tid = (int)threadIdx.x, tau = tid % T;
    const int row = (int)blockIdx.x * P::kRows + tid / T;
    const size_t at = (size_t)row * N + tau;
    float2 v[16];
#pragma unroll
    for (int m = 0; m < 16; ++m)
      v[m] = make_float2(__ldcs(xr + at + T * m), __ldcs(xi + at + T * m));
    row_pass<N>(v,
                reinterpret_cast<float2*>(nis_smem) + (tid / T) * P::kRowSlots,
                a, row, tau, second ? a.o2r : a.o1r, second ? a.o2i : a.o1i);
  }
}

// K2 on the mixed-radix plan: one block a row and channel, n complex slots
// of shared memory (the rest of the SM's 256 KB stays L1).
static int k2_mixed_run(K2Args a, int n_az, int n_rg, int npass, int nch,
                        void* stream) {
  if (npass < 1) return (int)cudaErrorInvalidValue;
  a.n = n_rg;
  a.npass = npass;
  const int smem = n_rg * (int)sizeof(float2);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k2_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 233472 / (smem + 1024);
  per_sm = per_sm < kMixBlocksPerSm ? per_sm : kMixBlocksPerSm;
  err = cudaFuncSetAttribute(
      k2_kernel<0>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (per_sm * (smem + 1024) * 100 + 233471) / 233472);
  if (err != cudaSuccess) return (int)err;
  k2_kernel<0><<<dim3(n_az, nch), kMixThreads, smem,
                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int N>
int k2_run(const K2Args& a, int n_az, int nch, void* stream) {
  using P = K2Plan<N>;
  if (n_az % P::kRows != 0) return (int)cudaErrorInvalidValue;
  // room for kBlocksPerSm blocks; the rest of the SM's 256 KB stays L1
  const int carveout =
      (P::kBlocksPerSm * (P::kSmem + 1024) * 100 + 233471) / 233472;
  cudaError_t err = cudaFuncSetAttribute(
      k2_kernel<N>, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  if (err != cudaSuccess) return (int)err;
  k2_kernel<N><<<dim3(n_az / P::kRows, nch), P::kThreads, P::kSmem,
                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int k2_dispatch(const K2Args& a, int n_az, int n_rg, int nch, void* stream) {
  switch (n_rg) {
    case 64: return k2_run<64>(a, n_az, nch, stream);
    case 128: return k2_run<128>(a, n_az, nch, stream);
    case 256: return k2_run<256>(a, n_az, nch, stream);
    case 512: return k2_run<512>(a, n_az, nch, stream);
    case 1024: return k2_run<1024>(a, n_az, nch, stream);
    case 2048: return k2_run<2048>(a, n_az, nch, stream);
    case 4096: return k2_run<4096>(a, n_az, nch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch K2 pair / K2 over (n_az, n_rg) planes on `stream`
// (ops/cuda/csa_kernel.py::RangePlan). With passes == 0, the register plan:
// n_rg a power of two in [64, 4096], n_az a multiple of 4096 / n_rg, `tw`
// the half table, `order` and `radix` null. Else the mixed-radix plan: n_rg
// in [64, 16384] with prime factors 2, 3, 5, 7, 11, 13, `tw` the full n_rg-
// point table, `order` the forward transform's frequency at each position,
// `radix` the plan's `passes` radices in the forward order. Each returns
// cudaGetLastError() after the launch.
static int k2_plan_run(K2Args a, const int* order, const int* radix,
                       int n_az, int n_rg, int passes, int nch,
                       void* stream) {
  if (passes == 0) return k2_dispatch(a, n_az, n_rg, nch, stream);
  a.twf = a.tw;
  a.tw = nullptr;
  a.order = order;
  a.radix = radix;
  return k2_mixed_run(a, n_az, n_rg, passes, nch, stream);
}

extern "C" int k2_pair_launch(
    const float* x1r, const float* x1i, const float* x2r, const float* x2i,
    const float* fr, const float* alpha, const float* beta,
    const float* cphase, const float* dr, const float* usq,
    const float* rphase, const float* g, const float* c3, const float2* tw,
    const int* order, const int* radix, float* o1r, float* o1i, float* o2r,
    float* o2i, int n_az, int n_rg, int passes, void* stream) {
  const K2Args a{x1r, x1i, x2r, x2i, fr,  alpha, beta, cphase, dr,
                 usq, rphase, g, c3, tw,  o1r,   o1i,  o2r,    o2i};
  return k2_plan_run(a, order, radix, n_az, n_rg, passes, 2, stream);
}

extern "C" int k2_launch(
    const float* xr, const float* xi, const float* fr, const float* alpha,
    const float* beta, const float* cphase, const float* dr,
    const float* usq, const float* rphase, const float* g, const float* c3,
    const float2* tw, const int* order, const int* radix, float* o_re,
    float* o_im, int n_az, int n_rg, int passes, void* stream) {
  const K2Args a{xr,  xi,     nullptr, nullptr, fr,   alpha,   beta,
                 cphase, dr, usq,     rphase,  g,    c3,      tw,
                 o_re, o_im, nullptr, nullptr};
  return k2_plan_run(a, order, radix, n_az, n_rg, passes, 1, stream);
}

// Message of a CUDA error code returned by a launcher.
extern "C" const char* nis_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
