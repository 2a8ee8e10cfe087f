// The fast-BP recentre kernels: forward spectra, recentre from spectra, and
// the fused recentre + presum; and the NUFFT echo's FFT convolution.
//
// Replaces the TPU kernels of nis_sar_amtigmti_video_tpu/ops/pallas/
// fft_kernel.py: forward_spectra_pallas (_kernel_fwd),
// recentre_from_spectra_pallas (_kernel_inv), recenter_presum_pallas
// (_kernel, and its lane-batched twin _kernel_wide) and fft_conv_pallas
// (the same _kernel with zero ramp and carrier and no presum). Per pulse, an
// nfft-point transform of the zero-padded pulse times the conjugate
// reference-chirp spectrum; per presum group of d pulses, the sum of the
// spectra times each pulse's recentre ramp and carrier, divided by d, and
// one band-limited inverse transform. The conv (fft_conv_kernel, one
// cluster per row of the echo's impulse field, read as float32 real and
// imaginary planes through a row stride): ifft(fft(row, nfft) x filter) cut
// to the band rows [p0, p1); at the NUFFT echo's full-scale chunk (512 rows
// of 50,420 samples, nfft 65,536, 207 band rows) it moves ~315 MB, 0.094 ms
// at 3.35 TB/s.
//
// The plan (Fwd<B1, R>, every kernel). Each nfft-point transform is a
// four-step split N = 128 x B1 (B1 = nfft / 128):
//   input  n = n1 + 128 n2   (n1 < 128, n2 < B1)
//   output f = k2 + B1 k1    (k2 < B1,  k1 < 128)
//   X[f] = sum_n1 W128^(k1 n1) WN^(k2 n1) sum_n2 x[n1 + 128 n2] WB1^(k2 n2)
// on a thread-block cluster of CS = B1 / R blocks (a pulse, a row or a
// presum group each): block r owns the k2 rows [r R, r R + R) and the
// columns n1 in [r C, r C + C), C = 128 / CS, 16 points a thread, T = 8 R
// threads. Every DFT runs in registers (nis::dft_reg): the B1-point columns
// split as A x 16 (n2 = a + A b, k2 = kb + 16 ka, A = B1 / 16), the
// 128-point rows as 8 x 16 (n1 = a' + 8 b', k1 = kb' + 16 ka'), so the rows
// leave k1 in natural order and a warp's loads and stores of a spectrum are
// whole 128-byte lines. Shared memory only transposes between the halves of
// a transform, and one cluster exchange (a DSMEM push to the owner of each
// row k2) joins the column and row halves. The inverse runs the same plan
// backwards: the rows' inverse DFTs, a push back to the owner of each column
// n1, the columns' inverse DFTs, and only the band rows n2 in [p0, p1)
// stored. No kernel has a scratch buffer in device memory.
//
// Forward spectra (forward_spectra_kernel): 32 rows a block at nfft 16,384
// and 32,768 (clusters of 4 and 8, 256 threads, 34 KB of shared memory, four
// blocks an SM, so one block's loads and stores overlap the others'
// transforms), the filter read in the spectra's order. The conv runs the
// same forward steps (its own copy of them: sharing forward spectra's text
// changed forward spectra's SASS) and then the inverse, two blocks of 512
// threads an SM at nfft 65,536.
//
// The recentre kernels (recenter_presum_kernel, recentre_spectra_kernel)
// run a presum group on one cluster of the same plan. The fused kernel runs
// forward spectra's steps for each of the group's d pulses; then, where
// forward spectra stores, each thread multiplies its 16 points (r, kb', ka')
// by the pulse's recentre ramp and adds them to its accumulator. Recentre
// from spectra reads the same 16 points of each stored spectrum (k1 natural,
// as forward spectra wrote them: whole 128-byte lines a warp). The d pulses
// go in a fixed order into a zeroed accumulator, with no atomics, so a
// group's rows do not depend on which cluster served it, nor on the pulses
// of other groups. After the group: the filter (fused kernel: it is the same
// for every pulse, so it multiplies the sum once), the conv's inverse, and
// the band rows stored / nfft. What bounds them on the H100: by bytes, the
// fused kernel reads the raw pulses and writes the band rows (~0.45 GB, 0.13
// ms at 3.35 TB/s at the reference shape: P 2,500, ns 22,004, nfft 32,768,
// d 4, 15 band rows); recentre from spectra reads 655 MB of spectra (0.20
// ms). The fused kernel does forward spectra's transforms without its 655
// MB of stores, so its time is that of the transforms and their barriers,
// at three blocks an SM where forward spectra runs four: the accumulator
// (32 KB a block) takes the room of the fourth
// (scripts/probe_torch_fft_phases.py times each phase and the variants).
//
// The ramp, factored. exp(j (2 pi / N ((f si) mod N + f_signed sf) + car))
// with f = k2 + B1 k1 and f_signed = f - N [k1 >= 64] is E2[k2] E1[k1]:
//   E2[k2] = exp(j 2 pi / N ((k2 si) mod N + k2 sf))
//   E1[k1] = exp(j (2 pi / N ((B1 k1 si) mod N + (B1 k1 - N [k1 >= 64]) sf)
//                   + car))
// Per pulse a block builds its R values of E2 and the 128 of E1 (with 1 / d
// folded in) into shared memory, one thread a value: each of those R + 128
// threads forms the pulse's shift and carrier from the float64 trajectory
// itself (pulse_scalars), splits the shift into si = round(shift) mod nfft
// and sf = shift - round(shift) and wraps the carrier mod 2 pi, then makes
// one accurate sincosf (no fast math): R + 128 calls a block where a
// per-point ramp would take 16 T, and no launch or barrier of their own.
// Each phase is formed from the low bits of an integer product, so it stays
// within a few rad and keeps f32 rounding.
#include <cooperative_groups.h>

#include "fft_smem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kTwoPi = 6.283185307179586f;

struct Tables {
  const float2* tw_n;     // [WN^b, b < 256 | WN^(256 a), a < nfft / 256]
  const float2* tw_b1;    // exp(-2 pi i k / B1),   k < B1 / 2
  const float2* tw_128;   // exp(-2 pi i k / 128),  k < 64
};

// WN^m = exp(-2 pi i m / nfft), 0 <= m < nfft, as WN^(m mod 256) x
// WN^(256 floor(m / 256)): two small tables that stay in L1, where one
// nfft-point table (128 KB at 32,768) would not.
__device__ __forceinline__ float2 tw_full(const float2* __restrict__ tw_n,
                                          int m) {
  return nis::cmul(__ldg(tw_n + (m & 255)), __ldg(tw_n + 256 + (m >> 8)));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 shfl_xor(float2 v, int mask) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, mask),
                     __shfl_xor_sync(0xffffffffu, v.y, mask));
}

// Forward spectra. A cluster of CS = B1 / R blocks per pulse; block r owns
// the k2 rows [r R, r R + R) and the columns n1 in [r C, r C + C), C =
// 128 / CS: P = 128 R points, 16 a thread, T = 8 R threads. Every DFT runs
// in registers (nis::dft_reg); shared memory only transposes between the two
// halves of each transform, so a block makes three barriers and one cluster
// exchange a pulse. The B1-point columns split as B1 = A x 16 (n2 = a + A b,
// k2 = kb + 16 ka), the 128-point rows as 8 x 16 (n1 = a' + 8 b', k1 = kb' +
// 16 ka'), so the rows leave k1 in natural order and each warp store writes
// two whole 128-byte lines. One buffer of kFwdPitch-point rows serves the
// column transpose, the rows a block receives and the row transpose.
// the rows' pitch in points: a warp's reads of 4 rows x 8 points take two
// bank wavefronts, the least for 256 bytes
constexpr int kFwdPitch = 136;

template <int B1, int R>
struct Fwd {
  static constexpr int CS = B1 / R, C = 128 / CS, T = 8 * R;
  static constexpr int A = B1 / 16;
  static constexpr int kRowT = 8 * R + 1;      // row transpose: odd pitch
  static constexpr int kSmem = R * kFwdPitch * (int)sizeof(float2);
  // blocks an SM holds: 4 at 256 threads (64 registers, no spills), 1 at
  // 512
  static constexpr int kBlocksPerSm = T == 256 ? 4 : 1;
  // the buffer holds the column transpose ([a][kb][c]), the received rows
  // and the row transpose
  static_assert(C * B1 <= R * kFwdPitch && 16 * kRowT <= R * kFwdPitch, "");
  // kBlocksPerSm blocks fit an H100 SM: 228 KB of shared memory (1 KB of it
  // the runtime's for each block) and 2,048 threads
  static_assert(kBlocksPerSm * (kSmem + 1024) <= 233472 &&
                kBlocksPerSm * T <= 2048, "");
};

// The cluster barrier in two halves: arrive (releasing this thread's shared
// memory reads and writes) and wait (acquiring the others').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// v[j] = X[c][kb + 16 (j-th ka this thread holds)] x WN^(k2 n1) into row
// k2 % R, column n1 of the block that owns k2.
template <int B1, int R, int N>
__device__ __forceinline__ void push_column(cg::cluster_group& cluster,
                                            float2* buf, const float2 (&v)[N],
                                            int n1, int kb, int ka0,
                                            int ka_step,
                                            const float2* __restrict__ tw_n) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int k2 = kb + 16 * (ka0 + ka_step * j);
    float2* dst = cluster.map_shared_rank(buf, k2 / R);
    dst[(k2 % R) * kFwdPitch + n1] = nis::cmul(v[j], tw_full(tw_n, k2 * n1));
  }
}

template <int B1, int R>
__global__ void __launch_bounds__(Fwd<B1, R>::T, Fwd<B1, R>::kBlocksPerSm)
    forward_spectra_kernel(const float2* __restrict__ x,
                           const float2* __restrict__ filt, Tables t,
                           float2* __restrict__ out, int ns) {
  using F = Fwd<B1, R>;
  constexpr int C = F::C, A = F::A, T = F::T;
  cg::cluster_group cluster = cg::this_cluster();
  float2* buf = reinterpret_cast<float2*>(nis_smem);
  const int tid = (int)threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int pulse = blockIdx.x / F::CS;
  const int c0 = rank * C;
  const float2* xp = x + (size_t)pulse * ns;

  // Columns, first half: thread (c, a) loads n2 = a + A b, b < 16 (a warp
  // reads whole 128-byte segments), the 16-point DFT over b, WB1^(a kb).
  {
    const int c = tid % C, a = tid / C;
    float2 v[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int n = c0 + c + 128 * (a + A * b);
      v[b] = n < ns ? __ldcs(xp + n) : make_float2(0.f, 0.f);
    }
    nis::dft_reg<false, 16>(v, t.tw_b1, A);
#pragma unroll
    for (int kb = 1; kb < 16; ++kb)
      v[kb] = nis::cmul(v[kb], nis::twiddle_pow<false>(t.tw_b1, a * kb, B1));
#pragma unroll
    for (int kb = 0; kb < 16; ++kb) buf[(a * 16 + kb) * C + c] = v[kb];
  }
  __syncthreads();

  // Columns, second half: the A-point DFT over a of each (c, kb), then each
  // X[c][k2] x WN^(k2 n1) goes to the block that owns row k2 (a DSMEM
  // store), once every block of the cluster is past its reads of `buf`.
  if constexpr (A <= 16) {
    constexpr int kItems = 16 / A;
    float2 w[kItems][A];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = tid + i * T, c = j % C, kb = j / C;
#pragma unroll
      for (int a = 0; a < A; ++a) w[i][a] = buf[(a * 16 + kb) * C + c];
    }
    cluster_arrive();
#pragma unroll
    for (int i = 0; i < kItems; ++i) nis::dft_reg<false, A>(w[i], t.tw_b1, 16);
    cluster_wait();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = tid + i * T;
      push_column<B1, R>(cluster, buf, w[i], c0 + j % C, j / C, 0, 1, t.tw_n);
    }
  } else {
    // A = 32: a lane pair per (c, kb), lane h holding a = 16 h + n; one
    // radix-2 step across the pair leaves lane h the 16-point DFT of
    // ka = 2 k + h
    static_assert(A == 32, "");
    const int h = tid & 1, item = tid >> 1, c = item % C, kb = item / C;
    float2 u[16];
#pragma unroll
    for (int n = 0; n < 16; ++n) u[n] = buf[((h * 16 + n) * 16 + kb) * C + c];
    cluster_arrive();
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float2 o = shfl_xor(u[n], 1);
      u[n] = h == 0 ? cadd(u[n], o)
                    : nis::cmul(make_float2(o.x - u[n].x, o.y - u[n].y),
                                nis::twiddle_pow<false>(t.tw_b1, 16 * n, B1));
    }
    nis::dft_reg<false, 16>(u, t.tw_b1, 32);
    cluster_wait();
    push_column<B1, R>(cluster, buf, u, c0 + c, kb, h, 2, t.tw_n);
  }
  cluster.sync();

  // Rows, first half: thread (r, a') the 16-point DFT over b' of n1 = a' +
  // 8 b', W128^(a' kb'), into the row transpose.
  {
    const int r = tid / 8, a = tid % 8;
    float2 v[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) v[b] = buf[r * kFwdPitch + a + 8 * b];
    nis::dft_reg<false, 16>(v, t.tw_128, 8);
#pragma unroll
    for (int kb = 1; kb < 16; ++kb)
      v[kb] = nis::cmul(v[kb], nis::twiddle_pow<false>(t.tw_128, a * kb, 128));
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < 16; ++kb) buf[kb * F::kRowT + r * 8 + a] = v[kb];
  }
  __syncthreads();

  // Rows, second half: the 8-point DFT over a' of each (r, kb'), times the
  // filter, k1 = kb' + 16 ka' in natural order.
  const int k2_0 = rank * R;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = tid + i * T, kb = j % 16, r = j / 16;
    float2 w[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) w[a] = buf[kb * F::kRowT + r * 8 + a];
    nis::dft_reg<false, 8>(w, t.tw_128, 16);
    const size_t row = (size_t)(k2_0 + r) * 128 + kb;
    const float2* f = filt + row;
    float2* o = out + (size_t)pulse * (B1 * 128) + row;
#pragma unroll
    for (int ka = 0; ka < 8; ++ka)
      __stcs(o + 16 * ka, nis::cmul(w[ka], __ldg(f + 16 * ka)));
  }
}

// The conv's forward transform on forward spectra's plan (Fwd<B1, R>), the
// same arithmetic as forward_spectra_kernel's steps. Forward spectra keeps
// its own copy: calling these from it changed its SASS
// (scripts/probe_torch_echo_phases.py compares it with an earlier
// commit's). The text here differs from that copy where
// scripts/probe_torch_fft_phases.py anchors its marks (the buffer's name,
// the barriers' comments), so those anchors stay forward spectra's alone.
//
// The columns' second half: with the first half's 16-point DFTs over b in
// `sm` as [a][kb][c], the A-point DFT over a of each (c, kb). After it (a
// cluster barrier) row k2 % R of the block that owns k2 (pitch kFwdPitch)
// holds X1[k2][n1] x WN^(k2 n1) for every n1.
template <int B1, int R>
__device__ __forceinline__ void columns_second_half(
    cg::cluster_group& cluster, float2* sm, const Tables& t) {
  using F = Fwd<B1, R>;
  constexpr int C = F::C, A = F::A, T = F::T;
  const int tid = (int)threadIdx.x;
  const int c0 = (int)cluster.block_rank() * C;

  // Columns, second half: the A-point DFT over a of each (c, kb), then each
  // X[c][k2] x WN^(k2 n1) goes to the block that owns row k2 (a DSMEM
  // store), once every block of the cluster is past its reads of `sm`.
  if constexpr (A <= 16) {
    constexpr int kItems = 16 / A;
    float2 w[kItems][A];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = tid + i * T, c = j % C, kb = j / C;
#pragma unroll
      for (int a = 0; a < A; ++a) w[i][a] = sm[(a * 16 + kb) * C + c];
    }
    cluster_arrive();
#pragma unroll
    for (int i = 0; i < kItems; ++i) nis::dft_reg<false, A>(w[i], t.tw_b1, 16);
    cluster_wait();  // every block is past its reads
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = tid + i * T;
      push_column<B1, R>(cluster, sm, w[i], c0 + j % C, j / C, 0, 1, t.tw_n);
    }
  } else {
    // A = 32: a lane pair per (c, kb), lane h holding a = 16 h + n; one
    // radix-2 step across the pair leaves lane h the 16-point DFT of
    // ka = 2 k + h
    static_assert(A == 32, "");
    const int h = tid & 1, item = tid >> 1, c = item % C, kb = item / C;
    float2 u[16];
#pragma unroll
    for (int n = 0; n < 16; ++n) u[n] = sm[((h * 16 + n) * 16 + kb) * C + c];
    cluster_arrive();
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float2 o = shfl_xor(u[n], 1);
      u[n] = h == 0 ? cadd(u[n], o)
                    : nis::cmul(make_float2(o.x - u[n].x, o.y - u[n].y),
                                nis::twiddle_pow<false>(t.tw_b1, 16 * n, B1));
    }
    nis::dft_reg<false, 16>(u, t.tw_b1, 32);
    cluster_wait();  // every block is past its reads
    push_column<B1, R>(cluster, sm, u, c0 + c, kb, h, 2, t.tw_n);
  }
  cluster.sync();  // this block's rows are in
}

// The rows' first half. Ends with a block barrier; then sm[kb' * kRowT +
// r * 8 + a'] holds row r's point (a', kb').
template <int B1, int R>
__device__ __forceinline__ void rows_first_half(float2* sm,
                                                const Tables& t) {
  using F = Fwd<B1, R>;
  const int tid = (int)threadIdx.x;

  // Rows, first half: thread (r, a') the 16-point DFT over b' of n1 = a' +
  // 8 b', W128^(a' kb'), into the row transpose.
  {
    const int r = tid / 8, a = tid % 8;
    float2 v[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) v[b] = sm[r * kFwdPitch + a + 8 * b];
    nis::dft_reg<false, 16>(v, t.tw_128, 8);
#pragma unroll
    for (int kb = 1; kb < 16; ++kb)
      v[kb] = nis::cmul(v[kb], nis::twiddle_pow<false>(t.tw_128, a * kb, 128));
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < 16; ++kb) sm[kb * F::kRowT + r * 8 + a] = v[kb];
  }
  __syncthreads();
}

// The FFT conv's plan: Fwd<B1, R>'s clusters, blocks and buffer, with two
// blocks of 512 threads an SM at nfft 65,536 (so one block's loads and
// stores overlap the other's transforms) and four of 256 below.
template <int B1, int R>
struct Conv {
  static constexpr int kBlocksPerSm = Fwd<B1, R>::T == 256 ? 4 : 2;
  static_assert(kBlocksPerSm * (Fwd<B1, R>::kSmem + 1024) <= 233472 &&
                kBlocksPerSm * Fwd<B1, R>::T <= 2048, "");
};

// The FFT conv, one cluster a row: the forward transform on forward
// spectra's plan (its columns' first half on the two planes through their
// row strides, columns_second_half, rows_first_half); per (r, kb') the rows'
// 8-point DFT, the filter, the inverse 8-point DFT, all in registers; the
// rows' inverse 16-point DFTs; each Y[k2][n1] x conj WN^(k2 n1) pushed to
// the block that owns column n1; the columns' inverse DFTs (A-point over
// ka, 16-point over kb); the band rows n2 in [p0, p1) stored, / nfft.
template <int B1, int R>
__global__ void __launch_bounds__(Fwd<B1, R>::T, Conv<B1, R>::kBlocksPerSm)
    fft_conv_kernel(const float* __restrict__ xr,
                    const float* __restrict__ xi,
                    const float2* __restrict__ filt, Tables t,
                    float2* __restrict__ out, int ns, int ld_r, int ld_i,
                    int p0, int p1) {
  using F = Fwd<B1, R>;
  constexpr int C = F::C, A = F::A, T = F::T;
  cg::cluster_group cluster = cg::this_cluster();
  float2* buf = reinterpret_cast<float2*>(nis_smem);
  const int tid = (int)threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / F::CS;
  const float* re = xr + (size_t)row * ld_r;
  const float* im = xi + (size_t)row * ld_i;

  // Columns, first half, as forward spectra's: thread (c, a) reads n2 = a +
  // A b of both planes, the 16-point DFT over b, WB1^(a kb), into
  // [a][kb][c]
  {
    const int c = tid % C, a = tid / C, n0 = rank * C + c + 128 * a;
    float2 v[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int n = n0 + 128 * A * b;
      v[b] = n < ns ? make_float2(__ldcs(re + n), __ldcs(im + n))
                    : make_float2(0.f, 0.f);
    }
    nis::dft_reg<false, 16>(v, t.tw_b1, A);
    float2* col = buf + a * 16 * C + c;
#pragma unroll
    for (int kb = 0; kb < 16; ++kb)
      col[kb * C] = kb == 0 ? v[0]
                            : nis::cmul(v[kb], nis::twiddle_pow<false>(
                                                   t.tw_b1, a * kb, B1));
  }
  __syncthreads();
  columns_second_half<B1, R>(cluster, buf, t);
  rows_first_half<B1, R>(buf, t);

  // Rows, second half and back: per (r, kb') the 8-point DFT over a', the
  // filter at k1 = kb' + 16 ka', the inverse 8-point DFT over ka' and conj
  // W128^(a' kb'), in place.
  const int k2_0 = rank * R;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = tid + i * T, kb = j % 16, r = j / 16;
    float2* p = buf + kb * F::kRowT + r * 8;
    float2 w[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) w[a] = p[a];
    nis::dft_reg<false, 8>(w, t.tw_128, 16);
    const float2* f = filt + (size_t)(k2_0 + r) * 128 + kb;
#pragma unroll
    for (int ka = 0; ka < 8; ++ka)
      w[ka] = nis::cmul(w[ka], __ldg(f + 16 * ka));
    nis::dft_reg<true, 8>(w, t.tw_128, 16);
#pragma unroll
    for (int a = 1; a < 8; ++a)
      w[a] = nis::cmul(w[a], nis::twiddle_pow<true>(t.tw_128, a * kb, 128));
#pragma unroll
    for (int a = 0; a < 8; ++a) p[a] = w[a];
  }
  __syncthreads();

  // Rows, inverse second half: thread (r, a') the inverse 16-point DFT over
  // kb' (n1 = a' + 8 b'), x conj WN^(k2 n1), each value to the block that
  // owns column n1, at [k2][n1 % C], once every block is past its reads of
  // `buf`. Odd rows take b' ^ 1 at step b' (the same owner), so a warp's
  // four rows write both halves of the banks.
  const int r = tid / 8, a = tid % 8, k2 = k2_0 + r;
  const bool odd = r & 1;
  float2 v[16];
#pragma unroll
  for (int kb = 0; kb < 16; ++kb) v[kb] = buf[kb * F::kRowT + r * 8 + a];
  cluster_arrive();
  nis::dft_reg<true, 16>(v, t.tw_128, 8);
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const float2 w = tw_full(t.tw_n, k2 * (a + 8 * b));
    v[b] = nis::cmul(v[b], make_float2(w.x, -w.y));
  }
  cluster_wait();
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int n1 = a + 8 * (odd ? b ^ 1 : b);
    float2* dst = cluster.map_shared_rank(buf, n1 / C);
    dst[k2 * C + n1 % C] = odd ? v[b ^ 1] : v[b];
  }
  cluster_arrive();
  cluster_wait();

  // Columns, inverse first half: per (c, kb) the inverse A-point DFT over
  // ka (k2 = kb + 16 ka), conj WB1^(kb a), into [a][kb][c].
  if constexpr (A <= 16) {
    constexpr int kItems = 16 / A;
    float2 w[kItems][A];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = tid + i * T, c = j % C, kb = j / C;
#pragma unroll
      for (int ka = 0; ka < A; ++ka) w[i][ka] = buf[(kb + 16 * ka) * C + c];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = tid + i * T, c = j % C, kb = j / C;
      nis::dft_reg<true, A>(w[i], t.tw_b1, 16);
#pragma unroll
      for (int n = 0; n < A; ++n)
        buf[(n * 16 + kb) * C + c] =
            n == 0 ? w[i][n]
                   : nis::cmul(w[i][n],
                               nis::twiddle_pow<true>(t.tw_b1, kb * n, B1));
    }
  } else {
    // A = 32: a lane pair per (c, kb), lane h holding ka = 16 h + n; one
    // radix-2 step across the pair leaves lane h the 16-point inverse DFT
    // of a = 2 m + h
    static_assert(A == 32, "");
    const int h = tid & 1, item = tid >> 1, c = item % C, kb = item / C;
    float2 u[16];
#pragma unroll
    for (int n = 0; n < 16; ++n) u[n] = buf[(kb + 16 * (16 * h + n)) * C + c];
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float2 o = shfl_xor(u[n], 1);
      u[n] = h == 0 ? cadd(u[n], o)
                    : nis::cmul(make_float2(o.x - u[n].x, o.y - u[n].y),
                                nis::twiddle_pow<true>(t.tw_b1, 16 * n, B1));
    }
    nis::dft_reg<true, 16>(u, t.tw_b1, 32);
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int n = 2 * m + h;
      buf[(n * 16 + kb) * C + c] =
          n == 0 ? u[m]
                 : nis::cmul(u[m],
                             nis::twiddle_pow<true>(t.tw_b1, kb * n, B1));
    }
  }
  __syncthreads();

  // Columns, inverse second half: thread (c, a) the inverse 16-point DFT
  // over kb (n2 = a + A b), the band rows stored / nfft (a warp writes whole
  // 128-byte segments).
  {
    const int c = tid % C, n = tid / C;
    float2 x[16];
#pragma unroll
    for (int kb = 0; kb < 16; ++kb) x[kb] = buf[(n * 16 + kb) * C + c];
    nis::dft_reg<true, 16>(x, t.tw_b1, A);
    const float inv_n = 1.0f / (float)(128 * B1);
    float2* o = out + (size_t)row * (p1 - p0) * 128 + rank * C + c;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int n2 = n + A * b;
      if (n2 >= p0 && n2 < p1)
        __stcs(o + (size_t)(n2 - p0) * 128, nis::cscale(x[b], inv_n));
    }
  }
}

// The recentre kernels' plan: Fwd<B1, R>'s clusters and blocks, a presum
// group a cluster. Shared memory: Fwd's buffer, the ramp factors (E2, E1) of
// a pulse (recentre from spectra: of two pulses, so it builds the next
// pulse's before a barrier that follows the last pulse's reads), and the
// accumulator, acc[q * T + tid] for the thread's points q = 8 i + ka' (a
// warp's accesses consecutive): recentre from spectra keeps it in the
// buffer, which it does not use before its inverse; the fused kernel beside
// it, 32 KB more, which leaves three blocks an SM at 256 threads (in
// registers, 32 more a thread, the kernel ran at two and took longer:
// scripts/probe_torch_fft_phases.py).
template <int B1, int R, bool FUSED>
struct Rec {
  using F = Fwd<B1, R>;
  static constexpr int kBlocksPerSm = F::T == 256 ? (FUSED ? 3 : 4) : 1;
  static constexpr int kRamp = R + 128;
  static constexpr int kAcc = 16 * F::T;
  static constexpr int kSmem =
      (R * kFwdPitch + (FUSED ? kRamp + kAcc : 2 * kRamp)) *
      (int)sizeof(float2);
  // one thread a ramp factor; recentre from spectra's accumulator fits the
  // buffer
  static_assert(F::T >= kRamp && kAcc <= R * kFwdPitch, "");
  // kBlocksPerSm blocks fit an H100 SM: 228 KB of shared memory (1 KB of it
  // the runtime's for each block) and 2,048 threads
  static_assert(kBlocksPerSm * (kSmem + 1024) <= 233472 &&
                kBlocksPerSm * F::T <= 2048, "");
};

// The float64 trajectory from which the recentre kernels form each pulse's
// ramp: pos (P, 3) and ts (P) chronological, vf (3) the focus velocity,
// t_mean (1) the time it is referred to; c_light, t_ref, fs and car_scale =
// 2 pi 2 fc / c as the plain version has them. Slot j of a ring of pulses
// holds pulse (j - ring_offset) mod P (0 for a chronological call).
struct Traj {
  const double* pos;
  const double* ts;
  const double* vf;
  const double* t_mean;
  double c_light, t_ref, fs, car_scale;
  int ring_offset;
};

// Slot j's scalars in float64, as the plain version forms them
// (ops/bp_fast.py::recentre_scalars): d0 = |pos - vf (t - t_mean)|, shift =
// (2 d0 / c - t_ref) fs, car = car_scale d0; then the exact split of the
// ramp (the head of the file): si = round(shift) mod N, sf = shift -
// round(shift), car wrapped mod 2 pi. A ring's scalars are the
// chronological ones rolled, bit for bit.
template <int N>
__device__ __forceinline__ void pulse_scalars(const Traj& tr, int j,
                                              int num_p, int& si, float& sf,
                                              float& car) {
  constexpr double kTwoPiD = 6.283185307179586;
  int i = (j - tr.ring_offset) % num_p;
  if (i < 0) i += num_p;
  const double dt = tr.ts[i] - tr.t_mean[0];
  const double x = tr.pos[3 * i] - tr.vf[0] * dt;
  const double y = tr.pos[3 * i + 1] - tr.vf[1] * dt;
  const double z = tr.pos[3 * i + 2] - tr.vf[2] * dt;
  const double d0 = sqrt(x * x + y * y + z * z);
  const double shift = (2.0 * d0 / tr.c_light - tr.t_ref) * tr.fs;
  const double r = rint(shift);                   // half to even, as torch
  sf = (float)(shift - r);
  const long long k = (long long)r % N;
  si = (int)(k < 0 ? k + N : k);
  const double cw = tr.car_scale * d0;
  car = (float)(cw - kTwoPiD * rint(cw / kTwoPiD));
}

// Ramp factor i < R + 128 of slot j (the head of the file): E2[k2_0 + i]
// for i < R, else E1[i - R] / d.
template <int B1, int R>
__device__ __forceinline__ float2 ramp_factor(int i, int k2_0, const Traj& tr,
                                              int j, int num_p, float inv_d) {
  constexpr int N = 128 * B1;
  int si;
  float sf, car;
  pulse_scalars<N>(tr, j, num_p, si, sf, car);
  const bool row = i < R;
  const int k = row ? k2_0 + i : B1 * (i - R);          // k2, or B1 k1
  // (k si) mod N: the low bits of the product, exact mod 2^32
  const unsigned m = ((unsigned)k * (unsigned)si) & (unsigned)(N - 1);
  const int ks = row || i - R < 64 ? k : k - N;
  const float ph =
      ((float)m + (float)ks * sf) * (kTwoPi / (float)N) + (row ? 0.f : car);
  float s, c;
  sincosf(ph, &s, &c);
  const float g = row ? 1.f : inv_d;
  return make_float2(c * g, s * g);
}

// The fused kernel's rows, second half, and the presum: per (r, kb') the
// 8-point DFT over a' (k1 = kb' + 16 ka', natural order), each point x
// E2[k2] E1[k1] / d added to the accumulator at q = 8 i + ka'.
template <int B1, int R>
__device__ __forceinline__ void rows_accumulate(const float2* sm,
                                                const float2* ramp,
                                                float2* acc, const Tables& t) {
  using F = Fwd<B1, R>;
  const int tid = (int)threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = tid + i * F::T, kb = j % 16, r = j / 16;
    float2 w[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) w[a] = sm[kb * F::kRowT + r * 8 + a];
    nis::dft_reg<false, 8>(w, t.tw_128, 16);
    const float2 e2 = ramp[r];
#pragma unroll
    for (int ka = 0; ka < 8; ++ka) {
      float2* at = acc + (8 * i + ka) * F::T + tid;
      *at = cadd(*at, nis::cmul(w[ka], nis::cmul(e2, ramp[R + kb + 16 * ka])));
    }
  }
}

// A presum group's inverse, forward spectra's plan backwards as the FFT
// conv runs it: the thread's accumulated points -> band rows n2 in [p0, p1)
// of x / nfft at out[(n2 - p0) * 128 + n1]. `sm` is the block's buffer.
// Ends after the last cluster exchange.
template <int B1, int R>
__device__ __forceinline__ void presum_inverse(
    cg::cluster_group& cluster, float2* sm, const float2* acc,
    const Tables& t, float2* __restrict__ out, int p0, int p1) {
  using F = Fwd<B1, R>;
  constexpr int C = F::C, A = F::A, T = F::T;
  const int tid = (int)threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int k2_0 = rank * R;

  // Rows, inverse first half: per (r, kb') the inverse 8-point DFT over ka'
  // and conj W128^(a' kb'), into the rows' transpose once every thread has
  // read its accumulator (recentre from spectra keeps it in `sm`).
  float2 u[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = tid + i * T, kb = j % 16, r = j / 16;
#pragma unroll
    for (int ka = 0; ka < 8; ++ka) u[i][ka] = acc[(8 * i + ka) * T + tid];
    nis::dft_reg<true, 8>(u[i], t.tw_128, 16);
#pragma unroll
    for (int a = 1; a < 8; ++a)
      u[i][a] = nis::cmul(u[i][a],
                          nis::twiddle_pow<true>(t.tw_128, a * kb, 128));
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = tid + i * T, kb = j % 16, r = j / 16;
#pragma unroll
    for (int a = 0; a < 8; ++a) sm[kb * F::kRowT + r * 8 + a] = u[i][a];
  }
  __syncthreads();

  // Rows, inverse second half: thread (r, a') the inverse 16-point DFT over
  // kb' (n1 = a' + 8 b'), x conj WN^(k2 n1), each value pushed to the block
  // that owns column n1, at [k2][n1 % C], once every block is past its reads
  // of `sm`. Odd rows take b' ^ 1 at step b' (the same owner), so a warp's
  // four rows write both halves of the banks.
  {
    const int r = tid / 8, a = tid % 8, k2 = k2_0 + r;
    const bool odd = r & 1;
    float2 y[16];
#pragma unroll
    for (int kb = 0; kb < 16; ++kb) y[kb] = sm[kb * F::kRowT + r * 8 + a];
    cluster_arrive();
    nis::dft_reg<true, 16>(y, t.tw_128, 8);
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const float2 w = tw_full(t.tw_n, k2 * (a + 8 * b));
      y[b] = nis::cmul(y[b], make_float2(w.x, -w.y));
    }
    cluster_wait();  // every block is past its reads of the rows
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int n1 = a + 8 * (odd ? b ^ 1 : b);
      float2* to = cluster.map_shared_rank(sm, n1 / C);
      to[k2 * C + n1 % C] = odd ? y[b ^ 1] : y[b];
    }
    cluster_arrive();
    cluster_wait();  // this block's columns are in
  }

  // Columns, inverse first half: per (c, kb) the inverse A-point DFT over
  // ka (k2 = kb + 16 ka), conj WB1^(kb a), into [a][kb][c].
  if constexpr (A <= 16) {
    constexpr int kItems = 16 / A;
    float2 w[kItems][A];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = tid + i * T, c = j % C, kb = j / C;
#pragma unroll
      for (int ka = 0; ka < A; ++ka) w[i][ka] = sm[(kb + 16 * ka) * C + c];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = tid + i * T, c = j % C, kb = j / C;
      nis::dft_reg<true, A>(w[i], t.tw_b1, 16);
#pragma unroll
      for (int n = 0; n < A; ++n)
        sm[(n * 16 + kb) * C + c] =
            n == 0 ? w[i][n]
                   : nis::cmul(w[i][n],
                               nis::twiddle_pow<true>(t.tw_b1, kb * n, B1));
    }
  } else {
    // A = 32: a lane pair per (c, kb), lane h holding ka = 16 h + n; one
    // radix-2 step across the pair leaves lane h the 16-point inverse DFT
    // of a = 2 m + h
    static_assert(A == 32, "");
    const int h = tid & 1, item = tid >> 1, c = item % C, kb = item / C;
    float2 w[16];
#pragma unroll
    for (int n = 0; n < 16; ++n) w[n] = sm[(kb + 16 * (16 * h + n)) * C + c];
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float2 o = shfl_xor(w[n], 1);
      w[n] = h == 0 ? cadd(w[n], o)
                    : nis::cmul(make_float2(o.x - w[n].x, o.y - w[n].y),
                                nis::twiddle_pow<true>(t.tw_b1, 16 * n, B1));
    }
    nis::dft_reg<true, 16>(w, t.tw_b1, 32);
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int n = 2 * m + h;
      sm[(n * 16 + kb) * C + c] =
          n == 0 ? w[m]
                 : nis::cmul(w[m],
                             nis::twiddle_pow<true>(t.tw_b1, kb * n, B1));
    }
  }
  __syncthreads();  // [a][kb][c] is in

  // Columns, inverse second half: thread (c, a) the inverse 16-point DFT
  // over kb (n2 = a + A b); the band rows stored / nfft, a warp's stores
  // whole 128-byte lines.
  {
    const int c = tid % C, a = tid / C;
    float2 z[16];
#pragma unroll
    for (int kb = 0; kb < 16; ++kb) z[kb] = sm[(a * 16 + kb) * C + c];
    nis::dft_reg<true, 16>(z, t.tw_b1, A);
    const float scale = 1.0f / (float)(128 * B1);
    float2* o = out + rank * C + c;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int n2 = a + A * b;
      if (n2 >= p0 && n2 < p1)
        __stcs(o + (size_t)(n2 - p0) * 128, nis::cscale(z[b], scale));
    }
  }
}

// Recentre from spectra: one cluster a presum group. Per pulse of the group,
// in order, each thread reads its 16 points of the stored spectrum (k1
// natural: a warp reads whole 128-byte lines), x E2 E1 / d, into the
// accumulator; then the inverse.
template <int B1, int R>
__global__ void __launch_bounds__(Fwd<B1, R>::T,
                                  (Rec<B1, R, false>::kBlocksPerSm))
    recentre_spectra_kernel(const float2* __restrict__ spec, Traj tr,
                            Tables t, float2* __restrict__ out, int num_p,
                            int d, int p0, int p1) {
  using F = Fwd<B1, R>;
  using P = Rec<B1, R, false>;
  cg::cluster_group cluster = cg::this_cluster();
  float2* sm = reinterpret_cast<float2*>(nis_smem);
  float2* ramps = sm + R * kFwdPitch;
  const int tid = (int)threadIdx.x;
  const int g = blockIdx.x / F::CS;
  const int k2_0 = (int)cluster.block_rank() * R;
  const int first = g * d, nj = min(d, num_p - first);
  const float inv_d = 1.0f / (float)d;
  float2* acc = sm;
#pragma unroll
  for (int q = 0; q < 16; ++q) acc[q * F::T + tid] = make_float2(0.f, 0.f);
#pragma unroll 1
  for (int jp = 0; jp < nj; ++jp) {
    const int pulse = first + jp;
    const float2* sp =
        spec + (size_t)pulse * (B1 * 128) + (size_t)k2_0 * 128;
    float2 v[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = tid + i * F::T, kb = j % 16, r = j / 16;
#pragma unroll
      for (int ka = 0; ka < 8; ++ka)
        v[i][ka] = __ldcs(sp + r * 128 + kb + 16 * ka);
    }
    // slot jp & 1 was last read for pulse jp - 2, before the barrier of
    // pulse jp - 1
    float2* ramp = ramps + (jp & 1) * P::kRamp;
    if (tid < P::kRamp)
      ramp[tid] = ramp_factor<B1, R>(tid, k2_0, tr, pulse, num_p, inv_d);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = tid + i * F::T, kb = j % 16, r = j / 16;
      const float2 e2 = ramp[r];
#pragma unroll
      for (int ka = 0; ka < 8; ++ka) {
        float2* at = acc + (8 * i + ka) * F::T + tid;
        *at = cadd(*at, nis::cmul(v[i][ka],
                                  nis::cmul(e2, ramp[R + kb + 16 * ka])));
      }
    }
  }
  // a ring's group g holds chronological group g - ring_offset / d (mod
  // the groups; ring_offset is a multiple of d then): its row goes there
  const int groups = (num_p + d - 1) / d;
  const int row = (g - tr.ring_offset / d + groups) % groups;
  presum_inverse<B1, R>(cluster, sm, acc, t,
                        out + (size_t)row * (p1 - p0) * 128, p0, p1);
}

// Recentre + presum: one cluster a presum group. Per pulse of the group, in
// order, forward spectra's steps up to its rows' 8-point DFTs, then each
// point x E2 E1 / d into the accumulator; a group's spectra never leave the
// chip. Then the filter on the sum and the inverse.
template <int B1, int R>
__global__ void __launch_bounds__(Fwd<B1, R>::T,
                                  (Rec<B1, R, true>::kBlocksPerSm))
    recenter_presum_kernel(const float2* __restrict__ x,
                           const float2* __restrict__ filt, Traj tr,
                           Tables t, float2* __restrict__ out, int num_p,
                           int ns, int d, int p0, int p1) {
  using F = Fwd<B1, R>;
  using P = Rec<B1, R, true>;
  constexpr int C = F::C, A = F::A;
  cg::cluster_group cluster = cg::this_cluster();
  float2* sm = reinterpret_cast<float2*>(nis_smem);
  float2* ramp = sm + R * kFwdPitch;
  const int tid = (int)threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.x / F::CS;
  const int k2_0 = rank * R;
  const int first = g * d, nj = min(d, num_p - first);
  const float inv_d = 1.0f / (float)d;
  float2* acc = ramp + P::kRamp;
#pragma unroll
  for (int q = 0; q < 16; ++q) acc[q * F::T + tid] = make_float2(0.f, 0.f);
  const int c = tid % C, a = tid / C, n0 = rank * C + c + 128 * a;
#pragma unroll 1
  for (int jp = 0; jp < nj; ++jp) {
    const int pulse = first + jp;
    const float2* raw = x + (size_t)pulse * ns;
    // Columns, first half, as forward spectra's: thread (c, a) reads n2 = a
    // + A b, b < 16, the 16-point DFT over b, WB1^(a kb), into [a][kb][c]
    float2 v[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int n = n0 + 128 * A * b;
      v[b] = n < ns ? __ldcs(raw + n) : make_float2(0.f, 0.f);
    }
    nis::dft_reg<false, 16>(v, t.tw_b1, A);
    float2 e = make_float2(0.f, 0.f);
    if (tid < P::kRamp)
      e = ramp_factor<B1, R>(tid, k2_0, tr, pulse, num_p, inv_d);
    __syncthreads();  // every thread is past the last pulse's rows and ramp
#pragma unroll
    for (int kb = 0; kb < 16; ++kb)
      sm[(a * 16 + kb) * C + c] =
          kb == 0 ? v[0]
                  : nis::cmul(v[kb],
                              nis::twiddle_pow<false>(t.tw_b1, a * kb, B1));
    if (tid < P::kRamp) ramp[tid] = e;
    __syncthreads();
    // The columns' second half pushes into the other blocks' buffers after
    // a cluster barrier that every thread arrives at after its reads of its
    // own buffer, the last pulse's rows included: so the pulse loop needs no
    // cluster barrier of its own.
    columns_second_half<B1, R>(cluster, sm, t);
    rows_first_half<B1, R>(sm, t);
    rows_accumulate<B1, R>(sm, ramp, acc, t);
  }
  // the filter on the sum: each thread scales its own accumulator points
  // (r, kb', ka'), so no barrier precedes the inverse's reads of them
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = tid + i * F::T, kb = j % 16, r = j / 16;
    const float2* f = filt + (size_t)(k2_0 + r) * 128 + kb;
#pragma unroll
    for (int ka = 0; ka < 8; ++ka) {
      float2* at = acc + (8 * i + ka) * F::T + tid;
      *at = nis::cmul(*at, __ldg(f + 16 * ka));
    }
  }
  presum_inverse<B1, R>(cluster, sm, acc, t,
                        out + (size_t)g * (p1 - p0) * 128, p0, p1);
}

// `items` clusters of `cs` blocks of `threads` each; returns the launch's
// error code.
template <typename... KArgs, typename... Args>
int launch_clusters(void (*kernel)(KArgs...), int items, int cs, int threads,
                    int smem, void* stream, Args... args) {
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(items * cs);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err) return err;
  return (int)cudaGetLastError();
}

// Forward spectra on Fwd<B1, R>'s plan: a cluster of CS blocks a pulse.
template <int B1, int R>
int forward_spectra_on(int num_p, void* stream, const float2* x,
                       const float2* filt, Tables t, float2* out, int ns) {
  using F = Fwd<B1, R>;
  return launch_clusters(forward_spectra_kernel<B1, R>, num_p, F::CS, F::T,
                         F::kSmem, stream, x, filt, t, out, ns);
}

// The FFT conv on Conv<B1, R>'s plan: a cluster of CS blocks a row.
template <int B1, int R>
int fft_conv_on(int num_p, void* stream, const float* xr, const float* xi,
                const float2* filt, Tables t, float2* out, int ns, int ld_r,
                int ld_i, int p0, int p1) {
  using F = Fwd<B1, R>;
  return launch_clusters(fft_conv_kernel<B1, R>, num_p, F::CS, F::T,
                         F::kSmem, stream, xr, xi, filt, t, out, ns, ld_r,
                         ld_i, p0, p1);
}

// The recentre kernels on Rec<B1, R, ...>'s plan: a cluster of CS blocks a
// presum group.
template <int B1, int R>
int recentre_spectra_on(int groups, void* stream, const float2* spec,
                        Traj tr, Tables t, float2* out, int num_p, int d,
                        int p0, int p1) {
  using F = Fwd<B1, R>;
  return launch_clusters(recentre_spectra_kernel<B1, R>, groups, F::CS, F::T,
                         Rec<B1, R, false>::kSmem, stream, spec, tr, t, out,
                         num_p, d, p0, p1);
}

template <int B1, int R>
int recenter_presum_on(int groups, void* stream, const float2* x,
                       const float2* filt, Traj tr, Tables t, float2* out,
                       int num_p, int ns, int d, int p0, int p1) {
  using F = Fwd<B1, R>;
  return launch_clusters(recenter_presum_kernel<B1, R>, groups, F::CS, F::T,
                         Rec<B1, R, true>::kSmem, stream, x, filt, tr, t, out,
                         num_p, ns, d, p0, p1);
}

}  // namespace

// The launchers: nfft = 128 * B1 with B1 a power of two in [128, 512].
// Each returns the launch's CUDA error.

// Forward spectra: 32 k2 rows a block at nfft 16,384 and 32,768 (clusters
// of 4 and 8, four blocks an SM), 64 at 65,536 (clusters of 8, one an SM).
extern "C" int forward_spectra_launch(
    const float2* x, const float2* filt, const float2* tw_n,
    const float2* tw_b1, const float2* tw_128, float2* out, int num_p, int ns,
    int nfft, void* stream) {
  const Tables t{tw_n, tw_b1, tw_128};
  switch (nfft) {
    case 128 * 128:
      return forward_spectra_on<128, 32>(num_p, stream, x, filt, t, out, ns);
    case 128 * 256:
      return forward_spectra_on<256, 32>(num_p, stream, x, filt, t, out, ns);
    case 128 * 512:
      return forward_spectra_on<512, 64>(num_p, stream, x, filt, t, out, ns);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The recentre kernels, one cluster a presum group on forward spectra's
// clusters (the same switch on nfft). Each pulse's ramp comes from the
// float64 trajectory (Traj): pos (P, 3), ts (P), vf (3) and t_mean (1) on
// the card, slot j of `spec` holding pulse (j - ring_offset) mod P.
extern "C" int recentre_spectra_launch(
    const float2* spec, const double* pos, const double* ts, const double* vf,
    const double* t_mean, const float2* tw_n, const float2* tw_b1,
    const float2* tw_128, float2* out, int num_p, int d, int nfft, int p0,
    int p1, int ring_offset, double c_light, double t_ref, double fs,
    double car_scale, void* stream) {
  const Tables t{tw_n, tw_b1, tw_128};
  const Traj tr{pos, ts, vf, t_mean, c_light, t_ref, fs, car_scale,
                ring_offset};
  const int groups = (num_p + d - 1) / d;
  switch (nfft) {
    case 128 * 128:
      return recentre_spectra_on<128, 32>(groups, stream, spec, tr, t, out,
                                          num_p, d, p0, p1);
    case 128 * 256:
      return recentre_spectra_on<256, 32>(groups, stream, spec, tr, t, out,
                                          num_p, d, p0, p1);
    case 128 * 512:
      return recentre_spectra_on<512, 64>(groups, stream, spec, tr, t, out,
                                          num_p, d, p0, p1);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int recenter_presum_launch(
    const float2* x, const float2* filt, const double* pos, const double* ts,
    const double* vf, const double* t_mean, const float2* tw_n,
    const float2* tw_b1, const float2* tw_128, float2* out, int num_p, int ns,
    int d, int nfft, int p0, int p1, double c_light, double t_ref, double fs,
    double car_scale, void* stream) {
  const Tables t{tw_n, tw_b1, tw_128};
  const Traj tr{pos, ts, vf, t_mean, c_light, t_ref, fs, car_scale, 0};
  const int groups = (num_p + d - 1) / d;
  switch (nfft) {
    case 128 * 128:
      return recenter_presum_on<128, 32>(groups, stream, x, filt, tr, t, out,
                                         num_p, ns, d, p0, p1);
    case 128 * 256:
      return recenter_presum_on<256, 32>(groups, stream, x, filt, tr, t, out,
                                         num_p, ns, d, p0, p1);
    case 128 * 512:
      return recenter_presum_on<512, 64>(groups, stream, x, filt, tr, t, out,
                                         num_p, ns, d, p0, p1);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The FFT conv on Conv<B1, R>'s plan (forward spectra's clusters); the
// field rows fr + j fi at row strides ld_r and ld_i (floats).
extern "C" int fft_conv_launch(const float* xr, const float* xi,
                               const float2* filt, const float2* tw_n,
                               const float2* tw_b1, const float2* tw_128,
                               float2* out, int num_p, int ns, int ld_r,
                               int ld_i, int nfft, int p0, int p1,
                               void* stream) {
  const Tables t{tw_n, tw_b1, tw_128};
  switch (nfft) {
    case 128 * 128:
      return fft_conv_on<128, 32>(num_p, stream, xr, xi, filt, t, out, ns,
                                  ld_r, ld_i, p0, p1);
    case 128 * 256:
      return fft_conv_on<256, 32>(num_p, stream, xr, xi, filt, t, out, ns,
                                  ld_r, ld_i, p0, p1);
    case 128 * 512:
      return fft_conv_on<512, 64>(num_p, stream, xr, xi, filt, t, out, ns,
                                  ld_r, ld_i, p0, p1);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
