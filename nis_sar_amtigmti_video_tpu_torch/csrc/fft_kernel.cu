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
// at 3.35 TB/s. It runs forward spectra's plan (below) forward, then the
// same plan backwards: the rows' filter and inverse in registers, a second
// cluster exchange back to the column owners, the columns' inverse DFTs,
// and only the band rows stored (the inverse's last 16-point DFTs run in
// full: pruning them to the band would save a few per cent of its
// operations).
//
// What bounds it on the H100. By bytes it would be the fused kernel's
// ~0.45 GB (each raw pulse read once, one band row per group written) at
// the reference shape (P 2,500, ns 22,004, nfft 32,768, d 4): 0.13 ms at
// 3.35 TB/s; the flops (~2 x 5 N log2 N per pulse) are ~0.03 ms of the f32
// rate. In practice the shared-memory FFT passes, the block and cluster
// barriers between them and the per-point index and sincos work take the
// time (scripts/probe_torch_fft_phases.py times each phase): the kernels
// are bound by instruction issue and barrier latency on one 512-thread
// block per SM, not by device memory. Forward spectra and the conv (below)
// run several smaller blocks an SM, so their memory phases overlap: forward
// spectra reached ~46 % of its byte bound.
//
// Design. One pulse's spectrum (256 KB at nfft 32,768, 512 KB at 65,536)
// does not fit the 227 KB of shared memory a block may have, so each
// transform is a four-step split N = 128 x B1 (B1 = nfft / 128):
//   input  n = n1 + 128 n2   (n1 < 128, n2 < B1)
//   output f = k2 + B1 k1    (k2 < B1,  k1 < 128)
//   X[f] = sum_n1 W128^(k1 n1) WN^(k2 n1) sum_n2 x[n1 + 128 n2] WB1^(k2 n2)
// and the spectrum lives in the distributed shared memory of a thread-block
// cluster of B1 / 64 blocks (2, 4 or 8): block r owns rows k2 in
// [64 r, 64 r + 64) of the [k2][k1] intermediate, 8,192 points (64 KB).
// Step 1: each block loads 128 / cs of the strided columns n1 (B1 points
// each) from device memory, transforms them in its own shared memory,
// applies WN^(k2 n1), and stores each value into the block that owns its
// row k2 (a DSMEM store). Step 2: after a cluster barrier each block runs
// the 128-point transforms of its 64 rows locally. The inverse runs the
// same two steps backwards: local 128-point row inverses, a cluster
// barrier, then each block gathers its columns from the owners (DSMEM
// loads), runs their B1-point inverses and stores only the band rows n2 in
// [p0, p1) to device memory. So the fused kernel's device traffic is the
// raw pulses in and the band rows out: a group's spectra and its presum
// accumulator (64 KB per block) never leave the chip, and no kernel has a
// scratch buffer in device memory. The spectra are kept in the natural
// [k2][k1] layout (the TPU kernel's (k, m) digit order). A presum group
// sums its d pulses in a fixed order in each block's accumulator (no
// atomics), so a group's result does not depend on which cluster or which
// ring slot served it.
//
// Forward spectra alone (forward_spectra_kernel) runs the same split on
// smaller blocks: 32 rows a block at nfft 16,384 and 32,768 (clusters of 4
// and 8, 256 threads, 34 KB of shared memory, four blocks an SM, so one
// block's loads and stores overlap the others' transforms), every DFT in
// registers, the rows' k1 in natural order so the spectra stores coalesce,
// and the filter read in that order too.
//
// The other kernels' block FFTs do radix-2 butterflies (fft_smem.cuh's, bit
// for bit) with few passes: the stages spanning 32 points or more two or
// three at a time in registers, the last five in one warp pass with
// shuffles; every warp access is to consecutive points, so no pass has
// bank conflicts. The nfft-point twiddle WN^m comes from a two-level table
// (256 + nfft / 256 entries, float64-built) that stays in L1; their filter
// table is stored in the row FFTs' output order, so its reads are
// coalesced.
//
// Exact ramp: the host splits each pulse's shift into si = round(shift)
// mod nfft and sf = shift - round(shift) in float64, and wraps the carrier
// mod 2 pi; the kernel forms (f si) mod nfft from the low bits of the
// integer product, so the phase 2 pi / N ((f si mod N) + f_signed sf) + car
// stays within a few rad and accurate sincosf (no fast math) keeps it to
// f32 rounding.
#include <cooperative_groups.h>

#include "fft_smem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kRowsPerBlock = 64;                 // k2 rows a block owns
constexpr int kPoints = kRowsPerBlock * 128;      // its share of a spectrum
constexpr int kPerThread = kPoints / kThreads;    // points per thread
constexpr int kBatch = 4;   // of them whose loads a thread issues together
// a block's kPoints / B1 columns at a pitch of B1 + 1 points, so a warp
// that walks across columns hits distinct banks
constexpr int kColPoints = kPoints + 64;
constexpr int kSmemOne = (kPoints + kColPoints) * (int)sizeof(float2);
constexpr int kSmemTwo = (2 * kPoints + kColPoints) * (int)sizeof(float2);
constexpr float kTwoPi = 6.283185307179586f;

struct Tables {
  const float2* tw_n;     // [WN^b, b < 256 | WN^(256 a), a < nfft / 256]
  const float2* tw_b1;    // exp(-2 pi i k / B1),   k < B1 / 2
  const float2* tw_128;   // exp(-2 pi i k / 128),  k < 64
};

struct Shape {
  int nfft, b1, log2b1;
  int cols, log2cols;     // columns per block: kPoints / B1
};

// WN^m = exp(-2 pi i m / nfft), 0 <= m < nfft, as WN^(m mod 256) x
// WN^(256 floor(m / 256)): two small tables that stay in L1, where one
// nfft-point table (128 KB at 32,768) would not.
__device__ __forceinline__ float2 tw_full(const float2* __restrict__ tw_n,
                                          int m) {
  return nis::cmul(__ldg(tw_n + (m & 255)), __ldg(tw_n + 256 + (m >> 8)));
}

// Recentre ramp exp(j (2 pi / N ((f si) mod N + f_signed sf) + car)).
__device__ __forceinline__ float2 ramp(int f, int nfft, int si, float sf,
                                       float car) {
  // (f si) mod nfft: the low bits of the product, exact mod 2^32
  const unsigned m = ((unsigned)f * (unsigned)si) & (unsigned)(nfft - 1);
  const int fs = f >= (nfft >> 1) ? f - nfft : f;
  const float ph = ((float)m + (float)fs * sf) * (kTwoPi / (float)nfft) + car;
  float s, c;
  sincosf(ph, &s, &c);
  return make_float2(c, s);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// Rows of 128 points: position l of a row-FFT output (k1 bit-reversed, as
// the row FFTs, the presum accumulator and the kernels' filter table hold
// it) is position row_natural(l) in natural k1 order (the spectra).
__device__ __forceinline__ int row_natural(int l) {
  return (l & ~127) + nis::bitrev(l & 127, 7);
}

// The point a thread handles on its q-th step over a block's kPoints.
__device__ __forceinline__ int point(int q) {
  return (int)threadIdx.x + q * kThreads;
}

// Over the thread's points l = point(q), kBatch at a time: v = load(l) for
// a whole batch (the loads go out together), then store(l, v).
template <typename Load, typename Store>
__device__ __forceinline__ void each_point(Load load, Store store) {
#pragma unroll 1
  for (int q0 = 0; q0 < kPerThread; q0 += kBatch) {
    float2 v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) v[q] = load(point(q0 + q));
#pragma unroll
    for (int q = 0; q < kBatch; ++q) store(point(q0 + q), v[q]);
  }
}

// The block FFTs below transform the block's kPoints points, held as
// kPoints / n sequences of n = 2^log2n points (128 <= n <= 512) `pitch`
// apart, in place and unnormalised, with the butterflies of fft_smem.cuh's
// radix-2 fft_dif / fft_dit, so the results are the same bit for bit. They
// are grouped to cut shared-memory passes and block barriers: the stages
// whose butterflies span 32 points or more run R at a time in registers
// (each thread loads 2^R points of a group, runs R stages, stores them),
// and the five stages within 32 points run in one pass per warp over
// contiguous 32-point chunks, partners exchanged by shuffles. Every access
// of a warp is to consecutive points, so no pass has a bank conflict. The
// caller synchronises before; each call ends with a block barrier.

// Stages s_top .. s_top - R + 1 of a DIF transform (s_top - R >= 5).
template <int R>
__device__ void dif_pass(float2* x, int log2n, int pitch, int s_top,
                         const float2* __restrict__ tw, bool inverse) {
  constexpr int kG = 1 << R, kPer = kPerThread / kG;
  const int lowb = s_top - R;
  int base[kPer], low[kPer];
  float2 a[kPer][kG];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int g = point(q), gi = g & ((1 << (log2n - R)) - 1);
    low[q] = gi & ((1 << lowb) - 1);
    base[q] = (g >> (log2n - R)) * pitch + ((gi >> lowb) << s_top) + low[q];
#pragma unroll
    for (int m = 0; m < kG; ++m) a[q][m] = x[base[q] + (m << lowb)];
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
#pragma unroll
    for (int t = R - 1; t >= 0; --t) {
      const int st = lowb + t + 1;                // the stage; half 2^(st-1)
#pragma unroll
      for (int m = 0; m < kG; ++m) {
        if (m & (1 << t)) continue;
        const int pos = low[q] + ((m & ((1 << t) - 1)) << lowb);
        const float2 u = a[q][m], v = a[q][m + (1 << t)];
        a[q][m] = cadd(u, v);
        a[q][m + (1 << t)] =
            nis::cmul(make_float2(u.x - v.x, u.y - v.y),
                      nis::twiddle(tw, pos << (log2n - st), inverse));
      }
    }
#pragma unroll
    for (int m = 0; m < kG; ++m) x[base[q] + (m << lowb)] = a[q][m];
  }
}

// Stages s_bot .. s_bot + R - 1 of a DIT transform (s_bot >= 6).
template <int R>
__device__ void dit_pass(float2* x, int log2n, int pitch, int s_bot,
                         const float2* __restrict__ tw, bool inverse) {
  constexpr int kG = 1 << R, kPer = kPerThread / kG;
  const int lowb = s_bot - 1;
  int base[kPer], low[kPer];
  float2 a[kPer][kG];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int g = point(q), gi = g & ((1 << (log2n - R)) - 1);
    low[q] = gi & ((1 << lowb) - 1);
    base[q] = (g >> (log2n - R)) * pitch + ((gi >> lowb) << (lowb + R))
              + low[q];
#pragma unroll
    for (int m = 0; m < kG; ++m) a[q][m] = x[base[q] + (m << lowb)];
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int st = s_bot + t;
#pragma unroll
      for (int m = 0; m < kG; ++m) {
        if (m & (1 << t)) continue;
        const int pos = low[q] + ((m & ((1 << t) - 1)) << lowb);
        const float2 u = a[q][m];
        const float2 w = nis::cmul(
            nis::twiddle(tw, pos << (log2n - st), inverse),
            a[q][m + (1 << t)]);
        a[q][m] = cadd(u, w);
        a[q][m + (1 << t)] = make_float2(u.x - w.x, u.y - w.y);
      }
    }
#pragma unroll
    for (int m = 0; m < kG; ++m) x[base[q] + (m << lowb)] = a[q][m];
  }
}

__device__ __forceinline__ float2 shfl_xor(float2 v, int mask) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, mask),
                     __shfl_xor_sync(0xffffffffu, v.y, mask));
}

// Stages 5 .. 1 (dit: 1 .. 5) on every 32-point chunk, one lane a point.
template <bool kDit>
__device__ void warp_stages(float2* x, int log2n, int pitch,
                            const float2* __restrict__ tw, bool inverse) {
  constexpr int kWarps = kThreads / 32;
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
  int at[kPerThread];
  float2 v[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int c = warp + q * kWarps;
    at[q] = (c >> (log2n - 5)) * pitch
            + ((c & ((1 << (log2n - 5)) - 1)) << 5) + lane;
    v[q] = x[at[q]];
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int st = kDit ? i + 1 : 5 - i, h = 1 << (st - 1);
    const float2 w = nis::twiddle(tw, (lane & (h - 1)) << (log2n - st),
                                  inverse);
    const bool upper = lane & h;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const float2 o = shfl_xor(v[q], h);
      if (kDit) {
        // lower: u = mine, t = w * theirs; upper: u = theirs, t = w * mine
        const float2 t = nis::cmul(w, upper ? v[q] : o);
        const float2 u = upper ? o : v[q];
        v[q] = upper ? make_float2(u.x - t.x, u.y - t.y) : cadd(u, t);
      } else {
        // lower: u = mine, v = theirs; upper: u = theirs, v = mine
        v[q] = upper ? nis::cmul(make_float2(o.x - v[q].x, o.y - v[q].y), w)
                     : cadd(v[q], o);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) x[at[q]] = v[q];
}

// Decimation in frequency: natural order in, bit-reversed order out.
__device__ void block_fft_dif(float2* x, int log2n, int pitch,
                              const float2* __restrict__ tw, bool inverse) {
  if (log2n == 9) {
    dif_pass<2>(x, log2n, pitch, 9, tw, inverse);
    __syncthreads();
  }
  if (log2n == 8)
    dif_pass<3>(x, log2n, pitch, 8, tw, inverse);
  else
    dif_pass<2>(x, log2n, pitch, 7, tw, inverse);
  __syncthreads();
  warp_stages<false>(x, log2n, pitch, tw, inverse);
  __syncthreads();
}

// Decimation in time: bit-reversed order in, natural order out.
__device__ void block_fft_dit(float2* x, int log2n, int pitch,
                              const float2* __restrict__ tw, bool inverse) {
  warp_stages<true>(x, log2n, pitch, tw, inverse);
  __syncthreads();
  if (log2n == 8) {
    dit_pass<3>(x, log2n, pitch, 6, tw, inverse);
  } else {
    dit_pass<2>(x, log2n, pitch, 6, tw, inverse);
    if (log2n == 9) {
      __syncthreads();
      dit_pass<2>(x, log2n, pitch, 8, tw, inverse);
    }
  }
  __syncthreads();
}

// Sample n of a zero-padded complex64 pulse of ns samples.
struct PulseLoad {
  const float2* __restrict__ x;
  int ns;
  __device__ __forceinline__ float2 operator()(int n) const {
    return n < ns ? __ldg(x + n) : make_float2(0.f, 0.f);
  }
};

// Step 1, local half: this block's columns n1 in [c0, c0 + cols) of one
// zero-padded pulse (`load(n)` its sample n), B1-point forward DFT in `col`
// (column c at c * (B1 + 1), bit-reversed k2 order).
template <typename Load>
__device__ void columns_forward(Load load, int c0, float2* col,
                                const Tables& t, const Shape& s) {
  each_point(
      [&](int l) {
        return load(c0 + (l & (s.cols - 1)) + 128 * (l >> s.log2cols));
      },
      [&](int l, float2 v) {
        col[(l & (s.cols - 1)) * (s.b1 + 1) + (l >> s.log2cols)] = v;
      });
  __syncthreads();
  block_fft_dif(col, s.log2b1, s.b1 + 1, t.tw_b1, false);
}

// Step 1, cluster half: Y[k2][n1] = col x WN^(k2 n1) into row k2 % 64 of
// the block that owns k2. Every block of the cluster must be past its last
// read of `y` (a cluster barrier) before this runs.
__device__ void scatter_columns(cg::cluster_group& cluster, const float2* col,
                                float2* y, int c0, const Tables& t,
                                const Shape& s) {
  each_point(
      [&](int l) {
        const int c = l & (s.cols - 1), p = l >> s.log2cols;
        return nis::cmul(col[c * (s.b1 + 1) + p],
                         tw_full(t.tw_n, nis::bitrev(p, s.log2b1) * (c0 + c)));
      },
      [&](int l, float2 v) {
        const int k2 = nis::bitrev(l >> s.log2cols, s.log2b1);
        float2* dst = cluster.map_shared_rank(y, k2 / kRowsPerBlock);
        dst[(k2 % kRowsPerBlock) * 128 + c0 + (l & (s.cols - 1))] = v;
      });
}

// The forward transform of one pulse (`load(n)` its sample n) into this
// block's rows of `y`: after it, y[r * 128 + q] = X[k2 + B1 bitrev(q)],
// k2 = 64 rank + r.
template <typename Load>
__device__ void pulse_forward(cg::cluster_group& cluster, Load load,
                              float2* y, float2* col, const Tables& t,
                              const Shape& s) {
  const int c0 = (int)cluster.block_rank() * s.cols;
  columns_forward(load, c0, col, t, s);
  cluster.sync();
  scatter_columns(cluster, col, y, c0, t, s);
  cluster.sync();
  block_fft_dif(y, 7, 128, t.tw_128, false);
}

// acc[l] (+)= spec x ramp / d for this block's rows; `spec(l)` is the
// filtered spectrum at acc's position l (k1 bit-reversed in its row).
template <typename Spectrum>
__device__ void accumulate_pulse(Spectrum spec, float2* acc, bool first,
                                 int k2_0, int si, float sf, float car,
                                 float inv_d, const Shape& s) {
  each_point(
      spec,
      [&](int l, float2 v) {
        const int f = k2_0 + (l >> 7) + s.b1 * nis::bitrev(l & 127, 7);
        const float2 r = nis::cscale(
            nis::cmul(v, ramp(f, s.nfft, si, sf, car)), inv_d);
        acc[l] = first ? r : cadd(acc[l], r);
      });
}

// The inverse of a group's accumulated spectrum (this block's rows in
// `acc`, k1 bit-reversed) -> band rows n2 in [p0, p1) of x / N at
// out[(n2 - p0) * 128 + n1]. `col` is this block's column work area.
// Ends with a cluster barrier: no block leaves while another still reads
// its rows.
__device__ void group_inverse(cg::cluster_group& cluster, float2* acc,
                              float2* col, float2* __restrict__ out, int p0,
                              int p1, const Tables& t, const Shape& s) {
  const int rank = (int)cluster.block_rank();
  const int k2_0 = rank * kRowsPerBlock, c0 = rank * s.cols;
  __syncthreads();
  block_fft_dit(acc, 7, 128, t.tw_128, true);
  each_point(
      [&](int l) {
        float2 w = tw_full(t.tw_n, (k2_0 + (l >> 7)) * (l & 127));
        w.y = -w.y;
        return nis::cmul(acc[l], w);
      },
      [&](int l, float2 v) { acc[l] = v; });
  cluster.sync();
  each_point(
      [&](int l) {
        const int k2 = l >> s.log2cols;
        const float2* src = cluster.map_shared_rank(acc, k2 / kRowsPerBlock);
        return src[(k2 % kRowsPerBlock) * 128 + c0 + (l & (s.cols - 1))];
      },
      [&](int l, float2 v) {
        col[(l & (s.cols - 1)) * (s.b1 + 1) + (l >> s.log2cols)] = v;
      });
  __syncthreads();
  block_fft_dif(col, s.log2b1, s.b1 + 1, t.tw_b1, true);
  const float inv_n = 1.0f / (float)s.nfft;
  each_point(
      [&](int l) {
        return nis::cscale(
            col[(l & (s.cols - 1)) * (s.b1 + 1) + (l >> s.log2cols)], inv_n);
      },
      [&](int l, float2 v) {
        const int n2 = nis::bitrev(l >> s.log2cols, s.log2b1);
        if (n2 >= p0 && n2 < p1)
          out[(size_t)(n2 - p0) * 128 + c0 + (l & (s.cols - 1))] = v;
      });
  cluster.sync();
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

// One cluster per presum group.
__global__ void __launch_bounds__(kThreads, 1) recentre_spectra_kernel(
    const float2* __restrict__ spec, const int* __restrict__ si,
    const float* __restrict__ sf, const float* __restrict__ car, Tables t,
    float2* __restrict__ out, int num_p, int d, int p0, int p1, Shape s) {
  cg::cluster_group cluster = cg::this_cluster();
  float2* acc = reinterpret_cast<float2*>(nis_smem);
  float2* col = acc + kPoints;
  const int g = blockIdx.x / (int)cluster.num_blocks();
  const int k2_0 = (int)cluster.block_rank() * kRowsPerBlock;
  const int first = g * d, nj = min(d, num_p - first);
  const float inv_d = 1.0f / (float)d;
  for (int j = 0; j < nj; ++j) {
    const float2* sp = spec + (size_t)(first + j) * s.nfft
                       + (size_t)k2_0 * 128;
    accumulate_pulse(
        [&](int l) { return sp[row_natural(l)]; }, acc, j == 0,
        k2_0, si[first + j], sf[first + j], car[first + j], inv_d, s);
  }
  group_inverse(cluster, acc, col, out + (size_t)g * (p1 - p0) * 128, p0, p1,
                t, s);
}

// One cluster per presum group; the group's spectra and its presum
// accumulator stay in the cluster's shared memory.
__global__ void __launch_bounds__(kThreads, 1) recenter_presum_kernel(
    const float2* __restrict__ x, const float2* __restrict__ filt,
    const int* __restrict__ si, const float* __restrict__ sf,
    const float* __restrict__ car, Tables t, float2* __restrict__ out,
    int num_p, int ns, int d, int p0, int p1, Shape s) {
  cg::cluster_group cluster = cg::this_cluster();
  float2* y = reinterpret_cast<float2*>(nis_smem);
  float2* acc = y + kPoints;
  float2* col = acc + kPoints;
  const int g = blockIdx.x / (int)cluster.num_blocks();
  const int k2_0 = (int)cluster.block_rank() * kRowsPerBlock;
  const int first = g * d, nj = min(d, num_p - first);
  const float inv_d = 1.0f / (float)d;
  const float2* f = filt + (size_t)k2_0 * 128;
  for (int j = 0; j < nj; ++j) {
    // the barrier inside pulse_forward orders this pulse's DSMEM stores
    // after every block's reads of `y` for the pulse before
    pulse_forward(cluster, PulseLoad{x + (size_t)(first + j) * ns, ns}, y,
                  col, t, s);
    accumulate_pulse([&](int l) { return nis::cmul(y[l], __ldg(f + l)); },
                     acc, j == 0, k2_0, si[first + j], sf[first + j],
                     car[first + j], inv_d, s);
  }
  group_inverse(cluster, acc, col, out + (size_t)g * (p1 - p0) * 128, p0, p1,
                t, s);
}

Shape shape_of(int nfft) {
  Shape s;
  s.nfft = nfft;
  s.b1 = nfft / 128;
  s.log2b1 = nis::log2_of(s.b1);
  s.cols = kPoints / s.b1;
  s.log2cols = nis::log2_of(s.cols);
  return s;
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

// The shared kernels' cluster: B1 / 64 blocks of kThreads.
int cluster_of(int nfft) { return nfft / 128 / kRowsPerBlock; }

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

// The other three: clusters of B1 / 64 blocks (2, 4 or 8).
extern "C" int recentre_spectra_launch(
    const float2* spec, const int* si, const float* sf, const float* car,
    const float2* tw_n, const float2* tw_b1, const float2* tw_128,
    float2* out, int num_p, int d, int nfft, int p0, int p1, void* stream) {
  return launch_clusters(recentre_spectra_kernel, (num_p + d - 1) / d,
                         cluster_of(nfft), kThreads,
                         kSmemOne, stream, spec, si, sf, car,
                         Tables{tw_n, tw_b1, tw_128}, out, num_p, d, p0, p1,
                         shape_of(nfft));
}

extern "C" int recenter_presum_launch(
    const float2* x, const float2* filt, const int* si, const float* sf,
    const float* car, const float2* tw_n, const float2* tw_b1,
    const float2* tw_128, float2* out, int num_p, int ns, int d, int nfft,
    int p0, int p1, void* stream) {
  return launch_clusters(recenter_presum_kernel, (num_p + d - 1) / d,
                         cluster_of(nfft), kThreads,
                         kSmemTwo, stream, x, filt, si, sf, car,
                         Tables{tw_n, tw_b1, tw_128}, out, num_p, ns, d, p0,
                         p1, shape_of(nfft));
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
