// The fast-BP accumulate kernels: the pixel-tile accumulate and the
// coarse-tile factorized inner sums, one templated kernel for both.
//
// Replaces the TPU kernels nis_sar_amtigmti_video_tpu/ops/pallas/
// bp_kernel.py :: accumulate_pallas (_kernel, W = 64) and
// bp_factor_kernel.py :: accumulate_factor_pallas (_kernel, W = 32,
// feed='windows'). Per pulse t and pixel (y, x) of the internal grid:
//
//   window y (W samples of the band at y * stride) -> tapered W-point DFT / W
//   -> window-offset ramp exp(+j 2 pi f_m u0[t,y]) x exp(+j c0[t,y])
//   -> column kernel exp(+j 2 pi f_m e_t(x)), e_t = b_t xi + c_t xi^2,
//      contracted over m
//   -> / max(taper(u0 + e_t), 1e-4) -> x exp(+j (c1[t,y] xi + c2[t,y] xi^2))
//   -> summed over the block's pulses.
//
// The pixel accumulate passes c0..c2 = (pa, pb, pc) and sums all pulses
// (e^{j pa} does not depend on m or x, so it rides the ramp). The factor
// kernel passes (ad, bd, cd), the phase residuals against each sub-
// aperture's anchor pulse, with xi the coarse columns in fine-pixel units;
// blockIdx.z is the sub-aperture and it sums only its live pulses (the
// reference's zero-weighted padded pulses contribute nothing).
//
// What bounds it on the H100: f32 arithmetic. At the VideoSAR full width
// (P 625 presummed pulses, 1,664 x 640 pixels, W 64) the 64-deep complex
// contraction alone is 625 x 1664 x 640 x 512 = 3.4e11 flop, ~5 ms at the
// 67 TFLOP/s f32 rate, against ~30 MB of operands (0.01 ms at 3.35 TB/s).
//
// Design. A block owns a 32 x 128 pixel tile and loops over the pulses
// itself, holding its sums in registers: no float atomics and a fixed
// order, so the result is deterministic (the ring mode stays bit-stable).
// Per pulse it reads the band rows the tile's windows cover (stride * 31 +
// W samples) straight from the recentred pulses into shared memory (the
// TPU wrapper's (P, 2W, ny) window packing is not needed), and builds in
// shared memory, shared by all rows and columns of the tile:
//   - the tapered window DFT of its 32 rows as an R1 x 8 split (W = R1 * 8:
//     8-point DFTs, twiddle, R1-point DFTs), 1,088 complex MACs per row at
//     W 64 instead of 4,096, from a float64-built twiddle table;
//   - the column kernel K[m][x] for its 128 columns, one sincospif each,
//     once per pulse per block (W x 128 entries against 32 x 128 x W MACs).
// Each of the 256 threads then contracts a 4 x 4 pixel micro-tile over m
// with plain f32 complex FMAs from shared memory (the TPU's bf16 x 3 split
// dots have no reason here). The taper uses the angle sum sin(a + b) of a
// per-row and a per-column sincospif, so a pixel pays 2 FMAs for it; the
// focusing phase is one accurate sincosf per pixel and pulse (it reaches
// tens of rad). No fast math. About 100 KB of shared memory at W 64, so two
// blocks share an SM; the full-width grid is 5 x 52 = 260 blocks.
#include "fft_smem.cuh"

namespace {

constexpr int kTileY = 32;      // rows of a block's tile
constexpr int kTileX = 128;     // columns of a block's tile
constexpr int kThreads = 256;   // 8 row groups x 32 column lanes
constexpr int kRows = 4;        // a thread's rows: ty * 4 + i
constexpr int kCols = 4;        // a thread's columns: tx + 32 j

struct Args {
  const float2* rc2;   // (P, n) recentred, presummed pulses
  const float* u0;     // (P, ny) window offsets
  const float* c0;     // (P, ny) constant phase (pa, or ad)
  const float* c1;     // (P, ny) linear phase coefficient (pb, or bd)
  const float* c2;     // (P, ny) quadratic phase coefficient (pc, or cd)
  const float* bt;     // (P,) column-offset linear term
  const float* ct;     // (P,) column-offset quadratic term
  const float* xi;     // (ncols,) column abscissae in fine pixels
  const float2* tw;    // (W,) exp(-2 pi i k / W)
  const float* tapw;   // (W,) taper[s] / W
  float2* out;         // (n_sub, ny, ncols)
  int num_p, n, ny, ncols, band_start, stride, sub_p, taper_pow;
};

__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 c) {
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, c.x)),
                     fmaf(a.x, b.y, fmaf(a.y, b.x, c.y)));
}

template <int W>
constexpr int smem_float2s(int seg) {
  return W * kTileX + 2 * W * kTileY + kTileY + W + seg;
}

template <int W>
constexpr int smem_floats() {
  return W + 5 * kTileY + 3 * kTileX;
}

template <int W>
__global__ void __launch_bounds__(kThreads, 2) accumulate_kernel(Args a) {
  constexpr int R2 = 8;          // first-stage DFT length
  constexpr int R1 = W / R2;     // second-stage DFT length
  // shared memory: float2 arrays first (16-byte aligned), then floats
  float2* kmat = reinterpret_cast<float2*>(nis_smem);   // [W][kTileX]
  float2* g = kmat + W * kTileX;                        // [W][kTileY]
  float2* sa1 = g + W * kTileY;                         // [W][kTileY]
  float2* rot = sa1 + W * kTileY;                       // [kTileY] e^{j c0}
  float2* tws = rot + kTileY;                           // [W]
  float2* band = tws + W;                               // [seg]
  const int seg = a.stride * (kTileY - 1) + W;
  float* tapw = reinterpret_cast<float*>(band + seg);   // [W]
  float* sa = tapw + W;          // [kTileY] sin(pi (u0 + 0.5) / W)
  float* ca = sa + kTileY;       // [kTileY] cos of the same
  float* u0s = ca + kTileY;      // [kTileY]
  float* c1s = u0s + kTileY;     // [kTileY]
  float* c2s = c1s + kTileY;     // [kTileY]
  float* sbx = c2s + kTileY;     // [kTileX] sin(pi e / W)
  float* cbx = sbx + kTileX;     // [kTileX] cos of the same
  float* xis = cbx + kTileX;     // [kTileX]

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int t0 = blockIdx.z * a.sub_p;
  const int t1 = min(a.num_p, t0 + a.sub_p);

  for (int i = tid; i < W; i += kThreads) {
    tws[i] = a.tw[i];
    tapw[i] = a.tapw[i];
  }
  for (int i = tid; i < kTileX; i += kThreads) xis[i] = a.xi[x0 + i];

  float2 acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = make_float2(0.f, 0.f);

  for (int t = t0; t < t1; ++t) {
    __syncthreads();   // the last pulse's readers are done with the buffers
    // -- the pulse's band rows, per-row terms, per-column terms, K[m][x]
    const float2* src = a.rc2 + (size_t)t * a.n + a.band_start
                        + (size_t)y0 * a.stride;
    for (int i = tid; i < seg; i += kThreads) band[i] = src[i];
    const float bt = a.bt[t];
    const float ct = a.ct[t];
    if (tid < kTileY) {
      const size_t r = (size_t)t * a.ny + y0 + tid;
      const float u = a.u0[r];
      float sn, cs;
      sincospif((u + 0.5f) / (float)W, &sn, &cs);
      sa[tid] = sn;
      ca[tid] = cs;
      u0s[tid] = u;
      sincosf(a.c0[r], &sn, &cs);
      rot[tid] = make_float2(cs, sn);
      c1s[tid] = a.c1[r];
      c2s[tid] = a.c2[r];
    } else if (tid >= kThreads - kTileX) {
      const int x = tid - (kThreads - kTileX);
      const float xi = xis[x];
      float sn, cs;
      sincospif((bt * xi + ct * (xi * xi)) / (float)W, &sn, &cs);
      sbx[x] = sn;
      cbx[x] = cs;
    }
    for (int i = tid; i < W * kTileX; i += kThreads) {
      const int m = i / kTileX;
      const int x = i % kTileX;
      const float xi = xis[x];
      const int k = m < W / 2 ? m : m - W;   // signed fftfreq numerator
      float sn, cs;
      sincospif((bt * xi + ct * (xi * xi)) * (float)(2 * k) / (float)W,
                &sn, &cs);
      kmat[i] = make_float2(cs, sn);
    }
    __syncthreads();
    // -- tapered window DFT, stage 1: window sample s = s1 + R1 s2,
    //    A[s1 R2 + m2][y] = w^(s1 m2) sum_s2 x[s] w^(R1 s2 m2), w = e^{-2 pi i/W}
    for (int i = tid; i < W * kTileY; i += kThreads) {
      const int r = i / kTileY;
      const int y = i % kTileY;
      const int s1 = r / R2;
      const int m2 = r % R2;
      const float2* xb = band + y * a.stride + s1;
      float2 sum = make_float2(0.f, 0.f);
#pragma unroll
      for (int s2 = 0; s2 < R2; ++s2) {
        const float2 v = nis::cscale(xb[R1 * s2], tapw[s1 + R1 * s2]);
        sum = cfma(v, tws[(R1 * s2 * m2) % W], sum);
      }
      sa1[i] = nis::cmul(sum, tws[(s1 * m2) % W]);
    }
    __syncthreads();
    // -- stage 2: bin m = m2 + R2 m1 is sum_s1 A[s1 R2 + m2] w^(R2 s1 m1);
    //    then the window-offset ramp and e^{j c0}
    for (int i = tid; i < W * kTileY; i += kThreads) {
      const int m = i / kTileY;
      const int y = i % kTileY;
      const int m2 = m % R2;
      const int m1 = m / R2;
      float2 sum = make_float2(0.f, 0.f);
#pragma unroll
      for (int s1 = 0; s1 < R1; ++s1)
        sum = cfma(sa1[(s1 * R2 + m2) * kTileY + y],
                   tws[(R2 * s1 * m1) % W], sum);
      const int k = m < W / 2 ? m : m - W;
      float sn, cs;
      sincospif(u0s[y] * (float)(2 * k) / (float)W, &sn, &cs);
      g[i] = nis::cmul(nis::cmul(sum, make_float2(cs, sn)), rot[y]);
    }
    __syncthreads();
    // -- the contraction over m on a 4 x 4 micro-tile
    float2 v[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) v[i][j] = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int m = 0; m < W; ++m) {
      const float4* gp =
          reinterpret_cast<const float4*>(g + m * kTileY + ty * kRows);
      const float4 ga = gp[0];
      const float4 gb = gp[1];
      const float2 gr[kRows] = {make_float2(ga.x, ga.y),
                                make_float2(ga.z, ga.w),
                                make_float2(gb.x, gb.y),
                                make_float2(gb.z, gb.w)};
      float2 kc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kc[j] = kmat[m * kTileX + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) v[i][j] = cfma(gr[i], kc[j], v[i][j]);
    }
    // -- taper division and phase, into the sums
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int y = ty * kRows + i;
      const float sy = sa[y];
      const float cy = ca[y];
      const float p1 = c1s[y];
      const float p2 = c2s[y];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int x = tx + 32 * j;
        const float xi = xis[x];
        // sin(pi (u0 + e + 0.5) / W) by the angle sum
        const float s = fmaf(sy, cbx[x], cy * sbx[x]);
        float tap = 1.f;
        for (int q = 0; q < a.taper_pow; ++q) tap *= s;
        const float inv = __frcp_rn(fmaxf(tap, 1e-4f));
        float sn, cs;
        sincosf(p1 * xi + p2 * (xi * xi), &sn, &cs);
        const float2 z = nis::cscale(nis::cmul(v[i][j], make_float2(cs, sn)),
                                     inv);
        acc[i][j] = make_float2(acc[i][j].x + z.x, acc[i][j].y + z.y);
      }
    }
  }

  float2* dst = a.out + ((size_t)blockIdx.z * a.ny + y0) * a.ncols + x0;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      dst[(size_t)(ty * kRows + i) * a.ncols + tx + 32 * j] = acc[i][j];
}

template <int W>
int launch(const Args& a, int n_sub, cudaStream_t stream) {
  const int seg = a.stride * (kTileY - 1) + W;
  const size_t smem = (size_t)smem_float2s<W>(seg) * sizeof(float2)
                      + (size_t)smem_floats<W>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      accumulate_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.ncols / kTileX, a.ny / kTileY, n_sub);
  accumulate_kernel<W><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Accumulates n_sub blocks of sub_p pulses (the last may be short) of the
// (num_p, n) recentred pulses into (n_sub, ny, ncols) sums, on `stream`.
// w is 32 or 64; ny a multiple of 32, ncols of 128; the band rows
// [band_start, band_start + stride (ny - 1) + w) lie inside each pulse.
// Returns cudaGetLastError() after the launch.
extern "C" int bp_accumulate_launch(
    const float2* rc2, const float* u0, const float* c0, const float* c1,
    const float* c2, const float* bt, const float* ct, const float* xi,
    const float2* tw, const float* tapw, float2* out, int num_p, int n,
    int ny, int ncols, int band_start, int stride, int sub_p, int n_sub,
    int taper_pow, int w, void* stream) {
  const Args a{rc2, u0, c0, c1, c2, bt, ct, xi, tw, tapw, out,
               num_p, n, ny, ncols, band_start, stride, sub_p, taper_pow};
  if (w == 64) return launch<64>(a, n_sub, (cudaStream_t)stream);
  if (w == 32) return launch<32>(a, n_sub, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
