// Range-cell migration correction (RCMC) and the azimuth filter of the
// Range-Doppler Algorithm, one launch a plane.
//
// Replaces no TPU kernel: the JAX package runs its 'exact' RCMC
// (nis_sar_amtigmti_video_tpu/ops/rda.py::rcmc) as a vmapped searchsorted
// and gather, then multiplies by the azimuth filter H in XLA, over
// delta_R and H planes built in float64. On the card that chain is a
// dozen passes over a 760 MB plane and its 1.5 GB float64 grids; here it
// is one read of the range-Doppler plane and one write of the filtered
// plane (and, for the viewers, one more write of the plane before H).
// ops/cuda/rcmc_kernel.py::rcmc_filter_plain is the same RCMC and H in
// PyTorch, its interval found by searchsorted.
//
// For the Doppler row of frequency fd (physical row p holds Doppler row
// (p + row_shift) mod n_az of the fd table) and the range axis r (float64
// tables):
//
//   delta_R(r) = r g,  g = fd^2 lam2 / den      (lam2 = lam^2, den = 8 V^2)
//   H(r)       = exp(j wrap(r hk fd^2))         (hk = -pi lam / (2 V^2))
//
// The RCMC (the upstream's interp1d): output cell j is the row read on the
// source grid s(m) = r(m) - delta_R(r(m)) at x = r(j): linear between the
// interval m (the largest with s(m) <= x, within [0, n - 2]) and m + 1,
// zero where x lies outside [s(0), s(n - 1)]. delta_R is linear in r, so
// s is affine in m (up to the rounding of r): m is estimated in closed
// form, (x / (1 - g) - r0) / dr, and moved while s(m + 1) <= x or s(m) >
// x, which lands on searchsorted's interval exactly (at most a step in
// practice; tests/test_torch_rda.py holds a PyTorch copy of the search to
// searchsorted).
//
// Numerics, as the plain version: g, s, the interval weight and H's
// phase in float64 without contraction into FMAs (the _rn intrinsics), the
// phase wrapped mod 2 pi before its float32 cast; the interpolation in
// float32 without FMAs; the accurate sincosf (the build has no fast math).
//
// Bound: bytes. A cell reads its two source taps (neighbouring threads
// read neighbouring taps: one pass over the row through L1) and writes
// one (two with the viewers' plane) complex64 value: 1.52 GB at 7,200 x
// 13,200, 0.454 ms at 3.35 TB/s; its float64 work (no division but the
// weight's) and one sincosf stay under that. Design: the plane in either
// layout (the card's azimuth FFT leaves it column-major), blocks of 256
// threads whose warps load and store neighbouring values (rcmc_kernel
// below); a row's constants are formed once a thread. With a counter, each
// warp adds its zero-filled cells with one atomic (only rows' far ends
// have any).

#include <cuda_runtime.h>

namespace {

constexpr int kRcmcThreads = 256;
constexpr int kRcmcItems = 4;     // row-major: cells a thread, 256 apart
constexpr int kColCells = 32;     // column-major: cells a thread, in order
constexpr double kTwoPi = 6.283185307179586;
constexpr double kInvTwoPi = 0.15915494309189535;

// s(m) = r(m) - r(m) g
__device__ __forceinline__ double source_at(const double* __restrict__ r,
                                            int m, double g) {
  const double rm = __ldg(r + m);
  return __dsub_rn(rm, __dmul_rn(rm, g));
}

// a (1 - w) + b w, as the plain version rounds it
__device__ __forceinline__ float2 lerp(float2 a, float2 b, float w) {
  const float u = __fsub_rn(1.0f, w);
  return make_float2(__fadd_rn(__fmul_rn(a.x, u), __fmul_rn(b.x, w)),
                     __fadd_rn(__fmul_rn(a.y, u), __fmul_rn(b.y, w)));
}

// One Doppler row's constants: delta_R = r g, H's phase r hrow, the
// source grid's ends and the interval's estimate x a - b.
struct Row {
  double g, hrow, s_first, s_last, a, b;
};

__device__ __forceinline__ Row row_of(const double* __restrict__ r,
                                      const double* __restrict__ fd, int i,
                                      int n_rg, double lam2, double den,
                                      double hk) {
  Row w{};
  const double f = __ldg(fd + i);
  const double fd2 = __dmul_rn(f, f);
  w.g = __ddiv_rn(__dmul_rn(fd2, lam2), den);
  w.hrow = __dmul_rn(hk, fd2);
  w.s_first = source_at(r, 0, w.g);
  w.s_last = source_at(r, n_rg - 1, w.g);
  const double r0 = __ldg(r);
  const double step = (__ldg(r + n_rg - 1) - r0) / (double)(n_rg - 1);
  w.a = 1.0 / (step * (1.0 - w.g));
  w.b = r0 / step;
  return w;
}

// The cell at x = r(j) of a row whose cell m is row[m * ld]: the RCMC
// alone; counts a zero-filled cell
__device__ __forceinline__ float2 resample(const Row& w,
                                           const double* __restrict__ r,
                                           const float2* __restrict__ row,
                                           size_t ld, int n_rg, double x,
                                           int& zeros) {
  if (!(x >= w.s_first && x <= w.s_last)) {
    ++zeros;
    return make_float2(0.0f, 0.0f);
  }
  const double q = fmin(fmax(x * w.a - w.b, 0.0), (double)(n_rg - 2));
  int m = (int)q;
  double s0 = source_at(r, m, w.g), s1 = source_at(r, m + 1, w.g);
  while (m < n_rg - 2 && s1 <= x) {
    ++m;
    s0 = s1;
    s1 = source_at(r, m + 1, w.g);
  }
  while (m > 0 && s0 > x) {
    --m;
    s1 = s0;
    s0 = source_at(r, m, w.g);
  }
  const float t = __double2float_rn(
      __ddiv_rn(__dsub_rn(x, s0), __dsub_rn(s1, s0)));
  return lerp(row[(size_t)m * ld], row[(size_t)(m + 1) * ld], t);
}

// v H(x), H's phase wrapped mod 2 pi in float64 before its float32 cast
__device__ __forceinline__ float2 filter(float2 v, double x, double hrow) {
  const double ph = __dmul_rn(x, hrow);
  const double wrapped =
      __dsub_rn(ph, __dmul_rn(kTwoPi, rint(__dmul_rn(ph, kInvTwoPi))));
  float sn, cs;
  sincosf(__double2float_rn(wrapped), &sn, &cs);
  return make_float2(__fsub_rn(__fmul_rn(v.x, cs), __fmul_rn(v.y, sn)),
                     __fadd_rn(__fmul_rn(v.x, sn), __fmul_rn(v.y, cs)));
}

__device__ __forceinline__ void add_zeros(unsigned long long* zeroed,
                                          int zeros) {
  if (zeroed == nullptr) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    zeros += __shfl_down_sync(0xffffffffu, zeros, o);
  if ((threadIdx.x & 31) == 0 && zeros > 0)
    atomicAdd(zeroed, (unsigned long long)zeros);
}

// COLS false: a row-major plane (cell j of physical row p at p n_rg + j);
// a block takes 1,024 cells (blockIdx.x) of one row (blockIdx.y), each
// thread 4 cells 256 apart. COLS true: a column-major plane (at j n_az +
// p), as the azimuth FFT on the card leaves it; a block takes 256 rows
// (blockIdx.x, one a thread) by 32 cells (blockIdx.y), each thread its
// row's cells in order, so a warp's loads and stores are 32 neighbouring
// rows of one cell.
template <bool KEEP, bool COLS>
__global__ void __launch_bounds__(kRcmcThreads) rcmc_kernel(
    const float2* __restrict__ in, float2* __restrict__ out,
    float2* __restrict__ out_rcmc, const double* __restrict__ r,
    const double* __restrict__ fd, unsigned long long* __restrict__ zeroed,
    int n_az, int n_rg, int row_shift, double lam2, double den, double hk) {
  const int p = COLS ? blockIdx.x * kRcmcThreads + threadIdx.x : blockIdx.y;
  int zeros = 0;
  if (p < n_az) {
    int i = p + row_shift;
    if (i >= n_az) i -= n_az;
    const Row w = row_of(r, fd, i, n_rg, lam2, den, hk);
    if (COLS) {
      const float2* __restrict__ row = in + p;
      const int j0 = blockIdx.y * kColCells;
      const int j1 = min(j0 + kColCells, n_rg);
      for (int j = j0; j < j1; ++j) {
        const double x = __ldg(r + j);
        const float2 v = resample(w, r, row, (size_t)n_az, n_rg, x, zeros);
        const size_t at = (size_t)j * n_az + p;
        if (KEEP) out_rcmc[at] = v;
        out[at] = filter(v, x, w.hrow);
      }
    } else {
      const size_t base = (size_t)p * (size_t)n_rg;
      const float2* __restrict__ row = in + base;
      const int j0 = blockIdx.x * (kRcmcThreads * kRcmcItems) + threadIdx.x;
#pragma unroll
      for (int k = 0; k < kRcmcItems; ++k) {
        const int j = j0 + k * kRcmcThreads;
        if (j >= n_rg) break;
        const double x = __ldg(r + j);
        const float2 v = resample(w, r, row, 1, n_rg, x, zeros);
        if (KEEP) out_rcmc[base + j] = v;
        out[base + j] = filter(v, x, w.hrow);
      }
    }
  }
  add_zeros(zeroed, zeros);
}

template <bool KEEP, bool COLS>
void launch_rcmc(cudaStream_t s, const float2* in, float2* out,
                 float2* out_rcmc, const double* r, const double* fd,
                 unsigned long long* zeroed, int n_az, int n_rg,
                 int row_shift, double lam2, double den, double hk) {
  const dim3 grid =
      COLS ? dim3((n_az + kRcmcThreads - 1) / kRcmcThreads,
                  (n_rg + kColCells - 1) / kColCells)
           : dim3((n_rg + kRcmcThreads * kRcmcItems - 1) /
                      (kRcmcThreads * kRcmcItems),
                  n_az);
  rcmc_kernel<KEEP, COLS><<<grid, kRcmcThreads, 0, s>>>(
      in, out, out_rcmc, r, fd, zeroed, n_az, n_rg, row_shift, lam2, den,
      hk);
}

template <bool KEEP>
void launch_layout(bool cols, cudaStream_t s, const float2* in, float2* out,
                   float2* out_rcmc, const double* r, const double* fd,
                   unsigned long long* zeroed, int n_az, int n_rg,
                   int row_shift, double lam2, double den, double hk) {
  if (cols)
    launch_rcmc<KEEP, true>(s, in, out, out_rcmc, r, fd, zeroed, n_az, n_rg,
                            row_shift, lam2, den, hk);
  else
    launch_rcmc<KEEP, false>(s, in, out, out_rcmc, r, fd, zeroed, n_az,
                             n_rg, row_shift, lam2, den, hk);
}

}  // namespace

// One (n_az, n_rg) complex64 range-Doppler plane, row-major (cols 0) or
// column-major (cols 1) -> its RCMC times H (out) and, where out_rcmc is
// not null, its RCMC alone, both in the plane's layout. r (n_rg,) and fd
// (n_az,) float64; zeroed (one uint64, added to) may be null. Returns
// cudaErrorInvalidValue for a plane the launch does not take, else
// cudaGetLastError() after the launch.
extern "C" int rcmc_launch(const float2* in, float2* out, float2* out_rcmc,
                           const double* r, const double* fd,
                           unsigned long long* zeroed, int n_az, int n_rg,
                           int row_shift, int cols, double lam2, double den,
                           double hk, void* stream) {
  if (n_az < 1 || n_rg < 2 || row_shift < 0 || row_shift >= n_az ||
      (cols ? (n_rg + kColCells - 1) / kColCells > 65535 : n_az > 65535))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (out_rcmc != nullptr)
    launch_layout<true>(cols, s, in, out, out_rcmc, r, fd, zeroed, n_az,
                        n_rg, row_shift, lam2, den, hk);
  else
    launch_layout<false>(cols, s, in, out, out_rcmc, r, fd, zeroed, n_az,
                         n_rg, row_shift, lam2, den, hk);
  return (int)cudaGetLastError();
}
