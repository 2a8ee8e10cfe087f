// The column passes of CSA focusing and the GMTI CPI's epilogue: K1 / K1g,
// K3 / K3g, K4 and the raw balance reduction.
//
// K1g replaces nis_sar_amtigmti_video_tpu/ops/pallas/gmti_kernel.py
//     :: k1_gmti_planes / _k1g_body. Azimuth (column) FFT of both channels,
//     x Phi1 = exp(j c1(a) (u(r) - w(a))^2), plus the raw balance partial
//     sums of x1 conj(x2) (the balance phase needs only their angle, and the
//     CSA chain is unitary up to a positive scale).
// K1  replaces ops/pallas/csa_kernel.py :: _k1_call / _k1_body: the same
//     pass for one channel (k1_kernel<1>; K1g is k1_kernel<2>, so K1 on a
//     channel gives K1g's bits for it).
// K3g replaces ops/pallas/gmti_kernel.py :: k3_gmti_planes / _k3g_call /
//     _k3g_body. Inverse azimuth FFT (1/N) of both channels, then every
//     product plane from the column still in shared memory: s1, s2, the
//     unmasked ATI phase angle(s1 conj(s2) e^{-j cal}), |s1|^2, the DPCA power
//     |s1 - s2 e^{j cal}|^2, the azimuth halves of the outer and inner CFAR
//     box sums of that power, and the column's max |s1|^2.
// K3  replaces ops/pallas/csa_kernel.py :: _k3_call / _k3_body: the inverse
//     azimuth FFT (1/N) of one channel, through K3g's column load and FFT
//     (column_ifft<1>), so it gives K3g's s1 bits.
// K4  replaces ops/pallas/gmti_kernel.py :: k4_epilogue_planes / _k4_body.
//     Per range row: the range halves of both box sums, exact training counts
//     (rank-1 vectors), noise, snr, the peak-referenced phase mask and dmag.
// Balance replaces ops/pallas/gmti_kernel.py :: raw_balance_pallas /
//     _balance_body: re and im of sum(x1 conj(x2)) over the raw pair.
//
// What bounds them on the H100: bytes. K1g moves 4 + 4 planes, K1 and K3
// 2 + 2, K3g 4 + 9, K4 5 + 4, balance 4 read (64 MB per plane at 4096^2); the
// FFT flops and the sincosf / atan2f per element are small beside that. The
// column passes walk columns of row-major planes, so their global accesses
// are strided (each 4-byte access touches its own 32-byte sector, shared with
// neighbouring blocks through L2).
// Design: one block owns one whole azimuth column of each channel (32 KB of
// shared memory per channel at 4096), so each FFT runs in shared memory and
// the column box sums close inside the block (no halo); K4 owns whole range
// rows for the same reason. Balance reads contiguous slabs of rows as float4.
// Cross-block reductions (balance sums, peak) go to per-block scratch that
// the host reduces: no float atomics, so results do not change from run to
// run. Coalescing the column passes (tiles of several columns, a transpose
// through shared memory) is later work.
#include "fft_smem.cuh"

namespace {

// Azimuth FFT x Phi1 of NCH channels (x2*, z2* unused when NCH == 1); for
// NCH == 2 also the raw balance partial sums of the column (zeros unless
// `balance`).
template <int NCH>
__global__ void k1_kernel(
    const float* __restrict__ x1r, const float* __restrict__ x1i,
    const float* __restrict__ x2r, const float* __restrict__ x2i,
    const float* __restrict__ u, const float* __restrict__ c1,
    const float* __restrict__ w, const float2* __restrict__ tw,
    float* __restrict__ z1r, float* __restrict__ z1i,
    float* __restrict__ z2r, float* __restrict__ z2i,
    float* __restrict__ bal, int n_az, int n_rg, int log2n, int balance) {
  float2* a = reinterpret_cast<float2*>(nis_smem);
  float2* b = a + n_az;
  float* red = reinterpret_cast<float*>(a + NCH * n_az);
  const int col = blockIdx.x;
  float pr = 0.0f;
  float pi = 0.0f;
  for (int r = threadIdx.x; r < n_az; r += blockDim.x) {
    const size_t idx = (size_t)r * n_rg + col;
    const float ar = x1r[idx], ai = x1i[idx];
    a[r] = make_float2(ar, ai);
    if constexpr (NCH == 2) {
      const float br = x2r[idx], bi = x2i[idx];
      b[r] = make_float2(br, bi);
      pr += ar * br + ai * bi;
      pi += ai * br - ar * bi;
    }
  }
  if constexpr (NCH == 2) {
    pr = nis::block_sum(red, pr);   // also orders the column loads
    pi = nis::block_sum(red, pi);
    if (threadIdx.x == 0) {
      bal[col] = balance ? pr : 0.0f;
      bal[n_rg + col] = balance ? pi : 0.0f;
    }
  } else {
    __syncthreads();
  }
  nis::fft_dif(a, NCH, n_az, log2n, tw, false);

  const float uc = u[col];
  for (int p = threadIdx.x; p < n_az; p += blockDim.x) {
    const int k = nis::bitrev(p, log2n);   // natural azimuth frequency
    const float du = uc - w[k];
    float sn, cs;
    sincosf(c1[k] * du * du, &sn, &cs);
    const float2 phi = make_float2(cs, sn);
    const size_t o = (size_t)k * n_rg + col;
    const float2 y1 = nis::cmul(a[p], phi);
    z1r[o] = y1.x;
    z1i[o] = y1.y;
    if constexpr (NCH == 2) {
      const float2 y2 = nis::cmul(b[p], phi);
      z2r[o] = y2.x;
      z2i[o] = y2.y;
    }
  }
}

// Loads column `col` of NCH channels in bit-reversed order into `a` (channel
// c at a + c * n_az) and runs the unnormalised inverse FFT: natural order
// out. Synchronises before returning.
template <int NCH>
__device__ void column_ifft(
    const float* __restrict__ z1r, const float* __restrict__ z1i,
    const float* __restrict__ z2r, const float* __restrict__ z2i,
    const float2* __restrict__ tw, float2* a, int col, int n_az, int n_rg,
    int log2n) {
  for (int r = threadIdx.x; r < n_az; r += blockDim.x) {
    const size_t idx = (size_t)r * n_rg + col;
    const int q = nis::bitrev(r, log2n);
    a[q] = make_float2(z1r[idx], z1i[idx]);
    if constexpr (NCH == 2) a[n_az + q] = make_float2(z2r[idx], z2i[idx]);
  }
  __syncthreads();
  nis::fft_dit(a, NCH, n_az, log2n, tw, true);
}

__global__ void k3_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float2* __restrict__ tw, float* __restrict__ sr,
    float* __restrict__ si, int n_az, int n_rg, int log2n) {
  float2* a = reinterpret_cast<float2*>(nis_smem);
  const int col = blockIdx.x;
  column_ifft<1>(zr, zi, nullptr, nullptr, tw, a, col, n_az, n_rg, log2n);
  const float inv_n = 1.0f / (float)n_az;
  for (int r = threadIdx.x; r < n_az; r += blockDim.x) {
    const size_t idx = (size_t)r * n_rg + col;
    const float2 v = nis::cscale(a[r], inv_n);
    sr[idx] = v.x;
    si[idx] = v.y;
  }
}

__global__ void k3g_kernel(
    const float* __restrict__ z1r, const float* __restrict__ z1i,
    const float* __restrict__ z2r, const float* __restrict__ z2i,
    const float* __restrict__ cal_cs, const float2* __restrict__ tw,
    float* __restrict__ s1r, float* __restrict__ s1i,
    float* __restrict__ s2r, float* __restrict__ s2i,
    float* __restrict__ ph, float* __restrict__ mag, float* __restrict__ pw,
    float* __restrict__ cso, float* __restrict__ csi,
    float* __restrict__ peaks, int n_az, int n_rg, int log2n, int h_out,
    int h_in) {
  float2* a = reinterpret_cast<float2*>(nis_smem);
  float2* b = a + n_az;
  float* pcol = reinterpret_cast<float*>(b + n_az);
  float* red = pcol + n_az;
  const int col = blockIdx.x;
  column_ifft<2>(z1r, z1i, z2r, z2i, tw, a, col, n_az, n_rg, log2n);

  const float cr = cal_cs[0];
  const float ci = cal_cs[1];
  const float inv_n = 1.0f / (float)n_az;
  float m = 0.0f;
  for (int r = threadIdx.x; r < n_az; r += blockDim.x) {
    const size_t idx = (size_t)r * n_rg + col;
    const float2 v1 = nis::cscale(a[r], inv_n);
    const float2 v2 = nis::cscale(b[r], inv_n);
    s1r[idx] = v1.x;
    s1i[idx] = v1.y;
    s2r[idx] = v2.x;
    s2i[idx] = v2.y;
    // interferogram s1 conj(s2) e^{-j cal}
    const float pr = v1.x * v2.x + v1.y * v2.y;
    const float pi = v1.y * v2.x - v1.x * v2.y;
    ph[idx] = atan2f(pi * cr - pr * ci, pr * cr + pi * ci);
    const float mg = v1.x * v1.x + v1.y * v1.y;
    mag[idx] = mg;
    m = fmaxf(m, mg);
    // DPCA difference s1 - s2 e^{j cal}
    const float dre = v1.x - (v2.x * cr - v2.y * ci);
    const float dim = v1.y - (v2.x * ci + v2.y * cr);
    const float p = dre * dre + dim * dim;
    pw[idx] = p;
    pcol[r] = p;
  }
  m = nis::block_max(red, m);   // also orders the pcol writes
  if (threadIdx.x == 0) peaks[col] = m;
  for (int r = threadIdx.x; r < n_az; r += blockDim.x) {
    const size_t idx = (size_t)r * n_rg + col;
    cso[idx] = nis::window_sum(pcol, n_az, r, h_out);
    csi[idx] = nis::window_sum(pcol, n_az, r, h_in);
  }
}

__global__ void k4_kernel(
    const float* __restrict__ cso, const float* __restrict__ csi,
    const float* __restrict__ pw, const float* __restrict__ ph,
    const float* __restrict__ mag, const float* __restrict__ thr,
    const float* __restrict__ ch_o, const float* __restrict__ ch_i,
    const float* __restrict__ cw_o, const float* __restrict__ cw_i,
    float* __restrict__ snr, float* __restrict__ oph,
    float* __restrict__ odm, float* __restrict__ onoise, int n_rg,
    int h_out, int h_in) {
  float* so = reinterpret_cast<float*>(nis_smem);
  float* si = so + n_rg;
  const int row = blockIdx.x;
  const size_t base = (size_t)row * n_rg;
  for (int j = threadIdx.x; j < n_rg; j += blockDim.x) {
    so[j] = cso[base + j];
    si[j] = csi[base + j];
  }
  __syncthreads();
  const float th = thr[0];
  const float cho = ch_o[row];
  const float chi = ch_i[row];
  for (int j = threadIdx.x; j < n_rg; j += blockDim.x) {
    const size_t idx = base + j;
    const float outer = nis::window_sum(so, n_rg, j, h_out);
    const float inner = nis::window_sum(si, n_rg, j, h_in);
    const float n_train = fmaxf(cho * cw_o[j] - chi * cw_i[j], 1.0f);
    const float nz = (outer - inner) / n_train;
    onoise[idx] = nz;
    const float p = pw[idx];
    snr[idx] = p / fmaxf(nz, 1e-30f);
    oph[idx] = mag[idx] > th ? ph[idx] : 0.0f;
    odm[idx] = sqrtf(p);
  }
}

// Per-block partials of re / im of sum(x1 conj(x2)) over `rows` contiguous
// rows of the four planes, read as float4 (n_rg a multiple of 4).
__global__ void balance_kernel(
    const float4* __restrict__ x1r, const float4* __restrict__ x1i,
    const float4* __restrict__ x2r, const float4* __restrict__ x2i,
    float* __restrict__ part, int rows, int n_rg) {
  float* red = reinterpret_cast<float*>(nis_smem);
  const size_t n4 = (size_t)rows * n_rg / 4;
  const size_t base = (size_t)blockIdx.x * n4;
  float pr = 0.0f;
  float pi = 0.0f;
  for (size_t i = threadIdx.x; i < n4; i += blockDim.x) {
    const float4 ar = x1r[base + i], ai = x1i[base + i];
    const float4 br = x2r[base + i], bi = x2i[base + i];
    pr += ar.x * br.x + ai.x * bi.x;
    pi += ai.x * br.x - ar.x * bi.x;
    pr += ar.y * br.y + ai.y * bi.y;
    pi += ai.y * br.y - ar.y * bi.y;
    pr += ar.z * br.z + ai.z * bi.z;
    pi += ai.z * br.z - ar.z * bi.z;
    pr += ar.w * br.w + ai.w * bi.w;
    pi += ai.w * br.w - ar.w * bi.w;
  }
  pr = nis::block_sum(red, pr);
  pi = nis::block_sum(red, pi);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = pr;
    part[gridDim.x + blockIdx.x] = pi;
  }
}

}  // namespace

// Each launcher runs its kernel over (n_az, n_rg) f32 planes on `stream`
// (n_az, n_rg powers of two) and returns cudaGetLastError() after the launch.

template <int NCH>
static int k1_run(const float* x1r, const float* x1i, const float* x2r,
                  const float* x2i, const float* u, const float* c1,
                  const float* w, const float2* tw, float* z1r, float* z1i,
                  float* z2r, float* z2i, float* bal, int n_az, int n_rg,
                  int balance, void* stream) {
  const int threads = nis::threads_for(n_az);
  const int smem = NCH * n_az * (int)sizeof(float2)
                   + (NCH == 2 ? threads * (int)sizeof(float) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      k1_kernel<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k1_kernel<NCH><<<n_rg, threads, smem, (cudaStream_t)stream>>>(
      x1r, x1i, x2r, x2i, u, c1, w, tw, z1r, z1i, z2r, z2i, bal, n_az, n_rg,
      nis::log2_of(n_az), balance);
  return (int)cudaGetLastError();
}

extern "C" int k1g_launch(
    const float* x1r, const float* x1i, const float* x2r, const float* x2i,
    const float* u, const float* c1, const float* w, const float2* tw,
    float* z1r, float* z1i, float* z2r, float* z2i, float* bal, int n_az,
    int n_rg, int balance, void* stream) {
  return k1_run<2>(x1r, x1i, x2r, x2i, u, c1, w, tw, z1r, z1i, z2r, z2i, bal,
                   n_az, n_rg, balance, stream);
}

extern "C" int k1_launch(const float* xr, const float* xi, const float* u,
                         const float* c1, const float* w, const float2* tw,
                         float* zr, float* zi, int n_az, int n_rg,
                         void* stream) {
  return k1_run<1>(xr, xi, nullptr, nullptr, u, c1, w, tw, zr, zi, nullptr,
                   nullptr, nullptr, n_az, n_rg, 0, stream);
}

extern "C" int k3_launch(const float* zr, const float* zi, const float2* tw,
                         float* sr, float* si, int n_az, int n_rg,
                         void* stream) {
  const int smem = n_az * (int)sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      k3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k3_kernel<<<n_rg, nis::threads_for(n_az), smem, (cudaStream_t)stream>>>(
      zr, zi, tw, sr, si, n_az, n_rg, nis::log2_of(n_az));
  return (int)cudaGetLastError();
}

extern "C" int k3g_launch(
    const float* z1r, const float* z1i, const float* z2r, const float* z2i,
    const float* cal_cs, const float2* tw, float* s1r, float* s1i,
    float* s2r, float* s2i, float* ph, float* mag, float* pw, float* cso,
    float* csi, float* peaks, int n_az, int n_rg, int h_out, int h_in,
    void* stream) {
  const int threads = nis::threads_for(n_az);
  const int smem = 2 * n_az * (int)sizeof(float2)
                   + (n_az + threads) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      k3g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k3g_kernel<<<n_rg, threads, smem, (cudaStream_t)stream>>>(
      z1r, z1i, z2r, z2i, cal_cs, tw, s1r, s1i, s2r, s2i, ph, mag, pw, cso,
      csi, peaks, n_az, n_rg, nis::log2_of(n_az), h_out, h_in);
  return (int)cudaGetLastError();
}

extern "C" int k4_launch(
    const float* cso, const float* csi, const float* pw, const float* ph,
    const float* mag, const float* thr, const float* ch_o, const float* ch_i,
    const float* cw_o, const float* cw_i, float* snr, float* oph, float* odm,
    float* onoise, int n_az, int n_rg, int h_out, int h_in, void* stream) {
  const int smem = 2 * n_rg * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      k4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k4_kernel<<<n_az, nis::threads_for(n_rg), smem, (cudaStream_t)stream>>>(
      cso, csi, pw, ph, mag, thr, ch_o, ch_i, cw_o, cw_i, snr, oph, odm,
      onoise, n_rg, h_out, h_in);
  return (int)cudaGetLastError();
}

// `part` holds 2 x blocks floats (re partials, then im); each block reduces
// n_az / blocks contiguous rows (blocks divides n_az).
extern "C" int balance_launch(const float* x1r, const float* x1i,
                              const float* x2r, const float* x2i, float* part,
                              int n_az, int n_rg, int blocks, void* stream) {
  const int threads = 256;
  balance_kernel<<<blocks, threads, threads * (int)sizeof(float),
                   (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x1r),
      reinterpret_cast<const float4*>(x1i),
      reinterpret_cast<const float4*>(x2r),
      reinterpret_cast<const float4*>(x2i), part, n_az / blocks, n_rg);
  return (int)cudaGetLastError();
}
