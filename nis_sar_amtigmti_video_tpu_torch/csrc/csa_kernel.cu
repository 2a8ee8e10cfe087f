// K2: the range pass of CSA focusing, for one channel or both GMTI channels.
//
// Replaces the TPU kernels nis_sar_amtigmti_video_tpu/ops/pallas/csa_kernel.py
// :: _k2_call / _k2_body (one channel, k2_kernel<1>) and k2_pair_call /
// _k2g_body (both channels, k2_kernel<2>). Per azimuth row a:
//
//   range FFT -> x Phi2 = exp(j (alpha(a) fr + beta(a)) fr)
//             -> range IFFT (1/N) -> x Phi3 = exp(j (rphase(a) + cphase(r)
//                                       + g(a) dr(r) - c3(a) u(r)^2))
//
// Phi2 and Phi3 do not depend on the data, so each is evaluated once per
// element and applied to every channel (as _k2g_body shares its trig). The
// two instances run the same code per channel, so K2 on one channel gives
// the pair's bits for it.
//
// What bounds it on the H100: one read and one write of the planes (2 or 4 x
// 64 MB each way at 4096^2) against ~2 x 5 N log2 N flops per row and channel
// and 2 sincosf per element — memory and shared-memory traffic, not math.
// Design: one block owns one azimuth row of each channel (N complex in
// shared memory per channel, 32 KB at N = 4096), so the row is read and
// written once, contiguously; the FFTs run in shared memory. The forward
// transform is decimation in frequency (natural in, bit-reversed out) and the
// inverse decimation in time (bit-reversed in, natural out), so Phi2 is
// applied in bit-reversed order by indexing fr with the reversed index and no
// permutation pass is needed. sincosf is the accurate library routine (no
// fast math): Phi2 reaches hundreds of rad at the slice's shape.
#include "fft_smem.cuh"

namespace {

// x2*, o2* unused when NCH == 1.
template <int NCH>
__global__ void k2_kernel(
    const float* __restrict__ x1r, const float* __restrict__ x1i,
    const float* __restrict__ x2r, const float* __restrict__ x2i,
    const float* __restrict__ fr, const float* __restrict__ alpha,
    const float* __restrict__ beta, const float* __restrict__ cphase,
    const float* __restrict__ dr, const float* __restrict__ usq,
    const float* __restrict__ rphase, const float* __restrict__ g,
    const float* __restrict__ c3, const float2* __restrict__ tw,
    float* __restrict__ o1r, float* __restrict__ o1i,
    float* __restrict__ o2r, float* __restrict__ o2i, int n, int log2n) {
  float2* a = reinterpret_cast<float2*>(nis_smem);
  float2* b = a + n;
  const int row = blockIdx.x;
  const size_t base = (size_t)row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    a[i] = make_float2(x1r[base + i], x1i[base + i]);
    if constexpr (NCH == 2) b[i] = make_float2(x2r[base + i], x2i[base + i]);
  }
  __syncthreads();
  nis::fft_dif(a, NCH, n, log2n, tw, false);

  const float al = alpha[row];
  const float be = beta[row];
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const float f = fr[nis::bitrev(p, log2n)];
    float sn, cs;
    sincosf((al * f + be) * f, &sn, &cs);
    const float2 phi = make_float2(cs, sn);
    a[p] = nis::cmul(a[p], phi);
    if constexpr (NCH == 2) b[p] = nis::cmul(b[p], phi);
  }
  __syncthreads();
  nis::fft_dit(a, NCH, n, log2n, tw, true);

  const float rp = rphase[row];
  const float gg = g[row];
  const float cc = c3[row];
  const float inv_n = 1.0f / (float)n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float sn, cs;
    sincosf(rp + cphase[i] + gg * dr[i] - cc * usq[i], &sn, &cs);
    const float2 phi = make_float2(cs, sn);
    const float2 y1 = nis::cmul(nis::cscale(a[i], inv_n), phi);
    o1r[base + i] = y1.x;
    o1i[base + i] = y1.y;
    if constexpr (NCH == 2) {
      const float2 y2 = nis::cmul(nis::cscale(b[i], inv_n), phi);
      o2r[base + i] = y2.x;
      o2i[base + i] = y2.y;
    }
  }
}

template <int NCH>
int k2_run(const float* x1r, const float* x1i, const float* x2r,
           const float* x2i, const float* fr, const float* alpha,
           const float* beta, const float* cphase, const float* dr,
           const float* usq, const float* rphase, const float* g,
           const float* c3, const float2* tw, float* o1r, float* o1i,
           float* o2r, float* o2i, int n_az, int n_rg, void* stream) {
  const int smem = NCH * n_rg * (int)sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      k2_kernel<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k2_kernel<NCH><<<n_az, nis::threads_for(n_rg), smem,
                   (cudaStream_t)stream>>>(
      x1r, x1i, x2r, x2i, fr, alpha, beta, cphase, dr, usq, rphase, g, c3,
      tw, o1r, o1i, o2r, o2i, n_rg, nis::log2_of(n_rg));
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K2 pair / K2 over (n_az, n_rg) planes on `stream`; n_rg a power of
// two. Each returns cudaGetLastError() after the launch.
extern "C" int k2_pair_launch(
    const float* x1r, const float* x1i, const float* x2r, const float* x2i,
    const float* fr, const float* alpha, const float* beta,
    const float* cphase, const float* dr, const float* usq,
    const float* rphase, const float* g, const float* c3, const float2* tw,
    float* o1r, float* o1i, float* o2r, float* o2i, int n_az, int n_rg,
    void* stream) {
  return k2_run<2>(x1r, x1i, x2r, x2i, fr, alpha, beta, cphase, dr, usq,
                   rphase, g, c3, tw, o1r, o1i, o2r, o2i, n_az, n_rg, stream);
}

extern "C" int k2_launch(
    const float* xr, const float* xi, const float* fr, const float* alpha,
    const float* beta, const float* cphase, const float* dr,
    const float* usq, const float* rphase, const float* g, const float* c3,
    const float2* tw, float* o_re, float* o_im, int n_az, int n_rg,
    void* stream) {
  return k2_run<1>(xr, xi, nullptr, nullptr, fr, alpha, beta, cphase, dr, usq,
                   rphase, g, c3, tw, o_re, o_im, nullptr, nullptr, n_az,
                   n_rg, stream);
}

// Message of a CUDA error code returned by a launcher.
extern "C" const char* nis_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
