// K2 pair: the range pass of CSA focusing for both GMTI channels.
//
// Replaces the TPU kernel nis_sar_amtigmti_video_tpu/ops/pallas/csa_kernel.py
// :: k2_pair_call / _k2g_body. Per azimuth row a, for both channels:
//
//   range FFT -> x Phi2 = exp(j (alpha(a) fr + beta(a)) fr)
//             -> range IFFT (1/N) -> x Phi3 = exp(j (rphase(a) + cphase(r)
//                                       + g(a) dr(r) - c3(a) u(r)^2))
//
// Phi2 and Phi3 do not depend on the data, so each is evaluated once per
// element and applied to both channels (as _k2g_body shares its trig).
//
// What bounds it on the H100: one read and one write of four f32 planes
// (4 x 64 MB each way at 4096^2) against ~2 x 5 N log2 N flops per row pair
// and 2 sincosf per element — memory and shared-memory traffic, not math.
// Design: one block owns one azimuth row of both channels (2 x N complex in
// shared memory, 64 KB at N = 4096), so the row is read and written once,
// contiguously; both FFTs run in shared memory. The forward transform is
// decimation in frequency (natural in, bit-reversed out) and the inverse
// decimation in time (bit-reversed in, natural out), so Phi2 is applied in
// bit-reversed order by indexing fr with the reversed index and no
// permutation pass is needed. sincosf is the accurate library routine (no
// fast math): Phi2 reaches hundreds of rad at the slice's shape.
#include "fft_smem.cuh"

namespace {

__global__ void k2_pair_kernel(
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
    b[i] = make_float2(x2r[base + i], x2i[base + i]);
  }
  __syncthreads();
  nis::fft_dif(a, 2, n, log2n, tw, false);

  const float al = alpha[row];
  const float be = beta[row];
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const float f = fr[nis::bitrev(p, log2n)];
    float sn, cs;
    sincosf((al * f + be) * f, &sn, &cs);
    const float2 phi = make_float2(cs, sn);
    a[p] = nis::cmul(a[p], phi);
    b[p] = nis::cmul(b[p], phi);
  }
  __syncthreads();
  nis::fft_dit(a, 2, n, log2n, tw, true);

  const float rp = rphase[row];
  const float gg = g[row];
  const float cc = c3[row];
  const float inv_n = 1.0f / (float)n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float sn, cs;
    sincosf(rp + cphase[i] + gg * dr[i] - cc * usq[i], &sn, &cs);
    const float2 phi = make_float2(cs, sn);
    const float2 y1 = nis::cmul(nis::cscale(a[i], inv_n), phi);
    const float2 y2 = nis::cmul(nis::cscale(b[i], inv_n), phi);
    o1r[base + i] = y1.x;
    o1i[base + i] = y1.y;
    o2r[base + i] = y2.x;
    o2i[base + i] = y2.y;
  }
}

}  // namespace

// Launches K2 pair over (n_az, n_rg) planes on `stream`; n_rg a power of two.
// Returns cudaGetLastError() after the launch.
extern "C" int k2_pair_launch(
    const float* x1r, const float* x1i, const float* x2r, const float* x2i,
    const float* fr, const float* alpha, const float* beta,
    const float* cphase, const float* dr, const float* usq,
    const float* rphase, const float* g, const float* c3, const float2* tw,
    float* o1r, float* o1i, float* o2r, float* o2i, int n_az, int n_rg,
    void* stream) {
  const int smem = 2 * n_rg * (int)sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      k2_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k2_pair_kernel<<<n_az, nis::threads_for(n_rg), smem,
                   (cudaStream_t)stream>>>(
      x1r, x1i, x2r, x2i, fr, alpha, beta, cphase, dr, usq, rphase, g, c3,
      tw, o1r, o1i, o2r, o2i, n_rg, nis::log2_of(n_rg));
  return (int)cudaGetLastError();
}

// Message of a CUDA error code returned by a launcher.
extern "C" const char* nis_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
