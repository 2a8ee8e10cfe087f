// The direct point-target echo accumulation.
//
// Replaces the TPU kernel of nis_sar_amtigmti_video_tpu/ops/pallas/
// echo_kernel.py: echo_accumulate (echo_kernel_body). For every pulse p and
// fast-time sample n,
//
//   out[p, n] = sum_b amp[p, b] gate(|arg| <= half)
//               exp(j (car[p, b] + k_pi arg^2)),
//   arg = t[n] - tau[p, b] - shift
//
// from the per-(pulse, target) float32 scalars that ops/echo.py's float64
// geometry pass produces. The TPU kernel laid the scalars out (targets,
// pulses) and computed (samples, pulses) tiles because Mosaic indexes only
// the sublane axis dynamically; here the scalars keep their (P, B) layout.
//
// The work the function needs is one sin and one cos per (pulse, target,
// sample) inside the gate: at the 4096^2 GMTI slice scene (2 x 4,097
// pulses x 4,096 samples, 35 + 500 targets) ~9.0e8 of the 1.8e10 triples.
// This kernel tests the gate of every triple. The phase reaches
// pi K (Tp / 2)^2 (~190 rad at the slice's waveform, ~7.9e3 rad at the
// full 500 MHz / 20 us one), so the build has no fast math and the
// arithmetic before sincosf is rounded as the plain version rounds it (no
// contraction into FMAs).
//
// Design: one thread per (pulse, sample), a block covering 256 samples of
// one pulse (a grid row walks pulses p, p + 65,535, ...); the pulse's
// target scalars pass through shared memory in tiles of 256 and every
// thread sums its sample over them in target order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) echo_accumulate_kernel(
    const float* __restrict__ tau, const float* __restrict__ car,
    const float* __restrict__ amp, const float* __restrict__ t_fast,
    float2* __restrict__ out, int num_p, int num_b, int ns, float k_pi,
    float shift, float half) {
  __shared__ float s_tau[kThreads], s_car[kThreads], s_amp[kThreads];
  const int n = blockIdx.x * kThreads + (int)threadIdx.x;
  const float t = n < ns ? __ldg(t_fast + n) : 0.f;
  for (int p = blockIdx.y; p < num_p; p += gridDim.y) {
    const size_t row = (size_t)p * num_b;
    float acc_r = 0.f, acc_i = 0.f;
    for (int b0 = 0; b0 < num_b; b0 += kThreads) {
      const int b = b0 + (int)threadIdx.x;
      __syncthreads();
      if (b < num_b) {
        s_tau[threadIdx.x] = __ldg(tau + row + b);
        s_car[threadIdx.x] = __ldg(car + row + b);
        s_amp[threadIdx.x] = __ldg(amp + row + b);
      }
      __syncthreads();
      const int nb = min(kThreads, num_b - b0);
      for (int i = 0; i < nb; ++i) {
        const float arg = __fsub_rn(__fsub_rn(t, s_tau[i]), shift);
        if (fabsf(arg) <= half) {
          const float ph =
              __fadd_rn(s_car[i], __fmul_rn(k_pi, __fmul_rn(arg, arg)));
          float s, c;
          sincosf(ph, &s, &c);
          acc_r = __fadd_rn(acc_r, __fmul_rn(s_amp[i], c));
          acc_i = __fadd_rn(acc_i, __fmul_rn(s_amp[i], s));
        }
      }
    }
    if (n < ns) out[(size_t)p * ns + n] = make_float2(acc_r, acc_i);
  }
}

}  // namespace

// (num_p, num_b) scalars and (ns,) fast times -> (num_p, ns) complex64.
// Returns the launch's CUDA error.
extern "C" int echo_accumulate_launch(const float* tau, const float* car,
                                      const float* amp, const float* t_fast,
                                      float2* out, int num_p, int num_b,
                                      int ns, float k_pi, float shift,
                                      float half, void* stream) {
  const dim3 grid((ns + kThreads - 1) / kThreads,
                  num_p < 65535 ? num_p : 65535);
  echo_accumulate_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tau, car, amp, t_fast, out, num_p, num_b, ns, k_pi, shift, half);
  return (int)cudaGetLastError();
}
