// The direct point-target echo accumulation.
//
// Replaces the TPU kernel of nis_sar_amtigmti_video_tpu/ops/pallas/
// echo_kernel.py: echo_accumulate (echo_kernel_body). For every pulse p and
// fast-time sample n,
//
//   out[p, n] = sum_b amp[p, b] gate(|arg| <= half)
//               exp(j (car[p, b] + k_pi arg^2)),
//   arg = t[n] - tau[p, b] - shift.
//
// One template serves both of ops/echo.py's direct routes:
//
// * echo_accumulate_kernel<false> (the 'pallas' backend) reads the float32
//   scalars (tau_rel, car, amp), each (P, B), that ops/echo.py's float64
//   geometry pass wrote to device memory;
// * echo_accumulate_kernel<true> (the 'jnp' direct engine on the card) forms
//   them itself from the float64 pulses (times, positions, velocities) and
//   targets (positions, RCS, one velocity): ops/echo.py::_geometry's
//   arithmetic, operation by operation in float64 (no contraction into
//   FMAs), the carrier wrapped to (-pi, pi] with round-half-even before its
//   cast to float32, tau_rel = tau - t_start cast to float32. No (P, B)
//   field reaches device memory.
//
// The work is one sin and one cos per (pulse, target, sample) inside the
// gate: at the VideoSAR ring's segment (500 pulses x 35 targets x 22,004
// samples, the 20 us chirp 12,001 samples long) 2.1e8 of the 3.85e8
// triples. The phase reaches pi K (Tp / 2)^2 (~7.9e3 rad at the 500 MHz /
// 20 us waveform), so the build has no fast math (the accurate sincosf) and
// the float32 arithmetic before it is rounded as the plain version rounds
// it (no contraction into FMAs); each sample sums its targets in target
// order, in float32.
//
// Design: a block of 256 threads takes one pulse; it forms (or loads) a
// tile of up to 256 targets' scalars into shared memory, one thread a
// target, and then sums chunks of 2,048 samples, each thread 8 samples 256
// apart (stores coalesced), so one shared-memory read of a target's scalars
// serves 8 samples. A thread's samples ascend, and so does arg along them
// (float32 subtraction rounds monotonically): where the gate misses its
// first and last sample it misses all, and the target costs the thread two
// tests. A pulse's chunks are dealt to ceil(chunks / 3) blocks, so a
// pulse's scalars are formed a few times (4 at 22,004 samples), not once
// per 256 samples. Scenes of more than 256 targets take the tiles in turn
// for every chunk.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // threads a block; targets a tile
constexpr int kPer = 8;                    // samples a thread, kThreads apart
constexpr int kChunk = kThreads * kPer;    // samples a block sums at once
constexpr int kChunksPerBlock = 3;
constexpr double kC = 299792458.0;         // ops/echo.py's _C
constexpr double kTwoPi = 6.283185307179586;  // ops/echo.py's _TWO_PI

// The 'pallas' backend's scalars, each (P, B) float32.
struct Fields {
  const float* tau;
  const float* car;
  const float* amp;
};

// The direct engine's float64 inputs: ts (P,), ps, vs (P, 3), pos0 (B, 3),
// rcs (B,), tgt_vel (3,); carrier_k = -2 pi fc; ant_k = pi L / lambda (0:
// no antenna pattern).
struct Geometry {
  const double* ts;
  const double* ps;
  const double* vs;
  const double* pos0;
  const double* rcs;
  const double* tgt_vel;
  double rx_offset, t_start, carrier_k, ant_k;
  int stop_and_go, sqrt_rcs;
};

struct Sum {
  const float* t_fast;   // (ns,) ascending
  float2* out;           // (P, ns)
  int num_p, num_b, ns;
  float k_pi, shift, half;
};

__device__ __forceinline__ double dot3(double ax, double ay, double az,
                                       double bx, double by, double bz) {
  return __dadd_rn(__dadd_rn(__dmul_rn(ax, bx), __dmul_rn(ay, by)),
                   __dmul_rn(az, bz));
}

__device__ __forceinline__ double norm3(double x, double y, double z) {
  return sqrt(dot3(x, y, z, x, y, z));
}

// ops/echo.py::_geometry for pulse p and target b, then the carrier and
// tau_rel of ops/echo.py::_direct, cast to float32.
__device__ void form_scalars(const Geometry& g, int p, int b, float& tau_rel,
                             float& car, float& amp) {
  const double t = g.ts[p];
  const double px = g.ps[3 * p], py = g.ps[3 * p + 1], pz = g.ps[3 * p + 2];
  const double vx = g.vs[3 * p], vy = g.vs[3 * p + 1], vz = g.vs[3 * p + 2];
  const double v_norm = norm3(vx, vy, vz);
  const double v_den = v_norm == 0.0 ? 1.0 : v_norm;
  const double dx = __ddiv_rn(vx, v_den), dy = __ddiv_rn(vy, v_den),
               dz = __ddiv_rn(vz, v_den);
  const double tx = __dadd_rn(g.pos0[3 * b], __dmul_rn(g.tgt_vel[0], t));
  const double ty = __dadd_rn(g.pos0[3 * b + 1], __dmul_rn(g.tgt_vel[1], t));
  const double tz = __dadd_rn(g.pos0[3 * b + 2], __dmul_rn(g.tgt_vel[2], t));
  const double ex = __dsub_rn(tx, px), ey = __dsub_rn(ty, py),
               ez = __dsub_rn(tz, pz);
  const double d_tx = norm3(ex, ey, ez);
  double rx = __dadd_rn(px, __dmul_rn(dx, g.rx_offset));
  double ry = __dadd_rn(py, __dmul_rn(dy, g.rx_offset));
  double rz = __dadd_rn(pz, __dmul_rn(dz, g.rx_offset));
  if (g.stop_and_go) {
    const double tau_a = __ddiv_rn(__dmul_rn(2.0, d_tx), kC);
    rx = __dadd_rn(rx, __dmul_rn(vx, tau_a));
    ry = __dadd_rn(ry, __dmul_rn(vy, tau_a));
    rz = __dadd_rn(rz, __dmul_rn(vz, tau_a));
  }
  const double d_rx = norm3(__dsub_rn(tx, rx), __dsub_rn(ty, ry),
                            __dsub_rn(tz, rz));
  const double tau = __ddiv_rn(__dadd_rn(d_tx, d_rx), kC);
  double a = g.sqrt_rcs ? sqrt(g.rcs[b]) : g.rcs[b];
  if (g.ant_k > 0.0) {
    const double p_norm = norm3(px, py, pz);
    const double cos_off = fmin(fmax(
        dot3(__ddiv_rn(-px, p_norm), __ddiv_rn(-py, p_norm),
             __ddiv_rn(-pz, p_norm), __ddiv_rn(ex, d_tx),
             __ddiv_rn(ey, d_tx), __ddiv_rn(ez, d_tx)), -1.0), 1.0);
    const double x = __dmul_rn(g.ant_k, sin(acos(cos_off)));
    const double sinc =
        fabs(x) > 1e-6 ? __ddiv_rn(sin(x), x == 0.0 ? 1.0 : x) : 1.0;
    a = __dmul_rn(a, __dmul_rn(sinc, sinc));
  }
  const double ph = __dmul_rn(g.carrier_k, tau);
  const double wrapped =
      __dsub_rn(ph, __dmul_rn(kTwoPi, rint(__ddiv_rn(ph, kTwoPi))));
  tau_rel = __double2float_rn(__dsub_rn(tau, g.t_start));
  car = __double2float_rn(wrapped);
  amp = __double2float_rn(a);
}

// Targets [b0, b0 + kThreads) of pulse p into shared memory, one a thread.
template <bool FormGeometry>
__device__ __forceinline__ void load_tile(const Fields& f, const Geometry& g,
                                          const Sum& s, int p, int b0,
                                          float* s_tau, float* s_car,
                                          float* s_amp) {
  const int b = b0 + (int)threadIdx.x;
  if (b >= s.num_b) return;
  if constexpr (FormGeometry) {
    form_scalars(g, p, b, s_tau[threadIdx.x], s_car[threadIdx.x],
                 s_amp[threadIdx.x]);
  } else {
    const size_t i = (size_t)p * s.num_b + b;
    s_tau[threadIdx.x] = __ldg(f.tau + i);
    s_car[threadIdx.x] = __ldg(f.car + i);
    s_amp[threadIdx.x] = __ldg(f.amp + i);
  }
}

template <bool FormGeometry>
__global__ void __launch_bounds__(kThreads) echo_accumulate_kernel(
    Fields f, Geometry g, Sum s) {
  __shared__ float s_tau[kThreads], s_car[kThreads], s_amp[kThreads];
  const int p = blockIdx.x;
  const int n_chunks = (s.ns + kChunk - 1) / kChunk;
  const bool one_tile = s.num_b <= kThreads;
  if (one_tile) {
    load_tile<FormGeometry>(f, g, s, p, 0, s_tau, s_car, s_amp);
    __syncthreads();
  }
  float2* out = s.out + (size_t)p * s.ns;
  for (int c = blockIdx.y; c < n_chunks; c += gridDim.y) {
    const int n0 = c * kChunk + (int)threadIdx.x;
    float t[kPer], re[kPer], im[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      t[k] = __ldg(s.t_fast + min(n0 + k * kThreads, s.ns - 1));
      re[k] = 0.f;
      im[k] = 0.f;
    }
    for (int b0 = 0; b0 < s.num_b; b0 += kThreads) {
      if (!one_tile) {
        __syncthreads();
        load_tile<FormGeometry>(f, g, s, p, b0, s_tau, s_car, s_amp);
        __syncthreads();
      }
      const int nb = min(kThreads, s.num_b - b0);
      for (int i = 0; i < nb; ++i) {
        const float tau = s_tau[i];
        if (__fsub_rn(__fsub_rn(t[kPer - 1], tau), s.shift) < -s.half ||
            __fsub_rn(__fsub_rn(t[0], tau), s.shift) > s.half)
          continue;                      // the gate misses all 8 samples
        const float car = s_car[i], amp = s_amp[i];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const float arg = __fsub_rn(__fsub_rn(t[k], tau), s.shift);
          if (fabsf(arg) <= s.half) {
            const float ph =
                __fadd_rn(car, __fmul_rn(s.k_pi, __fmul_rn(arg, arg)));
            float sn, cs;
            sincosf(ph, &sn, &cs);
            re[k] = __fadd_rn(re[k], __fmul_rn(amp, cs));
            im[k] = __fadd_rn(im[k], __fmul_rn(amp, sn));
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int n = n0 + k * kThreads;
      if (n < s.ns) out[n] = make_float2(re[k], im[k]);
    }
  }
}

template <bool FormGeometry>
int launch(const Fields& f, const Geometry& g, const Sum& s, void* stream) {
  const int n_chunks = (s.ns + kChunk - 1) / kChunk;
  const dim3 grid(s.num_p, (n_chunks + kChunksPerBlock - 1) / kChunksPerBlock);
  echo_accumulate_kernel<FormGeometry>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(f, g, s);
  return (int)cudaGetLastError();
}

}  // namespace

// (num_p, num_b) scalars and (ns,) ascending fast times -> (num_p, ns)
// complex64. Returns the launch's CUDA error.
extern "C" int echo_accumulate_launch(const float* tau, const float* car,
                                      const float* amp, const float* t_fast,
                                      float2* out, int num_p, int num_b,
                                      int ns, float k_pi, float shift,
                                      float half, void* stream) {
  return launch<false>(Fields{tau, car, amp}, Geometry{},
                       Sum{t_fast, out, num_p, num_b, ns, k_pi, shift, half},
                       stream);
}

// One channel of the direct engine: float64 pulses ts (num_p,), ps, vs
// (num_p, 3), targets pos0 (num_b, 3), rcs (num_b,), tgt_vel (3,), and
// (ns,) ascending float32 fast times -> (num_p, ns) complex64. Returns the
// launch's CUDA error.
extern "C" int echo_direct_launch(
    const double* ts, const double* ps, const double* vs, const double* pos0,
    const double* rcs, const double* tgt_vel, const float* t_fast,
    float2* out, int num_p, int num_b, int ns, int stop_and_go, int sqrt_rcs,
    float k_pi, float shift, float half, double rx_offset, double t_start,
    double carrier_k, double ant_k, void* stream) {
  const Geometry g{ts,        ps,      vs,        pos0,
                   rcs,       tgt_vel, rx_offset, t_start,
                   carrier_k, ant_k,   stop_and_go, sqrt_rcs};
  return launch<true>(Fields{}, g,
                      Sum{t_fast, out, num_p, num_b, ns, k_pi, shift, half},
                      stream);
}
