// The NUFFT echo's group-window spread.
//
// Replaces the TPU kernel of nis_sar_amtigmti_video_tpu/ops/pallas/
// spread_kernel.py: spread_windows_pallas, with its bodies _kernel (taps
// added in the roll-chain order) and _kernel_qr (the digit-factorized
// one-hot: every tap and target of a window cell in one accumulator). Per
// (pulse, group) of delay-ordered targets b with window-relative tap-0 cells
// c_b and tap values v[s][k][b] for value sets s,
//
//   roll order:      out[s][j] = sum_k part_k[(j - k) mod win],
//                    part_k[i] = sum over b with c_b = i of v[s][k][b]
//   one accumulator: out[s][j] = sum over c_b + k = j of v[s][k][b]
//
// (real and imaginary parts alike); a target with c outside [0, win) drops
// at every tap. The TPU kernel built a (win, bg) one-hot in VMEM and
// contracted it on the MXU, with each f32 value split into bf16 hi and lo
// halves; here values stay float32 and no one-hot exists.
//
// What bounds it on the H100: bytes. At the NUFFT echo's full-scale chunk
// (512 pulses x 16 groups of 315 targets, win 4,096, one set of 8 taps) a
// launch reads 206 MB of values and cells and writes 268 MB of windows:
// 0.14 ms at 3.35 TB/s; the adds are ~40 M.
//
// Design: one block per (pulse, group), deterministic, no float atomics.
//   1. The group's cells (cells outside [0, win) marked dropped) and all of
//      its values are staged in shared memory; cell counts by shared integer
//      atomics.
//   2. A block scan turns the counts into cell starts; each target's slot in
//      its cell is the number of earlier targets in the same cell, so every
//      cell lists its targets in index order and every sum has a fixed
//      order. (The first design sorted each cell's list with one thread;
//      where targets outside the grid all clamp onto one cell that cost
//      O(bg^2) serial steps, 3.8 ms a full-scale chunk on the H100.)
//   3. One thread per output cell j gathers the targets of cells j - k over
//      the taps k in a fixed order (k ascending, targets ascending) and
//      writes the window cell: coalesced stores, each window written once.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// In place inclusive scan of a[0, n) by the whole block: warp w scans its
// contiguous segment 32 entries at a time (lanes on consecutive entries, so
// no bank conflicts, the running total carried across), then adds the
// totals of the segments before it. Ends with a barrier.
__device__ void block_inclusive_scan(int* a, int n, int* warp_tot) {
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
  const int seg = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(n, warp * seg), hi = min(n, lo + seg);
  int carry = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    int v = i < hi ? a[i] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (i < hi) a[i] = v + carry;
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
  if (lane == 0) warp_tot[warp] = carry;
  __syncthreads();
  int offset = 0;
  for (int w = 0; w < warp; ++w) offset += warp_tot[w];
  for (int i = lo + lane; i < hi; i += 32) a[i] += offset;
  __syncthreads();
}

// One block per (pulse, group): cells (bg,) int32, vals (S, 2K, bg) float32,
// out (2S, win) float32, all at offset blockIdx.x of their arrays.
template <bool kQr>
__global__ void __launch_bounds__(kThreads) spread_windows_kernel(
    const int* __restrict__ cells, const float* __restrict__ vals,
    float* __restrict__ out, int bg, int win, int n_sets, int k_taps) {
  extern __shared__ int smem[];
  int* s_cell = smem;                    // bg: cell, or -1 (dropped)
  int* s_list = s_cell + bg;             // bg: target indices by cell
  int* s_pos = s_list + bg;              // win + 1: cell starts
  float* s_val = reinterpret_cast<float*>(s_pos + win + 1);
  __shared__ int warp_tot[kWarps];

  const int tid = (int)threadIdx.x;
  const size_t item = blockIdx.x;
  const int nv = n_sets * 2 * k_taps * bg;
  const int* c_g = cells + item * bg;
  const float* v_g = vals + item * (size_t)nv;
  float* o_g = out + item * (size_t)(2 * n_sets) * win;

  for (int j = tid; j <= win; j += kThreads) s_pos[j] = 0;
  for (int i = tid; i < nv; i += kThreads) s_val[i] = __ldg(v_g + i);
  __syncthreads();
  for (int b = tid; b < bg; b += kThreads) {
    int c = __ldg(c_g + b);
    if (c < 0 || c >= win) c = -1;
    s_cell[b] = c;
    if (c >= 0) atomicAdd(s_pos + c + 1, 1);
  }
  __syncthreads();

  // counts -> s_pos[c] = cell c's start, s_pos[c + 1] its end
  block_inclusive_scan(s_pos + 1, win, warp_tot);
  // stable placement: a target's slot in its cell is the number of
  // targets before it in the same cell, so each cell lists its targets in
  // index order (a whole group can share one cell: targets outside the
  // grid are clamped onto its edges)
  for (int b = tid; b < bg; b += kThreads) {
    const int c = s_cell[b];
    if (c < 0) continue;
    int rank = 0;
    for (int e = 0; e < b; ++e) rank += s_cell[e] == c;
    s_list[s_pos[c] + rank] = b;
  }
  __syncthreads();

  for (int j = tid; j < win; j += kThreads) {
    for (int s = 0; s < n_sets; ++s) {
      const float* vr = s_val + (size_t)s * 2 * k_taps * bg;
      const float* vi = vr + (size_t)k_taps * bg;
      float acc_r = 0.f, acc_i = 0.f;
      for (int k = 0; k < k_taps; ++k) {
        int i = j - k;
        if (i < 0) {
          if (kQr) break;        // cells below 0 hold no target
          i += win;              // the roll wraps around the window
        }
        const int lo = s_pos[i], hi = s_pos[i + 1];
        if (kQr) {
          for (int e = lo; e < hi; ++e) {
            const int b = s_list[e];
            acc_r += vr[k * bg + b];
            acc_i += vi[k * bg + b];
          }
        } else {
          float pr = 0.f, pi = 0.f;
          for (int e = lo; e < hi; ++e) {
            const int b = s_list[e];
            pr += vr[k * bg + b];
            pi += vi[k * bg + b];
          }
          acc_r += pr;
          acc_i += pi;
        }
      }
      o_g[(size_t)(2 * s) * win + j] = acc_r;
      o_g[(size_t)(2 * s + 1) * win + j] = acc_i;
    }
  }
}

}  // namespace

// items = pc x grp blocks; qr selects the one-accumulator order. Returns the
// launch's CUDA error.
extern "C" int spread_windows_launch(const int* cells, const float* vals,
                                     float* out, int items, int bg, int win,
                                     int n_sets, int k_taps, int qr,
                                     void* stream) {
  const int smem = 4 * (2 * bg + win + 1 + n_sets * 2 * k_taps * bg);
  void (*kernel)(const int*, const float*, float*, int, int, int, int) =
      qr ? spread_windows_kernel<true> : spread_windows_kernel<false>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kernel<<<items, kThreads, smem, (cudaStream_t)stream>>>(
      cells, vals, out, bg, win, n_sets, k_taps);
  return (int)cudaGetLastError();
}
