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
// launch reads 176 MB of values and cells and writes 268 MB of windows:
// 0.13 ms at 3.35 TB/s; the adds are ~40 M. The first design walked every
// window cell and tap (32,768 probes of the cell starts for at most 2,520
// occupied pairs) and ranked each target against every target before it:
// ~6K instructions a warp, bound by issue, not by bytes.
//
// Design: one block of 256 threads per (pulse, group), deterministic, no
// float atomics, ~26 KB of shared memory at the main pass and ~36 KB at the
// edge pass (six blocks an SM).
//   1. Staging, one of three (a template argument): the group's values go
//      to shared memory by cp.async (16-byte copies where aligned), in
//      flight while the cells are processed; or the block forms them there
//      from a few operands a target (the formed taps below), and the value
//      tensor, 176 MB a main launch at the full-scale chunk, is never
//      written or read.
//   2. Count: an occupancy bitmask of the window (one bit a cell, win / 32
//      words) by shared atomicOr; a prefix of the words' popcounts gives each
//      occupied cell its index among the occupied cells, u; per u, shared
//      integer atomics take the count of its targets and the least of them.
//   3. Scan (one warp): the counts become each occupied cell's start in the
//      target list.
//   4. Rank: a stable list (each cell's targets in index order) at O(1) a
//      target, however the cells are ordered: one warp walks the targets
//      of the cells of several targets 32 at a time in index order,
//      __match_any_sync over u giving each its rank among the equal cells
//      of its 32 and a running count per cell the targets before them (a
//      one-target cell needs no list: the gather reads its least target).
//   5. Gather and store: a thread takes 4 adjacent window cells j0 .. j0 + 3
//      and reads the occupancy of cells j0 - K + 1 .. j0 + 3 as one word
//      (a cell's occupied index: the first cell's plus the bits below); each
//      cell visits only its occupied predecessors (k ascending): a
//      one-target cell adds its value (its target and count in one word), a
//      cell of several targets its terms in list order (the roll order
//      through the per-tap partial). The 4 cells go out as one float4 a row
//      (16-byte, coalesced); a group with no occupied cell stores zeros at
//      once. A cell with no occupied predecessor is +0.0.
// The sums are the first design's, term for term: the same terms in the
// same order (k ascending, each cell's targets ascending), the roll order's
// per-tap partial sum starting at +0.0. The terms skipped are the empty
// cells' +0.0 partials, and a one-target cell adds v where the first design
// added the partial 0 + v: adding +0.0, or 0 + v for v, to a sum that
// started at +0.0 never changes it (no such sum is ever -0.0). So the
// windows are the first design's bit for bit.
//
// Formed taps (ops/cuda/spread_kernel.py::tap_sets is the same arithmetic
// in PyTorch, which the NUFFT echo ran before on (pulse, target, tap)
// tensors): per target the operands, (pc, rows, B) float32, target b of
// group g in column g bg + b (a column past B is padding: a dropped
// target, zeros); per (set, tap, target) one value pair, threads striding
// over them target-fastest (coalesced loads, conflict-free stores).
//   ES taps (the main pass; rows frac, a_re, a_im):
//     u = (k - (K/2 - 1)) - frac, w = |u| < K/2 ?
//     exp(beta (sqrt(clamp(1 - (2u/K)^2, 0, 1)) - 1)) : 0, values w a.
//   Flank taps (the exact-edge pass; rows a_re, a_im, then e0, c0, c1 a
//     set): ph = c0 + c1 k + c2 k^2, e = e0 + k / fs, a leading flank's gate
//     e >= -1e-12 and d = e, a trailing one's e <= t_edge + 1e-12 and d =
//     t_edge - e; tap = 0.5 + 0.5 cos(pi clamp(d / t_edge, 0, 1)); values
//     (gate ? tap : 0) (cos ph a_re - sin ph a_im, cos ph a_im + sin ph
//     a_re).
// Each value is the PyTorch operators' on the card bit for bit: their
// float32 operations in their order, one rounding each (the intrinsics keep
// nvcc from contracting a product and a sum into an FMA), the same libm
// functions (expf, sqrtf, cosf, sinf; no fast math), the Python scalars
// rounded as PyTorch rounds them (to float32; a division by a scalar is the
// product with its float32 reciprocal on the card). Steps 2-5 and their
// order of sums are the values staging's, so are the windows.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Step 1's stagings.
enum Staging : int { kValues = 0, kEsTaps = 1, kFlankTaps = 2 };

// What the formed taps read besides their operands: the float32 constants
// (ops/cuda/spread_kernel.py::_tap_args).
struct TapArgs {
  int n_targets;      // B: the operand rows' length
  int grp;            // groups a pulse
  int leading;        // flank taps: bit s set where set s is a leading flank
  float beta, inv_k;  // ES taps: beta, 1 / K
  float c2, fs, t_edge, inv_t_edge, pi, gate_lead, gate_trail;  // flank taps
};

__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool wide) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (wide)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

// i mod win in [0, win) for i >= -win * 2^20.
__device__ __forceinline__ int wrap_cell(int i, int win) {
  return i >= 0 ? i : (i % win + win) % win;
}

// For lo < 0 (the window's first cells): bit t of the result (t < 33) is
// the occupancy of cell lo + t; cells >= win are empty; a cell below 0 is
// cell (lo + t) mod win with `wrap` (the roll order), else empty.
__device__ __forceinline__ unsigned long long occupancy_below_0(
    const unsigned* occ, int lo, int win, bool wrap) {
  unsigned long long x = 0;
  for (int t = 0; t < 33; ++t) {
    int i = lo + t;
    if (i < 0) {
      if (!wrap) continue;
      i = wrap_cell(i, win);
    }
    if (i < win && ((occ[i >> 5] >> (i & 31)) & 1u)) x |= 1ull << t;
  }
  return x;
}

// The index of occupied cell i among the occupied cells.
__device__ __forceinline__ int occupied_index(const unsigned* occ,
                                              const int* word_pre, int i) {
  return word_pre[i >> 5] + __popc(occ[i >> 5] & ((1u << (i & 31)) - 1u));
}

// Step 1 of the formed taps: the group's values into s_val, (S, 2K, bg)
// (see the head of this file). ops: the (pc, rows, B) operands; item =
// pulse * grp + group.
template <int kStaging>
__device__ __forceinline__ void form_taps(const float* __restrict__ ops,
                                          float* s_val, int item, int bg,
                                          int n_sets, int k_taps,
                                          const TapArgs& ta) {
  const int n_b = ta.n_targets, p = item / ta.grp, g = item - p * ta.grp;
  const int rows = kStaging == kEsTaps ? 3 : 2 + 3 * n_sets;
  const float* op = ops + (size_t)p * rows * n_b;
  const int n_items = n_sets * k_taps * bg;
  // item i = sk bg + b, sk = s K + k, kept as (sk, b) while i strides
  int sk = 0, b = (int)threadIdx.x;
  while (b >= bg) {
    b -= bg;
    ++sk;
  }
  for (int i = (int)threadIdx.x; i < n_items; i += kThreads) {
    const int s = sk / k_taps, k = sk - s * k_taps;
    const int col = g * bg + b;
    float re = 0.f, im = 0.f;
    if (col < n_b) {
      if (kStaging == kEsTaps) {
        const float frac = __ldg(op + col), ar = __ldg(op + n_b + col),
                    ai = __ldg(op + 2 * (size_t)n_b + col);
        const float u = __fsub_rn((float)(k - (k_taps / 2 - 1)), frac);
        const float h = __fmul_rn(__fmul_rn(2.f, u), ta.inv_k);
        const float z2 =
            fminf(fmaxf(__fsub_rn(1.f, __fmul_rn(h, h)), 0.f), 1.f);
        const float w =
            fabsf(u) < 0.5f * (float)k_taps
                ? expf(__fmul_rn(ta.beta, __fsub_rn(__fsqrt_rn(z2), 1.f)))
                : 0.f;
        re = __fmul_rn(w, ar);
        im = __fmul_rn(w, ai);
      } else {
        const float ar = __ldg(op + col), ai = __ldg(op + n_b + col);
        const float* o = op + (size_t)(2 + 3 * s) * n_b + col;
        const float e0 = __ldg(o), c0 = __ldg(o + n_b),
                    c1 = __ldg(o + 2 * (size_t)n_b);
        const float kf = (float)k;
        const float ph = __fadd_rn(__fadd_rn(c0, __fmul_rn(c1, kf)),
                                   __fmul_rn(__fmul_rn(ta.c2, kf), kf));
        const float e = __fadd_rn(e0, __fdiv_rn(kf, ta.fs));
        const bool lead = (ta.leading >> s) & 1;
        const bool gate = lead ? e >= ta.gate_lead : e <= ta.gate_trail;
        const float d = lead ? e : __fsub_rn(ta.t_edge, e);
        const float z =
            fminf(fmaxf(__fmul_rn(d, ta.inv_t_edge), 0.f), 1.f);
        const float tap =
            __fadd_rn(0.5f, __fmul_rn(0.5f, cosf(__fmul_rn(z, ta.pi))));
        const float cs = cosf(ph), sn = sinf(ph);
        const float rot_r = __fsub_rn(__fmul_rn(cs, ar), __fmul_rn(sn, ai));
        const float rot_i = __fadd_rn(__fmul_rn(cs, ai), __fmul_rn(sn, ar));
        const float t = gate ? tap : 0.f;
        re = __fmul_rn(t, rot_r);
        im = __fmul_rn(t, rot_i);
      }
    }
    float* v = s_val + ((size_t)(2 * s) * k_taps + k) * bg + b;
    v[0] = re;
    v[(size_t)k_taps * bg] = im;
    b += kThreads;
    while (b >= bg) {
      b -= bg;
      ++sk;
    }
  }
}

// One block per (pulse, group): cells (bg,) int32, vals (S, 2K, bg) float32
// (the values staging) or the operands (form_taps), out (2S, win) float32,
// cells and out at offset blockIdx.x of their arrays. K <= 30, bg < 2^15.
template <bool kQr, int kStaging>
__global__ void __launch_bounds__(kThreads, 6) spread_windows_kernel(
    const int* __restrict__ cells, const float* __restrict__ vals,
    float* __restrict__ out, int bg, int win, int n_sets, int k_taps,
    TapArgs ta) {
  extern __shared__ float4 smem4[];
  const int nv = n_sets * 2 * k_taps * bg;
  const int nw = (win + 31) >> 5;
  float* s_val = reinterpret_cast<float*>(smem4);   // nv, 16-byte aligned
  int* s_key = reinterpret_cast<int*>(s_val + ((nv + 3) & ~3));
  int* s_list = s_key + bg;       // bg: targets by cell, stable
  int* s_cnt = s_list + bg;       // bg: u's count; then its targets ranked
  int* s_first = s_cnt + bg;      // bg: u's least target | its count << 16
  int* s_start = s_first + bg;    // bg + 1: u's start in s_list
  unsigned* s_occ = reinterpret_cast<unsigned*>(s_start + bg + 1);  // nw+1
  int* s_wpre = reinterpret_cast<int*>(s_occ + nw + 1);           // nw+1
  __shared__ int n_occ;

  const int tid = (int)threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t item = blockIdx.x;
  const int* c_g = cells + item * bg;
  const float* v_g = vals + item * (size_t)nv;
  float* o_g = out + item * (size_t)(2 * n_sets) * win;
  auto cell = [&](int b) {       // target b's cell, or -1 (dropped)
    const int c = __ldg(c_g + b);
    return c >= 0 && c < win ? c : -1;
  };

  // 1. staging: the values by cp.async (in flight until step 5) or the
  // formed taps; the cells, zeroed words and counts
  if constexpr (kStaging == kValues) {
    const bool wide = ((nv & 3) == 0) && ((size_t)v_g & 15) == 0;
    if (wide) {
      for (int i = 4 * tid; i < nv; i += 4 * kThreads)
        copy_async(s_val + i, v_g + i, true);
    } else {
      for (int i = tid; i < nv; i += kThreads)
        copy_async(s_val + i, v_g + i, false);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    form_taps<kStaging>(vals, s_val, (int)item, bg, n_sets, k_taps, ta);
  }
  for (int w = tid; w <= nw; w += kThreads) s_occ[w] = 0u;
  for (int u = tid; u < bg; u += kThreads) {
    s_cnt[u] = 0;
    s_first[u] = 0x7fffffff;
  }
  for (int b = tid; b < bg; b += kThreads) s_key[b] = cell(b);
  __syncthreads();

  // 2. count: occupancy; the occupied index u of each live target; per u
  // the count and the least target
  for (int b = tid; b < bg; b += kThreads) {
    const int c = s_key[b];
    if (c >= 0) atomicOr(s_occ + (c >> 5), 1u << (c & 31));
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base <= nw; base += 32) {
      const int w = base + lane;
      const int p = w < nw ? __popc(s_occ[w]) : 0;
      int x = p;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      if (w <= nw) s_wpre[w] = carry + x - p;
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) n_occ = carry;
  }
  __syncthreads();
  for (int b = tid; b < bg; b += kThreads) {
    const int c = s_key[b];
    if (c < 0) continue;
    const int u = occupied_index(s_occ, s_wpre, c);
    s_key[b] = u;
    atomicAdd(s_cnt + u, 1);
    atomicMin(s_first + u, b);
  }
  __syncthreads();
  const int n_u = n_occ;

  // 3. scan (one warp): s_start[u], the targets of the occupied cells
  // before u; lane l takes a run of ceil(n_u / 32) counts
  if (warp == 0) {
    const int per = (n_u + 31) >> 5;
    const int a0 = min(n_u, lane * per), a1 = min(n_u, a0 + per);
    int sum = 0;
    for (int i = a0; i < a1; ++i) sum += s_cnt[i];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
    for (int i = a0; i < a1; ++i) {
      const int n = s_cnt[i];
      s_start[i] = run;
      run += n;
      s_first[i] |= n << 16;
      s_cnt[i] = 0;
    }
    if (lane == 31) s_start[n_u] = incl;
  }
  __syncthreads();

  // 4. rank (one warp): the targets of the cells of several targets, 32 at
  // a time in index order; __match_any_sync gives each its rank among the
  // equal cells of its 32, a running count per cell the targets before them
  if (warp == 0) {
    const unsigned below = (1u << lane) - 1u;
    for (int base = 0; base < bg; base += 32) {
      const int b = base + lane;
      int u = b < bg ? s_key[b] : -1;
      if (u >= 0 && s_first[u] < (2 << 16)) u = -1;   // one target
      if (!__any_sync(kFull, u >= 0)) continue;
      const unsigned peers = __match_any_sync(kFull, u);
      const int rank = __popc(peers & below);
      if (u >= 0) s_list[s_start[u] + s_cnt[u] + rank] = b;
      __syncwarp();
      if (u >= 0 && rank == 0) s_cnt[u] += __popc(peers);
      __syncwarp();
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 5. gather and store, 4 cells a thread: bit t of `bits` is the occupancy
  // of cell lo + t, so cell j0 + d, tap k is bit d + K - 1 - k; where lo >= 0
  // the occupied index of the cell at bit t is that of cell lo plus the set
  // bits below t
  const unsigned tap_mask = (1u << k_taps) - 1u;
  const unsigned long long live_mask = (1ull << (k_taps + 3)) - 1ull;
  const bool vec = (win & 3) == 0;
  for (int j0 = 4 * tid; j0 < win; j0 += 4 * kThreads) {
    const int lo = j0 - k_taps + 1, w0 = max(lo, 0) >> 5;
    // s_occ holds one zero word after the window's, so w0 + 1 is in range
    const unsigned long long bits =
        (lo >= 0 ? (s_occ[w0] | ((unsigned long long)s_occ[w0 + 1] << 32))
                       >> (lo & 31)
                 : occupancy_below_0(s_occ, lo, win, !kQr)) & live_mask;
    if (bits == 0) {
      for (int s = 0; s < n_sets; ++s) {
        float* o = o_g + (size_t)(2 * s) * win + j0;
        if (vec) {
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          __stcs(reinterpret_cast<float4*>(o), zero);
          __stcs(reinterpret_cast<float4*>(o + win), zero);
        } else {
          for (int d = 0; d < 4 && j0 + d < win; ++d) o[d] = o[win + d] = 0.f;
        }
      }
      continue;
    }
    const int u_lo =
        lo >= 0 ? s_wpre[w0] + __popc(s_occ[w0] & ((1u << (lo & 31)) - 1u))
                : 0;
    for (int s = 0; s < n_sets; ++s) {
      const float* vr = s_val + (size_t)s * 2 * k_taps * bg;
      const float* vi = vr + (size_t)k_taps * bg;
      float re[4], im[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int j = j0 + d;
        unsigned m = (unsigned)(bits >> d) & tap_mask;
        float acc_r = 0.f, acc_i = 0.f;
        while (m) {
          const int t = 31 - __clz(m);          // the highest bit: least k
          m &= ~(1u << t);
          const int k = k_taps - 1 - t;
          const int u =
              lo >= 0 ? u_lo + __popcll(bits & ((1ull << (d + t)) - 1ull))
                      : occupied_index(s_occ, s_wpre, wrap_cell(j - k, win));
          const int info = s_first[u];
          const float* wr = vr + k * bg;
          const float* wi = vi + k * bg;
          if (info < (2 << 16)) {
            // one target: 0 + v is v for the sum (no such sum is -0.0)
            acc_r += wr[info & 0xffff];
            acc_i += wi[info & 0xffff];
          } else {
            const int e0 = s_start[u], e1 = e0 + (info >> 16);
            float pr = 0.f, pi = 0.f;
            for (int e = e0; e < e1; ++e) {
              const int b = s_list[e];
              if (kQr) {
                acc_r += wr[b];
                acc_i += wi[b];
              } else {
                pr += wr[b];
                pi += wi[b];
              }
            }
            if (!kQr) {
              acc_r += pr;
              acc_i += pi;
            }
          }
        }
        re[d] = acc_r;
        im[d] = acc_i;
      }
      float* o = o_g + (size_t)(2 * s) * win + j0;
      if (vec) {
        __stcs(reinterpret_cast<float4*>(o),
               make_float4(re[0], re[1], re[2], re[3]));
        __stcs(reinterpret_cast<float4*>(o + win),
               make_float4(im[0], im[1], im[2], im[3]));
      } else {
        for (int d = 0; d < 4 && j0 + d < win; ++d) {
          o[d] = re[d];
          o[win + d] = im[d];
        }
      }
    }
  }
}

// Shared memory of one block: the values (rounded up to 16 bytes), the
// target keys and list, the occupied cells' counts, least targets and
// starts, and the occupancy words and their prefix
// (ops/cuda/spread_kernel.py::smem_bytes says the same).
int smem_bytes(int bg, int win, int n_sets, int k_taps) {
  const int nv = n_sets * 2 * k_taps * bg, nw = (win + 31) / 32;
  return 4 * (((nv + 3) & ~3) + 5 * bg + 2 * nw + 3);
}

using SpreadKernel = void (*)(const int*, const float*, float*, int, int,
                              int, int, TapArgs);

// One spread launch of pc x grp blocks (items) on the stream.
int launch_spread(SpreadKernel kernel, const int* cells, const float* vals,
                  float* out, int items, int bg, int win, int n_sets,
                  int k_taps, const TapArgs& ta, void* stream) {
  if (k_taps < 1 || k_taps > 30) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(bg, win, n_sets, k_taps);
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kernel<<<items, kThreads, smem, (cudaStream_t)stream>>>(
      cells, vals, out, bg, win, n_sets, k_taps, ta);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The window placement: the group windows added into the field.
//
// Replaces no Pallas kernel: the JAX package places the windows with jnp in
// ops/echo_freq.py::_spread_dense (a gather, add and store of each group's
// 128-sample rows, group by group), as the plain version
// (ops/cuda/spread_kernel.py::place_windows_plain) does. Per field cell x
// of the cropped field [0, l_out) of pulse p, with the sets' integer cell
// offsets off[s] and each window's field cell base[p][g],
//
//   acc = 0
//   for s in sets, for g in groups (in order):
//     j = x + start - (base[p][g] + off[s])
//     if 0 <= j < win: acc += wins[p][g][2s + c][j]      (c: re, im)
//
// with start = win + lo, the padded field's first kept cell. This is the
// row loop's order of sums, set-major, then group, from +0.0; the loop
// also adds +0.0 where a window's padded rows cover a cell (the sub-row
// roll of an offset set), which never changes a sum that started at +0.0
// (no such sum is ever -0.0). So the field is the loop's bit for bit.
//
// What bounds it on the H100: bytes. At the full-scale chunk (512 pulses,
// 16 groups) the main pass reads at most its 268 MB of windows and writes
// two 103 MB planes, the edge pass reads at most 268 MB (less: most of the
// trailing flank's windows lie past the window's last sample) and writes
// 54 MB of complex64; the adds are ~0.1 G. The row loop moves ~6.6 GB a
// chunk through its zero fills, gathers, slab copies and stores.
//
// Design: one read of every window cell that lands in the cropped field and
// one write of every field cell. A block of 512 threads covers 2,048 cells
// of one pulse (grid: cell blocks x pulses), the pulse's group bases in
// shared memory; a thread takes 4 adjacent cells and, per (set, group) in
// the loop's order, adds the window's overlapping cells (one float4 a row
// where the window cell is 4-aligned, else per cell), then stores them
// once: float4 rows into the (re, im) planes at the conv's row stride, or
// two float4 of interleaved complex64. No zero fill, no index tensors, no
// atomics. Blocks of 512 threads ran the chunk's two launches in 0.218 ms;
// 256 or 128 threads 0.362, 256 threads of 8 cells 0.226, 1,024 threads
// 0.226 (H100 80GB HBM3, 700 W).
constexpr int kPlaceThreads = 512;
constexpr int kPlaceSets = 4;        // value sets a launch takes
constexpr int kPlaceGroups = 12288;  // group bases in 48 KB

struct SetOffsets {
  int v[kPlaceSets];
};

// wins (pc, grp, 2 S, win) float32; base (pc, grp) int32. Planes: out_r
// and out_i (pc, row_stride) float32; complex: out_r (pc, row_stride / 2)
// complex64 interleaved, out_i unused.
template <bool kComplex>
__global__ void __launch_bounds__(kPlaceThreads) place_windows_kernel(
    const float* __restrict__ wins, const int* __restrict__ base,
    float* __restrict__ out_r, float* __restrict__ out_i, int grp,
    int n_sets, int win, int start, int l_out, int row_stride,
    SetOffsets off) {
  extern __shared__ int s_base[];  // grp
  const int p = (int)blockIdx.y;
  for (int g = (int)threadIdx.x; g < grp; g += kPlaceThreads)
    s_base[g] = __ldg(base + (size_t)p * grp + g);
  __syncthreads();

  const float* w_p = wins + (size_t)p * grp * 2 * n_sets * win;
  const bool vec_in = (win & 3) == 0 && ((size_t)wins & 15) == 0;
  const int x0 = 4 * ((int)blockIdx.x * kPlaceThreads + (int)threadIdx.x);
  if (x0 >= l_out) return;
  float re[4] = {0.f, 0.f, 0.f, 0.f}, im[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < n_sets; ++s) {
    const int shift = x0 + start - off.v[s];
    for (int g = 0; g < grp; ++g) {
      const int j0 = shift - s_base[g];
      if (j0 <= -4 || j0 >= win) continue;
      const float* wr = w_p + ((size_t)g * 2 * n_sets + 2 * s) * win;
      const float* wi = wr + win;
      if (vec_in && (j0 & 3) == 0) {   // then 0 <= j0 <= win - 4
        const float4 r = __ldcs(reinterpret_cast<const float4*>(wr + j0));
        const float4 i = __ldcs(reinterpret_cast<const float4*>(wi + j0));
        re[0] += r.x; re[1] += r.y; re[2] += r.z; re[3] += r.w;
        im[0] += i.x; im[1] += i.y; im[2] += i.z; im[3] += i.w;
      } else {
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const int j = j0 + d;
          if (j >= 0 && j < win) {
            re[d] += __ldcs(wr + j);
            im[d] += __ldcs(wi + j);
          }
        }
      }
    }
  }

  const bool whole = x0 + 4 <= l_out && (row_stride & 3) == 0;
  if (kComplex) {
    float* o = out_r + (size_t)p * row_stride + 2 * (size_t)x0;
    if (whole && ((size_t)out_r & 15) == 0) {
      __stcs(reinterpret_cast<float4*>(o),
             make_float4(re[0], im[0], re[1], im[1]));
      __stcs(reinterpret_cast<float4*>(o + 4),
             make_float4(re[2], im[2], re[3], im[3]));
    } else {
      for (int d = 0; d < 4 && x0 + d < l_out; ++d) {
        o[2 * d] = re[d];
        o[2 * d + 1] = im[d];
      }
    }
  } else {
    float* o_r = out_r + (size_t)p * row_stride + x0;
    float* o_i = out_i + (size_t)p * row_stride + x0;
    if (whole && (((size_t)out_r | (size_t)out_i) & 15) == 0) {
      __stcs(reinterpret_cast<float4*>(o_r),
             make_float4(re[0], re[1], re[2], re[3]));
      __stcs(reinterpret_cast<float4*>(o_i),
             make_float4(im[0], im[1], im[2], im[3]));
    } else {
      for (int d = 0; d < 4 && x0 + d < l_out; ++d) {
        o_r[d] = re[d];
        o_i[d] = im[d];
      }
    }
  }
}

}  // namespace

// items = pc x grp blocks; qr selects the one-accumulator order. Returns the
// launch's CUDA error; cudaErrorInvalidValue for k_taps outside [1, 30].
extern "C" int spread_windows_launch(const int* cells, const float* vals,
                                     float* out, int items, int bg, int win,
                                     int n_sets, int k_taps, int qr,
                                     void* stream) {
  return launch_spread(qr ? spread_windows_kernel<true, kValues>
                          : spread_windows_kernel<false, kValues>,
                       cells, vals, out, items, bg, win, n_sets, k_taps,
                       TapArgs{}, stream);
}

// The formed taps (the roll order): ops (pc, rows, n_targets) float32,
// staging 1 (ES taps, one set) or 2 (flank taps, bit s of leading set where
// set s is a leading flank); the constants as TapArgs names them. Returns
// the launch's CUDA error; cudaErrorInvalidValue for a shape or staging it
// does not take.
extern "C" int spread_taps_launch(
    const int* cells, const float* ops, float* out, int pc, int grp, int bg,
    int win, int n_sets, int k_taps, int staging, int n_targets, int leading,
    float beta, float inv_k, float c2, float fs, float t_edge,
    float inv_t_edge, float pi, float gate_lead, float gate_trail,
    void* stream) {
  if (pc < 1 || grp < 1 || bg < 1 || n_targets < 1 ||
      (n_targets + grp - 1) / grp != bg || n_sets < 1 || n_sets > 8 ||
      (staging == kEsTaps && n_sets != 1) ||
      (staging != kEsTaps && staging != kFlankTaps))
    return (int)cudaErrorInvalidValue;
  const TapArgs ta = {n_targets, grp,   leading,    beta, inv_k,    c2,
                      fs,        t_edge, inv_t_edge, pi,   gate_lead,
                      gate_trail};
  return launch_spread(staging == kEsTaps
                           ? spread_windows_kernel<false, kEsTaps>
                           : spread_windows_kernel<false, kFlankTaps>,
                       cells, ops, out, pc * grp, bg, win, n_sets, k_taps, ta,
                       stream);
}

// pc pulses of grp group windows, n_sets value sets at cell offsets off0 ..
// off3; complex_out: out_r is (pc, l_out) complex64 (out_i unused), else
// out_r / out_i are planes of row_stride floats a pulse. Returns the
// launch's CUDA error; cudaErrorInvalidValue for a shape it does not take.
extern "C" int place_windows_launch(const float* wins, const int* base,
                                    float* out_r, float* out_i, int pc,
                                    int grp, int n_sets, int win, int start,
                                    int l_out, int row_stride,
                                    int complex_out, int off0, int off1,
                                    int off2, int off3, void* stream) {
  if (n_sets < 1 || n_sets > kPlaceSets || grp < 1 || grp > kPlaceGroups ||
      win < 1 || pc < 1 || pc > 65535 || l_out < 1)
    return (int)cudaErrorInvalidValue;
  const SetOffsets off = {{off0, off1, off2, off3}};
  const int cells = 4 * kPlaceThreads;   // a block's
  const dim3 grid((l_out + cells - 1) / cells, pc);
  const size_t smem = sizeof(int) * (size_t)grp;
  if (complex_out)
    place_windows_kernel<true><<<grid, kPlaceThreads, smem,
                                 (cudaStream_t)stream>>>(
        wins, base, out_r, out_i, grp, n_sets, win, start, l_out,
        row_stride, off);
  else
    place_windows_kernel<false><<<grid, kPlaceThreads, smem,
                                  (cudaStream_t)stream>>>(
        wins, base, out_r, out_i, grp, n_sets, win, start, l_out,
        row_stride, off);
  return (int)cudaGetLastError();
}
