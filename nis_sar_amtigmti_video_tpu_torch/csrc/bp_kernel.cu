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
// reference's zero-weighted padded pulses contribute nothing). Both run
// this design: the factor kernel at W 32 (a contraction depth of 64).
//
// What bounds it on the H100. At the VideoSAR full width (P 625 presummed
// pulses, 1,664 x 640 pixels, W 64) the W-deep complex contraction is
// 625 x 1664 x 640 x 8 W = 3.4e11 flop, 94 % of the arithmetic; on the f32
// FMA pipe (67 TFLOP/s) that alone is 5.1 ms, against ~30 MB of operands
// (0.01 ms at 3.35 TB/s). So the contraction goes to the tensor cores.
//
// The contraction. Per pulse and tile, the complex product V (rows x
// columns) = G (rows x m) . K (m x columns) is one real product of depth 2W
// with the columns as M, the stacked column kernel [Kr | Ki] as A and the
// window spectra as B, real and imaginary parts interleaved along N:
//   D[x][2y]     = sum_m Kr[x][m] Gr[y][m] + Ki[x][m] (-Gi[y][m]) = Re V[y][x]
//   D[x][2y + 1] = sum_m Kr[x][m] Gi[y][m] + Ki[x][m]   Gr[y][m]  = Im V[y][x]
// so one thread's accumulator pair of a wgmma m64n64 tile is one pixel's
// real and imaginary sum, and the epilogue needs no exchange. It runs at
// f32 grade as three TF32 passes, hi.hi + hi.lo + lo.hi accumulated in f32,
// with hi = cvt.rna.tf32(x) and lo = x - hi (read as TF32, its low 13 bits
// dropped): hi + lo carries 21 bits of x, so a product is good to ~2^-20,
// near f32 (one pass, 2^-11, misses the 1e-4 kernel-vs-plain budget). TF32
// and not the reference's bf16 x 3 split: at the same three passes bf16
// keeps 16 bits of x (~1.5e-5 a product), and the port's rule for f32-grade
// products is TF32 x 3. Instruction: wgmma.mma_async m64n64k8 TF32, A (the
// column kernel, computed, not loaded) from registers, B from shared memory
// in the K-major layout without swizzle (core matrices of 8 rows x 16
// bytes, 128 bytes apart along K, 64 W bytes apart along N). mma.sync
// m16n8k8 ran this contraction at ~13 SM cycles an HMMA per SM
// sub-partition, no faster than the f32 kernel it replaced.
//
// Cheaper exact tables. K[x][m] = z_x^k with z_x = exp(j 2 pi e_t(x) / W)
// and k the signed bin (fftfreq numerator): k = 8 a + b, b in [0, 8), so
// z^k = z^{8a} z^b from two per-column phasor tables of W/8 + 8 entries
// (16 sincospif a column at W 64 instead of 64), one complex multiply an
// entry in the consumer's registers. The ramp exp(j 2 pi k u0 / W) is built
// the same way per row. The focusing phase (tens of rad) keeps one accurate
// sincosf a pixel; the taper is the angle sum sin(a + b) of a per-row and a
// per-column sincospif. No fast math.
//
// Warp roles and the pulse ring. A block owns a 32 x 128 pixel tile and
// loops over its pulses, holding its sums in registers: no float atomics
// and a fixed order, so the result is deterministic (the ring mode stays
// bit-stable). 384 threads:
//   - 4 producer warps, per pulse: the band rows the tile's windows cover
//     (stride * 31 + W samples) and the pulse's per-row and per-column
//     scalars, by cp.async two pulses ahead into a ring of two; the per-row
//     terms and ramp phasors; the per-column phasor tables; the tapered
//     window DFT as 8-point DFTs in registers over samples W/8 apart, a
//     twiddle (float64-built), then W/8-point DFTs in registers; and the
//     ramped spectra split into TF32 hi / lo, stored as two B matrices;
//   - 2 consumer warpgroups, each 64 columns: per pair of k-steps the K
//     fragments (hi / lo) in registers, double-buffered, then six wgmma
//     (real and imaginary k-step, three passes each) into the tile's 64 x 64
//     accumulators, with the previous pulse's epilogue (a copy of its
//     accumulators) run between the groups.
// The contraction's operands sit in two slots, the epilogue's small terms
// in a ring of three; the producers fill slot t & 1 for pulse t + 1 while
// the consumers contract pulse t. Named barriers (bar.arrive / bar.sync)
// hand a slot over: FULL (producers arrive after a proxy fence, consumers
// wait), EMPTY (consumers arrive once the pulse's groups are done,
// producers wait), and one barrier among the producers between their
// steps. 191 KB of shared memory at W 64 (two 80 KB slots), so one block an
// SM; the full-width grid is 5 x 52 = 260 blocks, two waves on 132 SMs.
#include "fft_smem.cuh"

#include <cstdint>

// Hooks for scripts/probe_torch_bp_phases.py, which builds a copy with
// them defined; empty here.
#ifndef BP_PROBE_DECL
#define BP_PROBE_DECL
#define BP_MARK(i)
#define BP_PROBE_END
#endif

namespace {

constexpr int kTileY = 32;        // rows of a block's tile
constexpr int kTileX = 128;       // columns of a block's tile
constexpr int kConsumers = 256;   // 2 warpgroups of 64 columns each
constexpr int kProducers = 128;   // 4 warps
constexpr int kThreads = kConsumers + kProducers;
constexpr int kBarFull = 1;       // + slot; 0 is __syncthreads
constexpr int kBarEmpty = 3;      // + slot
constexpr int kBarProd = 5;       // the producers alone

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

// Shared memory, in bytes from the start: two slots of the contraction's
// per-pulse operands; a ring of three of the epilogue's per-pulse terms
// (the consumers run pulse t - 1's epilogue during pulse t's contraction);
// the producers' scratch and tables; the ring of two of the band rows and
// per-pulse scalars; the column abscissae.
template <int W>
struct Smem {
  static constexpr int kNA = W / 8;         // a of k = 8 a + b, [-W/16, W/16)
  static constexpr int kNT = kNA + 8;       // phasor table entries
  static constexpr int kR1 = W / 8;         // second-stage DFT length
  // sa1 [y][s1][m2]: 9 float2 an s1, R1 * 9 + 1 a row (bank-conflict
  // free for stage 2's lanes on rows)
  static constexpr int kPitch = kR1 * 9 + 1;
  static constexpr int kRzPitch = kNT + 1;  // rz row pitch (float2)
  static constexpr int kScal = 4 * kTileY + 4;   // u0, c0, c1, c2 rows; bt, ct
  // slot: float bh[2 kTileY][2W]  B hi, K-major core matrices: element
  //                               (k, n) at bofs(k, n)
  //       float bl[2 kTileY][2W]  B lo, the same
  //       float2 ct[kNT][kTileX]  z^{8a} then z^b per column
  static constexpr int kBh = 0;
  static constexpr int kBl = kBh + 2 * kTileY * 2 * W * 4;
  static constexpr int kCt = kBl + 2 * kTileY * 2 * W * 4;
  static constexpr int kSlot = kCt + kNT * kTileX * 8;
  // epilogue ring: float4 rt[kTileY]  sin, cos of pi (u0 + 0.5) / W; c1; c2
  //                float2 ch[kTileX]  sin, cos of pi e / W
  static constexpr int kEpi = 2 * kSlot;
  static constexpr int kEpiRt = 0;
  static constexpr int kEpiCh = kTileY * 16;
  static constexpr int kEpiSlot = kEpiCh + kTileX * 8;
  // the producers' scratch and tables
  static constexpr int kSa1 = kEpi + 3 * kEpiSlot;   // float2 [kTileY][kPitch]
  static constexpr int kRz = kSa1 + kTileY * kPitch * 8;  // [kTileY][kRzPitch]
  static constexpr int kRot = kRz + kTileY * kRzPitch * 8;  // float2 [kTileY]
  static constexpr int kTw = kRot + kTileY * 8;           // float2 [W]
  static constexpr int kTapw = kTw + W * 8;               // float [W]
  static constexpr int kScalRing = kTapw + W * 4;         // float [2][kScal]
  static constexpr int kBand = kScalRing + 2 * kScal * 4; // float2 [2][seg]
  static size_t bytes(int seg) {
    return (size_t)kBand + 2 * (size_t)seg * 8 + kTileX * 4;
  }
  // the float offset of B element (k, n): core matrix (n / 8, k / 4),
  // 2W / 4 of them along K at 32 floats each, row n % 8, column k % 4
  static __device__ __forceinline__ int bofs(int k, int n) {
    return ((n >> 3) * (W / 2) + (k >> 2)) * 32 + (n & 7) * 4 + (k & 3);
  }
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi rounded to TF32, lo = x - hi exactly; the tensor cores
// read lo's top 19 bits (dropping the low 13), so hi + lo carries x to
// ~2^-21 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The shared-memory descriptor of a K-major B tile without swizzle: core
// matrices 128 bytes apart along K (LBO) and sbo bytes apart along N.
__device__ __forceinline__ uint64_t b_desc(const void* p, int sbo) {
  const uint64_t a = (uint64_t)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x 64, this warpgroup's accumulators) = a b + (scale_d ? d : 0);
// a: this thread's fragment of the 64 x 8 TF32 A tile, b: a descriptor
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The signed bin of a phasor-table entry: 8 (e - W/16) for e < W/8, then
// e - W/8 (the b of z^b).
template <int W>
__device__ __forceinline__ int table_k(int e) {
  return e < W / 8 ? 8 * (e - W / 16) : e - W / 8;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmj(float2 a) {   // -j a
  return make_float2(a.y, -a.x);
}

// In place: the 4-point DFT sum_n v[n] exp(-2 pi i n k / 4), natural order
// in and out.
__device__ __forceinline__ void dft(float2 (&v)[4]) {
  const float2 a0 = cadd(v[0], v[2]), a1 = csub(v[0], v[2]);
  const float2 a2 = cadd(v[1], v[3]), a3 = cmj(csub(v[1], v[3]));
  v[0] = cadd(a0, a2);
  v[1] = cadd(a1, a3);
  v[2] = csub(a0, a2);
  v[3] = csub(a1, a3);
}

// In place: the 8-point DFT, natural order in and out, as the 4-point DFTs
// of the evens and odds and a radix-2 step.
__device__ __forceinline__ void dft(float2 (&v)[8]) {
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft(e);
  dft(o);
  constexpr float r = 0.70710678118654752f;   // w8 = (1 - j) / sqrt(2)
  const float2 w[4] = {o[0], make_float2(r * (o[1].x + o[1].y),
                                         r * (o[1].y - o[1].x)),
                       cmj(o[2]), make_float2(r * (o[3].y - o[3].x),
                                              -r * (o[3].x + o[3].y))};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], w[k]);
    v[k + 4] = csub(e[k], w[k]);
  }
}

// The taper power s^tp by squaring, without branches (tp < 16; the
// launcher refuses more).
__device__ __forceinline__ float taper_power(float s, int tp) {
  float r = 1.f;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    r = (tp >> b) & 1 ? r * s : r;
    s = s * s;
  }
  return r;
}

// 1 / x for x in [1e-4, 1]: the approximate reciprocal and one Newton
// step, within an ulp. Not __frcp_rn: its slow path for subnormal x is a
// subroutine call, and a call anywhere in the kernel makes ptxas wait for
// every wgmma to complete before the next.
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.f), r);
}

// Taper division and focusing phase of a consumer thread's pixels in the
// n8 tiles [i0, i1) of a pulse's accumulators d (rows 4 i + tq, columns
// xr + 8 h), into its sums. rt, sc: the pulse's per-row and the thread's
// per-column terms.
__device__ __forceinline__ void epilogue(const float (&d)[32],
                                         float2 (&acc)[8][2], int i0, int i1,
                                         const float4* rt,
                                         const float2 (&sc)[2],
                                         const float (&xv)[2], int tq,
                                         int taper_pow) {
#pragma unroll
  for (int i = i0; i < i1; ++i) {
    const float4 rw = rt[4 * i + tq];   // sin, cos, c1, c2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float xi = xv[h];
      // sin(pi (u0 + e + 0.5) / W) by the angle sum
      const float sv = fmaf(rw.x, sc[h].y, rw.y * sc[h].x);
      const float inv = recip(fmaxf(taper_power(sv, taper_pow), 1e-4f));
      float sn, cs;
      sincosf(rw.z * xi + rw.w * (xi * xi), &sn, &cs);
      const float2 v = make_float2(d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
      const float2 z = nis::cscale(nis::cmul(v, make_float2(cs, sn)), inv);
      acc[i][h] = make_float2(acc[i][h].x + z.x, acc[i][h].y + z.y);
    }
  }
}

// One pulse t of a consumer thread, after the FULL wait for its slot: the
// pulse's wgmma groups into d, and between them (PREV: t > t0) the
// epilogue of pulse t - 1 from e, a copy of its accumulators (its terms
// in the epilogue ring); then d is copied to e once the groups are done.
// The thread's A rows are xr and xr + 8 (columns of the tile), its D
// columns 8 i + 2 tq (+1). ptxas serialises the wgmma if a non-wgmma
// instruction reads an accumulator register while a group is in flight,
// or if such a read sits under a branch it cannot see is uniform: hence
// the copy, and PREV a template flag.
template <int W, bool PREV>
__device__ __forceinline__ void consume(const Args& a, const char* smem,
                                        int t, int t0, int t1,
                                        float (&d)[32], float (&e)[32],
                                        float2 (&acc)[8][2],
                                        const float (&xv)[2], int xr,
                                        int tq) {
  using S = Smem<W>;
  constexpr int kNA = S::kNA;
  constexpr int kPer = 64 / W;       // n8 tiles of epilogue a k-step pair
  constexpr int kSbo = 64 * W;       // bytes between core matrices along N
  const int sl = (t - t0) & 1;
  const char* slot = smem + sl * S::kSlot;
  const float* bh = reinterpret_cast<const float*>(slot + S::kBh);
  const float* bl = reinterpret_cast<const float*>(slot + S::kBl);
  const float2* ctab = reinterpret_cast<const float2*>(slot + S::kCt);
  const char* epi = smem + S::kEpi + ((t - t0 + 2) % 3) * S::kEpiSlot;
  const float4* rt = reinterpret_cast<const float4*>(epi + S::kEpiRt);
  const float2* ch = reinterpret_cast<const float2*>(epi + S::kEpiCh);
  // z^b of the thread's two columns for b = tq and tq + 4
  float2 zb[2][2];                   // [h][b = tq + 4 bb]
  float2 sc[2];                      // pulse t - 1's sin, cos of pi e / W
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int bb = 0; bb < 2; ++bb)
      zb[h][bb] = ctab[(kNA + tq + 4 * bb) * kTileX + xr + 8 * h];
    sc[h] = ch[xr + 8 * h];
  }
  // k-step pairs: bins m = 8 s + tq (+ 4), k = 8 a + tq (+ 4); the real
  // k-step s takes Kr against B rows m, the imaginary one W/8 + s Ki
  // against rows W + m. A fragments: [buffer][Kr hi, Kr lo, Ki hi, Ki lo]
  // [row xr (+8), k tq (+4)], double-buffered across k-step pairs (a
  // group's registers stay live until it completes)
  uint32_t af[2][4][4];
#pragma unroll
  for (int s = 0; s < W / 8; ++s) {
    uint32_t(&f)[4][4] = af[s & 1];
    if (s >= 2) wgmma_wait<1>();     // the group that read f is done
    const int ea = (s + W / 16) & (W / 8 - 1);   // z^{8a}: a = s or s - W/8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 z8 = ctab[ea * kTileX + xr + 8 * h];
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const float2 kz = nis::cmul(z8, zb[h][bb]);
        split_tf32(kz.x, f[0][h + 2 * bb], f[1][h + 2 * bb]);
        split_tf32(kz.y, f[2][h + 2 * bb], f[3][h + 2 * bb]);
      }
    }
    wgmma_fence();
    const uint64_t dr = b_desc(bh + 64 * s, kSbo);
    const uint64_t dr_l = b_desc(bl + 64 * s, kSbo);
    const uint64_t di = b_desc(bh + 64 * (W / 8 + s), kSbo);
    const uint64_t di_l = b_desc(bl + 64 * (W / 8 + s), kSbo);
    wgmma_tf32(d, f[0], dr, s > 0);
    wgmma_tf32(d, f[0], dr_l, 1);
    wgmma_tf32(d, f[1], dr, 1);
    wgmma_tf32(d, f[2], di, 1);
    wgmma_tf32(d, f[2], di_l, 1);
    wgmma_tf32(d, f[3], di, 1);
    wgmma_commit();
    if (PREV)
      epilogue(e, acc, s * kPer, s * kPer + kPer, rt, sc, xv, tq,
               a.taper_pow);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < 32; ++r) e[r] = d[r];
  if (t + 2 < t1) bar_arrive(kBarEmpty + sl, kThreads);   // B slot free
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1) accumulate_kernel(Args a) {
  using S = Smem<W>;
  constexpr int R1 = S::kR1;     // second-stage DFT length
  constexpr int kNA = S::kNA;
  constexpr int kNT = S::kNT;
  constexpr int kP = S::kPitch;
  constexpr int kRzP = S::kRzPitch;
  char* smem = reinterpret_cast<char*>(nis_smem);
  const int seg = a.stride * (kTileY - 1) + W;
  float2* tws = reinterpret_cast<float2*>(smem + S::kTw);
  float* tapw = reinterpret_cast<float*>(smem + S::kTapw);
  float* scal = reinterpret_cast<float*>(smem + S::kScalRing);
  float2* band = reinterpret_cast<float2*>(smem + S::kBand);
  float* xis = reinterpret_cast<float*>(band + 2 * seg);

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int t0 = blockIdx.z * a.sub_p;
  const int t1 = min(a.num_p, t0 + a.sub_p);
  BP_PROBE_DECL

  for (int i = tid; i < W; i += kThreads) {
    tws[i] = a.tw[i];
    tapw[i] = a.tapw[i];
  }
  for (int i = tid; i < kTileX; i += kThreads) xis[i] = a.xi[x0 + i];
  __syncthreads();

  // the role, as a value ptxas can see is warp-uniform: a role branch on
  // threadIdx itself is a divergent path to it, and wgmma in a divergent
  // path are serialised
  const int role = __shfl_sync(0xffffffffu, tid / kConsumers, 0);
  if (role != 0) {
    // ---------------- producers ----------------
    const int p = tid - kConsumers;
    float2* sa1 = reinterpret_cast<float2*>(smem + S::kSa1);
    float2* rz = reinterpret_cast<float2*>(smem + S::kRz);
    float2* rot = reinterpret_cast<float2*>(smem + S::kRot);
    // pulse t's band rows and scalars into ring entry b
    auto copy_pulse = [&](int t, int b) {
      if (t < t1) {
        const float2* src = a.rc2 + (size_t)t * a.n + a.band_start
                            + (size_t)y0 * a.stride;
        float2* dst = band + b * seg;
        for (int i = p; i < seg; i += kProducers) cp_async8(dst + i, src + i);
        float* sd = scal + b * S::kScal;
        const size_t r = (size_t)t * a.ny + y0;
        for (int y = p; y < kTileY; y += kProducers) {
          cp_async4(sd + y, a.u0 + r + y);
          cp_async4(sd + kTileY + y, a.c0 + r + y);
          cp_async4(sd + 2 * kTileY + y, a.c1 + r + y);
          cp_async4(sd + 3 * kTileY + y, a.c2 + r + y);
        }
        if (p == 0) {
          cp_async4(sd + 4 * kTileY, a.bt + t);
          cp_async4(sd + 4 * kTileY + 1, a.ct + t);
        }
      }
      cp_async_commit();
    };
    copy_pulse(t0, 0);
    copy_pulse(t0 + 1, 1);
    for (int t = t0; t < t1; ++t) {
      const int sl = (t - t0) & 1;
      char* slot = smem + sl * S::kSlot;
      float* bh = reinterpret_cast<float*>(slot + S::kBh);
      float* bl = reinterpret_cast<float*>(slot + S::kBl);
      float2* ctab = reinterpret_cast<float2*>(slot + S::kCt);
      char* epi = smem + S::kEpi + ((t - t0) % 3) * S::kEpiSlot;
      float4* rt = reinterpret_cast<float4*>(epi + S::kEpiRt);
      float2* ch = reinterpret_cast<float2*>(epi + S::kEpiCh);
      const float2* bnd = band + sl * seg;
      const float* sd = scal + sl * S::kScal;
      BP_MARK(4);
      if (t - t0 >= 2) bar_sync(kBarEmpty + sl, kThreads);  // slot free
      BP_MARK(5);
      cp_async_wait<1>();              // this thread's copies of pulse t
      bar_sync(kBarProd, kProducers);  // everyone's; scratch free
      BP_MARK(6);
      // -- per-row terms and ramp phasors: 4 threads a row, unrolled so
      //    that the evaluations interleave
      static_assert(kProducers == 4 * kTileY && kProducers == kTileX, "");
      {
        const int y = p >> 2;
        const int q = p & 3;
        const float u = sd[y];
#pragma unroll
        for (int e = q; e < kNT; e += 4) {
          float sn, cs;
          sincospif(u * (2.f * (float)table_k<W>(e) / (float)W), &sn, &cs);
          rz[y * kRzP + e] = make_float2(cs, sn);
        }
        if (q == 0) {
          float sn, cs, sr, cr;
          sincospif((u + 0.5f) / (float)W, &sn, &cs);
          sincosf(sd[kTileY + y], &sr, &cr);
          rot[y] = make_float2(cr, sr);
          rt[y] = make_float4(sn, cs, sd[2 * kTileY + y],
                              sd[3 * kTileY + y]);
        }
      }
      // -- per-column phasor tables: a thread a column; z^0 = 1 and
      //    z^{-8a} = conj(z^{8a}) exactly, so W/16 + 7 sincospif a column
      {
        constexpr int kA = W / 16;     // a in [-kA, kA): entry kA + a
        const float xi = xis[p];
        const float e = sd[4 * kTileY] * xi + sd[4 * kTileY + 1] * (xi * xi);
        float2* col = ctab + p;
        col[kA * kTileX] = make_float2(1.f, 0.f);
        col[kNA * kTileX] = make_float2(1.f, 0.f);
#pragma unroll
        for (int q = 1; q <= kA; ++q) {
          float sn, cs;
          sincospif(e * (16.f * (float)q / (float)W), &sn, &cs);
          if (q < kA) col[(kA + q) * kTileX] = make_float2(cs, sn);
          col[(kA - q) * kTileX] = make_float2(cs, -sn);
        }
#pragma unroll
        for (int b = 1; b < 8; ++b) {
          float sn, cs;
          sincospif(e * (2.f * (float)b / (float)W), &sn, &cs);
          col[(kNA + b) * kTileX] = make_float2(cs, sn);
        }
        float sn, cs;
        sincospif(e / (float)W, &sn, &cs);
        ch[p] = make_float2(sn, cs);
      }
      BP_MARK(7);
      // -- tapered window DFT, stage 1: window sample s = s1 + R1 s2,
      //    A[y][s1][m2] = w^(s1 m2) x the 8-point DFT over s2 of the
      //    tapered x[s], w = e^{-2 pi i / W}; a thread an (y, s1)
#pragma unroll
      for (int it = 0; it < kTileY * R1 / kProducers; ++it) {
        // (index arithmetic by shifts and masks: R1 is a power of 2)
        const unsigned i = p + it * kProducers;
        const unsigned y = i / R1;
        const unsigned s1 = i & (R1 - 1);
        const float2* xb = bnd + y * a.stride + s1;
        float2 v[8];
#pragma unroll
        for (int s2 = 0; s2 < 8; ++s2)
          v[s2] = nis::cscale(xb[R1 * s2], tapw[s1 + R1 * s2]);
        dft(v);
        float2* o = sa1 + y * kP + s1 * 9;
        o[0] = v[0];
#pragma unroll
        for (int m2 = 1; m2 < 8; ++m2)
          o[m2] = nis::cmul(v[m2], tws[(s1 * m2) & (W - 1)]);
      }
      bar_sync(kBarProd, kProducers);
      copy_pulse(t + 2, sl);           // stage 1 has read this entry
      BP_MARK(8);
      // -- stage 2: bin m = m2 + 8 m1 is the R1-point DFT over s1 of
      //    A[y][s1][m2]; then the ramp z^k = z^{8a} z^{m2} (k = 8a + m2)
      //    and e^{j c0}, split into TF32 hi / lo: B rows m (Gr, Gi) and
      //    W + m (-Gi, Gr) of columns 2y, 2y + 1. A thread an (y, m2).
#pragma unroll
      for (int it = 0; it < kTileY * 8 / kProducers; ++it) {
        const unsigned i = p + it * kProducers;
        const unsigned m2 = i & 7;
        const unsigned y = i >> 3;
        float2 v[R1];
#pragma unroll
        for (int s1 = 0; s1 < R1; ++s1) v[s1] = sa1[y * kP + s1 * 9 + m2];
        dft(v);
        const float2 zr = nis::cmul(rz[y * kRzP + kNA + m2], rot[y]);
#pragma unroll
        for (int m1 = 0; m1 < R1; ++m1) {
          // a = m1, or m1 - W/8 for the negative bins: entry a + W/16
          const float2 ramp = nis::cmul(
              rz[y * kRzP + ((m1 + W / 16) & (W / 8 - 1))], zr);
          const float2 g = nis::cmul(v[m1], ramp);
          uint32_t rh, rl, ih, il;
          split_tf32(g.x, rh, rl);
          split_tf32(g.y, ih, il);
          const unsigned m = m2 + 8 * m1;
          const int o0 = S::bofs(m, 2 * y), o1 = S::bofs(m, 2 * y + 1);
          const int o2 = S::bofs(W + m, 2 * y);
          const int o3 = S::bofs(W + m, 2 * y + 1);
          bh[o0] = __uint_as_float(rh);
          bh[o1] = __uint_as_float(ih);
          bh[o2] = -__uint_as_float(ih);
          bh[o3] = __uint_as_float(rh);
          bl[o0] = __uint_as_float(rl);
          bl[o1] = __uint_as_float(il);
          bl[o2] = -__uint_as_float(il);
          bl[o3] = __uint_as_float(rl);
        }
      }
      // the B tiles are read through the tensor cores' async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      BP_MARK(9);
      bar_arrive(kBarFull + sl, kThreads);
    }
    cp_async_wait<0>();
  } else {
    // ---------------- consumers ----------------
    const int wg = tid >> 7;           // warpgroup: columns 64 wg + [0, 64)
    const int lane = tid & 31;
    const int g = lane >> 2;           // fragment row group
    const int tq = lane & 3;           // fragment thread in group
    const int xr = 64 * wg + 16 * ((tid >> 5) & 3) + g;   // rows xr, xr + 8
    const float xv[2] = {xis[xr], xis[xr + 8]};
    float2 acc[8][2];                  // [n8 tile: row 4 i + tq][xr + 8 h]
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) acc[i][h] = make_float2(0.f, 0.f);
    // the accumulators of the pulse in flight, and a copy of the last
    // pulse's for its epilogue
    float d[32], e[32];
    if (t0 < t1) {
      BP_MARK(0);
      bar_sync(kBarFull + 0, kThreads);
      BP_MARK(1);
      consume<W, false>(a, smem, t0, t0, t1, d, e, acc, xv, xr, tq);
      BP_MARK(2);
    }
    for (int t = t0 + 1; t < t1; ++t) {
      bar_sync(kBarFull + ((t - t0) & 1), kThreads);
      BP_MARK(1);
      consume<W, true>(a, smem, t, t0, t1, d, e, acc, xv, xr, tq);
      BP_MARK(2);
    }
    if (t1 > t0) {                     // the last pulse's epilogue
      const char* epi = smem + S::kEpi + ((t1 - 1 - t0) % 3) * S::kEpiSlot;
      const float4* rt = reinterpret_cast<const float4*>(epi + S::kEpiRt);
      const float2* ch = reinterpret_cast<const float2*>(epi + S::kEpiCh);
      const float2 sc[2] = {ch[xr], ch[xr + 8]};
      epilogue(e, acc, 0, 8, rt, sc, xv, tq, a.taper_pow);
    }
    BP_MARK(3);

    float2* dst = a.out + ((size_t)blockIdx.z * a.ny + y0) * a.ncols + x0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        dst[(size_t)(4 * i + tq) * a.ncols + xr + 8 * h] = acc[i][h];
  }
  BP_PROBE_END
}

template <int W>
int launch(const Args& a, int n_sub, cudaStream_t stream) {
  if (a.taper_pow < 0 || a.taper_pow > 15) return (int)cudaErrorInvalidValue;
  const int seg = a.stride * (kTileY - 1) + W;
  const size_t smem = Smem<W>::bytes(seg);
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
// [band_start, band_start + stride (ny - 1) + w) lie inside each pulse;
// taper_pow in [0, 15]. Returns cudaErrorInvalidValue for a w or
// taper_pow outside these, else cudaGetLastError() after the launch.
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
