// The column passes of CSA focusing and the GMTI CPI's epilogue: K1 / K1g,
// K3 / K3g, K4 and the raw balance reduction.
//
// K1g replaces nis_sar_amtigmti_video_tpu/ops/pallas/gmti_kernel.py
//     :: k1_gmti_planes / _k1g_body. Azimuth (column) FFT of both channels,
//     x Phi1 = exp(j c1(a) (u(r) - w(a))^2), plus each column's raw balance
//     sum of x1 conj(x2) (the balance phase needs only their angle, and the
//     CSA chain is unitary up to a positive scale).
// K1  replaces ops/pallas/csa_kernel.py :: _k1_call / _k1_body: the same
//     pass for one channel (k1_kernel<1, ...>; K1g is k1_kernel<2, ...> on
//     the same split of n_az, so K1 on a channel gives K1g's bits for it).
// K3g replaces ops/pallas/gmti_kernel.py :: k3_gmti_planes / _k3g_call /
//     _k3g_body. Inverse azimuth FFT (1/N) of both channels, then every
//     product plane from the column still in shared memory: s1, s2, the
//     unmasked ATI phase angle(s1 conj(s2) e^{-j cal}), |s1|^2, the DPCA power
//     |s1 - s2 e^{j cal}|^2, the azimuth halves of the outer and inner CFAR
//     box sums of that power, and the column's max |s1|^2.
// K3  replaces ops/pallas/csa_kernel.py :: _k3_call / _k3_body: the inverse
//     azimuth FFT (1/N) of one channel, through K3g's column pass
//     (column_passes / column_gather), so it gives K3g's s1 bits.
// K4  replaces ops/pallas/gmti_kernel.py :: k4_epilogue_planes / _k4_body.
//     Per range row: the range halves of both box sums, exact training counts
//     (rank-1 vectors), noise, snr, the peak-referenced phase mask and dmag.
// Balance replaces ops/pallas/gmti_kernel.py :: raw_balance_pallas /
//     _balance_body: re and im of sum(x1 conj(x2)) over the raw pair.
//
// What bounds them on the H100: bytes. K1g moves 4 + 4 planes, K1 and K3
// 2 + 2, K3g 4 + 9, K4 5 + 4, balance 4 read (64 MB per plane at 4096^2); the
// FFT flops and the sincosf / atan2f per element are small beside that.
// Design of K1 / K1g and K3 / K3g: a cluster of blocks owns a tile of
// adjacent columns, at least 8 wide, so every row segment it reads or
// writes is whole 32-byte sectors of each plane. The tile's columns do not
// fit one block at 4096 (8 columns of K3g: 512 KB of spectra and 128 KB of
// power), so the transform is a four-step split of n_az across the
// cluster: each block transforms a strided row set in two register passes
// (QA- and QB-point DFTs, one block barrier between them), and after one
// cluster barrier each block gathers its output rows' partial spectra from
// the others through distributed shared memory and finishes them with a
// CS-point DFT in registers (see "The column DFT" below). K1 / K1g run it
// forward and multiply each gathered value by Phi1 as they store it; K1g's
// balance sums come from the gathered spectra of both channels (Parseval).
// K3 / K3g run it inverse; K3g's products come from the gathered values;
// its box sums close over the power each block keeps, with the 16 rows
// beyond each end of a block's chunks of rows copied once from the blocks
// holding them. ops/cuda/csa_kernel.py::column_plan picks the tile width
// and cluster size and the launchers check them. K4 owns whole range rows,
// so its box sums close in the block. Balance reads the four planes as
// float4 on a grid sized to the card, several loads in flight a thread, and
// closes its sum in the same launch (see balance_kernel).
// Azimuth sides that are not powers of two run at their own length. Those
// ops/cuda/csa_kernel.py::factored_split takes (the upstream's 7,199
// pulses after the DPCA shift = 23 x 313, and 7,200 = 32 x 225) run as
// prime-factor transforms in one launch of the kernel's factored
// instantiation (STAGE kFactored; see "The factored column DFT" below).
// Every other side (a prime such as 7,193) runs as a chirp-z transform
// (Bluestein) of the CPI's own length, on the column pass of m points, m
// the least power of two of at least 2 n_az - 1 (16,384 at 7,193): no
// padding of the data, the DFT of n_az points exactly, in one launch of the
// kernel's chirp-z instantiation (STAGE kChirpZ), the m-point spectrum never
// leaving the cluster's shared memory (chirpz_convolve): it reads the n_az
// rows (rows n_az .. m - 1 are zeros), multiplies each by the chirp c[n] =
// exp(-/+ j pi n^2 / n_az), runs the forward column pass with its gather on
// the output rows j = rank (mod CS), multiplies by the convolution kernel's
// spectrum H (a table: ops/cuda/csa_kernel.py::azimuth_plan), and holds the
// values in registers across a cluster barrier; since Q is a multiple of CS,
// those are the rows rank + CS q the block's own inverse pass A reads, so it
// writes them into its own Y and runs the inverse column pass (1 / m) there.
// Then it keeps rows below n_az times the chirp again and does what the
// direct launch does: Phi1 (K1, K1g), the stores (K3) or every product and
// the box sums (K3g, its windows clipped to n_az). K1g's balance sums come
// from the forward spectra (Parseval, 1 / m). Each value meets the same
// arithmetic in the same order as it would in two launches that carried the
// spectrum through (m, n_rg) planes in device memory. m = 8192 and 16,384, and
// the azimuth side 8192 itself, split over clusters of 16 blocks
// (non-portable on the H100; 16,384 as 16 x 32 x 32, one block an SM: the
// chirp-z blocks of 512 threads, K3g's with 182 KB of shared memory).
// A last tile of columns past n_rg (a range side that is not a multiple of
// the tile) reads its last column again and stores nothing past the edge.
// No float atomics anywhere: the balance kernel's last block sums the
// per-block partials in block order, K1g's per-column sums are summed by
// the wrapper (torch.sum), and K1g's column sums and K3g's column peaks are
// reduced over a cluster's blocks in rank order, so results do not change
// from run to run.
#include <cooperative_groups.h>

#include "fft_smem.cuh"

namespace cg = cooperative_groups;

namespace {

// ---- The column DFT of K1 / K1g (forward) and K3 / K3g (inverse) -------
//
// A cluster of CS blocks owns a tile of `cols` adjacent range columns (at
// least 8, so each row segment of a plane is whole 32-byte sectors) and
// transforms all n = CS * Q azimuth points of each, Q = QA * QB:
//   input  n = n1 + CS q,  q = qb + QB qa   (block n1 holds rows n1 + CS q)
//   output k = j + Q k1,   j = ja + QA jb   (block r emits j in its J = Q/CS)
//   Y_n1[j] = sum_q x[n1 + CS q] W_Q^(q j)                  (in block n1)
//   X[j + Q k1] = sum_n1 W_CS^(n1 k1) W_N^(n1 j) Y_n1[j]     (across blocks)
// with W_m = exp(-2 pi i / m) forward (INV false) and its conjugate inverse
// (INV). Pass A: per (channel, column, qb), the QA points qa of a strided
// row set from device memory, a QA-point DFT in registers, x W_Q^(qb ja), to
// shared memory. Block barrier. Pass B: per (column, ja), the QB points qb
// from shared memory, a QB-point DFT in registers, x W_N^(n1 j), back in
// place (a thread reads and writes the same QB slots). Cluster barrier.
// Gather: per (column, j), Y_n1[j] from each block of the cluster (DSMEM),
// a CS-point DFT in registers, X (forward) or X / N (inverse) for rows
// j + Q k1. Three barriers in all (K3g adds two around its halo copy),
// where the radix-2 form had one per stage. Shared memory holds a
// channel as (Q + QB) x cols float2: slot l of column c at
// (l + l / QA) * cols + c, the pad keeping pass A's stores conflict-free.
// The kernels are built for two blocks an SM (one block's loads overlap
// the other's transforms; at most 128 registers a thread, where the
// 32 x 32 split would take ~140), and the gather runs two tasks at a time
// to keep more DSMEM loads in flight.

constexpr int kColThreads = 256;

struct Tile {
  int n_rg, cols, log2cols, col0, rank;
};

// The kernels' instantiations: the direct column pass (n_az a power of two),
// the chirp-z transform of n_az points on the m-point pass, or the factored
// transform of n_az = N1 x N2 points (built for CS and N1 = QA, QB = 1)
constexpr int kDirect = 0, kChirpZ = 1, kFactored = 2;

// Where pass A reads its QA points: the planes' rows, the planes' rows times
// the chirp (zeros from n_valid on), or the spectrum the block holds in its
// own Y, at the slots the thread then writes (chirpz_convolve)
enum PassASource { kPlanes, kChirped, kHeld };

// Threads a block of the factored two-channel instantiations (K1g, K3g):
// one block an SM (their two channels' slots take 115-120 KB at 7,199 and
// 7,200 rows)
constexpr int kFacPairThreads = 2 * kColThreads;

// Threads a block of an instantiation of nch channels: kColThreads, or
// twice that for the chirp-z ones on clusters of 16 (one block an SM, whose
// transforms wait on latency: 16 warps hide more of it than 8, at 128
// registers a thread), or kFacPairThreads for the factored two-channel ones
__host__ __device__ constexpr int column_threads(int cs, int stage,
                                                 int nch = 1) {
  return stage == kFactored && nch == 2 ? kFacPairThreads
         : stage == kChirpZ && cs > 8   ? 2 * kColThreads
                                        : kColThreads;
}

// Blocks an SM an instantiation is built for: two, or one for the chirp-z
// ones on clusters of 16 and the factored two-channel ones
__host__ __device__ constexpr int column_blocks(int nch, int cs, int stage) {
  return stage == kFactored ? (nch == 2 ? 1 : 2) : (cs > 8 ? 1 : 2);
}

// The chirp-z instantiations' tile: column_plan's at the transform's length
// (a compile-time width, so each thread's gathered values stay in registers)
__host__ __device__ constexpr int chirpz_cols(int nch, int qb, int threads) {
  return threads / (nch * qb) > 8 ? threads / (nch * qb) : 8;
}

template <int CS>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (CS > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Block `rank`'s copy of `p` (its shared memory), for rank < CS.
template <int CS, typename T>
__device__ __forceinline__ T* block_smem(T* p, int rank) {
  if constexpr (CS > 1)
    return cg::this_cluster().map_shared_rank(p, rank);
  else
    return p;
}

template <int QA>
__device__ __forceinline__ int slot(int l, int c, const Tile& t) {
  return ((l + l / QA) << t.log2cols) + c;
}

// Pass A of NCH channels at once: task (ch, qb, c) for channel ch's planes
// into y + ch * ysz, so every thread of the block has a load to issue. A
// column past n_rg reads the last one again. kChirped: rows from n_valid on
// are zeros, the others times chirp[row]. kHeld: point qa of the task from
// slot qa + QA qb of channel ch, where the task's output goes.
template <bool INV, int NCH, int CS, int QA, int QB, int SRC>
__device__ void pass_a(const float* __restrict__ z1r,
                       const float* __restrict__ z1i,
                       const float* __restrict__ z2r,
                       const float* __restrict__ z2i, float2* y, int ysz,
                       const float2* __restrict__ tw, const Tile& t,
                       const float2* __restrict__ chirp, int n_valid) {
  constexpr int n = CS * QA * QB;
  const size_t step = (size_t)CS * QB * t.n_rg;
  for (int task = threadIdx.x; task < ((NCH * QB) << t.log2cols);
       task += blockDim.x) {
    const int c = task & (t.cols - 1), u = task >> t.log2cols;
    const int ch = u / QB, qb = u % QB;
    const float* __restrict__ zr = ch ? z2r : z1r;
    const float* __restrict__ zi = ch ? z2i : z1i;
    const int col = min(t.col0 + c, t.n_rg - 1);
    const size_t at = (size_t)(t.rank + CS * qb) * t.n_rg + col;
    float2 v[QA];
#pragma unroll
    for (int a = 0; a < QA; ++a) {
      if constexpr (SRC == kHeld) {
        v[a] = y[ch * ysz + slot<QA>(a + QA * qb, c, t)];
      } else if constexpr (SRC == kChirped) {
        const int row = t.rank + CS * (qb + QB * a);
        v[a] = row < n_valid
                   ? nis::cmul(make_float2(__ldg(zr + at + a * step),
                                           __ldg(zi + at + a * step)),
                               __ldg(chirp + row))
                   : make_float2(0.0f, 0.0f);
      } else {
        v[a] = make_float2(__ldg(zr + at + a * step),
                           __ldg(zi + at + a * step));
      }
    }
    nis::dft_reg<INV, QA>(v, tw, n / QA);
#pragma unroll
    for (int a = 0; a < QA; ++a) {
      const float2 w =
          a == 0 ? v[a]
                 : nis::cmul(v[a], nis::twiddle_pow<INV>(tw, CS * qb * a, n));
      y[ch * ysz + slot<QA>(a + QA * qb, c, t)] = w;
    }
  }
}

// Pass B of NCH channels at once (channel ch's slots at y + ch * ysz).
template <bool INV, int CS, int QA, int QB, int NCH = 1>
__device__ void pass_b(float2* y, const float2* __restrict__ tw,
                       const Tile& t, int ysz = 0) {
  constexpr int n = CS * QA * QB;
  for (int task = threadIdx.x; task < ((NCH * QA) << t.log2cols);
       task += blockDim.x) {
    const int c = task & (t.cols - 1), u = task >> t.log2cols;
    const int ja = u % QA;
    float2* yc = y + u / QA * ysz;
    float2 v[QB];
#pragma unroll
    for (int b = 0; b < QB; ++b) v[b] = yc[slot<QA>(ja + QA * b, c, t)];
    nis::dft_reg<INV, QB>(v, tw, n / QB);
#pragma unroll
    for (int b = 0; b < QB; ++b) {
      if constexpr (CS > 1)
        v[b] = nis::cmul(v[b],
                         nis::twiddle_pow<INV>(tw, t.rank * (ja + QA * b), n));
      yc[slot<QA>(ja + QA * b, c, t)] = v[b];
    }
  }
}

// Passes A and B of NCH channels (channel ch's planes into y + ch * ysz),
// then the cluster barrier: every block's Y is complete. The chirp-z passes
// (SRC other than kPlanes) run pass B of both channels in one loop, so
// that each of their 512 threads has a task.
template <bool INV, int NCH, int CS, int QA, int QB, int SRC = kPlanes>
__device__ void column_passes(const float* z1r, const float* z1i,
                              const float* z2r, const float* z2i, float2* y,
                              int ysz, const float2* __restrict__ tw,
                              const Tile& t,
                              const float2* __restrict__ chirp = nullptr,
                              int n_valid = 0) {
  pass_a<INV, NCH, CS, QA, QB, SRC>(z1r, z1i, z2r, z2i, y, ysz, tw, t,
                                    chirp, n_valid);
  __syncthreads();
  if constexpr (SRC != kPlanes) {
    pass_b<INV, CS, QA, QB, NCH>(y, tw, t, ysz);
  } else {
    pass_b<INV, CS, QA, QB>(y, tw, t);
    if constexpr (NCH == 2) pass_b<INV, CS, QA, QB>(y + ysz, tw, t);
  }
  cluster_barrier<CS>();
}

// The gather: emit(c, lr, row, v1, v2) for each column c of the tile and
// each of this block's output rows `row` = j + Q k1 (lr = k1 J + j - rank J
// its slot among the block's Q rows), v1 and v2 the two channels' X
// (forward) or X / N (inverse) (v2 = v1 when NCH == 1). The caller ends with
// a cluster barrier: other blocks read this block's Y until they are done.
template <bool INV, int NCH, int CS, int QA, int QB, typename Emit>
__device__ void column_gather(float2* y, int ysz,
                              const float2* __restrict__ tw, const Tile& t,
                              Emit emit) {
  constexpr int Q = QA * QB, J = Q / CS, n = CS * Q;
  const float inv_n = 1.0f / (float)n;
#pragma unroll 2
  for (int task = threadIdx.x; task < (J << t.log2cols);
       task += blockDim.x) {
    const int c = task & (t.cols - 1), jj = task >> t.log2cols;
    const int j = t.rank * J + jj;
    float2 v1[CS], v2[CS];
#pragma unroll
    for (int n1 = 0; n1 < CS; ++n1) {
      const float2* src = block_smem<CS>(y, n1);
      v1[n1] = src[slot<QA>(j, c, t)];
      if constexpr (NCH == 2) v2[n1] = src[ysz + slot<QA>(j, c, t)];
    }
    nis::dft_reg<INV, CS>(v1, tw, n / CS);
    if constexpr (NCH == 2) nis::dft_reg<INV, CS>(v2, tw, n / CS);
#pragma unroll
    for (int k1 = 0; k1 < CS; ++k1) {
      const float2 a = INV ? nis::cscale(v1[k1], inv_n) : v1[k1];
      const float2 b =
          NCH == 2 ? (INV ? nis::cscale(v2[k1], inv_n) : v2[k1]) : a;
      emit(c, k1 * J + jj, j + Q * k1, a, b);
    }
  }
}

// The chirp-z transform's circular convolution of NCH channels on the m =
// CS Q point column pass, up to its inverse gather, which the caller runs
// (column_gather<true, ...>, X / m, the chirp and its own output). Passes A
// and B forward over the chirped rows (zeros from n_valid on). The forward
// gather takes this block's output rows j = rank + CS jj (jj < J), each
// with the CS rows k = j + Q k1: k = rank + CS (jj + J k1), exactly the
// rows rank + CS q the block's inverse pass A reads, at q = jj + J k1. It
// calls sum(c, X1[k], X2[k]) for each (K1g's balance sums), multiplies by
// H[k] (`spec`) and holds the values in registers: T tasks of NCH x CS
// values a thread (J x COLS tasks). Other blocks read this block's Y until
// the cluster barrier; after it the block writes point q to slot qa + QA qb
// (q = qb + QB qa), the slot its inverse pass A task (qb, c) reads and
// writes, and runs the inverse passes A and B there.
template <int NCH, int CS, int QA, int QB, typename Sum>
__device__ void chirpz_convolve(const float* z1r, const float* z1i,
                                const float* z2r, const float* z2i,
                                float2* y, int ysz,
                                const float2* __restrict__ tw, const Tile& t,
                                const float2* __restrict__ chirp,
                                const float2* __restrict__ spec, int n_valid,
                                Sum sum) {
  constexpr int Q = QA * QB, J = Q / CS, n = CS * Q;
  constexpr int THREADS = column_threads(CS, kChirpZ);
  constexpr int COLS = chirpz_cols(NCH, QB, THREADS);
  constexpr int T = J * COLS / THREADS;
  static_assert(T * THREADS == J * COLS && Q % CS == 0,
                "whole gather tasks a thread");
  column_passes<false, NCH, CS, QA, QB, kChirped>(z1r, z1i, z2r, z2i, y, ysz,
                                                  tw, t, chirp, n_valid);
  float2 v[T][NCH][CS];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int task = threadIdx.x + i * THREADS;
    const int c = task % COLS, j = t.rank + CS * (task / COLS);
#pragma unroll
    for (int n1 = 0; n1 < CS; ++n1) {
      const float2* src = block_smem<CS>(y, n1);
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        v[i][ch][n1] = src[ch * ysz + slot<QA>(j, c, t)];
    }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
      nis::dft_reg<false, CS>(v[i][ch], tw, n / CS);
#pragma unroll
    for (int k1 = 0; k1 < CS; ++k1) {
      sum(c, v[i][0][k1], v[i][NCH - 1][k1]);
      const float2 h = __ldg(spec + j + Q * k1);
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        v[i][ch][k1] = nis::cmul(v[i][ch][k1], h);
    }
  }
  cluster_barrier<CS>();   // no block reads another's Y after this
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int task = threadIdx.x + i * THREADS;
    const int c = task % COLS, jj = task / COLS;
#pragma unroll
    for (int k1 = 0; k1 < CS; ++k1) {
      const int q = jj + J * k1;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        y[ch * ysz + slot<QA>(q / QB + QA * (q % QB), c, t)] = v[i][ch][k1];
    }
  }
  __syncthreads();
  column_passes<true, NCH, CS, QA, QB, kHeld>(nullptr, nullptr, nullptr,
                                              nullptr, y, ysz, tw, t);
}

// ---- The factored column DFT (STAGE kFactored) --------------------------
//
// n = N1 x N2 with gcd(N1, N2) = 1 (ops/cuda/csa_kernel.py::factored_split:
// 7,199 = 23 x 313, 7,200 = 32 x 225) as a Good-Thomas transform: input row
// (N2 i1 + N1 i2) mod n is point (i1, i2), and the output row k with k mod
// N1 = k1, k mod N2 = k2 is the 2-D DFT's (k1, k2); no twiddles between the
// legs. Block `rank` of the cluster holds i1 = rank + CS u (u < U =
// ceil(N1 / CS)): per channel, u and tile column a sequence of N2 slots,
// slot s at ((u N2 + s) << log2cols) + c. The local leg (N2 points) runs
// there in passes (fac_pass), natural order in, the plan's digit order out:
// each an in-place decimation in frequency of one radix (R-point DFTs in
// registers, twiddles from the L-point table), one block barrier each; the
// first reads its points from the planes, slot s from row N2 i1 + the
// plan's row offset of s (mod n), whole 32-byte row segments. A prime N2
// runs Rader's convolution of L = N2 - 1 points instead: slot s < L holds
// point g^-s and slot L point 0; the forward passes, x the kernel's spectrum
// in the last (with x0 added at frequency 0, and X[0] = x0 + A[0] kept in
// slot L), then the inverse passes backwards, which leave X[g^q] in slot q.
// After one cluster barrier the gather (fac_gather) takes this block's k2
// in [rank J, rank J + J) (J = ceil(N2 / CS)), reads X_i1[k2] of every i1
// from the block holding it (DSMEM, at the plan's slot of k2), runs the
// N1-point DFT in registers and emits rows (e1 k1 + e2 k2) mod n: block
// rank's output rows are the N1 chunks [m N2 + rank J, m N2 + rank J + J),
// as the direct pass's are CS chunks of Q. Per tile one barrier a local
// pass, one cluster barrier and one DSMEM gather, on the CPI's n points.

// A factored launch's legs and tables (ops/cuda/csa_kernel.py::AzimuthPlan:
// `tw` the L-point then the N1-point table, `index` e1, e2, the radices,
// each slot's row offset, each k2's slot)
struct Fac {
  const float2* tl;     // exp(-2 pi i k / L), k < L
  const float2* to;     // exp(-2 pi i k / N1), k < N1
  const float2* spec;   // Rader's spectrum / L in the passes' order, or null
  const int* radix;     // the local passes' radices, forward order
  const int* rowof;     // (N1 i2) mod n of each slot
  const int* slot;      // the slot of each k2 after the local transform
  int n, n2, len, npass, e1, e2;
};

__device__ __forceinline__ Fac fac_of(const float2* tw, const float2* spec,
                                      const int* fidx, int n, int n2,
                                      int len, int npass) {
  Fac f;
  f.tl = tw;
  f.to = tw + len;
  f.spec = spec;
  f.radix = fidx + 2;
  f.rowof = fidx + 2 + npass;
  f.slot = f.rowof + n2;
  f.n = n;
  f.n2 = n2;
  f.len = len;
  f.npass = npass;
  f.e1 = __ldg(fidx);
  f.e2 = __ldg(fidx + 1);
  return f;
}

// The planes a factored launch's first pass reads (z1r null: every other
// pass reads the slots), and where its block's sequences start
struct FacSrc {
  const float *z1r, *z1i, *z2r, *z2i;
  int n_rg, col0, rank, cs;
};

// One radix-R pass of the local transform over nch channels x nu sequences
// of each tile column (channel ch's at y + ch * ysz): butterfly (blk, s)
// holds the R slots blk len + s + (len / R) j of its sequence. DIT false:
// the R-point DFT over j of the direction, x W_len^(s k), back to slot k
// (K2's forward mixed-radix pass); DIT: x W_len^(s k) first, then the DFT
// (its inverse pass). `last` with f.spec (Rader's last forward pass, len =
// R): x the spectrum at position blk R + k, and at position 0 the x0 of
// slot L added, X[0] = x0 + A[0] written there. Ends with a block barrier.
// One copy of each pass for every kernel of this file (noinline).
template <bool INV, bool DIT, int R>
__device__ __noinline__ void fac_pass(float2* y, int ysz, int nch, int nu,
                                      Fac f, int len, int log2cols,
                                      FacSrc src, bool last) {
  const int sl = len / R, stride = f.len / len, per = f.len / R;
  const int cols = 1 << log2cols;
  for (int task = threadIdx.x; task < ((nch * nu * per) << log2cols);
       task += blockDim.x) {
    const int c = task & (cols - 1), q = task >> log2cols;
    const int sq = q / per, b = q - sq * per;
    const int ch = sq / nu, u = sq - ch * nu;
    const int blk = b / sl, s = b - blk * sl;
    float2* p = y + ch * ysz + ((u * f.n2 + blk * len + s) << log2cols) + c;
    float2 v[R];
    if (src.z1r != nullptr) {
      const float* __restrict__ zr = ch ? src.z2r : src.z1r;
      const float* __restrict__ zi = ch ? src.z2i : src.z1i;
      const int col = min(src.col0 + c, src.n_rg - 1);
      const int base = f.n2 * (src.rank + src.cs * u);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        int row = base + __ldg(f.rowof + s + j * sl);
        row = row < f.n ? row : row - f.n;
        const size_t at = (size_t)row * src.n_rg + col;
        v[j] = make_float2(__ldg(zr + at), __ldg(zi + at));
      }
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) v[j] = p[(j * sl) << log2cols];
    }
    if constexpr (DIT) {
      if (s) nis::mixed_twiddle<INV, R>(v, f.tl, s * stride);
      nis::mixed_dft<INV, R>(v, f.tl, f.len);
    } else {
      nis::mixed_dft<INV, R>(v, f.tl, f.len);
      if (s) nis::mixed_twiddle<INV, R>(v, f.tl, s * stride);
    }
    if (last && f.spec != nullptr) {
      const float2 a0 = v[0];
#pragma unroll
      for (int j = 0; j < R; ++j)
        v[j] = nis::cmul(v[j], __ldg(f.spec + blk * R + j));
      if (blk == 0) {
        float2* p0 = y + ch * ysz + ((u * f.n2 + f.len) << log2cols) + c;
        const float2 x0 = *p0;
        *p0 = make_float2(x0.x + a0.x, x0.y + a0.y);
        v[0] = make_float2(v[0].x + x0.x, v[0].y + x0.y);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) p[(j * sl) << log2cols] = v[j];
  }
  __syncthreads();
}

// fac_pass of radix r (one of csa_kernel.py::local_radices' radices)
template <bool INV, bool DIT>
__device__ void fac_pass_of(int r, float2* y, int ysz, int nch, int nu,
                            const Fac& f, int len, int log2cols,
                            const FacSrc& src, bool last) {
  switch (r) {
    case 16: fac_pass<INV, DIT, 16>(y, ysz, nch, nu, f, len, log2cols, src,
                                    last); break;
    case 15: fac_pass<INV, DIT, 15>(y, ysz, nch, nu, f, len, log2cols, src,
                                    last); break;
    case 13: fac_pass<INV, DIT, 13>(y, ysz, nch, nu, f, len, log2cols, src,
                                    last); break;
    case 11: fac_pass<INV, DIT, 11>(y, ysz, nch, nu, f, len, log2cols, src,
                                    last); break;
    case 9: fac_pass<INV, DIT, 9>(y, ysz, nch, nu, f, len, log2cols, src,
                                  last); break;
    case 8: fac_pass<INV, DIT, 8>(y, ysz, nch, nu, f, len, log2cols, src,
                                  last); break;
    case 7: fac_pass<INV, DIT, 7>(y, ysz, nch, nu, f, len, log2cols, src,
                                  last); break;
    case 5: fac_pass<INV, DIT, 5>(y, ysz, nch, nu, f, len, log2cols, src,
                                  last); break;
    case 4: fac_pass<INV, DIT, 4>(y, ysz, nch, nu, f, len, log2cols, src,
                                  last); break;
    case 3: fac_pass<INV, DIT, 3>(y, ysz, nch, nu, f, len, log2cols, src,
                                  last); break;
    default: fac_pass<INV, DIT, 2>(y, ysz, nch, nu, f, len, log2cols, src,
                                   last); break;
  }
}

// The local transform of NCH channels' sequences (the planes' rows into y +
// ch * ysz), then the cluster barrier: every block's X_i1 is complete.
template <bool INV, int NCH, int CS, int N1>
__device__ void factored_passes(const float* z1r, const float* z1i,
                                const float* z2r, const float* z2i,
                                float2* y, int ysz, const Fac& f,
                                const Tile& t) {
  const int nu = (N1 - t.rank + CS - 1) / CS;   // i1 = rank + CS u < N1
  const FacSrc planes{z1r, z1i, z2r, z2i, t.n_rg, t.col0, t.rank, CS};
  const FacSrc slots{};
  const bool rader = f.spec != nullptr;
  if (rader) {            // point 0 of each sequence into slot L
    for (int task = threadIdx.x; task < ((NCH * nu) << t.log2cols);
         task += blockDim.x) {
      const int c = task & (t.cols - 1), sq = task >> t.log2cols;
      const int ch = sq / nu, u = sq - ch * nu;
      const float* __restrict__ zr = ch ? z2r : z1r;
      const float* __restrict__ zi = ch ? z2i : z1i;
      const size_t at = (size_t)(f.n2 * (t.rank + CS * u)) * t.n_rg
                        + min(t.col0 + c, t.n_rg - 1);
      y[ch * ysz + ((u * f.n2 + f.len) << t.log2cols) + c] =
          make_float2(__ldg(zr + at), __ldg(zi + at));
    }
    __syncthreads();
  }
  int len = f.len;
  for (int p = 0; p < f.npass; ++p) {
    const int r = __ldg(f.radix + p);
    const FacSrc& src = p == 0 ? planes : slots;
    if (rader)
      fac_pass_of<false, false>(r, y, ysz, NCH, nu, f, len, t.log2cols, src,
                                p == f.npass - 1);
    else
      fac_pass_of<INV, false>(r, y, ysz, NCH, nu, f, len, t.log2cols, src,
                              false);
    len /= r;
  }
  if (rader) {
    len = __ldg(f.radix + f.npass - 1);
    for (int p = f.npass - 1; p >= 0; --p) {
      fac_pass_of<true, true>(__ldg(f.radix + p), y, ysz, NCH, nu, f, len,
                              t.log2cols, slots, false);
      if (p > 0) len *= __ldg(f.radix + p - 1);
    }
  }
  cluster_barrier<CS>();
}

// The gather: emit(c, lr, row, v1, v2) for each column c of the tile and
// each of this block's output rows `row` (lr = (row / N2) J + jj its slot
// among the block's N1 chunks of J rows), v1 and v2 the two channels' X
// (forward) or X / n (inverse) (v2 = v1 when NCH == 1). With two
// channels, lanes c and c + cols (cols <= 16) run the two channels' DFTs
// of a k2, each holding N1 values, and each emits the rows of its parity
// of k1 with the other channel's value from a shuffle. The caller ends
// with a cluster barrier: other blocks read this block's slots until they
// are done.
template <bool INV, int NCH, int CS, int N1, typename Emit>
__device__ void factored_gather(float2* y, int ysz, const Fac& f,
                                const Tile& t, Emit emit) {
  const int J = (f.n2 + CS - 1) / CS;
  const int jn = min(J, f.n2 - t.rank * J);     // the last block's are fewer
  const float inv_n = 1.0f / (float)f.n;
  const int lg = t.log2cols + (NCH == 2);       // tasks a k2: (ch, c)
  const int total = jn > 0 ? jn << lg : 0;
  for (int task = threadIdx.x; task < total; task += blockDim.x) {
    const int c = task & (t.cols - 1), jj = task >> lg;
    const int ch = NCH == 2 ? (task >> t.log2cols) & 1 : 0;
    const int k2 = t.rank * J + jj;
    const int at = ch * ysz + (__ldg(f.slot + k2) << t.log2cols) + c;
    // the warp's live lanes: a prefix, whole pairs (total is a multiple of
    // 2 cols)
    const int live = min(32, total - (task - (task & 31)));
    const unsigned mask = live == 32 ? 0xffffffffu : (1u << live) - 1u;
    float2 v[N1];
#pragma unroll
    for (int i1 = 0; i1 < N1; ++i1)
      v[i1] = block_smem<CS>(y, i1 % CS)[(((i1 / CS) * f.n2)
                                          << t.log2cols) + at];
    nis::mixed_dft<INV, N1>(v, f.to, N1);
    int row = f.e2 * k2 % f.n;
    if constexpr (NCH == 2) {
      // this lane's k1 = 2 kk + ch; it sends the partner's k1 of its own
      // channel
      const int step = 2 * f.e1 % f.n;
      row += ch ? f.e1 : 0;
      row = row < f.n ? row : row - f.n;
#pragma unroll
      for (int kk = 0; kk < (N1 + 1) / 2; ++kk) {
        const int lo = 2 * kk, hi = 2 * kk + 1 < N1 ? 2 * kk + 1 : 2 * kk;
        const float2 mine = ch ? v[hi] : v[lo];
        const float2 send = ch ? v[lo] : v[hi];
        const float2 a = INV ? nis::cscale(mine, inv_n) : mine;
        const float2 b = INV ? nis::cscale(send, inv_n) : send;
        const float2 o = make_float2(__shfl_xor_sync(mask, b.x, t.cols),
                                     __shfl_xor_sync(mask, b.y, t.cols));
        if (lo + ch < N1)
          emit(c, row / f.n2 * J + jj, row, ch ? o : a, ch ? a : o);
        row += step;
        row = row < f.n ? row : row - f.n;
      }
    } else {
#pragma unroll
      for (int k1 = 0; k1 < N1; ++k1) {
        const float2 a = INV ? nis::cscale(v[k1], inv_n) : v[k1];
        emit(c, row / f.n2 * J + jj, row, a, a);
        row += f.e1;
        row = row < f.n ? row : row - f.n;
      }
    }
  }
}

template <int CS>
__device__ __forceinline__ Tile tile_of(int n_rg, int log2cols) {
  Tile t;
  t.n_rg = n_rg;
  t.cols = 1 << log2cols;
  t.log2cols = log2cols;
  t.col0 = (int)(blockIdx.x / CS) << log2cols;
  t.rank = CS > 1 ? (int)cg::this_cluster().block_rank() : 0;
  return t;
}

// K1 / K1g: the forward column DFT of NCH channels (x2*, z2* and bal unused
// when NCH == 1), x Phi1 = exp(j c1(k) (u(col) - w(k))^2) on the natural
// frequency k as each value is stored (the accurate sincosf of the same f32
// expression as the plain version). For NCH == 2 also each column's raw
// balance sum of x1 conj(x2) into bal[col] (re) and bal[n_rg + col] (im),
// zeros unless `balance`: by Parseval, sum_k X1 conj(X2) / n over the
// gathered spectra before Phi1 (which cancels), each thread's rows in task
// order, then the threads that served the column (c, c + cols, ...) in
// thread order, then the cluster's blocks in rank order in rank 0's shared
// memory, and 1 / n (a power of two) at the end. Chirp-z (kChirpZ): the
// balance sums from the forward spectra in chirpz_convolve, and rows below
// n_valid of the inverse gather times chirp get Phi1. Factored (kFactored,
// N1 = QA): the local passes and the gather of factored_passes /
// factored_gather, the sums as the direct pass's, / n_valid at the end.
template <int NCH, int CS, int QA, int QB, int STAGE>
__global__ void __launch_bounds__(column_threads(CS, STAGE, NCH),
                                  column_blocks(NCH, CS, STAGE))
    k1_kernel(
    const float* __restrict__ x1r, const float* __restrict__ x1i,
    const float* __restrict__ x2r, const float* __restrict__ x2i,
    const float* __restrict__ u, const float* __restrict__ c1,
    const float* __restrict__ w, const float2* __restrict__ tw,
    const float2* __restrict__ chirp, const float2* __restrict__ spec,
    const int* __restrict__ fidx,
    float* __restrict__ z1r, float* __restrict__ z1i,
    float* __restrict__ z2r, float* __restrict__ z2i,
    float* __restrict__ bal, int n_rg, int n_valid, int n2, int len,
    int npass, int balance, int log2cols) {
  constexpr int Q = QA * QB, n = CS * Q;
  constexpr bool CZ = STAGE == kChirpZ;
  constexpr bool FAC = STAGE == kFactored;
  constexpr bool SUMS = NCH == 2;
  const Tile t = tile_of<CS>(n_rg, log2cols);
  const int ysz = FAC ? ((QA + CS - 1) / CS * n2) << log2cols
                      : (Q + QB) << log2cols;
  float2* y = reinterpret_cast<float2*>(nis_smem);
  // K1g's sums after the channels' slots: one a thread, then rank 0's
  // cols a block of the cluster
  float2* red = y + 2 * ysz;
  float2* part = red + column_threads(CS, STAGE, NCH);
  float2 s = make_float2(0.0f, 0.0f);   // X1 conj(X2) over this thread's rows
  Fac f;
  if constexpr (FAC) {
    f = fac_of(tw, spec, fidx, n_valid, n2, len, npass);
    factored_passes<false, NCH, CS, QA>(x1r, x1i, x2r, x2i, y, ysz, f, t);
  } else if constexpr (CZ) {
    chirpz_convolve<NCH, CS, QA, QB>(
        x1r, x1i, x2r, x2i, y, ysz, tw, t, chirp, spec, n_valid,
        [&](int c, float2 v1, float2 v2) {
          if (!SUMS || t.col0 + c >= n_rg) return;
          s.x += v1.x * v2.x + v1.y * v2.y;
          s.y += v1.y * v2.x - v1.x * v2.y;
        });
  } else {
    column_passes<false, NCH, CS, QA, QB>(x1r, x1i, x2r, x2i, y, ysz, tw, t);
  }
  const auto emit = [&](int c, int, int row, float2 v1, float2 v2) {
        const int col = t.col0 + c;
        if (col >= n_rg) return;
        const size_t idx = (size_t)row * n_rg + col;
        if constexpr (SUMS && !CZ) {
          s.x += v1.x * v2.x + v1.y * v2.y;
          s.y += v1.y * v2.x - v1.x * v2.y;
        }
        if constexpr (CZ) {
          if (row >= n_valid) return;
          const float2 cz = __ldg(chirp + row);
          v1 = nis::cmul(v1, cz);
          v2 = nis::cmul(v2, cz);
        }
        const float du = __ldg(u + col) - __ldg(w + row);
        float sn, cs;
        sincosf(__ldg(c1 + row) * du * du, &sn, &cs);
        const float2 phi = make_float2(cs, sn);
        const float2 a = nis::cmul(v1, phi);
        z1r[idx] = a.x;
        z1i[idx] = a.y;
        if constexpr (NCH == 2) {
          const float2 b = nis::cmul(v2, phi);
          z2r[idx] = b.x;
          z2i[idx] = b.y;
        }
      };
  if constexpr (FAC)
    factored_gather<false, NCH, CS, QA>(y, ysz, f, t, emit);
  else
    column_gather<CZ, NCH, CS, QA, QB>(y, ysz, tw, t, emit);
  if constexpr (SUMS) {
    red[threadIdx.x] = s;
    __syncthreads();
    if ((int)threadIdx.x < t.cols) {
      for (int i = threadIdx.x + t.cols; i < (int)blockDim.x; i += t.cols) {
        s.x += red[i].x;
        s.y += red[i].y;
      }
      block_smem<CS>(part, 0)[(t.rank << log2cols) + threadIdx.x] = s;
    }
  }
  cluster_barrier<CS>();   // every gather and every block's sums are done
  if constexpr (SUMS) {
    if (t.rank == 0 && (int)threadIdx.x < t.cols &&
        t.col0 + (int)threadIdx.x < n_rg) {
      float sr = 0.0f, si = 0.0f;
#pragma unroll
      for (int r = 0; r < CS; ++r) {
        sr += part[(r << log2cols) + threadIdx.x].x;
        si += part[(r << log2cols) + threadIdx.x].y;
      }
      const float inv_n = 1.0f / (float)(FAC ? n_valid : n);
      bal[t.col0 + threadIdx.x] = balance ? sr * inv_n : 0.0f;
      bal[n_rg + t.col0 + threadIdx.x] = balance ? si * inv_n : 0.0f;
    }
  }
}

// K3: the inverse column DFT of one channel, / n. Chirp-z (kChirpZ): the
// convolution in chirpz_convolve, then rows below n_valid of the inverse
// gather stored times chirp. Factored (kFactored): factored_passes and
// factored_gather inverse.
template <int CS, int QA, int QB, int STAGE>
__global__ void __launch_bounds__(column_threads(CS, STAGE),
                                  column_blocks(1, CS, STAGE))
    k3_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float2* __restrict__ tw, const float2* __restrict__ chirp,
    const float2* __restrict__ spec, const int* __restrict__ fidx,
    float* __restrict__ sr, float* __restrict__ si, int n_rg, int n_valid,
    int n2, int len, int npass, int log2cols) {
  constexpr bool CZ = STAGE == kChirpZ;
  constexpr bool FAC = STAGE == kFactored;
  float2* y = reinterpret_cast<float2*>(nis_smem);
  const Tile t = tile_of<CS>(n_rg, log2cols);
  Fac f;
  if constexpr (FAC) {
    f = fac_of(tw, spec, fidx, n_valid, n2, len, npass);
    factored_passes<true, 1, CS, QA>(zr, zi, nullptr, nullptr, y, 0, f, t);
  } else if constexpr (CZ) {
    chirpz_convolve<1, CS, QA, QB>(zr, zi, nullptr, nullptr, y, 0, tw, t,
                                   chirp, spec, n_valid,
                                   [](int, float2, float2) {});
  } else {
    column_passes<true, 1, CS, QA, QB>(zr, zi, nullptr, nullptr, y, 0, tw,
                                       t);
  }
  const auto emit = [&](int c, int, int row, float2 v, float2) {
        const int col = t.col0 + c;
        if (col >= n_rg) return;
        if constexpr (CZ) {
          if (row >= n_valid) return;
          v = nis::cmul(v, __ldg(chirp + row));
        }
        const size_t idx = (size_t)row * n_rg + col;
        sr[idx] = v.x;
        si[idx] = v.y;
      };
  if constexpr (FAC)
    factored_gather<true, 1, CS, QA>(y, 0, f, t, emit);
  else
    column_gather<true, 1, CS, QA, QB>(y, 0, tw, t, emit);
  cluster_barrier<CS>();
}

// K3g keeps the DPCA power of its output rows in `pcol`, chunk by chunk
// (Chunks: the direct pass's CS chunks of J = Q / CS consecutive rows, row
// k1 Q + rank J + jj; the factored pass's N1 chunks of J = ceil(N2 / CS),
// row k1 N2 + rank J + jj, of which the last block holds fewer), each chunk
// with kHalo slots on either side for the rows just beyond it: chunk k1's
// row jj of column c at slot pslot(k1, jj, c, J). After the gather the
// block copies those halo rows from the blocks that hold them (one DSMEM
// load each), so a box sum of half-width h <= kHalo reads only its own
// block's shared memory.
constexpr int kHalo = 16;

struct Chunks {
  int chunks, period, J, jn;   // jn: this block's rows a chunk (J or fewer)
};

__device__ __forceinline__ int pslot(int k1, int jj, int c, int J,
                                     const Tile& t) {
  return ((k1 * (J + 2 * kHalo) + kHalo + jj) << t.log2cols) + c;
}

// The azimuth box sums of half-widths h_out and h_in at `row` (chunk k1,
// row jj of it) of column c: each the power of rows [row - h, row + h]
// clipped to the column's n rows, summed in row order (a locally windowed sum, as
// nis::window_sum; adding 0 outside a window changes no bit). One pass over
// the wider window, from the chunk and its halo when it is within kHalo,
// else row by row from the blocks that hold the rows.
template <int CS>
__device__ __forceinline__ float2 column_windows(const float* pcol, int row,
                                                 int k1, int jj, int c,
                                                 int h_out, int h_in,
                                                 const Tile& t, int n,
                                                 const Chunks& g) {
  const int Q = g.period, J = g.J;
  const int h = h_out > h_in ? h_out : h_in;
  const int lo = (row - h > 0 ? row - h : 0) - row;
  const int hi = (row + h < n - 1 ? row + h : n - 1) - row;
  float so = 0.0f, si = 0.0f;
  if (h <= kHalo) {
    const float* p = pcol + pslot(k1, jj, c, J, t);
#pragma unroll 8
    for (int d = lo; d <= hi; ++d) {
      const float v = p[d * t.cols];
      so += abs(d) <= h_out ? v : 0.0f;
      si += abs(d) <= h_in ? v : 0.0f;
    }
  } else {
    for (int d = lo; d <= hi; ++d) {
      const int q = row + d, jq = q % Q;  // q = jq + Q kq, held by jq / J
      const float v = block_smem<CS>(pcol, jq / J)[pslot(q / Q, jq % J, c,
                                                          J, t)];
      so += abs(d) <= h_out ? v : 0.0f;
      si += abs(d) <= h_in ? v : 0.0f;
    }
  }
  return make_float2(so, si);
}

// K3g: the inverse column DFT of both channels, / n, and every product
// from the gathered values. Chirp-z (kChirpZ): the convolution in
// chirpz_convolve, then rows below n_valid of the inverse gather times
// chirp, with the windows and the halo clipped to n_valid rows. Factored
// (kFactored): factored_passes and factored_gather inverse, the power in
// the factored pass's chunks.
template <int CS, int QA, int QB, int STAGE>
__global__ void __launch_bounds__(column_threads(CS, STAGE, 2),
                                  column_blocks(2, CS, STAGE))
    k3g_kernel(
    const float* __restrict__ z1r, const float* __restrict__ z1i,
    const float* __restrict__ z2r, const float* __restrict__ z2i,
    const float* __restrict__ cal_cs, const float2* __restrict__ tw,
    const float2* __restrict__ chirp, const float2* __restrict__ spec,
    const int* __restrict__ fidx,
    float* __restrict__ s1r, float* __restrict__ s1i,
    float* __restrict__ s2r, float* __restrict__ s2i,
    float* __restrict__ ph, float* __restrict__ mag, float* __restrict__ pw,
    float* __restrict__ cso, float* __restrict__ csi,
    float* __restrict__ peaks, int n_rg, int n_valid, int n2, int len,
    int npass, int h_out, int h_in, int log2cols) {
  constexpr int Q = QA * QB, J = Q / CS, n = CS * Q;
  constexpr bool CZ = STAGE == kChirpZ;
  constexpr bool FAC = STAGE == kFactored;
  const Tile t = tile_of<CS>(n_rg, log2cols);
  const int jf = (n2 + CS - 1) / CS;
  const Chunks g = FAC ? Chunks{QA, n2, jf, min(jf, n2 - t.rank * jf)}
                       : Chunks{CS, Q, J, J};
  const int ysz = FAC ? ((QA + CS - 1) / CS * n2) << log2cols
                      : (Q + QB) << log2cols;
  float2* y = reinterpret_cast<float2*>(nis_smem);
  // the rows of the transform that are the CPI's
  const int nv = STAGE == kDirect ? n : n_valid;
  float* pcol = reinterpret_cast<float*>(y + 2 * ysz);
  float* red = pcol + ((g.chunks * (g.J + 2 * kHalo)) << log2cols);
  Fac f;
  if constexpr (FAC) {
    f = fac_of(tw, spec, fidx, n_valid, n2, len, npass);
    factored_passes<true, 2, CS, QA>(z1r, z1i, z2r, z2i, y, ysz, f, t);
  } else if constexpr (CZ) {
    chirpz_convolve<2, CS, QA, QB>(z1r, z1i, z2r, z2i, y, ysz, tw, t, chirp,
                                   spec, n_valid,
                                   [](int, float2, float2) {});
  } else {
    column_passes<true, 2, CS, QA, QB>(z1r, z1i, z2r, z2i, y, ysz, tw, t);
  }

  const float cr = cal_cs[0];
  const float ci = cal_cs[1];
  float m = 0.0f;     // max |s1|^2 over this thread's rows of column c
  const auto emit = [&](int c, int lr, int row, float2 v1, float2 v2) {
        const int col = t.col0 + c;
        if (col >= n_rg || row >= nv) return;
        if constexpr (CZ) {
          const float2 cz = __ldg(chirp + row);
          v1 = nis::cmul(v1, cz);
          v2 = nis::cmul(v2, cz);
        }
        const size_t idx = (size_t)row * n_rg + col;
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
        pcol[pslot(lr / g.J, lr % g.J, c, g.J, t)] = p;
      };
  if constexpr (FAC)
    factored_gather<true, 2, CS, QA>(y, ysz, f, t, emit);
  else
    column_gather<true, 2, CS, QA, QB>(y, ysz, tw, t, emit);
  // peaks: the max over the threads that served column c (threads c,
  // c + cols, ... of each block), first in each block, then over the
  // cluster's blocks; max is exact in any order
  red[threadIdx.x] = m;
  __syncthreads();
  if ((int)threadIdx.x < t.cols) {
    for (int i = threadIdx.x + t.cols; i < (int)blockDim.x; i += t.cols)
      m = fmaxf(m, red[i]);
    red[threadIdx.x] = m;
  }
  cluster_barrier<CS>();   // every block's pcol and column maxima are done
  if (t.rank == 0 && (int)threadIdx.x < t.cols &&
      t.col0 + (int)threadIdx.x < n_rg) {
    float pk = 0.0f;
#pragma unroll
    for (int r = 0; r < CS; ++r)
      pk = fmaxf(pk, block_smem<CS>(red, r)[threadIdx.x]);
    peaks[t.col0 + threadIdx.x] = pk;
  }
  // the halo: kHalo rows before and after each chunk, where in the column
#pragma unroll 4
  for (int task = threadIdx.x;
       task < (g.jn > 0 ? (g.chunks * 2 * kHalo) << log2cols : 0);
       task += blockDim.x) {
    const int c = task & (t.cols - 1), e = (task >> log2cols) % (2 * kHalo);
    const int k1 = (task >> log2cols) / (2 * kHalo);
    const int first = k1 * g.period + t.rank * g.J;   // the chunk's first row
    const int row = e < kHalo ? first - kHalo + e : first + g.jn + e - kHalo;
    if (row >= 0 && row < nv) {
      const int jq = row % g.period;
      const float* src = block_smem<CS>(pcol, jq / g.J);
      pcol[((k1 * (g.J + 2 * kHalo) + (e < kHalo ? e : g.jn + e))
            << log2cols) + c] =
          src[pslot(row / g.period, jq % g.J, c, g.J, t)];
    }
  }
  // with both windows inside the halo no block reads another's shared
  // memory after this barrier, so each leaves when its sums are done
  const bool local = h_out <= kHalo && h_in <= kHalo;
  if (local)
    cluster_barrier<CS>();
  else
    __syncthreads();
#pragma unroll 2
  for (int task = threadIdx.x; task < ((g.chunks * g.jn) << log2cols);
       task += blockDim.x) {
    const int c = task & (t.cols - 1), lr = task >> log2cols;
    const int k1 = lr / g.jn, jj = lr % g.jn;
    const int row = k1 * g.period + t.rank * g.J + jj;
    if (row >= nv || t.col0 + c >= n_rg) continue;
    const size_t idx = (size_t)row * n_rg + t.col0 + c;
    const float2 w = column_windows<CS>(pcol, row, k1, jj, c, h_out, h_in,
                                        t, nv, g);
    cso[idx] = w.x;
    csi[idx] = w.y;
  }
  if (!local) cluster_barrier<CS>();   // others read this pcol until then
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

// Raw balance: re / im of sum(x1 conj(x2)) over n4 float4 of each plane
// (and the last n % 4 floats, added by the last block), in one launch. Thread i of the grid takes float4 i, i + S, i + 2 S, ... (S
// the grid's threads), kBalU of them per plane at a time: their loads go out
// together (streaming loads, evict-first: each byte is read once) into kBalU
// separate sums, combined in a fixed order. A block reduces its threads in a
// fixed tree and writes its partial; the last block to finish (a ticket
// taken after a fence) sums the partials in block order and resets the
// ticket. No float atomics, and the grid is a function of the shape alone
// (ops/cuda/gmti_kernel.py::balance_grid), so every launch gives the same
// bits. Bound by bytes: four planes read once, 0.080 ms at 4096^2.
constexpr int kBalThreads = 256;
constexpr int kBalU = 4;
constexpr int kBalBlocksPerSm = 3;   // at most 80 registers a thread

__global__ void __launch_bounds__(kBalThreads, kBalBlocksPerSm)
    balance_kernel(
    const float4* __restrict__ x1r, const float4* __restrict__ x1i,
    const float4* __restrict__ x2r, const float4* __restrict__ x2i,
    float* __restrict__ work, float* __restrict__ out, long long n4,
    int tail) {
  unsigned int* ticket = reinterpret_cast<unsigned int*>(work);
  float* part = work + 1;
  __shared__ float red[32];
  __shared__ bool last;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float pr[kBalU] = {}, pi[kBalU] = {};
  auto add = [&](int u, float4 ar, float4 ai, float4 br, float4 bi) {
    pr[u] += ar.x * br.x + ai.x * bi.x;
    pi[u] += ai.x * br.x - ar.x * bi.x;
    pr[u] += ar.y * br.y + ai.y * bi.y;
    pi[u] += ai.y * br.y - ar.y * bi.y;
    pr[u] += ar.z * br.z + ai.z * bi.z;
    pi[u] += ai.z * br.z - ar.z * bi.z;
    pr[u] += ar.w * br.w + ai.w * bi.w;
    pi[u] += ai.w * br.w - ar.w * bi.w;
  };
  for (; i + (kBalU - 1) * stride < n4; i += kBalU * stride) {
    float4 ar[kBalU], ai[kBalU], br[kBalU], bi[kBalU];
#pragma unroll
    for (int u = 0; u < kBalU; ++u) {
      ar[u] = __ldcs(x1r + i + u * stride);
      ai[u] = __ldcs(x1i + i + u * stride);
      br[u] = __ldcs(x2r + i + u * stride);
      bi[u] = __ldcs(x2i + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kBalU; ++u) add(u, ar[u], ai[u], br[u], bi[u]);
  }
#pragma unroll
  for (int u = 0; u < kBalU; ++u, i += stride)
    if (i < n4) add(u, __ldcs(x1r + i), __ldcs(x1i + i), __ldcs(x2r + i),
                    __ldcs(x2i + i));
  float sr = (pr[0] + pr[1]) + (pr[2] + pr[3]);
  float si = (pi[0] + pi[1]) + (pi[2] + pi[3]);
  sr = nis::block_sum(red, sr);
  si = nis::block_sum(red, si);
  const int nb = (int)gridDim.x;
  if (threadIdx.x == 0) {
    part[blockIdx.x] = sr;
    part[nb + blockIdx.x] = si;
    __threadfence();                 // the partials before the ticket
    last = atomicAdd(ticket, 1u) == (unsigned)nb - 1u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();                   // every block's partials are visible
  sr = 0.0f;
  si = 0.0f;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    sr += __ldcg(part + b);
    si += __ldcg(part + nb + b);
  }
  sr = nis::block_sum(red, sr);
  si = nis::block_sum(red, si);
  if (threadIdx.x == 0) {
    // the last n % 4 floats of each plane, after every float4
    const float* ar = reinterpret_cast<const float*>(x1r + n4);
    const float* ai = reinterpret_cast<const float*>(x1i + n4);
    const float* br = reinterpret_cast<const float*>(x2r + n4);
    const float* bi = reinterpret_cast<const float*>(x2i + n4);
    for (int k = 0; k < tail; ++k) {
      sr += ar[k] * br[k] + ai[k] * bi[k];
      si += ai[k] * br[k] - ar[k] * bi[k];
    }
    out[0] = sr;
    out[1] = si;
    *ticket = 0u;                    // ready for the next launch
  }
}

}  // namespace

// Each launcher runs its kernel over (n_az, n_rg) f32 planes on `stream`
// and returns cudaGetLastError() after the launch.

// The column pass's launch plan (ops/cuda/csa_kernel.py::column_plan):
// `cols` columns a tile (a power of two, 8 to kColThreads; the last tile
// may pass n_rg), a cluster of `cluster` blocks a tile, `smem` bytes of
// dynamic shared memory a block. The split of the transform's n points
// into CS x QA x QB is fixed by (n, cluster): QA = 2^ceil(log2(Q) / 2), QB
// = Q / QA, Q = n / cluster.
// The shared memory a block of `threads` threads needs: per channel (Q +
// QB) x cols float2; K1g (`forward`) adds one float2 a thread and cluster x
// cols float2 of block sums; K3g its Q x cols power slots, 2 kHalo x cols
// halo slots a chunk and one float a thread.
static int column_smem(int nch, bool forward, int n_az, int cluster,
                       int cols, int threads) {
  const int q = n_az / cluster;
  int qb = 1;
  while (4 * qb * qb <= q) qb *= 2;      // QB = 2^floor(log2(Q) / 2)
  int bytes = nch * (q + qb) * cols * (int)sizeof(float2);
  if (nch == 2 && forward)
    bytes += (threads + cluster * cols) * (int)sizeof(float2);
  else if (nch == 2)
    bytes += ((q + 2 * kHalo * cluster) * cols + threads)
             * (int)sizeof(float);
  return bytes;
}

// The factored kind's (ops/cuda/csa_kernel.py::factored_smem): per channel
// ceil(n1 / cluster) x n2 x cols float2; K1g as column_smem; K3g n1 chunks
// of ceil(n2 / cluster) + 2 kHalo power slots a column and one float a
// thread.
static int factored_smem(int nch, bool forward, int n1, int n2, int cluster,
                         int cols, int threads) {
  const int j = (n2 + cluster - 1) / cluster;
  int bytes = nch * ((n1 + cluster - 1) / cluster) * n2 * cols
              * (int)sizeof(float2);
  if (nch == 2 && forward)
    bytes += (threads + cluster * cols) * (int)sizeof(float2);
  else if (nch == 2)
    bytes += (n1 * (j + 2 * kHalo) * cols + threads) * (int)sizeof(float);
  return bytes;
}

// Launches `kernel` as ceil(n_rg / cols) tiles of clusters of CS blocks of
// column_threads(CS, STAGE, NCH) threads, after checking the plan (a chirp-z
// instantiation, COLS > 0, is built for tiles of COLS columns; `expect` is
// the shared memory the launch's arithmetic gives); returns the CUDA error
// code. Clusters of more than 8 blocks are non-portable: the kernel is
// allowed them first.
template <int CS, int STAGE, int COLS, int NCH, typename... KArgs,
          typename... Args>
static int column_launch(void (*kernel)(KArgs...), int expect, int n_rg,
                         int cols, int smem, void* stream, Args... args) {
  constexpr int threads = column_threads(CS, STAGE, NCH);
  if (cols < 8 || cols > kColThreads || (cols & (cols - 1)) != 0
      || (COLS > 0 && cols != COLS) || smem != expect || smem > 232448)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  if (CS > 8) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_rg + cols - 1) / cols * CS);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, args..., nis::log2_of(cols));
  if (err) return err;
  return (int)cudaGetLastError();
}

// The (n, cluster) splits the column pass is built for, one per n
// (column_plan's): F(CS, QA, QB) for the launch's pair;
// cudaErrorInvalidValue for any other. Direct: the azimuth sides that are
// powers of two. Chirp-z: the chirp-z lengths 256 to 16,384.
template <typename F>
static int column_dispatch(int n, int cluster, F f) {
  switch (n * 32 + cluster) {
    case 64 * 32 + 1: return f.template run<1, 8, 8, kDirect>();
    case 128 * 32 + 1: return f.template run<1, 16, 8, kDirect>();
    case 256 * 32 + 1: return f.template run<1, 16, 16, kDirect>();
    case 512 * 32 + 1: return f.template run<1, 32, 16, kDirect>();
    case 1024 * 32 + 2: return f.template run<2, 32, 16, kDirect>();
    case 2048 * 32 + 4: return f.template run<4, 32, 16, kDirect>();
    case 4096 * 32 + 8: return f.template run<8, 32, 16, kDirect>();
    case 8192 * 32 + 16: return f.template run<16, 32, 16, kDirect>();
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
static int chirpz_dispatch(int m, int cluster, F f) {
  switch (m * 32 + cluster) {
    case 256 * 32 + 1: return f.template run<1, 16, 16, kChirpZ>();
    case 512 * 32 + 1: return f.template run<1, 32, 16, kChirpZ>();
    case 1024 * 32 + 2: return f.template run<2, 32, 16, kChirpZ>();
    case 2048 * 32 + 4: return f.template run<4, 32, 16, kChirpZ>();
    case 4096 * 32 + 8: return f.template run<8, 32, 16, kChirpZ>();
    case 8192 * 32 + 16: return f.template run<16, 32, 16, kChirpZ>();
    case 16384 * 32 + 16: return f.template run<16, 32, 32, kChirpZ>();
    default: return (int)cudaErrorInvalidValue;
  }
}

// The factored kind's outer legs n1 (csa_kernel.py::FACTORED_OUTER), each on
// clusters of 8 (FACTORED_CLUSTER): F(CS, N1, 1)
template <typename F>
static int factored_dispatch(int n1, int cluster, F f) {
  switch (n1 * 32 + cluster) {
    case 32 * 32 + 8: return f.template run<8, 32, 1, kFactored>();
    case 16 * 32 + 8: return f.template run<8, 16, 1, kFactored>();
    case 8 * 32 + 8: return f.template run<8, 8, 1, kFactored>();
    case 23 * 32 + 8: return f.template run<8, 23, 1, kFactored>();
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tile width a launch of NCH channels at STAGE is built for: any (0)
// for the direct and factored passes, chirpz_cols for the chirp-z one.
template <int NCH, int CS, int QB, int STAGE>
constexpr int built_cols() {
  return STAGE == kChirpZ ? chirpz_cols(NCH, QB, column_threads(CS, STAGE))
                          : 0;
}

// What the launch structs share: the transform's length n (m, or n_az for
// the factored kind), its factored legs (n1 = 0 for the other kinds) and
// the plan; expect(CS, QA, STAGE) is the shared memory their arithmetic
// gives a block.
struct ColumnArgs {
  int n, n_az, n1, n2, len, npass, n_rg, cols, smem;
  template <int CS, int QA, int STAGE>
  int expect(int nch, bool forward) const {
    const int threads = column_threads(CS, STAGE, nch);
    return STAGE == kFactored
               ? factored_smem(nch, forward, QA, n2, CS, cols, threads)
               : column_smem(nch, forward, n, CS, cols, threads);
  }
};

template <int NCH>
struct K1Launch {
  const float *x1r, *x1i, *x2r, *x2i, *u, *c1, *w;
  const float2 *tw, *chirp, *spec;
  const int* fidx;
  float *z1r, *z1i, *z2r, *z2i, *bal;
  ColumnArgs a;
  int balance;
  void* stream;
  template <int CS, int QA, int QB, int STAGE>
  int run() const {
    return column_launch<CS, STAGE, built_cols<NCH, CS, QB, STAGE>(), NCH>(
        k1_kernel<NCH, CS, QA, QB, STAGE>,
        a.expect<CS, QA, STAGE>(NCH, true), a.n_rg, a.cols, a.smem, stream,
        x1r, x1i, x2r, x2i, u, c1, w, tw, chirp, spec, fidx, z1r, z1i, z2r,
        z2i, bal, a.n_rg, a.n_az, a.n2, a.len, a.npass, balance);
  }
};

struct K3Launch {
  const float *zr, *zi;
  const float2 *tw, *chirp, *spec;
  const int* fidx;
  float *sr, *si;
  ColumnArgs a;
  void* stream;
  template <int CS, int QA, int QB, int STAGE>
  int run() const {
    return column_launch<CS, STAGE, built_cols<1, CS, QB, STAGE>(), 1>(
        k3_kernel<CS, QA, QB, STAGE>, a.expect<CS, QA, STAGE>(1, false),
        a.n_rg, a.cols, a.smem, stream, zr, zi, tw, chirp, spec, fidx, sr,
        si, a.n_rg, a.n_az, a.n2, a.len, a.npass);
  }
};

struct K3gLaunch {
  const float *z1r, *z1i, *z2r, *z2i, *cal_cs;
  const float2 *tw, *chirp, *spec;
  const int* fidx;
  float *s1r, *s1i, *s2r, *s2i, *ph, *mag, *pw, *cso, *csi, *peaks;
  ColumnArgs a;
  int h_out, h_in;
  void* stream;
  template <int CS, int QA, int QB, int STAGE>
  int run() const {
    return column_launch<CS, STAGE, built_cols<2, CS, QB, STAGE>(), 2>(
        k3g_kernel<CS, QA, QB, STAGE>, a.expect<CS, QA, STAGE>(2, false),
        a.n_rg, a.cols, a.smem, stream, z1r, z1i, z2r, z2i, cal_cs, tw,
        chirp, spec, fidx, s1r, s1i, s2r, s2i, ph, mag, pw, cso, csi, peaks,
        a.n_rg, a.n_az, a.n2, a.len, a.npass, h_out, h_in);
  }
};

// The column pass's launchers (ops/cuda/csa_kernel.py::AzimuthPlan): one
// launch on `stream`, of the direct pass at m == n_az (a power of two), of
// the factored transform where n1 > 0 (n_az = n1 x n2 on `npass` local
// passes of `len` points, n2 or n2 - 1), else of the chirp-z transform of
// n_az points on m. `cols`, `cluster` and `smem` are the column plan's;
// `tw` is the m-point table (the factored kind's L- and n1-point tables),
// `chirp` (n_az) and `spec` (m) the direction's chirp-z tables (null at
// m == n_az; `spec` Rader's spectrum for a factored prime n2), `fidx` the
// factored kind's index table (null for the others).
template <typename L>
static int column_run(const L& l, int cluster) {
  const ColumnArgs& a = l.a;
  if (a.n1 > 0) {
    if (a.n != a.n_az || a.n1 * a.n2 != a.n_az || a.npass < 1
        || (a.len != a.n2 && a.len != a.n2 - 1))
      return (int)cudaErrorInvalidValue;
    return factored_dispatch(a.n1, cluster, l);
  }
  return a.n != a.n_az ? chirpz_dispatch(a.n, cluster, l)
                       : column_dispatch(a.n_az, cluster, l);
}

extern "C" int k1g_launch(
    const float* x1r, const float* x1i, const float* x2r, const float* x2i,
    const float* u, const float* c1, const float* w, const float2* tw,
    const float2* chirp, const float2* spec, const int* fidx, float* z1r,
    float* z1i, float* z2r, float* z2i, float* bal, int n_az, int m, int n1,
    int n2, int len, int npass, int n_rg, int balance, int cols, int cluster,
    int smem, void* stream) {
  return column_run(
      K1Launch<2>{x1r, x1i, x2r, x2i, u, c1, w, tw, chirp, spec, fidx, z1r,
                  z1i, z2r, z2i, bal,
                  {m, n_az, n1, n2, len, npass, n_rg, cols, smem}, balance,
                  stream},
      cluster);
}

extern "C" int k1_launch(
    const float* xr, const float* xi, const float* u, const float* c1,
    const float* w, const float2* tw, const float2* chirp,
    const float2* spec, const int* fidx, float* zr, float* zi, int n_az,
    int m, int n1, int n2, int len, int npass, int n_rg, int cols,
    int cluster, int smem, void* stream) {
  return column_run(
      K1Launch<1>{xr, xi, nullptr, nullptr, u, c1, w, tw, chirp, spec, fidx,
                  zr, zi, nullptr, nullptr, nullptr,
                  {m, n_az, n1, n2, len, npass, n_rg, cols, smem}, 0,
                  stream},
      cluster);
}

extern "C" int k3_launch(
    const float* zr, const float* zi, const float2* tw, const float2* chirp,
    const float2* spec, const int* fidx, float* sr, float* si, int n_az,
    int m, int n1, int n2, int len, int npass, int n_rg, int cols,
    int cluster, int smem, void* stream) {
  return column_run(
      K3Launch{zr, zi, tw, chirp, spec, fidx, sr, si,
               {m, n_az, n1, n2, len, npass, n_rg, cols, smem}, stream},
      cluster);
}

extern "C" int k3g_launch(
    const float* z1r, const float* z1i, const float* z2r, const float* z2i,
    const float* cal_cs, const float2* tw, const float2* chirp,
    const float2* spec, const int* fidx, float* s1r, float* s1i, float* s2r,
    float* s2i, float* ph, float* mag, float* pw, float* cso, float* csi,
    float* peaks, int n_az, int m, int n1, int n2, int len, int npass,
    int n_rg, int h_out, int h_in, int cols, int cluster, int smem,
    void* stream) {
  return column_run(
      K3gLaunch{z1r, z1i, z2r, z2i, cal_cs, tw, chirp, spec, fidx, s1r, s1i,
                s2r, s2i, ph, mag, pw, cso, csi, peaks,
                {m, n_az, n1, n2, len, npass, n_rg, cols, smem}, h_out, h_in,
                stream},
      cluster);
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

// The balance kernel's float4 loads of a plane a block makes in one round,
// and its blocks an SM: ops/cuda/gmti_kernel.py::balance_limits sizes the
// grid and the workspace from them.
extern "C" int balance_loads_per_block() { return kBalThreads * kBalU; }
extern "C" int balance_blocks_per_sm() { return kBalBlocksPerSm; }

// Raw balance over the n_az * n_rg floats of each plane, n4 = n_az * n_rg
// / 4 float4 and the rest, on `blocks` blocks
// (ops/cuda/gmti_kernel.py::balance_grid): `work` holds the ticket (a zero
// uint32, left zero) and then 2 x blocks floats for the partials, `out` re
// and im.
extern "C" int balance_launch(const float* x1r, const float* x1i,
                              const float* x2r, const float* x2i,
                              float* work, float* out, int n_az, int n_rg,
                              int blocks, void* stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)n_az * n_rg;
  balance_kernel<<<blocks, kBalThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x1r),
      reinterpret_cast<const float4*>(x1i),
      reinterpret_cast<const float4*>(x2r),
      reinterpret_cast<const float4*>(x2i), work, out, n / 4, (int)(n % 4));
  return (int)cudaGetLastError();
}
