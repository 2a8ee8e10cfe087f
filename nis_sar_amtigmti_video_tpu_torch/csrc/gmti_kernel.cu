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
// to keep more DSMEM loads in flight. The probe
// scripts/probe_torch_column_plan.py times both, and the plans, against
// their alternatives, which it builds from a copy of this file.

constexpr int kColThreads = 256;

struct Tile {
  int n_rg, cols, log2cols, col0, rank;
};

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
// into y + ch * ysz, so every thread of the block has a load to issue.
template <bool INV, int NCH, int CS, int QA, int QB>
__device__ void pass_a(const float* __restrict__ z1r,
                       const float* __restrict__ z1i,
                       const float* __restrict__ z2r,
                       const float* __restrict__ z2i, float2* y, int ysz,
                       const float2* __restrict__ tw, const Tile& t) {
  constexpr int n = CS * QA * QB;
  const size_t step = (size_t)CS * QB * t.n_rg;
  for (int task = threadIdx.x; task < ((NCH * QB) << t.log2cols);
       task += blockDim.x) {
    const int c = task & (t.cols - 1), u = task >> t.log2cols;
    const int ch = u / QB, qb = u % QB;
    const float* __restrict__ zr = ch ? z2r : z1r;
    const float* __restrict__ zi = ch ? z2i : z1i;
    const size_t at = (size_t)(t.rank + CS * qb) * t.n_rg + t.col0 + c;
    float2 v[QA];
#pragma unroll
    for (int a = 0; a < QA; ++a)
      v[a] = make_float2(__ldg(zr + at + a * step), __ldg(zi + at + a * step));
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

template <bool INV, int CS, int QA, int QB>
__device__ void pass_b(float2* y, const float2* __restrict__ tw,
                       const Tile& t) {
  constexpr int n = CS * QA * QB;
  for (int task = threadIdx.x; task < (QA << t.log2cols);
       task += blockDim.x) {
    const int c = task & (t.cols - 1), ja = task >> t.log2cols;
    float2 v[QB];
#pragma unroll
    for (int b = 0; b < QB; ++b) v[b] = y[slot<QA>(ja + QA * b, c, t)];
    nis::dft_reg<INV, QB>(v, tw, n / QB);
#pragma unroll
    for (int b = 0; b < QB; ++b) {
      if constexpr (CS > 1)
        v[b] = nis::cmul(v[b],
                         nis::twiddle_pow<INV>(tw, t.rank * (ja + QA * b), n));
      y[slot<QA>(ja + QA * b, c, t)] = v[b];
    }
  }
}

// Passes A and B of NCH channels (channel ch's planes into y + ch * ysz),
// then the cluster barrier: every block's Y is complete.
template <bool INV, int NCH, int CS, int QA, int QB>
__device__ void column_passes(const float* z1r, const float* z1i,
                              const float* z2r, const float* z2i, float2* y,
                              int ysz, const float2* __restrict__ tw,
                              const Tile& t) {
  pass_a<INV, NCH, CS, QA, QB>(z1r, z1i, z2r, z2i, y, ysz, tw, t);
  __syncthreads();
  pass_b<INV, CS, QA, QB>(y, tw, t);
  if constexpr (NCH == 2) pass_b<INV, CS, QA, QB>(y + ysz, tw, t);
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
// memory, and 1 / n (a power of two) at the end.
template <int NCH, int CS, int QA, int QB>
__global__ void __launch_bounds__(kColThreads, 2) k1_kernel(
    const float* __restrict__ x1r, const float* __restrict__ x1i,
    const float* __restrict__ x2r, const float* __restrict__ x2i,
    const float* __restrict__ u, const float* __restrict__ c1,
    const float* __restrict__ w, const float2* __restrict__ tw,
    float* __restrict__ z1r, float* __restrict__ z1i,
    float* __restrict__ z2r, float* __restrict__ z2i,
    float* __restrict__ bal, int n_rg, int balance, int log2cols) {
  constexpr int Q = QA * QB, n = CS * Q;
  const Tile t = tile_of<CS>(n_rg, log2cols);
  const int ysz = (Q + QB) << log2cols;
  float2* y = reinterpret_cast<float2*>(nis_smem);
  // K1g's sums after the channels' slots: one a thread, then rank 0's
  // cols a block of the cluster
  float2* red = y + 2 * ysz;
  float2* part = red + kColThreads;
  column_passes<false, NCH, CS, QA, QB>(x1r, x1i, x2r, x2i, y, ysz, tw, t);
  float2 s = make_float2(0.0f, 0.0f);   // X1 conj(X2) over this thread's rows
  column_gather<false, NCH, CS, QA, QB>(
      y, ysz, tw, t, [&](int c, int, int row, float2 v1, float2 v2) {
        const int col = t.col0 + c;
        const float du = __ldg(u + col) - __ldg(w + row);
        float sn, cs;
        sincosf(__ldg(c1 + row) * du * du, &sn, &cs);
        const float2 phi = make_float2(cs, sn);
        const size_t idx = (size_t)row * n_rg + col;
        const float2 a = nis::cmul(v1, phi);
        z1r[idx] = a.x;
        z1i[idx] = a.y;
        if constexpr (NCH == 2) {
          const float2 b = nis::cmul(v2, phi);
          z2r[idx] = b.x;
          z2i[idx] = b.y;
          s.x += v1.x * v2.x + v1.y * v2.y;
          s.y += v1.y * v2.x - v1.x * v2.y;
        }
      });
  if constexpr (NCH == 2) {
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
  if constexpr (NCH == 2) {
    if (t.rank == 0 && (int)threadIdx.x < t.cols) {
      float sr = 0.0f, si = 0.0f;
#pragma unroll
      for (int r = 0; r < CS; ++r) {
        sr += part[(r << log2cols) + threadIdx.x].x;
        si += part[(r << log2cols) + threadIdx.x].y;
      }
      const float inv_n = 1.0f / (float)n;
      bal[t.col0 + threadIdx.x] = balance ? sr * inv_n : 0.0f;
      bal[n_rg + t.col0 + threadIdx.x] = balance ? si * inv_n : 0.0f;
    }
  }
}

template <int CS, int QA, int QB>
__global__ void __launch_bounds__(kColThreads, 2) k3_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float2* __restrict__ tw, float* __restrict__ sr,
    float* __restrict__ si, int n_rg, int log2cols) {
  float2* y = reinterpret_cast<float2*>(nis_smem);
  const Tile t = tile_of<CS>(n_rg, log2cols);
  column_passes<true, 1, CS, QA, QB>(zr, zi, nullptr, nullptr, y, 0, tw, t);
  column_gather<true, 1, CS, QA, QB>(
      y, 0, tw, t, [&](int c, int, int row, float2 v, float2) {
        const size_t idx = (size_t)row * n_rg + t.col0 + c;
        sr[idx] = v.x;
        si[idx] = v.y;
      });
  cluster_barrier<CS>();
}

// K3g keeps the DPCA power of its Q output rows in `pcol`, chunk by chunk
// (CS chunks of J consecutive rows), each chunk with kHalo slots on either
// side for the rows just beyond it: chunk k1's row jj of column c at slot
// pslot(k1, jj, c). After the gather the block copies those halo rows from
// the blocks that hold them (one DSMEM load each), so a box sum of
// half-width h <= kHalo reads only its own block's shared memory.
constexpr int kHalo = 16;

template <int J>
__device__ __forceinline__ int pslot(int k1, int jj, int c, const Tile& t) {
  return ((k1 * (J + 2 * kHalo) + kHalo + jj) << t.log2cols) + c;
}

// The azimuth box sums of half-widths h_out and h_in at `row` (chunk k1,
// row jj of it) of column c: each the power of rows [row - h, row + h]
// clipped to the column, summed in row order (a locally windowed sum, as
// nis::window_sum; adding 0 outside a window changes no bit). One pass over
// the wider window, from the chunk and its halo when it is within kHalo,
// else row by row from the blocks that hold the rows.
template <int CS, int QA, int QB>
__device__ __forceinline__ float2 column_windows(const float* pcol, int row,
                                                 int k1, int jj, int c,
                                                 int h_out, int h_in,
                                                 const Tile& t) {
  constexpr int Q = QA * QB, J = Q / CS, n = CS * Q;
  const int h = h_out > h_in ? h_out : h_in;
  const int lo = (row - h > 0 ? row - h : 0) - row;
  const int hi = (row + h < n - 1 ? row + h : n - 1) - row;
  float so = 0.0f, si = 0.0f;
  if (h <= kHalo) {
    const float* p = pcol + pslot<J>(k1, jj, c, t);
#pragma unroll 8
    for (int d = lo; d <= hi; ++d) {
      const float v = p[d * t.cols];
      so += abs(d) <= h_out ? v : 0.0f;
      si += abs(d) <= h_in ? v : 0.0f;
    }
  } else {
    for (int d = lo; d <= hi; ++d) {
      const int q = row + d, jq = q % Q;  // q = jq + Q kq, held by jq / J
      const float v = block_smem<CS>(pcol, jq / J)[pslot<J>(q / Q, jq % J,
                                                            c, t)];
      so += abs(d) <= h_out ? v : 0.0f;
      si += abs(d) <= h_in ? v : 0.0f;
    }
  }
  return make_float2(so, si);
}

template <int CS, int QA, int QB>
__global__ void __launch_bounds__(kColThreads, 2) k3g_kernel(
    const float* __restrict__ z1r, const float* __restrict__ z1i,
    const float* __restrict__ z2r, const float* __restrict__ z2i,
    const float* __restrict__ cal_cs, const float2* __restrict__ tw,
    float* __restrict__ s1r, float* __restrict__ s1i,
    float* __restrict__ s2r, float* __restrict__ s2i,
    float* __restrict__ ph, float* __restrict__ mag, float* __restrict__ pw,
    float* __restrict__ cso, float* __restrict__ csi,
    float* __restrict__ peaks, int n_rg, int h_out, int h_in, int log2cols) {
  constexpr int Q = QA * QB, J = Q / CS, n = CS * Q;
  const Tile t = tile_of<CS>(n_rg, log2cols);
  const int ysz = (Q + QB) << log2cols;
  float2* y = reinterpret_cast<float2*>(nis_smem);
  float* pcol = reinterpret_cast<float*>(y + 2 * ysz);
  float* red = pcol + ((Q + 2 * kHalo * CS) << log2cols);
  column_passes<true, 2, CS, QA, QB>(z1r, z1i, z2r, z2i, y, ysz, tw, t);

  const float cr = cal_cs[0];
  const float ci = cal_cs[1];
  float m = 0.0f;     // max |s1|^2 over this thread's rows of column c
  column_gather<true, 2, CS, QA, QB>(
      y, ysz, tw, t, [&](int c, int lr, int row, float2 v1, float2 v2) {
        const size_t idx = (size_t)row * n_rg + t.col0 + c;
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
        pcol[pslot<J>(lr / J, lr % J, c, t)] = p;
      });
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
  if (t.rank == 0 && (int)threadIdx.x < t.cols) {
    float pk = 0.0f;
#pragma unroll
    for (int r = 0; r < CS; ++r)
      pk = fmaxf(pk, block_smem<CS>(red, r)[threadIdx.x]);
    peaks[t.col0 + threadIdx.x] = pk;
  }
  // the halo: kHalo rows before and after each chunk, where in the column
#pragma unroll 4
  for (int task = threadIdx.x; task < ((CS * 2 * kHalo) << log2cols);
       task += blockDim.x) {
    const int c = task & (t.cols - 1), e = (task >> log2cols) % (2 * kHalo);
    const int k1 = (task >> log2cols) / (2 * kHalo);
    const int first = k1 * Q + t.rank * J;       // the chunk's first row
    const int row = e < kHalo ? first - kHalo + e : first + J + e - kHalo;
    if (row >= 0 && row < n) {
      const int jq = row % Q;
      const float* src = block_smem<CS>(pcol, jq / J);
      pcol[((k1 * (J + 2 * kHalo) + (e < kHalo ? e : J + e)) << log2cols)
           + c] = src[pslot<J>(row / Q, jq % J, c, t)];
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
  for (int task = threadIdx.x; task < (Q << log2cols); task += blockDim.x) {
    const int c = task & (t.cols - 1), lr = task >> log2cols;
    const int k1 = lr / J, jj = lr % J;
    const int row = k1 * Q + t.rank * J + jj;
    const size_t idx = (size_t)row * n_rg + t.col0 + c;
    const float2 w = column_windows<CS, QA, QB>(pcol, row, k1, jj, c,
                                                h_out, h_in, t);
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

// Raw balance: re / im of sum(x1 conj(x2)) over n4 float4 of each plane, in
// one launch. Thread i of the grid takes float4 i, i + S, i + 2 S, ... (S
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
    float* __restrict__ work, float* __restrict__ out, long long n4) {
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
    out[0] = sr;
    out[1] = si;
    *ticket = 0u;                    // ready for the next launch
  }
}

}  // namespace

// Each launcher runs its kernel over (n_az, n_rg) f32 planes on `stream`
// (n_az, n_rg powers of two) and returns cudaGetLastError() after the launch.

// The column pass's launch plan (ops/cuda/csa_kernel.py::column_plan):
// `cols` columns a tile (a power of two, 8 to kColThreads, dividing n_rg),
// a cluster of `cluster` blocks a tile, `smem` bytes of dynamic shared
// memory a block. The split of n_az into CS x QA x QB is fixed by (n_az,
// cluster): QA = 2^ceil(log2(Q) / 2), QB = Q / QA, Q = n_az / cluster.
// The shared memory a block of the plan needs: per channel (Q + QB) x cols
// float2; K1g (`forward`) adds one float2 a thread and cluster x cols
// float2 of block sums; K3g its Q x cols power slots, 2 kHalo x cols halo
// slots a chunk and one float a thread.
static int column_smem(int nch, bool forward, int n_az, int cluster,
                       int cols) {
  const int q = n_az / cluster;
  int qb = 1;
  while (4 * qb * qb <= q) qb *= 2;      // QB = 2^floor(log2(Q) / 2)
  int bytes = nch * (q + qb) * cols * (int)sizeof(float2);
  if (nch == 2 && forward)
    bytes += (kColThreads + cluster * cols) * (int)sizeof(float2);
  else if (nch == 2)
    bytes += ((q + 2 * kHalo * cluster) * cols + kColThreads)
             * (int)sizeof(float);
  return bytes;
}

// Launches `kernel` as n_rg / cols tiles of clusters of CS blocks, after
// checking the plan; returns the CUDA error code.
template <int CS, typename... KArgs, typename... Args>
static int column_launch(void (*kernel)(KArgs...), int nch, bool forward,
                         int n_az, int n_rg, int cols, int smem,
                         void* stream, Args... args) {
  if (cols < 8 || cols > kColThreads || (cols & (cols - 1)) != 0
      || n_rg % cols != 0
      || smem != column_smem(nch, forward, n_az, CS, cols)
      || smem > 232448)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_rg / cols * CS);
  cfg.blockDim = dim3(kColThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, args..., nis::log2_of(cols));
  if (err) return err;
  return (int)cudaGetLastError();
}

// The (n_az, cluster) splits the column pass is built for, one per n_az
// (column_plan's): F(CS, QA, QB) for the launch's pair;
// cudaErrorInvalidValue for any other.
template <typename F>
static int column_dispatch(int n_az, int cluster, F f) {
  switch (n_az * 16 + cluster) {
    case 64 * 16 + 1: return f.template run<1, 8, 8>();
    case 128 * 16 + 1: return f.template run<1, 16, 8>();
    case 256 * 16 + 1: return f.template run<1, 16, 16>();
    case 512 * 16 + 1: return f.template run<1, 32, 16>();
    case 1024 * 16 + 2: return f.template run<2, 32, 16>();
    case 2048 * 16 + 4: return f.template run<4, 32, 16>();
    case 4096 * 16 + 8: return f.template run<8, 32, 16>();
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int NCH>
struct K1Launch {
  const float *x1r, *x1i, *x2r, *x2i, *u, *c1, *w;
  const float2* tw;
  float *z1r, *z1i, *z2r, *z2i, *bal;
  int n_az, n_rg, balance, cols, smem;
  void* stream;
  template <int CS, int QA, int QB>
  int run() const {
    return column_launch<CS>(k1_kernel<NCH, CS, QA, QB>, NCH, true, n_az,
                             n_rg, cols, smem, stream, x1r, x1i, x2r, x2i, u,
                             c1, w, tw, z1r, z1i, z2r, z2i, bal, n_rg,
                             balance);
  }
};

struct K3Launch {
  const float *zr, *zi;
  const float2* tw;
  float *sr, *si;
  int n_az, n_rg, cols, smem;
  void* stream;
  template <int CS, int QA, int QB>
  int run() const {
    return column_launch<CS>(k3_kernel<CS, QA, QB>, 1, false, n_az, n_rg,
                             cols, smem, stream, zr, zi, tw, sr, si, n_rg);
  }
};

struct K3gLaunch {
  const float *z1r, *z1i, *z2r, *z2i, *cal_cs;
  const float2* tw;
  float *s1r, *s1i, *s2r, *s2i, *ph, *mag, *pw, *cso, *csi, *peaks;
  int n_az, n_rg, cols, smem, h_out, h_in;
  void* stream;
  template <int CS, int QA, int QB>
  int run() const {
    return column_launch<CS>(
        k3g_kernel<CS, QA, QB>, 2, false, n_az, n_rg, cols, smem, stream,
        z1r, z1i, z2r, z2i, cal_cs, tw, s1r, s1i, s2r, s2i, ph, mag, pw, cso,
        csi, peaks, n_rg, h_out, h_in);
  }
};

extern "C" int k1g_launch(
    const float* x1r, const float* x1i, const float* x2r, const float* x2i,
    const float* u, const float* c1, const float* w, const float2* tw,
    float* z1r, float* z1i, float* z2r, float* z2i, float* bal, int n_az,
    int n_rg, int balance, int cols, int cluster, int smem, void* stream) {
  return column_dispatch(
      n_az, cluster,
      K1Launch<2>{x1r, x1i, x2r, x2i, u, c1, w, tw, z1r, z1i, z2r, z2i, bal,
                  n_az, n_rg, balance, cols, smem, stream});
}

extern "C" int k1_launch(const float* xr, const float* xi, const float* u,
                         const float* c1, const float* w, const float2* tw,
                         float* zr, float* zi, int n_az, int n_rg, int cols,
                         int cluster, int smem, void* stream) {
  return column_dispatch(
      n_az, cluster,
      K1Launch<1>{xr, xi, nullptr, nullptr, u, c1, w, tw, zr, zi, nullptr,
                  nullptr, nullptr, n_az, n_rg, 0, cols, smem, stream});
}

extern "C" int k3_launch(const float* zr, const float* zi, const float2* tw,
                         float* sr, float* si, int n_az, int n_rg, int cols,
                         int cluster, int smem, void* stream) {
  return column_dispatch(n_az, cluster, K3Launch{zr, zi, tw, sr, si, n_az,
                                                 n_rg, cols, smem, stream});
}

extern "C" int k3g_launch(
    const float* z1r, const float* z1i, const float* z2r, const float* z2i,
    const float* cal_cs, const float2* tw, float* s1r, float* s1i,
    float* s2r, float* s2i, float* ph, float* mag, float* pw, float* cso,
    float* csi, float* peaks, int n_az, int n_rg, int h_out, int h_in,
    int cols, int cluster, int smem, void* stream) {
  return column_dispatch(
      n_az, cluster,
      K3gLaunch{z1r, z1i, z2r, z2i, cal_cs, tw, s1r, s1i, s2r, s2i, ph, mag,
                pw, cso, csi, peaks, n_az, n_rg, cols, smem, h_out, h_in,
                stream});
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

// Raw balance over n4 = n_az * n_rg / 4 float4 of each plane on `blocks`
// blocks (ops/cuda/gmti_kernel.py::balance_grid): `work` holds the ticket
// (a zero uint32, left zero) and then 2 x blocks floats for the partials,
// `out` re and im.
extern "C" int balance_launch(const float* x1r, const float* x1i,
                              const float* x2r, const float* x2i,
                              float* work, float* out, int n_az, int n_rg,
                              int blocks, void* stream) {
  if (n_rg % 4 || blocks < 1) return (int)cudaErrorInvalidValue;
  balance_kernel<<<blocks, kBalThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x1r),
      reinterpret_cast<const float4*>(x1i),
      reinterpret_cast<const float4*>(x2r),
      reinterpret_cast<const float4*>(x2i), work, out,
      (long long)n_az * n_rg / 4);
  return (int)cudaGetLastError();
}
