#!/usr/bin/env python3
"""Where the time goes inside K2 (the CSA range pass), phase by phase, and
what its design choices are worth.

    python3 scripts/probe_torch_k2_phases.py [--parent DIR]  # GPU, repo root

Builds copies of ``nis_sar_amtigmti_video_tpu_torch/csrc/csa_kernel.cu``
under ``build/probe_k2_phases/``, each alone with ``-Xptxas -v`` (the
registers and spills of every instantiation head the output):

- "marked": thread 0 of every block records ``clock64()`` after each phase
  (and ``%globaltimer`` and the SM id at its start and end). K2 single runs
  on chip_smoke.py's phase-3 inputs at 4096^2 (one row a block), and the
  output gives the span, the mean block time, the most blocks resident at
  once and the mean SM cycles of each phase: loads issued / forward pass 1
  and its transpose / pass 2's DFT and the wait / the second transpose /
  pass 3 / Phi2 / the inverse's pass 1 and transpose / pass 2 and the wait
  / the second transpose / pass 3 / Phi3 and the stores. Each mark costs a
  few cycles.
- VARIANTS, text substitutions on copies: four or two blocks an SM in
  place of three (64 or 128 registers a thread in place of 80); the
  table's radix-2 ``nis::dft_reg`` at 16 points in place of the
  constant-twiddle dft16; six or fifteen table loads for the twiddles
  between passes in place of two (W^m and W^(4 m)) and their products;
  Phi2 and Phi3 in rolled loops (one sincosf's code each), each thread's
  phases staged in its own slots of the row's buffer; and three kernels
  appended to the source: the pair with both channels' points in one
  thread and the trig evaluated once for the two (68 KB, two blocks an
  SM); the pair split by channel in one block of 512 threads, the row's
  Phi2 and Phi3 evaluated once, 8 points a thread, and staged in shared
  memory (68 KB, two blocks an SM); persistent blocks (three an SM) that
  walk the rows and channels, the next row's two plane segments brought
  into a 32 KB shared slot by ``cp.async.bulk`` on an ``mbarrier`` while
  the current one transforms.

Then the times (CUDA events, median of 20 after a warm-up) at 4096^2 of
this tree's wrappers and launchers (K2 single on channel 1, the pair), of
each variant's launchers, and of the composed torch.fft pass (fft, x Phi2,
ifft, x Phi3, the phases built outside the timing), each with its error
against the plain version, its share of the byte bound (2 or 4 planes read
and written), and whether its single gives the pair's bits on both
channels. With ``--parent DIR`` (a checkout of another commit of the port,
e.g. a ``git archive`` unpacked under ``build/``) it also builds DIR's
sources as they are (the whole library, as the package builds it) and
marked where DIR has the radix-2 K2 (its phases: loads / forward stages /
Phi2 / inverse stages / Phi3 and stores), times DIR's launchers on the
same inputs in the same runs, and compares the SASS of every kernel
outside csa_kernel.cu (``cuobjdump -sass`` of the package's library and of
DIR's build): identical, or how many lines differ (the diffs under
``build/probe_k2_phases/``). The card's name and power limit head the
output. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    _build, csa_kernel)
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import (  # noqa: E402
    median_ms)
from probe_torch_echo_phases import sass_functions  # noqa: E402
from probe_torch_fft_phases import (  # noqa: E402
    HEADER, MARK, PHASE_TIMES, _replace, phases)

OUT = ROOT / "build" / "probe_k2_phases"
N = chip_smoke.N
END = MARK + "  ts_end();\n"
MARKS = [
    ("namespace {\n", HEADER, 1),
    ("  const size_t at = (size_t)row * N + tau;\n  float2 v[16];\n",
     "  ts_reset();\n", 1),
    ("    v[m] = make_float2(__ldcs(xr + at + T * m), __ldcs(xi + at + T * m))"
     ";\n", MARK, 1),
    ("    for (int k = 0; k < R; ++k) buf[k * kPitch + s] = u[k];\n  }\n"
     "  __syncthreads();\n", MARK, 1),
    ("    __syncthreads();  // every thread is past its reads of the buffer\n",
     MARK, 1),
    ("    for (int k = 0; k < 16; ++k) buf[(prefix + Q * k) * kNext + s] = "
     "u[k];\n    __syncthreads();\n", MARK, 1),
    ("  transform<N, false>(v, buf, a.tw, tau);\n", MARK, 1),
    ("    v[m] = nis::cmul(v[m], make_float2(cs, sn));\n  }\n", MARK, 1),
    ("  transform<N, true>(v, buf, a.tw, tau);\n", MARK, 1),
    ("    __stcs(o_im + at + T * m, y.y);\n  }\n", END, 1),
]
PHASES = ["loads issued", "fwd pass 1 + transpose", "fwd pass 2, wait",
          "fwd transpose 2", "fwd pass 3", "Phi2", "inv pass 1 + transpose",
          "inv pass 2, wait", "inv transpose 2", "inv pass 3",
          "Phi3 + stores"]
# the radix-2 design (one block a row, the row in shared memory): loads /
# forward stages / Phi2 in bit-reversed order / inverse stages / Phi3 and
# stores
PARENT_MARKS = [
    ("namespace {\n", HEADER, 1),
    ("  const size_t base = (size_t)row * n;\n", "  ts_reset();\n", 1),
    ("    if constexpr (NCH == 2) b[i] = make_float2(x2r[base + i], "
     "x2i[base + i]);\n  }\n  __syncthreads();\n", MARK, 1),
    ("  nis::fft_dif(a, NCH, n, log2n, tw, false);\n", MARK, 1),
    ("    if constexpr (NCH == 2) b[p] = nis::cmul(b[p], phi);\n  }\n"
     "  __syncthreads();\n", MARK, 1),
    ("  nis::fft_dit(a, NCH, n, log2n, tw, true);\n", MARK, 1),
    ("      o2i[base + i] = y2.y;\n    }\n  }\n", END, 1),
]
PARENT_PHASES = ["loads", "forward stages", "Phi2", "inverse stages",
                 "Phi3 + stores"]

_BLOCKS = "  static constexpr int kBlocksPerSm = 3;\n"
# the pair with both channels' points in one thread: each channel's
# transforms as the single runs them, on a buffer of its own, and Phi2 /
# Phi3 evaluated once for the two
PAIR_REGS = r"""
namespace {
template <int N>
__global__ void __launch_bounds__(256, 2) k2_pair_regs_kernel(K2Args a) {
  using P = K2Plan<N>;
  constexpr int T = P::T;
  const int tid = (int)threadIdx.x, tau = tid % T;
  const int row = (int)blockIdx.x * P::kRows + tid / T;
  const size_t at = (size_t)row * N + tau;
  float2* buf1 = reinterpret_cast<float2*>(nis_smem) + (tid / T) * P::kRowSlots;
  float2* buf2 = buf1 + P::kRows * P::kRowSlots;
  float2 v1[16], v2[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    v1[m] = make_float2(__ldcs(a.x1r + at + T * m), __ldcs(a.x1i + at + T * m));
    v2[m] = make_float2(__ldcs(a.x2r + at + T * m), __ldcs(a.x2i + at + T * m));
  }
  transform<N, false>(v1, buf1, a.tw, tau);
  transform<N, false>(v2, buf2, a.tw, tau);
  const float al = a.alpha[row];
  const float be = a.beta[row];
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const float f = __ldg(a.fr + tau + T * m);
    float sn, cs;
    sincosf((al * f + be) * f, &sn, &cs);
    v1[m] = nis::cmul(v1[m], make_float2(cs, sn));
    v2[m] = nis::cmul(v2[m], make_float2(cs, sn));
  }
  transform<N, true>(v1, buf1, a.tw, tau);
  transform<N, true>(v2, buf2, a.tw, tau);
  const float rp = a.rphase[row];
  const float gg = a.g[row];
  const float cc = a.c3[row];
  const float inv_n = 1.0f / (float)N;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int i = tau + T * m;
    float sn, cs;
    sincosf(rp + __ldg(a.cphase + i) + gg * __ldg(a.dr + i) -
                cc * __ldg(a.usq + i),
            &sn, &cs);
    const float2 y1 = nis::cmul(nis::cscale(v1[m], inv_n), make_float2(cs, sn));
    const float2 y2 = nis::cmul(nis::cscale(v2[m], inv_n), make_float2(cs, sn));
    __stcs(a.o1r + at + T * m, y1.x);
    __stcs(a.o1i + at + T * m, y1.y);
    __stcs(a.o2r + at + T * m, y2.x);
    __stcs(a.o2i + at + T * m, y2.y);
  }
}
}  // namespace

extern "C" int k2_pair_regs_launch(
    const float* x1r, const float* x1i, const float* x2r, const float* x2i,
    const float* fr, const float* alpha, const float* beta,
    const float* cphase, const float* dr, const float* usq,
    const float* rphase, const float* g, const float* c3, const float2* tw,
    float* o1r, float* o1i, float* o2r, float* o2i, int n_az, int n_rg,
    void* stream) {
  if (n_rg != 4096) return (int)cudaErrorInvalidValue;
  using P = K2Plan<4096>;
  const K2Args a{x1r, x1i, x2r, x2i, fr,  alpha, beta, cphase, dr,
                 usq, rphase, g, c3, tw,  o1r,   o1i,  o2r,    o2i};
  const int smem = 2 * P::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      k2_pair_regs_kernel<4096>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  k2_pair_regs_kernel<4096><<<n_az / P::kRows, P::kThreads, smem,
                              (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
"""
# persistent blocks over (row, channel) items at 4096: the next item's two
# plane segments (2 x 16 KB) come into a shared slot by cp.async.bulk on an
# mbarrier while the current one transforms; the same row_pass
PERSIST = r"""
namespace {
constexpr int kPersistBlocksPerSm = 3;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void fetch_row(const K2Args& a, int item,
                                          int n_az, float* slot,
                                          unsigned long long* bar) {
  constexpr int N = 4096;
  const bool second = item >= n_az;
  const size_t row = (size_t)(second ? item - n_az : item);
  const float* xr = (second ? a.x2r : a.x1r) + row * N;
  const float* xi = (second ? a.x2i : a.x1i) + row * N;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(2 * N * 4) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(slot)), "l"(xr), "r"(N * 4), "r"(smem_u32(bar))
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(slot + N)), "l"(xi), "r"(N * 4), "r"(smem_u32(bar))
      : "memory");
}

__global__ void __launch_bounds__(256, kPersistBlocksPerSm)
    k2_persist_kernel(K2Args a, int n_az, int nch) {
  constexpr int N = 4096, T = N / 16;
  float2* buf = reinterpret_cast<float2*>(nis_smem);
  float* slot = reinterpret_cast<float*>(buf + K2Plan<N>::kRowSlots);
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(slot + 2 * N);
  const int tau = (int)threadIdx.x, items = n_az * nch;
  if (tau == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if ((int)blockIdx.x < items) fetch_row(a, blockIdx.x, n_az, slot, bar);
  }
  __syncthreads();
  unsigned parity = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    unsigned done = 0;
    while (!done)
      asm volatile("{\n .reg .pred p;\n"
                   " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                   " selp.u32 %0, 1, 0, p;\n}\n"
                   : "=r"(done) : "r"(smem_u32(bar)), "r"(parity)
                   : "memory");
    parity ^= 1;
    float2 v[16];
#pragma unroll
    for (int m = 0; m < 16; ++m)
      v[m] = make_float2(slot[tau + T * m], slot[N + tau + T * m]);
    __syncthreads();  // the slot is read, the last item's buffer reads done
    if (tau == 0 && item + (int)gridDim.x < items) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch_row(a, item + gridDim.x, n_az, slot, bar);
    }
    const bool second = item >= n_az;
    row_pass<N>(v, buf, a, second ? item - n_az : item, tau,
                second ? a.o2r : a.o1r, second ? a.o2i : a.o1i);
  }
}
}  // namespace

extern "C" int k2_persist_launch(
    const float* x1r, const float* x1i, const float* x2r, const float* x2i,
    const float* fr, const float* alpha, const float* beta,
    const float* cphase, const float* dr, const float* usq,
    const float* rphase, const float* g, const float* c3, const float2* tw,
    float* o1r, float* o1i, float* o2r, float* o2i, int n_az, int n_rg,
    int nch, void* stream) {
  if (n_rg != 4096) return (int)cudaErrorInvalidValue;
  const K2Args a{x1r, x1i, x2r, x2i, fr,  alpha, beta, cphase, dr,
                 usq, rphase, g, c3, tw,  o1r,   o1i,  o2r,    o2i};
  const int smem = K2Plan<4096>::kSmem + 2 * 4096 * 4 + 16;
  cudaError_t err = cudaFuncSetAttribute(
      k2_persist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  k2_persist_kernel<<<sms * kPersistBlocksPerSm, 256, smem,
                      (cudaStream_t)stream>>>(a, n_az, nch);
  return (int)cudaGetLastError();
}
"""
# the pair split by channel in one block of 512 threads (two an SM), each
# channel's transforms as the single runs them on a buffer of its own, and
# the row's Phi2 and Phi3 evaluated once for the two: 8 points a thread,
# staged in channel 0's buffer between barriers
PAIR_STAGED = r"""
namespace {
template <int N>
__global__ void __launch_bounds__(512, 2) k2_pair_staged_kernel(K2Args a) {
  using P = K2Plan<N>;
  constexpr int T = P::T, kPoints = P::kRows * N;
  const int tid = (int)threadIdx.x, ch = tid / 256, t = tid % 256;
  const int tau = t % T, row0 = (int)blockIdx.x * P::kRows;
  const int row = row0 + t / T;
  const size_t at = (size_t)row * N + tau;
  float2* stage = reinterpret_cast<float2*>(nis_smem);
  float2* buf = stage + (ch * P::kRows + t / T) * P::kRowSlots;
  const float* xr = ch ? a.x2r : a.x1r;
  const float* xi = ch ? a.x2i : a.x1i;
  float* o_re = ch ? a.o2r : a.o1r;
  float* o_im = ch ? a.o2i : a.o1i;
  float2 v[16];
#pragma unroll
  for (int m = 0; m < 16; ++m)
    v[m] = make_float2(__ldcs(xr + at + T * m), __ldcs(xi + at + T * m));
  transform<N, false>(v, buf, a.tw, tau);
  __syncthreads();  // every thread is past the forward's reads
#pragma unroll
  for (int j = 0; j < kPoints / 512; ++j) {
    const int q = tid + 512 * j, r = row0 + q / N;
    const float al = a.alpha[r], be = a.beta[r];
    const float f = __ldg(a.fr + q % N);
    float sn, cs;
    sincosf((al * f + be) * f, &sn, &cs);
    stage[q] = make_float2(cs, sn);
  }
  __syncthreads();
  const int base = (t / T) * N + tau;
#pragma unroll
  for (int m = 0; m < 16; ++m) v[m] = nis::cmul(v[m], stage[base + T * m]);
  transform<N, true>(v, buf, a.tw, tau);
  __syncthreads();  // every thread is past the inverse's reads
#pragma unroll
  for (int j = 0; j < kPoints / 512; ++j) {
    const int q = tid + 512 * j, r = row0 + q / N, i = q % N;
    const float rp = a.rphase[r], gg = a.g[r], cc = a.c3[r];
    float sn, cs;
    sincosf(rp + __ldg(a.cphase + i) + gg * __ldg(a.dr + i) -
                cc * __ldg(a.usq + i),
            &sn, &cs);
    stage[q] = make_float2(cs, sn);
  }
  __syncthreads();
  const float inv_n = 1.0f / (float)N;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const float2 y = nis::cmul(nis::cscale(v[m], inv_n), stage[base + T * m]);
    __stcs(o_re + at + T * m, y.x);
    __stcs(o_im + at + T * m, y.y);
  }
}
}  // namespace

extern "C" int k2_pair_staged_launch(
    const float* x1r, const float* x1i, const float* x2r, const float* x2i,
    const float* fr, const float* alpha, const float* beta,
    const float* cphase, const float* dr, const float* usq,
    const float* rphase, const float* g, const float* c3, const float2* tw,
    float* o1r, float* o1i, float* o2r, float* o2i, int n_az, int n_rg,
    void* stream) {
  if (n_rg != 4096) return (int)cudaErrorInvalidValue;
  using P = K2Plan<4096>;
  const K2Args a{x1r, x1i, x2r, x2i, fr,  alpha, beta, cphase, dr,
                 usq, rphase, g, c3, tw,  o1r,   o1i,  o2r,    o2i};
  const int smem = 2 * P::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      k2_pair_staged_kernel<4096>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k2_pair_staged_kernel<4096><<<n_az / P::kRows, 512, smem,
                                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
"""
# the single's trig in rolled loops (one sincosf's code a phase in place
# of sixteen), each thread's phases staged in its own slots of the row's
# buffer, once every thread is past the transform's reads
_PHI2 = """#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const float f = __ldg(a.fr + tau + T * m);
    float sn, cs;
    sincosf((al * f + be) * f, &sn, &cs);
    v[m] = nis::cmul(v[m], make_float2(cs, sn));
  }
"""
_PHI2_ROLLED = """  __syncthreads();
#pragma unroll 1
  for (int m = 0; m < 16; ++m) {
    const float f = __ldg(a.fr + tau + T * m);
    float sn, cs;
    sincosf((al * f + be) * f, &sn, &cs);
    buf[tau + T * m] = make_float2(cs, sn);
  }
#pragma unroll
  for (int m = 0; m < 16; ++m) v[m] = nis::cmul(v[m], buf[tau + T * m]);
"""
_PHI3 = """#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int i = tau + T * m;
    float sn, cs;
    sincosf(rp + __ldg(a.cphase + i) + gg * __ldg(a.dr + i) -
                cc * __ldg(a.usq + i),
            &sn, &cs);
    const float2 y = nis::cmul(nis::cscale(v[m], inv_n), make_float2(cs, sn));
"""
_PHI3_ROLLED = """  __syncthreads();
#pragma unroll 1
  for (int m = 0; m < 16; ++m) {
    const int i = tau + T * m;
    float sn, cs;
    sincosf(rp + __ldg(a.cphase + i) + gg * __ldg(a.dr + i) -
                cc * __ldg(a.usq + i),
            &sn, &cs);
    buf[i] = make_float2(cs, sn);
  }
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const float2 y = nis::cmul(nis::cscale(v[m], inv_n), buf[tau + T * m]);
"""
# the twiddles between passes from six table loads, W^(m a) and W^(4 m b)
# for a, b < 4, in place of two and their products
_TW_TWO = """  wa[1] = nis::twiddle_pow<INV>(tw, m, N);
#pragma unroll
  for (int a = 2; a < A; ++a) wa[a] = nis::cmul(wa[a - 1], wa[1]);
  if constexpr (B > 1) wb[1] = nis::twiddle_pow<INV>(tw, 4 * m, N);
#pragma unroll
  for (int b = 2; b < B; ++b) wb[b] = nis::cmul(wb[b - 1], wb[1]);
"""
_TW_SIX = """#pragma unroll
  for (int a = 1; a < A; ++a) wa[a] = nis::twiddle_pow<INV>(tw, m * a, N);
#pragma unroll
  for (int b = 1; b < B; ++b) wb[b] = nis::twiddle_pow<INV>(tw, 4 * m * b, N);
"""
VARIANTS = {
    "four an SM": [(_BLOCKS, _BLOCKS.replace("3", "4"))],
    "two an SM": [(_BLOCKS, _BLOCKS.replace("3", "2"))],
    "radix-2 dft_reg at 16": [
        ("  if constexpr (R == 16) dft16<INV>(u);\n  else nis::dft_reg",
         "  nis::dft_reg")],
    "six twiddle loads": [(_TW_TWO, _TW_SIX)],
    "fifteen twiddle loads": [
        ("    const float2 w = b == 0 ? wa[a] : a == 0 ? wb[b] : "
         "nis::cmul(wa[a], wb[b]);\n",
         "    const float2 w = nis::twiddle_pow<INV>(tw, m * k, N);\n")],
    "trig in rolled loops": [(_PHI2, _PHI2_ROLLED), (_PHI3, _PHI3_ROLLED)],
    "pair in registers": [],
    "pair, trig staged": [],
    "persistent, bulk copy": [],
}
APPENDED = {"pair in registers": PAIR_REGS, "pair, trig staged": PAIR_STAGED,
            "persistent, bulk copy": PERSIST}
# the appended pairs' launchers (the pair's signature)
PAIR_LAUNCHERS = {"pair in registers": "k2_pair_regs_launch",
                  "pair, trig staged": "k2_pair_staged_launch"}
HBM_BYTES_PER_S = chip_smoke.HBM_BYTES_PER_S


def _mark(src: str, marks) -> str:
    for anchor, text, count in marks:
        if src.count(anchor) != count:
            raise RuntimeError(f"anchor found {src.count(anchor)} times, "
                               f"expected {count}: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src + PHASE_TIMES


def radix2_design(src: str) -> bool:
    """Whether a csa_kernel.cu is the radix-2 shared-memory K2."""
    return "nis::fft_dif(" in src


def parent_library(parent: str) -> Path:
    """DIR's whole library, built as the package builds its own (under
    build/probe_k2_phases/parent)."""
    saved = _build.SOURCE_DIR, _build.BUILD_DIR
    _build.SOURCE_DIR = Path(parent) / _build.SOURCE_DIR.relative_to(ROOT)
    _build.BUILD_DIR = OUT / "parent"
    try:
        return _build.build()
    finally:
        _build.SOURCE_DIR, _build.BUILD_DIR = saved


def _load(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.nis_error_string.argtypes = [ctypes.c_int]
    lib.nis_error_string.restype = ctypes.c_char_p
    return lib


def build(parent) -> dict:
    """Libraries of csa_kernel.cu alone, all nvcc processes at once, under
    build/probe_k2_phases/: "marked", each of VARIANTS, and with ``parent``
    "parent marked" (DIR's radix-2 K2) and "parent" (DIR's whole library).
    Prints what ptxas reports for each K2 kernel; a variant that does not
    build is reported and left out."""
    shutil.rmtree(OUT, ignore_errors=True)
    src = (_build.SOURCE_DIR / "csa_kernel.cu").read_text()
    sources = {"marked": (_build.SOURCE_DIR, _mark(src, MARKS))}
    for v, pairs in VARIANTS.items():
        sources[v] = (_build.SOURCE_DIR,
                      _replace(src, pairs, v) + APPENDED.get(v, ""))
    parent_src = None
    if parent is not None:
        where = Path(parent) / _build.SOURCE_DIR.relative_to(ROOT)
        parent_src = (where / "csa_kernel.cu").read_text()
        if radix2_design(parent_src):
            sources["parent marked"] = (where,
                                        _mark(parent_src, PARENT_MARKS))
    jobs = {}
    for i, (name, (headers, text)) in enumerate(sources.items()):
        where = OUT / f"lib{i}"
        where.mkdir(parents=True)
        for f in headers.glob("*.cuh"):
            shutil.copy(f, where)
        (where / "csa_kernel.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(where / "lib.so"),
               str(where / "csa_kernel.cu")]
        jobs[name] = (where, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    if parent is not None:
        libs["parent"] = _load(parent_library(parent))
    for name, (where, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            if name in VARIANTS:
                print(f"[build] {name}: nvcc failed, left out:\n{log[-3000:]}")
                continue
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
                entry = fn if "k2_" in fn else None
            elif entry and ("registers" in line or "stack frame" in line):
                info = line.split("info", 1)[-1].lstrip(" :")
                short = entry[entry.index("k2_"):]
                print(f"[ptxas] {name}: {short}: {info}")
        lib = _load(where / "lib.so")
        if name.endswith("marked"):
            lib.get_phase_times.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    return libs


def named(title, names, ts) -> None:
    """The mean SM cycles of each named phase over the blocks recorded."""
    k = int(ts[:, 61].max())
    full = ts[ts[:, 61] == k]
    cyc = np.diff(full[:, 1:k + 1], axis=1).mean(axis=0)
    if len(cyc) != len(names):
        raise RuntimeError(f"{title}: {len(cyc)} phases, expected "
                           f"{len(names)}")
    print(f"  {title}: " + "; ".join(f"{a} {c:.0f}" for a, c in
                                     zip(names, cyc))
          + f" (a block {cyc.sum():.0f} cycles)")


class Launchers:
    """Callables launching a library's K2 launchers on the phase-3 inputs
    into preallocated outputs (single: channel 1)."""

    def __init__(self, lib, x, fac):
        self.lib, self.x, self.fac = lib, x, fac
        self.out = [torch.empty_like(x[0]) for _ in range(4)]

    def _call(self, name, tensors, ints):
        fn = getattr(self.lib, name)
        fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                       + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = fn(*(t.data_ptr() for t in tensors), *ints,
                 _build.stream_handle(tensors[0].device))
        if err:
            raise RuntimeError(f"{name}: "
                               f"{self.lib.nis_error_string(err).decode()}")

    def single(self, ch=0):
        x = self.x[2 * ch:2 * ch + 2]
        self._call("k2_launch", (*x, *self.fac, *self.out[:2]), (N, N))
        return [o.clone() for o in self.out[:2]]

    def pair(self, name="k2_pair_launch", extra=()):
        self._call(name, (*self.x, *self.fac, *self.out), (N, N, *extra))
        return [o.clone() for o in self.out]

    def timed(self, name="k2_pair_launch", extra=()):
        return lambda: self._call(name, (*self.x, *self.fac, *self.out),
                                  (N, N, *extra))

    def timed_single(self):
        return lambda: self._call("k2_launch", (*self.x[:2], *self.fac,
                                                *self.out[:2]), (N, N))


def _kernels(so: str) -> dict:
    """sass_functions of every kernel of library ``so``, keyed by its name
    with the file's anonymous namespace (whose hash follows the file's
    text) as ANON."""
    return {re.sub(r"(\d+)(_GLOBAL__N__\w+)", lambda m: "ANON"
                   + m.group(2)[int(m.group(1)):], k): v
            for k, v in sass_functions(so, ("",)).items()}


def compare_sass(parent_so: str) -> None:
    """The SASS of every kernel outside csa_kernel.cu: the package's
    library against DIR's build."""
    here = _kernels(str(_build.library_path()))
    there = _kernels(parent_so)
    same = differ = 0
    for i, fn in enumerate(sorted(set(here) | set(there))):
        if "k2_kernel" in fn or "k2_" in fn.split("(")[0]:
            continue
        a, b = there.get(fn), here.get(fn)
        if a is None or b is None:
            print(f"[sass] {fn}: only in "
                  f"{'this tree' if a is None else 'the parent'}")
            differ += 1
            continue
        diff = list(difflib.unified_diff(a, b, "parent", "this tree",
                                         lineterm="", n=2))
        changed = sum(1 for d in diff[2:] if d[:1] in "+-")
        if changed:
            differ += 1
            (OUT / f"sass_{i}.diff").write_text(fn + "\n" + "\n".join(diff)
                                                + "\n")
            print(f"[sass] {fn}: {changed} lines differ")
        else:
            same += 1
    print(f"[sass] kernels outside csa_kernel.cu: {same} identical, "
          f"{differ} differ")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_k2_phases: needs a CUDA device")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of another commit whose K2 "
                    "to time beside and whose other kernels' SASS to "
                    "compare")
    parent = ap.parse_args().parent
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    libs = build(parent)
    dev = torch.device("cuda", 0)
    f, x = chip_smoke.kernel_inputs(dev)
    tw = csa_kernel.twiddle_table(N, dev)
    fac = csa_kernel._k2_args("probe", x, f, tw)[2]

    print("[phases] this tree, K2 single at 4096^2")
    seen = phases(libs["marked"],
                  [("k2_call", lambda: csa_kernel.k2_call(x[0], x[1], f,
                                                          twiddles=tw))])
    named("cycles", PHASES, seen["k2_call"][2])
    if "parent marked" in libs:
        print(f"[phases] parent {parent} (the radix-2 design), K2 single")
        seen = phases(libs["parent marked"],
                      [("k2_call", lambda: csa_kernel.k2_call(
                          x[0], x[1], f, twiddles=tw))])
        named("cycles", PARENT_PHASES, seen["k2_call"][2])

    want = csa_kernel.k2_pair_plain(*x, f)
    bounds = {n: n * 2 * 4.0 * N * N / HBM_BYTES_PER_S * 1e3 for n in (2, 4)}
    phi2, phi3 = csa_kernel._k2_phases(f)
    xc = [torch.complex(x[0], x[1]), torch.complex(x[2], x[3])]
    xs = torch.stack(xc)

    lib_ms = {n: median_ms(lambda: chip_smoke.composed_range_pass(
        z, phi2, phi3), reps=20) for n, z in ((2, xc[0]), (4, xs))}
    print(f"[time] composed torch.fft pass: one channel {lib_ms[2]:.4f} ms, "
          f"the two as a stack {lib_ms[4]:.4f} ms")

    def line(name, fn, got, planes):
        err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got, want[:len(got)]))
        if err > 1e-4:
            raise RuntimeError(f"{name}: rel err {err}")
        ms = median_ms(fn, reps=20)
        return (f"{name} {ms:.4f} ms ({bounds[planes] / ms:.1%} of the byte "
                f"bound, {ms / lib_ms[planes]:.2f}x torch.fft, rel err "
                f"{err:.2e})")

    single = [line("this tree's wrapper", lambda: csa_kernel.k2_call(
        x[0], x[1], f, twiddles=tw), csa_kernel.k2_call(
        x[0], x[1], f, twiddles=tw), 2)]
    pair = [line("this tree's wrapper", lambda: csa_kernel.k2_pair_call(
        *x, f, twiddles=tw), csa_kernel.k2_pair_call(*x, f, twiddles=tw), 4)]
    builds = [("this tree", _build.library())]
    builds += [(v, libs[v]) for v in VARIANTS if v in libs]
    if "parent" in libs:
        builds.append((f"parent {parent}", libs["parent"]))
    for name, lib in builds:
        run = Launchers(lib, x, fac)
        if name in PAIR_LAUNCHERS:
            got = run.pair(PAIR_LAUNCHERS[name])
            pair.append(line(name, run.timed(PAIR_LAUNCHERS[name]), got, 4))
            ref = [Launchers(libs[name], x, fac).single(c) for c in (0, 1)]
        elif name == "persistent, bulk copy":
            got = run.pair("k2_persist_launch", (1,))
            single.append(line(name, run.timed("k2_persist_launch", (1,)),
                               got[:2], 2))
            got = run.pair("k2_persist_launch", (2,))
            pair.append(line(name, run.timed("k2_persist_launch", (2,)),
                             got, 4))
            ref = [Launchers(libs[name], x, fac).single(c) for c in (0, 1)]
        else:
            single.append(line(f"{name}'s launcher", run.timed_single(),
                               run.single(), 2))
            got = run.pair()
            pair.append(line(f"{name}'s launcher", run.timed(), got, 4))
            ref = [run.single(c) for c in (0, 1)]
        same = all(torch.equal(a, b) for a, b in zip(ref[0] + ref[1], got))
        pair[-1] += "; the single's bits on both channels" if same else \
            "; NOT the single's bits"
    print("[time] K2 single: " + "; ".join(single))
    print("[time] K2 pair: " + "; ".join(pair))
    print(f"[time] byte bounds: single {bounds[2]:.4f} ms, pair "
          f"{bounds[4]:.4f} ms")
    if "parent" in libs:
        compare_sass(libs["parent"]._name)


if __name__ == "__main__":
    main()
