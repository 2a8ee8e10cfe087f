#!/usr/bin/env python3
"""Where the time goes inside the port's recentre kernels, phase by phase.

    python3 scripts/probe_torch_fft_phases.py [--parent DIR]  # GPU, repo root

Builds a copy of ``nis_sar_amtigmti_video_tpu_torch/csrc/fft_kernel.cu``
under ``build/probe_fft_phases/`` in which thread 0 of every block records
``clock64()`` after each phase (and ``%globaltimer`` and the SM id at its
start and end), runs forward spectra at the VideoSAR reference shape (P
2,500 x ns 22,004, nfft 32,768) and at the ring path's 500 pulses, and
recentre from spectra and the fused recentre + presum once each (presum 4,
band rows 82-97), and prints per kernel: the span, the mean block time, the
most blocks resident at once, the idle gap between blocks on an SM, and the
mean SM cycles of each phase. The phases follow the kernel source. Forward
spectra: column loads and 16-point DFTs / column transpose, A-point DFTs
and the wait for the cluster / DSMEM pushes / cluster barrier / row
16-point DFTs and transpose / row 8-point DFTs, filter and stores. The
recentre kernels, per pulse (the mean over a group's pulses), the fused
kernel: column loads, 16-point DFTs and the ramp factors / the columns'
A-point DFTs, the push and the cluster barrier / the rows' 16-point DFTs
and transpose / the rows' 8-point DFTs and the accumulate; recentre from
spectra: loads, ramp factors and accumulate; then per group (both): the
inverse rows' 8-point DFTs (the fused kernel's filter) / their inverse
16-point DFTs and the wait for the cluster / the exchange to the column
owners / the columns' inverse DFTs / the band stores. Each mark costs a few
cycles. ptxas's registers and spills head the output.

Then the times (CUDA events, median of 20 after a warm-up): the wrapper's
forward spectra (the unmarked build) at 2,500 and 500 pulses, its error
against the plain version, beside ``torch.fft.fft(rc, n=nfft, dim=-1)`` and
the byte bound; the two recentre kernels through their wrappers beside
their plain versions' errors and their byte bounds; and the cost of the
500-pulse forward launch's last, partial wave: its time against the time
at the most pulses that fill whole waves (the clusters resident at once,
from the marked run, times the whole waves in 500), scaled to 500. Each of
``VARIANTS`` (text substitutions on copies of the source: forward spectra
on fewer blocks an SM, with plain loads and stores, on clusters of 4; the
recentre kernels' accumulators in registers or shared memory at two to four
blocks an SM, and their ramp per point, the first design's, in place of the
factored one) is timed beside this tree, and marked too where the marks'
anchors survive. With ``--parent DIR`` (a checkout of another commit of
the port, e.g. a ``git archive`` unpacked under ``build/``), it also builds
DIR's source as it is and marked (the first recentre design's phases, where
DIR has it) and times DIR's launchers on the same inputs, with the filter
tables in the order they read (k1 natural, or bit-reversed for the first
design's kernels). The card's name and power limit head the output. Imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops import bp_fast  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    _build, fft_kernel)
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import (  # noqa: E402
    median_ms)

OUT = ROOT / "build" / "probe_fft_phases"
MAX_BLOCKS = 8192
HEADER = r"""
__device__ unsigned long long g_ts[8192 * 64];
__shared__ int n_ts;
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void ts_reset() {
  if (threadIdx.x == 0 && blockIdx.x < 8192) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    n_ts = 1;
    g_ts[blockIdx.x * 64] = gtime();
    g_ts[blockIdx.x * 64 + 62] = sm;
    g_ts[blockIdx.x * 64 + 1] = clock64();
  }
}
__device__ __forceinline__ void ts_mark() {
  if (threadIdx.x == 0 && blockIdx.x < 8192 && ++n_ts < 60)
    g_ts[blockIdx.x * 64 + n_ts] = clock64();
}
__device__ __forceinline__ void ts_end() {
  if (threadIdx.x == 0 && blockIdx.x < 8192) {
    g_ts[blockIdx.x * 64 + 63] = gtime();
    g_ts[blockIdx.x * 64 + 61] = n_ts;
  }
}
"""
# (anchor in the kernel source, text put after it); each anchor must occur
# exactly as often as given
MARK = "  ts_mark();\n"
END = MARK + "  ts_end();\n"
# recentre from spectra's accumulate: the indent of its E1 factor's line,
# and its head comment's first line
_E1 = " " * 34
_SPECTRA = "// Recentre from spectra: one cluster a presum group."
MARKS = [
    ("namespace {\n", HEADER, 1),
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  ts_reset();\n", 4),
    # forward spectra
    ("    for (int kb = 0; kb < 16; ++kb) buf[(a * 16 + kb) * C + c] = v[kb];"
     "\n  }\n  __syncthreads();\n", MARK, 1),
    ("    cluster_wait();\n", MARK, 2),
    ("      push_column<B1, R>(cluster, buf, w[i], c0 + j % C, j / C, 0, 1, "
     "t.tw_n);\n    }\n", MARK, 1),
    ("    push_column<B1, R>(cluster, buf, u, c0 + c, kb, h, 2, t.tw_n);\n",
     MARK, 1),
    ("  cluster.sync();\n", MARK, 1),
    ("    for (int kb = 0; kb < 16; ++kb) buf[kb * F::kRowT + r * 8 + a] = "
     "v[kb];\n  }\n  __syncthreads();\n", MARK, 1),
    ("      __stcs(o + 16 * ka, nis::cmul(w[ka], __ldg(f + 16 * ka)));\n  }\n",
     END, 1),
    # the fused kernel, per pulse
    ("    if (tid < P::kRamp) ramp[tid] = e;\n    __syncthreads();\n", MARK,
     1),
    ("    columns_second_half<B1, R>(cluster, sm, t);\n", MARK, 1),
    ("    rows_first_half<B1, R>(sm, t);\n", MARK, 1),
    ("    rows_accumulate<B1, R>(sm, ramp, acc, t);\n", MARK, 1),
    # recentre from spectra, per pulse
    (_E1 + "nis::cmul(e2, ramp[R + kb + 16 * ka])));\n      }\n    }\n",
     MARK, 1),
    # both recentre kernels, per group (presum_inverse)
    ("    for (int a = 0; a < 8; ++a) sm[kb * F::kRowT + r * 8 + a] = u[i][a];"
     "\n  }\n  __syncthreads();\n", MARK, 1),
    ("    cluster_wait();  // every block is past its reads of the rows\n",
     MARK, 1),
    ("    cluster_wait();  // this block's columns are in\n", MARK, 1),
    ("    nis::dft_reg<true, 16>(z, t.tw_b1, A);\n", MARK, 1),
    ("        __stcs(o + (size_t)(n2 - p0) * 128, nis::cscale(z[b], scale));\n"
     "    }\n", END, 1),
]
FUSED_PHASES = ["column loads, DFT16, ramp factors",
                "column DFT-A, push, cluster barrier", "row DFT16",
                "row DFT8, accumulate"]
SPECTRA_PHASES = ["loads, ramp factors, accumulate"]
INVERSE_PHASES = ["inverse row DFT8", "inverse row DFT16, wait",
                  "exchange", "inverse column DFTs", "band store"]
# the first recentre design's phases (a parent that has it): per pulse of
# the fused kernel, column load and FFT / cluster barrier / DSMEM scatter /
# cluster barrier / row FFT / ramp and accumulate; per group (both recentre
# kernels), the inverse row FFT / twiddle / cluster barrier / DSMEM gather
# and column FFT / band store and final barrier
PARENT_MARKS = [
    ("namespace {\n", HEADER, 1),
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  ts_reset();\n", 4),
    ("  cluster.sync();\n", MARK, 5),
    ("  columns_forward(load, c0, col, t, s);\n", MARK, 1),
    ("  scatter_columns(cluster, col, y, c0, t, s);\n", MARK, 1),
    ("  block_fft_dif(y, 7, 128, t.tw_128, false);\n", MARK, 1),
    ("        acc[l] = first ? r : cadd(acc[l], r);\n      });\n", MARK, 1),
    ("  block_fft_dit(acc, 7, 128, t.tw_128, true);\n", MARK, 1),
    ("      [&](int l, float2 v) { acc[l] = v; });\n", MARK, 1),
    ("  block_fft_dif(col, s.log2b1, s.b1 + 1, t.tw_b1, true);\n", MARK, 1),
    ("  group_inverse(cluster, acc, col, out + (size_t)g * (p1 - p0) * 128, "
     "p0, p1,\n                t, s);\n", "  ts_end();\n", 2),
]
# variants of this checkout's fft_kernel.cu, each a copy with the listed
# text replaced (each text must occur once), timed beside it, and marked
# too where the marks' anchors survive. Forward spectra at nfft 32,768 with
# three or two blocks an SM in place of four; with plain loads and stores
# in place of streaming ones; on clusters of 4 blocks of 64 rows (512
# threads, two an SM) in place of 8 of 32 (256, four). The recentre
# kernels' plans (Rec): the fused kernel at two blocks an SM in place of
# three, recentre from spectra at three in place of four; and both with the
# first design's ramp, one sincosf a point, in place of the factored one
_BLOCKS_PER_SM = "  static constexpr int kBlocksPerSm = T == 256 ? 4 : 1;"
_REC_BLOCKS = ("  static constexpr int kBlocksPerSm = F::T == 256 ? "
               "(FUSED ? 3 : 4) : 1;")
_POINT_RAMP = r"""// the first design's ramp: one sincosf a point
template <int B1>
__device__ __forceinline__ float2 point_ramp(int f, int si, float sf,
                                             float car, float inv_d) {
  constexpr int N = 128 * B1;
  const unsigned m = ((unsigned)f * (unsigned)si) & (unsigned)(N - 1);
  const int fs = f >= N / 2 ? f - N : f;
  const float ph = ((float)m + (float)fs * sf) * (kTwoPi / (float)N) + car;
  float s, c;
  sincosf(ph, &s, &c);
  return make_float2(c * inv_d, s * inv_d);
}

template <int B1, int R>
__device__ __forceinline__ void rows_accumulate_pp(
    const float2* sm, float2* acc, const Tables& t, int k2_0, int si,
    float sf, float car, float inv_d) {
  using F = Fwd<B1, R>;
  const int tid = (int)threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = tid + i * F::T, kb = j % 16, r = j / 16;
    float2 w[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) w[a] = sm[kb * F::kRowT + r * 8 + a];
    nis::dft_reg<false, 8>(w, t.tw_128, 16);
#pragma unroll
    for (int ka = 0; ka < 8; ++ka) {
      float2* at = acc + (8 * i + ka) * F::T + tid;
      *at = cadd(*at, nis::cmul(w[ka], point_ramp<B1>(
          k2_0 + r + B1 * (kb + 16 * ka), si, sf, car, inv_d)));
    }
  }
}

"""
# the per-point ramp's scalars: each thread forms the pulse's itself
_RING_SLOT = "    float2* ramp = ramps + (jp & 1) * P::kRamp;\n"
_SCALARS = ("    int si_;\n    float sf_, car_;\n"
            "    pulse_scalars<128 * B1>(tr, pulse, num_p, si_, sf_, car_);\n")
VARIANTS = {
    "three an SM": [(_BLOCKS_PER_SM, _BLOCKS_PER_SM.replace("4", "3"))],
    "two an SM": [(_BLOCKS_PER_SM, _BLOCKS_PER_SM.replace("4", "2"))],
    "plain loads and stores": [
        ("v[b] = n < ns ? __ldcs(xp + n) : make_float2(0.f, 0.f);",
         "v[b] = n < ns ? xp[n] : make_float2(0.f, 0.f);"),
        ("      __stcs(o + 16 * ka, nis::cmul(w[ka], __ldg(f + 16 * ka)));",
         "      o[16 * ka] = nis::cmul(w[ka], __ldg(f + 16 * ka));")],
    "clusters of 4": [
        ("      return forward_spectra_on<256, 32>(num_p",
         "      return forward_spectra_on<256, 64>(num_p"),
        (_BLOCKS_PER_SM, _BLOCKS_PER_SM.replace(": 1", ": B1 == 256 ? 2 : 1")),
    ],
    "fused, two an SM": [
        (_REC_BLOCKS, _REC_BLOCKS.replace("FUSED ? 3", "FUSED ? 2"))],
    "from spectra, three an SM": [
        (_REC_BLOCKS, _REC_BLOCKS.replace(": 4)", ": 3)"))],
    "ramp per point": [
        (_SPECTRA, _POINT_RAMP + _SPECTRA),
        (_RING_SLOT, _RING_SLOT + _SCALARS),
        (_E1 + "nis::cmul(e2, ramp[R + kb + 16 * ka])));",
         _E1 + "point_ramp<B1>(k2_0 + r + B1 * (kb + 16 * ka), si_, sf_, "
         "car_, inv_d)));"),
        ("    rows_accumulate<B1, R>(sm, ramp, acc, t);",
         _SCALARS + "    rows_accumulate_pp<B1, R>(sm, acc, t, k2_0, si_, "
         "sf_, car_, inv_d);")],
}
# the variants that change the recentre kernels (the others change forward
# spectra)
RECENTRE_VARIANTS = ["fused, two an SM", "from spectra, three an SM",
                     "ramp per point"]
# k1 bit-reversed within a 128-point row: the first recentre design's
# filter order
BITREV_LANE = [int(f"{q:07b}"[::-1], 2) for q in range(128)]
# the error strings of a library built from fft_kernel.cu alone
SHIM = ('extern "C" const char* nis_error_string(int code) {\n'
        "  return cudaGetErrorString((cudaError_t)code);\n}\n")
PHASE_TIMES = ('extern "C" int get_phase_times(void* dst) {\n'
               "  return (int)cudaMemcpyFromSymbol(dst, g_ts, sizeof(g_ts));"
               "\n}\n"
               'extern "C" int reset_phase_times() {\n'
               "  void* p;\n"
               "  int err = (int)cudaGetSymbolAddress(&p, g_ts);\n"
               "  return err ? err : (int)cudaMemset(p, 0, sizeof(g_ts));\n"
               "}\n")
HBM_BYTES_PER_S = 3.35e12
KERNELS = ("forward_spectra_kernel", "recentre_spectra_kernel",
           "recenter_presum_kernel")


def first_design(src: str) -> bool:
    """Whether a source's recentre kernels are the first design (radix-2
    shared-memory helpers, filter with k1 bit-reversed in each row)."""
    return "group_inverse(" in src


def _replace(src: str, pairs, what: str) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"{what}: found {src.count(old)} times, "
                               f"expected once: {old!r}")
        src = src.replace(old, new)
    return src


def _mark(src: str, marks=MARKS) -> str:
    for anchor, text, count in marks:
        if src.count(anchor) != count:
            raise RuntimeError(f"anchor found {src.count(anchor)} times, "
                               f"expected {count}: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src + PHASE_TIMES


def build(parent) -> dict:
    """Libraries built from fft_kernel.cu alone, all nvcc processes at
    once, under build/probe_fft_phases/: "marked" (this checkout's, with
    the phase marks), "<variant>" for each of VARIANTS and "marked
    <variant>" where the marks apply to it, and "parent" (DIR's source as
    it is, with --parent). Prints what ptxas reports for the forward
    spectra and recentre kernels; a variant that does not build is
    reported and left out. With ``parent``, also "parent marked" where DIR
    has the first recentre design."""
    shutil.rmtree(OUT, ignore_errors=True)
    src = (_build.SOURCE_DIR / "fft_kernel.cu").read_text()
    sources = {"marked": (_build.SOURCE_DIR, _mark(src))}
    for v, pairs in VARIANTS.items():
        var = _replace(src, pairs, v)
        sources[v] = (_build.SOURCE_DIR, var)
        try:
            sources[f"marked {v}"] = (_build.SOURCE_DIR, _mark(var))
        except RuntimeError:
            pass                          # timed, not marked
    if parent is not None:
        where = Path(parent) / _build.SOURCE_DIR.relative_to(ROOT)
        text = (where / "fft_kernel.cu").read_text()
        sources["parent"] = (where, text)
        if first_design(text):
            sources["parent marked"] = (where, _mark(text, PARENT_MARKS))
    jobs = {}
    for i, (name, (headers, text)) in enumerate(sources.items()):
        where = OUT / f"lib{i}"
        where.mkdir(parents=True)
        for f in headers.glob("*.cuh"):
            shutil.copy(f, where)
        (where / "fft_kernel.cu").write_text(text + SHIM)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(where / "lib.so"),
               str(where / "fft_kernel.cu")]
        jobs[name] = (where, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (where, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            if name.removeprefix("marked ") in VARIANTS:
                print(f"[build] {name}: nvcc failed, left out:\n{log[-2000:]}")
                continue
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = (line.split("'")[1] if any(
                    k in line for k in KERNELS) else None)
            elif entry and ("registers" in line or "stack frame" in line):
                info = line.split("info", 1)[-1].lstrip(" :")
                print(f"[ptxas] {name}: {entry}: {info}")
        lib = ctypes.CDLL(str(where / "lib.so"))
        lib.nis_error_string.argtypes = [ctypes.c_int]
        lib.nis_error_string.restype = ctypes.c_char_p
        if name.startswith("marked"):
            lib.get_phase_times.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    return libs


def parent_forward(lib, natural: bool, rc, p):
    """A callable launching DIR's forward spectra on ``rc`` into a new
    output, with the filter table its launcher reads (k1 ``natural`` or
    bit-reversed)."""
    nfft = 1 << (rc.shape[1] - 1).bit_length()
    dev = rc.device
    filt = fft_kernel._filter_layout(p, nfft, True, dev)
    if not natural:
        filt = filt[:, BITREV_LANE].contiguous()
    ints = [rc.shape[0], rc.shape[1], nfft]
    fn = lib.forward_spectra_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * len(ints) + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tabs = fft_kernel._tables(nfft, dev)

    def run():
        out = torch.empty((rc.shape[0], nfft // 128, 128),
                          dtype=torch.complex64, device=dev)
        err = fn(*(t.data_ptr() for t in (rc, filt, *tabs, out)), *ints,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"parent forward_spectra_launch: "
                               f"{lib.nis_error_string(err).decode()}")
        return out
    return run


def launchers(lib, src: str, rc, spec, args, rows):
    """Callables launching ``lib``'s two recentre launchers (built from
    ``src``; the C signatures its wrappers use) on ``rc`` and its spectra
    ``spec`` into new outputs: with the float64 trajectory where the kernels
    form each pulse's scalars themselves, else with the per-pulse scalars
    (made once by the plain version, not timed); the fused kernel's filter
    in the order ``lib`` reads (k1 bit-reversed for the first design):
    (recentre from spectra, recentre + presum)."""
    p, d, t_ref = args[4], args[5], args[6]
    num_p, ns = rc.shape
    nfft = 1 << (ns - 1).bit_length()
    dev = rc.device
    filt = fft_kernel._filter_layout(p, nfft, True, dev)
    if first_design(src):
        filt = filt[:, BITREV_LANE].contiguous()
    tabs = fft_kernel._tables(nfft, dev)
    p0, p1 = rows
    shape = (-(-num_p // d), (p1 - p0) * 128)
    if "Traj tr" in src:
        tr, doubles = fft_kernel._kernel_trajectory(
            "probe", args[0], args[2], args[3], p, t_ref, None, dev)
        ring = (0,)
    else:
        tr, doubles = fft_kernel.kernel_scalars_plain(*args, nfft)[:3], ()
        ring = ()

    def call(name, tensors, ints):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        out = torch.empty(shape, dtype=torch.complex64, device=dev)
        fn.argtypes = ([ctypes.c_void_p] * (len(tensors) + 1)
                       + [ctypes.c_int] * len(ints)
                       + [ctypes.c_double] * len(doubles)
                       + [ctypes.c_void_p])
        err = fn(*(t.data_ptr() for t in (*tensors, out)), *ints, *doubles,
                 _build.stream_handle(dev))
        if err:
            raise RuntimeError(f"{name}: {lib.nis_error_string(err).decode()}")
        return out

    return (lambda: call("recentre_spectra_launch",
                         (spec, *tr, *tabs),
                         (num_p, d, nfft, p0, p1, *ring)),
            lambda: call("recenter_presum_launch",
                         (rc, filt, *tr, *tabs),
                         (num_p, ns, d, nfft, p0, p1)))


def report(name: str, ts: np.ndarray) -> int:
    """Print a kernel's block times and phase cycles; return the most
    blocks resident at once."""
    k = int(ts[:, 61].max())
    cyc = np.diff(ts[:, 1:k + 1], axis=1).mean(axis=0)
    g0, g1, sm = ts[:, 0], ts[:, 63], ts[:, 62]
    events = sorted([(a, 1) for a in g0] + [(b, -1) for b in g1])
    live = most = 0
    for _, e in events:
        live += e
        most = max(most, live)
    gaps = []
    for s in np.unique(sm):
        i = np.where(sm == s)[0]
        o = np.argsort(g0[i])
        gaps += list((g0[i][o][1:] - g1[i][o][:-1]) / 1e3)
    dur = (g1 - g0) / 1e3
    print(f"{name}: {len(ts)} blocks on {len(np.unique(sm))} SMs, span "
          f"{(g1.max() - g0.min()) / 1e3:.1f} us; block {dur.mean():.2f} us "
          f"mean; at most {most} blocks at once; gap between blocks on an "
          f"SM {np.median(gaps):.2f} us median")
    print("  phase cycles: " + " ".join(f"{c:.0f}" for c in cyc))
    return most


def named_phases(ts: np.ndarray, per_pulse, d: int) -> None:
    """A recentre kernel's phase cycles by name: each per-pulse phase the
    mean over the group's d pulses, then the group's inverse (blocks of
    whole groups only)."""
    k = int(ts[:, 61].max())
    full = ts[ts[:, 61] == k]
    cyc = np.diff(full[:, 1:k + 1], axis=1).mean(axis=0)
    n = len(per_pulse)
    if len(cyc) != n * d + len(INVERSE_PHASES):
        raise RuntimeError(f"{len(cyc)} phases, expected "
                           f"{n * d + len(INVERSE_PHASES)}")
    pulse = cyc[:n * d].reshape(d, n).mean(axis=0)
    print("  a pulse: " + "; ".join(f"{a} {c:.0f}" for a, c in
                                    zip(per_pulse, pulse))
          + f" (sum {pulse.sum():.0f}); the group's inverse: "
          + "; ".join(f"{a} {c:.0f}" for a, c in
                      zip(INVERSE_PHASES, cyc[n * d:]))
          + f" (sum {cyc[n * d:].sum():.0f}); a block {cyc.sum():.0f} "
          "cycles")


def phases(lib, runs) -> dict:
    """Run each (name, fn) of ``runs`` twice on the marked library ``lib``
    and report the second launch's blocks; name -> (blocks recorded, most
    at once, the blocks' records)."""
    package = _build.library
    _build.library = lambda: lib          # the wrappers launch the copy
    buf = np.zeros(MAX_BLOCKS * 64, np.uint64)
    seen = {}
    try:
        for name, fn in runs:
            fn()
            torch.cuda.synchronize()
            if lib.reset_phase_times() != 0:
                raise RuntimeError("clearing the phase times failed")
            fn()
            torch.cuda.synchronize()
            if lib.get_phase_times(buf.ctypes.data) != 0:
                raise RuntimeError("reading the phase times failed")
            ts = buf.reshape(MAX_BLOCKS, 64).astype(np.int64)
            ts = ts[ts[:, 63] != 0]           # the blocks this launch ran
            seen[name] = (len(ts), report(name, ts), ts)
    finally:
        _build.library = package
    return seen


def through(lib, fn):
    """``fn`` with the package's wrappers launching ``lib`` (None: the
    package's own build)."""
    if lib is None:
        return fn

    def run(*a, **k):
        package = _build.library
        _build.library = lambda: lib
        try:
            return fn(*a, **k)
        finally:
            _build.library = package
    return run


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_fft_phases: needs a CUDA device")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of another commit whose "
                    "forward spectra and recentre kernels to time beside")
    parent = ap.parse_args().parent
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    libs = build(parent)
    src = (_build.SOURCE_DIR / "fft_kernel.cu").read_text()
    parent_src = None if parent is None else (
        Path(parent) / _build.SOURCE_DIR.relative_to(ROOT)
        / "fft_kernel.cu").read_text()
    variants = [v for v in VARIANTS if v in libs]
    forward_variants = [v for v in variants if v not in RECENTRE_VARIANTS]
    dev = torch.device("cuda", 0)
    sc, opts, _, p, d, traj, plan = chip_smoke.videosar_setup()
    cpi, ns = sc.video.cpi_pulses(sc.radar.prf_hz), opts.num_samples
    step = sc.video.step_pulses(sc.radar.prf_hz)
    rows = bp_fast.band_rows(plan)
    gen = torch.Generator(device=dev).manual_seed(1)
    rc = torch.complex(torch.randn((cpi, ns), generator=gen, device=dev),
                       torch.randn((cpi, ns), generator=gen, device=dev))
    seg = rc[:step].contiguous()
    tr = [torch.as_tensor(a[:cpi], device=dev) for a in
          (traj.positions, traj.velocities, traj.times)]
    vf = torch.tensor([10.6, 10.6, 0.0], dtype=torch.float64, device=dev)
    args = (*tr, vf, p, d, plan.t_ref)
    spec = fft_kernel.forward_spectra(rc, p)
    forward = [("forward_spectra", lambda: fft_kernel.forward_spectra(rc, p)),
               (f"forward_spectra {step} pulses",
                lambda: fft_kernel.forward_spectra(seg, p))]
    recentre = {
        "recentre_from_spectra": lambda: fft_kernel.recentre_from_spectra(
            spec, *args, out_rows=rows)[0],
        "recenter_presum": lambda: fft_kernel.recenter_presum(
            rc, *args, out_rows=rows)[0]}
    named = {"recentre_from_spectra": SPECTRA_PHASES,
             "recenter_presum": FUSED_PHASES}
    # the 500-pulse launch's whole waves for each build: the clusters
    # resident at once, and the most pulses they take in whole waves
    waves = {}
    for build_name, lib, runs in (
            ("this tree", libs["marked"], forward + list(recentre.items())),
            *((v, libs[f"marked {v}"],
               list(recentre.items()) if v in RECENTRE_VARIANTS else forward)
              for v in variants if f"marked {v}" in libs)):
        print(f"[phases] {build_name}")
        seen = phases(lib, runs)
        for name, (_, _, ts) in seen.items():
            if name in named:
                named_phases(ts, named[name], d)
        if forward[1][0] in seen:
            blocks, at_once, _ = seen[forward[1][0]]
            clusters = at_once // (blocks // step)
            waves[build_name] = (clusters, clusters * (step // clusters))
    if "parent marked" in libs:
        print(f"[phases] parent {parent} (the first recentre design)")
        lib = libs["parent marked"]
        split, fused = launchers(lib, parent_src, rc, spec, args, rows)
        phases(lib, [("recentre_from_spectra", split),
                     ("recenter_presum", fused)])

    builds = [("this tree", None)] + [(v, libs[v]) for v in forward_variants]
    for x in (rc, seg):
        n_p = x.shape[0]
        want = fft_kernel.forward_spectra_plain(x, p)
        bound = 8.0 * n_p * (ns + plan.nfft) / HBM_BYTES_PER_S * 1e3
        lib_ms = median_ms(lambda: torch.fft.fft(x, n=plan.nfft, dim=-1),
                           reps=20)
        runs = [(name, functools.partial(
            through(lib, fft_kernel.forward_spectra), x, p))
            for name, lib in builds]
        if "parent" in libs:
            natural = "kFwdPitch" in (
                Path(parent) / _build.SOURCE_DIR.relative_to(ROOT)
                / "fft_kernel.cu").read_text()
            runs.append((f"parent {parent}",
                         parent_forward(libs["parent"], natural, x, p)))
        line = []
        for name, fn in runs:
            got = fn()
            err = float((got - want).abs().max() / want.abs().max())
            if err > 1e-4:
                raise RuntimeError(f"{name} at {n_p} pulses: rel err {err}")
            ms = median_ms(fn, reps=20)
            line.append(f"{name} {ms:.4f} ms ({ms / lib_ms:.2f}x the "
                        f"library, {bound / ms:.1%} of the bound, rel err "
                        f"{err:.2e})")
        print(f"[time] {n_p} pulses: " + "; ".join(line) + f"; torch.fft.fft "
              f"{lib_ms:.4f} ms; byte bound {bound:.4f} ms")

    # the recentre kernels: this tree's wrappers and launchers, the
    # recentre variants through the wrappers, DIR's launchers
    n_out, band = -(-cpi // d), (rows[1] - rows[0]) * 128
    n_bytes = {"recentre_from_spectra": 8.0 * (cpi * plan.nfft + n_out * band),
               "recenter_presum": 8.0 * (cpi * ns + n_out * band)}
    here = dict(zip(recentre, launchers(_build.library(), src, rc, spec,
                                        args, rows)))
    there = {}
    if "parent" in libs:
        there = dict(zip(recentre, launchers(
            libs["parent"], parent_src, rc, spec, args, rows)))
    for name, fn in recentre.items():
        want = (fft_kernel.recentre_from_spectra_plain(spec, *args,
                                                       out_rows=rows)[0]
                if name == "recentre_from_spectra" else
                fft_kernel.recenter_presum_plain(rc, *args,
                                                 out_rows=rows)[0])
        bound = n_bytes[name] / HBM_BYTES_PER_S * 1e3
        runs = [("this tree", fn), ("this tree's launcher", here[name])]
        runs += [(f"{v}'s launcher", dict(zip(recentre, launchers(
            libs[v], src, rc, spec, args, rows)))[name])
            for v in RECENTRE_VARIANTS if v in libs]
        if name in there:
            runs.append((f"parent {parent}'s launcher", there[name]))
        line = []
        for run_name, run in runs:
            got = run()
            err = float((got - want).abs().max() / want.abs().max())
            if err > 1e-4:
                raise RuntimeError(f"{run_name} {name}: rel err {err}")
            ms = median_ms(run, reps=20)
            line.append(f"{run_name} {ms:.4f} ms ({bound / ms:.1%} of the "
                        f"bound, rel err {err:.2e})")
        print(f"[time] {name}: " + "; ".join(line) + f"; byte bound "
              f"{bound:.4f} ms ({n_bytes[name] / 1e6:.0f} MB)")
    del spec

    for name, lib in builds:
        if name not in waves:
            continue
        fn = functools.partial(through(lib, fft_kernel.forward_spectra),
                               p=p)
        clusters, full = waves[name]
        whole = rc[:full].contiguous()
        seg_ms = median_ms(lambda: fn(seg), reps=20)
        whole_ms = median_ms(lambda: fn(whole), reps=20)
        print(f"[tail] {name}: {clusters} clusters at once; {step} pulses "
              f"{seg_ms:.4f} ms; {full} pulses (whole waves) {whole_ms:.4f} "
              f"ms, {whole_ms * step / full:.4f} ms scaled to {step}; the "
              f"partial wave costs {seg_ms - whole_ms * step / full:.4f} ms")


if __name__ == "__main__":
    main()
