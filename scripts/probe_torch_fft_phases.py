#!/usr/bin/env python3
"""Where the time goes inside the port's recentre kernels, phase by phase.

    python3 scripts/probe_torch_fft_phases.py      # on a GPU, repo root

Builds a copy of ``nis_sar_amtigmti_video_tpu_torch/csrc/fft_kernel.cu``
under ``build/probe_fft_phases/`` in which thread 0 of every block records
``clock64()`` after each phase (and ``%globaltimer`` and the SM id at its
start and end), runs forward spectra, recentre from spectra and the fused
recentre + presum once each at the VideoSAR reference shape (P 2,500 x
ns 22,004, nfft 32,768, presum 4, band rows 82-97), and prints per kernel:
the span, the mean block time, the most blocks resident at once, the idle
gap between blocks on an SM, and the mean SM cycles of each phase. The
phases follow the kernel source: per pulse, column load and FFT / cluster
barrier / DSMEM scatter / cluster barrier / row FFT / output (forward) or
ramp and accumulate; per group, the inverse row FFT / twiddle / cluster
barrier / DSMEM gather and column FFT / band store and final barrier.
Imports neither JAX nor the JAX package. Each mark costs a few cycles.
"""

from __future__ import annotations

import ctypes
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
MARKS = [
    ("namespace {\n", HEADER, 1),
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  ts_reset();\n", 4),
    ("  columns_forward(load, c0, col, t, s);\n", "  ts_mark();\n", 1),
    ("  cluster.sync();\n", "  ts_mark();\n", 4),
    ("  scatter_columns(cluster, col, y, c0, t, s);\n", "  ts_mark();\n", 1),
    ("  block_fft_dif(y, 7, 128, t.tw_128, false);\n", "  ts_mark();\n", 1),
    ("        acc[l] = first ? r : cadd(acc[l], r);\n      });\n",
     "  ts_mark();\n", 1),
    ("  block_fft_dit(acc, 7, 128, t.tw_128, true);\n", "  ts_mark();\n", 1),
    ("      [&](int l, float2 v) { acc[l] = v; });\n", "  ts_mark();\n", 1),
    ("  block_fft_dif(col, s.log2b1, s.b1 + 1, t.tw_b1, true);\n",
     "  ts_mark();\n", 1),
    ("             [&](int l, float2 v) { o[row_natural(l)] = v; });\n",
     "  ts_mark();\n  ts_end();\n", 1),
    ("  group_inverse(cluster, acc, col, out + (size_t)g * (p1 - p0) * 128, "
     "p0, p1,\n                t, s);\n", "  ts_end();\n", 2),
]


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    for f in _build.SOURCE_DIR.glob("*.cu*"):
        shutil.copy(f, OUT)
    src = (OUT / "fft_kernel.cu").read_text()
    for anchor, text, count in MARKS:
        if src.count(anchor) != count:
            raise RuntimeError(f"anchor found {src.count(anchor)} times, "
                               f"expected {count}: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    src += ('extern "C" int get_phase_times(void* dst) {\n'
            "  return (int)cudaMemcpyFromSymbol(dst, g_ts, sizeof(g_ts));\n"
            "}\n")
    (OUT / "fft_kernel.cu").write_text(src)
    lib = OUT / "libprobe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    *map(str, sorted(OUT.glob("*.cu")))], check=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.get_phase_times.argtypes = [ctypes.c_void_p]
    cdll.nis_error_string.argtypes = [ctypes.c_int]
    cdll.nis_error_string.restype = ctypes.c_char_p
    return cdll


def report(name: str, ts: np.ndarray) -> None:
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_fft_phases: needs a CUDA device")
    lib = build()
    _build.library = lambda: lib         # the wrappers launch the probe copy
    dev = torch.device("cuda", 0)
    sc, opts, _, p, d, traj, plan = chip_smoke.videosar_setup()
    cpi, ns = sc.video.cpi_pulses(sc.radar.prf_hz), opts.num_samples
    rows = bp_fast.band_rows(plan)
    gen = torch.Generator(device=dev).manual_seed(1)
    rc = torch.complex(torch.randn((cpi, ns), generator=gen, device=dev),
                       torch.randn((cpi, ns), generator=gen, device=dev))
    tr = [torch.as_tensor(a[:cpi], device=dev) for a in
          (traj.positions, traj.velocities, traj.times)]
    vf = torch.tensor([10.6, 10.6, 0.0], dtype=torch.float64, device=dev)
    args = (*tr, vf, p, d, plan.t_ref)
    spec = fft_kernel.forward_spectra(rc, p)
    cs = plan.nfft // 128 // 64
    buf = np.zeros(MAX_BLOCKS * 64, np.uint64)
    for name, fn, blocks in (
            ("forward_spectra", lambda: fft_kernel.forward_spectra(rc, p),
             cpi * cs),
            ("recentre_from_spectra",
             lambda: fft_kernel.recentre_from_spectra(spec, *args,
                                                      out_rows=rows),
             -(-cpi // d) * cs),
            ("recenter_presum",
             lambda: fft_kernel.recenter_presum(rc, *args, out_rows=rows),
             -(-cpi // d) * cs)):
        fn()
        fn()
        torch.cuda.synchronize(dev)
        if lib.get_phase_times(buf.ctypes.data) != 0:
            raise RuntimeError("reading the phase times failed")
        report(name, buf.reshape(MAX_BLOCKS, 64)[:min(blocks, MAX_BLOCKS)]
               .astype(np.int64))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
