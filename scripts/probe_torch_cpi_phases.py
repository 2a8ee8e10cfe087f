#!/usr/bin/env python3
"""Where the time goes inside the chirp-z column kernels (K1g, K1, K3g, K3).

    python3 scripts/probe_torch_cpi_phases.py [--n 7193] [--n-rg 13200]

(GPU, from the repo root.) Builds copies of
``nis_sar_amtigmti_video_tpu_torch/csrc/gmti_kernel.cu`` under
``build/probe_cpi_phases/``, all nvcc processes at once, and prints what
ptxas reports (registers, spills) for the chirp-z instantiations at
16,384 points:

- "marked": thread 0 of every block sums ``clock64()`` deltas by phase,
  each mark set just after a barrier, so a phase ends when the block's (or
  the cluster's) last thread is done with it: the forward passes A and B
  (the chirped rows' loads), the forward gather (DSMEM, x H, held in
  registers), the wait at the cluster barrier, the write-back to the
  block's own slots, the inverse passes A and B, the inverse gather with
  the kernel's stores, and the rest (K1g's column sums; K3g's peaks, halo
  and box sums). Printed as SM cycles a block, beside the clusters the
  card holds at once (``cudaOccupancyMaxActiveClusters``). The marks
  change the code ptxas makes (at 7,199 x 13,200 the marked K1g ran 14 %
  slower than this tree's, K1 28 % faster), so read the phases as shares.
- ``VARIANTS``, text substitutions on copies that change the result to
  time one part.

Then it times each build's four wrappers at (n, n_rg) (CUDA events, median
of 5 after a warm-up) through the package's wrappers with the build's
library in place of the package's. The card's name and power limit head
the output. Imports neither JAX nor the JAX package. The anchors below
must match the source exactly.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from nis_sar_amtigmti_video_tpu_torch.ops import csa  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    _build, csa_kernel, gmti_kernel)
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import (  # noqa: E402
    median_ms)

OUT = ROOT / "build" / "probe_cpi_phases"
SRC = ROOT / "nis_sar_amtigmti_video_tpu_torch" / "csrc"
PROBE = r"""
__device__ unsigned long long g_cpi[16];
__shared__ unsigned long long cpi_last;
#define CPI_START                                                         \
  if (threadIdx.x == 0) cpi_last = clock64();
#define CPI_MARK(i)                                                       \
  if (threadIdx.x == 0) {                                                 \
    const unsigned long long c_ = clock64();                              \
    atomicAdd(&g_cpi[i], c_ - cpi_last);                                  \
    cpi_last = c_;                                                        \
  }
#define CPI_END(i)                                                        \
  CPI_MARK(i)                                                             \
  if (threadIdx.x == 0) atomicAdd(&g_cpi[15], 1ull);
"""
PHASES = ("forward passes A, B (loads)", "forward gather, x H, held",
          "cluster barrier", "write-back to own slots",
          "inverse passes A, B", "inverse gather, stores",
          "rest (sums; peaks, halo, box sums)")
MARKS = [
    ('#include "fft_smem.cuh"\n', '#include "fft_smem.cuh"\n' + PROBE),
    ("  const Tile t = tile_of<CS>(n_rg, log2cols);\n",
     "  const Tile t = tile_of<CS>(n_rg, log2cols);\n  CPI_START\n"),
    ("                                                  tw, t, chirp, "
     "n_valid);\n  float2 v[T][NCH][CS];\n",
     "                                                  tw, t, chirp, "
     "n_valid);\n  CPI_MARK(0)\n  float2 v[T][NCH][CS];\n"),
    ("  cluster_barrier<CS>();   // no block reads another's Y after this\n",
     "  CPI_MARK(1)\n  cluster_barrier<CS>();\n  CPI_MARK(2)\n"),
    ("  __syncthreads();\n  column_passes<true, NCH, CS, QA, QB, kHeld>("
     "nullptr, nullptr, nullptr,\n                                         "
     "     nullptr, y, ysz, tw, t);\n}\n",
     "  __syncthreads();\n  CPI_MARK(3)\n  column_passes<true, NCH, CS, QA, "
     "QB, kHeld>(nullptr, nullptr, nullptr,\n                              "
     "                nullptr, y, ysz, tw, t);\n  CPI_MARK(4)\n}\n"),
    # K1 / K1g
    ("    column_gather<CZ, NCH, CS, QA, QB>(y, ysz, tw, t, emit);\n"
     "  if constexpr (SUMS) {\n",
     "    column_gather<CZ, NCH, CS, QA, QB>(y, ysz, tw, t, emit);\n"
     "  CPI_MARK(5)\n  if constexpr (SUMS) {\n"),
    ("      bal[n_rg + t.col0 + threadIdx.x] = balance ? si * inv_n : 0.0f;"
     "\n    }\n  }\n}\n",
     "      bal[n_rg + t.col0 + threadIdx.x] = balance ? si * inv_n : 0.0f;"
     "\n    }\n  }\n  CPI_END(6)\n}\n"),
    # K3
    ("    column_gather<true, 1, CS, QA, QB>(y, 0, tw, t, emit);\n"
     "  cluster_barrier<CS>();\n}\n",
     "    column_gather<true, 1, CS, QA, QB>(y, 0, tw, t, emit);\n"
     "  CPI_MARK(5)\n  cluster_barrier<CS>();\n  CPI_END(6)\n}\n"),
    # K3g
    ("    column_gather<true, 2, CS, QA, QB>(y, ysz, tw, t, emit);\n",
     "    column_gather<true, 2, CS, QA, QB>(y, ysz, tw, t, emit);\n"
     "  CPI_MARK(5)\n"),
    ("  if (!local) cluster_barrier<CS>();   // others read this pcol until "
     "then\n}\n",
     "  if (!local) cluster_barrier<CS>();\n  CPI_END(6)\n}\n"),
]
SHIM = r"""
extern "C" const char* nis_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
"""
READ = r"""
extern "C" int get_probe(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_cpi, sizeof(g_cpi));
}
extern "C" int reset_probe() {
  void* p;
  int err = (int)cudaGetSymbolAddress(&p, g_cpi);
  return err ? err : (int)cudaMemset(p, 0, sizeof(g_cpi));
}
template <typename K>
static int clusters(K kernel, int cs, int smem) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaFuncSetAttribute(kernel,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * 1024);
  cfg.blockDim = dim3(column_threads(cs, kChirpZ));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = -1;
  const int err = (int)cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err ? -err : n;
}
// the clusters of 16 blocks the card holds at once, at m = 16,384
extern "C" int active_clusters(int which, int smem) {
  switch (which) {
    case 0: return clusters(k1_kernel<2, 16, 32, 32, kChirpZ>, 16, smem);
    case 1: return clusters(k1_kernel<1, 16, 32, 32, kChirpZ>, 16, smem);
    case 2: return clusters(k3g_kernel<16, 32, 32, kChirpZ>, 16, smem);
    default: return clusters(k3_kernel<16, 32, 32, kChirpZ>, 16, smem);
  }
}
"""
# copies that change the result to time one part: the forward gather on
# contiguous rows (no 2-way bank conflicts, the wrong rows); K1's Phi1
# without its sincosf; K3g without its box sums or its atan2f
VARIANTS = {
    "contiguous gather": [(
        "    const int c = task % COLS, j = t.rank + CS * (task / COLS);\n",
        "    const int c = task % COLS, j = t.rank * J + task / COLS;\n")],
    "no Phi1 sincosf": [(
        "        sincosf(__ldg(c1 + row) * du * du, &sn, &cs);\n",
        "        sn = du;\n        cs = 1.0f;\n")],
    "K3g no box sums": [(
        "    const float2 w = column_windows<CS>(pcol, row, k1, jj, c, h_out, "
        "h_in,\n                                        t, nv, g);\n",
        "    const float2 w = make_float2(0.0f, 0.0f);\n")],
    "K3g no atan2f": [(
        "        ph[idx] = atan2f(pi * cr - pr * ci, pr * cr + pi * ci);\n",
        "        ph[idx] = pi * cr - pr * ci;\n")],
}
KERNELS = ("K1g", "K1", "K3g", "K3")


def substitute(text: str, pairs) -> str:
    for a, b in pairs:
        if text.count(a) < 1:
            raise SystemExit(f"anchor not found in gmti_kernel.cu:\n{a}")
        text = text.replace(a, b)
    return text


def build() -> dict:
    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    base = (SRC / "gmti_kernel.cu").read_text()
    texts = {"marked": substitute(base, MARKS) + READ}
    for name, pairs in VARIANTS.items():
        texts[name] = substitute(base, pairs)
    jobs = {}
    for name, text in texts.items():
        d = OUT / re.sub(r"\W+", "_", name)
        d.mkdir()
        shutil.copy(SRC / "fft_smem.cuh", d)
        (d / "k.cu").write_text(text + SHIM)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(d / "lib.so"), str(d / "k.cu")]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    libs = {}
    for name, (d, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log[-4000:]}")
        if name == "marked":
            for kernel, regs, spill in ptxas(log):
                print(f"[ptxas] {kernel}: {regs} registers, {spill}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.nis_error_string.argtypes = [ctypes.c_int]
        lib.nis_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def ptxas(log: str):
    """(kernel, registers, spills) of each chirp-z instantiation at m =
    16,384 in ptxas's -v output."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"(k1_kernel|k3g_kernel|k3_kernel)IL(.*?)EEEv",
                          m.group(1))
            args = re.findall(r"i(\d+)E", k.group(2) + "E") if k else []
            name = (f"{k.group(1)}<{', '.join(args)}>"
                    if k and args[-1] == "1" and "32, 32" in ", ".join(args)
                    else None)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = f"spills {m.group(1)} / {m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def inputs(dev, n_az, n_rg):
    f = csa.csa_factors(csa.CsaParams(
        wavelength_m=0.031, chirp_rate=120e6 / 2e-6, fs_hz=150e6,
        prf_hz=6000.0, velocity_mps=7600.0, range_ref_m=6e5,
        t_start_fast=2 * 6e5 / 299792458.0 - 2e-6, num_pulses=n_az,
        num_samples=n_rg), dev)
    rng = np.random.default_rng(0)
    x = [torch.from_numpy(rng.standard_normal((n_az, n_rg),
                                              dtype=np.float32)).to(dev)
         for _ in range(4)]
    return f, x


def calls(f, x, plan, dev):
    cal = torch.tensor([np.cos(0.4), np.sin(0.4)], dtype=torch.float32,
                       device=dev)
    return {
        "K1g": lambda: gmti_kernel.k1_gmti_planes(*x, f, plan=plan),
        "K1": lambda: csa_kernel.k1_call(x[0], x[1], f, plan=plan),
        "K3g": lambda: gmti_kernel.k3_gmti_planes(*x, cal, h_out=10,
                                                  h_in=2, plan=plan),
        "K3": lambda: csa_kernel.k3_call(x[0], x[1], plan=plan)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=7193)
    ap.add_argument("--n-rg", type=int, default=13200)
    a = ap.parse_args()
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(dev), subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    libs = build()
    f, x = inputs(dev, a.n, a.n_rg)
    plan = csa_kernel.azimuth_plan(a.n, dev)
    fns = calls(f, x, plan, dev)
    own = _build.library
    times = {}
    try:
        for name, lib in [("this tree", own())] + list(libs.items()):
            _build.library = lambda lib=lib: lib
            for k, fn in fns.items():
                fn()
                torch.cuda.synchronize()
                times[(name, k)] = median_ms(fn, reps=5)
            print(f"[time] {name}: " + ", ".join(
                f"{k} {times[(name, k)]:.3f} ms" for k in KERNELS))
        lib = libs["marked"]
        _build.library = lambda: lib
        lib.get_probe.argtypes = [ctypes.c_void_p]
        buf = np.zeros(16, np.uint64)
        for i, k in enumerate(KERNELS):
            plan_nch = (2, 1, 2, 1)[i]
            smem = csa_kernel.column_plan(a.n, a.n_rg, plan_nch,
                                          forward=i < 2).smem
            active = lib.active_clusters(i, smem)
            lib.reset_probe()
            fns[k]()
            torch.cuda.synchronize()
            lib.get_probe(buf.ctypes.data)
            blocks = int(buf[15])
            per = buf[:7].astype(np.float64) / max(blocks, 1)
            print(f"[phases] {k}: {blocks} blocks, {active} clusters at "
                  f"once, {per.sum():.0f} cycles a block: " + "; ".join(
                      f"{p} {c:.0f}" for p, c in zip(PHASES, per)))
    finally:
        _build.library = own


if __name__ == "__main__":
    main()
