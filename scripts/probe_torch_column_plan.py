#!/usr/bin/env python3
"""The K3 / K3g column pass at the slice's 4096 x 4096 under each launch
plan the kernels are built for, and under variants of its source.

    python3 scripts/probe_torch_column_plan.py [--parent DIR]   # on a GPU


Builds ``csrc/gmti_kernel.cu`` as it is and each variant of VARIANTS (a
copy with the listed text replaced), each with the extra launch splits of
EXTRA_SPLITS added to its dispatch, into its own library under
``build/probe_column/``, all nvcc processes at once, and prints what ptxas
reports for the column kernels of each (registers, stack, spills). Then,
for each library and each plan (columns a tile, blocks a cluster) of K3 and
of K3g: the error against the plain version (<= 1e-4 of the peak, else it
fails), K3's bits against K3g's s1 under the same cluster, and the time
(CUDA events, median of 20 after a warm-up) beside ``torch.fft.ifft`` over
the azimuth axis and the byte bound. With ``--parent DIR`` (a checkout of
an earlier commit of the port, whose one-column K3 / K3g launchers take no
plan), it also builds DIR's gmti_kernel.cu and times its K3 and K3g on the
same inputs. The card's name and power limit head the output. The
wrappers' launch counters do not move. Imports neither JAX nor the JAX
package.
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

from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    _build, csa_kernel, gmti_kernel)
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import (  # noqa: E402
    median_ms)

N = 4096
H_OUT, H_IN = 10, 2
# (cols, cluster) of each plan timed; a cluster of 8 splits 4096 rows as
# 8 x 32 x 16 (column_plan's), one of 4 as 4 x 32 x 32
K3_PLANS = [(8, 4), (16, 4), (8, 8), (16, 8), (32, 8)]
K3G_PLANS = [(8, 4), (8, 8), (16, 8)]
# the package's build holds one split per n_az (column_plan's); every copy
# built here also gets the cluster-of-4 split of 4096 rows timed against it
EXTRA_SPLITS = [
    ("    case 4096 * 16 + 8: return f.template run<8, 32, 16>();\n",
     "    case 4096 * 16 + 8: return f.template run<8, 32, 16>();\n"
     "    case 4096 * 16 + 4: return f.template run<4, 32, 32>();\n")]
HBM_BYTES_PER_S = 3.35e12
OUT = ROOT / "build" / "probe_column"
# name -> (text, replacement) pairs applied to a copy of gmti_kernel.cu
# "diag:" variants change what the kernel computes, to time a part alone:
# their errors are printed, not checked
VARIANTS = {
    "as is": [],
    "diag: box sums not stored": [("    cso[idx] = w.x;\n    csi[idx] = w.y;",
                                   "    if (w.x < 0.0f) cso[idx] = w.y;")],
    "diag: box sums not summed": [
        ("    const float2 w = column_windows<CS, QA, QB>(pcol, row, k1, jj, "
         "c,\n                                                h_out, h_in, "
         "t);",
         "    const float2 w = make_float2(pcol[pslot<J>(k1, jj, c, t)], "
         "0.0f);")],
    "no register cap": [("__launch_bounds__(kColThreads, 2)",
                         "__launch_bounds__(kColThreads)")],
    "3 blocks/SM": [("__launch_bounds__(kColThreads, 2)",
                     "__launch_bounds__(kColThreads, 3)")],
    "gather x1": [("#pragma unroll 2\n  for (int task = threadIdx.x; "
                   "task < (J << t.log2cols);",
                   "  for (int task = threadIdx.x; "
                   "task < (J << t.log2cols);")],
}

# the "phase marks" build: thread 0 of each block records clock64() at each
# phase boundary of the column pass (the marks cost a few cycles each)
MARKS_HEADER = r"""
__device__ unsigned long long g_marks[1 << 16][12];
__device__ __forceinline__ void nis_mark(int i) {
  if (threadIdx.x == 0 && blockIdx.x < (1 << 16))
    g_marks[blockIdx.x][i] = clock64();
}
extern "C" int probe_read_marks(unsigned long long* host, int blocks) {
  return (int)cudaMemcpyFromSymbol(host, g_marks, (size_t)blocks * 96);
}
"""
MARKS = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n" + MARKS_HEADER),
    ("  pass_a<NCH, CS, QA, QB>(",
     "  nis_mark(0);\n  pass_a<NCH, CS, QA, QB>("),
    ("  __syncthreads();\n  pass_b<CS, QA, QB>(y, tw, t);\n",
     "  nis_mark(1);\n  __syncthreads();\n  nis_mark(2);\n"
     "  pass_b<CS, QA, QB>(y, tw, t);\n"),
    ("pass_b<CS, QA, QB>(y + ysz, tw, t);\n  cluster_barrier<CS>();\n}",
     "pass_b<CS, QA, QB>(y + ysz, tw, t);\n  nis_mark(3);\n"
     "  cluster_barrier<CS>();\n  nis_mark(4);\n}"),
    ("        si[idx] = v.y;\n      });\n  cluster_barrier<CS>();\n}",
     "        si[idx] = v.y;\n      });\n  nis_mark(5);\n"
     "  cluster_barrier<CS>();\n  nis_mark(6);\n}"),
    ("  red[threadIdx.x] = m;\n  __syncthreads();",
     "  nis_mark(5);\n  red[threadIdx.x] = m;\n  __syncthreads();"),
    ("  cluster_barrier<CS>();   // every block's pcol and column maxima",
     "  nis_mark(6);\n  cluster_barrier<CS>();\n  nis_mark(7);   // every "
     "block's pcol and column maxima"),
    ("  // with both windows inside the halo",
     "  nis_mark(8);\n  // with both windows inside the halo"),
    ("    __syncthreads();\n#pragma unroll 2\n",
     "    __syncthreads();\n  nis_mark(9);\n#pragma unroll 2\n"),
    ("  if (!local) cluster_barrier<CS>();",
     "  nis_mark(10);\n  if (!local) cluster_barrier<CS>();"),
]
PHASES = {"k3": ["pass A (loads, DFT)", "block barrier", "pass B",
                 "cluster barrier", "gather + stores", "final barrier"],
          "k3g": ["pass A (loads, DFT)", "block barrier", "pass B x2",
                  "cluster barrier", "gather + products + stores",
                  "column maxima", "cluster barrier", "peaks + halo copy",
                  "cluster barrier", "box sums + stores"]}


def build_variants(parent) -> dict:
    """{name: ctypes library} of each variant (and "parent", the parent
    checkout's source, where given), with ptxas's report of their column
    kernels printed."""
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    shutil.copy(_build.SOURCE_DIR / "fft_smem.cuh", OUT)
    base = (_build.SOURCE_DIR / "gmti_kernel.cu").read_text()
    sources = {}
    for name, subs in {**VARIANTS, "phase marks": MARKS}.items():
        text = base
        for old, new in EXTRA_SPLITS + subs:
            assert old in text, (name, old)
            text = text.replace(old, new)
        sources[name] = (OUT, text)
    if parent is not None:            # with its own header beside it
        csrc = Path(parent) / _build.SOURCE_DIR.relative_to(ROOT)
        (OUT / "parent").mkdir()
        shutil.copy(csrc / "fft_smem.cuh", OUT / "parent")
        sources["parent"] = (OUT / "parent",
                             (csrc / "gmti_kernel.cu").read_text())
    jobs = {}
    for i, (name, (where, text)) in enumerate(sources.items()):
        src = where / f"v{i}.cu"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(OUT / f"v{i}.so"), str(src)]
        jobs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (i, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lines = err.splitlines()
        for k, line in enumerate(lines):
            if "Compiling entry function" in line and "k3" in line:
                m = re.search(r"(k3g?)_kernel(ILi(\d+)ELi(\d+)ELi(\d+))?",
                              line)
                kern = m.group(1) + ("<{},{},{}>".format(*m.groups()[2:])
                                     if m.group(2) else "")
                info = " ".join(ln.split(":", 1)[-1].strip()
                                for ln in lines[k + 1:k + 4]
                                if "Compiling" not in ln)
                print(f"[ptxas] {name}: {kern}: {info}")
        libs[name] = ctypes.CDLL(str(OUT / f"v{i}.so"))
    return libs


def call(lib, name, tensors, ints) -> None:
    """C launcher ``name`` of ``lib`` on the tensors and ints, on the
    current stream; raises on a CUDA error."""
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * (len(tensors) + 1 + len(ints)))
    fn.argtypes[len(tensors):-1] = [ctypes.c_int] * len(ints)
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in tensors), *ints,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


def phase_report(lib, name, launch, blocks) -> None:
    """Mean SM cycles of each phase of the column kernel `name` over the
    blocks of one launch (thread 0's marks)."""
    launch()
    torch.cuda.synchronize()
    marks = np.zeros((blocks, 12), np.uint64)
    fn = lib.probe_read_marks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    assert fn(marks.ctypes.data, blocks) == 0
    n = len(PHASES[name])
    d = np.diff(marks[:, :n + 1].astype(np.int64), axis=1).mean(axis=0)
    print(f"[phases] {name}: {blocks} blocks, mean block "
          f"{float(d.sum()):.0f} cycles: " + "; ".join(
              f"{p} {v:.0f}" for p, v in zip(PHASES[name], d)))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_column_plan: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of an earlier commit whose "
                    "K3 / K3g to time beside")
    parent = ap.parse_args().parent
    libs = build_variants(parent)
    rng = np.random.default_rng(0)
    x = [torch.from_numpy(rng.standard_normal((N, N), dtype=np.float32)
                          ).to(dev) for _ in range(4)]
    tw = csa_kernel.twiddle_table(N, dev)
    cal_cs = torch.tensor([np.cos(0.4), np.sin(0.4)], dtype=torch.float32,
                          device=dev)
    plane = 4.0 * N * N
    want3 = csa_kernel.k3_plain(x[0], x[1])
    want3g = gmti_kernel.k3_gmti_plain(*x, cal_cs, h_out=H_OUT, h_in=H_IN)
    xc = torch.complex(x[0], x[1])
    lib_ms = median_ms(lambda: torch.fft.ifft(xc, dim=0), reps=20)
    bound3, bound3g = 4 * plane / HBM_BYTES_PER_S * 1e3, \
        13 * plane / HBM_BYTES_PER_S * 1e3
    print(f"[plan] column_plan: K3 {csa_kernel.column_plan(N, N, 1)[:2]}, "
          f"K3g {csa_kernel.column_plan(N, N, 2)[:2]} (cols, cluster); "
          f"torch.fft.ifft(dim=0) {lib_ms:.4f} ms; bounds K3 {bound3:.4f} "
          f"ms, K3g {bound3g:.4f} ms")
    marks = libs.pop("phase marks")
    if parent is not None:
        old = libs.pop("parent")
        o3 = [torch.empty_like(x[0]) for _ in range(2)]
        o3g = [torch.empty_like(x[0]) for _ in range(9)] + [
            torch.empty(N, device=dev)]
        ms3 = median_ms(lambda: call(old, "k3_launch", (x[0], x[1], tw, *o3),
                                     (N, N)), reps=20)
        err3 = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(o3, want3))
        ms3g = median_ms(lambda: call(old, "k3g_launch",
                                      (*x, cal_cs, tw, *o3g),
                                      (N, N, H_OUT, H_IN)), reps=20)
        err3g = max(float((a - b).abs().max() / b.abs().max())
                    for i, (a, b) in enumerate(zip(o3g, want3g)) if i != 4)
        print(f"[parent] K3 {ms3:.4f} ms (rel err {err3:.2e}, "
              f"{ms3 / lib_ms:.2f}x torch.fft.ifft, {bound3 / ms3:.1%} of "
              f"the byte bound); K3g {ms3g:.4f} ms (rel err {err3g:.2e}, "
              f"{bound3g / ms3g:.1%})")
    p3, p3g = csa_kernel.column_plan(N, N, 1), csa_kernel.column_plan(N, N, 2)
    o3 = [torch.empty_like(x[0]) for _ in range(2)]
    o3g = [torch.empty_like(x[0]) for _ in range(9)] + [
        torch.empty(N, device=dev)]
    phase_report(marks, "k3", lambda: call(
        marks, "k3_launch", (x[0], x[1], tw, *o3), (N, N, *p3)),
        N // p3.cols * p3.cluster)
    phase_report(marks, "k3g", lambda: call(
        marks, "k3g_launch", (*x, cal_cs, tw, *o3g),
        (N, N, H_OUT, H_IN, *p3g)), N // p3g.cols * p3g.cluster)
    for name, lib in libs.items():
        def k3(cols, cluster, out):
            smem = csa_kernel.column_smem(N, cols, cluster, 1)
            call(lib, "k3_launch", (x[0], x[1], tw, *out),
                 (N, N, cols, cluster, smem))

        def k3g(cols, cluster, out):
            smem = csa_kernel.column_smem(N, cols, cluster, 2)
            call(lib, "k3g_launch", (*x, cal_cs, tw, *out),
                 (N, N, H_OUT, H_IN, cols, cluster, smem))

        s1 = {}
        for cols, cluster in K3G_PLANS:
            out = [torch.empty_like(x[0]) for _ in range(9)] + [
                torch.empty(N, device=dev)]
            k3g(cols, cluster, out)
            err = max(float((a - b).abs().max() / b.abs().max())
                      for i, (a, b) in enumerate(zip(out, want3g)) if i != 4)
            assert err <= 1e-4 or name.startswith("diag"), (name, cols,
                                                            cluster, err)
            s1[cluster] = out[:2]
            ms = median_ms(lambda: k3g(cols, cluster, out), reps=20)
            print(f"[K3g] {name}: cols {cols:2d} cluster {cluster}: rel err "
                  f"{err:.2e}; {ms:.4f} ms, {bound3g / ms:.1%} of the byte "
                  "bound")
        for cols, cluster in K3_PLANS if not name.startswith("diag") else ():
            out = [torch.empty_like(x[0]) for _ in range(2)]
            k3(cols, cluster, out)
            err = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(out, want3))
            assert err <= 1e-4, (name, cols, cluster, err)
            same = all(torch.equal(a, b) for a, b in zip(out, s1[cluster]))
            ms = median_ms(lambda: k3(cols, cluster, out), reps=20)
            print(f"[K3] {name}: cols {cols:2d} cluster {cluster}: rel err "
                  f"{err:.2e}; K3g's s1 bit for bit: {same}; {ms:.4f} ms, "
                  f"{ms / lib_ms:.2f}x torch.fft.ifft, {bound3 / ms:.1%} of "
                  "the byte bound")


if __name__ == "__main__":
    main()
