#!/usr/bin/env python3
"""The column pass at the slice's 4096 x 4096, forward (K1 / K1g) and
inverse (K3 / K3g), under each launch plan the kernels are built for, and
under variants of its source.

    python3 scripts/probe_torch_column_plan.py [--parent DIR]   # on a GPU


Builds ``csrc/gmti_kernel.cu`` as it is and each variant of VARIANTS (a
copy with the listed text replaced), each with the extra launch splits of
EXTRA_SPLITS added to its dispatch, into its own library under
``build/probe_column/``, all nvcc processes at once, and prints what ptxas
reports for the column kernels of each (registers, stack, spills) and the
SM cycles of each phase of K1, K1g, K3 and K3g (thread 0's ``clock64()``
marks). Then, for each library and each plan (columns a tile, blocks a
cluster) of K1, K1g, K3 and K3g: the error against the plain version
(<= 1e-4 of the peak, else it fails), K1's bits against K1g's z1 and K3's
against K3g's s1 under the same cluster, and the time (CUDA events, median
of 20 after a warm-up) beside ``torch.fft.fft`` (K1, K1g: over one and over
both channels) or ``torch.fft.ifft`` over the azimuth axis and the byte
bound. With ``--parent DIR`` (a checkout of an earlier commit of the port
whose K3 / K3g launchers take the plan and whose one-column K1 / K1g
launchers take none), it also builds DIR's gmti_kernel.cu and times its
four column kernels on the same inputs. The card's name and power limit
head the output. The wrappers' launch counters do not move. Imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from nis_sar_amtigmti_video_tpu_torch import config  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops import csa  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    _build, csa_kernel, gmti_kernel)
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import (  # noqa: E402
    median_ms)

N = 4096
H_OUT, H_IN = 10, 2
# (cols, cluster) of each plan timed, of the one-channel kernels (K1, K3)
# and the two-channel ones (K1g, K3g); a cluster of 8 splits 4096 rows as
# 8 x 32 x 16 (column_plan's), one of 4 as 4 x 32 x 32
PLANS_1CH = [(8, 4), (16, 4), (8, 8), (16, 8), (32, 8)]
PLANS_2CH = [(8, 4), (8, 8), (16, 8)]
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
    "diag: Phi1 not evaluated": [
        ("        sincosf(__ldg(c1 + row) * du * du, &sn, &cs);\n",
         "        sn = du;\n        cs = 1.0f;\n")],
    "diag: fast sincos": [
        ("        sincosf(__ldg(c1 + row) * du * du, &sn, &cs);\n",
         "        __sincosf(__ldg(c1 + row) * du * du, &sn, &cs);\n")],
    "Phi1 sincosf out of line": [
        ("// K1 / K1g: the forward column DFT",
         "__device__ __noinline__ float2 cis_call(float x) {\n"
         "  float s, c;\n  sincosf(x, &s, &c);\n  return make_float2(c, s);\n"
         "}\n\n// K1 / K1g: the forward column DFT"),
        ("        float sn, cs;\n"
         "        sincosf(__ldg(c1 + row) * du * du, &sn, &cs);\n"
         "        const float2 phi = make_float2(cs, sn);\n",
         "        const float2 phi = cis_call(__ldg(c1 + row) * du * du);\n")],
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
    ("  pass_a<INV, NCH, CS, QA, QB>(",
     "  nis_mark(0);\n  pass_a<INV, NCH, CS, QA, QB>("),
    ("  __syncthreads();\n  pass_b<INV, CS, QA, QB>(y, tw, t);\n",
     "  nis_mark(1);\n  __syncthreads();\n  nis_mark(2);\n"
     "  pass_b<INV, CS, QA, QB>(y, tw, t);\n"),
    ("pass_b<INV, CS, QA, QB>(y + ysz, tw, t);\n  cluster_barrier<CS>();\n}",
     "pass_b<INV, CS, QA, QB>(y + ysz, tw, t);\n  nis_mark(3);\n"
     "  cluster_barrier<CS>();\n  nis_mark(4);\n}"),
    ("      });\n  if constexpr (NCH == 2) {\n    red[threadIdx.x] = s;",
     "      });\n  nis_mark(5);\n  if constexpr (NCH == 2) {\n"
     "    red[threadIdx.x] = s;"),
    ("  cluster_barrier<CS>();   // every gather and every block's sums",
     "  cluster_barrier<CS>();\n  nis_mark(6);   // every gather and every "
     "block's sums"),
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
PHASES = {"k1": ["pass A (loads, DFT)", "block barrier", "pass B",
                 "cluster barrier", "gather + Phi1 + stores",
                 "final barrier"],
          "k1g": ["pass A (loads, DFT)", "block barrier", "pass B x2",
                  "cluster barrier", "gather + Phi1 + stores + sums",
                  "column sums + final barrier"],
          "k3": ["pass A (loads, DFT)", "block barrier", "pass B",
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
            m = re.search(r"(k[13]g?)_kernelI?((?:Li\d+E)*)", line)
            if "Compiling entry function" in line and m:
                args = re.findall(r"Li(\d+)E", m.group(2))
                kern = m.group(1) + (f"<{','.join(args)}>" if args else "")
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


def slice_factors(dev):
    """The slice scenario's CSA factors at 4096 x 4096 (chip_smoke.py's
    GMTI kernel inputs: config.ati_dpca() at the 120 MHz waveform)."""
    sc = config.ati_dpca()
    r = dataclasses.replace(sc.radar, bandwidth_hz=120e6, pulse_width_s=2e-6,
                            fs_hz=150e6)
    g = sc.geometry
    return csa.csa_factors(csa.CsaParams(
        wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
        prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m,
        t_start_fast=2.0 * g.slant_range_m / 299792458.0
        - r.pulse_width_s / 2 - 1e-6, num_pulses=N, num_samples=N), dev)


def rel(got, want) -> float:
    """Largest error of the planes over the peak of each."""
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got, want))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_column_plan: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of an earlier commit whose "
                    "K1 / K1g / K3 / K3g to time beside")
    parent = ap.parse_args().parent
    libs = build_variants(parent)
    rng = np.random.default_rng(0)
    x = [torch.from_numpy(rng.standard_normal((N, N), dtype=np.float32)
                          ).to(dev) for _ in range(4)]
    f = slice_factors(dev)
    phi = (f.u, f.c1, f.w)
    tw = csa_kernel.twiddle_table(N, dev)
    cal_cs = torch.tensor([np.cos(0.4), np.sin(0.4)], dtype=torch.float32,
                          device=dev)
    plane = 4.0 * N * N
    want1 = csa_kernel.k1_plain(x[0], x[1], f)
    want1g = gmti_kernel.k1_gmti_plain(*x, f)
    want3 = csa_kernel.k3_plain(x[0], x[1])
    want3g = gmti_kernel.k3_gmti_plain(*x, cal_cs, h_out=H_OUT, h_in=H_IN)
    xc = torch.complex(x[0], x[1])
    xc2 = torch.stack([xc, torch.complex(x[2], x[3])])
    lib_ms = median_ms(lambda: torch.fft.ifft(xc, dim=0), reps=20)
    lib1_ms = median_ms(lambda: torch.fft.fft(xc, dim=0), reps=20)
    lib1g_ms = median_ms(lambda: torch.fft.fft(xc2, dim=1), reps=20)
    del xc, xc2
    bound = {k: planes * plane / HBM_BYTES_PER_S * 1e3
             for k, planes in (("K1", 4), ("K1g", 8), ("K3", 4), ("K3g", 13))}
    print(f"[plan] column_plan (cols, cluster): K1 "
          f"{csa_kernel.column_plan(N, N, 1, forward=True)[:2]}, K1g "
          f"{csa_kernel.column_plan(N, N, 2, forward=True)[:2]}, K3 "
          f"{csa_kernel.column_plan(N, N, 1)[:2]}, K3g "
          f"{csa_kernel.column_plan(N, N, 2)[:2]}; torch.fft.fft(dim=0) "
          f"{lib1_ms:.4f} ms, over 2 channels {lib1g_ms:.4f} ms, "
          f"torch.fft.ifft(dim=0) {lib_ms:.4f} ms; byte bounds "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in bound.items()))

    def outs(k):
        n = {"K1": 2, "K1g": 4, "K3": 2, "K3g": 9}[k]
        o = [torch.empty_like(x[0]) for _ in range(n)]
        if k == "K1g":
            o.append(torch.empty((2, N), device=dev))
        elif k == "K3g":
            o.append(torch.empty(N, device=dev))
        return o

    def launch(lib, k, out, plan=None):
        """Kernel k of `lib` into `out`, under `plan` (cols, cluster) or,
        when None, through the parent's launchers (K1 / K1g take none)."""
        if plan is not None:
            cols, cluster = plan
            plan = (cols, cluster, csa_kernel.column_smem(
                N, cols, cluster, 1 + k.endswith("g"), k.startswith("K1")))
        elif k in ("K3", "K3g"):
            plan = tuple(csa_kernel.column_plan(N, N, 1 + k.endswith("g")))
        plan = plan or ()
        if k == "K1":
            call(lib, "k1_launch", (x[0], x[1], *phi, tw, *out),
                 (N, N, *plan))
        elif k == "K1g":
            call(lib, "k1g_launch", (*x, *phi, tw, *out), (N, N, 1, *plan))
        elif k == "K3":
            call(lib, "k3_launch", (x[0], x[1], tw, *out), (N, N, *plan))
        else:
            call(lib, "k3g_launch", (*x, cal_cs, tw, *out),
                 (N, N, H_OUT, H_IN, *plan))

    def error(k, out):
        """Planes' error over the peak; K1g's balance sums' beside."""
        if k == "K1":
            return rel(out, want1)
        if k == "K1g":
            sums = torch.sum(out[4], dim=1)
            return max(rel(out[:4], want1g[:4]),
                       rel([sums], [torch.stack(want1g[4:])]))
        if k == "K3":
            return rel(out, want3)
        return rel([o for i, o in enumerate(out) if i != 4],
                   [w for i, w in enumerate(want3g) if i != 4])

    lib_of = {"K1": lib1_ms, "K1g": lib1g_ms, "K3": lib_ms}
    marks = libs.pop("phase marks")
    if parent is not None:
        old = libs.pop("parent")
        for k in ("K1", "K1g", "K3", "K3g"):
            out = outs(k)
            launch(old, k, out)
            err = error(k, out)
            ms = median_ms(lambda: launch(old, k, out), reps=20)
            vs = (f", {ms / lib_of[k]:.2f}x the library" if k in lib_of
                  else "")
            print(f"[parent] {k} {ms:.4f} ms (rel err {err:.2e}{vs}, "
                  f"{bound[k] / ms:.1%} of the byte bound)")
    for k in ("K1", "K1g", "K3", "K3g"):
        plan = csa_kernel.column_plan(N, N, 1 + k.endswith("g"),
                                      forward=k.startswith("K1"))
        phase_report(marks, k.lower(),
                     lambda: launch(marks, k, outs(k), plan[:2]),
                     N // plan.cols * plan.cluster)
    for name, lib in libs.items():
        diag = name.startswith("diag")
        kept = {}             # two-channel outputs by (kernel, cluster)
        for k, twin, plans in (("K3g", None, PLANS_2CH),
                               ("K3", "K3g", PLANS_1CH),
                               ("K1g", None, PLANS_2CH),
                               ("K1", "K1g", PLANS_1CH)):
            # a diag variant is timed only on the kernels it changes
            if diag and k not in (("K3g",) if "box sums" in name
                                  else ("K1g", "K1")):
                continue
            for cols, cluster in plans:
                out = outs(k)
                launch(lib, k, out, (cols, cluster))
                err = error(k, out)
                assert err <= 1e-4 or diag, (name, k, cols, cluster, err)
                if twin is None:
                    kept[(k, cluster)] = out[:2]
                    same = ""
                else:
                    same = "; {}'s first channel bit for bit: {}".format(
                        twin, all(torch.equal(a, b) for a, b in
                                  zip(out, kept[(twin, cluster)])))
                ms = median_ms(lambda: launch(lib, k, out, (cols, cluster)),
                               reps=20)
                vs = (f", {ms / lib_of[k]:.2f}x the library" if k in lib_of
                      else "")
                print(f"[{k}] {name}: cols {cols:2d} cluster {cluster}: "
                      f"rel err {err:.2e}{same}; {ms:.4f} ms{vs}, "
                      f"{bound[k] / ms:.1%} of the byte bound")


if __name__ == "__main__":
    main()
