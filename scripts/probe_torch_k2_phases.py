#!/usr/bin/env python3
"""Where the time goes inside K2 (the CSA range pass), phase by phase.

    python3 scripts/probe_torch_k2_phases.py       # on a GPU, from the root

Builds a marked copy of ``nis_sar_amtigmti_video_tpu_torch/csrc/csa_kernel.cu``
alone under ``build/probe_k2_phases/`` with ``-Xptxas -v`` (the registers
and spills of every K2 instantiation head the output): thread 0 of every
block records ``clock64()`` after each phase (and ``%globaltimer`` and the
SM id at its start and end). K2 single runs on chip_smoke.py's phase-3
inputs at 4096^2 (the register plan, one row a block), and the output gives
the span, the mean block time, the most blocks resident at once and the
mean SM cycles of each phase: loads issued / forward pass 1 and its
transpose / pass 2's DFT and the wait / the second transpose / pass 3 /
Phi2 / the inverse's pass 1 and transpose / pass 2 and the wait / the
second transpose / pass 3 / Phi3 and the stores. Each mark costs a few
cycles.

Then the times (CUDA events, median of 20 after a warm-up) at 4096^2 of the
wrappers (K2 single on channel 1, the pair) and of their launchers
``k2_launch`` and ``k2_pair_launch`` into preallocated outputs, beside the
composed torch.fft pass (fft, x Phi2, ifft, x Phi3, the phases built
outside the timing), each with its error against the plain version and its
share of the byte bound (2 or 4 planes read and written), and whether the
single gives the pair's bits on both channels. The card's name and power
limit head the output. Imports neither JAX nor the JAX package.
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
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
from bench_torch.peaks import HBM_BYTES_PER_S  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    _build, csa_kernel)
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import (  # noqa: E402
    median_ms)
from probe_torch_fft_phases import (  # noqa: E402
    HEADER, MARK, PHASE_TIMES, phases)

OUT = ROOT / "build" / "probe_k2_phases"
N = chip_smoke.N
END = MARK + "  ts_end();\n"
MARKS = [
    ("namespace {\n", HEADER, 1),
    ("    const size_t at = (size_t)row * N + tau;\n    float2 v[16];\n",
     "    ts_reset();\n", 1),
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


def _mark(src: str) -> str:
    for anchor, text, count in MARKS:
        if src.count(anchor) != count:
            raise RuntimeError(f"anchor found {src.count(anchor)} times, "
                               f"expected {count}: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src + PHASE_TIMES


def build() -> ctypes.CDLL:
    """The marked csa_kernel.cu alone, built under build/probe_k2_phases/;
    prints what ptxas reports for each K2 kernel."""
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    for f in _build.SOURCE_DIR.glob("*.cuh"):
        shutil.copy(f, OUT)
    src = OUT / "csa_kernel.cu"
    src.write_text(_mark((_build.SOURCE_DIR / "csa_kernel.cu").read_text()))
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
           "-o", str(OUT / "lib.so"), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
    entry = None
    for line in proc.stdout.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            entry = fn if "k2_" in fn else None
        elif entry and ("registers" in line or "stack frame" in line):
            info = line.split("info", 1)[-1].lstrip(" :")
            print(f"[ptxas] {entry[entry.index('k2_'):]}: {info}")
    lib = ctypes.CDLL(str(OUT / "lib.so"))
    lib.nis_error_string.argtypes = [ctypes.c_int]
    lib.nis_error_string.restype = ctypes.c_char_p
    lib.get_phase_times.argtypes = [ctypes.c_void_p]
    return lib


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_k2_phases: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    marked = build()
    dev = torch.device("cuda", 0)
    f, x = chip_smoke.kernel_inputs(dev)
    plan = csa_kernel.range_plan(N, dev)

    print("[phases] K2 single at 4096^2")
    seen = phases(marked, [("k2_call", lambda: csa_kernel.k2_call(
        x[0], x[1], f, plan=plan))])
    named("cycles", PHASES, seen["k2_call"][2])

    want = csa_kernel.k2_pair_plain(*x, f)
    bounds = {n: n * 2 * 4.0 * N * N / HBM_BYTES_PER_S * 1e3 for n in (2, 4)}
    phi2, phi3 = csa_kernel._k2_phases(f)
    xc = [torch.complex(x[0], x[1]), torch.complex(x[2], x[3])]
    xs = torch.stack(xc)
    lib_ms = {n: median_ms(lambda: chip_smoke.composed_range_pass(
        z, phi2, phi3), reps=20) for n, z in ((2, xc[0]), (4, xs))}
    print(f"[time] composed torch.fft pass: one channel {lib_ms[2]:.4f} ms, "
          f"the two as a stack {lib_ms[4]:.4f} ms")

    tables, ints = csa_kernel._k2_args("probe", x, f, plan)
    out = [torch.empty_like(x[0]) for _ in range(4)]

    def single_launch():
        _build.launch("k2_launch", (x[0], x[1], *tables, *out[:2]), ints)
        return out[:2]

    def pair_launch():
        _build.launch("k2_pair_launch", (*x, *tables, *out), ints)
        return out

    def line(name, fn, planes):
        got = [o.clone() for o in fn()]
        err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got, want))
        if err > 1e-4:
            raise RuntimeError(f"{name}: rel err {err}")
        ms = median_ms(fn, reps=20)
        return (f"{name} {ms:.4f} ms ({bounds[planes] / ms:.1%} of the byte "
                f"bound, {ms / lib_ms[planes]:.2f}x torch.fft, rel err "
                f"{err:.2e})")

    single = [line("wrapper", lambda: csa_kernel.k2_call(
        x[0], x[1], f, plan=plan), 2), line("k2_launch", single_launch, 2)]
    pair = [line("wrapper", lambda: csa_kernel.k2_pair_call(
        *x, f, plan=plan), 4), line("k2_pair_launch", pair_launch, 4)]
    ones = [csa_kernel.k2_call(x[2 * c], x[2 * c + 1], f, plan=plan)
            for c in (0, 1)]
    same = all(torch.equal(a, b) for a, b in zip(
        ones[0] + ones[1], csa_kernel.k2_pair_call(*x, f, plan=plan)))
    print("[time] K2 single: " + "; ".join(single))
    print("[time] K2 pair: " + "; ".join(pair) + (
        "; the single's bits on both channels" if same
        else "; NOT the single's bits"))
    print(f"[time] byte bounds: single {bounds[2]:.4f} ms, pair "
          f"{bounds[4]:.4f} ms")


if __name__ == "__main__":
    main()
