#!/usr/bin/env python3
"""The raw balance kernel at the GMTI CPI's 4096 x 4096 planes, timed as a
wrapper call, as a launch in a loop, and for the host's share.

    python3 scripts/probe_torch_balance.py [--parent DIR]   # GPU, repo root

On four seeded normal float32 planes on the card: ``raw_balance`` (the
wrapper) and ``torch.vdot`` on the same bytes, each call timed from an idle
card (CUDA events, median of 20 after a warm-up); the balance launcher alone,
200 launches in a loop between two events (median of 5 loops), beside
``torch.vdot`` in the same loop; and the byte bound (four planes read once
over 3.35 TB/s). With ``--parent DIR`` (a checkout of another commit of the
port), it also builds DIR's ``gmti_kernel.cu`` and times its
``balance_launch`` in the same loop: with the ``torch.sum`` over its
partials after each launch where that launcher leaves partials (a source
whose launcher takes ``float* part``), as that commit's wrapper calls it.
Then the host's microseconds a call on 64 x 64 planes (the card's work
negligible, 2,000 calls): the wrapper, the bare ctypes launch and
``torch.vdot``. Every result is held to the plain version (<= 1e-4
relative). The card's name and power limit head the output. Imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    _build, gmti_kernel)
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import (  # noqa: E402
    median_ms)

N = 4096
OUT = ROOT / "build" / "probe_balance"
HBM_BYTES_PER_S = 3.35e12
LOOP = 200


def loop_ms(fn) -> float:
    """ms a call of ``fn`` run LOOP times back to back (median of 5)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(LOOP):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / LOOP)
    return statistics.median(times)


def host_us(fn, calls: int = 2000) -> float:
    """Host microseconds a call of ``fn`` (launches queue on the card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def planes(n_az: int, n_rg: int, dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(5)
    return [torch.randn((n_az, n_rg), generator=gen, device=dev)
            for _ in range(4)]


def launcher(lib, x, parent_style: bool):
    """A callable making one balance launch of ``lib`` over the planes
    ``x`` (and, for a launcher that leaves partials, the torch.sum after
    it); returns (re, im)."""
    n_az, n_rg = x[0].shape
    dev = x[0].device
    stream = _build.stream_handle(dev)
    fn = lib.balance_launch
    if parent_style:              # a slab of rows a block, power-of-two
        blocks = min(n_az, 512)
        part = torch.empty((2, blocks), dtype=torch.float32, device=dev)
        bufs = (part,)
    else:
        blocks = gmti_kernel.balance_grid(n_az, n_rg,
                                          *gmti_kernel.balance_limits(dev))
        work = torch.zeros(1 + 2 * gmti_kernel.balance_limits(dev)[1],
                           dtype=torch.float32, device=dev)
        out = torch.empty(2, dtype=torch.float32, device=dev)
        bufs = (work, out)
    fn.argtypes = ([ctypes.c_void_p] * (4 + len(bufs))
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in (*x, *bufs)]

    def run():
        err = fn(*ptrs, n_az, n_rg, blocks, stream)
        if err:
            raise RuntimeError(f"balance_launch: CUDA error {err}")
        return torch.sum(part, dim=1) if parent_style else out
    return run


def parent_library(parent: str):
    """DIR's gmti_kernel.cu built alone; and whether its launcher leaves
    per-block partials for a torch.sum."""
    src = Path(parent) / _build.SOURCE_DIR.relative_to(ROOT)
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    for f in src.glob("*.cuh"):
        shutil.copy(f, OUT)
    shutil.copy(src / "gmti_kernel.cu", OUT)
    lib = OUT / "libparent_balance.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(OUT / "gmti_kernel.cu")], check=True)
    text = (OUT / "gmti_kernel.cu").read_text()
    return ctypes.CDLL(str(lib)), "float* part" in text


def check(name: str, got, want) -> None:
    g = torch.complex(got[0].double(), got[1].double())
    w = torch.complex(want[0].double(), want[1].double())
    err = float((g - w).abs() / w.abs())
    if err > 1e-4:
        raise RuntimeError(f"{name}: rel err {err}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_balance: needs a CUDA device")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of another commit whose "
                    "balance launcher to time beside")
    parent = ap.parse_args().parent
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    old = parent_library(parent) if parent is not None else None
    lib = _build.library()
    x = planes(N, N, dev)
    a = torch.complex(x[0], x[1]).flatten()
    b = torch.complex(x[2], x[3]).flatten()
    want = gmti_kernel.raw_balance_plain(*x)
    bound = 4 * 4.0 * N * N / HBM_BYTES_PER_S * 1e3
    wrapper = lambda: gmti_kernel.raw_balance(*x)   # noqa: E731
    vdot = lambda: torch.vdot(b, a)                 # noqa: E731
    check("raw_balance", wrapper(), want)
    v = vdot()
    check("torch.vdot", (v.real, v.imag), want)
    w_ms, v_ms = median_ms(wrapper, reps=20), median_ms(vdot, reps=20)
    print(f"[call] {N}^2: raw_balance {w_ms:.4f} ms ({w_ms / v_ms:.2f}x "
          f"torch.vdot, {bound / w_ms:.1%} of the bound); torch.vdot "
          f"{v_ms:.4f} ms; byte bound {bound:.4f} ms")
    runs = [("launcher", launcher(lib, x, False)), ("torch.vdot", vdot)]
    if old is not None:
        runs.insert(1, (f"parent {parent} launcher"
                        + (" + torch.sum" if old[1] else ""),
                        launcher(old[0], x, old[1])))
    line = []
    for name, fn in runs:
        got = fn()
        if name != "torch.vdot":
            check(name, got, want)
        ms = loop_ms(fn)
        line.append(f"{name} {ms:.4f} ms ({bound / ms:.1%} of the bound)")
    print(f"[loop] {N}^2, {LOOP} calls back to back: " + "; ".join(line))
    small = planes(64, 64, dev)
    sa = torch.complex(small[0], small[1]).flatten()
    sb = torch.complex(small[2], small[3]).flatten()
    bare = launcher(lib, small, False)
    print(f"[host] 64^2, us a call: raw_balance "
          f"{host_us(lambda: gmti_kernel.raw_balance(*small)):.2f}; bare "
          f"ctypes launch {host_us(bare):.2f}; torch.vdot "
          f"{host_us(lambda: torch.vdot(sb, sa)):.2f}")


if __name__ == "__main__":
    main()
