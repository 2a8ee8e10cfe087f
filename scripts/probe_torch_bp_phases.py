#!/usr/bin/env python3
"""Where the time goes inside the port's fast-BP accumulate kernel.

    python3 scripts/probe_torch_bp_phases.py [--parent DIR]  # GPU, repo root

Builds copies of ``nis_sar_amtigmti_video_tpu_torch/csrc/bp_kernel.cu``
under ``build/probe_bp_phases/``, all nvcc processes at once, and prints
what ptxas reports (registers, spills, shared memory) for each
``accumulate_kernel<W>``:

- "marked": the source's ``BP_MARK`` hooks defined, so that thread 0 (a
  consumer warp) and thread 256 (a producer warp) of every block sum
  ``clock64()`` deltas per phase over the block's pulses. Run on the
  full-width operands of ``chip_smoke.py``'s phase 7 (the pixel accumulate,
  P 625 x 1,664 x 640, W 64; the factor kernel's inner sums, W 32 on 128
  coarse columns, sub-apertures of 64), it prints the SM cycles a pulse of
  each phase: the consumers' wait for a slot, contraction (K fragments and
  HMMA) and epilogue; the producers' wait for a free slot, band load
  (``cp.async`` wait), row and column tables, window DFT stage 1 and stage
  2 (ramp, TF32 split, stores); with the span, the mean block time and the
  most blocks resident at once.
- this tree's source as it is: ``cuobjdump -sass`` counts its tensor-core
  instructions (``HMMA``, ``HGMMA``) per kernel, to show the contraction is
  on the matrix unit, beside its ``WARPGROUP.DEPBAR`` waits and calls (one
  call in a kernel makes ptxas wait for each wgmma in turn), and leaves the listing in
  ``build/probe_bp_phases/this_tree.sass``.
- ``VARIANTS``, text substitutions on copies that change the result to
  time one part (one TF32 pass instead of three; no contraction; no
  epilogue; the producers alone; the contraction alone; the epilogue
  without its ``sincosf``).
- with ``--parent DIR`` (a ``git archive`` of another commit unpacked under
  ``build/``), DIR's source as it is.

Then it times each build's launch at the two full-width shapes (CUDA
events, median of 10 after a warm-up) beside the plain version's error and
the bounds of ``chip_smoke.acc_work`` (tensor-core and f32-FMA). The
card's name and power limit head the output. Imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    _build, bp_factor_kernel, bp_kernel)
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import (  # noqa: E402
    median_ms)

OUT = ROOT / "build" / "probe_bp_phases"
MAX_BLOCKS = 8192
N_SLOTS = 16
# slots 0-9: phase cycles (BP_MARK indices); 10, 11: globaltimer at the
# block's start and end; 12: SM id; 13: the block's pulses
PROBE = r"""
__device__ unsigned long long g_bp[8192 * 16];
__device__ __forceinline__ unsigned long long bp_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define BP_PROBE_DECL                                                     \
  const unsigned long long bp_g0 = bp_gtime();                            \
  unsigned long long bp_last = clock64();                                 \
  unsigned long long bp_acc[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#define BP_MARK(i)                                                        \
  do {                                                                    \
    const unsigned long long c_ = clock64();                              \
    bp_acc[i] += c_ - bp_last;                                            \
    bp_last = c_;                                                         \
  } while (0)
#define BP_PROBE_END                                                      \
  {                                                                       \
    const int b_ = blockIdx.x + gridDim.x * (blockIdx.y                   \
                                             + gridDim.y * blockIdx.z);   \
    unsigned long long* r_ = g_bp + (size_t)b_ * 16;                      \
    if (b_ < 8192 && threadIdx.x == 0) {                                  \
      unsigned sm_;                                                       \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));                    \
      r_[0] = bp_acc[0];                                                  \
      r_[1] = bp_acc[1];                                                  \
      r_[2] = bp_acc[2];                                                  \
      r_[3] = bp_acc[3];                                                  \
      r_[10] = bp_g0;                                                     \
      r_[11] = bp_gtime();                                                \
      r_[12] = sm_;                                                       \
      r_[13] = t1 - t0;                                                   \
    } else if (b_ < 8192 && threadIdx.x == kConsumers) {                  \
      r_[4] = bp_acc[4];                                                  \
      r_[5] = bp_acc[5];                                                  \
      r_[6] = bp_acc[6];                                                  \
      r_[7] = bp_acc[7];                                                  \
      r_[8] = bp_acc[8];                                                  \
      r_[9] = bp_acc[9];                                                  \
    }                                                                     \
  }
"""
# BP_MARK(i) closes the phase PHASES[i], opened by the mark before it;
# 0 (set-up, then nothing) and 4 (set-up, then the FULL arrive) are left
# out; 3 is once a block (the last pulse's epilogue), shown per pulse too
PHASES = (None, "consumer: wait for a full slot",
          "consumer: contraction, with the last pulse's epilogue between "
          "its wgmma groups", "consumer: the block's last epilogue", None,
          "producer: wait for an empty slot", "producer: band load",
          "producer: row and column tables", "producer: window DFT stage 1",
          "producer: stage 2, ramp, split, stores")
SHIM = ('extern "C" const char* nis_error_string(int code) {\n'
        "  return cudaGetErrorString((cudaError_t)code);\n}\n")
READ = ('extern "C" int get_probe(void* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, g_bp, sizeof(g_bp));\n}\n"
        'extern "C" int reset_probe() {\n'
        "  void* p;\n"
        "  int err = (int)cudaGetSymbolAddress(&p, g_bp);\n"
        "  return err ? err : (int)cudaMemset(p, 0, sizeof(g_bp));\n}\n")
# copies of this tree's source timed beside it, which change the result to
# time one part: one TF32 pass instead of three; no contraction; no
# epilogue but the last pulse's; the producers alone (neither); the
# contraction alone (no epilogue, the producers skip their work); the
# epilogue without its sincosf
_LO_PASSES = [(f"    wgmma_tf32(d, f[{f}], {b}, 1);\n", "")
              for f, b in ((0, "dr_l"), (1, "dr"), (2, "di_l"), (3, "di"))]
_HI_PASSES = [("    wgmma_tf32(d, f[0], dr, s > 0);\n", ""),
              ("    wgmma_tf32(d, f[2], di, 1);\n", "")]
_EPILOGUE = """    if (PREV)
      epilogue(e, acc, s * kPer, s * kPer + kPer, rt, sc, xv, tq,
               a.taper_pow);
"""
VARIANTS = {
    "diag: one TF32 pass": _LO_PASSES,
    "diag: no contraction": _LO_PASSES + _HI_PASSES,
    "diag: no epilogue": [(_EPILOGUE, "")],
    "diag: producers alone": _LO_PASSES + _HI_PASSES + [(_EPILOGUE, "")],
    "diag: contraction alone": [
        (_EPILOGUE, ""),
        ("      BP_MARK(6);\n", "      BP_MARK(6);\n      if (a.num_p < 0) {\n"),
        ("      // the B tiles are read through the tensor cores' async proxy\n",
         "      }\n      // the B tiles are read through the tensor cores' "
         "async proxy\n")],
    "diag: no epilogue sincosf": [
        ("      sincosf(rw.z * xi + rw.w * (xi * xi), &sn, &cs);\n",
         "      sn = rw.z * xi;\n      cs = rw.w;\n")],
}


def _replace(src: str, pairs, what: str) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"{what}: found {src.count(old)} times, "
                               f"expected once: {old!r}")
        src = src.replace(old, new)
    return src


def build(parent) -> dict:
    """Libraries built from bp_kernel.cu alone: "marked", "this tree",
    each of VARIANTS, and "parent" with --parent. Prints ptxas's report
    per accumulate kernel."""
    shutil.rmtree(OUT, ignore_errors=True)
    src = (_build.SOURCE_DIR / "bp_kernel.cu").read_text()
    sources = {"marked": (_build.SOURCE_DIR, PROBE + src + READ),
               "this tree": (_build.SOURCE_DIR, src)}
    for v, pairs in VARIANTS.items():
        sources[v] = (_build.SOURCE_DIR, _replace(src, pairs, v))
    if parent is not None:
        where = Path(parent) / _build.SOURCE_DIR.relative_to(ROOT)
        sources["parent"] = (where, (where / "bp_kernel.cu").read_text())
    jobs = {}
    for i, (name, (headers, text)) in enumerate(sources.items()):
        where = OUT / f"lib{i}"
        where.mkdir(parents=True)
        for f in headers.glob("*.cuh"):
            shutil.copy(f, where)
        (where / "bp_kernel.cu").write_text(text + SHIM)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(where / "lib.so"),
               str(where / "bp_kernel.cu")]
        jobs[name] = (where, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (where, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                entry = "W 64" if "ILi64E" in entry else "W 32"
            elif "wgmma" in line.lower() or (entry and (
                    "registers" in line or "stack frame" in line)):
                info = line.split("info", 1)[-1].lstrip(" :")
                print(f"[ptxas] {name}: {entry}: {info}")
        lib = ctypes.CDLL(str(where / "lib.so"))
        lib.nis_error_string.argtypes = [ctypes.c_int]
        lib.nis_error_string.restype = ctypes.c_char_p
        if name == "marked":
            lib.get_probe.argtypes = [ctypes.c_void_p]
        libs[name] = (where / "lib.so", lib)
    return libs


def sass_counts(so: Path) -> None:
    """Tensor-core instructions per kernel in the library's SASS."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        print(f"[sass] cuobjdump failed: {out.stderr[-500:]}")
        return
    (OUT / "this_tree.sass").write_text(out.stdout)
    fn, counts = None, {}
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = "W 64" if "ILi64E" in m.group(1) else "W 32"
            counts[fn] = {"HMMA": 0, "HGMMA": 0, "WARPGROUP.DEPBAR": 0,
                          "CALL": 0, "FFMA": 0, "MUFU": 0}
            continue
        if fn is None:
            continue
        for op in counts[fn]:
            if re.search(rf"\b{re.escape(op)}\b", line):
                counts[fn][op] += 1
    for fn, c in counts.items():
        print(f"[sass] accumulate_kernel {fn}: " + ", ".join(
            f"{op} {n}" for op, n in c.items()) + " (static instructions; a "
            "WARPGROUP.DEPBAR after every HGMMA means ptxas serialised them)")


def through(lib, fn):
    """``fn`` with the package's launches going to ``lib``."""
    def run():
        package = _build.library
        _build.library = lambda: lib
        try:
            return fn()
        finally:
            _build.library = package
    return run


def phases(lib, name, fn) -> None:
    """Run ``fn`` on the marked library twice; report the second launch."""
    buf = np.zeros(MAX_BLOCKS * N_SLOTS, np.uint64)
    run = through(lib, fn)
    run()
    torch.cuda.synchronize()
    if lib.reset_probe() != 0:
        raise RuntimeError("clearing the probe failed")
    run()
    torch.cuda.synchronize()
    if lib.get_probe(buf.ctypes.data) != 0:
        raise RuntimeError("reading the probe failed")
    ts = buf.reshape(MAX_BLOCKS, N_SLOTS).astype(np.int64)
    ts = ts[ts[:, 11] != 0]
    pulses = ts[:, 13].sum()
    g0, g1, sm = ts[:, 10], ts[:, 11], ts[:, 12]
    events = sorted([(a, 1) for a in g0] + [(b, -1) for b in g1])
    live = most = 0
    for _, e in events:
        live += e
        most = max(most, live)
    dur = (g1 - g0) / 1e3
    print(f"[phases] {name}: {len(ts)} blocks on {len(np.unique(sm))} SMs, "
          f"span {(g1.max() - g0.min()) / 1e3:.1f} us; block {dur.mean():.2f}"
          f" us mean; at most {most} blocks at once; {pulses} block-pulses")
    for i, what in enumerate(PHASES):
        if what is not None:
            print(f"  {what}: {ts[:, i].sum() / pulses:.0f} SM cycles a pulse")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_bp_phases: needs a CUDA device")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of another commit whose "
                    "accumulate kernel to time beside")
    parent = ap.parse_args().parent
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    libs = build(parent)
    sass_counts(libs["this tree"][0])
    dev = torch.device("cuda", 0)
    sc, opts, t0, p, d, traj, _ = chip_smoke.videosar_setup()
    cpi = sc.video.cpi_pulses(sc.radar.prf_hz)
    plan64, plan_cpi = chip_smoke.acc_plans(p, traj, t0, cpi)
    gen = torch.Generator(device=dev).manual_seed(2)
    rc = torch.complex(
        torch.randn((cpi, opts.num_samples), generator=gen, device=dev),
        torch.randn((cpi, opts.num_samples), generator=gen, device=dev))
    tr = [torch.as_tensor(a[:cpi], device=dev) for a in
          (traj.positions, traj.velocities, traj.times)]
    vf = torch.as_tensor(
        [chip_smoke.SHIP_SPEED * math.cos(math.radians(chip_smoke.SHIP_HEADING)),
         chip_smoke.SHIP_SPEED * math.sin(math.radians(chip_smoke.SHIP_HEADING)),
         0.0], dtype=torch.float64, device=dev)
    sub_p = max(1, plan_cpi.sub_raw // d)
    ops64 = chip_smoke.acc_operands(rc, tr, vf, p, d, plan64, 0)
    opsf = chip_smoke.acc_operands(rc, tr, vf, p, d, plan_cpi, 16)
    del rc
    cases = {
        "accumulate_pallas": (
            lambda: bp_kernel.accumulate_pallas(*ops64),
            bp_kernel.accumulate_pallas_plain(*ops64),
            chip_smoke.acc_work(ops64, plan64.nx_i)),
        "inner sums (factor kernel)": (
            lambda: bp_factor_kernel.inner_sums(*opsf, sub_p),
            None, chip_smoke.acc_work(opsf, plan_cpi.nx_c)),
    }
    for name, (fn, _, _) in cases.items():
        phases(libs["marked"][1], name, fn)
    for name, (fn, want, work) in cases.items():
        b, f32_ms = chip_smoke.acc_bounds(work)
        line = []
        for build_name, (_, lib) in libs.items():
            if build_name == "marked":
                continue
            run = through(lib, fn)
            got = run()
            torch.cuda.synchronize()
            if want is not None and not build_name.startswith("diag"):
                err = float((got - want).abs().max() / want.abs().max())
                if err > 1e-4:
                    raise RuntimeError(f"{build_name} {name}: rel err {err}")
                err_s = f", rel err {err:.2e}"
            else:
                err_s = ""
            ms = median_ms(run, reps=10)
            line.append(f"{build_name} {ms:.4f} ms ({b['bound_ms'] / ms:.1%}"
                        f" of the tensor-core bound{err_s})")
        print(f"[time] {name}: " + "; ".join(line) + f"; tensor-core bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}), f32-FMA bound "
              f"{f32_ms:.4f} ms")


if __name__ == "__main__":
    main()
