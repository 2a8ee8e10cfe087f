#!/usr/bin/env python3
"""Where the time goes inside the NUFFT echo's spread and FFT-conv kernels.

    python3 scripts/probe_torch_echo_phases.py [--parent DIR]  # GPU, repo root

Builds copies of ``nis_sar_amtigmti_video_tpu_torch/csrc/spread_kernel.cu`` and
``csrc/fft_kernel.cu`` under ``build/probe_echo_phases/`` in which thread 0 of
every block records ``clock64()`` after each phase (and ``%globaltimer`` and
the SM id at its start and end), and runs them on the operands of
``chip_smoke.py``'s phase 10: the full-scale chain's first 512-pulse chunk
(``echo_freq.kernel_operands``). Per kernel it prints the span, the mean block
time, the most blocks resident at once, the idle gap between blocks on an SM,
and the mean SM cycles of each named phase. The spread, with its values staged
and with its taps formed (the path's operands of both passes): staging (values
by cp.async or the taps formed, cells, zeroing) / count (occupancy bits,
occupied-cell index, counts, least targets) / scan (one warp) and the barrier /
rank (the stable list) / the values' arrival and the barrier / gather and
store. The conv: loads and the columns' 16-point DFTs / the columns' A-point
DFTs, the push and the rows' 16-point DFTs / the rows' 8-point DFTs, the filter
and the inverse 8-point DFTs / the rows' inverse 16-point DFTs and the push
back / the columns' inverse A-point DFTs / their inverse 16-point DFTs and the
band stores. ptxas's registers and spills head each build.

Then the times (CUDA events, median of 20 after a warm-up) of this tree's
wrappers on the same operands: the spread's main and edge passes in both orders
and with the taps formed, the conv beside torch.fft's fft / multiply / ifft and
beside each part's byte bound, and the VARIANTS (text substitutions on copies:
the conv on one block an SM; the spread at 64 registers, four blocks an SM,
with its values read from device memory in the gather, none staged, on 192 or
384 threads, or with the targets of a cell that form one run in index order put
in its list in parallel, the match loop ranking the rest). With ``--parent
DIR`` (a checkout of an earlier commit, e.g. a ``git archive`` unpacked under
``build/``) it also builds DIR's two sources as they are and marked (the first
design's phases: the spread's staging / count / scan / rank / gather and store;
the conv's loads / column FFT / scatter / row FFT / filter / row inverse /
twiddle / barrier / gather / column inverse / band store), times DIR's
launchers on the same operands (its conv on contiguous copies of the field, the
copies the sim pass made before, timed apart) and prints whether this tree's
spread windows equal DIR's bit for bit (``torch.equal``) in both orders, and
compares the SASS of forward spectra and the conv (``cuobjdump -sass`` of the
package's library and of DIR's build, each instantiation's instructions with
the addresses, encodings and label numbers left out): identical, or how many
lines differ (the diffs under ``build/probe_echo_phases/``). A DIR whose spread
or conv is already this tree's design is marked with this tree's marks and its
conv launched through the package's wrapper. The card's name and power limit
head the output. Imports neither JAX nor the JAX package."""

from __future__ import annotations

import argparse
import ctypes
import difflib
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
from bench_torch.peaks import HBM_BYTES_PER_S  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops import echo, echo_freq  # noqa
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    _build, fft_kernel, spread_kernel)
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import (  # noqa: E402
    median_ms)
from probe_torch_fft_phases import (  # noqa: E402
    BITREV_LANE, HEADER, MARK, PHASE_TIMES, SHIM, _replace, phases, through)

OUT = ROOT / "build" / "probe_echo_phases"
END = MARK + "  ts_end();\n"          # the last phase's mark, then the end
# (anchor, text put after it, times the anchor occurs), and the phase names
SPREAD_MARKS = [
    ("namespace {\n", HEADER, 1),
    ("  const int tid = (int)threadIdx.x, lane = tid & 31, warp = tid >> 5;"
     "\n", "  ts_reset();\n", 1),
    ("  for (int b = tid; b < bg; b += kThreads) s_key[b] = cell(b);\n"
     "  __syncthreads();\n", MARK, 1),
    ("    atomicMin(s_first + u, b);\n  }\n  __syncthreads();\n", MARK, 1),
    ("    if (lane == 31) s_start[n_u] = incl;\n  }\n  __syncthreads();\n",
     MARK, 1),
    ("      if (u >= 0 && rank == 0) s_cnt[u] += __popc(peers);\n"
     "      __syncwarp();\n    }\n  }\n", MARK, 1),
    ('  asm volatile("cp.async.wait_all;\\n" ::: "memory");\n'
     "  __syncthreads();\n", MARK, 1),
    ("          o[win + d] = im[d];\n        }\n      }\n    }\n  }\n", END,
     1),
]
SPREAD_PHASES = ["staging", "count", "scan", "rank", "values' wait",
                 "gather + store"]
CONV_MARKS = [
    ("namespace {\n", HEADER, 1),
    ("  const float* im = xi + (size_t)row * ld_i;\n", "  ts_reset();\n", 1),
    ("                                                   t.tw_b1, a * kb, "
     "B1));\n  }\n  __syncthreads();\n", MARK, 1),
    ("  rows_first_half<B1, R>(buf, t);\n\n  // Rows, second half and back: "
     "per (r, kb') the 8-point DFT over a', the\n", MARK, 1),
    ("    for (int a = 0; a < 8; ++a) p[a] = w[a];\n  }\n  __syncthreads();\n",
     MARK, 1),
    ("    dst[k2 * C + n1 % C] = odd ? v[b ^ 1] : v[b];\n  }\n"
     "  cluster_arrive();\n  cluster_wait();\n", MARK, 1),
    ("nis::twiddle_pow<true>(t.tw_b1, kb * n, B1));\n    }\n  }\n"
     "  __syncthreads();\n", MARK, 1),
    ("        __stcs(o + (size_t)(n2 - p0) * 128, nis::cscale(x[b], inv_n));\n"
     "    }\n", END, 1),
]
CONV_PHASES = ["loads + column DFT16", "column DFT-A, push, row DFT16",
               "row DFT8, filter, inverse DFT8",
               "row inverse DFT16, push back", "column inverse DFT-A",
               "column inverse DFT16 + band store"]
# the first design's sources (before the redesign)
PARENT_SPREAD_MARKS = [
    ("namespace {\n", HEADER, 1),
    ("  const int tid = (int)threadIdx.x;\n", "  ts_reset();\n", 1),
    ("  for (int i = tid; i < nv; i += kThreads) s_val[i] = __ldg(v_g + i);\n"
     "  __syncthreads();\n", MARK, 1),
    ("    if (c >= 0) atomicAdd(s_pos + c + 1, 1);\n  }\n  __syncthreads();\n",
     MARK, 1),
    ("  block_inclusive_scan(s_pos + 1, win, warp_tot);\n", MARK, 1),
    ("    s_list[s_pos[c] + rank] = b;\n  }\n  __syncthreads();\n", MARK, 1),
    ("      o_g[(size_t)(2 * s + 1) * win + j] = acc_i;\n    }\n  }\n", END,
     1),
]
PARENT_SPREAD_PHASES = ["staging", "count", "scan", "rank", "gather + store"]
_COL = ("        col[(l & (s.cols - 1)) * (s.b1 + 1) + (l >> s.log2cols)] = v;"
        "\n      });\n  __syncthreads();\n")
PARENT_CONV_MARKS = [
    ("namespace {\n", HEADER, 1),
    ("  const size_t at = (size_t)row * ns;\n", "  ts_reset();\n", 1),
    (_COL, MARK, 2),                 # loads (forward), gather (inverse)
    ("  cluster.sync();\n", MARK, 5),
    ("  pulse_forward(cluster, PlanesLoad{xr + at, xi + at, ns}, y, col, t, "
     "s);\n", MARK, 1),
    ("             [&](int l, float2 v) { y[l] = v; });\n", MARK, 1),
    ("  block_fft_dit(acc, 7, 128, t.tw_128, true);\n", MARK, 1),
    ("      [&](int l, float2 v) { acc[l] = v; });\n", MARK, 1),
    ("  block_fft_dif(col, s.log2b1, s.b1 + 1, t.tw_b1, true);\n", MARK, 1),
    ("  group_inverse(cluster, y, col, out + (size_t)row * (p1 - p0) * 128, "
     "p0, p1,\n                t, s);\n", "  ts_end();\n", 1),
]
PARENT_CONV_PHASES = ["loads", "column FFT + barrier",
                      "scatter + barrier", "row FFT", "filter",
                      "row inverse", "twiddle", "barrier",
                      "gather", "column inverse", "band store + barrier"]
# variants of this tree's sources, timed beside it; _FROM_DEVICE: the
# spread's gather reads the values from device memory, none staged
_FROM_DEVICE = [
    ("  int* s_key = reinterpret_cast<int*>(s_val + ((nv + 3) & ~3));",
     "  int* s_key = reinterpret_cast<int*>(s_val);"),
    ("    for (int i = 4 * tid; i < nv; i += 4 * kThreads)",
     "    for (int i = 4 * tid; i < 0; i += 4 * kThreads)"),
    ("    for (int i = tid; i < nv; i += kThreads)",
     "    for (int i = tid; i < 0; i += kThreads)"),
    ("      const float* vr = s_val + (size_t)s * 2 * k_taps * bg;",
     "      const float* vr = v_g + (size_t)s * 2 * k_taps * bg;"),
    ("  return 4 * (((nv + 3) & ~3) + 5 * bg + 2 * nw + 3);",
     "  return 4 * (5 * bg + 2 * nw + 3);"),
]
# _RUNS: a cell whose targets form one run in index order puts them in the
# list in parallel (start + b - least target), the match loop ranking the
# rest
_RUNS = [
    ("    atomicAdd(s_cnt + u, 1);\n",
     "    atomicAdd(s_cnt + u, b == 0 || cell(b - 1) != c ? 1 + (1 << 16) : "
     "1);\n"),
    ("    for (int i = a0; i < a1; ++i) sum += s_cnt[i];\n",
     "    for (int i = a0; i < a1; ++i) sum += s_cnt[i] & 0xffff;\n"),
    ("      const int n = s_cnt[i];\n", "      const int n = s_cnt[i] & 0xffff;\n"),
    ("      s_cnt[i] = 0;\n", "      s_cnt[i] = (s_cnt[i] >> 16) == 1 ? -1 : 0;\n"),
    ("  if (warp == 0) {\n    const unsigned below",
     "  for (int b = tid; b < bg; b += kThreads) {\n"
     "    const int u = s_key[b];\n"
     "    if (u >= 0 && s_cnt[u] < 0)\n"
     "      s_list[s_start[u] + b - (s_first[u] & 0xffff)] = b;\n"
     "  }\n  if (warp == 0) {\n    const unsigned below"),
    ("      if (u >= 0 && s_first[u] < (2 << 16)) u = -1;   // one target\n",
     "      if (u >= 0 && s_cnt[u] < 0) u = -1;\n"),
]
VARIANTS = {
    "conv one block an SM": ("fft_kernel.cu", [(
        "  static constexpr int kBlocksPerSm = Fwd<B1, R>::T == 256 ? 4 : 2;",
        "  static constexpr int kBlocksPerSm = Fwd<B1, R>::T == 256 ? 4 : 1;"
    )]),
    "spread at 64 registers": ("spread_kernel.cu", [
        ("__launch_bounds__(kThreads, 6)", "__launch_bounds__(kThreads, 4)")]),
    "spread, values from device memory": ("spread_kernel.cu", _FROM_DEVICE),
    "spread, one-run cells in parallel": ("spread_kernel.cu", _RUNS),
    "spread on 192 threads": ("spread_kernel.cu", [
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 192;"),
        ("__launch_bounds__(kThreads, 6)", "__launch_bounds__(kThreads, 8)")]),
    "spread on 384 threads": ("spread_kernel.cu", [
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 384;"),
        ("__launch_bounds__(kThreads, 6)", "__launch_bounds__(kThreads, 4)")]),
}


def _mark(src: str, marks) -> str:
    for anchor, text, count in marks:
        if src.count(anchor) != count:
            raise RuntimeError(f"anchor found {src.count(anchor)} times, "
                               f"expected {count}: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src + PHASE_TIMES


def build(parent) -> dict:
    """Libraries of one source each, all nvcc processes at once: "spread
    marked", "conv marked", each VARIANT, and with ``parent`` "parent
    spread", "parent conv" and their marked copies. Prints what ptxas
    reports for the spread and conv kernels."""
    shutil.rmtree(OUT, ignore_errors=True)
    here = _build.SOURCE_DIR
    sources = {
        "spread marked": (here, "spread_kernel.cu", _mark(
            (here / "spread_kernel.cu").read_text(), SPREAD_MARKS)),
        "conv marked": (here, "fft_kernel.cu", _mark(
            (here / "fft_kernel.cu").read_text(), CONV_MARKS)),
    }
    for name, (f, pairs) in VARIANTS.items():
        sources[name] = (here, f, _replace((here / f).read_text(), pairs,
                                           name))
    if parent is not None:
        there = Path(parent) / here.relative_to(ROOT)
        spread = (there / "spread_kernel.cu").read_text()
        conv = (there / "fft_kernel.cu").read_text()
        sources.update({
            "parent spread": (there, "spread_kernel.cu", spread),
            "parent conv": (there, "fft_kernel.cu", conv),
            "parent spread marked": (there, "spread_kernel.cu", _mark(
                spread, SPREAD_MARKS if spread_redesigned(spread)
                else PARENT_SPREAD_MARKS)),
            "parent conv marked": (there, "fft_kernel.cu", _mark(
                conv, CONV_MARKS if conv_redesigned(conv)
                else PARENT_CONV_MARKS))})
    jobs = {}
    for i, (name, (headers, fname, text)) in enumerate(sources.items()):
        where = OUT / f"lib{i}"
        where.mkdir(parents=True)
        for f in headers.glob("*.cuh"):
            shutil.copy(f, where)
        (where / fname).write_text(text + SHIM)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(where / "lib.so"), str(where / fname)]
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
                entry = entry if ("spread_windows" in entry
                                  or "fft_conv" in entry) else None
            elif entry and ("registers" in line or "stack frame" in line):
                info = line.split("info", 1)[-1].lstrip(" :")
                print(f"[ptxas] {name}: {entry[:48]}: {info}")
        lib = ctypes.CDLL(str(where / "lib.so"))
        lib.nis_error_string.argtypes = [ctypes.c_int]
        lib.nis_error_string.restype = ctypes.c_char_p
        if "marked" in name:
            lib.get_phase_times.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    return libs


def _call(lib, name, tensors, ints):
    f = getattr(lib, name)
    f.argtypes = ([ctypes.c_void_p] * len(tensors)
                  + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    err = f(*(t.data_ptr() for t in tensors), *ints,
            _build.stream_handle(tensors[0].device))
    if err:
        raise RuntimeError(f"{name}: {lib.nis_error_string(err).decode()}")


def parent_spread(lib, c, v, win, qr):
    """DIR's spread launcher (the same C signature) into a new output."""
    pc, grp, bg = c.shape
    out = torch.empty((pc, grp, 2 * v.shape[2], win), device=c.device)
    _call(lib, "spread_windows_launch", (c, v, out),
          (pc * grp, bg, win, v.shape[2], v.shape[3] // 2, int(qr)))
    return out


def spread_redesigned(src: str) -> bool:
    """Whether a spread_kernel.cu is the occupancy-bit design (this tree's
    marks apply), not the first design."""
    return "__match_any_sync" in src


def conv_redesigned(src: str) -> bool:
    """Whether a fft_kernel.cu has the conv on forward spectra's plan (its
    launcher takes the field's row strides), not the first design's."""
    return "rows_first_half<B1, R>(buf, t);" in src


def parent_conv(lib, fr, fi, filt, nfft, rows):
    """DIR's first-design conv launcher: contiguous planes, the filter with
    k1 bit-reversed in each row."""
    dev = fr.device
    lay = fft_kernel._to_layout(filt[None])[0][:, BITREV_LANE].contiguous()
    out = torch.empty((fr.shape[0], (rows[1] - rows[0]) * 128),
                      dtype=torch.complex64, device=dev)
    _call(lib, "fft_conv_launch",
          (fr, fi, lay, *fft_kernel._tables(nfft, dev), out),
          (fr.shape[0], fr.shape[1], nfft, rows[0], rows[1]))
    return out


def sass_functions(so: str, patterns) -> dict:
    """The SASS of each kernel of library ``so`` whose name holds one of
    ``patterns``, keyed by its name from that pattern on: the instructions
    without their addresses and encodings, labels numbered afresh in order
    of appearance, a file's anonymous namespace as ANON."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", so], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    funcs, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            fn = next((name[name.index(p):] for p in patterns if p in name),
                      None)
            if fn is not None:
                funcs[fn] = []
            continue
        m = re.match(r"\s*(?:/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;|(\.L_x_\d+:))",
                     line)
        if fn is not None and m:
            funcs[fn].append(m.group(1) or m.group(2))
    for fn, lines in funcs.items():
        labels = {}
        text = re.sub(r"(\d+)(_GLOBAL__N__\w+)", lambda m: "4ANON"
                      + m.group(2)[int(m.group(1)):], "\n".join(lines))
        funcs[fn] = re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(
            m.group(0), f"L{len(labels)}"), text).splitlines()
    return funcs


def compare_sass(parent_so: str) -> None:
    """The SASS of forward spectra and the conv (fft_kernel.cu), the
    package's library against DIR's build."""
    patterns = ("forward_spectra_kernel", "fft_conv_kernel")
    here = sass_functions(str(_build.library_path()), patterns)
    there = sass_functions(parent_so, patterns)
    for i, fn in enumerate(sorted(set(here) | set(there))):
        a, b = there.get(fn), here.get(fn)
        if a is None or b is None:
            print(f"[sass] {fn}: only in "
                  f"{'this tree' if a is None else 'the parent'}")
            continue
        diff = list(difflib.unified_diff(a, b, "parent", "this tree",
                                         lineterm="", n=2))
        changed = sum(1 for d in diff[2:] if d[:1] in "+-")
        if changed:
            (OUT / f"sass_{i}.diff").write_text(fn + "\n" + "\n".join(diff)
                                                + "\n")
        print(f"[sass] {fn}: parent {len(a)} instructions, this tree "
              f"{len(b)}: " + (f"{changed} lines differ" if changed
                               else "identical"))


def show_phases(lib, runs, names):
    """phases() of each run, then the phase names in order."""
    phases(lib, runs)
    print("  phases: " + " | ".join(names))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_echo_phases: needs a CUDA device")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of an earlier commit whose "
                    "spread and conv to mark and time beside")
    parent = ap.parse_args().parent
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    libs = build(parent)
    dev = torch.device("cuda", 0)
    sc, opts, t0, scene, traj, offs = chip_smoke.e2e_setup()
    fields = echo.scalar_fields(traj, scene, opts, t_start=t0,
                                rx_offsets=offs, device=dev)
    ops = echo_freq.kernel_operands(*fields, opts,
                                    **echo.synth_options(opts))
    del fields
    spreads = {"main": ops["spread main"], "edge": ops["spread edge"][0]}
    formed = {"main": ops["spread main taps"],
              "edge": ops["spread edge taps"][0]}
    fr, fi, filt, nfft, rows = ops["conv"]
    torch.cuda.synchronize()
    print(f"[operands] spread main cells {tuple(spreads['main'][0].shape)}, "
          f"values {tuple(spreads['main'][1].shape)}, win "
          f"{spreads['main'][2]}; edge values "
          f"{tuple(spreads['edge'][1].shape)}, win {spreads['edge'][2]}; "
          f"conv field {tuple(fr.shape)} (row strides {fr.stride(0)}, "
          f"{fi.stride(0)}), nfft {nfft}, band rows {rows}")

    sw = spread_kernel.spread_windows_pallas
    conv = fft_kernel.fft_conv_pallas
    print("[phases] this tree")
    show_phases(libs["spread marked"],
                [(f"spread {p}", lambda c=c, v=v, w=w: sw(c, v, w))
                 for p, (c, v, w) in spreads.items()]
                + [(f"spread {p}, taps formed",
                    lambda c=c, o=o, w=w, t=t: sw(c, o, w, taps=t))
                   for p, (c, o, w, t) in formed.items()], SPREAD_PHASES)
    show_phases(libs["conv marked"],
                [("conv", lambda: conv(fr, fi, filt, nfft, out_rows=rows))],
                CONV_PHASES)
    frc, fic = fr.contiguous(), fi.contiguous()
    if parent is not None:
        print(f"[phases] parent {parent}")
        there = Path(parent) / _build.SOURCE_DIR.relative_to(ROOT)
        show_phases(libs["parent spread marked"],
                    [(f"spread {p}", lambda c=c, v=v, w=w: parent_spread(
                        libs["parent spread marked"], c, v, w, False))
                     for p, (c, v, w) in spreads.items()],
                    SPREAD_PHASES if spread_redesigned(
                        (there / "spread_kernel.cu").read_text())
                    else PARENT_SPREAD_PHASES)
        if conv_redesigned((there / "fft_kernel.cu").read_text()):
            show_phases(libs["parent conv marked"], [("conv", lambda: through(
                libs["parent conv marked"], conv)(fr, fi, filt, nfft,
                                                  out_rows=rows))],
                        CONV_PHASES)
        else:
            show_phases(libs["parent conv marked"],
                        [("conv", lambda: parent_conv(
                            libs["parent conv marked"], frc, fic, filt, nfft,
                            rows))], PARENT_CONV_PHASES)

    for p, (c, v, w) in spreads.items():
        b, _ = chip_smoke.spread_work(c, v, w)
        bound = b / HBM_BYTES_PER_S * 1e3
        for qr in (False, True):
            line = []
            got = sw(c, v, w, qr=qr)
            ms = median_ms(lambda: sw(c, v, w, qr=qr), reps=20)
            line.append(f"this tree {ms:.4f} ms ({bound / ms:.1%} of the "
                        "bound)")
            for var, (f, _) in VARIANTS.items():
                if f != "spread_kernel.cu":
                    continue
                fn = through(libs[var], sw)
                assert torch.equal(fn(c, v, w, qr=qr), got), var
                ms = median_ms(lambda: fn(c, v, w, qr=qr), reps=20)
                line.append(f"{var} {ms:.4f} ms")
            if parent is not None:
                lib = libs["parent spread"]
                same = torch.equal(parent_spread(lib, c, v, w, qr), got)
                ms = median_ms(lambda: parent_spread(lib, c, v, w, qr),
                               reps=20)
                line.append(f"parent {ms:.4f} ms; bit-identical to the "
                            f"parent: {same}")
            order = "one accumulator" if qr else "roll"
            print(f"[time] spread {p} ({order}): " + "; ".join(line)
                  + f"; byte bound {bound:.4f} ms ({b / 1e6:.0f} MB)")
            del got
        c, o, w, t = formed[p]
        b = 4.0 * (c.numel() + o.numel()) + b - 4.0 * (c.numel() + v.numel())
        ms = median_ms(lambda: sw(c, o, w, taps=t), reps=20)
        print(f"[time] spread {p} (taps formed): this tree {ms:.4f} ms; "
              f"byte bound {b / HBM_BYTES_PER_S * 1e3:.4f} ms "
              f"({b / 1e6:.0f} MB)")

    want = fft_kernel.fft_conv_plain(fr, fi, filt, nfft, out_rows=rows)
    field = torch.complex(fr, fi)
    lib_ms = median_ms(lambda: torch.fft.ifft(
        torch.fft.fft(field, n=nfft, dim=-1) * filt, dim=-1), reps=20)
    num_p, pb = fr.shape[0], rows[1] - rows[0]
    n_bytes = 8.0 * fr.numel() + 8.0 * nfft + 8.0 * num_p * pb * 128
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    line = []
    for name, fn in (("this tree", conv),
                     ("conv one block an SM",
                      through(libs["conv one block an SM"], conv))):
        got = fn(fr, fi, filt, nfft, out_rows=rows)
        err = float((got - want).abs().max() / want.abs().max())
        if err > 3e-5:
            raise RuntimeError(f"{name}: conv rel err {err}")
        ms = median_ms(lambda: fn(fr, fi, filt, nfft, out_rows=rows),
                       reps=20)
        line.append(f"{name} {ms:.4f} ms ({ms / lib_ms:.2f}x the library, "
                    f"{bound / ms:.1%} of the bound, rel err {err:.2e})")
    if parent is not None and conv_redesigned(
            (Path(parent) / _build.SOURCE_DIR.relative_to(ROOT)
             / "fft_kernel.cu").read_text()):
        fn = through(libs["parent conv"], conv)
        got = fn(fr, fi, filt, nfft, out_rows=rows)
        err = float((got - want).abs().max() / want.abs().max())
        ms = median_ms(lambda: fn(fr, fi, filt, nfft, out_rows=rows),
                       reps=20)
        line.append(f"parent {ms:.4f} ms (rel err {err:.2e})")
    elif parent is not None:
        lib = libs["parent conv"]
        got = parent_conv(lib, frc, fic, filt, nfft, rows)
        err = float((got - want).abs().max() / want.abs().max())
        ms = median_ms(lambda: parent_conv(lib, frc, fic, filt, nfft, rows),
                       reps=20)
        copy_ms = median_ms(lambda: (fr.contiguous(), fi.contiguous()),
                            reps=20)
        line.append(f"parent {ms:.4f} ms on contiguous planes (rel err "
                    f"{err:.2e}), plus {copy_ms:.4f} ms for the two copies "
                    "it needs")
    print(f"[time] conv: " + "; ".join(line) + f"; torch.fft fft / multiply"
          f" / ifft {lib_ms:.4f} ms; byte bound {bound:.4f} ms "
          f"({n_bytes / 1e6:.0f} MB)")
    if parent is not None:
        compare_sass(libs["parent conv"]._name)


if __name__ == "__main__":
    main()
