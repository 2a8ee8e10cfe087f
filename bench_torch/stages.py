#!/usr/bin/env python3
"""The port's stages on the device trace: each kernel put down to the
program span (``nis_sar_amtigmti_video_tpu_torch/utils/profiling.py``)
that was open when the host launched it, each idle gap to the span and
the runtime call open at its midpoint, and the stage readings of a cell.

    python3 bench_torch/stages.py --workload <cell> --seed <n> [--pairs 2]

runs one cell as ``run.py --trace 1`` does (the same set-up, warm-up and
traced window), ``--pairs`` times two traced windows in turn, one with the
program's recording off and one with it on, and prints one JSON line: each
window's product time and per-layer metrics, and for the recorded windows
the stage readings, the share of device time put down to a span, where
each named kernel was launched, the idle gaps by span and the span tree.
Without a CUDA card it exits with code 2 and prints no result.

A kernel is followed by its correlation id to the CUDA API call that
launched it (``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaLaunchKernelExC``; a copy or a memset to its ``cudaMemcpyAsync`` or
``cudaMemsetAsync``) and goes to the innermost span open at that call's
start. The spans are stamped on the clock kineto stamps its events with,
so the trace's start (``trace_start_ns``) lays them on it."""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_torch import trace  # noqa: E402

UNATTRIBUTED = "unattributed"
TOP = 16

# where each named kernel must be launched from
KERNEL_SPANS = {"spread_windows_kernel": ("echo.spread", "echo.edge"),
                "fft_conv_kernel": ("echo.conv",),
                "forward_spectra_kernel": ("segment.spectra",),
                "recentre_spectra_kernel": ("bp.recentre",),
                "accumulate_kernel": ("bp.accumulate",)}


def is_echo(name: str) -> bool:
    """The simulation's spans: the echo and its stages, a segment's echo
    and its noise."""
    return name == "echo" or name.startswith("echo.") \
        or name in ("segment.echo", "segment.noise")


def is_focus(name: str) -> bool:
    """The products' spans: the focus and its stages (full scale); a
    segment's spectra, a frame, its trajectory and its formation (ring)."""
    return name in ("focus", "segment.spectra", "frame", "frame.traj",
                    "frame.bp") or name.startswith(("focus.", "bp."))


@dataclass
class StageTrace:
    """A traced window with the program's spans on its clock: device
    intervals (name, start_us, end_us, span), the host's runtime calls
    (name, start_us, end_us), the spans (name, start_us, end_us), the
    window on the trace's clock, the products completed in it and the
    record's counters."""

    device: list
    host: list
    spans: list
    window_us: tuple
    products: int
    counters: dict


def program_spans(record, origin_ns: int) -> list:
    """The record's spans as (name, start_us, end_us) on the trace's clock
    (us after ``origin_ns``), in the order they opened."""
    return [(s.name, (s.start_ns - origin_ns) / 1e3,
             (s.end_ns - origin_ns) / 1e3)
            for s in sorted(record.spans, key=lambda s: (s.start_ns, s.id))]


def innermost(spans: list, times: list) -> list:
    """For each time, the name of the innermost span open then (None where
    none is). The spans of one thread nest, so the open ones form a
    stack."""
    out = [None] * len(times)
    sp = sorted(spans, key=lambda s: (s[1], -s[2]))
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(sp) and sp[j][1] <= t:
            while stack and stack[-1][2] < sp[j][1]:
                stack.pop()
            stack.append(sp[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


def from_events(events, record, origin_ns: int,
                products: int) -> StageTrace:
    """A StageTrace from profiler FunctionEvents (``name``, ``id``,
    ``device_type``, ``time_range`` in us after ``origin_ns``) and the
    program's record of the same window."""
    dev, host, launch = [], [], {}
    for e in events:
        a, b = float(e.time_range.start), float(e.time_range.end)
        if str(e.device_type).endswith("CUDA"):
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.name, a, b, e.id))
        else:
            host.append((e.name, a, b))
            if e.id > 0:
                launch[e.id] = a
    spans = program_spans(record, origin_ns)
    # a device event with no launch call in the window goes to no span
    at = [launch.get(i) for *_, i in dev]
    who = iter(innermost(spans, [t for t in at if t is not None]))
    device = [(n, a, b, (next(who) if t is not None else None)
               or UNATTRIBUTED) for (n, a, b, _), t in zip(dev, at)]
    ends = [x for ev in dev + host for x in ev[1:3]]
    win = (min(ends), max(ends)) if ends else (0.0, 0.0)
    return StageTrace(device, host, spans, win, products,
                      dict(record.counters))


def _gaps(st: StageTrace) -> list:
    """The device's idle (start_us, end_us) gaps in the window."""
    busy = trace.merged([d[:3] for d in st.device])
    edges = [st.window_us[0]] + [x for ab in busy for x in ab] \
        + [st.window_us[1]]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def labelled_gaps(st: StageTrace) -> list:
    """(span or None, runtime call or None, seconds) of each idle gap, by
    what was open at its midpoint: the innermost program span and the
    innermost runtime call."""
    gaps = _gaps(st)
    mids = [0.5 * (a + b) for a, b in gaps]
    spans = innermost(st.spans, mids)
    calls = innermost(st.host, mids)
    return [(s, c, (b - a) / 1e6) for (a, b), s, c in zip(gaps, spans,
                                                          calls)]


def idle_gaps(st: StageTrace, top: int = TOP) -> list:
    """[label, seconds] of the idle time summed by label, as
    ``trace.idle_gaps`` labels it ('python' where no runtime call was
    open), prefixed with the innermost program span where one was open:
    'bp.fit python', 'frame.fetch cudaStreamSynchronize'."""
    tot = {}
    for s, c, sec in labelled_gaps(st):
        label = c or "python"
        label = f"{s} {label}" if s else label
        tot[label] = tot.get(label, 0.0) + sec
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def device_ms(st: StageTrace, keep) -> float | None:
    """Device ms a product of the kernels (not copies) put down to a span
    that ``keep(name)`` takes; None where there are none."""
    ks = [b - a for n, a, b, s in st.device
          if s != UNATTRIBUTED and keep(s) and not trace.is_copy(n)]
    if not ks or st.products <= 0:
        return None
    return sum(ks) / 1e3 / st.products


def readings(st: StageTrace) -> dict:
    """The stage readings, each None where the window holds nothing to
    read: ``echo_device_ms`` and ``focus_device_ms`` (device ms a product
    of the simulation's and the products' kernels), ``host_gap_ms``
    (device-idle ms a product with a program span open and no runtime
    call: host Python holding the card back), ``fetch_wait_ms`` (host ms a
    product in ``frame.fetch``) and ``segments_per_frame`` (segments
    echoed a product)."""
    n = st.products
    out = {"echo_device_ms": device_ms(st, is_echo),
           "focus_device_ms": device_ms(st, is_focus),
           "host_gap_ms": None, "fetch_wait_ms": None,
           "segments_per_frame": None}
    if n <= 0:
        return out
    if st.spans and st.device:
        out["host_gap_ms"] = 1e3 * sum(sec for s, c, sec in
                                       labelled_gaps(st)
                                       if s and c is None) / n
    fetch = [b - a for name, a, b in st.spans if name == "frame.fetch"]
    if fetch:
        out["fetch_wait_ms"] = sum(fetch) / 1e3 / n
    if "segment.echoed" in st.counters:
        out["segments_per_frame"] = st.counters["segment.echoed"] / n
    return out


def attributed_share(st: StageTrace) -> float | None:
    """The share of the device time put down to some program span."""
    tot = sum(b - a for _, a, b, _ in st.device)
    if tot <= 0:
        return None
    return sum(b - a for _, a, b, s in st.device
               if s != UNATTRIBUTED) / tot


def launch_sites(st: StageTrace, kernels=KERNEL_SPANS) -> dict:
    """{kernel: {span: launches}} of the kernels named in ``kernels`` (by
    name without template arguments) found in the window."""
    out = {}
    for n, _, _, s in st.device:
        k = trace.base_name(n)
        if k in kernels:
            out.setdefault(k, {})
            out[k][s] = out[k].get(s, 0) + 1
    return out


def misplaced(sites: dict, kernels=KERNEL_SPANS) -> dict:
    """{kernel: launches} of the named kernels launched outside their
    spans."""
    return {k: sum(v for s, v in by.items() if s not in kernels[k])
            for k, by in sites.items()
            if any(s not in kernels[k] for s in by)}


def report(st: StageTrace, record) -> dict:
    """What a recorded window says of the cell's stages."""
    gaps = labelled_gaps(st)
    idle = sum(sec for *_, sec in gaps)
    bare = sum(sec for s, c, sec in gaps if s is None and c is None)
    sites = launch_sites(st)
    per = max(st.products, 1)
    return {"readings": readings(st),
            "attributed_share": attributed_share(st),
            "kernels": sites, "misplaced": misplaced(sites),
            "bare_python_idle_share": bare / idle if idle > 0 else None,
            "idle_gaps": idle_gaps(st),
            "tree": {k: [n / per, 1e3 * sec / per]
                     for k, (n, sec) in record.tree().items()},
            "counters": dict(record.counters)}


def trace_origin_ns(prof) -> int:
    """The profiler's trace start, in ns of the clock it stamps events
    with: its FunctionEvents' times are microseconds after it."""
    return int(prof.profiler.kineto_results.trace_start_ns())


def clock_check(dev) -> list:
    """The profiler's clock against the program's: a synchronise stamped
    by ``profiling.clock_ns`` on both sides, under the profiler. For each
    synchronise the profiler saw (the first is that one; the profiler's
    own stop may add one), [name, us from the first stamp to the call's
    start, us from its end to the second stamp]: both positive where the
    clocks agree."""
    import torch

    from nis_sar_amtigmti_video_tpu_torch.utils import profiling
    x = torch.ones(1 << 24, device=dev)
    with trace.profile(dev.type == "cuda") as prof:
        y = torch.cumsum(x, 0)
        t0 = profiling.clock_ns()
        torch.cuda.synchronize(dev)
        t1 = profiling.clock_ns()
    del y
    calls = sorted((e for e in prof.profiler.kineto_results.events()
                    if "Synchronize" in e.name()), key=lambda e: e.start_ns())
    return [[e.name(), (e.start_ns() - t0) / 1e3, (t1 - e.end_ns()) / 1e3]
            for e in calls]


def windows(spec, workload, cfg, traffic, seed, dev, pairs, seconds) -> dict:
    """Set-up and warm-up as run.py does, then ``pairs`` pairs of traced
    windows, recording off and on in turn (off first in even pairs)."""
    import contextlib
    import time

    import torch

    from bench_torch import core
    from nis_sar_amtigmti_video_tpu_torch.utils import profiling

    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (
        lambda: None)
    drv = core.kind_module(traffic).setup(cfg, traffic, core.seed64(seed),
                                          dev, trace=True)
    drv.warm()
    sync()
    n_min = int(traffic.get("trace_products", 3))
    wanted = core.cell_metrics(spec, "per_layer", workload)
    out = {"workload": workload, "seed": seed,
           "clock": clock_check(dev) if on_card else None, "windows": []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            for v in drv.spans.values():      # this window's host spans
                v.clear()
            win = core.Window(drv, seconds)
            with contextlib.ExitStack() as stack:
                rec = stack.enter_context(profiling.recording()) if on \
                    else None
                prof = stack.enter_context(trace.profile(on_card))
                t0 = time.perf_counter()
                win.run(stop=lambda n, el: el >= seconds and n >= n_min)
                sync()
                elapsed = time.perf_counter() - t0
            events = prof.events()
            tr = trace.from_events(events, win.products, elapsed, drv.spans)
            w = {"record": on, "products": win.products,
                 "product_ms": 1e3 * elapsed / win.products,
                 "busy_s": tr.busy_s, "window_s": tr.window_s,
                 "metrics": {m["name"]: core.metric_module(m["name"]).read(
                     tr, drv.shapes) for m in wanted}}
            if on:
                st = from_events(events, rec, trace_origin_ns(prof),
                                 win.products)
                w["stages"] = report(st, rec)
                w["device_ops"] = trace.device_ops(tr)
            out["windows"].append(w)
            del prof, events, tr
    drv.release()
    return out


def main(argv=None) -> int:
    import argparse
    import json

    from bench_torch import run
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=2)
    a = ap.parse_args(argv)
    run.environment()
    import torch

    from bench_torch import core
    torch.set_num_threads(1)
    spec = core.load_spec()
    cell, _, cfg, traffic = core.resolve(spec, a.workload)
    if not torch.cuda.is_available():
        core.log(f"{a.workload}: no CUDA card: no result")
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    core.log(f"{a.workload}: {run.power_limit()}; torch {torch.__version__}"
             f" cuda {torch.version.cuda}")
    from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build
    _build.build()
    _build.library()
    out = windows(spec, a.workload, cfg, traffic, a.seed, dev, a.pairs,
                  run.TRACE_SECONDS)
    out["device"] = {"kind": torch.cuda.get_device_name(dev),
                     "power": run.power_limit()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
