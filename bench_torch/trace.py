"""The device trace of a traced window: torch.profiler over the products of
a steady part of the window, reduced to device intervals, the busy time,
and the ``breakdown`` of the result line.

``device_breakdown`` of ``chip_smoke.py`` (kernels by device time under
torch.profiler, busy as the kernels' summed self time on one stream) is the
piece copied here; the interval union and the idle gaps labelled by the
host's activity are this file's. The profiler records device activity
alone (with the CUDA runtime calls that come with it): recording every
PyTorch operator on the host as well slowed a GMTI CPI by 24 % and a
full-scale collect by 40 % on the H100, against 3 % and 7 % this way."""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field

TOP = 10


def bare_name(key: str) -> str:
    """A kernel's signature -> its name with template arguments, without
    'void', the anonymous namespace and the parameter list."""
    key = key.replace("(anonymous namespace)::", "")
    key = re.sub(r"^void ", "", key)
    depth, out = 0, []
    for ch in key:                      # cut at the first '(' outside <>
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        out.append(ch)
    return "".join(out).strip()


def base_name(key: str) -> str:
    """:func:`bare_name` without template arguments."""
    return bare_name(key).split("<")[0]


@dataclass
class DeviceTrace:
    """Device intervals (name, start_us, end_us) and host intervals (the
    runtime calls) of a traced window; the window's span on the trace's
    clock, its length on the host clock, the products completed in it."""

    device: list
    host: list
    window_us: tuple
    window_s: float
    products: int
    spans: dict = field(default_factory=dict)

    def kernels(self) -> list:
        """Device intervals of kernels (not copies or memsets)."""
        return [e for e in self.device if not is_copy(e[0])]

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran (interval union)."""
        return sum(b - a for a, b in merged(self.device)) / 1e6


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def merged(intervals) -> list:
    """Union of (name, a, b) intervals as sorted disjoint (a, b)."""
    out = []
    for _, a, b in sorted(intervals, key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def from_events(events, products: int, window_s: float,
                spans=None) -> DeviceTrace:
    """A DeviceTrace from profiler FunctionEvents (or any objects with
    ``name``, ``device_type`` and ``time_range.start/.end`` in us) of a
    window that lasted ``window_s`` on the host clock."""
    dev, host = [], []
    for e in events:
        a, b = float(e.time_range.start), float(e.time_range.end)
        if str(e.device_type).endswith("CUDA"):
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.name, a, b))
        else:
            host.append((e.name, a, b))
    ends = [x for ev in dev + host for x in ev[1:]]
    win = (min(ends), max(ends)) if ends else (0.0, window_s * 1e6)
    return DeviceTrace(dev, host, win, window_s, products, spans or {})


def device_ops(tr: DeviceTrace, top: int = TOP) -> list:
    """[name, seconds] of the device operations that took most time, by
    kernel name without template arguments."""
    tot = {}
    for n, a, b in tr.device:
        k = base_name(n)
        tot[k] = tot.get(k, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def idle_gaps(tr: DeviceTrace, top: int = TOP) -> list:
    """[host activity, seconds] of the device's idle time in the window,
    each gap labelled by the innermost host operation that was running at
    its midpoint ('python' where none was), summed by label."""
    busy = merged(tr.device)
    edges = [tr.window_us[0]] + [x for ab in busy for x in ab] \
        + [tr.window_us[1]]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    host = sorted(tr.host, key=lambda h: h[1])
    active, j, tot = [], 0, {}
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][1] <= mid:
            heapq.heappush(active, (-host[j][1], host[j][2], host[j][0]))
            j += 1
        while active and active[0][1] < mid:     # ended: gone for good
            heapq.heappop(active)
        label = active[0][2] if active else "python"
        tot[label] = tot.get(label, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def breakdown(tr: DeviceTrace) -> dict:
    return {"device_ops": device_ops(tr), "idle_gaps": idle_gaps(tr)}


def profile(on_card: bool = True):
    """A torch.profiler context over device activity (over the host's, for
    a rehearsal on the CPU, which has no device activity to record)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile
    return _profile(activities=[ProfilerActivity.CUDA if on_card
                                else ProfilerActivity.CPU])
