"""What the per-layer metric readers share: kernel selection by name in a
DeviceTrace and the roofline share of a kernel."""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

from bench_torch import peaks
from bench_torch.trace import DeviceTrace, bare_name

BENCH = Path(__file__).resolve().parent

# the port's hand-written kernels (csrc/*.cu), by name without template
# arguments; every other device kernel is a PyTorch operator's
HAND_WRITTEN = ("k1_kernel", "k2_kernel", "k3_kernel", "k3g_kernel",
                "k4_kernel", "balance_kernel", "forward_spectra_kernel",
                "recentre_spectra_kernel", "recenter_presum_kernel",
                "fft_conv_kernel", "accumulate_kernel",
                "spread_windows_kernel", "echo_accumulate_kernel")


def load(path: Path, name: str):
    """A module from a file, by path (a metric's name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def matching(tr: DeviceTrace, pattern: str) -> list:
    """Kernel intervals whose bare name (with template arguments) matches
    the regular expression ``pattern`` from its start."""
    rx = re.compile(pattern)
    return [k for k in tr.kernels() if rx.match(bare_name(k[0]))]


def is_hand_written(name: str) -> bool:
    return bare_name(name).split("<")[0] in HAND_WRITTEN


def roofline(tr: DeviceTrace, shapes: dict, pattern: str, work_name: str):
    """100 x the least time of one launch's work over the kernel's mean
    device time a launch, in %; None where the trace holds no launch or
    the cell has no shapes for it."""
    ks = matching(tr, pattern)
    s = shapes.get(work_name)
    if not ks or s is None:
        return None
    mean_ms = sum(b - a for _, a, b in ks) / len(ks) / 1e3
    w = load(BENCH / "work" / f"{work_name}.py", f"work_{work_name}").work(s)
    return 100.0 * peaks.bound_ms(**w) / mean_ms


def roofline_product(tr: DeviceTrace, shapes: dict, pattern: str,
                     work_name: str):
    """As :func:`roofline`, for a work module that counts all the launches
    of one product: its least time over the kernel's device time a
    product in the trace."""
    ks = matching(tr, pattern)
    s = shapes.get(work_name)
    if not ks or s is None or tr.products <= 0:
        return None
    per_product_ms = sum(b - a for _, a, b in ks) / tr.products / 1e3
    w = load(BENCH / "work" / f"{work_name}.py", f"work_{work_name}").work(s)
    return 100.0 * peaks.bound_ms(**w) / per_product_ms
