"""The harness: the spec in BENCHMARK.json, the files it names found by
name, the measured window, and the result line.

A cell (``workloads`` entry) names a configuration (``configs``: its
``file`` under bench_torch/configs/) and a traffic mix, read from
bench_torch/traffic/<traffic>.json. The mix names its product ``kind``,
the general generator in bench_torch/kinds/<kind>.py that sets up the
cell's inputs from the seed and issues one product at a time; every other
entry of the mix is a parameter of that generator. A per-layer metric is
read by bench_torch/metrics/<name>.py, a kernel's work is
bench_torch/work/<kernel>.py. Adding a cell, a configuration or a metric
is adding files and BENCHMARK.json entries."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def resolve(spec: dict, workload: str) -> tuple:
    """(cell, configuration entry, configuration file, traffic mix)."""
    cell = find(spec["workloads"], workload, "workload")
    centry = find(spec["configs"], cell["config"], "config")
    cfg = json.loads((ROOT / centry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return cell, centry, cfg, traffic


def cell_metrics(spec: dict, section: str, workload: str) -> list:
    """The entries of ``section`` that this cell reports."""
    return [m for m in spec[section]
            if "workloads" not in m or workload in m["workloads"]]


def kind_module(traffic: dict):
    from bench_torch.readers import load
    name = traffic["kind"]
    return load(BENCH / "kinds" / f"{name}.py", f"bench_kind_{name}")


def metric_module(name: str):
    from bench_torch.readers import load
    return load(BENCH / "metrics" / f"{name}.py", f"bench_metric_{name}")


def seed64(seed: int) -> int:
    """Any whole number -> a non-negative 64-bit seed."""
    return int(seed) % (1 << 64)


class Window:
    """Products issued one at a time, each when the previous one's served
    result is on the host, for ``seconds`` of the host clock."""

    def __init__(self, drv, seconds: float):
        self.drv, self.seconds = drv, seconds
        self.latencies, self.failed = [], 0
        # a call that serves several products (frames) counts each
        self.units = getattr(drv, "units", 1)

    @property
    def products(self) -> int:
        """Products served so far (a call's every frame counts)."""
        return len(self.latencies) * self.units

    def run(self, stop=None) -> float:
        """Issue products until ``seconds`` have passed (or ``stop(n,
        elapsed)`` says so); returns the elapsed seconds, first issue to
        last served result."""
        lat, i = self.latencies, len(self.latencies)
        t_start = time.perf_counter()
        while True:
            t = time.perf_counter()
            served = self.drv.product(i)
            t_done = time.perf_counter()
            lat.append(t_done - t)
            if not self.drv.served_ok(served):
                self.failed += self.units
            i += 1
            el = t_done - t_start
            if (stop(i, el) if stop is not None else el >= self.seconds):
                return el


def end_to_end(window: Window, elapsed: float, peak_bytes: int,
               setup_s: float, wanted: list) -> dict:
    n = window.products
    vals = {"product_ms": (1e3 * elapsed / n, "ms"),
            "peak_mem_gib": (peak_bytes / 2 ** 30, "GiB"),
            "setup_s": (setup_s, "s")}
    return {m["name"]: {"value": vals[m["name"]][0], "unit": m["unit"]}
            for m in wanted}


def checks_ok(checks: list) -> bool:
    return all(v == v and v <= lim for _, v, lim in checks)


def checks_text(checks: list) -> str:
    return "\n".join(f"check {n}: {v!r} (limit {lim!r})"
                     for n, v, lim in checks)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: list, breakdown=None) -> str:
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return json.dumps(line)


def log(*a):
    print(*a, file=sys.stderr, flush=True)
