#!/usr/bin/env python3
"""The benchmark of the PyTorch / CUDA port, one run of one cell:

    python3 bench_torch/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. Builds (or loads) the port's kernel library,
sets up the cell's inputs on the card from the seed, warms the cell's
shapes, then issues one product at a time for ``--seconds`` (``--trace 1``:
under torch.profiler, for a few seconds of it), checks the served outputs
against the plain reference once the window has closed, and prints one JSON
line last on standard output. Without a CUDA card, or with fewer than the
cell asks for, it exits with code 2 and prints no result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# a traced run profiles this much of the window (and at least the mix's
# ``trace_products``): enough products for steady per-layer numbers
TRACE_SECONDS = 3.0


def environment() -> None:
    """The process's settings, before torch and NumPy load: every build
    and kernel cache of the program at a fixed path in the checkout, one
    host thread for NumPy's and PyTorch's CPU work (the load of one
    process, no thread pools beside the launch path), the checkout's root
    on the import path."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    for v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[v] = "1"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    a = parse(argv)
    environment()
    import torch

    from bench_torch import core

    torch.set_num_threads(1)
    spec = core.load_spec()
    cell, _, cfg, traffic = core.resolve(spec, a.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        core.log(f"{a.workload} needs {cell['chips']} CUDA card(s); found "
                 f"{n}: no result")
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(dev)
    core.log(f"{a.workload}: {power_limit()}; torch {torch.__version__} "
             f"cuda {torch.version.cuda}")
    from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build
    _build.build()
    _build.library()
    line = run_cell(spec, a.workload, cfg, traffic, a.seed, a.seconds,
                    bool(a.trace), dev)
    print(line, flush=True)
    return 0


def run_cell(spec, workload, cfg, traffic, seed, seconds, traced, dev,
             t_start=None) -> str:
    """Set-up, warm-up, the window and the check of one run on ``dev``;
    returns the result line. The card's presence is the caller's to
    check (the CPU is for rehearsals of the harness alone)."""
    import torch

    from bench_torch import core, trace

    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (
        lambda: None)
    drv = core.kind_module(traffic).setup(cfg, traffic, core.seed64(seed),
                                          dev, trace=traced)
    drv.warm()
    sync()
    setup_s = time.perf_counter() - (T_START if t_start is None
                                     else t_start)
    core.log(f"set-up {setup_s:.3f} s")
    win = core.Window(drv, seconds)
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
              "count": 1}
    breakdown = None
    if not traced:
        elapsed = win.run()
        sync()
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        metrics = core.end_to_end(win, elapsed, peak, setup_s,
                                  core.cell_metrics(spec, "end_to_end",
                                                    workload))
    else:
        t_s = min(seconds, TRACE_SECONDS)
        n_min = int(traffic.get("trace_products", 3))
        with trace.profile(on_card) as prof:
            t0 = time.perf_counter()
            win.run(stop=lambda n, el: el >= t_s and n >= n_min)
            sync()
            elapsed = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        tr = trace.from_events(prof.events(), win.products, elapsed,
                               drv.spans)
        del prof
        metrics = {}
        for m in core.cell_metrics(spec, "per_layer", workload):
            v = core.metric_module(m["name"]).read(tr, drv.shapes)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = trace.breakdown(tr)
    device["memory_peak_bytes"] = int(peak)
    core.log(f"{win.products} products; peak {peak} bytes")
    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    checks = drv.check()
    correct = core.checks_ok(checks) and win.failed == 0
    core.log(core.checks_text(checks))
    return core.result_line(correct, win.products, win.failed,
                            metrics, device, checks, breakdown)


if __name__ == "__main__":
    sys.exit(main())
