#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from (run on the
card, from the root of a checkout; not part of a benchmark run):

    python3 bench_torch/readings.py --workload <cell> --seeds 1 2 3 ... \
        [--seconds 2] [--control 3]

For each seed: the cell's set-up, a short window at the cell's own load
(``--seconds``), then the numbers the check compares, of the program's
served outputs (the lower readings) and, on the first ``--control`` seeds,
of the control: the plain reference in bfloat16 put in the program's place
(the upper readings; ``--modes`` names the reference's modes to read, of
which 'bf16' is the control). One JSON line per seed, side and mode."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--modes", nargs="+", default=["bf16"])
    a = ap.parse_args(argv)
    import torch

    from bench_torch import core
    if not torch.cuda.is_available():
        core.log("readings: no CUDA card")
        return 2
    dev = torch.device("cuda", 0)
    spec = core.load_spec()
    _, _, cfg, traffic = core.resolve(spec, a.workload)
    kind = core.kind_module(traffic)
    for j, seed in enumerate(a.seeds):
        t = time.perf_counter()
        drv = kind.setup(cfg, traffic, core.seed64(seed), dev)
        drv.warm()
        win = core.Window(drv, a.seconds)
        win.run()
        torch.cuda.synchronize(dev)
        drv.release()
        t1 = time.perf_counter()
        nums = drv.numbers()
        t2 = time.perf_counter()
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "side": "program", "products": win.products,
                          "failed": win.failed, "numbers": nums,
                          "check_s": t2 - t1, "run_s": t1 - t}), flush=True)
        for mode in a.modes if j < a.control else ():
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "side": "control", "mode": mode,
                              "numbers": drv.numbers(mode)}), flush=True)
        del drv, win
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
