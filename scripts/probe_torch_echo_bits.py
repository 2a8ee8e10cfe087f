#!/usr/bin/env python3
"""sha256 of the full-scale NUFFT echo's raw, for comparing two trees bit
for bit on one GPU.

    python3 scripts/probe_torch_echo_bits.py [--root DIR]

Imports ``chip_smoke`` and ``nis_sar_amtigmti_video_tpu_torch`` from DIR
(the checkout this script sits in unless given), builds its kernels there,
and runs ``chip_smoke.e2e_sim``: the channel-batched freq echo of the
full-scale two-channel collect (config.ati_dpca(), 2 x 7,200 x 13,200, the
destroyer turned by 90 degrees in 5,000 clutter points) on the card's
default spreader and conv. Prints one JSON line: the raw's shape and the
sha256 of its bytes, its first 512-pulse chunk's, and the spread launches
of each kind. Two trees whose echo computes the same bits print the same
digests. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.root).resolve()))
    import torch
    import chip_smoke
    from nis_sar_amtigmti_video_tpu_torch.ops.cuda import spread_kernel

    dev = torch.device("cuda", 0)
    sw = spread_kernel.spread_windows_pallas
    counters = ("launches", "launches_qr", "launches_taps")
    before = {k: getattr(sw, k, 0) for k in counters}
    raw = chip_smoke.e2e_sim(dev, chip_smoke.e2e_setup())
    torch.cuda.synchronize()
    host = raw.contiguous().cpu()

    def digest(t):
        return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()

    print(json.dumps({
        "root": a.root, "shape": list(host.shape),
        "sha256": digest(torch.view_as_real(host)),
        "first_chunk_sha256": digest(torch.view_as_real(host[:, :512])),
        "spread_launches": {k: getattr(sw, k, 0) - before[k]
                            for k in counters}}))


if __name__ == "__main__":
    main()
