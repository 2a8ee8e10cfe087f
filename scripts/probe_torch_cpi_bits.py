#!/usr/bin/env python3
"""sha256 of the GMTI CPI kernels' outputs, for comparing two trees bit for
bit on one GPU.

    python3 scripts/probe_torch_cpi_bits.py [--root DIR] [--n 4096]
                                             [--n-rg N_RG]

Imports ``nis_sar_amtigmti_video_tpu_torch`` from DIR (the checkout this
script sits in unless given), builds its kernels there, and runs K1g, the
K2 pair, K3g and K4 in a chain on seeded (n, n_rg) planes (n_rg = n unless
given) with the slice waveform's CSA factors (BW 120 MHz, fs 150 MHz), each
kernel fed the one before, and the split route's K1, K2 single and K3 on the
first channel in a chain of their own. K1g's planes and its two balance sums
are hashed apart ("K1g planes", "K1g sums"), and K3g takes its calibration
from the raw balance kernel, so that a change in the sums' order of
summation does not reach K3g's and K4's bits. Prints one JSON line: the
sha256 of each kernel's output tensors, in order. Two trees whose kernels
compute the same bits print the same line. Needs a CUDA device.
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
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--n-rg", type=int, default=None)
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.root).resolve()))
    import numpy as np
    import torch
    from nis_sar_amtigmti_video_tpu_torch.gmti.cfar import CfarParams
    from nis_sar_amtigmti_video_tpu_torch.ops import csa
    from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (csa_kernel,
                                                           gmti_kernel)

    dev, n = torch.device("cuda", 0), a.n
    n_rg = a.n_rg or n
    f = csa.csa_factors(csa.CsaParams(
        wavelength_m=0.031, chirp_rate=120e6 / 2e-6, fs_hz=150e6,
        prf_hz=6000.0, velocity_mps=7600.0, range_ref_m=6e5,
        t_start_fast=2 * 6e5 / 299792458.0 - 2e-6, num_pulses=n,
        num_samples=n_rg), dev)
    rng = np.random.default_rng(0)
    x = [torch.from_numpy(rng.standard_normal((n, n_rg), dtype=np.float32))
         .to(dev) for _ in range(4)]
    cp = CfarParams()
    h_out, h_in = cp.guard + cp.train, cp.guard

    def digest(ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    k1 = gmti_kernel.k1_gmti_planes(*x, f)
    out["K1g planes"] = digest(k1[:4])
    out["K1g sums"] = digest(k1[4:])
    k2 = csa_kernel.k2_pair_call(*k1[:4], f)
    out["K2 pair"] = digest(k2)
    xs = gmti_kernel.raw_balance(*x)
    out["balance"] = digest(xs)
    cal = torch.atan2(xs[1], xs[0])
    cal_cs = torch.stack([torch.cos(cal), torch.sin(cal)])
    k3 = gmti_kernel.k3_gmti_planes(*k2, cal_cs, h_out=h_out, h_in=h_in)
    out["K3g"] = digest(k3)
    k4 = gmti_kernel.k4_epilogue_planes(k3[7], k3[8], k3[6], k3[4], k3[5],
                                        0.05 ** 2 * k3[9].max(),
                                        h_out=h_out, h_in=h_in)
    out["K4"] = digest(k4)
    del k1, k2, k3, k4
    z = csa_kernel.k1_call(x[0], x[1], f)
    out["K1"] = digest(z)
    z = csa_kernel.k2_call(*z, f)
    out["K2 single"] = digest(z)
    out["K3"] = digest(csa_kernel.k3_call(*z))
    print(json.dumps({"n": n, "n_rg": n_rg, "root": a.root, "sha256": out}))


if __name__ == "__main__":
    main()
