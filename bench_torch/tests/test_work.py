"""The work arithmetic of bench_torch/work/ held to the bound column of
PERF.md's table of kernels at the main path's shapes."""

import pytest

from bench_torch import peaks
from bench_torch.readers import load, BENCH

# config.videosar(): CPI 2,500 x 22,004, nfft 32,768, presum 4, band rows
# (82, 97) of the 64-sample-window plan, 1,664 x 640 accumulate grid
VIDEO = dict(cpi=2500, ns=22004, nfft=32768, n_out=625, band=15 * 128)
CASES = [
    ("recentre_from_spectra", VIDEO, 0.199),
    ("forward_spectra", dict(pulses=2500, ns=22004, nfft=32768), 0.327),
    ("forward_spectra", dict(pulses=500, ns=22004, nfft=32768), 0.065),
    ("accumulate", dict(num_p=625, w=64, ny=1664, ncols=640, rows=15),
     2.065),
    # the full-scale chain's first chunk: cells (512, 16, 315); main values
    # (512, 16, 1, 16, 315) at win 4,096, edge (512, 16, 2, 12, 315) at
    # 2,048 (chip_smoke.py phase 10)
    ("spread", dict(chunks=1, launches=[
        [512, 16, 512 * 16 * 315, 512 * 16 * 16 * 315, 1, 16, 4096,
         512 * 16 * 300],
        [512, 16, 512 * 16 * 315, 512 * 16 * 2 * 12 * 315, 2, 12, 2048,
         512 * 16 * 300]]), 0.290),
    ("fft_conv", dict(total_rows=512, launches=1, l_imp=50420, nfft=65536,
                      band=394 - 187), 0.094),
]


def work(name):
    return load(BENCH / "work" / f"{name}.py", f"work_{name}").work


@pytest.mark.parametrize("name,shapes,want_ms", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_bound_matches_perf_table(name, shapes, want_ms):
    got = peaks.bound_ms(**work(name)(shapes))
    assert got == pytest.approx(want_ms, rel=6e-3, abs=6e-4)


def test_accumulate_bound_is_the_tensor_cores():
    w = work("accumulate")(dict(num_p=625, w=64, ny=1664, ncols=640,
                                rows=15))
    assert peaks.bound_by(**w) == "operations"
    f32 = peaks.bound_ms(w["n_bytes"], w["n_flops"] + w["n_tc"] / 3.0)
    assert f32 == pytest.approx(5.420, rel=5e-3)
