"""The NUFFT echo's FFT convolution (``fft_conv_kernel``), all launches of
one two-channel pass.

Copied from ``chip_smoke.py``'s phase 10, per launch of ``rows`` field
rows: the (rows, l_imp) float32 real and imaginary field planes and the
nfft complex filter read once, the rows' band of ``band`` 128-sample
blocks written once as complex64; an nfft FFT forward and back and a
multiply (10 nfft log2 nfft + 6 nfft operations) a row. ``shapes``:
total_rows, launches, l_imp, nfft, band. PERF.md's bound: 0.094 ms a
512-row chunk (0.32 GB)."""

import math


def work(s: dict) -> dict:
    n, nfft = s["total_rows"], s["nfft"]
    return dict(n_bytes=8.0 * n * s["l_imp"] + 8.0 * nfft * s["launches"]
                + 8.0 * n * s["band"] * 128,
                n_flops=n * (10.0 * nfft * math.log2(nfft) + 6.0 * nfft))
