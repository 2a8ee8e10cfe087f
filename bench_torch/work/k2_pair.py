"""K2 pair (``k2_kernel<...>`` on both channels), all its launches of one
CPI: per azimuth row and channel the range DFT, x Phi2, the inverse DFT,
x Phi3.

The function's work at the CPI's own length, whatever implements it: the
four (n_az, n_rg) float32 planes read once and four written once (8
planes), two n_rg-point FFTs (5 n log2 n each) a row and channel, and the
two phases' sin and cos a point and channel. ``shapes``: n_az, n_rg. The
bound at 7,199 x 13,200: 0.908 ms (bytes, 3.04 GB)."""

from bench_torch.work._fft import fft_flops


def work(s: dict) -> dict:
    n_az, n_rg = s["n_az"], s["n_rg"]
    return dict(n_bytes=4.0 * n_az * n_rg * 8,
                n_flops=2.0 * n_az * 2 * fft_flops(n_rg),
                n_sfu=2.0 * n_az * n_rg * 2 * 2)
