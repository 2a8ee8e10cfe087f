"""K2 single (``k2_kernel<...>`` on one channel), all its launches of one
plane: per azimuth row the range DFT, x Phi2, the inverse DFT, x Phi3.

The function's work at the plane's own length, whatever implements it:
the two (n_az, n_rg) float32 planes read once and two written once (4
planes), two n_rg-point FFTs (5 n log2 n each) a row, and the two phases'
sin and cos a point. ``shapes``: n_az, n_rg. The bound at 7,199 x 13,200:
0.454 ms (bytes, 1.52 GB)."""

from bench_torch.work._fft import fft_flops


def work(s: dict) -> dict:
    n_az, n_rg = s["n_az"], s["n_rg"]
    return dict(n_bytes=4.0 * n_az * n_rg * 4,
                n_flops=2.0 * n_az * fft_flops(n_rg),
                n_sfu=2.0 * n_az * n_rg * 2)
