"""K3g (``k3g_kernel<...>``), all its launches of one CPI: the inverse
azimuth DFT of both channels and every product plane from it.

The function's work at the CPI's own length, whatever implements it: the
four (n_az, n_rg) float32 planes read once and nine written once (s1, s2,
the ATI phase, |s1|^2, the DPCA power and the two azimuth box sums: 13
planes; the n_rg column peaks beside them), an n_az-point FFT (5 n log2 n)
a column and channel. ``shapes``: n_az, n_rg. The bound at 7,199 x
13,200: 1.475 ms (bytes, 4.94 GB)."""

from bench_torch.work._fft import fft_flops


def work(s: dict) -> dict:
    n_az, n_rg = s["n_az"], s["n_rg"]
    return dict(n_bytes=4.0 * n_az * n_rg * 13 + 4.0 * n_rg,
                n_flops=2.0 * n_rg * fft_flops(n_az))
