"""K1g (``k1_kernel<2, ...>``), all its launches of one CPI: the azimuth
DFT of both channels times Phi1, and the raw balance sums.

The function's work at the CPI's own length, whatever implements it:
the four (n_az, n_rg) float32 raw planes read once and the four planes
written once (8 planes; the balance sums' 2 n_rg floats beside them), an
n_az-point FFT (5 n log2 n) a column and channel. A chirp-z transform's
inner passes are the implementation's, not the function's, and count
against its share. ``shapes``: n_az, n_rg. The bound at 7,199 x 13,200:
0.908 ms (bytes, 3.04 GB)."""

from bench_torch.work._fft import fft_flops


def work(s: dict) -> dict:
    n_az, n_rg = s["n_az"], s["n_rg"]
    return dict(n_bytes=4.0 * n_az * n_rg * 8 + 8.0 * n_rg,
                n_flops=2.0 * n_rg * fft_flops(n_az))
