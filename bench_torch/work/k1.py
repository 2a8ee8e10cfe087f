"""K1 (``k1_kernel<1, ...>``), all its launches of one plane: the azimuth DFT
of one channel times Phi1.

The function's work at the plane's own length, whatever implements it:
the two (n_az, n_rg) float32 raw planes read once and the two planes
written once (4 planes), an n_az-point FFT (5 n log2 n) a column. A chirp-z
transform's inner passes are the implementation's, not the function's,
and count against its share. ``shapes``: n_az, n_rg. The bound at 7,199 x
13,200: 0.454 ms (bytes, 1.52 GB)."""

from bench_torch.work._fft import fft_flops


def work(s: dict) -> dict:
    n_az, n_rg = s["n_az"], s["n_rg"]
    return dict(n_bytes=4.0 * n_az * n_rg * 4,
                n_flops=1.0 * n_rg * fft_flops(n_az))
