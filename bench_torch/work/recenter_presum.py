"""Recentre + presum (``recenter_presum_kernel``): a CPI of raw pulses to
band rows of presummed, recentred pulses, the matched filter fused in.

Copied from ``chip_smoke.py``'s phase 6: the (cpi, ns) complex64 raw read
once, the (n_out, band) rows written once, the float64 trajectory (32 bytes
a pulse, 80 a group); an nfft FFT and 16 operations a bin a pulse, an
inverse FFT a group. The bytes bound it, just: 0.134 ms at
config.videosar()'s CPI (the operations 0.134 too)."""

from bench_torch.work._fft import fft_flops


def work(s: dict) -> dict:
    cpi, ns, nfft = s["cpi"], s["ns"], s["nfft"]
    n_out, band = s["n_out"], s["band"]
    return dict(n_bytes=8.0 * (cpi * ns + n_out * band) + 32.0 * cpi
                + 80.0 * n_out,
                n_flops=cpi * (fft_flops(nfft) + 16.0 * nfft)
                + n_out * fft_flops(nfft))
