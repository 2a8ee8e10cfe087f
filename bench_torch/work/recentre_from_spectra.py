"""Recentre from spectra (``recentre_spectra_kernel``): a CPI of cached
spectra to band rows of presummed, recentred pulses.

Copied from ``chip_smoke.py``'s phase 6: the (cpi, nfft) complex64 spectra
read once, the (n_out, band) rows written once, the float64 trajectory as
for recentre + presum; 10 operations a bin a pulse, an inverse FFT a group.
The bytes bound it: 0.199 ms at config.videosar()'s CPI."""

from bench_torch.work._fft import fft_flops


def work(s: dict) -> dict:
    cpi, nfft, n_out, band = s["cpi"], s["nfft"], s["n_out"], s["band"]
    return dict(n_bytes=8.0 * (cpi * nfft + n_out * band) + 32.0 * cpi
                + 80.0 * n_out,
                n_flops=cpi * 10.0 * nfft + n_out * fft_flops(nfft))
