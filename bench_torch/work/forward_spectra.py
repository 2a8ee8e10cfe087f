"""Forward spectra (``forward_spectra_kernel``): raw pulses to their
matched-filtered nfft-point spectra.

Copied from ``chip_smoke.py``'s phase 6: the (pulses, ns) complex64 raw
read once, the (pulses, nfft) complex64 spectra written once; an nfft FFT
and 6 operations a bin a pulse. The bytes bound it: 0.327 ms at 2,500
pulses of config.videosar() (ns 22,004, nfft 32,768), 0.065 at the ring
path's 500."""

from bench_torch.work._fft import fft_flops


def work(s: dict) -> dict:
    p, ns, nfft = s["pulses"], s["ns"], s["nfft"]
    return dict(n_bytes=8.0 * p * (ns + nfft),
                n_flops=p * (fft_flops(nfft) + 6.0 * nfft))
