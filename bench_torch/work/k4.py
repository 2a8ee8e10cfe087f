"""K4 (``k4_kernel``), its launch of one CPI: the range halves of the
CFAR box sums, noise, SNR, the masked ATI phase and |dpca|.

The function's work: five (n_az, n_rg) float32 planes read once (the two
azimuth box sums, the power, the ATI phase, |s1|^2) and four written once
(SNR, phase, |dpca|, noise): 9 planes. ``shapes``: n_az, n_rg. The bound
at 7,199 x 13,200: 1.021 ms (bytes, 3.42 GB)."""


def work(s: dict) -> dict:
    n_az, n_rg = s["n_az"], s["n_rg"]
    return dict(n_bytes=4.0 * n_az * n_rg * 9)
