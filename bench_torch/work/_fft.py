"""Shared counts."""

import math


def fft_flops(n: int) -> float:
    """Operations of one complex FFT of length n (the usual 5 n log2 n)."""
    return 5.0 * n * math.log2(n)
