"""Chirp-Z evaluation of trigonometric interpolants (Bluestein, FFT-only).

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/czt.py`` on ``torch.fft``:
when the evaluation positions form an arithmetic progression
``start + step*k``, the periodic sinc interpolant is evaluated exactly with
three FFTs (Bluestein's nk = (n^2 + k^2 - (k-n)^2) / 2). Chirp phases are
computed in float64 and wrapped mod 2*pi before the float32 cast.
"""

from __future__ import annotations

import math

import torch

_TWO_PI = 2.0 * math.pi


def _expj_wrapped(phase64: torch.Tensor) -> torch.Tensor:
    ph = (phase64 - _TWO_PI * torch.round(phase64 / _TWO_PI)).to(
        torch.float32)
    return torch.complex(torch.cos(ph), torch.sin(ph))


def czt_eval(x: torch.Tensor, n_out: int, step, start,
             axis: int = -1) -> torch.Tensor:
    """Evaluate the periodic trig interpolant of ``x`` at ``start + step*k``.

    x: (..., N, ...) complex samples on the integer grid 0..N-1 along
    ``axis``; positions are in sample units. Returns (..., n_out, ...) with

        out[k] = (1/N) sum_m X[m] exp(j 2 pi f_m (start + step k))

    where X = DFT(x) and f_m are the signed bin frequencies. ``start`` may
    be an array broadcasting against x's non-``axis`` dims (shaped like x
    with ``axis`` moved last and dropped): a per-slice start comes free.
    """
    dev = x.device
    f64 = torch.float64
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    xs = torch.fft.fftshift(torch.fft.fft(x, dim=-1), dim=-1) / n
    m = torch.arange(n, dtype=f64, device=dev) - n // 2

    theta = _TWO_PI * torch.as_tensor(step, dtype=f64, device=dev) / n
    phi = (_TWO_PI / n) * (torch.as_tensor(start, dtype=f64,
                                           device=dev)[..., None] * m)

    j = torch.arange(n, dtype=f64, device=dev)
    a = xs * _expj_wrapped(phi + 0.5 * theta * j * j)
    k = torch.arange(n_out, dtype=f64, device=dev)
    out_chirp = _expj_wrapped(0.5 * theta * k * k - theta * (n // 2) * k)

    # linear convolution of a (len n) with the even chirp over lags
    # d = k - j in [-(n-1), n_out-1], filled asymmetrically in the circle
    nfft = 1 << (n + n_out - 2).bit_length()
    d = torch.arange(nfft, dtype=f64, device=dev)
    d = torch.where(d >= n_out, d - nfft, d)
    b = _expj_wrapped(-0.5 * theta * d * d)
    conv = torch.fft.ifft(torch.fft.fft(a, n=nfft, dim=-1)
                          * torch.fft.fft(b), dim=-1)
    out = conv[..., :n_out] * out_chirp
    return torch.movedim(out.to(x.dtype), -1, axis)
