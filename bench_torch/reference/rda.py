"""Plain reference of single-channel stripmap focusing by the Range-Doppler
Algorithm: the upstream's sar_focus_rda (sar_satellite_sim.py:356-448),
step by step, on a (pulses, samples) raw:

1. range compression: each pulse convolved with the unit-norm conjugate
   chirp, Hamming-windowed (scipy's symmetric window), of
   floor(Tp fs) + 1 taps, in 'same' mode (np.convolve's), here through
   complex FFTs long enough for the linear convolution;
2. the azimuth Hamming window, then fftshift, the azimuth FFT and fftshift;
3. RCMC: each Doppler row fd resampled linearly from the source grid
   r - delta_R(r), delta_R = r fd^2 lam^2 / (8 V^2), at the range axis r,
   zero outside the source grid (interp1d with fill_value 0), the interval
   found by torch.searchsorted;
4. H = exp(-j pi fd^2 / Ka), Ka = 2 V^2 / (lam r);
5. ifftshift, the azimuth IFFT, ifftshift.

The range axis r is centred on 2 R_ref / c, the Doppler axis on 0, as the
upstream lays them out. Written in plain torch on the raw's device, in
blocks of rows or columns so that the complex128 planes fit beside the
program's; imports nothing of the port.

mode 'f64': complex128 throughout, float64 geometry and weights. mode
'bf16' (the control): each stage's plane, the filter, the windows and H
rounded to bfloat16, the stages computed in complex64. TF32 is off."""

from __future__ import annotations

import math

import torch

from bench_torch.reference import _precision as P
from bench_torch.reference.hrws import _no_tf32

C = 299792458.0
BLOCK = 512               # rows (or columns) a step


def axes(n_az: int, n_rg: int, r: dict, dev):
    """(range axis r (n_rg,), Doppler axis fd (n_az,)), float64: the
    upstream's fast-time axis centred on 2 R_ref / c, and the Doppler bins
    from -PRF / 2."""
    f64 = torch.float64
    t_ref = 2.0 * r["range_ref_m"] / C
    fast = (torch.arange(n_rg, dtype=f64, device=dev) - (n_rg // 2)) \
        / r["fs_hz"] + t_ref
    fd = (torch.arange(n_az, dtype=f64, device=dev) - (n_az // 2)) \
        * (r["prf_hz"] / n_az)
    return fast * C / 2.0, fd


def hamming(n: int, dev) -> torch.Tensor:
    if n == 1:
        return torch.ones(1, dtype=torch.float64, device=dev)
    m = torch.arange(n, dtype=torch.float64, device=dev)
    return 0.54 - 0.46 * torch.cos(2.0 * math.pi * m / (n - 1))


def matched_filter(r: dict, dev) -> torch.Tensor:
    """The upstream's reference chirp, complex128."""
    tp = r["pulse_width_s"]
    n = int(math.floor(tp * r["fs_hz"])) + 1
    t = torch.linspace(-tp / 2.0, tp / 2.0, n, dtype=torch.float64,
                       device=dev)
    mf = torch.polar(hamming(n, dev),
                     -math.pi * r["chirp_rate"] * t * t)
    return mf / torch.linalg.vector_norm(mf)


def focus(raw: torch.Tensor, r: dict, mode: str = "f64") -> torch.Tensor:
    """(n_az, n_rg) raw -> (n_az, n_rg) SLC (complex128; in 'bf16'
    complex64 of bfloat16 values). ``r``: wavelength_m, pulse_width_s,
    chirp_rate, fs_hz, prf_hz, velocity_mps (V_eff), range_ref_m."""
    P.check(mode)
    n_az, n_rg = raw.shape
    dev, ct = raw.device, P.ctype(mode)

    def q(x):
        return P.q(x, mode)

    with _no_tf32():
        mf = matched_filter(r, dev)
        n_mf = mf.shape[0]
        nfft = 1 << (n_rg + n_mf - 2).bit_length()
        spec_mf = q(torch.fft.fft(q(mf.to(ct)), n=nfft))
        start = (n_mf - 1) // 2
        win = q(hamming(n_az, dev).to(P.rtype(mode)))
        x = torch.empty((n_az, n_rg), dtype=ct, device=dev)
        for a in range(0, n_az, BLOCK):
            b = q(raw[a:a + BLOCK].to(ct))
            full = torch.fft.ifft(torch.fft.fft(b, n=nfft, dim=1) * spec_mf,
                                  dim=1)
            x[a:a + BLOCK] = q(q(full[:, start:start + n_rg])
                               * win[a:a + BLOCK, None])
            del b, full
        for c in range(0, n_rg, BLOCK):
            x[:, c:c + BLOCK] = q(torch.fft.fftshift(torch.fft.fft(
                torch.fft.fftshift(x[:, c:c + BLOCK], dim=0), dim=0), dim=0))
        rg, fd = axes(n_az, n_rg, r, dev)
        lam, v = r["wavelength_m"], r["velocity_mps"]
        ka = 2.0 * v * v / (lam * rg)
        for a in range(0, n_az, BLOCK):
            f = fd[a:a + BLOCK, None]
            src = rg[None, :] - rg[None, :] * f * f * lam * lam / (8.0 * v * v)
            xo = rg.expand(src.shape).contiguous()
            i0 = (torch.searchsorted(src.contiguous(), xo, right=True)
                  - 1).clamp(0, n_rg - 2)
            s0 = torch.gather(src, 1, i0)
            s1 = torch.gather(src, 1, i0 + 1)
            w = ((xo - s0) / (s1 - s0)).to(P.rtype(mode))
            row = x[a:a + BLOCK]
            y = torch.gather(row, 1, i0) * (1.0 - w) \
                + torch.gather(row, 1, i0 + 1) * w
            inside = (xo >= src[:, :1]) & (xo <= src[:, -1:])
            y = q(torch.where(inside, y, torch.zeros((), dtype=ct,
                                                     device=dev)))
            h = P.expj(-math.pi * f * f / ka[None, :], mode)
            x[a:a + BLOCK] = q(y * h)
            del src, xo, i0, s0, s1, w, y, inside, h
        for c in range(0, n_rg, BLOCK):
            x[:, c:c + BLOCK] = q(torch.fft.ifftshift(torch.fft.ifft(
                torch.fft.ifftshift(x[:, c:c + BLOCK], dim=0), dim=0),
                dim=0))
    return x
