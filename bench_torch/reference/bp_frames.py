"""Plain reference of a VideoSAR frame: time-domain backprojection of one
CPI of raw pulses onto the moving pixel grid.

The upstream sar_batch_sim.py's tdbp_gpu as the repo's float64 NumPy
oracle describes it (oracle/pipeline.py::focus_tdbp): FFT matched filter
with the conjugate spectrum of the fftshifted reference chirp at int(Tp fs)
points; the pixel grid linspace(-S/2, S/2, n) in x and y, moved by
v_focus (t - mean t); the radial-velocity Doppler re-centring
t_shift = -fc (2 v_rad / c) / Kr; the stop-and-go receive advance; linear
interpolation at (index - 0.5) with zeros outside; the phase
exp(j 2 pi fc tau); the coherent sum over pulses. Range-compressed pulses
are FFT-upsampled ``upsample`` times first, so the interpolation is that
of band-limited data (the fast backprojection's budget is held against
this, as the repo's tests hold it). Every pulse is used: no presum.

mode 'f64': everything in float64. mode 'bf16': what a float32 working
precision holds in float32 held in bfloat16: the pulses, the interpolated
samples, the phasors and each pixel's range relative to the pulse's range
to the moving scene origin (that range and the carrier phase it gives stay
float64, as the port's float32 path keeps them). mode 'bf16_data': the
raw pulses alone rounded to bfloat16, everything after in float64."""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_torch.reference import _precision as P

C = 299792458.0


def range_compress(raw: torch.Tensor, fc, kr, fs, tp) -> torch.Tensor:
    n = raw.shape[-1]
    n_ref = int(tp * fs)
    t_ref = np.linspace(-tp / 2.0, tp / 2.0, n_ref)
    ref = np.fft.fft(np.fft.fftshift(np.exp(1j * np.pi * kr * t_ref ** 2)),
                     n=n)
    ref_c = torch.as_tensor(np.conj(ref), device=raw.device)
    return torch.fft.ifft(torch.fft.fft(raw.to(torch.complex128), dim=-1)
                          * ref_c, dim=-1)


def upsample(rc: torch.Tensor, u: int) -> torch.Tensor:
    """Band-limited u-times upsampling of (P, n) rows, n even (the Nyquist
    bin split between the two halves)."""
    n = rc.shape[-1]
    h = n // 2
    s = torch.fft.fft(rc, dim=-1)
    su = torch.zeros(rc.shape[:-1] + (n * u,), dtype=s.dtype,
                     device=rc.device)
    su[..., :h] = s[..., :h]
    su[..., -h + 1:] = s[..., -h + 1:]
    su[..., h] = 0.5 * s[..., h]
    su[..., -h] = 0.5 * s[..., h]
    return torch.fft.ifft(su, dim=-1) * u


def frame(raw, pos, vel, t_slow, vel_focus, t_start: float, r: dict,
          mode: str = "f64", upsample_by: int = 8,
          block: int = 16) -> torch.Tensor:
    """(ny, nx) complex128 frame of a (P, Ns) raw CPI; pos / vel (P, 3),
    t_slow (P,), vel_focus (3,) float64 tensors on raw's device. ``r``:
    fc_hz, chirp_rate, fs_hz, pulse_width_s, nx, ny, scene_size_m."""
    if mode == "bf16_data":
        raw, mode = P.q(raw, "bf16"), "f64"
    P.check(mode)
    dev = raw.device
    f64 = torch.float64
    fc, kr, fs = r["fc_hz"], r["chirp_rate"], r["fs_hz"]
    u = upsample_by
    fs_u = fs * u
    t0_u = t_start + 0.5 * (u - 1) / (u * fs)
    s = r["scene_size_m"]
    x = torch.linspace(-s / 2.0, s / 2.0, r["nx"], dtype=f64, device=dev)
    y = torch.linspace(-s / 2.0, s / 2.0, r["ny"], dtype=f64, device=dev)
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.zeros_like(gx).reshape(-1)], dim=1)
    pos, vel, ts = (v.to(f64) for v in (pos, vel, t_slow))
    vf = vel_focus.to(f64)
    t_c = ts.mean()
    img = torch.zeros(grid.shape[0], dtype=torch.complex128, device=dev)
    for b0 in range(0, raw.shape[0], block):
        b1 = min(b0 + block, raw.shape[0])
        rc = range_compress(P.q(raw[b0:b1], mode), fc, kr, fs,
                            r["pulse_width_s"])
        rc = P.q(upsample(P.q(rc.to(P.ctype(mode)), mode).to(
            torch.complex128), u).to(P.ctype(mode)), mode)
        p_, v_ = pos[b0:b1, None, :], vel[b0:b1, None, :]
        org = vf[None, None, :] * (ts[b0:b1, None, None] - t_c)
        g = grid[None] + org                              # (B, N, 3)
        diff = g - p_
        if mode == "f64":
            d_tx = torch.linalg.vector_norm(diff, dim=-1)
        else:                   # |p - org| in f64, the rest relative, bf16
            d0 = torch.linalg.vector_norm(org - p_, dim=-1)
            g_rel = P.q((g - org).to(torch.float32), mode).to(f64)
            num = P.q(((g_rel * g_rel).sum(-1)
                       + 2.0 * (g_rel * (org - p_)).sum(-1)).to(
                           torch.float32), mode).to(f64)
            d_tx = d0 + P.q((num / (d0 + torch.sqrt(d0 * d0 + num))).to(
                torch.float32), mode).to(f64)
        r_unit = diff / d_tx[..., None]
        v_rad = ((v_ - vf) * r_unit).sum(-1)
        t_shift = -fc * (2.0 * v_rad / C) / kr
        tau_a = 2.0 * d_tx / C
        p_rx = p_ + v_ * tau_a[..., None]
        g_rx = g + vf * tau_a[..., None]
        d_rx = torch.linalg.vector_norm(g_rx - p_rx, dim=-1)
        tau = (d_tx + d_rx) / C
        idx = (tau - t0_u + t_shift) * fs_u - 0.5
        i0 = torch.floor(idx)
        w = (idx - i0).to(rc.real.dtype)
        i0 = i0.to(torch.int64)
        n_u = rc.shape[-1]

        def take(i):
            ok = (i >= 0) & (i < n_u)
            v = torch.gather(rc, 1, i.clamp(0, n_u - 1))
            return torch.where(ok, v, torch.zeros_like(v))

        samp = P.q((1.0 - w) * take(i0) + w * take(i0 + 1), mode)
        ph = P.expj((2.0 * math.pi * fc) * tau, mode)
        img += P.q(samp * ph, mode).sum(0).to(torch.complex128)
    return img.reshape(r["ny"], r["nx"])
