"""Time-domain backprojection (TDBP) — moving-grid (mBP) and standard BP.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/bp.py``: FFT matched-filter
range compression, then per pixel/pulse: moving-grid shift
g + v_focus*(t - t_mean), radial-velocity Doppler re-centering
t_shift = -fc*(2 v_rad/c)/Kr, stop-and-go Rx advance, fractional-sample
lookup at (index - 0.5) with zero fill (grid_sample semantics), phase
rotation exp(j*2*pi*fc*tau), coherent pulse sum.

Ranges are d = d0 + delta with d0 = |p| a per-pulse float64 scalar folded
into a wrapped carrier, and delta = (|g|^2 - 2 g.p) / (2 d0 + delta1) (one
Newton refinement) in the working precision: float32 by default,
``precision='f64'`` for the golden checks. The reference's ``lax.scan`` over
pulse blocks is a Python loop here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.ops.interp import interp_uniform

_TWO_PI = 2.0 * math.pi
_C = 299792458.0


@dataclass(frozen=True)
class BpParams:
    fc_hz: float
    chirp_rate: float
    fs_hz: float
    pulse_width_s: float
    num_samples: int
    nx: int = 512
    ny: int = 512
    scene_size_m: float = 500.0
    pulse_block: int = 16
    precision: str = "f32"   # 'f32' (delta-range fast path) | 'f64' (tests)


def expj(phase: torch.Tensor) -> torch.Tensor:
    """exp(j * phase) for a real tensor (complex64 from float32)."""
    return torch.complex(torch.cos(phase), torch.sin(phase))


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return x - _TWO_PI * torch.round(x / _TWO_PI)


def _f64(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def reference_chirp_conj(p: BpParams, n: int) -> np.ndarray:
    """Conjugate spectrum at length ``n`` of the reference chirp sampled at
    int(Tp*fs) points and fftshifted (host numpy, complex64)."""
    n_ref = int(p.pulse_width_s * p.fs_hz)
    t_ref = np.linspace(-p.pulse_width_s / 2.0, p.pulse_width_s / 2.0, n_ref)
    ref = np.exp(1j * np.pi * p.chirp_rate * t_ref ** 2)
    ref_f = np.fft.fft(np.fft.fftshift(ref), n=n)
    return np.conj(ref_f).astype(np.complex64)


def bp_range_compress(raw: torch.Tensor, p: BpParams) -> torch.Tensor:
    """FFT matched filter at the native length (a circular convolution)."""
    ref_conj = torch.from_numpy(reference_chirp_conj(p, p.num_samples)).to(
        raw.device)
    return torch.fft.ifft(torch.fft.fft(raw, dim=-1) * ref_conj, dim=-1)


def pixel_grid(p: BpParams) -> np.ndarray:
    """(nx*ny, 3) float64 pixel centers, row-major in y."""
    x = np.linspace(-p.scene_size_m / 2.0, p.scene_size_m / 2.0, p.nx)
    y = np.linspace(-p.scene_size_m / 2.0, p.scene_size_m / 2.0, p.ny)
    gx, gy = np.meshgrid(x, y, indexing="xy")
    return np.stack([gx.ravel(), gy.ravel(), np.zeros(p.nx * p.ny)], axis=1)


@lru_cache(maxsize=None)
def pixel_grid_on(p: BpParams, device: torch.device) -> torch.Tensor:
    """:func:`pixel_grid` as a float64 tensor on ``device``, built and
    copied once per (params, device): the droop correction reads it every
    frame. Shared: never written in place; kept for the process's life,
    since a captured frame graph (``bp_fast._FrameGraph``) reads it by
    address."""
    return torch.from_numpy(pixel_grid(p)).to(device)


def backproject(rc: torch.Tensor, sat_pos, sat_vel, t_slow, vel_focus,
                t_start, p: BpParams, t_mean=None) -> torch.Tensor:
    """Backproject range-compressed data onto the (moving) pixel grid.

    rc: (P, Ns) complex64 range-compressed pulses on the working device;
    sat_pos/sat_vel (P, 3), t_slow (P,), vel_focus (3,): float64 (tensors or
    arrays); t_start: receive-window opening time; t_mean: moving-grid
    reference time (default mean(t_slow)). Returns (ny, nx) complex64.
    """
    dev = rc.device
    ft = torch.float64 if p.precision == "f64" else torch.float32
    pos = _f64(sat_pos, dev)
    vel = _f64(sat_vel, dev)
    ts = _f64(t_slow, dev)
    vf64 = _f64(vel_focus, dev)
    num_p = pos.shape[0]

    d0 = torch.linalg.norm(pos, dim=1)
    carrier0 = _wrap((_TWO_PI * p.fc_hz) * (2.0 * d0 / _C)).to(ft)
    toff = (2.0 * d0 / _C - float(t_start)).to(ft)
    t_ref_grid = ts.mean() if t_mean is None else _f64(t_mean, dev)
    dt = (ts - t_ref_grid).to(ft)
    pos_f, vel_f, vf = pos.to(ft), vel.to(ft), vf64.to(ft)
    d0_f = d0.to(ft)
    g0 = torch.from_numpy(pixel_grid(p)).to(device=dev, dtype=ft)
    k_doppler = -p.fc_hz * 2.0 / (_C * p.chirp_rate)
    k_phase = _TWO_PI * p.fc_hz / _C

    pb = max(1, min(p.pulse_block, num_p))
    img = torch.zeros((p.nx * p.ny,), dtype=torch.complex64, device=dev)
    for b0 in range(0, num_p, pb):
        sl = slice(b0, min(b0 + pb, num_p))
        pos_b, vel_b, d0_b = pos_f[sl], vel_f[sl], d0_f[sl]
        g = g0[None, :, :] + vf[None, None, :] * dt[sl][:, None, None]
        gp = torch.sum(g * pos_b[:, None, :], dim=-1)
        g2 = torch.sum(g * g, dim=-1)
        num = g2 - 2.0 * gp
        d1 = num / (2.0 * d0_b[:, None])
        delta = num / (2.0 * d0_b[:, None] + d1)
        d_tx = d0_b[:, None] + delta

        u = g - pos_b[:, None, :]
        v_rel = vel_b[:, None, :] - vf[None, None, :]
        v_rad = torch.sum(v_rel * u, dim=-1) / d_tx
        t_shift = k_doppler * v_rad

        tau_a = 2.0 * d_tx / _C
        w_vec = (vf[None, None, :] - vel_b[:, None, :]) * tau_a[..., None]
        uw = 2.0 * torch.sum(u * w_vec, dim=-1) + torch.sum(w_vec * w_vec,
                                                            dim=-1)
        drx1 = uw / (2.0 * d_tx)
        delta_rx = uw / (2.0 * d_tx + drx1)

        dtau = (2.0 * delta + delta_rx) / _C
        idx = (toff[sl][:, None] + dtau + t_shift) * p.fs_hz - 0.5
        samp = interp_uniform(rc[sl], idx.to(torch.float32))
        phase = carrier0[sl][:, None] + k_phase * (2.0 * delta + delta_rx)
        phase = _wrap(phase)
        contrib = samp * expj(phase.to(torch.float32))
        img = img + torch.sum(contrib, dim=0).to(torch.complex64)
    return img.reshape(p.ny, p.nx)


def presum_factor(p: BpParams, prf_hz: float, wavelength_m: float,
                  slant_range_m: float, velocity_mps: float) -> int:
    """Largest safe azimuth-presum factor for this scene geometry: the
    decimated rate PRF/D keeps a 3.5x margin over the residual Doppler of a
    scene-corner pixel, 2 V (diag/2) / (lambda R)."""
    diag = p.scene_size_m * math.sqrt(2.0)
    f_corner = (2.0 * velocity_mps * (diag / 2.0)
                / (wavelength_m * slant_range_m))
    if f_corner <= 0:
        return 1
    return max(1, int(prf_hz / (3.5 * f_corner)))


def presum_droop_correction(sat_pos, sat_vel, t_slow, vel_focus,
                            p: BpParams, d: int, device=None):
    """(ny, nx) float32 map undoing the box presum's per-pixel sinc droop
    sinc(pi f D / PRF), f the pixel's residual Doppler at the CPI centre;
    clipped at 3x."""
    dev = device if device is not None else (
        sat_pos.device if isinstance(sat_pos, torch.Tensor) else None)
    pos, vel = _f64(sat_pos, dev), _f64(sat_vel, dev)
    ts, vf = _f64(t_slow, dev), _f64(vel_focus, dev)
    num_p = ts.shape[0]
    c = num_p // 2
    lam = _C / p.fc_hz
    prf = (num_p - 1) / (ts[-1] - ts[0])
    dtc = ts[c] - ts.mean()
    org = vf * dtc
    g = pixel_grid_on(p, pos.device) + org[None, :]
    ug = pos[c][None, :] - g
    ug = ug / torch.linalg.norm(ug, dim=-1, keepdim=True)
    u0 = pos[c] - org
    u0 = u0 / torch.linalg.norm(u0)
    v_rel = vel[c] - vf
    f_res = (2.0 / lam) * (ug @ v_rel - torch.dot(u0, v_rel))
    x = math.pi * f_res * d / prf
    safe = torch.where(torch.abs(x) < 1e-6, torch.ones_like(x), x)
    corr = torch.where(torch.abs(x) < 1e-6, torch.ones_like(x),
                       safe / torch.sin(safe))
    corr = torch.clamp(corr, -3.0, 3.0)
    return corr.reshape(p.ny, p.nx).to(torch.float32)


def _ramp(phase64: torch.Tensor) -> torch.Tensor:
    return expj(_wrap(phase64).to(torch.float32))


def presum_recenter(rc: torch.Tensor, sat_pos, sat_vel, t_slow, vel_focus,
                    t_start, p: BpParams, d: int):
    """Coherent azimuth presum by ``d``: recentre every pulse to the moving
    scene origin (FFT fractional-delay shift + wrapped carrier removal),
    box-average blocks of ``d``, then re-insert the block-centre pulse's
    delay and carrier. Returns (rc2, pos2, vel2, t2) with ceil(P/d) pulses
    (trajectory outputs float64 on rc's device)."""
    dev = rc.device
    pos, vel = _f64(sat_pos, dev), _f64(sat_vel, dev)
    ts, vf = _f64(t_slow, dev), _f64(vel_focus, dev)
    num_p, ns = rc.shape
    dt = ts - ts.mean()
    org = vf[None, :] * dt[:, None]
    d0 = torch.linalg.norm(pos - org, dim=1)

    p_pad = -(-num_p // d) * d
    w = torch.zeros((p_pad,), dtype=torch.float32, device=dev)
    w[:num_p] = 1.0
    edge = torch.arange(p_pad, device=dev).clamp(max=num_p - 1)
    rc_p = rc[edge]
    d0_p = d0[edge]

    t_ref = 2.0 * d0.mean() / _C
    shift = (2.0 * d0_p / _C - t_ref) * p.fs_hz
    nfft = 1 << (ns - 1).bit_length()
    f_bins = torch.fft.fftfreq(nfft, dtype=torch.float64, device=dev)
    car = _TWO_PI * (2.0 * p.fc_hz / _C) * d0_p

    spec = torch.fft.fft(rc_p, n=nfft, dim=-1)
    spec = spec * _ramp(_TWO_PI * f_bins[None, :] * shift[:, None])
    rc_c = torch.fft.ifft(spec, dim=-1) * _ramp(car)[:, None]

    wb = w.reshape(-1, d).to(torch.complex64)
    rc_b = (rc_c.reshape(-1, d, nfft) * wb[:, :, None]).sum(dim=1) / d

    ci = (torch.arange(p_pad // d, device=dev) * d + d // 2).clamp(
        max=num_p - 1)
    d0_c = d0[ci]
    shift_c = (2.0 * d0_c / _C - t_ref) * p.fs_hz
    car_c = _TWO_PI * (2.0 * p.fc_hz / _C) * d0_c
    spec_b = torch.fft.fft(rc_b, dim=-1)
    spec_b = spec_b * _ramp(-_TWO_PI * f_bins[None, :] * shift_c[:, None])
    rc2 = torch.fft.ifft(spec_b, dim=-1)[:, :ns] * _ramp(-car_c)[:, None]
    return rc2.to(torch.complex64), pos[ci], vel[ci], ts[ci]


def focus_bp(raw: torch.Tensor, sat_pos, sat_vel, t_slow, vel_focus,
             t_start, p: BpParams, presum: int = 1) -> torch.Tensor:
    """Range compression + backprojection; ``presum > 1`` decimates slow
    time first (:func:`presum_recenter`) and rescales by ``presum``."""
    rc = bp_range_compress(raw, p)
    if presum > 1:
        corr = presum_droop_correction(sat_pos, sat_vel, t_slow, vel_focus,
                                       p, presum, device=raw.device)
        rc, pos, vel, ts = presum_recenter(rc, sat_pos, sat_vel, t_slow,
                                           vel_focus, t_start, p, presum)
        return presum * corr * backproject(rc, pos, vel, ts, vel_focus,
                                           t_start, p)
    return backproject(rc, sat_pos, sat_vel, t_slow, vel_focus, t_start, p)
