"""Chirp Scaling Algorithm (CSA) focusing — the grid-free fused form.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/csa.py`` (its ``CsaParams``,
``CsaFactors``, ``csa_factors``, ``apply_csa_fused`` and ``csa_axes``).

    az-FFT -> Phi1 (chirp scaling) -> rg-FFT -> Phi2 (range compression +
    bulk RCMC) -> rg-IFFT -> Phi3 (azimuth compression + residual) -> az-IFFT

* No fftshifts: the phase functions are evaluated on natural ``fftfreq``
  order, which gives the same output as the reference's shifted grids.
* Every 2-D phase is built inline from 1-D factors (:class:`CsaFactors`):
  row and column terms are wrapped mod 2*pi in float64 at setup and cast to
  float32; every cross term stays within a few thousand rad, safe in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, NamedTuple

import numpy as np
import torch

_TWO_PI = 2.0 * math.pi
_C = 299792458.0


@dataclass(frozen=True)
class CsaParams:
    """Static focusing parameters (hashable)."""

    wavelength_m: float
    chirp_rate: float        # K_r [Hz/s]
    fs_hz: float
    prf_hz: float
    velocity_mps: float      # effective platform velocity V_eff
    range_ref_m: float       # reference (mid-swath) range R_ref
    t_start_fast: float      # receive-window opening time [s]
    num_pulses: int
    num_samples: int


class CsaFactors(NamedTuple):
    """Decomposed 1-D phase factors (float32 tensors on one device).

    Phi1 = c1(a) * (u(r) - w(a))^2          u = tau - 2R_ref/c (small)
    Phi2 = alpha(a)*fr^2 + beta(a)*fr       alpha = pi/(Kr(1+Cs)),
                                            beta = 4pi*R_ref*Cs/c
    Phi3 = rphase(a) + cphase(r) + g(a)*dr(r) - c3(a)*u^2
           rphase = wrap(4pi*R_ref*D/lam), cphase = wrap(4pi*dr/lam),
           g = (4pi/lam)(D-1), c3 = pi*Kr*Cs*(1+Cs), dr = c*u/2
    """

    u: torch.Tensor        # (n_rg,) tau - 2R_ref/c
    fr: torch.Tensor       # (n_rg,)
    dr: torch.Tensor       # (n_rg,) delta range c*u/2
    cphase: torch.Tensor   # (n_rg,) wrapped 4*pi*dr/lam
    c1: torch.Tensor       # (n_az,)
    w: torch.Tensor        # (n_az,)
    alpha: torch.Tensor    # (n_az,)
    beta: torch.Tensor     # (n_az,)
    rphase: torch.Tensor   # (n_az,) wrapped 4*pi*R_ref*D/lam
    g: torch.Tensor        # (n_az,) (4*pi/lam)*(D-1)
    c3: torch.Tensor       # (n_az,)


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return x - _TWO_PI * torch.round(x / _TWO_PI)


def _fftfreq64(n: int, d: float) -> torch.Tensor:
    """Natural-order FFT frequencies in float64 (k / (d*n), as the
    reference computes them)."""
    k = torch.cat([torch.arange(0, (n - 1) // 2 + 1, dtype=torch.float64),
                   torch.arange(-(n // 2), 0, dtype=torch.float64)])
    return k / (d * n)


def csa_factors(p: CsaParams, device=None) -> CsaFactors:
    """The 1-D factors, computed in float64 on the host, wrapped, then cast
    to float32 and placed on ``device``."""
    n_az, n_rg = p.num_pulses, p.num_samples
    lam, kr, vr, r_ref = (p.wavelength_m, p.chirp_rate, p.velocity_mps,
                          p.range_ref_m)
    f64 = torch.float64
    tau = p.t_start_fast + torch.arange(n_rg, dtype=f64) / p.fs_hz
    fr = _fftfreq64(n_rg, 1.0 / p.fs_hz)
    fa = _fftfreq64(n_az, 1.0 / p.prf_hz)

    arg = 1.0 - (lam * fa / (2.0 * vr)) ** 2
    d_fa = torch.sqrt(torch.where(arg < 0.0, torch.full_like(arg, 1e-9), arg))
    cs = 1.0 / d_fa - 1.0

    u = tau - 2.0 * r_ref / _C
    dr = _C * u / 2.0

    def f32(x):
        return x.to(device=device, dtype=torch.float32)

    return CsaFactors(
        u=f32(u), fr=f32(fr), dr=f32(dr),
        cphase=f32(_wrap((4.0 * math.pi / lam) * dr)),
        c1=f32(-math.pi * kr * cs),
        w=f32((2.0 * r_ref / _C) * cs),
        alpha=f32(math.pi / (kr * (1.0 + cs))),
        beta=f32((4.0 * math.pi / _C) * r_ref * cs),
        rphase=f32(_wrap((4.0 * math.pi / lam) * r_ref * d_fa)),
        g=f32((4.0 * math.pi / lam) * (d_fa - 1.0)),
        c3=f32(math.pi * kr * cs * (1.0 + cs)),
    )


def csa_factors_from_numpy(d: Mapping[str, np.ndarray],
                           device=None) -> CsaFactors:
    """Factors given as numpy arrays by field name (e.g. the reference
    package's ``CsaFactors._asdict()`` fetched to the host) -> the port's
    float32 tensors, bit for bit."""
    return CsaFactors(**{
        k: torch.tensor(np.asarray(d[k], np.float32), device=device)
        for k in CsaFactors._fields})


def expj(phase: torch.Tensor) -> torch.Tensor:
    """exp(j * phase) for a real float32 tensor, as complex64."""
    return torch.complex(torch.cos(phase), torch.sin(phase))


def apply_csa_fused(phist: torch.Tensor, f: CsaFactors) -> torch.Tensor:
    """Grid-free CSA: (..., n_az, n_rg) complex64 raw -> SLC, with the
    phases generated inline from the 1-D factors (torch.fft throughout)."""
    u, fr = f.u[None, :], f.fr[None, :]
    s = torch.fft.fft(phist, dim=-2)
    du = u - f.w[:, None]
    s = s * expj(f.c1[:, None] * du * du)
    s = torch.fft.fft(s, dim=-1)
    s = s * expj((f.alpha[:, None] * fr + f.beta[:, None]) * fr)
    s = torch.fft.ifft(s, dim=-1)
    s = s * expj(f.rphase[:, None] + f.cphase[None, :]
                  + f.g[:, None] * f.dr[None, :]
                  - f.c3[:, None] * u * u)
    return torch.fft.ifft(s, dim=-2)


def csa_axes(p: CsaParams):
    """(range_axis_m, cross_range_m) as numpy float64, matching the
    reference outputs (sar_ati_dcpa_sim_csa.py:388-394)."""
    tau = p.t_start_fast + np.arange(p.num_samples) / p.fs_hz
    r_vec = _C * tau / 2.0
    t_slow = np.arange(p.num_pulses) / p.prf_hz
    t_slow -= t_slow.mean()
    return r_vec, t_slow * p.velocity_mps
