"""Range-Doppler Algorithm (RDA).

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/rda.py`` (the upstream's
``sar_focus_rda``, sar_satellite_sim.py:356-448):

    1. range compression   'same'-mode convolution with a Hamming-windowed
                           conjugate chirp, as one batched FFT convolution
    2. azimuth Hamming + (fftshift-bracketed) FFT -> range-Doppler
    3. RCMC                delta_R = R fd^2 lam^2 / (8 V^2); the upstream
                           resamples each Doppler row from the source grid
                           r - delta_R(r) with interp1d
    4. azimuth compression H = exp(-j pi fd^2 / Ka), Ka = 2 V^2 / (lam R)
    5. azimuth IFFT -> image

Layout (azimuth, range) = (pulses, samples), as the JAX package keeps it.

:func:`rcmc` is the JAX package's function on its grids, all four modes in
plain PyTorch. :func:`focus_rda` runs the 'exact' mode through
``ops/cuda/rcmc_kernel.py``: one launch a plane resamples every Doppler row
and applies H, forming delta_R and H's phase per cell in float64 (on CPU
tensors its plain version); the other modes run :func:`rcmc` and H. Since each row's RCMC and H are linear maps of
that row alone, the fftshifts around the azimuth transforms cancel: with
``intermediates=False`` the transforms run in natural FFT order, the kernel
reading Doppler row (p + n_az // 2) mod n_az at physical row p, and no
shifted copy of a plane is made. The viewer planes (``intermediates=True``)
keep the reference's shifted layout.

Stage record: ``focus.range``, ``focus.azimuth``, ``focus.rcmc`` (the
kernel), ``focus.compress`` (H where no kernel applies it, the azimuth
IFFT); counters ``rda.rcmc_rows`` (Doppler rows resampled) and, formed on
the device, ``rda.rcmc_zeroed`` (cells zero-filled because their source
lies outside the window).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.ops.cuda import rcmc_kernel
from nis_sar_amtigmti_video_tpu_torch.ops.interp import (
    interp_nonuniform_src, interp_uniform)
from nis_sar_amtigmti_video_tpu_torch.ops.windows import get_window
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import count, span

_TWO_PI = 2.0 * math.pi
_C = 299792458.0
RCMC_MODES = ("exact", "fast", "phase", "czt")


@dataclass(frozen=True)
class RdaParams:
    wavelength_m: float
    pulse_width_s: float
    chirp_rate: float
    fs_hz: float
    prf_hz: float
    velocity_mps: float
    range_ref_m: float        # group reference range (centres the range axis)
    num_pulses: int
    num_samples: int
    range_window: str = "hamming"
    azimuth_window: str = "hamming"
    rcmc_mode: str = "exact"  # 'exact' (interp1d semantics) | 'fast' (one
                              # gather) | 'phase' (Fourier shift a row) |
                              # 'czt' (affine resample a row)


class RdaProducts(NamedTuple):
    """The SLC and the planes the upstream saves for its viewers
    (sar_satellite_sim.py:483-500), layout (azimuth, range); the four
    viewer planes are None where :func:`focus_rda` was asked for none."""

    image: torch.Tensor                  # complex SLC
    compressed: Optional[torch.Tensor]   # after range compression
    rd_map: Optional[torch.Tensor]       # range-Doppler, before RCMC
    rd_rcmc: Optional[torch.Tensor]      # after RCMC
    rd_az_comp: Optional[torch.Tensor]   # after the azimuth matched filter


def rda_axes(p: RdaParams):
    """(range_axis_m, range_axis_centered, cross_range_m, doppler_freq_hz),
    numpy float64."""
    n_rg, n_az = p.num_samples, p.num_pulses
    t_ref = 2.0 * p.range_ref_m / _C
    if n_rg % 2 == 0:
        fast = (np.arange(n_rg) - n_rg / 2) / p.fs_hz + t_ref
    else:
        fast = (np.arange(n_rg) - (n_rg - 1) / 2) / p.fs_hz + t_ref
    if n_az % 2 == 0:
        slow = (np.arange(n_az) - n_az / 2) / p.prf_hz
        fd = np.arange(-n_az / 2, n_az / 2) * (p.prf_hz / n_az)
    else:
        slow = (np.arange(n_az) - (n_az - 1) / 2) / p.prf_hz
        fd = np.arange(-(n_az - 1) / 2, (n_az - 1) / 2 + 1) * (p.prf_hz / n_az)
    r = fast * _C / 2.0
    return r, r - r.mean(), p.velocity_mps * slow, fd


def matched_filter(p: RdaParams, device=None) -> torch.Tensor:
    """Hamming-windowed, unit-norm conjugate chirp, complex64
    (sar_satellite_sim.py:378-384): formed in float64, cast once."""
    n_mf = int(np.floor(p.pulse_width_s * p.fs_hz)) + 1
    t = np.linspace(-p.pulse_width_s / 2.0, p.pulse_width_s / 2.0, n_mf)
    h = get_window(p.range_window, n_mf, dtype=torch.float64).numpy()
    mf = np.exp(-1j * np.pi * p.chirp_rate * t ** 2) * h
    mf = mf / np.linalg.norm(mf)
    return torch.as_tensor(mf.astype(np.complex64), device=device)


def range_nfft(n_rg: int, n_mf: int) -> int:
    """The range FFT length: the power of two at or above the linear
    convolution's n_rg + n_mf - 1 points."""
    return 1 << (n_rg + n_mf - 2).bit_length()


@functools.lru_cache(maxsize=4)
def _filter_spectrum(p: RdaParams, n_rg: int, device) -> torch.Tensor:
    mf = matched_filter(p, device)
    return torch.fft.fft(mf, n=range_nfft(n_rg, mf.shape[0]))


def _compressed_full(phist: torch.Tensor, p: RdaParams):
    """(the 'full' convolution on nfft points, the 'same' slice's start)."""
    n_rg = phist.shape[-1]
    f = _filter_spectrum(p, n_rg, phist.device)
    spec = torch.fft.fft(phist, n=f.shape[0], dim=-1)
    spec *= f
    full = torch.fft.ifft(spec, dim=-1)
    n_mf = int(np.floor(p.pulse_width_s * p.fs_hz)) + 1
    return full, (n_mf - 1) // 2


def range_compress(phist: torch.Tensor, p: RdaParams) -> torch.Tensor:
    """'same'-mode linear convolution along range through one batched FFT.

    phist: (..., n_az, n_rg) complex64. Equal to np.convolve(row, mf,
    'same') per pulse."""
    full, start = _compressed_full(phist, p)
    return full[..., start:start + phist.shape[-1]].contiguous()


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return x - _TWO_PI * torch.round(x / _TWO_PI)


def rda_grids(p: RdaParams, device=None):
    """The geometry's grids: (delta_R (n_az, n_rg) float64, the azimuth
    filter H (n_az, n_rg) complex64, range_axis (n_rg,) float64), rows in
    the reference's shifted Doppler order."""
    r, _, _, fd = rda_axes(p)
    r = torch.as_tensor(r, device=device)
    fd = torch.as_tensor(fd, device=device)
    delta_r = (r[None, :] * fd[:, None] ** 2 * p.wavelength_m ** 2
               / (8.0 * p.velocity_mps ** 2))
    ka = 2.0 * p.velocity_mps ** 2 / (p.wavelength_m * r)
    hphase = _wrap(-math.pi * fd[:, None] ** 2 / ka[None, :]).to(
        torch.float32)
    return delta_r, torch.complex(torch.cos(hphase), torch.sin(hphase)), r


class RcmcTables(NamedTuple):
    """What the RCMC kernel forms delta_R and H from: the range axis r
    (n_rg,) and the Doppler axis fd (n_az,, shifted order), float64 on the
    device; delta_R = r fd^2 lam2 / den, H's phase hk fd^2 r."""

    r: torch.Tensor
    fd: torch.Tensor
    lam2: float           # lam^2
    den: float            # 8 V^2
    hk: float             # -pi lam / (2 V^2)


@functools.lru_cache(maxsize=8)
def rcmc_tables(p: RdaParams, device) -> RcmcTables:
    """The kernel's tables, built once per (params, device) and kept."""
    r, _, _, fd = rda_axes(p)
    v2 = p.velocity_mps ** 2
    return RcmcTables(torch.as_tensor(r, device=device),
                      torch.as_tensor(fd, device=device),
                      p.wavelength_m ** 2, 8.0 * v2,
                      -math.pi * p.wavelength_m / (2.0 * v2))


def phase_rcmc_inrow_cells(p: RdaParams) -> float:
    """Largest variation of the RCM shift within one Doppler row, in range
    cells. ``rcmc_mode='phase'`` takes the shift as constant along a row,
    which holds while this is << 1. delta_R is linear in R, so the in-row
    spread is the swath's extent times the same factor at the highest
    Doppler."""
    dr = _C / (2.0 * p.fs_hz)
    extent_m = p.num_samples * dr
    f_dmax = p.prf_hz / 2.0
    k = (p.wavelength_m * f_dmax) ** 2 / (8.0 * p.velocity_mps ** 2)
    return extent_m * k / dr


def rcmc(rd: torch.Tensor, delta_r: torch.Tensor, range_axis: torch.Tensor,
         mode: str = "exact") -> torch.Tensor:
    """Range-cell migration correction of (..., n_az, n_rg) range-Doppler
    data on the grids of :func:`rda_grids`, in plain PyTorch.

    'exact': the reference's semantics, each Doppler row resampled from
    the source grid r - delta_R(r) (sar_satellite_sim.py:417-427).
    'fast': a uniform gather at r + delta_R(r).
    'phase': a constant shift a row (at the swath's centre) as a Fourier
    phase ramp; edges wrap circularly.
    'czt': each row's affine resample by chirp-z evaluation (ops/czt.py);
    cells whose source lies outside the window are zeroed."""
    if mode not in RCMC_MODES:
        raise ValueError(f"unknown rcmc mode {mode!r}; options: "
                         f"{', '.join(RCMC_MODES)}")
    n = rd.shape[-1]
    count("rda.rcmc_rows", int(np.prod(rd.shape[:-1])))
    dr = range_axis[1] - range_axis[0]
    if mode == "czt":
        from nis_sar_amtigmti_video_tpu_torch.ops.czt import czt_eval
        # delta_R(row, r) = k_row r -> u(j) = j (1 + k_row) + r0 k_row / dr
        k_row = delta_r[..., -1] / range_axis[-1]
        step = 1.0 + k_row
        start = range_axis[0] * k_row / dr
        out = czt_eval(rd, n, step[:, None], start)
        u = start[:, None] + step[:, None] * torch.arange(
            n, dtype=torch.float64, device=rd.device)
        return torch.where((u >= 0.0) & (u <= n - 1.0), out,
                           torch.zeros((), dtype=out.dtype,
                                       device=out.device))
    if mode == "phase":
        s = delta_r[..., n // 2:n // 2 + 1] / dr
        f = torch.fft.fftfreq(n, dtype=torch.float64, device=rd.device)
        ramp_phase = _wrap(_TWO_PI * f[None, :] * s).to(torch.float32)
        ramp = torch.complex(torch.cos(ramp_phase), torch.sin(ramp_phase))
        return torch.fft.ifft(torch.fft.fft(rd, dim=-1) * ramp, dim=-1)
    if mode == "fast":
        base = torch.arange(n, dtype=torch.float64, device=rd.device)
        u = base[None, :] + delta_r / dr
        return interp_uniform(rd, u.expand(rd.shape))
    src = range_axis[None, :] - delta_r
    return interp_nonuniform_src(src.expand(rd.shape), rd,
                                 range_axis.expand(rd.shape))


def focus_rda(phist: torch.Tensor, p: RdaParams, *,
              intermediates: bool = True) -> RdaProducts:
    """The RDA chain on (n_az, n_rg) complex64 raw, on its device.

    'exact' runs the RCMC and H in ``rcmc_kernel.rcmc_filter`` (the kernel
    on CUDA tensors, its plain version on the CPU); 'fast', 'phase' and
    'czt' run :func:`rcmc` and H in PyTorch. ``intermediates=False`` keeps
    no viewer plane and runs the azimuth transforms without fftshifts
    (module docstring)."""
    if p.rcmc_mode not in RCMC_MODES:
        raise ValueError(f"unknown rcmc mode {p.rcmc_mode!r}; options: "
                         f"{', '.join(RCMC_MODES)}")
    if p.rcmc_mode == "phase":
        spread = phase_rcmc_inrow_cells(p)
        if spread > 0.5:
            raise ValueError(
                f"rcmc_mode='phase' models RCM as constant per Doppler row, "
                f"but this geometry varies {spread:.2f} cells across the "
                f"swath; use 'fast' or 'exact'")
    n_az, n_rg = p.num_pulses, p.num_samples
    dev = phist.device
    kernel = p.rcmc_mode == "exact"
    # natural FFT order where nothing shows the shifted planes
    natural = kernel and not intermediates
    with span("focus.range"):
        full, start = _compressed_full(phist, p)
        compressed = full[..., start:start + n_rg]
    with span("focus.azimuth"):
        win = get_window(p.azimuth_window, n_az, device=dev)[:, None]
        if intermediates:
            compressed = compressed.contiguous()
            windowed = compressed * win
        else:
            windowed = compressed * win
            compressed = None
        del full
        if natural:
            rd = torch.fft.fft(windowed, dim=-2)
        else:
            rd = torch.fft.fftshift(torch.fft.fft(
                torch.fft.fftshift(windowed, dim=-2), dim=-2), dim=-2)
        del windowed
    with span("focus.rcmc"):
        if kernel:
            t = rcmc_tables(p, dev)
            rd_ac, rd_rcmc = rcmc_kernel.rcmc_filter(
                rd, t.r, t.fd, lam2=t.lam2, den=t.den, hk=t.hk,
                row_shift=n_az // 2 if natural else 0, keep=intermediates)
            if not intermediates:
                rd = None
        else:
            delta_r, h, range_axis = rda_grids(p, dev)
            rd_rcmc = rcmc(rd, delta_r, range_axis, p.rcmc_mode)
    with span("focus.compress"):
        if not kernel:
            rd_ac = rd_rcmc * h
        if natural:
            image = torch.fft.ifft(rd_ac, dim=-2)
        else:
            image = torch.fft.ifftshift(torch.fft.ifft(
                torch.fft.ifftshift(rd_ac, dim=-2), dim=-2), dim=-2)
    if not intermediates:
        return RdaProducts(image, None, None, None, None)
    return RdaProducts(image=image, compressed=compressed, rd_map=rd,
                       rd_rcmc=rd_rcmc, rd_az_comp=rd_ac)
