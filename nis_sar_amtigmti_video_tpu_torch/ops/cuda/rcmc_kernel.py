"""The RDA's range-cell migration correction and azimuth filter, one launch a
plane (``csrc/rcmc_kernel.cu``).

Replaces no TPU kernel: the JAX package's 'exact' RCMC
(``nis_sar_amtigmti_video_tpu/ops/rda.py::rcmc``) is a searchsorted and
gather over float64 grids in XLA, and H a separate product. For each
Doppler row (physical row p holds Doppler row (p + row_shift) mod n_az of
``fd``) the kernel forms delta_R = r fd^2 lam2 / den and H's phase
hk fd^2 r per cell in float64, resamples the row as the upstream's
interp1d from the source grid r - delta_R(r) and multiplies by H; it finds
each cell's interval in closed form where :func:`rcmc_filter_plain`, the
same RCMC and H in PyTorch, searches for it (``interp_nonuniform_src``, as
``ops/rda.py::rcmc``'s 'exact' mode).

:func:`rcmc_filter` runs the plain version on CPU tensors and launches the
kernel on CUDA tensors (or raises). Each launch adds one to
``rcmc_filter.launches``; each call counts its rows on ``rda.rcmc_rows``
and, under ``profiling.recording(device_counts=True)``, its zero-filled
cells on ``rda.rcmc_zeroed``, summed on the device.
"""

from __future__ import annotations

import math

import torch

from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build
from nis_sar_amtigmti_video_tpu_torch.ops.interp import interp_nonuniform_src
from nis_sar_amtigmti_video_tpu_torch.utils import profiling

TWO_PI = 2.0 * math.pi
INV_TWO_PI = 1.0 / TWO_PI


def row_factors(fd: torch.Tensor, n_az: int, row_shift: int, lam2: float,
                den: float, hk: float):
    """(g, hrow), each (n_az, 1) float64: delta_R = r g and H's phase
    r hrow of each physical row."""
    i = (torch.arange(n_az, device=fd.device) + row_shift) % n_az
    f = fd[i]
    fd2 = f * f
    return ((fd2 * lam2) / den)[:, None], (hk * fd2)[:, None]


def rcmc_filter_plain(rd: torch.Tensor, r: torch.Tensor, fd: torch.Tensor,
                      *, lam2: float, den: float, hk: float,
                      row_shift: int = 0):
    """Plain version of :func:`rcmc_filter`: (out, rcmc, zeroed), the RCMC
    times H, the RCMC alone and the count of zero-filled cells (0-d
    int64), on rd's device."""
    n_az, n = rd.shape
    g, hrow = row_factors(fd, n_az, row_shift, lam2, den, hk)
    x = r[None, :]
    src = x - x * g
    v = interp_nonuniform_src(src, rd, x.expand(n_az, n))
    zeroed = ((x < src[:, :1]) | (x > src[:, -1:])).sum()
    ph = x * hrow
    ph = (ph - TWO_PI * torch.round(ph * INV_TWO_PI)).to(torch.float32)
    out = v * torch.complex(torch.cos(ph), torch.sin(ph))
    return out, v, zeroed


def rcmc_filter(rd: torch.Tensor, r: torch.Tensor, fd: torch.Tensor, *,
                lam2: float, den: float, hk: float, row_shift: int = 0,
                keep: bool = False):
    """(n_az, n_rg) complex64 range-Doppler plane -> (its RCMC times H, its
    RCMC alone where ``keep``, else None), in the plane's layout (the
    kernel takes it row-major or column-major). ``r`` (n_rg,) and ``fd``
    (n_az,) float64 on rd's device."""
    n_az, n_rg = rd.shape
    profiling.count("rda.rcmc_rows", n_az)
    counting = profiling.device_counting()
    if _build.on_cpu(rd):
        out, v, zeroed = rcmc_filter_plain(rd, r, fd, lam2=lam2, den=den,
                                           hk=hk, row_shift=row_shift)
        if counting:
            profiling.count_device("rda.rcmc_zeroed", lambda: zeroed)
        return out, (v if keep else None)
    dev = rd.device
    # the card's azimuth FFT leaves the plane column-major
    cols = not rd.is_contiguous() and rd.t().is_contiguous()
    if n_rg < 2 or (-(-n_rg // 32) if cols else n_az) > 65535:
        raise ValueError(f"rcmc_filter takes planes of 2 or more cells a "
                         f"row and 65,535 rows (row-major) or 2,097,120 "
                         f"cells (column-major), got {(n_az, n_rg)}")
    _build.check("rcmc_filter", (rd.t() if cols else rd,),
                 (n_rg, n_az) if cols else (n_az, n_rg), dev,
                 torch.complex64)
    _build.check("rcmc_filter", (r,), (n_rg,), dev, torch.float64)
    _build.check("rcmc_filter", (fd,), (n_az,), dev, torch.float64)
    out = torch.empty_like(rd)
    v = torch.empty_like(rd) if keep else None
    zeroed = torch.zeros((), dtype=torch.int64, device=dev) \
        if counting else None
    _build.launch("rcmc_launch", (rd, out, v, r, fd, zeroed),
                  (n_az, n_rg, row_shift % n_az, int(cols)),
                  (), (lam2, den, hk))
    rcmc_filter.launches += 1
    if counting:
        profiling.count_device("rda.rcmc_zeroed", lambda: zeroed)
    return out, v


rcmc_filter.launches = 0
