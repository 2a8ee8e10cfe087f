"""Gather-based linear interpolation.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/interp.py``:
``interp_uniform`` (ops/bp.py, the RDA's 'fast' RCMC) and
``interp_nonuniform_src`` (the RDA's 'exact' RCMC), as vectorized index
arithmetic plus ``torch.gather`` in place of the reference's
``take_along_axis``.
"""

from __future__ import annotations

import torch


def interp_uniform(sig: torch.Tensor, u: torch.Tensor, *,
                   fill_zero: bool = True) -> torch.Tensor:
    """Sample complex/real ``sig`` (..., N) at fractional positions ``u``
    (..., M) on its own uniform index grid; linear, zero outside [0, N-1].

    Matches grid_sample(align_corners=False) semantics when the caller
    passes u = index - 0.5.
    """
    n = sig.shape[-1]
    i0 = torch.floor(u)
    w = (u - i0).to(torch.float32)
    i0 = i0.to(torch.int64)
    lead = torch.broadcast_shapes(sig.shape[:-1], u.shape[:-1])
    src = sig.expand(*lead, n)

    def take(idx):
        idx = idx.expand(*lead, idx.shape[-1])
        v = torch.gather(src, -1, idx.clamp(0, n - 1))
        if fill_zero:
            ok = (idx >= 0) & (idx <= n - 1)
            v = torch.where(ok, v, torch.zeros((), dtype=sig.dtype,
                                               device=sig.device))
        return v

    return take(i0) * (1.0 - w) + take(i0 + 1) * w


def interp_nonuniform_src(x_src: torch.Tensor, y_src: torch.Tensor,
                          x_out: torch.Tensor) -> torch.Tensor:
    """Linear interpolation from a non-uniform ascending source grid:
    scipy's ``interp1d(x_src, y_src, kind='linear', fill_value=0,
    bounds_error=False)`` at ``x_out`` (the upstream's RCMC resampler,
    sar_satellite_sim.py:422-424).

    x_src: (..., N) ascending; y_src: (..., N) values; x_out: (..., M); the
    leading dimensions are the same for the three (one grid a row). The
    weights are cast to float32, as the reference casts them."""
    n = x_src.shape[-1]
    # the interval: largest i with x_src[i] <= x_out
    idx = torch.searchsorted(x_src.contiguous(), x_out.contiguous(),
                             right=True) - 1
    i0 = idx.clamp(0, n - 2)
    x0 = torch.gather(x_src, -1, i0)
    x1 = torch.gather(x_src, -1, i0 + 1)
    w = ((x_out - x0) / (x1 - x0)).to(torch.float32)
    out = (torch.gather(y_src, -1, i0) * (1.0 - w)
           + torch.gather(y_src, -1, i0 + 1) * w)
    ok = (x_out >= x_src[..., :1]) & (x_out <= x_src[..., -1:])
    return torch.where(ok, out, torch.zeros((), dtype=out.dtype,
                                            device=out.device))
