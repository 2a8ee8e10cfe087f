"""Gather-based linear interpolation.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/interp.py``'s
``interp_uniform`` (what ops/bp.py needs): vectorized index arithmetic plus
``torch.gather`` in place of the reference's ``take_along_axis``.
``interp_nonuniform_src`` waits for the RDA port.
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
