"""2-D Cell-Averaging CFAR detection.

Counterpart of ``nis_sar_amtigmti_video_tpu/gmti/cfar.py``: a CA-CFAR over
the DPCA power map whose training-cell mean is two box sums, each computed as
two separable 1-D *locally windowed* sums.

Precision note (the reason the sums are windowed): SAR power maps span
80-100 dB, so a cumulative-sum-difference box filter is unusable in float32
— after one bright scatterer the running sum is O(target power), and
differencing it for weak cells far away loses their whole training sum.
Each windowed output sums only 2*half+1 values and never differences large
accumulators, so float32 keeps a relative error ~2^-24 of the *local* sum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class CfarParams:
    guard: int = 2        # guard half-width (cells) per axis
    train: int = 8        # training half-width beyond guard
    pfa: float = 1e-6     # design false-alarm rate (sets the threshold factor)

    @property
    def num_train_cells(self) -> int:
        outer = (2 * (self.guard + self.train) + 1) ** 2
        inner = (2 * self.guard + 1) ** 2
        return outer - inner

    @property
    def alpha(self) -> float:
        """CA-CFAR scale: N*(Pfa^(-1/N) - 1) (exponential clutter)."""
        n = self.num_train_cells
        return n * (self.pfa ** (-1.0 / n) - 1.0)


class CfarResult(NamedTuple):
    detections: torch.Tensor   # bool map
    snr: torch.Tensor          # cell power / local noise estimate
    noise: torch.Tensor        # local noise-power estimate


def _window_sum(x: torch.Tensor, half: int, dim: int) -> torch.Tensor:
    """Centered (2*half+1)-tap sum along ``dim`` with zero padding: each
    output sums its own window (an unfold view, no prefix differences)."""
    dim = dim % x.ndim
    pad = [0, 0] * (x.ndim - 1 - dim) + [half, half]
    xp = F.pad(x, pad)
    return xp.unfold(dim, 2 * half + 1, 1).sum(dim=-1)


def _box_sum(x: torch.Tensor, half: int) -> torch.Tensor:
    """Sum over a (2*half+1)^2 window with zero padding, as two separable
    windowed sums (azimuth, then range)."""
    return _window_sum(_window_sum(x, half, -2), half, -1)


def _count_1d(n: int, half: int, device=None) -> torch.Tensor:
    """Per-position count of in-bounds cells in a (2*half+1) window — the
    1-D factor of the zero-padded box count (exact small integers)."""
    i = torch.arange(n, device=device)
    return (torch.clamp(i + half, max=n - 1) - torch.clamp(i - half, min=0)
            + 1).to(torch.float32)


def _box_count(shape2, half: int, device=None) -> torch.Tensor:
    """Rank-1 equivalent of ``_box_sum(ones, half)``: count[i, j] =
    c_h(i) * c_w(j), exact integers in float32."""
    h, w = shape2
    return _count_1d(h, half, device)[:, None] \
        * _count_1d(w, half, device)[None, :]


def ca_cfar(power: torch.Tensor, p: CfarParams) -> CfarResult:
    """Detect cells whose power exceeds alpha * local-training-mean.

    power: (..., H, W) real nonnegative (e.g. |dpca|^2). Edge cells use the
    available (zero-padded) training cells with the count corrected.
    """
    g, t = p.guard, p.train
    outer = _box_sum(power, g + t)
    inner = _box_sum(power, g)
    n_outer = _box_count(power.shape[-2:], g + t, power.device)
    n_inner = _box_count(power.shape[-2:], g, power.device)
    n_train = torch.clamp(n_outer - n_inner, min=1.0)
    noise = (outer - inner) / n_train
    snr = power / torch.clamp(noise, min=1e-30)
    return CfarResult(detections=snr > p.alpha, snr=snr, noise=noise)


def detection_list(result: CfarResult, max_detections: int = 256):
    """Top-k detections as (row, col, snr), fixed size (padded with -1
    rows). Batched (..., H, W) inputs give (..., K) per image."""
    snr = torch.where(result.detections, result.snr,
                      torch.zeros_like(result.snr))
    h, w = snr.shape[-2], snr.shape[-1]
    flat = snr.reshape(snr.shape[:-2] + (h * w,))
    vals, idx = torch.topk(flat, max_detections, dim=-1)
    rows, cols = idx // w, idx % w
    valid = vals > 0
    neg = torch.full_like(rows, -1)
    return (torch.where(valid, rows, neg), torch.where(valid, cols, neg),
            torch.where(valid, vals, torch.zeros_like(vals)))
