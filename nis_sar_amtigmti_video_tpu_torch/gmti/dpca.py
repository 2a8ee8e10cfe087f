"""Displaced Phase Center Antenna (DPCA) clutter cancellation.

Counterpart of ``nis_sar_amtigmti_video_tpu/gmti/dpca.py``: baseline design,
pulse-shift co-registration and the difference product
(sar_ati_dcpa_sim_csa.py:40-43, 398-404, 418-419) plus the viewer's
cancellation-quality metric (sar_ati_dcpa_viewer_csa.py:139-143).
"""

from __future__ import annotations

import torch


def dpca_baseline(v_platform: float, prf_hz: float) -> float:
    """d_rx = 2 V / PRF: after a one-pulse shift the two-way phase centers of
    the trailing and leading channels coincide exactly."""
    return 2.0 * v_platform / prf_hz


def pulse_shift_coregister(raw1, raw2, shift_pulses: int = 1):
    """Trailing channel advanced by ``shift_pulses`` PRIs: returns
    (raw1[s:], raw2[:-s]) so both see the same phase-center track.
    shift_pulses=0 (co-located phase centers, pure ATI) is a no-op."""
    s = shift_pulses
    if s == 0:
        return raw1, raw2
    return raw1[..., s:, :], raw2[..., :-s, :]


def dpca_difference(slc1, slc2):
    """Clutter-cancelled complex difference; |.| highlights movers."""
    return slc1 - slc2


def cancellation_ratio(slc1, dpca, eps: float = 1e-12) -> torch.Tensor:
    """mean|ch1| / mean|dpca| — the viewer's clutter-cancellation quality
    metric. Returns the linear ratio; 20*log10 for dB."""
    return torch.mean(torch.abs(slc1)) / (torch.mean(torch.abs(dpca)) + eps)
