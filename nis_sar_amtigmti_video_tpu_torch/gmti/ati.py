"""Along-Track Interferometry (ATI) products.

Counterpart of ``nis_sar_amtigmti_video_tpu/gmti/ati.py``: the reference's
products (sar_ati_dcpa_sim_csa.py:414-416, 447-450) and viewer calibration
(sar_ati_dcpa_viewer_csa.py:43-56, 245-254).
"""

from __future__ import annotations

import torch

from nis_sar_amtigmti_video_tpu_torch.ops.csa import expj


def interferogram(slc1, slc2):
    """Complex ATI interferogram slc1 * conj(slc2)."""
    return slc1 * torch.conj(slc2)


def ati_phase(slc1, slc2):
    return torch.angle(interferogram(slc1, slc2))


def masked_phase(slc1, slc2, threshold: float = 0.05):
    """Phase where channel-1 magnitude exceeds threshold*peak; else 0
    (sar_ati_dcpa_sim_csa.py:447-449)."""
    phase = ati_phase(slc1, slc2)
    mag = torch.abs(slc1)
    return torch.where(mag > threshold * torch.max(mag), phase,
                       torch.zeros_like(phase))


def channel_balance_phase(slc1, slc2):
    """Global calibration phase = angle(mean(slc1*conj(slc2)))
    (sar_ati_dcpa_viewer_csa.py:245-254)."""
    return torch.angle(torch.mean(interferogram(slc1, slc2)))


def apply_balance(slc2, cal_phase):
    """Rotate channel 2 by the calibration phase."""
    return slc2 * expj(torch.as_tensor(cal_phase, dtype=torch.float32,
                                       device=slc2.device))
