"""VideoSAR frame scheduler: sliding CPI windows over a long pulse stream.

Counterpart of ``nis_sar_amtigmti_video_tpu/video/scheduler.py``: duration*PRF
pulses, CPI windows of cpi_s*PRF pulses stepping PRF/fps pulses (80% overlap
at the reference's 0.5 s CPI / 10 fps). The schedule is pure host data, so a
failed frame is re-formed from its (i0, i1) window alone.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.config import VideoConfig


class FrameSchedule(NamedTuple):
    starts: np.ndarray      # (F,) start pulse index of each frame
    cpi_pulses: int
    step_pulses: int
    total_pulses: int

    @property
    def num_frames(self) -> int:
        return self.starts.shape[0]


def make_schedule(video: VideoConfig, prf_hz: float) -> FrameSchedule:
    total = video.total_pulses(prf_hz)
    cpi = video.cpi_pulses(prf_hz)
    step = video.step_pulses(prf_hz)
    starts = []
    for f in range(video.num_frames()):
        i0 = f * step
        if i0 + cpi > total:
            break
        starts.append(i0)
    return FrameSchedule(starts=np.asarray(starts, np.int64), cpi_pulses=cpi,
                         step_pulses=step, total_pulses=total)


def gather_frames(stream: torch.Tensor, schedule: FrameSchedule):
    """(T, ...) pulse stream -> (F, cpi, ...) overlapped frame stack, on the
    stream's device (overlap duplicates the shared pulses)."""
    idx = (torch.as_tensor(schedule.starts, device=stream.device)[:, None]
           + torch.arange(schedule.cpi_pulses, device=stream.device)[None, :])
    return stream[idx]


def frame_slices_host(traj_arrays, schedule: FrameSchedule):
    """Host-side per-frame stacking of trajectory arrays: each (T, ...) ->
    (F, cpi, ...) float64 numpy."""
    out = []
    for a in traj_arrays:
        out.append(np.stack([a[i0:i0 + schedule.cpi_pulses]
                             for i0 in schedule.starts], axis=0))
    return out
