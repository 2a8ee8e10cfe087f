"""Device timing for the port: CUDA events around work on the current
stream, closed with a synchronise.

Counterpart of ``nis_sar_amtigmti_video_tpu/utils/profiling.py``, whose
fences (a scalar fetched to the host) existed because of a TPU runtime; on
CUDA, events recorded on the stream time the device work directly.
"""

from __future__ import annotations

import statistics
from typing import Callable, List

import torch


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA timing needs a CUDA device")


def cuda_times_ms(fn: Callable[[], object], *, warmup: int = 1,
                  reps: int = 5) -> List[float]:
    """Milliseconds of each of ``reps`` calls of ``fn`` (after ``warmup``
    untimed calls), from CUDA events on the current stream. Each call's
    result is dropped before the next call."""
    _require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def median_ms(fn: Callable[[], object], *, warmup: int = 1,
              reps: int = 5) -> float:
    """Median of :func:`cuda_times_ms`."""
    return statistics.median(cuda_times_ms(fn, warmup=warmup, reps=reps))
