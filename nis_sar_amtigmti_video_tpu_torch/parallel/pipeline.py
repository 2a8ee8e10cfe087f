"""Stage-overlapping pipeline over a frame/batch stream.

Counterpart of ``nis_sar_amtigmti_video_tpu/parallel/pipeline.py``, copied.
Under PyTorch, ``dispatch`` enqueues CUDA work on the current stream and
returns at once; ``fetch`` is the blocking stage (``.cpu()``). Keeping
``depth`` results in flight and blocking only on the oldest lets the device
form batch k+1 while the host fetches batch k.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def pipelined(dispatch: Callable[[T], R], items: Iterable[T], *,
              depth: int = 2,
              fetch: Optional[Callable[[R], object]] = None) -> Iterator:
    """Map ``dispatch`` over ``items`` with ``depth`` results in flight.

    ``dispatch(item)`` should *enqueue* device work and return a handle (a
    CUDA tensor). ``fetch(handle)``, if given, is the blocking host-side
    stage; it runs on the oldest handle while up to ``depth - 1`` newer ones
    are still computing. Results are yielded in input order. ``depth=1``
    degrades to the serial loop; ``depth=2`` is classic double buffering.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    inflight: deque = deque()
    for x in items:
        inflight.append(dispatch(x))
        if len(inflight) > depth:
            h = inflight.popleft()
            yield fetch(h) if fetch is not None else h
    while inflight:
        h = inflight.popleft()
        yield fetch(h) if fetch is not None else h
