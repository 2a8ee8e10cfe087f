"""Device timing and the stage record of the port.

CUDA events around work on the current stream, closed with a synchronise
(:func:`cuda_times_ms`, :func:`median_ms`). Counterpart of
``nis_sar_amtigmti_video_tpu/utils/profiling.py``, whose fences (a scalar
fetched to the host) existed because of a TPU runtime; on CUDA, events
recorded on the stream time the device work directly.

The stage record: the port opens a :func:`span` at each stage boundary
(the echo, the focus, a frame and their stages) and bumps a :func:`count`
where it decides to do or skip work. Both do nothing until
:func:`recording` turns recording on::

    with profiling.recording() as rec:
        videosar.run(...)
    rec.tree()        # {"videosar.run/frame/frame.bp/bp.fit": [46, s], ...}
    rec.counters      # {"segment.echoed": 50, "segment.reused": 180}

A span never waits for the card: its times are the host's, stamped on the
clock the torch profiler stamps its events with (:data:`clock_ns`), so a
span can be laid on a device trace taken at the same time and each kernel
put down to the span open when the host launched it. A count the card
holds (:func:`count_device`) is summed on the card and read into
``counters`` once, when the recording ends.
"""

from __future__ import annotations

import contextlib
import itertools
import statistics
import threading
import time
from typing import Callable, List, NamedTuple

import torch

# the torch profiler's clock: kineto stamps host and device events in ns
# of the Unix epoch, as time.time_ns() (time.perf_counter_ns() is another
# epoch)
clock_ns = time.time_ns


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


class Span(NamedTuple):
    """One closed span: ``parent_id`` the innermost span open on its
    thread when it opened (0: none), ``root_id`` the outermost (itself
    for a root), which names the product the span belongs to; times in
    ns of :data:`clock_ns`."""

    id: int
    parent_id: int
    root_id: int
    name: str
    start_ns: int
    end_ns: int
    attrs: dict


class Record:
    """What one :func:`recording` collected: ``spans`` in the order they
    closed, ``counters`` by name (those of :func:`count_device` once the
    recording has ended)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: dict = {}
        self._on_device: dict = {}      # name -> 0-d sum on the card
        self._ids = itertools.count(1)
        self._open = threading.local()

    def _read_device_counts(self) -> None:
        """Adds the device counts into ``counters`` (one read to the host
        a name, after the work that made them)."""
        for name, total in self._on_device.items():
            self.counters[name] = self.counters.get(name, 0) + int(total)
        self._on_device = {}

    def _stack(self) -> list:
        st = getattr(self._open, "stack", None)
        if st is None:
            st = self._open.stack = []
        return st

    def tree(self) -> dict:
        """{path of span names from the root, "a/b/c": [spans, host
        seconds]}, the paths in the order their first span opened."""
        by_id = {s.id: s for s in self.spans}

        def path(s):
            names = [s.name]
            while s.parent_id:
                s = by_id[s.parent_id]
                names.append(s.name)
            return "/".join(reversed(names))

        out = {}
        for s in sorted(self.spans, key=lambda s: (s.start_ns, s.id)):
            n_s = out.setdefault(path(s), [0, 0.0])
            n_s[0] += 1
            n_s[1] += (s.end_ns - s.start_ns) / 1e9
        return out


class _Open:
    """An open span of a recording."""

    __slots__ = ("rec", "name", "attrs", "id", "parent", "root", "t0")

    def __init__(self, rec: Record, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        st = self.rec._stack()
        self.id = next(self.rec._ids)
        self.parent = st[-1].id if st else 0
        self.root = st[0].id if st else self.id
        st.append(self)
        self.t0 = clock_ns()
        return self

    def __exit__(self, *exc):
        t1 = clock_ns()
        self.rec._stack().pop()
        self.rec.spans.append(Span(self.id, self.parent, self.root,
                                   self.name, self.t0, t1, self.attrs))
        return False


_OFF = contextlib.nullcontext()     # the span of a process not recording
_record: Record | None = None       # the recording on, if any


def span(name: str, **attrs):
    """A context manager marking a stage of the port. Not recording: the
    one shared no-op context. Recording: a span of ``name`` (and
    ``attrs``) goes into the record when it closes."""
    if _record is None:
        return _OFF
    return _Open(_record, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    rec = _record
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def count_device(name: str, make: Callable[[], torch.Tensor]) -> None:
    """Add the 0-d integer tensor ``make()`` to the counter ``name`` while
    recording, without waiting for the card: ``make`` runs only while
    recording, the sum stays on the tensor's device, and it reaches
    ``counters`` when the recording ends."""
    rec = _record
    if rec is not None:
        n = make()
        prev = rec._on_device.get(name)
        rec._on_device[name] = n if prev is None else prev + n


@contextlib.contextmanager
def recording():
    """Turns recording on for the ``with`` block and yields its
    :class:`Record`, which stays readable after the block."""
    global _record
    if _record is not None:
        raise RuntimeError("already recording")
    rec = _record = Record()
    try:
        yield rec
    finally:
        _record = None
        rec._read_device_counts()
