"""The stage metrics of a traced window, read from the port's own spans:
the device time a product of the kernels each stage launched, the card's
idle time split by what the host held open, and the frames' fetch wait.

``stages.py`` lays the program's record on the device trace
(``stages.from_events``: each kernel put down to the innermost span open at
its launch, each idle gap to the span and runtime call open at its
midpoint); this module reads the resulting ``StageTrace``. It holds the one
reading function (:func:`readings`), the one map of where each hand-written
kernel is launched (:data:`KERNEL_SPANS`), the idle split over the window
the host timed (:func:`host_window`, :func:`idle_split`) and the result
line's idle gaps labelled by span (:func:`breakdown`): pure functions of a
recorded window, for ``run.py``'s traced branch to read under
``profiling.recording(device_counts=False)`` and for ``stages.py`` to take
in place of its own ``KERNEL_SPANS``, ``is_focus`` and ``readings``."""

from __future__ import annotations

import dataclasses

from bench_torch import stages, trace

# where each hand-written kernel (csrc/*.cu, by name without template
# arguments) must be launched from: a replayed frame graph launches the
# formation under ``bp.replay``; K1g is ``k1_kernel`` on two channels
KERNEL_SPANS = {"spread_windows_kernel": ("echo.spread", "echo.edge"),
                "place_windows_kernel": ("echo.spread", "echo.edge"),
                "fft_conv_kernel": ("echo.conv",),
                "echo_accumulate_kernel": ("segment.echo", "echo"),
                "forward_spectra_kernel": ("segment.spectra",),
                "recentre_spectra_kernel": ("bp.recentre",),
                "recenter_presum_kernel": ("bp.recentre",),
                "accumulate_kernel": ("bp.accumulate", "bp.replay"),
                "k1_kernel": ("focus.k1g", "focus.k1"),
                "k2_kernel": ("focus.k2",),
                "k3g_kernel": ("focus.k3g",),
                "k3_kernel": ("focus.k3",),
                "k4_kernel": ("focus.k4",),
                "balance_kernel": ("focus.balance",)}

READINGS = ("echo_device_ms", "focus_device_ms", "reconstruct_device_ms",
            "host_gap_ms", "outside_gap_ms", "fetch_wait_ms")


def is_focus(name: str) -> bool:
    """The products' spans: the focus and its stages, HRWS's focus, a
    frame and its stages, the fast BP's stages and a ring segment's
    spectra."""
    return name in ("focus", "hrws.focus", "segment.spectra") \
        or name.startswith(("focus.", "frame", "bp."))


def is_reconstruct(name: str) -> bool:
    """HRWS's reconstruction and its stages."""
    return name.startswith("hrws.") and name != "hrws.focus"


def idle_split(st: stages.StageTrace) -> dict | None:
    """The card's idle ms a product in the window, by what was open at
    each gap's midpoint: a program span and no runtime call
    (``host_gap_ms``: the program's Python holding the card), no span
    (``outside_gap_ms``: the caller's work between products), a span and a
    runtime call (``call_gap_ms``: a fetch's event wait, a graph launch).
    None where the window holds no device activity or no product."""
    if st.products <= 0 or not st.device:
        return None
    out = {"host_gap_ms": 0.0, "outside_gap_ms": 0.0, "call_gap_ms": 0.0}
    for s, c, sec in stages.labelled_gaps(st):
        key = "outside_gap_ms" if s is None else \
            "host_gap_ms" if c is None else "call_gap_ms"
        out[key] += 1e3 * sec / st.products
    return out


def readings(st: stages.StageTrace) -> dict:
    """The stage readings of a recorded window, a product each, None where
    the window holds nothing to read: device ms of the kernels (not
    copies) launched under the simulation's spans (``echo_device_ms``,
    ``stages.is_echo``), the products' (``focus_device_ms``,
    :func:`is_focus`) and HRWS's reconstruction (``reconstruct_device_ms``,
    :func:`is_reconstruct`); ``host_gap_ms`` and ``outside_gap_ms`` of
    :func:`idle_split`, where the record holds a span; host ms in
    ``frame.fetch`` (``fetch_wait_ms``)."""
    out = {"echo_device_ms": stages.device_ms(st, stages.is_echo),
           "focus_device_ms": stages.device_ms(st, is_focus),
           "reconstruct_device_ms": stages.device_ms(st, is_reconstruct),
           "host_gap_ms": None, "outside_gap_ms": None,
           "fetch_wait_ms": None}
    split = idle_split(st) if st.spans else None
    if split is not None:
        out["host_gap_ms"] = split["host_gap_ms"]
        out["outside_gap_ms"] = split["outside_gap_ms"]
    fetch = [b - a for name, a, b in st.spans if name == "frame.fetch"]
    if fetch and st.products > 0:
        out["fetch_wait_ms"] = sum(fetch) / 1e3 / st.products
    return out


def misplaced(st: stages.StageTrace) -> dict:
    """{kernel: launches} of the hand-written kernels launched outside
    their :data:`KERNEL_SPANS`."""
    return stages.misplaced(stages.launch_sites(st, KERNEL_SPANS),
                            KERNEL_SPANS)


def breakdown(tr: trace.DeviceTrace, st: stages.StageTrace) -> dict:
    """The result line's ``breakdown`` with the idle gaps labelled by the
    innermost program span, then the runtime call or 'python'
    ('focus.factors python', 'frame.fetch cudaEventSynchronize'); a gap
    with no span open keeps ``trace.idle_gaps``' label."""
    return {"device_ops": trace.device_ops(tr),
            "idle_gaps": stages.idle_gaps(st, trace.TOP)}


def host_window(st: stages.StageTrace, origin_ns: int, t0_ns: int,
                t1_ns: int) -> stages.StageTrace:
    """``st`` over the window the host timed, from ``t0_ns`` to ``t1_ns``
    of ``profiling.clock_ns`` (the trace's clock; ``origin_ns`` its
    start), in place of its first to last event: its idle gaps then add
    up to the idle time ``device_idle_share`` counts, the host's window
    less the device's busy time, the host's work before the first runtime
    call included."""
    return dataclasses.replace(st, window_us=((t0_ns - origin_ns) / 1e3,
                                              (t1_ns - origin_ns) / 1e3))
