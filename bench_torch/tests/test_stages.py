"""bench_torch/stages.py: kernels put down to the program span open at
their launch, idle gaps labelled by span, the stage readings on a
synthetic trace with a synthetic record, and a CPU rehearsal of the
command's windows."""

import random
import types

import pytest
import torch

from bench_torch import core, stages, trace
from bench_torch.tests import tiny
from nis_sar_amtigmti_video_tpu_torch.utils import profiling

ORIGIN = 1_700_000_000_000_000_000          # the trace's start, in ns


def ev(name, a, b, dev, i):
    return types.SimpleNamespace(
        name=name, id=i, device_type="DeviceType.CUDA" if dev else "CPU",
        is_user_annotation=False,
        time_range=types.SimpleNamespace(start=a, end=b))


ACC = "void (anonymous namespace)::accumulate_kernel<64>(AccArgs)"


def synthetic():
    """Two frames' worth of a ring's window, in us: launches on the host,
    their kernels on the card, the program's spans (stamped in ns on the
    profiler's clock) and one counter."""
    events = [ev("cudaLaunchKernel", 150, 200, False, 1),
              ev("cudaLaunchKernel", 430, 440, False, 5),
              ev("cudaLaunchKernel", 1100, 1150, False, 2),
              ev("cudaLaunchKernel", 5200, 5300, False, 3),
              ev("cudaMemcpyAsync", 6100, 8500, False, 4),
              ev("at::native::vectorized_elementwise_kernel<4>", 300, 900,
                 True, 1),
              ev(ACC, 1200, 2500, True, 2),
              ev("at::native::elementwise_kernel<128, 2>", 2500, 2600,
                 True, 5),
              ev("gemv_kernel", 2600, 2700, True, 9),    # launch not seen
              ev("fill_kernel", 5400, 5600, True, 3),    # under no span
              ev("Memcpy DtoH (Device -> Pageable)", 7000, 7500, True, 4)]
    rec = profiling.Record()
    for k, (name, a, b) in enumerate(
            [("frame", 0, 5000), ("frame.traj", 100, 400),
             ("segment.echo", 420, 480), ("frame.bp", 500, 4000),
             ("bp.accumulate", 1000, 2000), ("frame.fetch", 6000, 9000)]):
        rec.spans.append(profiling.Span(k + 1, 0, k + 1, name,
                                        ORIGIN + 1000 * a, ORIGIN + 1000 * b,
                                        {}))
    rec.counters["segment.echoed"] = 3
    return events, rec


def test_kernels_go_to_the_span_open_at_their_launch():
    events, rec = synthetic()
    st = stages.from_events(events, rec, ORIGIN, 2)
    assert [d[3] for d in st.device] == [
        "frame.traj", "bp.accumulate", "segment.echo",
        stages.UNATTRIBUTED, stages.UNATTRIBUTED, "frame.fetch"]
    assert st.window_us == (150, 8500)
    assert stages.attributed_share(st) == pytest.approx(2500 / 2800)
    assert stages.launch_sites(st) == {"accumulate_kernel":
                                       {"bp.accumulate": 1}}
    assert stages.misplaced({"accumulate_kernel": {"bp.accumulate": 4},
                             "forward_spectra_kernel": {
                                 "segment.spectra": 3, "frame": 2}}) \
        == {"forward_spectra_kernel": 2}


def test_idle_gaps_by_span_and_runtime_call():
    events, rec = synthetic()
    st = stages.from_events(events, rec, ORIGIN, 2)
    gaps = dict(stages.idle_gaps(st))
    assert gaps == pytest.approx({
        "frame.traj python": 150e-6, "bp.accumulate python": 300e-6,
        "frame python": 2700e-6, "frame.fetch cudaMemcpyAsync": 2400e-6})
    # with no span open, the labels are trace.idle_gaps' own
    bare = stages.from_events(events, profiling.Record(), ORIGIN, 2)
    tr = trace.from_events(events, 2, 0.0085)
    assert dict(stages.idle_gaps(bare)) == pytest.approx(
        dict(trace.idle_gaps(tr)))
    assert stages.report(bare, profiling.Record())[
        "bare_python_idle_share"] == pytest.approx(3150 / 5550)


def test_readings():
    events, rec = synthetic()
    r = stages.readings(stages.from_events(events, rec, ORIGIN, 2))
    assert r == pytest.approx({
        "echo_device_ms": 0.05,                  # 100 us over 2 products
        "focus_device_ms": 0.95,                 # frame.traj + accumulate
        "host_gap_ms": 1.575,                    # 150 + 300 + 2700 us
        "fetch_wait_ms": 1.5, "segments_per_frame": 1.5})
    none = stages.readings(stages.from_events(events, profiling.Record(),
                                              ORIGIN, 2))
    assert none == {k: None for k in r}


def test_the_record_moves_no_existing_reading():
    """The accepted per-layer metrics read the same trace the same way
    whether or not a record is laid on it."""
    events, rec = synthetic()
    names = [m["name"] for m in core.load_spec()["per_layer"]]
    before = {n: core.metric_module(n).read(
        trace.from_events(events, 2, 0.0085), {}) for n in names}
    stages.from_events(events, rec, ORIGIN, 2)
    after = {n: core.metric_module(n).read(
        trace.from_events(events, 2, 0.0085), {}) for n in names}
    assert before == after and before["launches_per_product"] == 2.5


def test_innermost_is_the_latest_started_open_interval():
    rng = random.Random(7)
    spans = []
    for _ in range(60):
        a = rng.uniform(0, 100)
        spans.append((len(spans), a, a + rng.uniform(0, 30)))
    times = [rng.uniform(-5, 135) for _ in range(300)]

    def brute(t):
        open_ = [s for s in spans if s[1] <= t <= s[2]]
        return max(open_, key=lambda s: (s[1], -s[2]))[0] if open_ else None

    assert stages.innermost(spans, times) == [brute(t) for t in times]


def test_windows_on_the_cpu():
    """The command's windows at the ring cell's tiny size: recording off
    then on; the recorded window reads the frames' fetch and one echoed
    segment a frame beyond the first CPI's."""
    spec, cfg, traffic = tiny.cell("videosar_collect_ring")
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    try:
        out = stages.windows(spec, "videosar_collect_ring", cfg, traffic,
                             2 ** 31 + 5, torch.device("cpu"), 1, 0.1)
    finally:
        torch.set_num_threads(n)
    off, on = out["windows"]
    assert (off["record"], on["record"]) == (False, True)
    assert "stages" not in off
    r, tree = on["stages"]["readings"], on["stages"]["tree"]
    assert tree["videosar.run/frame"][0] == pytest.approx(1.0)
    per_call = round(1 / tree["videosar.run"][0])    # frames a call: 3
    calls = on["products"] // per_call
    segs = on["stages"]["counters"]["segment.echoed"]
    assert per_call == 3 and calls >= traffic["trace_products"]
    assert segs == calls * (per_call - 1 + 2)        # 2 segments a CPI
    assert r["segments_per_frame"] == pytest.approx(segs / on["products"])
    assert r["fetch_wait_ms"] > 0
    assert r["echo_device_ms"] is None               # no device on the CPU
