"""The stage metrics of a traced window (``bench_torch/stage_metrics.py``)
read from the port's own spans: the readings on a synthetic trace and
record, a frame graph's kernels put down to ``bp.replay``, the idle split
against the window's idle time, the breakdown's span labels, and a CPU
rehearsal of a recorded traced window.

The test marked ``cuda`` holds the held and ring routes of
``videosar.run`` to the same kernel launches with the program's recording
on and off; it skips where no CUDA device is present. On a GPU machine:
``python -m pytest --noconftest tests/test_torch_stage_metrics.py -q``."""

import copy
import json
import pathlib
import random
import re
import types

import pytest
import torch

from bench_torch import core, stage_metrics, stages, trace
from bench_torch.tests import tiny
from nis_sar_amtigmti_video_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
ORIGIN = 1_700_000_000_000_000_000          # the trace's start, in ns
SEED = 2 ** 31 + 2024


def ev(name, a, b, dev, i):
    return types.SimpleNamespace(
        name=name, id=i, device_type="DeviceType.CUDA" if dev else "CPU",
        is_user_annotation=False,
        time_range=types.SimpleNamespace(start=a, end=b))


def record(spans):
    """A Record holding (name, start_us, end_us) spans on the trace's
    clock."""
    rec = profiling.Record()
    for k, (name, a, b) in enumerate(spans):
        rec.spans.append(profiling.Span(k + 1, 0, k + 1, name,
                                        ORIGIN + 1000 * a, ORIGIN + 1000 * b,
                                        {}))
    return rec


ACC = "void (anonymous namespace)::accumulate_kernel<64>(AccArgs)"


def synthetic():
    """Two products' worth of a window, in us: a segment's echo, a frame
    formed by one graph launch (two kernels), an HRWS reconstruction and
    focus, a fetch's copy and event wait, and a kernel launched under no
    span."""
    events = [ev("cudaLaunchKernel", 100, 110, False, 1),
              ev("cudaGraphLaunch", 1000, 1020, False, 2),
              ev("cudaLaunchKernel", 2300, 2310, False, 3),
              ev("cudaLaunchKernel", 2470, 2478, False, 4),
              ev("cudaMemcpyAsync", 2860, 2880, False, 7),
              ev("cudaEventSynchronize", 3100, 3500, False, 5),
              ev("cudaLaunchKernel", 3700, 3710, False, 6),
              ev("at::native::vectorized_elementwise_kernel<4>", 200, 400,
                 True, 1),
              ev(ACC, 1100, 2100, True, 2),
              ev("at::native::elementwise_kernel<128, 2>", 2100, 2200, True,
                 2),
              ev("gemm_kernel", 2350, 2450, True, 3),
              ev("void k1_kernel<1, 64>(K1Args)", 2500, 2800, True, 4),
              ev("Memcpy DtoH (Device -> Pinned)", 2950, 3000, True, 7),
              ev("reduce_kernel", 3800, 3900, True, 6)]
    rec = record([("segment.echo", 50, 160), ("frame", 600, 2250),
                  ("bp.replay", 950, 1050), ("hrws.reconstruct", 2280, 2400),
                  ("hrws.unfold", 2290, 2320), ("hrws.focus", 2440, 2820),
                  ("focus.k1", 2460, 2480), ("frame.fetch", 2850, 3600)])
    return events, rec


def staged(events, rec, products=2):
    return stages.from_events(events, rec, ORIGIN, products)


def test_readings_on_a_synthetic_window():
    st = staged(*synthetic())
    assert stage_metrics.readings(st) == pytest.approx({
        "echo_device_ms": 0.1,              # 200 us over 2 products
        "focus_device_ms": 0.7,             # the replay's 1,100 + K1's 300
        "reconstruct_device_ms": 0.05,      # the unfold's gemm
        "host_gap_ms": 0.4,                 # 100 + 700 us of Python
        "outside_gap_ms": 0.075,            # 150 us under no span
        "fetch_wait_ms": 0.375})            # 750 us in frame.fetch
    assert stage_metrics.idle_split(st) == pytest.approx({
        "host_gap_ms": 0.4, "outside_gap_ms": 0.075,
        "call_gap_ms": 0.5})                # 50 + 150 + 800 us
    assert stages.attributed_share(st) == pytest.approx(1750 / 1850)


def test_readings_read_none_without_a_record():
    events, _ = synthetic()
    got = stage_metrics.readings(staged(events, profiling.Record()))
    assert got == {k: None for k in stage_metrics.READINGS}
    # a window with no device activity (a CPU run) splits no idle time
    bare = staged([e for e in events if "CUDA" not in e.device_type],
                  synthetic()[1])
    assert stage_metrics.idle_split(bare) is None
    assert stage_metrics.readings(bare)["fetch_wait_ms"] \
        == pytest.approx(0.375)


def test_a_graph_launch_puts_its_kernels_in_bp_replay():
    """The replay's accumulate follows its correlation id to the
    ``cudaGraphLaunch`` made in ``bp.replay``: placed there, where
    ``stages.py``'s own map does not take it."""
    st = staged(*synthetic())
    sites = stages.launch_sites(st, stage_metrics.KERNEL_SPANS)
    assert sites == {"accumulate_kernel": {"bp.replay": 1},
                     "k1_kernel": {"focus.k1": 1}}
    assert stage_metrics.misplaced(st) == {}
    assert stages.misplaced(stages.launch_sites(st)) \
        == {"accumulate_kernel": 1}


# hand-written kernels whose spans the benchmark's map does not hold yet
# (bench_torch/stage_metrics.py::KERNEL_SPANS takes them in a change of the
# benchmark's own), with the spans they are launched from
PENDING_KERNEL_SPANS = {"rcmc_kernel": ("focus.rcmc",)}


def test_every_hand_written_kernel_has_its_spans():
    """Each ``__global__`` kernel of ``csrc/`` has the spans it must be
    launched from, in the benchmark's map or the pending one, and the two
    maps, which share no kernel, name no other."""
    names = set()
    for f in (REPO / "nis_sar_amtigmti_video_tpu_torch" / "csrc").glob(
            "*.cu"):
        names |= set(re.findall(r"__global__.*?\b(\w+_kernel)\s*\(",
                                f.read_text(), re.S))
    assert len(names) >= 15
    assert not set(stage_metrics.KERNEL_SPANS) & set(PENDING_KERNEL_SPANS)
    assert set(stage_metrics.KERNEL_SPANS) | set(PENDING_KERNEL_SPANS) \
        == names


def random_window(rng: random.Random):
    """Kernels, runtime calls and nested spans at random times (us)."""
    events, spans = [], []
    for i in range(1, 40):
        a = rng.uniform(0, 10_000)
        events.append(ev("cudaLaunchKernel", a, a + rng.uniform(1, 30),
                         False, i))
        k = a + rng.uniform(5, 400)
        events.append(ev(f"kernel_{i % 5}", k, k + rng.uniform(1, 300),
                         True, i))
    for _ in range(6):
        a = rng.uniform(0, 9_000)
        events.append(ev("cudaStreamSynchronize", a, a + rng.uniform(1, 800),
                         False, 0))
    t = 0.0
    while t < 10_000:                       # products, each with stages
        b = t + rng.uniform(200, 2000)
        spans.append(("frame", t, b))
        u = t
        while u < b:
            v = min(b, u + rng.uniform(20, 500))
            if rng.random() < 0.6:
                spans.append((rng.choice(["bp.fit", "focus.k2"]), u, v))
            u = v
        t = b + rng.uniform(0, 300)
    return events, record(spans)


@pytest.mark.parametrize("seed", range(4))
def test_the_idle_split_sums_to_the_windows_idle_time(seed):
    """The program's Python (span, no call), the caller's work (no span)
    and the runtime calls inside a span add up to every idle us of the
    window, which is its length less the device's busy union."""
    events, rec = random_window(random.Random(seed))
    st = staged(events, rec, products=5)
    split = stage_metrics.idle_split(st)
    busy = sum(b - a for a, b in trace.merged([d[:3] for d in st.device]))
    idle_ms = (st.window_us[1] - st.window_us[0] - busy) / 1e3 / 5
    assert sum(split.values()) == pytest.approx(idle_ms, rel=1e-12)
    assert min(split.values()) >= 0
    r = stage_metrics.readings(st)
    assert (r["host_gap_ms"], r["outside_gap_ms"]) \
        == (split["host_gap_ms"], split["outside_gap_ms"])


def test_breakdown_labels_gaps_by_span():
    events, rec = synthetic()
    tr = trace.from_events(events, 2, 0.0038)
    got = stage_metrics.breakdown(tr, staged(events, rec))
    assert got["device_ops"] == trace.device_ops(tr)
    assert dict(got["idle_gaps"]) == pytest.approx({
        "segment.echo python": 100e-6, "frame python": 700e-6,
        "python": 150e-6, "focus.k1 cudaLaunchKernel": 50e-6,
        "frame.fetch cudaMemcpyAsync": 150e-6,
        "frame.fetch cudaEventSynchronize": 800e-6})
    # with no span open, every gap keeps trace.idle_gaps' label
    bare = stage_metrics.breakdown(tr, staged(events, profiling.Record()))
    assert bare == trace.breakdown(tr)


def test_the_split_over_the_host_window_is_the_idle_time_counted():
    """Over the window the host timed (0 to 4,000 us here, the trace's
    events 100 to 3,900), the split adds the edges (the first launch's
    call, the host's work after the last kernel) and sums to the idle time
    ``device_idle_share`` counts: the host's window less the busy union."""
    events, rec = synthetic()
    st = stage_metrics.host_window(staged(events, rec), ORIGIN, ORIGIN,
                                   ORIGIN + 4_000_000)
    assert st.window_us == (0.0, 4000.0)
    split = stage_metrics.idle_split(st)
    assert split == pytest.approx({"host_gap_ms": 0.35,
                                   "outside_gap_ms": 0.125,
                                   "call_gap_ms": 0.6})
    tr = trace.from_events(events, 2, 0.004)
    share = core.metric_module("device_idle_share").read(tr, {})
    assert sum(split.values()) == pytest.approx(share / 100 * 4.0 / 2) \
        == 1.075
    assert stage_metrics.misplaced(st) == {}
    assert stage_metrics.readings(st)["host_gap_ms"] == split["host_gap_ms"]


def test_a_recorded_window_on_the_cpu():
    """A traced window of the full-scale cell at its tiny size, recorded
    under ``recording(device_counts=False)`` and read over the host's
    window: each collect's echo and focus recorded once, no device count,
    and every device reading and the idle split None (no device activity
    on the CPU); the frame-less cell has no fetch wait."""
    spec, cfg, traffic = tiny.cell("fullscale_sim_gmti")
    drv = core.kind_module(traffic).setup(cfg, traffic, core.seed64(SEED),
                                          torch.device("cpu"), trace=True)
    drv.warm()
    n_min = int(traffic["trace_products"])
    win = core.Window(drv, 0.05)
    with profiling.recording(device_counts=False) as rec:
        with trace.profile(False) as prof:
            t0_ns = profiling.clock_ns()
            win.run(stop=lambda n, el: el >= 0.05 and n >= n_min)
            t1_ns = profiling.clock_ns()
    drv.release()
    origin = stages.trace_origin_ns(prof)
    st = stage_metrics.host_window(
        stages.from_events(prof.events(), rec, origin, win.products),
        origin, t0_ns, t1_ns)
    assert win.products >= n_min
    tree = rec.tree()
    assert tree["echo"][0] == tree["focus"][0] == win.products
    assert rec.counters == {}
    assert st.window_us[1] - st.window_us[0] \
        == pytest.approx((t1_ns - t0_ns) / 1e3)
    assert stage_metrics.idle_split(st) is None
    assert stage_metrics.readings(st) == {k: None
                                          for k in stage_metrics.READINGS}


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the launches of the card's route)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["held", "ring"])
def test_recording_launches_the_same_kernels_on_card(dev, mode):
    """``videosar.run`` on the card, held collect or ring, after a warm
    call: a call recorded as a traced benchmark window records
    (``device_counts=False``) launches exactly the kernels of an
    unrecorded call, and each of them from a span."""
    from bench_torch.spotlight import Collect
    from nis_sar_amtigmti_video_tpu_torch.models import videosar
    from nis_sar_amtigmti_video_tpu_torch.scene import targets as T

    cfg = json.loads((REPO / "bench_torch" / "configs"
                      / "videosar_spotlight_held.json").read_text())
    cfg["scenario"] = copy.deepcopy(tiny.VIDEO_TINY)
    cfg["scenario"]["processing"]["bp_presum"] = 4
    cfg["scenario"]["video"]["duration_s"] = 2.0
    c = Collect(cfg, SEED, dev, "fast_pallas")
    ship = T.destroyer()
    kw = dict(heading_deg=c.heading, speed_mps=c.speed,
              bp_backend="fast_pallas", device=dev)
    if mode == "held":
        kw["raw"] = videosar.record(c.sc, ship, heading_deg=c.heading,
                                    speed_mps=c.speed, seed=SEED,
                                    avg_rcs=5000.0, device=dev)
    else:
        kw.update(stream_spectra="ring", seed=SEED,
                  noise_mode="per_segment", avg_rcs=5000.0)

    def launches(rec=False):
        with trace.profile(True) as prof:
            if rec:
                with profiling.recording(device_counts=False) as r:
                    videosar.run(c.sc, ship, **kw)
            else:
                videosar.run(c.sc, ship, **kw)
            torch.cuda.synchronize(dev)
        events = prof.events()
        n = len(trace.from_events(events, 1, 1.0).kernels())
        st = stages.from_events(events, r, stages.trace_origin_ns(prof), 1) \
            if rec else None
        return n, st

    launches()                                      # captures the graphs
    off, _ = launches()
    on, st = launches(rec=True)
    assert on == off > 0
    assert stage_metrics.misplaced(st) == {}
    assert stages.attributed_share(st) > 0.999
