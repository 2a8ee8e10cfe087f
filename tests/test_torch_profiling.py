"""The port's stage record (utils/profiling.py): a span or a count costs
nothing and records nothing until recording is on; spans nest by thread
and share their root; their clock is the torch profiler's; and the two
main paths, the full-scale echo and focus and the VideoSAR ring, record
exactly the documented span tree and counters, with the same outputs bit
for bit whether recording is on or off."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nis_sar_amtigmti_video_tpu_torch import config
from nis_sar_amtigmti_video_tpu_torch.geometry import orbit
from nis_sar_amtigmti_video_tpu_torch.gmti import fused
from nis_sar_amtigmti_video_tpu_torch.models import gmti, videosar
from nis_sar_amtigmti_video_tpu_torch.models.stripmap import echo_opts_for
from nis_sar_amtigmti_video_tpu_torch.ops import csa, echo
from nis_sar_amtigmti_video_tpu_torch.scene import clutter, targets
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import (
    count, count_device, recording, span)

# one intra-op thread: the suite runs in several processes at once,
# and a torch OpenMP pool per process oversubscribes the cores
torch.set_num_threads(1)


def test_off_records_nothing_and_shares_one_no_op():
    a, b = span("echo"), span("frame", f=3)
    assert a is b
    with a:
        count("segment.echoed")
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_spans_nest_and_share_their_root():
    with recording() as rec:
        with span("run", frames=2):
            with span("frame", f=0):
                with span("frame.bp"):
                    pass
            with span("frame", f=1):
                pass
        with span("run", frames=1):
            pass
    s = {(x.name, x.attrs.get("f", x.attrs.get("frames"))): x
         for x in rec.spans}
    run0, run1 = s["run", 2], s["run", 1]
    f0, f1, bp = s["frame", 0], s["frame", 1], s["frame.bp", None]
    assert run0.parent_id == 0 and run0.root_id == run0.id
    assert f0.parent_id == f1.parent_id == run0.id
    assert bp.parent_id == f0.id
    assert {f0.root_id, f1.root_id, bp.root_id} == {run0.id}
    assert run1.root_id == run1.id != run0.id
    assert run0.start_ns <= f0.start_ns <= bp.start_ns <= bp.end_ns \
        <= f0.end_ns <= f1.start_ns <= f1.end_ns <= run0.end_ns
    assert [x.name for x in rec.spans] == ["frame.bp", "frame", "frame",
                                           "run", "run"]     # as they close
    assert list(rec.tree()) == ["run", "run/frame", "run/frame/frame.bp"]
    assert rec.tree()["run/frame"][0] == 2


def test_counters_count_only_while_recording():
    count("segment.echoed")
    with recording() as rec:
        count("segment.echoed")
        count("segment.echoed", 4)
        count("segment.reused")
    count("segment.echoed")
    assert rec.counters == {"segment.echoed": 5, "segment.reused": 1}


def test_device_counts_sum_where_they_are_and_read_at_the_end():
    """A device count is made only while recording, summed on its tensor's
    device, and reaches ``counters`` when the recording ends (beside the
    host counts of the same name)."""
    made = []

    def make(n):
        def f():
            made.append(n)
            return torch.tensor(n)
        return f
    count_device("echo.dropped", make(1))
    with recording() as rec:
        count_device("echo.dropped", make(2))
        count_device("echo.dropped", make(3))
        count("echo.dropped")
        assert rec.counters == {"echo.dropped": 1}
    assert made == [2, 3]
    assert rec.counters == {"echo.dropped": 6}


def test_device_counts_only_where_the_recording_asks():
    """``recording(device_counts=False)``, a traced benchmark window's,
    forms no device count (``make`` is never called, so it launches
    nothing); the default, a set-up check's, forms them."""
    made = []

    def make():
        made.append(1)
        return torch.tensor(1)
    with recording(device_counts=False) as rec:
        count_device("echo.dropped", make)
        count("segment.echoed")
    assert made == [] and rec.counters == {"segment.echoed": 1}
    with recording() as rec:
        count_device("echo.dropped", make)
    assert made == [1] and rec.counters == {"echo.dropped": 1}


@pytest.mark.parametrize("device_counts", [False, True])
def test_the_echo_forms_its_dropped_count_where_asked(device_counts):
    """The full-scale echo on the CPU's dense spreader (the card's route
    forms its cells the same way): its ``echo.dropped`` is formed only
    where the recording asks, as ``hrws_recon_k4``'s set-up does, and the
    raw and the spans are the same either way."""
    sc, opts, t0, traj, scene = _fullscale()
    opts = dataclasses.replace(opts, freq_spreader="dense")

    def raw():
        return echo.multi_channel_phase_history(
            traj, scene, opts, t_start=t0,
            rx_offsets=sc.channels.rx_offsets(), device="cpu")
    off = raw()
    with recording(device_counts=device_counts) as rec:
        on = raw()
    assert torch.equal(off, on)
    assert rec.counters == ({"echo.dropped": 0} if device_counts else {})
    assert "echo/echo.synthesize/echo.chunk/echo.spread" in rec.tree()


def test_recording_does_not_nest_and_ends_on_error():
    with pytest.raises(ValueError):
        with recording():
            with pytest.raises(RuntimeError, match="already recording"):
                with recording():
                    pass
            raise ValueError
    assert span("echo") is span("focus")             # off again


def test_spans_share_the_profilers_clock():
    """A span around a torch op, under a host-activity torch.profiler run,
    holds that op's interval as kineto stamps it."""
    a = torch.randn(200, 200)
    with recording() as rec, profile(activities=[ProfilerActivity.CPU]) \
            as prof:
        with span("mm"):
            a @ a
    (mm,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm"]
    (s,) = rec.spans
    assert s.start_ns <= mm.start_ns() <= mm.end_ns() <= s.end_ns


# --------------------------------------------------------------------------
# the documented span trees of the two main paths, at CPU sizes
# --------------------------------------------------------------------------

def _fullscale():
    """ati_dpca cut to 257 x 256 on the cell's NUFFT echo (freq, centred
    window), a destroyer in 40 clutter points."""
    sc = config.ati_dpca()
    sc = sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                  pulse_width_s=2e-6, fs_hz=150e6),
        collect=dataclasses.replace(sc.collect, echo_backend="freq",
                                    window_start_mode="centered",
                                    integration_time_s=257 / 6000.0,
                                    window_length_s=256 / 150e6))
    r, g, c = sc.radar, sc.geometry, sc.collect
    opts = dataclasses.replace(echo_opts_for(sc), max_elements=40_000)
    t0 = echo.window_start_time(g.slant_range_m, opts, c.window_length_s,
                                c.window_start_mode)
    traj = orbit.make_trajectory(g, orbit.slow_time_grid(
        c.integration_time_s, c.num_pulses(r.prf_hz)))
    scene = targets.PointTargets.concatenate([
        targets.destroyer().rotate_z(90.0),
        clutter.ocean_clutter_field(np.random.default_rng(5),
                                    num_points=40)])
    return sc, opts, t0, traj, scene


def _fullscale_product(path="composed"):
    sc, opts, t0, traj, scene = _fullscale()
    raw = echo.multi_channel_phase_history(
        traj, scene, opts, t_start=t0, rx_offsets=sc.channels.rx_offsets(),
        device="cpu")
    p = gmti.focus_and_products(raw, sc, t0, path=path)
    return [raw, p.slc1, p.slc2, p.ati_phase, p.dpca_mag, p.velocity_map,
            p.detections.snr, p.cancellation_ratio, p.cal_phase]


def _video():
    """The VideoSAR preset cut to a 0.8 s collect of 3 frames, presum 2."""
    sc = config.videosar()
    sc = sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                  pulse_width_s=2e-6, fs_hz=150e6,
                                  prf_hz=500.0),
        collect=dataclasses.replace(sc.collect,
                                    window_length_s=9000 / 150e6),
        processing=dataclasses.replace(sc.processing, bp_grid=128,
                                       bp_scene_size_m=400.0, bp_presum=2),
        video=config.VideoConfig(duration_s=0.8, fps=5.0, cpi_s=0.4))
    return sc


def _ring(**kw):
    """The ring cell's route at :func:`_video`'s size: fast_pallas, the
    ring, noise per segment (``kw``: another route)."""
    kw = {"bp_backend": "fast_pallas", "stream_spectra": "ring", **kw}
    return videosar.run(_video(), targets.destroyer(), heading_deg=45.0,
                        speed_mps=15.0, noise_mode="per_segment",
                        seed=2 ** 40 + 7, device="cpu", **kw)


@pytest.mark.parametrize("path", ["composed", "kernel_fused"])
def test_fullscale_span_tree_and_outputs(path):
    """The CSA route (composed) or the CPI kernels' (their plain versions
    on the CPU)."""
    off = _fullscale_product(path)
    with recording() as rec:
        on = _fullscale_product(path)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    rows = off[0].shape[0] * off[0].shape[1]     # channels x pulses
    p0 = [s.attrs["p0"] for s in rec.spans if s.name == "echo.chunk"]
    chunks = len(p0)
    assert chunks >= 2 and p0 == list(range(0, rows, p0[1]))
    syn = "echo/echo.synthesize"
    assert {k: v[0] for k, v in rec.tree().items()} == {
        "echo": 1, "echo/echo.fields": 1, syn: 1,
        f"{syn}/echo.chunk": chunks, f"{syn}/echo.chunk/echo.spread": chunks,
        f"{syn}/echo.chunk/echo.conv": chunks,
        f"{syn}/echo.chunk/echo.edge": chunks,
        "focus": 1, "focus/focus.shift": 1, "focus/focus.factors": 1,
        {"composed": "focus/focus.csa",
         "kernel_fused": "focus/focus.cpi_kernels"}[path]: 1,
        "focus/focus.products": 1,
        **({f"focus/focus.cpi_kernels/focus.{k}": 1
            for k in ("k1g", "k2", "k3g", "k4")}
           if path == "kernel_fused" else {})}
    # a 256 x 256 CPI: no axis by chirp-z or by the mixed-radix plan
    assert rec.counters == ({"cpi.chirpz_axes": 0, "cpi.mixed_radix_axes": 0}
                            if path == "kernel_fused" else {})


@pytest.mark.parametrize("k1_impl", ["fused2ch", "split"])
@pytest.mark.parametrize("shape", [(64, 128), (90, 165), (64, 120),
                                   (97, 128)])
def test_cpi_kernel_spans_and_counters(shape, k1_impl):
    """Each CPI kernel under its span (the split route's balance, K1 and
    K2 single a channel), and the counters: the CPI's azimuth transforms
    (forward, inverse) by chirp-z where n_az is not a power of two, its
    range transforms by the mixed-radix plan where n_rg is not one up to
    4096."""
    n_az, n_rg = shape
    f = csa.csa_factors(csa.CsaParams(
        wavelength_m=0.03, chirp_rate=6e13, fs_hz=150e6, prf_hz=6000.0,
        velocity_mps=7600.0, range_ref_m=6e5, t_start_fast=4e-3,
        num_pulses=n_az, num_samples=n_rg))
    rng = np.random.default_rng(3)
    x = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
         for _ in range(4)]
    with recording() as rec:
        fused.gmti_cpi(*x, f, k1_impl=k1_impl)
    tree = {k: v[0] for k, v in rec.tree().items()}
    if k1_impl == "fused2ch":
        want = {"focus.k1g": 1, "focus.k2": 1}
    else:
        want = {"focus.balance": 1, "focus.k1": 2, "focus.k2": 2}
    assert tree == {**want, "focus.k3g": 1, "focus.k4": 1}
    odd_az = n_az & (n_az - 1) != 0
    assert rec.counters == {"cpi.chirpz_axes": 2 * odd_az,
                            "cpi.mixed_radix_axes": 2 * (n_rg != 128)}


def test_ring_span_tree_counters_and_frames():
    off = _ring()
    with recording() as rec:
        on = _ring()
    assert np.array_equal(off.images, on.images)
    n_f = on.images.shape[0]
    steps = on.schedule.cpi_pulses // on.schedule.step_pulses
    segs = n_f - 1 + steps
    assert n_f >= 2 and steps >= 2
    fr, bp = "videosar.run/frame", "videosar.run/frame/frame.bp"
    assert {k: v[0] for k, v in rec.tree().items()} == {
        "videosar.run": 1, "videosar.run/bp.plan": 1, fr: n_f,
        f"{fr}/frame.traj": n_f, f"{fr}/segment.echo": segs,
        f"{fr}/segment.noise": segs, f"{fr}/segment.spectra": segs,
        f"{fr}/frame.bp": n_f, f"{bp}/bp.recentre": n_f,
        f"{bp}/bp.fit": n_f, f"{bp}/bp.accumulate": n_f,
        f"{bp}/bp.finalize": n_f, f"{bp}/bp.droop": n_f,
        "videosar.run/frame.fetch": n_f}
    assert rec.counters == {"segment.echoed": segs}
    (root,) = [s for s in rec.spans if s.name == "videosar.run"]
    assert root.attrs == {"frames": n_f}
    assert all(s.root_id == root.id for s in rec.spans)
    assert [s.attrs["f"] for s in rec.spans if s.name == "frame"] \
        == list(range(n_f))
    # the frame closes before its image is fetched
    frames = [s for s in rec.spans if s.name == "frame"]
    fetches = [s for s in rec.spans if s.name == "frame.fetch"]
    assert all(not (f.start_ns <= g.start_ns < f.end_ns)
               for f in frames for g in fetches)


def test_batch_route_spans_and_reused_segments():
    """The batch route (frames formed in batches from concatenated
    segments): a ``frame.bp`` and a ``frame.fetch`` a batch, and every
    segment of a CPI after the first echoed once and then reused."""
    kw = dict(bp_backend="fast", stream_spectra=False, frames_per_batch=2)
    off = _ring(**kw)
    with recording() as rec:
        on = _ring(**kw)
    assert np.array_equal(off.images, on.images)
    n_f = on.images.shape[0]
    steps = on.schedule.cpi_pulses // on.schedule.step_pulses
    batches = -(-n_f // 2)
    segs = n_f - 1 + steps
    run, bp = "videosar.run", "videosar.run/frame.bp"
    assert {k: v[0] for k, v in rec.tree().items()} == {
        run: 1, f"{run}/bp.plan": 1, f"{run}/segment.echo": segs,
        f"{run}/segment.noise": segs, bp: batches,
        f"{bp}/bp.recentre": n_f, f"{bp}/bp.fit": n_f,
        f"{bp}/bp.accumulate": n_f, f"{bp}/bp.finalize": n_f,
        f"{bp}/bp.droop": n_f, f"{run}/frame.fetch": batches}
    assert rec.counters == {"segment.echoed": segs,
                            "segment.reused": n_f * steps - segs}
