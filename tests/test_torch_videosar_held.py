"""The held-collect path of ``videosar.run`` (``raw=``): a recorded collect
formed frame by frame from views of it, against the simulated per-segment
path on the same pulses (bit for bit), against the plain float64
reference of the benchmark (bench_torch/reference/bp_frames.py) within the
cell ``videosar_frames_a``'s limits, which the reference in bfloat16
fails; no CPI is copied; the spans and the counter; and the errors. CPU,
tiny scenarios, the kernels' plain versions."""

import copy
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from bench_torch.reference import bp_frames
from bench_torch.spotlight import Collect, compare
from bench_torch.tests.tiny import VIDEO_TINY
from nis_sar_amtigmti_video_tpu_torch import config
from nis_sar_amtigmti_video_tpu_torch.models import videosar
from nis_sar_amtigmti_video_tpu_torch.ops import bp_fast
from nis_sar_amtigmti_video_tpu_torch.scene import targets as T
from nis_sar_amtigmti_video_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MOVER = dict(heading_deg=90.0, speed_mps=30.0)
SEED = 2 ** 31 + 777


def _scenario(window=9000, grid=32):
    """A 1 s collect at PRF 1 kHz: 1,000 pulses of 9,000 samples (nfft
    16,384), four 0.4 s CPIs stepping 200 pulses, 32^2 frames."""
    sc = config.videosar()
    return sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                  pulse_width_s=2e-6, fs_hz=150e6,
                                  prf_hz=1000.0),
        collect=dataclasses.replace(sc.collect,
                                    window_length_s=window / 150e6),
        processing=dataclasses.replace(sc.processing, bp_grid=grid,
                                       bp_scene_size_m=400.0),
        video=config.VideoConfig(duration_s=1.0, fps=5.0, cpi_s=0.4))


def _target():
    return T.point_target((0.0, 0.0, 0.0), 50.0)


@pytest.fixture(scope="module")
def collect():
    """The tiny scenario's collect, recorded as the simulated path echoes
    it per segment with its noise."""
    return videosar.record(_scenario(), _target(), seed=SEED, device=CPU,
                           **MOVER)


@pytest.mark.parametrize("backend", ["fast", "fast_factor", "exact"])
def test_held_equals_the_simulated_run(monkeypatch, collect, backend):
    """run(raw=R) is the simulated per-segment run frame for frame, bit
    for bit, where R is that run's own segments (echo plus noise)
    concatenated: both form each CPI by the same calls on the same
    values, a view of R against a torch.cat of the segments. R is what
    ``record`` gives."""
    segments = {}
    orig = videosar._segment_raw

    def spy(sc, g, s, step, seed, dev):
        segments[s] = orig(sc, g, s, step, seed, dev)
        return segments[s]
    monkeypatch.setattr(videosar, "_segment_raw", spy)
    kw = dict(algorithm="mbp", bp_backend=backend, frames_per_batch=2,
              device=CPU, **MOVER)
    sim = videosar.run(_scenario(), _target(), noise_mode="per_segment",
                       seed=SEED, stream_spectra=False, **kw)
    raw = torch.cat([segments[s] for s in sorted(segments)])
    assert sorted(segments) == list(range(5))
    assert torch.equal(raw, collect)
    held = videosar.run(_scenario(), _target(), raw=raw, **kw)
    assert held.images.shape == sim.images.shape == (4, 32, 32)
    np.testing.assert_array_equal(held.images, sim.images)
    np.testing.assert_array_equal(held.schedule.starts, sim.schedule.starts)


def test_record_adds_the_noise_with_a_seed(collect):
    clean = videosar.record(_scenario(), _target(), device=CPU, **MOVER)
    assert clean.shape == collect.shape and clean.dtype == torch.complex64
    noise = (collect - clean).abs()
    assert float(noise.max()) > 0.01 * float(clean.abs().max())


@pytest.mark.parametrize("indices,fpb", [(None, 4), ([0, 1, 3], 4),
                                         ([1, 3], 2)],
                         ids=["contiguous", "gaps", "stride"])
def test_held_frames_are_views_of_the_collect(monkeypatch, collect, indices,
                                              fpb):
    """Each frame handed to the formation is a row window of the collect
    itself (its storage, at its start's offset): no CPI is copied, for
    the whole schedule, a subset with gaps and a subset two steps apart."""
    seen = []
    orig = bp_fast.focus_bp_fast

    def spy(raw, *a, **kw):
        seen.append(raw)
        return orig(raw, *a, **kw)
    monkeypatch.setattr(bp_fast, "focus_bp_fast", spy)
    out = videosar.run(_scenario(), _target(), bp_backend="fast", raw=collect,
                       frame_indices=indices, frames_per_batch=fpb,
                       device=CPU, **MOVER)
    ns = collect.shape[1]
    assert len(seen) == len(out.schedule.starts)
    for raw, s in zip(seen, out.schedule.starts):
        assert raw.untyped_storage().data_ptr() \
            == collect.untyped_storage().data_ptr()
        assert raw.data_ptr() == collect.data_ptr() + 8 * int(s) * ns
        assert raw.shape == (out.schedule.cpi_pulses, ns)
        assert raw.is_contiguous()


def test_held_spans_and_counter(collect):
    with profiling.recording() as rec:
        videosar.run(_scenario(), _target(), bp_backend="fast", raw=collect,
                     device=CPU, **MOVER)
    tree = rec.tree()
    assert rec.counters["frame.held"] == 4
    assert tree["videosar.run/frame"][0] == 4
    assert tree["videosar.run/frame/frame.traj"][0] == 4
    assert tree["videosar.run/frame/frame.bp"][0] == 4
    assert tree["videosar.run/frame/frame.bp/bp.recentre"][0] == 4
    assert not any("segment" in k for k in tree)       # nothing simulated


def test_held_frames_within_the_cells_limits_of_the_reference():
    """At a tiny size at which the fast backprojection holds its budget
    (128^2 frames over 200 m of a 400-pulse collect), the held path's
    frames are within the cell's limits of the exact float64
    backprojection of the same held CPI; the reference in bfloat16 is
    outside at least one."""
    cfg = json.loads((REPO / "bench_torch" / "configs"
                      / "videosar_spotlight_held.json").read_text())
    limits = json.loads((REPO / "bench_torch" / "traffic"
                         / "videosar_frames_a.json").read_text())["limits"]
    cfg["scenario"] = copy.deepcopy(VIDEO_TINY)
    cfg["scenario"]["processing"]["bp_scene_size_m"] = 200.0
    c = Collect(cfg, SEED, CPU, "fast_pallas")
    ship = T.destroyer()
    raw = videosar.record(c.sc, ship, heading_deg=c.heading,
                          speed_mps=c.speed, seed=SEED, avg_rcs=5000.0,
                          device=CPU)
    imgs = videosar.run(c.sc, ship, heading_deg=c.heading, speed_mps=c.speed,
                        bp_backend="fast_pallas", raw=raw, device=CPU).images
    f = 1
    s0 = int(c.sched.starts[f])
    cpi = raw[s0:s0 + c.sched.cpi_pulses].to(torch.complex128)
    traj = c.frame_traj(f, CPU)
    want = bp_frames.frame(cpi, *traj, c.vf, c.t0, c.ref_params, "f64")
    got = compare(torch.as_tensor(imgs[f]), want)
    assert all(got[k] <= v for k, v in limits.items()), got
    ctl = compare(bp_frames.frame(cpi, *traj, c.vf, c.t0, c.ref_params,
                                  "bf16"), want)
    assert sum(ctl[k] > v for k, v in limits.items()) >= 1, ctl


def _zeros(p, ns, dtype=torch.complex64):
    return torch.zeros((p, ns), dtype=dtype)


# the tiny scenario's collect is 1,000 x 9,000
ERRORS = {
    "pulses": (r"\(1000, 9000\), not \(999, 9000\)",
               dict(raw=_zeros(999, 9000))),
    "samples": (r"\(1000, 9000\), not \(1000, 9001\)",
                dict(raw=_zeros(1000, 9001))),
    "dtype": ("complex64 tensor, not torch.complex128",
              dict(raw=_zeros(1000, 9000, torch.complex128))),
    "not_contiguous": ("contiguous",
                       dict(raw=_zeros(9000, 1000).t())),
    "seed": ("pass no seed", dict(raw=_zeros(1000, 9000), seed=1)),
    "stream_spectra": ("stream_spectra must be False",
                       dict(raw=_zeros(1000, 9000), stream_spectra="ring",
                            bp_backend="fast_factor")),
    "csa": ("backprojection", dict(raw=_zeros(1000, 9000),
                                   algorithm="csa")),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_held_errors(monkeypatch, name):
    """Each refusal is a ValueError naming what is wrong, before any
    formation."""
    def no_formation(*a, **kw):
        raise AssertionError("formed before the check")
    monkeypatch.setattr(bp_fast, "focus_bp_fast", no_formation)
    match, kw = ERRORS[name]
    with pytest.raises(ValueError, match=match):
        videosar.run(_scenario(), _target(), device=CPU, **kw)
