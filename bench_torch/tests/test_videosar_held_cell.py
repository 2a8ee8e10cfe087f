"""A CPU rehearsal of the cell videosar_frames_a (the kind videosar_held)
at a tiny size with the kernels' plain versions: its window, the traced
window's readers, the check and the result line; the control (the
reference in bfloat16 in the program's place) and answers altered
underneath come out not correct; a program without the held path fails at
set-up; recentre + presum's work at the upstream's CPI against the bound
of PERF.md's table of kernels, and its reader on a synthetic trace.

    python -m pytest -q bench_torch/tests/test_videosar_held_cell.py"""

import copy
import json
import math
import time
import types

import numpy as np
import pytest
import torch

from bench_torch import core, peaks, run, trace
from bench_torch.readers import BENCH, load
from bench_torch.tests.tiny import VIDEO_TINY

CPU = torch.device("cpu")
SEED = 2 ** 31 + 2468           # above 32 signed bits, as run seeds may be
CELL = "videosar_frames_a"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


def tiny():
    """(spec, cfg, traffic) of the cell cut to two 400 x 9,000 collects of
    three 128^2 frames over 200 m (a size at which the fast
    backprojection holds the cell's limits)."""
    spec = core.load_spec()
    _, _, cfg, traffic = core.resolve(spec, CELL)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["scenario"] = copy.deepcopy(VIDEO_TINY)
    cfg["scenario"]["processing"]["bp_scene_size_m"] = 200.0
    return spec, cfg, traffic


def one_run(traced, cfg=None, traffic=None, seconds=0.3):
    spec, cfg0, traffic0 = tiny()
    return json.loads(run.run_cell(
        spec, CELL, cfg or cfg0, traffic or traffic0, SEED, seconds,
        traced, CPU, t_start=time.perf_counter()))


@pytest.mark.parametrize("traced", [False, True])
def test_a_run_on_the_cpu(traced):
    spec, cfg, traffic = tiny()
    line = one_run(traced, cfg, traffic)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert line["attempted"] >= 3 and line["attempted"] % 3 == 0
    assert set(line["checks"]) == set(traffic["limits"])
    assert line["device"]["platform"] == "cpu"
    if traced:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        want = {m["name"] for m in core.cell_metrics(spec, "end_to_end",
                                                     CELL)}
        assert set(line["metrics"]) == want


def test_the_cell_reports_its_metrics():
    """setup_s and product_ms among the end-to-end metrics; recentre +
    presum's roofline and the metrics of every cell among the per-layer
    ones, and none of a path the cell does not run."""
    spec = core.load_spec()
    e2e = {m["name"] for m in core.cell_metrics(spec, "end_to_end", CELL)}
    assert {"setup_s", "product_ms", "peak_mem_gib"} <= e2e
    per = {m["name"] for m in core.cell_metrics(spec, "per_layer", CELL)}
    assert per == {"recenter_presum_roofline", "device_idle_share",
                   "launches_per_product", "torch_ops_ms"}


def test_the_set_up_holds_two_collects_called_in_turn(monkeypatch):
    from nis_sar_amtigmti_video_tpu_torch.models import videosar
    _, cfg, traffic = tiny()
    drv = core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)
    assert len(drv.held) == 2 and drv.units == 3
    assert drv.held[0].shape == (400, 9000)
    assert not torch.equal(drv.held[0], drv.held[1])     # noise of its own
    seen = []
    orig = videosar.run

    def spy(*a, raw=None, **kw):
        seen.append(raw)
        return orig(*a, raw=raw, **kw)
    monkeypatch.setattr(videosar, "run", spy)
    for i in range(3):
        drv.product(i)
    assert [s is drv.held[i % 2] for i, s in enumerate(seen)] == [True] * 3


def test_the_control_is_not_correct():
    """The reference in bfloat16 in the program's place fails a limit; the
    program (the kernels' plain versions) passes them all."""
    _, cfg, traffic = tiny()
    drv = core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)
    drv.warm()
    core.Window(drv, 0.1).run(stop=lambda n, el: n >= 2)
    lim = traffic["limits"]
    ctl = drv.numbers("bf16")
    assert sum(ctl[k] > v for k, v in lim.items()) >= 1, ctl
    ok = drv.numbers()
    assert all(ok[k] <= v for k, v in lim.items()), ok


def _limits_from_sound_runs():
    """3x the tiny size's sound readings, so that a fault shows against
    what the program reads and not against the cell's room."""
    _, cfg, traffic = tiny()
    drv = core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)
    drv.warm()
    core.Window(drv, 0.1).run(stop=lambda n, el: n >= 2)
    t = copy.deepcopy(traffic)
    t["limits"] = {k: 3.0 * v for k, v in drv.numbers().items()}
    return cfg, t


@pytest.mark.parametrize("fault", ["phase", "half_pulses", "wrong_offset"])
def test_a_held_frame_altered_is_not_correct(monkeypatch, fault):
    """A frame turned 0.1 rad, half of each CPI's pulses left out and the
    rest doubled, or each CPI taken a quarter CPI away from its start in
    the collect: each comes out not correct."""
    cfg, t = _limits_from_sound_runs()
    from nis_sar_amtigmti_video_tpu_torch.models import videosar
    from nis_sar_amtigmti_video_tpu_torch.ops import bp_fast
    if fault == "phase":
        orig = videosar.run

        def broken(*a, **kw):
            out = orig(*a, **kw)
            imgs = out.images.copy()
            imgs[1] *= complex(math.cos(0.1), math.sin(0.1))
            return out._replace(images=imgs)
        monkeypatch.setattr(videosar, "run", broken)
    elif fault == "half_pulses":
        orig = bp_fast.focus_bp_fast

        def broken(raw, *a, **kw):
            r = 2.0 * raw
            r[: r.shape[0] // 2] = 0
            return orig(r, *a, **kw)
        monkeypatch.setattr(bp_fast, "focus_bp_fast", broken)
    else:
        orig = bp_fast.focus_bp_fast

        def broken(raw, *a, **kw):
            # raw is a row window of the collect: the same rows a quarter
            # CPI later in it (earlier where that would leave the collect)
            ns, off = raw.shape[1], raw.shape[0] // 4
            if raw.storage_offset() + (off + raw.shape[0]) * ns \
                    > raw.untyped_storage().nbytes() // raw.element_size():
                off = -off
            return orig(raw.as_strided(raw.shape, raw.stride(),
                                       raw.storage_offset() + off * ns),
                        *a, **kw)
        monkeypatch.setattr(bp_fast, "focus_bp_fast", broken)
    line = one_run(False, cfg, t)
    assert line["correct"] is False, line["checks"]


def test_a_program_without_the_held_path_fails_at_set_up(monkeypatch):
    """As the parent program, which has no ``videosar.record``: an error
    at set-up, before any frame is formed."""
    from nis_sar_amtigmti_video_tpu_torch.models import videosar
    monkeypatch.delattr(videosar, "record")
    _, cfg, traffic = tiny()
    with pytest.raises(AttributeError, match="record"):
        core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)


# config.videosar()'s CPI: 2,500 x 22,004, nfft 32,768, presum 4, band rows
# (82, 97); PERF.md's bound 0.134 ms (bytes)
CPI = dict(cpi=2500, ns=22004, nfft=32768, n_out=625, band=15 * 128)


def test_recenter_presum_bound_matches_perf_table():
    w = load(BENCH / "work" / "recenter_presum.py",
             "work_recenter_presum").work(CPI)
    assert peaks.bound_ms(**w) == pytest.approx(0.134, rel=6e-3, abs=6e-4)
    assert peaks.bound_by(**w) == "bytes"


def _ev(name, a, b, dev):
    return types.SimpleNamespace(
        name=name, device_type="DeviceType.CUDA" if dev else "CPU",
        is_user_annotation=False,
        time_range=types.SimpleNamespace(start=a, end=b))


def test_the_reader_finds_recenter_presum():
    """Two launches of 1.0 and 1.5 ms among other kernels: the bound over
    their mean; no launch, or no shapes, reads nothing."""
    rp = ("void (anonymous namespace)::recenter_presum_kernel<256, 8>"
          "(float2 const*, float2 const*, Traj, Tables, float2*)")
    other = ("void (anonymous namespace)::recentre_spectra_kernel<256, 8>"
             "(float2 const*)")
    events = [_ev("cudaLaunchKernel", 0, 50, False),
              _ev(rp, 100, 1_100, True), _ev(other, 1_200, 1_700, True),
              _ev(rp, 2_000, 3_500, True),
              _ev("void accumulate_kernel<64>(AccArgs)", 4_000, 9_000, True)]
    tr = trace.from_events(events, 2, 0.010)
    read = core.metric_module("recenter_presum_roofline").read
    w = load(BENCH / "work" / "recenter_presum.py", "w").work(CPI)
    want = 100.0 * peaks.bound_ms(**w) / 1.25
    assert read(tr, {"recenter_presum": CPI}) == pytest.approx(want)
    assert read(tr, {}) is None
    bare = trace.from_events([e for e in events if e.name != rp], 2, 0.010)
    assert read(bare, {"recenter_presum": CPI}) is None
    assert np.isfinite(want) and 0 < want < 100
