"""A CPU rehearsal of the harness: each cell's set-up at a tiny size, its
window, the traced window's readers, the check and the result line, with
the kernels' plain versions (run_cell skips the look for a card, which
run.py's main makes). Then the controls: the reference in bfloat16 in the
program's place, and the timed path broken underneath, must both come out
not correct.

    python -m pytest -q bench_torch/tests      # from the root, ~4 min"""

import copy
import json
import math
import time

import pytest
import torch

from bench_torch import core, run
from bench_torch.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345          # above 32 signed bits, as run seeds may be


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


def one_run(workload, traced, cfg=None, traffic=None, seconds=0.3):
    spec, cfg0, traffic0 = tiny.cell(workload)
    return json.loads(run.run_cell(
        spec, workload, cfg or cfg0, traffic or traffic0, SEED, seconds,
        traced, CPU, t_start=time.perf_counter()))


def loose(traffic):
    """Limits that hold at the tiny size, to rehearse the plumbing alone
    (the fast backprojection's budget holds at the configuration's size,
    not at this one's)."""
    t = copy.deepcopy(traffic)
    t["limits"] = {k: 10.0 for k in t["limits"]}
    return t


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", ["fullscale_sim_gmti",
                                      "videosar_collect_ring"])
def test_a_run_on_the_cpu(workload, traced):
    spec, cfg, traffic = tiny.cell(workload)
    line = one_run(workload, traced, cfg, loose(traffic))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["checks"]) == set(traffic["limits"])
    assert line["device"]["platform"] == "cpu"
    if traced:
        assert "breakdown" in line and line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        want = {m["name"] for m in core.cell_metrics(spec, "end_to_end",
                                                     workload)}
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for k, v in line["metrics"].items()
                   if k != "peak_mem_gib")


@pytest.mark.parametrize("workload", ["fullscale_sim_gmti",
                                      "videosar_collect_ring"])
def test_the_control_is_not_correct(workload):
    """The reference in bfloat16 in the program's place fails a limit; the
    program itself passes them where the tiny size is representative (the
    echo and the GMTI products; the fast backprojection's accuracy is not,
    at 128^2 frames of a 400-pulse CPI)."""
    spec, cfg, traffic = tiny.cell(workload)
    drv = core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)
    drv.warm()
    core.Window(drv, 0.1).run(stop=lambda n, el: n >= 2)
    lim = traffic["limits"]
    ctl = drv.numbers("bf16")
    assert sum(ctl[k] > v for k, v in lim.items()) >= 1, ctl
    if traffic["kind"] == "sim_focus":
        ok = drv.numbers()
        assert all(ok[k] <= v for k, v in lim.items()), ok


def _gmti_fault(monkeypatch, fault):
    from nis_sar_amtigmti_video_tpu_torch.models import gmti
    orig = gmti.focus_and_products

    def broken(*a, **kw):
        p = orig(*a, **kw)
        if fault == "cal":
            return p._replace(cal_phase=p.cal_phase + 0.01)
        if fault == "dpca":
            return p._replace(dpca_mag=p.dpca_mag * 1.05)
        if fault == "slc_row":
            s = p.slc1.clone()
            s[s.shape[0] // 2] = 0
            return p._replace(slc1=s)
        raise KeyError(fault)
    monkeypatch.setattr(gmti, "focus_and_products", broken)


@pytest.mark.parametrize("fault", ["cal", "dpca", "slc_row"])
def test_a_gmti_answer_altered_is_not_correct(monkeypatch, fault):
    _gmti_fault(monkeypatch, fault)
    line = one_run("fullscale_sim_gmti", False)
    assert line["correct"] is False, line["checks"]


def _vs_limits_from_sound_runs(workload="videosar_collect_ring"):
    """3x the tiny size's sound readings: the tiny frames are no measure
    of the fast backprojection's accuracy, so the faults are held against
    these."""
    spec, cfg, traffic = tiny.cell(workload)
    drv = core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)
    drv.warm()
    core.Window(drv, 0.1).run(stop=lambda n, el: n >= 2)
    t = copy.deepcopy(traffic)
    t["limits"] = {k: 3.0 * v for k, v in drv.numbers().items()}
    return cfg, t


def test_videosar_sound_run_passes_its_own_limits():
    cfg, t = _vs_limits_from_sound_runs()
    line = one_run("videosar_collect_ring", False, cfg, t)
    assert line["correct"] is True, line["checks"]


def test_the_ring_reference_adds_the_collects_noise(monkeypatch):
    """The reference's CPI is the plain echo plus each segment's noise,
    the same for the same seed; without the noise it is the echo."""
    spec, cfg, traffic = tiny.cell("videosar_collect_ring")
    drv = core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)
    noisy = drv.reference_raw(0)
    assert torch.equal(noisy, drv.reference_raw(0))
    from bench_torch.reference import noise
    monkeypatch.setattr(noise, "add", lambda raw, *a: raw)
    clean = drv.reference_raw(0)
    assert float((noisy - clean).abs().max()) > 0.1 * float(clean.abs().max())


def test_the_reference_noise_is_the_collects():
    """The same unit draws, scaled in float64: the reference's noise of a
    segment is the port's to float32 rounding, at the port's SNR."""
    import dataclasses

    from nis_sar_amtigmti_video_tpu_torch import config
    from nis_sar_amtigmti_video_tpu_torch.ops import noise as noise_ops

    from bench_torch.reference import noise
    sc = config.videosar()
    r, g = sc.radar, sc.geometry
    want, _ = noise_ops.snr_db(sc.noise, g.slant_range_m, 5000.0,
                               r.wavelength_m, r.bandwidth_hz, None)
    snr = noise.snr_db(g.slant_range_m, 5000.0, r.wavelength_m,
                       r.bandwidth_hz, dataclasses.asdict(sc.noise))
    assert snr == pytest.approx(want, abs=1e-9)
    gen = torch.Generator().manual_seed(7)
    raw = torch.complex(torch.randn(6, 50, generator=gen),
                        torch.randn(6, 50, generator=gen))
    stream = 1_000_003
    got = noise.add(raw.to(torch.complex128), SEED, stream, snr, 10.0, 1.0)
    port = noise_ops.add_ocean_noise(
        noise_ops.generator(SEED, stream, CPU), raw, snr, 10.0, 1.0,
        ref_power_mode="peak")
    n_got, n_port = got - raw, (port - raw).to(torch.complex128)
    err = float((n_got - n_port).abs().max() / n_port.abs().max())
    assert err < 1e-5


@pytest.mark.parametrize("fault", ["phase", "half_pulses", "no_noise"])
def test_a_ring_frame_altered_is_not_correct(monkeypatch, fault):
    """A frame turned 0.1 rad where it is formed, half of each CPI's
    pulses left out and the rest doubled, or the collect's noise left
    out: each comes out not correct."""
    cfg, t = _vs_limits_from_sound_runs()
    from nis_sar_amtigmti_video_tpu_torch.models import videosar
    from nis_sar_amtigmti_video_tpu_torch.ops import bp_fast
    if fault == "phase":
        orig = videosar.run

        def broken(*a, **kw):
            out = orig(*a, **kw)
            return out._replace(images=out.images * complex(math.cos(0.1),
                                                            math.sin(0.1)))
        monkeypatch.setattr(videosar, "run", broken)
    elif fault == "half_pulses":
        orig = bp_fast.focus_bp_fast

        def broken(*a, raw_spectra=None, **kw):
            sp = 2.0 * raw_spectra
            sp[: sp.shape[0] // 2] = 0
            return orig(*a, raw_spectra=sp, **kw)
        monkeypatch.setattr(bp_fast, "focus_bp_fast", broken)
    else:
        orig = videosar.run

        def broken(*a, **kw):
            return orig(*a, **{**kw, "seed": None})
        monkeypatch.setattr(videosar, "run", broken)
    line = one_run("videosar_collect_ring", False, cfg, t)
    assert line["correct"] is False, line["checks"]


def test_a_fullscale_raw_or_answer_altered_is_not_correct(monkeypatch):
    from nis_sar_amtigmti_video_tpu_torch.ops import echo
    orig = echo.multi_channel_phase_history

    def broken(*a, **kw):         # the second channel's echo left out
        raw = orig(*a, **kw)
        raw[1] = 0
        return raw
    monkeypatch.setattr(echo, "multi_channel_phase_history", broken)
    line = one_run("fullscale_sim_gmti", False)
    assert line["correct"] is False, line["checks"]
