"""A CPU rehearsal of the cell stripmap_rda_fullscale (the kind
stripmap_focus) at a tiny collect, with the RCMC kernel's plain version:
the plain reference (bench_torch/reference/rda.py) against the port's RDA
on the same raw; the cell's window, the traced window's readers, the check
and the result line; the controls (the reference in bfloat16 in the
program's place, answers altered underneath) come out not correct; the
warm product refuses a zero fill the geometry does not give; and the RCMC
kernel's work at the upstream's collect against the bound of PERF.md's
table of kernels.

    python -m pytest -q bench_torch/tests/test_stripmap_cell.py"""

import copy
import dataclasses
import json
import re
import time

import numpy as np
import pytest
import torch

from bench_torch import core, peaks, run, scenario
from bench_torch.readers import BENCH, load
from bench_torch.reference import rda as ref_rda
from bench_torch.sampling import rel_rms

CPU = torch.device("cpu")
SEED = 2 ** 31 + 6007           # above 32 signed bits, as run seeds may be
CELL = "stripmap_rda_fullscale"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


def tiny():
    """(spec, cfg, traffic) of the cell cut to 96 pulses x 385 samples (an
    odd range side) of the CLI's small waveform, 40 clutter points, two
    inputs."""
    spec = core.load_spec()
    _, _, cfg, traffic = core.resolve(spec, CELL)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["scenario"].update(
        radar={"bandwidth_hz": 120e6, "pulse_width_s": 2e-6,
               "fs_hz": 150e6}, pulses=96, samples=385)
    cfg["scene"]["clutter_points"] = 40
    traffic["inputs"] = 2
    return spec, cfg, traffic


def one_run(traced, cfg=None, traffic=None, seconds=0.3):
    spec, cfg0, traffic0 = tiny()
    return json.loads(run.run_cell(
        spec, CELL, cfg or cfg0, traffic or traffic0, SEED, seconds,
        traced, CPU, t_start=time.perf_counter()))


@pytest.mark.parametrize("n_az", [96, 95])
def test_the_reference_is_the_ports_rda(n_az):
    """The float64 reference and the port's RDA (the kernel's plain
    version) on one noise raw, even and odd azimuth sides: equal to the
    port's float32 rounding."""
    from nis_sar_amtigmti_video_tpu_torch.models import stripmap
    _, cfg, _ = tiny()
    sc = scenario.build(cfg)
    rng = np.random.default_rng(5)
    raw = torch.from_numpy((rng.standard_normal((n_az, 385))
                            + 1j * rng.standard_normal((n_az, 385)))
                           .astype(np.complex64))
    slc, _ = stripmap.focus(raw, sc, 0.0, intermediates=False)
    r, g = sc.radar, sc.geometry
    want = ref_rda.focus(raw, dict(
        wavelength_m=r.wavelength_m, pulse_width_s=r.pulse_width_s,
        chirp_rate=r.chirp_rate, fs_hz=r.fs_hz, prf_hz=r.prf_hz,
        velocity_mps=g.effective_velocity_mps, range_ref_m=g.slant_range_m))
    assert want.dtype == torch.complex128
    assert rel_rms(slc, want) < 2e-6
    # the control is another number
    ctl = ref_rda.focus(raw, dict(
        wavelength_m=r.wavelength_m, pulse_width_s=r.pulse_width_s,
        chirp_rate=r.chirp_rate, fs_hz=r.fs_hz, prf_hz=r.prf_hz,
        velocity_mps=g.effective_velocity_mps, range_ref_m=g.slant_range_m),
        "bf16")
    assert rel_rms(ctl, want) > 1e-3


@pytest.mark.parametrize("traced", [False, True])
def test_a_run_on_the_cpu(traced):
    spec, cfg, traffic = tiny()
    line = one_run(traced, cfg, traffic)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert line["attempted"] >= 1
    assert set(line["checks"]) == set(traffic["limits"])
    assert line["device"]["platform"] == "cpu"
    if traced:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the device readers find no device trace on the CPU
        assert "rcmc_roofline" not in line["metrics"]
    else:
        want = {m["name"] for m in core.cell_metrics(spec, "end_to_end",
                                                     CELL)}
        assert set(line["metrics"]) == want


def test_the_cell_reports_its_metrics():
    """setup_s and product_ms among the end-to-end metrics; the RCMC
    kernel's roofline and the metrics of every cell among the per-layer
    ones, and none of the other cells'."""
    spec = core.load_spec()
    e2e = {m["name"] for m in core.cell_metrics(spec, "end_to_end", CELL)}
    assert {"setup_s", "product_ms"} <= e2e
    per = {m["name"] for m in core.cell_metrics(spec, "per_layer", CELL)}
    assert per == {"rcmc_roofline", "device_idle_share",
                   "launches_per_product", "torch_ops_ms"}


def test_the_product_is_the_ports_entry(monkeypatch):
    """A product calls models/stripmap.py::focus once, with no viewer
    planes, and the RCMC through the kernel's wrapper."""
    from nis_sar_amtigmti_video_tpu_torch.models import stripmap
    from nis_sar_amtigmti_video_tpu_torch.ops.cuda import rcmc_kernel
    calls = []
    orig, orig_k = stripmap.focus, rcmc_kernel.rcmc_filter

    def spy(*a, **kw):
        calls.append(kw.get("intermediates"))
        return orig(*a, **kw)

    def spy_k(*a, **kw):
        calls.append("rcmc_filter")
        return orig_k(*a, **kw)
    monkeypatch.setattr(stripmap, "focus", spy)
    monkeypatch.setattr(rcmc_kernel, "rcmc_filter", spy_k)
    _, cfg, traffic = tiny()
    drv = core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)
    drv.product(0)
    assert calls == [False, "rcmc_filter"]


def test_the_control_is_not_correct():
    """The reference in bfloat16 in the program's place fails a limit; the
    program (the kernel's plain version) passes them all."""
    _, cfg, traffic = tiny()
    drv = core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)
    drv.warm()
    core.Window(drv, 0.1).run(stop=lambda n, el: n >= 3)
    lim = traffic["limits"]
    ctl = drv.numbers("bf16")
    assert sum(ctl[k] > v for k, v in lim.items()) >= 1, ctl
    ok = drv.numbers()
    assert all(ok[k] <= v for k, v in lim.items()), ok


@pytest.mark.parametrize("fault", ["row", "peak", "phase"])
def test_an_answer_altered_is_not_correct(monkeypatch, fault):
    from nis_sar_amtigmti_video_tpu_torch.models import stripmap
    orig = stripmap.focus

    def broken(*a, **kw):
        slc, prod = orig(*a, **kw)
        slc = slc.clone(memory_format=torch.contiguous_format)
        if fault == "row":
            slc[slc.shape[0] // 2] = 0
        elif fault == "peak":
            i = int(torch.argmax(slc.abs()))
            slc.view(-1)[i] *= 1.1
        else:
            slc = slc * complex(torch.polar(torch.tensor(1.0),
                                            torch.tensor(0.3)))
        return slc, prod
    monkeypatch.setattr(stripmap, "focus", broken)
    assert one_run(False)["correct"] is False


def test_a_focus_without_the_migration_is_refused(monkeypatch):
    """The same chain with the migration left in (the geometry's delta_R
    factor zero): the warm product's zero-fill count refuses it, and its
    products fail the check."""
    from nis_sar_amtigmti_video_tpu_torch.ops import rda
    orig = rda.rcmc_tables
    monkeypatch.setattr(rda, "rcmc_tables",
                        lambda p, device: orig(p, device)._replace(lam2=0.0))
    _, cfg, traffic = tiny()
    drv = core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)
    with pytest.raises(RuntimeError, match="zero-filled 0 cells"):
        drv.warm()
    for i in range(3):
        drv.product(i)
    assert not core.checks_ok(drv.check())


def test_an_unexpected_zero_fill_fails_the_warm_product(monkeypatch):
    _, cfg, traffic = tiny()
    kind = core.kind_module(traffic)
    drv = kind.setup(cfg, traffic, SEED, CPU)
    want = kind.zero_filled(*drv.raws[0].shape, drv.r)
    assert want > 0
    monkeypatch.setattr(kind, "zero_filled", lambda *a: want + 1)
    with pytest.raises(RuntimeError, match="zero-filled"):
        drv.warm()


def test_an_echo_that_drops_targets_fails_at_set_up(monkeypatch):
    """The dense spreader's group windows cut to a size that cannot hold
    a group drop (pulse, target) pairs, and set-up refuses the raw."""
    from nis_sar_amtigmti_video_tpu_torch.models import stripmap
    orig = stripmap.echo_opts_for

    def narrow(sc):
        return dataclasses.replace(orig(sc), freq_spreader="dense",
                                   freq_spread_win=512, freq_spread_grp=1)
    monkeypatch.setattr(stripmap, "echo_opts_for", narrow)
    _, cfg, traffic = tiny()
    with pytest.raises(RuntimeError, match="dropped"):
        core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)


def test_a_configuration_off_the_exact_rcmc_fails_at_set_up():
    _, cfg, traffic = tiny()
    cfg["scenario"]["processing"]["rcmc_mode"] = "fast"
    with pytest.raises(ValueError, match="exact RCMC"):
        core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)


def test_the_upstream_collect_zero_fills_the_far_ends():
    """At 7,200 x 13,200 the exact RCMC zero-fills the cells past the
    source grid's far end: ~13 a row, none in the zero-Doppler row."""
    _, cfg, _ = core.resolve(core.load_spec(), CELL)[1:3] + (None,)
    sc = scenario.build(cfg)
    r, g = sc.radar, sc.geometry
    kind = load(BENCH / "kinds" / "stripmap_focus.py", "k_stripmap")
    n = kind.zero_filled(7200, 13200, dict(
        wavelength_m=r.wavelength_m, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m, fs_hz=r.fs_hz, prf_hz=r.prf_hz))
    assert 7200 * 12 < n < 7200 * 14


def test_kernel_bound_matches_perf_table():
    """PERF.md's bound: 0.454 ms of bytes at the upstream's 7,200 x
    13,200."""
    w = load(BENCH / "work" / "rcmc.py", "work_rcmc").work(
        dict(n_az=7200, n_rg=13200))
    assert peaks.bound_ms(**w) == pytest.approx(0.454, rel=6e-3)
    assert peaks.bound_by(**w) == "bytes"


def test_the_roofline_reader_finds_its_kernel():
    pat = load(BENCH / "metrics" / "rcmc_roofline.py", "m_rcmc").PATTERN
    assert re.match(pat, "rcmc_kernel<0, false>")
    assert re.match(pat, "rcmc_kernel<1, true>")
    assert not re.match(pat, "k1_kernel<1, 8, 32, 1, 2>")
