"""A CPU rehearsal of the cell hrws_recon_k4 (the kind hrws_focus) at a
tiny collect whose unfolded azimuth side is not a power of two, with the
kernels' plain versions: its window, the traced window's readers, the
check and the result line; the controls (the reference in bfloat16 in the
program's place, answers altered underneath) come out not correct; a
program whose kernels do not take the unfolded shape fails at set-up,
before any echo, and so does an echo that drops targets; and the three
kernels' work at the upstream's CPI against the bounds of PERF.md's table
of kernels.

    python -m pytest -q bench_torch/tests/test_hrws_cell.py"""

import copy
import json
import re
import time

import pytest
import torch

from bench_torch import core, peaks, run
from bench_torch.readers import BENCH, load

CPU = torch.device("cpu")
SEED = 2 ** 31 + 2207           # above 32 signed bits, as run seeds may be
CELL = "hrws_recon_k4"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


def tiny():
    """(spec, cfg, traffic) of the cell cut to 4 channels of 48 pulses x
    165 samples (192 x 165 unfolded: an azimuth side that is not a power
    of two, an odd range side), 40 clutter points."""
    spec = core.load_spec()
    _, _, cfg, traffic = core.resolve(spec, CELL)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["scenario"].update(
        radar={"prf_hz": 1500.0, "bandwidth_hz": 120e6,
               "pulse_width_s": 2e-6, "fs_hz": 150e6},
        pulses=48, samples=165)
    cfg["scene"]["clutter_points"] = 40
    traffic.update(inputs=2, rec_cols=32)
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
    assert line["attempted"] >= 1
    assert set(line["checks"]) == set(traffic["limits"])
    assert line["device"]["platform"] == "cpu"
    if traced:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the host span is the benchmark's own; the device readers find no
        # device trace on the CPU
        assert line["metrics"]["reconstruct_ms"]["value"] > 0
    else:
        want = {m["name"] for m in core.cell_metrics(spec, "end_to_end",
                                                     CELL)}
        assert set(line["metrics"]) == want


def test_the_cell_reports_its_metrics():
    """setup_s and product_ms among the end-to-end metrics; the
    reconstruction's span, the three kernels' rooflines and the metrics of
    every cell among the per-layer ones, and none of the other cells'."""
    spec = core.load_spec()
    e2e = {m["name"] for m in core.cell_metrics(spec, "end_to_end", CELL)}
    assert {"setup_s", "product_ms"} <= e2e
    per = {m["name"] for m in core.cell_metrics(spec, "per_layer", CELL)}
    assert per == {"reconstruct_ms", "k1_roofline", "k2_roofline",
                   "k3_roofline", "device_idle_share",
                   "launches_per_product", "torch_ops_ms"}


def test_the_product_is_the_ports_entry(monkeypatch):
    """An untraced product calls models/hrws.py::reconstruct_focus on the
    kernel route, once."""
    from nis_sar_amtigmti_video_tpu_torch.models import hrws
    calls = []
    orig = hrws.reconstruct_focus

    def spy(*a, **kw):
        calls.append(a[3] if len(a) > 3 else kw.get("fft_impl"))
        return orig(*a, **kw)
    monkeypatch.setattr(hrws, "reconstruct_focus", spy)
    _, cfg, traffic = tiny()
    drv = core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)
    drv.product(0)
    assert calls == ["pallas"]


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


@pytest.mark.parametrize("fault", ["rec", "slc_row", "peak", "phase"])
def test_an_answer_altered_is_not_correct(monkeypatch, fault):
    from nis_sar_amtigmti_video_tpu_torch.models import hrws
    orig = hrws.reconstruct_focus

    def broken(*a, **kw):
        rec, slc = orig(*a, **kw)
        if fault == "rec":
            return rec * 1.01, slc
        slc = slc.clone()
        if fault == "slc_row":
            slc[slc.shape[0] // 2] = 0
        elif fault == "peak":
            i = int(torch.argmax(slc.abs()))
            slc.view(-1)[i] *= 1.1
        else:
            slc = slc * complex(torch.polar(torch.tensor(1.0),
                                            torch.tensor(0.3)))
        return rec, slc
    monkeypatch.setattr(hrws, "reconstruct_focus", broken)
    assert one_run(False)["correct"] is False


def test_a_program_whose_kernels_refuse_the_shape_fails_at_set_up(
        monkeypatch):
    """As a program without the kernels' other sides does: a ValueError
    before any echo is simulated."""
    from nis_sar_amtigmti_video_tpu_torch.ops import echo
    from nis_sar_amtigmti_video_tpu_torch.ops.cuda import csa_kernel
    monkeypatch.setattr(csa_kernel, "supported", lambda *a: False)

    def no_echo(*a, **kw):
        raise AssertionError("echo simulated before the shape check")
    monkeypatch.setattr(echo, "multi_channel_phase_history", no_echo)
    _, cfg, traffic = tiny()
    with pytest.raises(ValueError, match="do not take"):
        core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)


def test_an_echo_that_drops_targets_fails_at_set_up(monkeypatch):
    """The set-up counts the (pulse, target) pairs the echo's spread drops
    (``echo.dropped``) and refuses a raw that lost any: here the dense
    spreader's group windows are cut to a size that cannot hold a group."""
    from nis_sar_amtigmti_video_tpu_torch.models import stripmap
    orig = stripmap.echo_opts_for

    def narrow(sc):
        import dataclasses
        return dataclasses.replace(orig(sc), freq_spreader="dense",
                                   freq_spread_win=512,
                                   freq_spread_grp=1)
    monkeypatch.setattr(stripmap, "echo_opts_for", narrow)
    _, cfg, traffic = tiny()
    with pytest.raises(RuntimeError, match="dropped"):
        core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)


# the upstream's CPI after the DPCA shift; PERF.md's bounds (bytes)
CPI = dict(n_az=7199, n_rg=13200)
WORK = [("k1", 0.454), ("k2", 0.454), ("k3", 0.454)]


@pytest.mark.parametrize("name,want_ms", WORK, ids=[w[0] for w in WORK])
def test_kernel_bound_matches_perf_table(name, want_ms):
    w = load(BENCH / "work" / f"{name}.py", f"work_{name}").work(CPI)
    assert peaks.bound_ms(**w) == pytest.approx(want_ms, rel=6e-3,
                                                abs=6e-4)
    assert peaks.bound_by(**w) == "bytes"


def test_roofline_readers_find_their_kernels():
    """Each reader's pattern takes its kernel's instantiations (the
    chirp-z stage included) and not the two-channel kernels'."""
    names = {"k1": ["k1_kernel<1, 16, 32, 32, 1>",
                    "k1_kernel<1, 8, 32, 16, 0>"],
             "k2": ["k2_kernel<0>", "k2_kernel<4096>"],
             "k3": ["k3_kernel<16, 32, 32, 1>", "k3_kernel<8, 32, 16, 0>"]}
    others = {"k1": ["k1_kernel<2, 16, 32, 32, 1>", "k3_kernel<16, 32, 32,"
                     " 1>"],
              "k2": ["k1_kernel<1, 16, 32, 32, 1>", "k3_kernel<16, 32, 32,"
                     " 1>"],
              "k3": ["k3g_kernel<16, 32, 32, 2>", "k1_kernel<1, 16, 32, 32,"
                     " 1>"]}
    for name, hits in names.items():
        pat = load(BENCH / "metrics" / f"{name}_roofline.py",
                   f"m_{name}").PATTERN
        assert all(re.match(pat, h) for h in hits), name
        assert not any(re.match(pat, o) for o in others[name]), name
