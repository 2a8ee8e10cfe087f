"""A CPU rehearsal of the cell gmti_cpi_fullscale_stream (the kind
gmti_cpi) at a tiny CPI whose sides are not powers of two, with the
kernels' plain versions: its window, the traced window's readers, the
check and the result line; the controls (the reference in bfloat16 in
the program's place, answers altered underneath) come out not correct;
a program whose kernels do not take the CPI fails at set-up, before any
echo; and the four kernels' work at the upstream's CPI against the bounds
of PERF.md's table of kernels.

    python -m pytest -q bench_torch/tests/test_gmti_cpi_cell.py"""

import copy
import json
import time

import pytest
import torch

from bench_torch import core, peaks, run
from bench_torch.readers import BENCH, load

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4321           # above 32 signed bits, as run seeds may be
CELL = "gmti_cpi_fullscale_stream"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


def tiny():
    """(spec, cfg, traffic) of the cell cut to a 97 x 165 CPI after the
    shift (a prime azimuth side, an odd range side), 40 clutter points."""
    spec = core.load_spec()
    _, _, cfg, traffic = core.resolve(spec, CELL)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["scenario"].update(
        radar={"bandwidth_hz": 120e6, "pulse_width_s": 2e-6,
               "fs_hz": 150e6}, pulses=98, samples=165)
    cfg["scene"]["clutter_points"] = 40
    traffic["inputs"] = 2
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
    else:
        want = {m["name"] for m in core.cell_metrics(spec, "end_to_end",
                                                     CELL)}
        assert set(line["metrics"]) == want


def test_the_cell_reports_its_metrics():
    """setup_s and product_ms among the end-to-end metrics; the four
    kernels' rooflines and the metrics of every cell among the per-layer
    ones."""
    spec = core.load_spec()
    e2e = {m["name"] for m in core.cell_metrics(spec, "end_to_end", CELL)}
    assert {"setup_s", "product_ms"} <= e2e
    per = {m["name"] for m in core.cell_metrics(spec, "per_layer", CELL)}
    assert {"k1g_roofline", "k2_pair_roofline", "k3g_roofline",
            "k4_roofline", "device_idle_share", "launches_per_product",
            "torch_ops_ms"} <= per
    assert not per & {"echo_ms", "focus_ms", "spread_roofline"}


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


@pytest.mark.parametrize("fault", ["cal", "dpca", "slc_row", "snr"])
def test_an_answer_altered_is_not_correct(monkeypatch, fault):
    from nis_sar_amtigmti_video_tpu_torch.models import gmti
    orig = gmti.focus_and_products

    def broken(*a, **kw):
        p = orig(*a, **kw)
        if fault == "cal":
            return p._replace(cal_phase=p.cal_phase + 0.01)
        if fault == "dpca":
            return p._replace(dpca_mag=p.dpca_mag * 1.05)
        if fault == "snr":
            d = p.detections
            return p._replace(detections=d._replace(snr=d.snr * 1.5))
        s = p.slc1.clone()
        s[s.shape[0] // 2] = 0
        return p._replace(slc1=s)
    monkeypatch.setattr(gmti, "focus_and_products", broken)
    assert one_run(False)["correct"] is False


def test_a_program_whose_kernels_refuse_the_cpi_fails_at_set_up(
        monkeypatch):
    """As an earlier program without the kernels' other sides does: a
    ValueError before any echo is simulated."""
    from nis_sar_amtigmti_video_tpu_torch.ops import echo
    from nis_sar_amtigmti_video_tpu_torch.ops.cuda import csa_kernel
    monkeypatch.setattr(csa_kernel, "supported", lambda *a: False)

    def no_echo(*a, **kw):
        raise AssertionError("echo simulated before the shape check")
    monkeypatch.setattr(echo, "multi_channel_phase_history", no_echo)
    _, cfg, traffic = tiny()
    with pytest.raises(ValueError, match="do not take"):
        core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)


# the upstream's CPI after the DPCA shift; PERF.md's bounds (bytes)
CPI = dict(n_az=7199, n_rg=13200)
WORK = [("k1g", 0.908), ("k2_pair", 0.908), ("k3g", 1.475), ("k4", 1.021)]


@pytest.mark.parametrize("name,want_ms", WORK, ids=[w[0] for w in WORK])
def test_cpi_kernel_bound_matches_perf_table(name, want_ms):
    w = load(BENCH / "work" / f"{name}.py", f"work_{name}").work(CPI)
    assert peaks.bound_ms(**w) == pytest.approx(want_ms, rel=6e-3,
                                                abs=6e-4)
    assert peaks.bound_by(**w) == "bytes"


def test_cpi_roofline_readers_find_their_kernels():
    """Each reader's pattern takes its kernel's instantiations (the
    chirp-z stages and the mixed-radix K2 included) and no other."""
    names = {"k1g": ["k1_kernel<2, 16, 32, 32, 1>",
                     "k1_kernel<2, 8, 32, 16, 0>"],
             "k2_pair": ["k2_kernel<0>", "k2_kernel<4096>"],
             "k3g": ["k3g_kernel<16, 32, 32, 2>"],
             "k4": ["k4_kernel"]}
    others = ["k1_kernel<1, 16, 32, 32, 1>", "k3_kernel<16, 32, 32, 2>",
              "balance_kernel"]
    import re
    for name, hits in names.items():
        pat = load(BENCH / "metrics" / f"{name}_roofline.py",
                   f"m_{name}").PATTERN
        assert all(re.match(pat, h) for h in hits), name
        assert not any(re.match(pat, o) for o in others), name
