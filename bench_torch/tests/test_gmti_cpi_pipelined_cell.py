"""A CPU rehearsal of the cell gmti_cpi_pipelined (the kind
gmti_cpi_pipelined: the CPI stream with two CPIs in flight) at the CPI
stream's tiny CPI, with the kernels' plain versions: its window and the
traced window's readers, the check and the result line; product i issues
CPI i + 1 before it serves CPI i, and serves what the CPI stream serves;
the limits are the CPI stream's.

    python -m pytest -q bench_torch/tests/test_gmti_cpi_pipelined_cell.py"""

import copy
import json
import time

import pytest
import torch

from bench_torch import core, run

CPU = torch.device("cpu")
SEED = 2 ** 31 + 8111           # above 32 signed bits, as run seeds may be
CELL = "gmti_cpi_pipelined"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


def tiny(cell=CELL):
    """(spec, cfg, traffic) of a CPI cell cut to a 97 x 165 CPI after the
    shift (as the CPI stream's rehearsal), 40 clutter points."""
    spec = core.load_spec()
    _, _, cfg, traffic = core.resolve(spec, cell)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["scenario"].update(
        radar={"bandwidth_hz": 120e6, "pulse_width_s": 2e-6,
               "fs_hz": 150e6}, pulses=98, samples=165)
    cfg["scene"]["clutter_points"] = 40
    traffic["inputs"] = 2
    return spec, cfg, traffic


@pytest.mark.parametrize("traced", [False, True])
def test_a_run_on_the_cpu(traced):
    spec, cfg, traffic = tiny()
    line = json.loads(run.run_cell(spec, CELL, cfg, traffic, SEED, 0.3,
                                   traced, CPU, t_start=time.perf_counter()))
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert line["attempted"] >= 1
    assert set(line["checks"]) == set(traffic["limits"])
    if not traced:
        want = {m["name"] for m in core.cell_metrics(spec, "end_to_end",
                                                     CELL)}
        assert set(line["metrics"]) == want


def test_the_cell_reports_its_metrics():
    spec = core.load_spec()
    per = {m["name"] for m in core.cell_metrics(spec, "per_layer", CELL)}
    assert per == {"k1g_roofline", "k2_pair_roofline", "k3g_roofline",
                   "k4_roofline", "device_idle_share",
                   "launches_per_product", "torch_ops_ms"}


def test_the_limits_and_inputs_are_the_cpi_streams():
    _, cfg, traffic = core.resolve(core.load_spec(), CELL)[1:]
    _, cfg0, traffic0 = core.resolve(core.load_spec(),
                                     "gmti_cpi_fullscale_stream")[1:]
    assert cfg == cfg0
    assert traffic["limits"] == traffic0["limits"]
    assert (traffic["inputs"], traffic["path"], traffic["sample"]) \
        == (traffic0["inputs"], traffic0["path"], traffic0["sample"])


def test_two_cpis_are_in_flight(monkeypatch):
    """Product i issues CPI i + 1 before it serves CPI i (CPI 0 and 1 at
    the first product, then one a product), and serves the CPI stream's
    numbers for the same CPI."""
    from nis_sar_amtigmti_video_tpu_torch.models import gmti
    _, cfg, traffic = tiny()
    _, cfg0, traffic0 = tiny("gmti_cpi_fullscale_stream")
    pipe = core.kind_module(traffic).setup(cfg, traffic, SEED, CPU)
    plain = core.kind_module(traffic0).setup(cfg0, traffic0, SEED, CPU)
    issued = []
    orig = gmti.focus_and_products

    def spy(raw, *a, **kw):
        issued.append(next(k for k, r in enumerate(pipe.raws) if r is raw))
        return orig(raw, *a, **kw)
    monkeypatch.setattr(gmti, "focus_and_products", spy)
    served = [pipe.product(i) for i in range(3)]
    assert issued == [0, 1, 0, 1]
    monkeypatch.setattr(gmti, "focus_and_products", orig)
    for i, s in enumerate(served):
        assert torch.equal(s, plain.product(i))
    pipe.release()
    assert pipe._next is None
