"""The per-layer readers and the breakdown on synthetic traces."""

import types

import pytest

from bench_torch import core, peaks, trace
from bench_torch.readers import BENCH, load


def ev(name, a, b, dev, note=False):
    return types.SimpleNamespace(
        name=name, device_type="DeviceType.CUDA" if dev else "CPU",
        is_user_annotation=note,
        time_range=types.SimpleNamespace(start=a, end=b))


FS = ("void (anonymous namespace)::forward_spectra_kernel<2, 8>"
      "(float const*)")
K2 = "void (anonymous namespace)::k2_kernel<4096>(K2Args)"
FFT = "void vector_fft<32768u, 8u>(float2*)"


def synthetic(products=2):
    """A 10 ms window: forward spectra 1-2 ms and 6-7 ms, K2 2-3 ms, a cuFFT kernel
    3-4 ms, a copy 8-8.5 ms; runtime calls on the host around them."""
    events = [ev("cudaLaunchKernel", 0, 100, False),
              ev("cudaLaunchKernel", 4_000, 5_500, False),
              ev("cudaStreamSynchronize", 7_000, 8_000, False),
              ev("cudaMemcpyAsync", 7_500, 10_000, False),
              ev(FS, 1_000, 2_000, True), ev(FS, 6_000, 7_000, True),
              ev(K2, 2_000, 3_000, True), ev(FFT, 3_000, 4_000, True),
              ev("Memcpy DtoH (Device -> Pageable)", 8_000, 8_500, True),
              ev("bench.span", 500, 600, True, True)]     # an annotation
    return trace.from_events(events, products, 0.010, {"echo": [0.5, 0.7]})


def metric(name):
    return core.metric_module(name).read


def test_busy_idle_and_launches():
    tr = synthetic()
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s == pytest.approx(0.0045)
    assert metric("device_idle_share")(tr, {}) == pytest.approx(55.0)
    assert metric("launches_per_product")(tr, {}) == pytest.approx(2.0)
    assert metric("torch_ops_ms")(tr, {}) == pytest.approx(0.5)
    assert metric("echo_ms")(tr, {}) == pytest.approx(600.0)
    assert metric("focus_ms")(tr, {}) is None


def test_roofline_reads_the_work_over_the_mean_launch():
    tr = synthetic()
    s = {"forward_spectra": {"pulses": 500, "ns": 22004, "nfft": 32768}}
    w = load(BENCH / "work" / "forward_spectra.py", "w").work(
        s["forward_spectra"])
    want = 100.0 * peaks.bound_ms(**w) / 1.0          # 1 ms a launch
    assert metric("forward_spectra_roofline")(tr, s) == pytest.approx(want)
    assert metric("accumulate_roofline")(tr, {}) is None  # no shapes
    assert metric("recentre_from_spectra_roofline")(
        tr, {"recentre_from_spectra": dict(cpi=2500, ns=22004, nfft=32768,
                                           n_out=625, band=1920)}) is None


def test_breakdown_lists_ops_and_gaps_by_host_activity():
    b = trace.breakdown(synthetic())
    ops = dict(b["device_ops"])
    assert ops["forward_spectra_kernel"] == pytest.approx(0.002)
    assert list(ops)[0] == "forward_spectra_kernel"
    gaps = dict(b["idle_gaps"])
    assert gaps["cudaLaunchKernel"] == pytest.approx(0.002)     # 4-6 ms
    assert gaps["cudaMemcpyAsync"] == pytest.approx(0.0025)  # 7-8, 8.5-10
    assert gaps["python"] == pytest.approx(0.001)               # 0-1 ms
    assert sum(gaps.values()) == pytest.approx(0.0055)
    assert all(len(x) == 2 for x in b["device_ops"] + b["idle_gaps"])


def test_bare_names():
    assert trace.bare_name(FS) == "forward_spectra_kernel<2, 8>"
    assert trace.base_name(K2) == "k2_kernel"
    assert trace.base_name("Memcpy DtoH (Device -> Pageable)") \
        == "Memcpy DtoH"


def test_every_per_layer_metric_has_a_reader_that_says_what_it_moves():
    spec = core.load_spec()
    for m in spec["per_layer"]:
        mod = core.metric_module(m["name"])
        assert mod.SOURCE == m["source"] and mod.MOVES == m["moves"]
        assert mod.UNIT == m["unit"]
