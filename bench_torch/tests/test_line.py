"""BENCHMARK.json against the benchmark's rules, and the result line."""

import json
import re
from pathlib import Path

import pytest

from bench_torch import core

ROOT = core.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def spec():
    return core.load_spec()


def test_top_level_and_sizes(spec):
    assert set(spec) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51
    n = 24
    assert 338 * (spec["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(spec["command"]) <= 32


def test_names_units_and_entry_keys(spec):
    seen = set()
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[sec]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for e in spec["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in e["reduced"])
        cfg = json.loads((ROOT / e["file"]).read_text())
        assert set(e["reduced"]) == set(cfg["reduced"])
        assert cfg["source"] == e["source"]
    for e in spec["workloads"]:
        assert set(e) == {"name", "config", "traffic", "chips", "why"}
        assert e["chips"] == 1 and len(e["why"]) <= 200
        t = json.loads((core.BENCH / "traffic" / f"{e['traffic']}.json")
                       .read_text())
        assert (core.BENCH / "kinds" / f"{t['kind']}.py").is_file()
    for sec in ("end_to_end", "per_layer"):
        for m in spec[sec]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in {x["name"] for x in spec["end_to_end"]}
        assert (core.BENCH / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer(spec):
    for c in spec["workloads"]:
        e2e = {m["name"] for m in core.cell_metrics(spec, "end_to_end",
                                                    c["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.cell_metrics(spec, "per_layer", c["name"])


def test_result_line_keys_and_checks_last():
    line = json.loads(core.result_line(
        True, 10, 0, {"product_ms": {"value": 5.1, "unit": "ms"}},
        {"platform": "gpu", "kind": "x", "count": 1,
         "memory_peak_bytes": 5}, [("a", 1e-6, 1e-3)],
        {"device_ops": [["k", 1.0]], "idle_gaps": []}))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["checks"]["a"] == {"value": 1e-6, "limit": 1e-3}


def test_checks_fail_on_nan_and_over_the_limit():
    assert core.checks_ok([("a", 0.5, 1.0)])
    assert not core.checks_ok([("a", 1.5, 1.0)])
    assert not core.checks_ok([("a", float("nan"), 1.0)])


def test_nothing_imports_jax_or_the_jax_package():
    bad = re.compile(r"^\s*(import|from)\s+(jax|nis_sar_amtigmti_video_tpu"
                     r"(?!_torch)|bench\b)", re.M)
    for p in Path(core.BENCH).rglob("*.py"):
        assert not bad.search(p.read_text()), p
