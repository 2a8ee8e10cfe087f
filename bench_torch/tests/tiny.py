"""The cells' configurations cut to sizes a CPU test holds, for rehearsals
of the harness (the kernels' plain versions run on CPU tensors)."""

from __future__ import annotations

import copy

from bench_torch import core

VIDEO_TINY = {"preset": "videosar",
              "radar": {"bandwidth_hz": 120e6, "pulse_width_s": 2e-6,
                        "fs_hz": 150e6, "prf_hz": 500.0},
              "collect": {"window_length_s": 9000 / 150e6},
              "processing": {"bp_grid": 128, "bp_scene_size_m": 400.0},
              "video": {"duration_s": 0.8, "fps": 5.0, "cpi_s": 0.4}}


def cell(workload: str):
    """(spec, cfg, traffic) of a cell, cut to a CPU size."""
    spec = core.load_spec()
    _, _, cfg, traffic = core.resolve(spec, workload)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    kind = traffic["kind"]
    if kind == "sim_focus":
        cfg["scenario"].update(
            radar={"bandwidth_hz": 120e6, "pulse_width_s": 2e-6,
                   "fs_hz": 150e6}, pulses=257, samples=256)
        cfg["scene"]["clutter_points"] = 40
        traffic["pulses"] = 3
    elif kind == "videosar_run":
        cfg["scenario"] = copy.deepcopy(VIDEO_TINY)
        traffic["frames"] = 2
    else:
        raise KeyError(kind)
    return spec, cfg, traffic
