"""The NUFFT echo's spread (``spread_windows_kernel``), all launches of one
two-channel pass: the main spread (one set of 8 taps) and the exact-edge
spread (two sets of 6) of every pulse chunk.

Copied from ``chip_smoke.py::spread_work``, per launch: the cells and the
values read once, the windows written once (rows x groups x 2 x sets x
win float32); two adds per live target, tap and set. ``shapes`` gives the
first chunk's launches (``launches``: [rows, groups, cells, values, sets,
taps, win, live]) and ``chunks``, the pass's rows over the first chunk's
(every chunk but the last is as large, and the work is linear in the
rows). PERF.md's bound: 0.290 ms a chunk (0.97 GB) at the full-scale
chain's first chunk."""


def launch(rows, groups, cells, values, sets, taps, win, live):
    out = rows * groups * 2 * sets * win
    return 4.0 * (cells + values + out), 2.0 * live * sets * taps


def work(s: dict) -> dict:
    b = f = 0.0
    for ln in s["launches"]:
        lb, lf = launch(*ln)
        b, f = b + lb, f + lf
    return dict(n_bytes=b * s["chunks"], n_flops=f * s["chunks"])
