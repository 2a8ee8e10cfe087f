"""recentre_from_spectra_roofline (%, layer: kernels): Recentre from
spectra's least time for one launch's work
(bench_torch/work/recentre_from_spectra.py, at the cell's shapes) over
its mean device time a launch in the trace; kernels whose name matches
r"recentre_spectra_kernel<". Source: device_trace. Moves product_ms."""

from bench_torch.readers import roofline

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"
PATTERN = r"recentre_spectra_kernel<"


def read(tr, shapes):
    return roofline(tr, shapes, PATTERN, "recentre_from_spectra")
