"""forward_spectra_roofline (%, layer: kernels): Forward spectra's least
time for one launch's work (bench_torch/work/forward_spectra.py, at the
cell's shapes) over its mean device time a launch in the trace; kernels
whose name matches r"forward_spectra_kernel<". Source: device_trace.
Moves product_ms."""

from bench_torch.readers import roofline

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"
PATTERN = r"forward_spectra_kernel<"


def read(tr, shapes):
    return roofline(tr, shapes, PATTERN, "forward_spectra")
