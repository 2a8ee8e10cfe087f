"""recenter_presum_roofline (%, layer: kernels): Recentre + presum's
least time for one launch's work (bench_torch/work/recenter_presum.py, at
the cell's shapes) over its mean device time a launch in the trace;
kernels whose name matches r"recenter_presum_kernel<". Source:
device_trace. Moves product_ms."""

from bench_torch.readers import roofline

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"
PATTERN = r"recenter_presum_kernel<"


def read(tr, shapes):
    return roofline(tr, shapes, PATTERN, "recenter_presum")
