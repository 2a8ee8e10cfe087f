"""k4_roofline (%, layer: kernels): K4's least time for its launch of one CPI
(bench_torch/work/k4.py, at the CPI's shape) over its device time a
product in the trace; kernels whose name matches r"k4_kernel". Source:
device_trace. Moves product_ms."""

from bench_torch.readers import roofline_product

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"
PATTERN = r"k4_kernel"


def read(tr, shapes):
    return roofline_product(tr, shapes, PATTERN, "k4")
