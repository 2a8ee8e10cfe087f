"""k2_pair_roofline (%, layer: kernels): K2 pair's least time for its launch
of one CPI (bench_torch/work/k2_pair.py, at the CPI's shape) over its
device time a product in the trace; kernels whose name matches
r"k2_kernel<". Source: device_trace. Moves product_ms."""

from bench_torch.readers import roofline_product

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"
PATTERN = r"k2_kernel<"


def read(tr, shapes):
    return roofline_product(tr, shapes, PATTERN, "k2_pair")
