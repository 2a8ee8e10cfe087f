"""k1g_roofline (%, layer: kernels): K1g's least time for all its launches of
one CPI (both chirp-z stages where n_az takes them)
(bench_torch/work/k1g.py, at the CPI's shape) over its device time a
product in the trace; kernels whose name matches r"k1_kernel<2,". Source:
device_trace. Moves product_ms."""

from bench_torch.readers import roofline_product

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"
PATTERN = r"k1_kernel<2,"


def read(tr, shapes):
    return roofline_product(tr, shapes, PATTERN, "k1g")
