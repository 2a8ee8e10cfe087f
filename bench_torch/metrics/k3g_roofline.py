"""k3g_roofline (%, layer: kernels): K3g's least time for all its launches of
one CPI (both chirp-z stages where n_az takes them)
(bench_torch/work/k3g.py, at the CPI's shape) over its device time a
product in the trace; kernels whose name matches r"k3g_kernel<". Source:
device_trace. Moves product_ms."""

from bench_torch.readers import roofline_product

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"
PATTERN = r"k3g_kernel<"


def read(tr, shapes):
    return roofline_product(tr, shapes, PATTERN, "k3g")
