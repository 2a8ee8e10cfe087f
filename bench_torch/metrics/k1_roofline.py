"""k1_roofline (%, layer: kernels): K1's least time for all its launches of
one product (bench_torch/work/k1.py, at the product's plane shape) over its
device time a product in the trace; kernels whose name matches
r"k1_kernel<1,". Source: device_trace. Moves product_ms."""

from bench_torch.readers import roofline_product

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"
PATTERN = r"k1_kernel<1,"


def read(tr, shapes):
    return roofline_product(tr, shapes, PATTERN, "k1")
