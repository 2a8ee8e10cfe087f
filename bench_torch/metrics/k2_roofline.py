"""k2_roofline (%, layer: kernels): K2 single's least time for all its
launches of one product (bench_torch/work/k2.py, at the product's plane
shape) over its device time a product in the trace; kernels whose name
matches r"k2_kernel<" (the cell's only K2 is the single). Source:
device_trace. Moves product_ms."""

from bench_torch.readers import roofline_product

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"
PATTERN = r"k2_kernel<"


def read(tr, shapes):
    return roofline_product(tr, shapes, PATTERN, "k2")
