"""k3_roofline (%, layer: kernels): K3's least time for all its launches of
one product (bench_torch/work/k3.py, at the product's plane shape) over its
device time a product in the trace; kernels whose name matches
r"k3_kernel<" (not K3g's ``k3g_kernel``). Source: device_trace. Moves
product_ms."""

from bench_torch.readers import roofline_product

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"
PATTERN = r"k3_kernel<"


def read(tr, shapes):
    return roofline_product(tr, shapes, PATTERN, "k3")
