"""spread_roofline (%, layer: kernels): The NUFFT spread's least time for
all its launches of one product (bench_torch/work/spread.py, at the
pass's shapes) over its device time a product in the trace; kernels
whose name matches r"spread_windows_kernel". Source: device_trace. Moves
product_ms."""

from bench_torch.readers import roofline_product

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"
PATTERN = r"spread_windows_kernel"


def read(tr, shapes):
    return roofline_product(tr, shapes, PATTERN, "spread")
