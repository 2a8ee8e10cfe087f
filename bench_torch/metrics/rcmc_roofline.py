"""rcmc_roofline (%, layer: kernels): the RCMC kernel's least time a launch
(bench_torch/work/rcmc.py, at the product's plane shape) over its mean
device time a launch in the trace; kernels whose name matches
r"rcmc_kernel<". Source: device_trace. Moves product_ms."""

from bench_torch.readers import roofline

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"
PATTERN = r"rcmc_kernel<"


def read(tr, shapes):
    return roofline(tr, shapes, PATTERN, "rcmc")
