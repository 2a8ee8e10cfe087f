"""accumulate_roofline (%, layer: kernels): The pixel-tile accumulate's
least time for one launch's work (bench_torch/work/accumulate.py, at the
cell's shapes) over its mean device time a launch in the trace; kernels
whose name matches r"accumulate_kernel<64>". Source: device_trace. Moves
product_ms."""

from bench_torch.readers import roofline

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"
PATTERN = r"accumulate_kernel<64>"


def read(tr, shapes):
    return roofline(tr, shapes, PATTERN, "accumulate")
