"""launches_per_product (launches, layer: model orchestration): device
kernels launched in the traced window over the products completed in it
(copies and memsets not counted). A count that repeats exactly from run to
run. Source: device_trace. Moves product_ms: each launch costs host time
before it."""

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "launches"


def read(tr, shapes):
    if tr.products <= 0 or not tr.kernels():
        return None
    return len(tr.kernels()) / tr.products
