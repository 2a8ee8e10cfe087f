"""device_idle_share (%, layer: device): the share of the traced window's
wall time in which no operation ran on the card (one stream, so the union
of the device intervals is the busy time). Source: device_trace. Moves
product_ms: host work between kernels is time a product waits."""

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "%"


def read(tr, shapes):
    if tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
