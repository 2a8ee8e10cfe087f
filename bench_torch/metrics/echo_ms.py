"""echo_ms (ms, layer: simulation): the benchmark's own span around
ops/echo.py::multi_channel_phase_history in a product, closed by a
synchronise (traced runs only), mean over the traced products. Source:
host_clock. Moves product_ms."""

SOURCE, MOVES, UNIT = "host_clock", "product_ms", "ms"


def read(tr, shapes):
    v = tr.spans.get("echo")
    return 1e3 * sum(v) / len(v) if v else None
