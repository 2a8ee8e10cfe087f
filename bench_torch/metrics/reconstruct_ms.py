"""reconstruct_ms (ms, layer: products): the benchmark's own span around
models/hrws.py::reconstruct in a product, closed by a synchronise (traced
runs only), mean over the traced products. Source: host_clock. Moves
product_ms."""

SOURCE, MOVES, UNIT = "host_clock", "product_ms", "ms"


def read(tr, shapes):
    v = tr.spans.get("reconstruct")
    return 1e3 * sum(v) / len(v) if v else None
