"""torch_ops_ms (ms, layer: PyTorch operators): device ms a product of
every kernel that is not one of the port's hand-written kernels
(bench_torch/readers.py::HAND_WRITTEN): cuFFT, the elementwise, reduction
and copy kernels of the PyTorch operators in ops/*.py and models/*.py.
Source: device_trace. Moves product_ms."""

from bench_torch.readers import is_hand_written

SOURCE, MOVES, UNIT = "device_trace", "product_ms", "ms"


def read(tr, shapes):
    ops = [k for k in tr.kernels() if not is_hand_written(k[0])]
    if tr.products <= 0 or not ops:
        return None
    return sum(b - a for _, a, b in ops) / 1e3 / tr.products
