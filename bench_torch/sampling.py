"""Which products of a window the correctness check keeps: ``k`` of them,
uniform over the window, drawn from the seed (reservoir sampling, so the
choice does not need the window's length in advance)."""

from __future__ import annotations

import numpy as np


class Reservoir:
    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 0x5A4D])
        self.items = {}                 # slot -> (product index, payload)

    def offer(self, i: int, make):
        """Product ``i`` is offered; ``make()`` builds what to keep, called
        only where it is kept."""
        if i < self.k:
            self.items[i] = (i, make())
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = (i, make())

    def kept(self) -> list:
        return [self.items[s] for s in sorted(self.items)]


def rel_rms(got, want) -> float:
    """||got - want|| / ||want|| in float64."""
    import torch
    g = got.to(torch.complex128 if got.is_complex() else torch.float64)
    w = want.to(g.dtype)
    return float(torch.linalg.vector_norm(g - w)
                 / torch.linalg.vector_norm(w).clamp(min=1e-300))
