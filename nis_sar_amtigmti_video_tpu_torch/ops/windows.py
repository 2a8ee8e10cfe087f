"""Window / taper functions.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/windows.py``: the same
windows, computed in float64 and cast to ``dtype`` (float32 by default).
The upstream tapers with scipy's symmetric Hamming
(``sar_satellite_sim.py:382,396``); :func:`hamming` reproduces it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def hamming(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Symmetric Hamming window (scipy.signal.windows.hamming, sym=True)."""
    if n == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    m = torch.arange(n, dtype=torch.float64, device=device)
    return (0.54 - 0.46 * torch.cos(2.0 * math.pi * m / (n - 1))).to(dtype)


def hann(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    if n == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    m = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * m / (n - 1))).to(dtype)


def rectangular(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones((n,), dtype=dtype, device=device)


def taylor(n: int, nbar: int = 4, sll_db: float = -30.0,
           dtype=torch.float32, device=None) -> torch.Tensor:
    """Taylor taper, the usual SAR sidelobe-control window (not in the
    upstream; offered for production imaging)."""
    a = np.arccosh(10.0 ** (-sll_db / 20.0)) / np.pi
    sigma2 = nbar ** 2 / (a ** 2 + (nbar - 0.5) ** 2)
    m = np.arange(1, nbar)
    fm = np.empty(nbar - 1)
    for i, mi in enumerate(m):
        num = np.prod(1.0 - mi ** 2 / (sigma2 * (a ** 2 + (m - 0.5) ** 2)))
        den = np.prod([1.0 - mi ** 2 / j ** 2 for j in m if j != mi])
        fm[i] = (-1.0) ** (mi + 1) * num / (2.0 * den)
    x = (np.arange(n) - (n - 1) / 2.0) / n
    w = 1.0 + 2.0 * np.sum(fm[:, None] * np.cos(2.0 * np.pi * m[:, None]
                                                 * x[None, :]), axis=0)
    return torch.as_tensor(w / w.max(), device=device).to(dtype)


WINDOWS = {
    "hamming": hamming,
    "hann": hann,
    "rect": rectangular,
    "rectangular": rectangular,
    "taylor": taylor,
    "none": rectangular,
}


def get_window(name: str, n: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    try:
        fn = WINDOWS[name]
    except KeyError:
        raise ValueError(f"unknown window {name!r}; options: "
                         f"{sorted(WINDOWS)}") from None
    return fn(n, dtype=dtype, device=device)
