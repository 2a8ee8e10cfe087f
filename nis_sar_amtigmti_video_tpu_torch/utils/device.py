"""Where the port's entry points put their work."""

from __future__ import annotations

import torch


def entry_device(device=None) -> torch.device:
    """The device of an entry point (``models.*.run`` and friends): the one
    given, else the card. Without CUDA an entry point never falls back to
    the CPU quietly: it raises and asks for ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: entry points run on the card by default; pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
