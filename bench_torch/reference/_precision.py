"""The working types of a reference mode."""

from __future__ import annotations

import torch

MODES = ("f64", "bf16")


def check(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown reference mode {mode!r}: {MODES}")


def ctype(mode: str):
    return torch.complex128 if mode == "f64" else torch.complex64


def rtype(mode: str):
    return torch.float64 if mode == "f64" else torch.float32


def q(x: torch.Tensor, mode: str) -> torch.Tensor:
    """x as the mode stores it: unchanged in 'f64'; each real part rounded
    to bfloat16 (and back to float32) in 'bf16'."""
    if mode == "f64":
        return x
    if x.is_complex():
        return torch.complex(x.real.to(torch.bfloat16).float(),
                             x.imag.to(torch.bfloat16).float())
    return x.to(torch.bfloat16).float()


def expj(phase64: torch.Tensor, mode: str) -> torch.Tensor:
    """exp(j phase) from a float64 phase, stored as the mode stores it."""
    z = torch.polar(torch.ones_like(phase64), phase64)
    return q(z.to(ctype(mode)), mode)
