"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
full 700 W power limit), and the least time a piece of work can take on it.

A roofline share is ``bound_ms(work) / measured ms``: the larger of the
work's bytes over the HBM rate and its operations over the peak of the unit
that does them, whichever takes longest (the units issue side by side)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# sin and cos results a second: the special-function units return 16 a clock
# per SM against 128 f32 FMAs (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0); an FMA is 2 of F32_FLOPS
SFU_PER_S = F32_FLOPS / 16
# dense TF32 tensor-core operations a second
TF32_FLOPS = 495e12


def bound_ms(n_bytes: float = 0.0, n_flops: float = 0.0, n_sfu: float = 0.0,
             n_tc: float = 0.0) -> float:
    """The least ms of the work on the card."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_f = max(n_flops / F32_FLOPS, n_sfu / SFU_PER_S, n_tc / TF32_FLOPS)
    return max(t_b, t_f) * 1e3


def bound_by(n_bytes: float = 0.0, n_flops: float = 0.0, n_sfu: float = 0.0,
             n_tc: float = 0.0) -> str:
    """'bytes' or 'operations': which side sets :func:`bound_ms`."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_f = max(n_flops / F32_FLOPS, n_sfu / SFU_PER_S, n_tc / TF32_FLOPS)
    return "bytes" if t_b >= t_f else "operations"
