"""The fast-BP pixel-tile accumulate.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/pallas/bp_kernel.py``
(``supported``, ``accumulate_pallas``): a drop-in for
``ops/bp_fast.py::_accumulate`` on a ``w_win=64`` plan, running the
hand-written CUDA kernel of ``csrc/bp_kernel.cu``, which fuses the whole
per-pulse chain (window DFT, ramp, column kernel, taper, focusing phase)
over a pixel tile held in registers: producer warps prepare each pulse's
window spectra and phasor tables while the consumer warpgroups contract
the previous one on the tensor cores (wgmma, three TF32 passes) and run
its epilogue. :func:`accumulate_pallas` runs its
plain version (``bp_fast._accumulate``) for CPU tensors, and launches the
kernel or raises for CUDA tensors. The TPU knobs ``block``, ``tile_y``,
``mode``, ``interpret`` and ``ablate`` are not ported.

:func:`launch_accumulate` is the launch shared with
``ops/cuda/bp_factor_kernel.py``, whose coarse-tile inner sums run the same
device code.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.ops import bp_fast
from nis_sar_amtigmti_video_tpu_torch.ops.bp_fast import FastBpPlan
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build

_LANE = 128
TILE_Y, TILE_X = 32, 128      # the kernel's pixel tile
C64 = torch.complex64


def supported(plan: FastBpPlan) -> bool:
    """The reference's rule: 64-sample windows and a 128-multiple grid."""
    return (plan.w_win == 64 and plan.nx_i % _LANE == 0
            and plan.ny_i % _LANE == 0)


@functools.lru_cache(maxsize=None)
def _tables(w: int, taper_pow: int, device: torch.device):
    """Float64-built (exp(-2 pi i k / w), k < w) complex64 and the tapered
    window weights sin(pi (s + 0.5) / w) ** taper_pow / w float32."""
    k = np.arange(w)
    tw = np.exp(-2j * np.pi * k / w).astype(np.complex64)
    tapw = (np.sin(np.pi * (k + 0.5) / w) ** taper_pow / w).astype(
        np.float32)
    return torch.from_numpy(tw).to(device), torch.from_numpy(tapw).to(device)


def launch_accumulate(name: str, rc2, u0, c0, c1, c2, b_t, c_t,
                      xi: torch.Tensor, plan: FastBpPlan, sub_p: int,
                      n_sub: int) -> torch.Tensor:
    """One launch of ``csrc/bp_kernel.cu``: (n_sub, ny_i, len(xi))
    complex64 sums over blocks of ``sub_p`` pulses, with (c0, c1, c2) the
    per-(pulse, row) phase (constant, linear, quadratic in ``xi``)."""
    num_p, n = rc2.shape
    ny, ncols, w = plan.ny_i, xi.shape[0], plan.w_win
    dev = rc2.device
    _build.check(name, (rc2,), (num_p, n), dev, C64)
    _build.check(name, (u0, c0, c1, c2), (num_p, ny), dev)
    _build.check(name, (b_t, c_t), (num_p,), dev)
    _build.check(name, (xi,), (ncols,), dev)
    if w not in (32, 64) or ny % TILE_Y or ncols % TILE_X:
        raise ValueError(f"{name}: the kernel takes w_win 32 or 64, rows in "
                         f"multiples of {TILE_Y} and columns in multiples of "
                         f"{TILE_X}, got {(w, ny, ncols)}")
    if not 0 <= plan.taper_pow <= 15:
        raise ValueError(f"{name}: the kernel takes taper_pow 0 to 15, got "
                         f"{plan.taper_pow}")
    band_end = plan.band_start + plan.stride * (ny - 1) + w
    if plan.band_start < 0 or band_end > n:
        raise ValueError(f"{name}: band [{plan.band_start}, {band_end}) "
                         f"outside the {n} recentred samples")
    if sub_p < 1 or not (n_sub - 1) * sub_p < num_p <= n_sub * sub_p:
        raise ValueError(f"{name}: {n_sub} blocks of {sub_p} pulses do not "
                         f"cover {num_p}")
    out = torch.empty((n_sub, ny, ncols), dtype=C64, device=dev)
    _build.launch("bp_accumulate_launch",
                  (rc2, u0, c0, c1, c2, b_t, c_t, xi,
                   *_tables(w, plan.taper_pow, dev), out),
                  (num_p, n, ny, ncols, plan.band_start, plan.stride, sub_p,
                   n_sub, plan.taper_pow, w))
    return out


def accumulate_pallas_plain(rc2, u0, pa, pb, pc, b_t, c_t,
                            plan: FastBpPlan) -> torch.Tensor:
    """Plain version of :func:`accumulate_pallas`."""
    return bp_fast._accumulate(rc2, u0, pa, pb, pc, b_t, c_t, plan)


def accumulate_pallas(rc2, u0, pa, pb, pc, b_t, c_t,
                      plan: FastBpPlan) -> torch.Tensor:
    """sum over pulses of the window-interpolated value times the focusing
    phase on the (ny_i, nx_i) internal grid, complex64: ``_accumulate``'s
    operands and result. rc2 (P, n) complex64 recentred pulses (band-
    relative to ``plan.band_start``); u0, pa, pb, pc (P, ny_i) and b_t, c_t
    (P,) float32, contiguous. Requires ``supported(plan)``."""
    if not supported(plan):
        raise ValueError("accumulate_pallas needs w_win=64 and a 128-multiple "
                         f"internal grid, got "
                         f"{(plan.w_win, plan.ny_i, plan.nx_i)}")
    if _build.on_cpu(rc2):
        return accumulate_pallas_plain(rc2, u0, pa, pb, pc, b_t, c_t, plan)
    xi = bp_fast._fm_xi(plan, rc2.device)[1]
    out = launch_accumulate("accumulate_pallas", rc2, u0, pa, pb, pc, b_t,
                            c_t, xi, plan, rc2.shape[0], 1)
    accumulate_pallas.launches += 1
    return out[0]


accumulate_pallas.launches = 0
