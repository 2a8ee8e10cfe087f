"""The fast-BP factorized (sub-aperture) accumulate on coarse tiles.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/pallas/bp_factor_kernel.py``
(``supported``, ``accumulate_factor_pallas`` with ``feed='windows'``): a
drop-in for ``ops/bp_fast.py::_accumulate_factor``. The inner sums of each
sub-aperture on the plan's ``nx_c`` coarse columns run in the hand-written
CUDA kernel of ``csrc/bp_kernel.cu`` (the pixel-tile accumulate's device
code, one block per (sub-aperture, row tile), summing only that
sub-aperture's live pulses); the merge to the fine grid (Kaiser-sinc
upsample matmul and anchor carrier) stays plain PyTorch, one sub-aperture
after another in a fixed order. :func:`accumulate_factor_pallas` runs its
plain version (``bp_fast._accumulate_factor``) for CPU tensors, and
launches the kernel or raises for CUDA tensors. The TPU knobs ``tile_y``,
``mode``, ``interpret`` and ``feed='spectra'`` are not ported.
"""

from __future__ import annotations

import math

import torch

from nis_sar_amtigmti_video_tpu_torch.ops import bp_fast
from nis_sar_amtigmti_video_tpu_torch.ops.bp_fast import FastBpPlan
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build
from nis_sar_amtigmti_video_tpu_torch.ops.cuda.bp_kernel import (
    launch_accumulate)

_LANE = 128
_TWO_PI = 2.0 * math.pi


def supported(plan: FastBpPlan) -> bool:
    """The reference's rule: 32-sample windows, a full-lane coarse grid, a
    sub-aperture, and a 128-multiple internal grid."""
    return (plan.w_win == 32 and plan.nx_c == _LANE
            and plan.sub_raw > 0 and plan.ny_i % _LANE == 0
            and plan.nx_i % _LANE == 0)


def residual_phases(pa, pb, pc, sub_p: int):
    """Per pulse and row, the phase coefficients less those of its
    sub-aperture's anchor pulse: (ad wrapped mod 2 pi in float32, bd, cd),
    contiguous (P, ny) float32."""
    num_p = pa.shape[0]
    ci = bp_fast.subaperture_anchors(num_p, sub_p, pa.device)
    rep = torch.arange(num_p, device=pa.device) // sub_p
    ad = pa - pa[ci][rep]
    ad = ad - _TWO_PI * torch.round(ad / _TWO_PI)
    return (ad.contiguous(), (pb - pb[ci][rep]).contiguous(),
            (pc - pc[ci][rep]).contiguous())


def accumulate_factor_pallas_plain(rc2, u0, pa, pb, pc, b_t, c_t,
                                   plan: FastBpPlan, sub_p: int):
    """Plain version of :func:`accumulate_factor_pallas`."""
    return bp_fast._accumulate_factor(rc2, u0, pa, pb, pc, b_t, c_t, plan,
                                      sub_p)


def inner_sums(rc2, u0, pa, pb, pc, b_t, c_t, plan: FastBpPlan,
               sub_p: int) -> torch.Tensor:
    """The kernel alone: (n_sub, ny_i, nx_c) complex64 inner sums of each
    sub-aperture of ``sub_p`` pulses against its anchor pulse (CUDA
    tensors). Each launch adds one to ``accumulate_factor_pallas.launches``.
    """
    num_p = rc2.shape[0]
    xic = bp_fast._coarse_cols(plan.nx_c, plan.nx_i, rc2.device)
    ad, bd, cd = residual_phases(pa, pb, pc, sub_p)
    out = launch_accumulate("accumulate_factor_pallas", rc2, u0, ad, bd, cd,
                            b_t, c_t, xic, plan, sub_p, -(-num_p // sub_p))
    accumulate_factor_pallas.launches += 1
    return out


def accumulate_factor_pallas(rc2, u0, pa, pb, pc, b_t, c_t,
                             plan: FastBpPlan, sub_p: int) -> torch.Tensor:
    """``_accumulate_factor``'s operands and result: the (ny_i, nx_i)
    complex64 internal-grid image from sub-aperture inner sums on the
    plan's coarse columns, merged to the fine grid. Operands as for
    ``bp_kernel.accumulate_pallas``. Requires ``supported(plan)``."""
    if not supported(plan):
        raise ValueError(
            "accumulate_factor_pallas needs w_win=32, nx_c=128, a sub-"
            "aperture and a 128-multiple internal grid, got "
            f"{(plan.w_win, plan.nx_c, plan.sub_raw, plan.ny_i, plan.nx_i)}")
    if _build.on_cpu(rc2):
        return accumulate_factor_pallas_plain(rc2, u0, pa, pb, pc, b_t, c_t,
                                              plan, sub_p)
    j_s = inner_sums(rc2, u0, pa, pb, pc, b_t, c_t, plan, sub_p)
    dev = rc2.device
    ci = bp_fast.subaperture_anchors(rc2.shape[0], sub_p, dev)
    u_mat = bp_fast.upsample_matrix(plan, dev)
    xi = bp_fast._fm_xi(plan, dev)[1]
    img = torch.zeros((plan.ny_i, plan.nx_i), dtype=torch.complex64,
                      device=dev)
    for s in range(j_s.shape[0]):
        img = bp_fast.merge_subaperture(img, j_s[s], u_mat, pa[ci[s]],
                                        pb[ci[s]], pc[ci[s]], xi)
    return img


accumulate_factor_pallas.launches = 0
