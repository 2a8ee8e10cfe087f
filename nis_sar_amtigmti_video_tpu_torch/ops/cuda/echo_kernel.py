"""The direct point-target echo accumulation.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/pallas/echo_kernel.py``
(``echo_accumulate``): the sum over targets of the gated chirp echo, from
the per-(pulse, target) float32 scalars of ``ops/echo.py``'s float64
geometry pass (``backend='pallas'``). :func:`echo_accumulate` runs its plain
version for CPU tensors, and launches the hand-written CUDA kernel of
``csrc/echo_kernel.cu`` or raises for CUDA tensors. The TPU tiling knobs
``pulse_tile``, ``ns_tile`` and ``target_tile`` are not ported, and
``interpret=True`` raises: the port has no kernel interpreter.
"""

from __future__ import annotations

import torch

from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build

C64 = torch.complex64
_WORK = 1 << 25            # (pulses x targets x samples) per plain step


def echo_accumulate_plain(tau_rel, carrier, amp, t_fast, *, k_pi: float,
                          shift: float, half: float) -> torch.Tensor:
    """Plain version of :func:`echo_accumulate`: the (pulses, targets,
    samples) gated chirps in float32, summed over targets in blocks that
    bound the work tensor."""
    num_p, num_b = tau_rel.shape
    ns = t_fast.shape[0]
    out = torch.zeros((num_p, ns), dtype=C64, device=tau_rel.device)
    tb = max(1, min(num_b, 512))
    pc = max(1, _WORK // (tb * max(1, ns)))
    kf, sf, hf = (torch.tensor(v, dtype=torch.float32, device=tau_rel.device)
                  for v in (k_pi, shift, half))
    for p0 in range(0, num_p, pc):
        acc = out[p0:p0 + pc]
        for b0 in range(0, num_b, tb):
            tau = tau_rel[p0:p0 + pc, b0:b0 + tb, None]
            arg = (t_fast[None, None, :] - tau) - sf
            phase = carrier[p0:p0 + pc, b0:b0 + tb, None] + kf * (arg * arg)
            gate = torch.where(torch.abs(arg) <= hf,
                               amp[p0:p0 + pc, b0:b0 + tb, None],
                               torch.zeros((), device=tau.device))
            acc += torch.sum(torch.complex(gate * torch.cos(phase),
                                           gate * torch.sin(phase)), dim=1)
    return out


def echo_accumulate(tau_rel, carrier, amp, t_fast, *, k_pi: float,
                    shift: float, half: float,
                    interpret: bool = False) -> torch.Tensor:
    """(P, Ns) complex64: for every pulse and sample of the window-relative
    fast-time grid ``t_fast`` (Ns,) float32, the sum over targets of amp *
    gate(|t - tau - shift| <= half) * exp(j (carrier + k_pi (t - tau -
    shift)^2)). tau_rel, carrier, amp: (P, B) float32."""
    if interpret:
        raise NotImplementedError(
            "echo_accumulate(interpret=True) is not ported (the port has no "
            "kernel interpreter): pass CPU tensors to run the plain version")
    num_p, num_b = tau_rel.shape
    ns = t_fast.shape[0]
    if _build.on_cpu(tau_rel):
        return echo_accumulate_plain(tau_rel, carrier, amp, t_fast,
                                     k_pi=k_pi, shift=shift, half=half)
    dev = tau_rel.device
    _build.check("echo_accumulate", (tau_rel, carrier, amp), (num_p, num_b),
                 dev)
    _build.check("echo_accumulate", (t_fast,), (ns,), dev)
    out = torch.empty((num_p, ns), dtype=C64, device=dev)
    if num_p == 0 or ns == 0:
        return out
    _build.launch("echo_accumulate_launch",
                  (tau_rel, carrier, amp, t_fast, out), (num_p, num_b, ns),
                  (k_pi, shift, half))
    echo_accumulate.launches += 1
    return out


echo_accumulate.launches = 0
