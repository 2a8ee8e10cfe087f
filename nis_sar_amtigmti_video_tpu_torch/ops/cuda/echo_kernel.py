"""The direct point-target echo accumulation.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/pallas/echo_kernel.py``
(``echo_accumulate``): the sum over targets of the gated chirp echo, in two
forms that share one CUDA kernel template (``csrc/echo_kernel.cu``):

* :func:`echo_accumulate` (``backend='pallas'``) from the per-(pulse,
  target) float32 scalars of ``ops/echo.py``'s float64 geometry pass;
* :func:`echo_direct` (the ``'jnp'`` direct engine on the card), which forms
  those scalars itself from the float64 pulses and targets, one launch a
  channel, with no (pulse, target) field in device memory.

:func:`echo_accumulate` runs its plain version for CPU tensors;
:func:`echo_direct` takes only CUDA tensors (on the CPU the direct engine
is ``ops/echo.py::_direct``). On the card each launches the kernel or
raises. The TPU tiling knobs ``pulse_tile``, ``ns_tile`` and
``target_tile`` are not ported, and ``interpret=True`` raises: the port has
no kernel interpreter.
"""

from __future__ import annotations

import math

import torch

from nis_sar_amtigmti_video_tpu_torch.ops import echo
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import count

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


def echo_direct(t_slow, sat_pos, sat_vel, tgt_pos, tgt_rcs, tgt_vel, opts,
                *, rx_offsets, t_start: float) -> torch.Tensor:
    """The direct engine (``ops/echo.py``, ``backend='jnp'``) of every
    channel of ``rx_offsets``: (C * P, Ns) complex64, channel-major.

    Float64 pulses t_slow (P,), sat_pos, sat_vel (P, 3), targets tgt_pos
    (B, 3), tgt_rcs (B,) and their velocity tgt_vel (3,), all on one device;
    ``opts`` an ``echo.EchoOpts``. On the card, one launch a channel forms
    each (pulse, target)'s delay, carrier and amplitude in float64 as
    ``ops/echo.py::_geometry`` does and sums the gated chirps; nothing is
    copied from the host once the fast-time grid is on the device (its
    first use). CPU tensors raise: ``echo._phase_history`` runs the plain
    engine (``echo._direct``) there."""
    if _build.on_cpu(t_slow):
        raise ValueError("echo_direct launches the CUDA kernel: on the CPU "
                         "the direct engine is ops/echo.py::_direct")
    dev = t_slow.device
    num_p, num_b, ns = t_slow.shape[0], tgt_pos.shape[0], opts.num_samples
    f64 = torch.float64
    _build.check("echo_direct", (t_slow,), (num_p,), dev, f64)
    _build.check("echo_direct", (sat_pos, sat_vel), (num_p, 3), dev, f64)
    _build.check("echo_direct", (tgt_pos,), (num_b, 3), dev, f64)
    _build.check("echo_direct", (tgt_rcs,), (num_b,), dev, f64)
    _build.check("echo_direct", (tgt_vel,), (3,), dev, f64)
    offs = [float(o) for o in rx_offsets]
    out = torch.empty((len(offs) * num_p, ns), dtype=C64, device=dev)
    if num_p == 0 or ns == 0:
        return out
    t_fast = echo.fast_time_on(opts, dev)
    ant_k = (math.pi * opts.antenna_length_m / (echo._C / opts.fc_hz)
             if opts.antenna_length_m > 0.0 else 0.0)
    ints = (num_p, num_b, ns, int(opts.stop_and_go),
            int(opts.amplitude == "sqrt_rcs"))
    floats = (math.pi * opts.chirp_rate, opts.chirp_shift, opts.half_width)
    for c, off in enumerate(offs):
        _build.launch("echo_direct_launch",
                      (t_slow, sat_pos, sat_vel, tgt_pos, tgt_rcs, tgt_vel,
                       t_fast, out[c * num_p:(c + 1) * num_p]), ints, floats,
                      (off, float(t_start), -echo._TWO_PI * opts.fc_hz,
                       ant_k))
        echo_direct.launches += 1
        count("echo.direct")
    return out


echo_direct.launches = 0
