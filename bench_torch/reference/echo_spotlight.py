"""Plain reference of the spotlight raw echo of one CPI.

The upstream sar_batch_sim.py's spotlight engine as the repo's float64
NumPy oracle describes it (oracle/pipeline.py::echo_spotlight): targets
moving rigidly at ``target_vel`` from their positions at slow time 0; the
receive position advanced by v_sat tau_approx (stop and go), the delay
(d_tx + d_rx) / c; the two-way sinc^2 azimuth pattern of an antenna of
``ant_length`` aimed at the beam centre; the chirp centred on tau,
|t - tau| <= Tp / 2, with phase pi Kr (t - tau)^2 - 2 pi fc tau; the
amplitude rcs (the upstream multiplies by rcs, not its root); summed over
the targets. Float64 throughout."""

from __future__ import annotations

import math

import torch

C = 299792458.0


def cpi(sat_pos, sat_vel, t_slow, tgt_pos, rcs, target_vel, t_fast,
        fc: float, kr: float, tp: float, wavelength: float,
        ant_length: float, beam_center=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """(P, Ns) complex128 raw: sat_pos / sat_vel (P, 3), t_slow (P,),
    tgt_pos (B, 3), rcs (B,), target_vel (3,), t_fast (Ns,) float64."""
    dev = t_fast.device
    f64 = torch.float64
    bc = torch.as_tensor(beam_center, dtype=f64, device=dev)
    out = torch.zeros((sat_pos.shape[0], t_fast.shape[0]),
                      dtype=torch.complex128, device=dev)
    rcs = rcs.to(f64)
    for i in range(sat_pos.shape[0]):
        p, v = sat_pos[i], sat_vel[i]
        pos = tgt_pos + target_vel[None, :] * t_slow[i]
        diff = pos - p
        d_tx = torch.linalg.vector_norm(diff, dim=1)
        tau_a = 2.0 * d_tx / C
        p_rx = p[None, :] + v[None, :] * tau_a[:, None]
        d_rx = torch.linalg.vector_norm(pos - p_rx, dim=1)
        tau = (d_tx + d_rx) / C
        look = (bc - p) / torch.linalg.vector_norm(bc - p)
        cos_off = torch.clamp((diff / d_tx[:, None]) @ look, -1.0, 1.0)
        x = math.pi * ant_length * torch.sin(torch.arccos(cos_off)) \
            / wavelength
        gain = torch.where(x.abs() > 1e-6,
                           (torch.sin(x) / torch.where(x.abs() > 1e-6, x,
                                                       torch.ones_like(x)))
                           ** 2, torch.ones_like(x))
        t_loc = t_fast[None, :] - tau[:, None]
        ph = math.pi * kr * t_loc ** 2 - 2.0 * math.pi * fc * tau[:, None]
        z = torch.polar((rcs * gain)[:, None].expand_as(ph), ph)
        out[i] = torch.where(t_loc.abs() <= tp / 2.0, z,
                             torch.zeros_like(z)).sum(0)
    return out
