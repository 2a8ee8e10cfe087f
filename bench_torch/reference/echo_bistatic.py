"""Plain reference of the two-phase-centre raw echo of one pulse.

The upstream sar_ati_dcpa_sim_csa.py's run_bistatic_physics_gpu as the
repo's float64 NumPy oracle describes it (oracle/pipeline.py::
echo_bistatic): the receive phase centre displaced ``rx_offset`` along the
velocity's unit vector, the delay (d_tx + d_rx) / c, the carrier
-2 pi fc tau, the chirp gated on [tau, tau + Tp] with phase
pi Kr (t - tau - Tp/2)^2, amplitude sqrt(rcs), summed over the targets.

mode 'f64': everything in float64. mode 'bf16': the delays and the carrier
phase in float64 (as the port keeps its per-target fields), the chirp's
phase argument, each target's contribution and the sum in bfloat16."""

from __future__ import annotations

import math

import torch

from bench_torch.reference import _precision as P

C = 299792458.0


def pulses(idx, sat_pos, sat_vel, tgt_pos, rcs, t_fast, rx_offset: float,
           fc: float, kr: float, tp: float, mode: str = "f64",
           chunk: int = 512) -> torch.Tensor:
    """(len(idx), Ns) complex raw of the pulses ``idx``: sat_pos / sat_vel
    (P, 3), tgt_pos (B, 3), rcs (B,), t_fast (Ns,) float64 tensors."""
    P.check(mode)
    dev = t_fast.device
    out = torch.zeros((len(idx), t_fast.shape[0]), dtype=P.ctype(mode),
                      device=dev)
    amp = torch.sqrt(rcs.to(torch.float64))
    for row, i in enumerate(idx):
        p_tx, v = sat_pos[i], sat_vel[i]
        p_rx = p_tx + v / torch.linalg.vector_norm(v) * rx_offset
        for b0 in range(0, tgt_pos.shape[0], chunk):
            t = tgt_pos[b0:b0 + chunk]
            tau = (torch.linalg.vector_norm(t - p_tx, dim=1)
                   + torch.linalg.vector_norm(t - p_rx, dim=1)) / C
            arg = t_fast[None, :] - tau[:, None] - tp / 2.0     # f64
            gate = arg.abs() <= tp / 2.0
            car = -2.0 * math.pi * fc * tau
            if mode == "f64":
                ph = car[:, None] + math.pi * kr * arg ** 2
                z = torch.polar(amp[b0:b0 + chunk, None].expand_as(ph), ph)
            else:
                chirp = P.q((math.pi * kr * arg ** 2).float(), mode)
                z = P.q(torch.polar(
                    amp[b0:b0 + chunk, None].float().expand_as(chirp),
                    chirp) * P.expj(car, mode)[:, None], mode)
            z = torch.where(gate, z, torch.zeros_like(z))
            out[row] = P.q(out[row] + z.sum(0), mode)
    return out
