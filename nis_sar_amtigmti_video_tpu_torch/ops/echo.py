"""Point-target raw-echo engine (forward model), direct summation.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/echo.py``, with its direct
(``backend='jnp'``) engine: monostatic / bistatic two-phase-center echoes,
moving targets, sinc^2 antenna pattern and stop-and-go Rx, as options on one
generator. The other backends are not ported yet.

* Geometry (positions -> delays -> carrier phase) runs in float64: at ~507 km
  slant range the two-way phase needs sub-mm range accuracy. The carrier
  phase is wrapped mod 2*pi in float64 and *then* cast to float32, so the
  large (pulses x targets x samples) work is pure float32 / complex64.
* Pulses and targets are processed in fixed-size chunks that bound the
  (pulse_chunk x target_chunk x samples) work tensor; the chunk plan only
  changes the association of the target sum, not the result's class.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

_TWO_PI = 2.0 * math.pi
_C = 299792458.0


@dataclass(frozen=True)
class EchoOpts:
    """Static configuration of the direct echo engine (hashable): the
    reference ``EchoOpts`` fields it reads, with the same defaults."""

    fc_hz: float
    chirp_rate: float            # K_r [Hz/s]
    pulse_width_s: float
    fs_hz: float
    num_samples: int
    # True reproduces the reference's linspace(0, N/fs, N) endpoint quirk
    # (sar_satellite_sim.py:254); False is a uniform arange(N)/fs grid
    endpoint_grid: bool = True
    # 'leading': echo on [tau, tau+Tp]; 'centered': on [tau-Tp/2, tau+Tp/2]
    chirp_centering: str = "leading"
    amplitude: str = "sqrt_rcs"  # 'sqrt_rcs' | 'rcs'
    stop_and_go: bool = False    # advance Rx by v_sat * tau
    antenna_length_m: float = 0.0  # >0: sinc^2 azimuth pattern
    # elements of the f32 work tensor per step ~ pulse_chunk*target_chunk*Ns
    max_elements: int = 1 << 25
    target_chunk: int = 512
    # 'jnp' is the direct engine; 'pallas', 'pallas_interpret' and 'freq'
    # name reference backends that are not ported yet
    backend: str = "jnp"

    @property
    def half_width(self) -> float:
        return self.pulse_width_s / 2.0

    @property
    def chirp_shift(self) -> float:
        return self.half_width if self.chirp_centering == "leading" else 0.0


def fast_time_grid(opts: EchoOpts) -> np.ndarray:
    """Fast-time sample offsets from window start, float64 (host numpy)."""
    n, fs = opts.num_samples, opts.fs_hz
    if opts.endpoint_grid:
        return np.linspace(0.0, n / fs, n)
    return np.arange(n) / fs


def window_start_time(r0: float, opts: EchoOpts, window_length_s: float,
                      mode: str = "reference") -> float:
    """Receive-window opening time.

    'reference': 2R0/c - Tp/2 - 1us (sar_satellite_sim.py:252)
    'centered' : 2R0/c - win/2     (sar_batch_sim.py:89)
    """
    if mode == "reference":
        return 2.0 * r0 / _C - opts.pulse_width_s / 2.0 - 1e-6
    if mode == "centered":
        return 2.0 * r0 / _C - window_length_s / 2.0
    raise ValueError(
        f"window mode must be 'reference' or 'centered', got {mode!r}")


def _wrap_pi(x: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi] in the input dtype."""
    return x - _TWO_PI * torch.round(x / _TWO_PI)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _check_backend(opts: EchoOpts) -> None:
    if opts.backend in ("pallas", "pallas_interpret", "freq"):
        raise NotImplementedError(
            f"echo backend {opts.backend!r} is not ported yet")
    if opts.backend != "jnp":
        raise ValueError(f"unknown echo backend {opts.backend!r}")


def _phase_history(t_slow, sat_pos, sat_vel, tgt_pos, tgt_rcs, tgt_vel,
                   rx_offset: float, t_start: float,
                   opts: EchoOpts) -> torch.Tensor:
    """Direct engine. Tensor args float64 on one device; returns (P, Ns)
    complex64 there."""
    _check_backend(opts)
    dev = t_slow.device
    num_p, num_b, ns = t_slow.shape[0], tgt_pos.shape[0], opts.num_samples
    out = torch.zeros((num_p, ns), dtype=torch.complex64, device=dev)
    if num_b == 0:                       # empty scene: pure zeros
        return out

    # --- static chunk plan (the reference's) ---
    tb = min(opts.target_chunk, num_b)
    pc = max(1, min(num_p, opts.max_elements // max(1, tb * ns)))

    amp_b = torch.sqrt(tgt_rcs) if opts.amplitude == "sqrt_rcs" else tgt_rcs
    f32 = torch.float32
    t_fast = torch.as_tensor(fast_time_grid(opts), device=dev).to(f32)
    k_pi = torch.tensor(math.pi * opts.chirp_rate, dtype=f32, device=dev)
    shift = torch.tensor(opts.chirp_shift, dtype=f32, device=dev)
    half = torch.tensor(opts.half_width, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    for p0 in range(0, num_p, pc):
        ts, ps, vs = t_slow[p0:p0 + pc], sat_pos[p0:p0 + pc], \
            sat_vel[p0:p0 + pc]
        v_norm = _norm(vs)[:, None]
        v_dir = vs / torch.where(v_norm == 0.0, torch.ones_like(v_norm),
                                 v_norm)
        acc = torch.zeros((ts.shape[0], ns), dtype=torch.complex64,
                          device=dev)
        for j0 in range(0, num_b, tb):
            pos0, amp0 = tgt_pos[j0:j0 + tb], amp_b[j0:j0 + tb]

            # ---------- float64 geometry ----------
            p_t = pos0[None, :, :] + tgt_vel[None, None, :] \
                * ts[:, None, None]
            diff_tx = p_t - ps[:, None, :]                  # (pc, tb, 3)
            d_tx = _norm(diff_tx)                           # (pc, tb)
            p_rx = ps[:, None, :] + v_dir[:, None, :] * rx_offset
            if opts.stop_and_go:
                tau_a = 2.0 * d_tx / _C
                p_rx = p_rx + vs[:, None, :] * tau_a[:, :, None]
            d_rx = _norm(p_t - p_rx)
            tau = (d_tx + d_rx) / _C
            amp = amp0[None, :]
            if opts.antenna_length_m > 0.0:
                look = -ps / _norm(ps)[:, None]
                cos_off = torch.clamp(
                    torch.sum(look[:, None, :] * (diff_tx / d_tx[..., None]),
                              dim=-1), -1.0, 1.0)
                lam = _C / opts.fc_hz
                x = (math.pi * opts.antenna_length_m / lam) \
                    * torch.sin(torch.arccos(cos_off))
                safe = torch.where(x == 0, torch.ones_like(x), x)
                sinc = torch.where(torch.abs(x) > 1e-6, torch.sin(x) / safe,
                                   torch.ones_like(x))
                amp = amp * sinc ** 2
            amp = torch.broadcast_to(amp, tau.shape).to(f32)
            carrier = _wrap_pi(-_TWO_PI * opts.fc_hz * tau).to(f32)
            tau_rel = (tau - t_start).to(f32)               # < ~50 us

            # ---------- float32 echo accumulation ----------
            arg = (t_fast[None, None, :] - tau_rel[:, :, None]) - shift
            mask = torch.abs(arg) <= half
            phase = carrier[:, :, None] + k_pi * (arg * arg)
            gate = torch.where(mask, amp[:, :, None], zero)
            sig = torch.complex(gate * torch.cos(phase),
                                gate * torch.sin(phase))
            acc += torch.sum(sig, dim=1)
        out[p0:p0 + pc] = acc
    return out


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def phase_history(trajectory, targets, opts: EchoOpts, *, t_start: float,
                  target_velocity=(0.0, 0.0, 0.0), rx_offset: float = 0.0,
                  device=None) -> torch.Tensor:
    """One channel's raw phase history: (num_pulses, num_samples) complex64
    on ``device``.

    trajectory: geometry.orbit.Trajectory (float64 times/positions/
    velocities); targets: scene.targets.PointTargets; t_start: receive-window
    opening time [s]; target_velocity: rigid velocity of the cluster [m/s];
    rx_offset: along-track Rx phase-center offset from the Tx [m].
    """
    return _phase_history(
        _f64(trajectory.times, device), _f64(trajectory.positions, device),
        _f64(trajectory.velocities, device),
        _f64(targets.positions, device).reshape(-1, 3),
        _f64(targets.rcs, device), _f64(target_velocity, device),
        float(rx_offset), float(t_start), opts)


def multi_channel_phase_history(trajectory, targets, opts: EchoOpts, *,
                                t_start: float, rx_offsets,
                                target_velocity=(0.0, 0.0, 0.0),
                                device=None) -> torch.Tensor:
    """All receive channels: a (num_channels, P, Ns) complex64 tensor on
    ``device``."""
    return torch.stack([
        phase_history(trajectory, targets, opts, t_start=t_start,
                      target_velocity=target_velocity, rx_offset=off,
                      device=device)
        for off in np.asarray(rx_offsets, np.float64)])
