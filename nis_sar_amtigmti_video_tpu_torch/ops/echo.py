"""Point-target raw-echo engine (forward model).

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/echo.py``: monostatic /
bistatic two-phase-center echoes, moving targets, sinc^2 antenna pattern and
stop-and-go Rx, as options on one generator, with the reference's backends:

* ``'jnp'``: the direct engine. On the CPU plain PyTorch: pulses and
  targets go in fixed-size chunks that bound the (pulse_chunk x
  target_chunk x samples) work tensor; the chunk plan only changes the
  association of the target sum, not the result's class. On the card one
  hand-written launch a channel (``ops/cuda/echo_kernel.py::echo_direct``)
  forms the same float64 geometry and sums the gated chirps, each sample's
  targets in order.
* ``'freq'``: the NUFFT engine (``ops/echo_freq.py::synthesize``), fed by a
  two-pass scalar-field branch: float64 geometry for every (pulse, target),
  anchored every ``freq_geom_stride`` pulses with quadratic interpolation
  between, then one synthesis over every channel's pulses (a (C,)
  ``rx_offset`` stacks the channels on the pulse axis).
* ``'pallas'``: the same scalar fields into the hand-written direct-echo
  kernel (``ops/cuda/echo_kernel.py::echo_accumulate``; its plain version
  for CPU tensors). ``'pallas_interpret'`` raises: the port has no kernel
  interpreter.

Geometry (positions -> delays -> carrier phase) runs in float64: at ~507 km
slant range the two-way phase needs sub-mm range accuracy. The carrier phase
is wrapped mod 2*pi in float64 and *then* cast to float32, so the large
(pulses x targets x samples) work is pure float32 / complex64.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.utils.anchors import anchor_plan
from nis_sar_amtigmti_video_tpu_torch.utils.device import entry_device
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import span

_TWO_PI = 2.0 * math.pi
_C = 299792458.0


@dataclass(frozen=True)
class EchoOpts:
    """Static configuration of the echo engine (hashable): the reference
    ``EchoOpts`` fields, with the same defaults."""

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
    # 'jnp' (direct engine) | 'pallas' (the direct-echo kernel on the
    # scalar fields) | 'freq' (NUFFT convolution + exact gate edges,
    # ops/echo_freq.py; needs endpoint_grid=False)
    backend: str = "jnp"
    freq_oversample: int = 2    # spreading-grid oversampling for 'freq'
    # raised-cosine flank width (native samples) carried by the NUFFT path;
    # the flanks themselves are synthesised exactly. 0 = the approximate
    # mode (no exact-edge pass, ~-25 dB field floor)
    freq_edge_taper: float = 4.0
    # 'auto' | 'scatter' | 'dense' | 'dense_kernel' | 'dense_kernel_qr':
    # how the NUFFT impulses reach the grid (ops/echo_freq.py)
    freq_spreader: str = "auto"
    # dense-spreader group sizing overrides (None = module defaults)
    freq_spread_win: Optional[int] = None
    freq_spread_grp: Optional[int] = None
    # exact-edge-pass window override (None = half the main window)
    freq_spread_win_edge: Optional[int] = None
    # slow-time stride of the exact float64 geometry for 'freq' (quadratic
    # anchor interpolation between; 0/1 = exact at every pulse)
    freq_geom_stride: int = 8
    # 'f64': interpolate the delay field in float64 and wrap the carrier per
    # (pulse, target); 'split' (quarantined in the reference): float64 only
    # at the anchors, inter-anchor deltas in float32 (~1e-5 rad class)
    freq_geom_interp: str = "f64"
    # 'auto' | 'xla' | 'pallas': the freq backend's FFT convolution
    freq_conv: str = "auto"

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
    if opts.backend == "pallas_interpret":
        raise NotImplementedError(
            "echo backend 'pallas_interpret' is not ported (the port has no "
            "kernel interpreter): use backend='pallas' with device='cpu' to "
            "run the kernel's plain version")
    if opts.backend not in ("jnp", "pallas", "freq"):
        raise ValueError(f"unknown echo backend {opts.backend!r}")
    if opts.backend == "freq" and opts.endpoint_grid:
        raise ValueError("backend='freq' needs a uniform fast-time grid "
                         "(endpoint_grid=False)")
    if opts.backend != "jnp" and opts.freq_geom_interp not in ("f64",
                                                               "split"):
        raise ValueError(
            f"unknown freq_geom_interp {opts.freq_geom_interp!r}")


def _geometry(ts, ps, vs, pos0, amp0, tgt_vel, rx_offset: float,
              opts: EchoOpts):
    """Float64 geometry of pulses (ts (pc,), ps / vs (pc, 3)) against
    targets (pos0 (tb, 3), amplitudes amp0 (tb,)): (tau (pc, tb) float64,
    amp (pc, tb) float32). ``rx_offset`` is the along-track Rx offset."""
    v_norm = _norm(vs)[:, None]
    v_dir = vs / torch.where(v_norm == 0.0, torch.ones_like(v_norm), v_norm)
    p_t = pos0[None, :, :] + tgt_vel[None, None, :] * ts[:, None, None]
    diff_tx = p_t - ps[:, None, :]                          # (pc, tb, 3)
    d_tx = _norm(diff_tx)                                   # (pc, tb)
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
    return tau, torch.broadcast_to(amp, tau.shape).to(torch.float32)


def _direct(t_slow, sat_pos, sat_vel, tgt_pos, amp_b, tgt_vel,
            rx_offset: float, t_start: float,
            opts: EchoOpts) -> torch.Tensor:
    """The direct engine for one channel: (P, Ns) complex64."""
    dev = t_slow.device
    num_p, num_b, ns = t_slow.shape[0], tgt_pos.shape[0], opts.num_samples
    out = torch.zeros((num_p, ns), dtype=torch.complex64, device=dev)

    # --- static chunk plan (the reference's) ---
    tb = min(opts.target_chunk, num_b)
    pc = max(1, min(num_p, opts.max_elements // max(1, tb * ns)))

    f32 = torch.float32
    t_fast = torch.as_tensor(fast_time_grid(opts), device=dev).to(f32)
    k_pi = torch.tensor(math.pi * opts.chirp_rate, dtype=f32, device=dev)
    shift = torch.tensor(opts.chirp_shift, dtype=f32, device=dev)
    half = torch.tensor(opts.half_width, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    for p0 in range(0, num_p, pc):
        ts, ps, vs = t_slow[p0:p0 + pc], sat_pos[p0:p0 + pc], \
            sat_vel[p0:p0 + pc]
        acc = torch.zeros((ts.shape[0], ns), dtype=torch.complex64,
                          device=dev)
        for j0 in range(0, num_b, tb):
            tau, amp = _geometry(ts, ps, vs, tgt_pos[j0:j0 + tb],
                                 amp_b[j0:j0 + tb], tgt_vel, rx_offset, opts)
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


def _scalar_fields(t_slow, sat_pos, sat_vel, tgt_pos, amp_b, tgt_vel,
                   offsets, t_start: float, opts: EchoOpts, h_geo: int):
    """The two-pass backends' first pass: float32 (tau_rel, carrier, amp),
    each (C * P, B), the channels of ``offsets`` stacked on the pulse axis.
    With ``h_geo`` > 1 (and more than 3 h_geo pulses) the float64 geometry
    runs only at anchor pulses every ``h_geo`` and the delay field is
    interpolated quadratically in slow time; the carrier then derives from
    the interpolated float64 delay ('f64') or wraps once per anchor in
    float64 with the inter-anchor deltas in float32 ('split')."""
    num_p, num_b = t_slow.shape[0], tgt_pos.shape[0]
    dev, f32 = t_slow.device, torch.float32
    step = max(1, opts.max_elements // (8 * num_b))  # geometry pulses a pass

    def geometry(ts, ps, vs, off):
        parts = [_geometry(ts[i:i + step], ps[i:i + step], vs[i:i + step],
                           tgt_pos, amp_b, tgt_vel, off, opts)
                 for i in range(0, ts.shape[0], step)]
        return (torch.cat([q[0] for q in parts]),
                torch.cat([q[1] for q in parts]))

    def carrier_of(tau64):
        return _wrap_pi(-_TWO_PI * opts.fc_hz * tau64).to(f32)

    fields = []
    for off in offsets:
        if h_geo > 1 and num_p > 3 * h_geo:
            needed, trip, w_np = anchor_plan(num_p, h_geo)
            nd = torch.as_tensor(needed, device=dev)
            tau_a, amp_a = geometry(t_slow[nd], sat_pos[nd], sat_vel[nd],
                                    off)
            a0, a1, a2 = (torch.as_tensor(trip[:, k], device=dev)
                          for k in range(3))
            w64 = torch.as_tensor(w_np, device=dev)
            w32 = w64.to(f32)
            amp = (w32[:, 0, None] * amp_a[a0] + w32[:, 1, None] * amp_a[a1]
                   + w32[:, 2, None] * amp_a[a2])
            if opts.freq_geom_interp == "split":
                # sum(w) = 1: tau = tau[a1] + w0 (tau[a0] - tau[a1]) + w2
                # (tau[a2] - tau[a1]); the ns-scale deltas cast to float32
                # exactly enough, and the carrier wraps once per anchor
                car_a = carrier_of(tau_a)
                rel_a = (tau_a - t_start).to(f32)
                d0 = (tau_a[a0] - tau_a[a1]).to(f32)
                d2 = (tau_a[a2] - tau_a[a1]).to(f32)
                dly = w32[:, 0, None] * d0 + w32[:, 2, None] * d2
                tau = rel_a[a1] + dly
                dph = torch.tensor(-_TWO_PI * opts.fc_hz, dtype=f32,
                                   device=dev) * dly
                car = _wrap_pi(car_a[a1] + dph)
            else:
                tau64 = (w64[:, 0, None] * tau_a[a0]
                         + w64[:, 1, None] * tau_a[a1]
                         + w64[:, 2, None] * tau_a[a2])
                car = carrier_of(tau64)
                tau = (tau64 - t_start).to(f32)
        else:
            tau64, amp = geometry(t_slow, sat_pos, sat_vel, off)
            car = carrier_of(tau64)
            tau = (tau64 - t_start).to(f32)
        fields.append((tau, car, amp))
    return tuple(torch.cat([f[i] for f in fields]).contiguous()
                 for i in range(3))


def _fields(t_slow, sat_pos, sat_vel, tgt_pos, amp_b, tgt_vel, offsets,
            t_start: float, opts: EchoOpts):
    """The scalar fields (tau_rel, carrier, amp), each (C * P, B) float32,
    that the 'freq' and 'pallas' backends take."""
    with span("echo.fields"):
        if opts.backend == "freq":
            # delay-sort the scene once (mid-aperture ranges): the dense
            # spreaders' group windows need consecutive targets in a narrow
            # delay band; the echo is a sum over targets, so order never
            # changes the output
            num_p = t_slow.shape[0]
            order = torch.argsort(
                _norm(tgt_pos - sat_pos[num_p // 2][None, :]), stable=True)
            tgt_pos, amp_b = tgt_pos[order], amp_b[order]
        h_geo = opts.freq_geom_stride if opts.backend == "freq" else 0
        return _scalar_fields(t_slow, sat_pos, sat_vel, tgt_pos, amp_b,
                              tgt_vel, offsets, t_start, opts, h_geo)


def synth_options(opts: EchoOpts) -> dict:
    """The ``ops/echo_freq.py::synthesize`` options of the 'freq' backend."""
    return dict(oversample=opts.freq_oversample,
                edge_taper=opts.freq_edge_taper,
                spreader=opts.freq_spreader, spread_win=opts.freq_spread_win,
                spread_grp=opts.freq_spread_grp, conv=opts.freq_conv,
                spread_win_edge=opts.freq_spread_win_edge)


def _amplitudes(tgt_rcs, opts: EchoOpts):
    return torch.sqrt(tgt_rcs) if opts.amplitude == "sqrt_rcs" else tgt_rcs


def _phase_history(t_slow, sat_pos, sat_vel, tgt_pos, tgt_rcs, tgt_vel,
                   offsets, t_start: float, opts: EchoOpts) -> torch.Tensor:
    """Float64 tensor args on one device; ``offsets`` the channels' Rx
    offsets (the 'jnp' engine runs them one by one: on the card one
    launch of ``ops/cuda/echo_kernel.py::echo_direct`` each, elsewhere
    :func:`_direct`; the scalar-field backends in one pass). Returns
    (C * P, Ns) complex64 there, channel-major."""
    _check_backend(opts)
    if opts.backend == "jnp" and t_slow.is_cuda:
        # the direct engine on the card: one hand-written launch a channel
        from nis_sar_amtigmti_video_tpu_torch.ops.cuda.echo_kernel import (
            echo_direct)
        return echo_direct(t_slow, sat_pos, sat_vel, tgt_pos, tgt_rcs,
                           tgt_vel, opts, rx_offsets=offsets,
                           t_start=t_start)
    dev = t_slow.device
    num_p, num_b, ns = t_slow.shape[0], tgt_pos.shape[0], opts.num_samples
    if num_b == 0:                       # empty scene: pure zeros
        return torch.zeros((len(offsets) * num_p, ns),
                           dtype=torch.complex64, device=dev)
    amp_b = _amplitudes(tgt_rcs, opts)
    if opts.backend == "jnp":
        return torch.cat([_direct(t_slow, sat_pos, sat_vel, tgt_pos, amp_b,
                                  tgt_vel, off, t_start, opts)
                          for off in offsets])
    tau, car, amp = _fields(t_slow, sat_pos, sat_vel, tgt_pos, amp_b,
                            tgt_vel, offsets, t_start, opts)
    if opts.backend == "freq":
        from nis_sar_amtigmti_video_tpu_torch.ops.echo_freq import synthesize
        return synthesize(tau, car, amp, opts, **synth_options(opts))
    from nis_sar_amtigmti_video_tpu_torch.ops.cuda.echo_kernel import (
        echo_accumulate)
    return echo_accumulate(tau, car, amp, **echo_kernel_args(opts, dev))


@functools.lru_cache(maxsize=32)
def fast_time_on(opts: EchoOpts, device) -> torch.Tensor:
    """:func:`fast_time_grid` in float32 on ``device``, the direct-echo
    kernel's grid: copied there once a process for each (options, device),
    so that a launch copies nothing from the host. Read, never written."""
    return torch.as_tensor(fast_time_grid(opts), device=device).to(
        torch.float32)


def echo_kernel_args(opts: EchoOpts, device) -> dict:
    """The 'pallas' backend's arguments of ``echo_accumulate`` beside the
    scalar fields: t_fast (Ns,) float32 on ``device``, k_pi, shift, half."""
    return dict(t_fast=fast_time_on(opts, device),
                k_pi=float(math.pi * opts.chirp_rate),
                shift=float(opts.chirp_shift), half=float(opts.half_width))


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def _inputs(trajectory, targets, target_velocity, device):
    return (_f64(trajectory.times, device), _f64(trajectory.positions, device),
            _f64(trajectory.velocities, device),
            _f64(targets.positions, device).reshape(-1, 3),
            _f64(targets.rcs, device), _f64(target_velocity, device))


def phase_history(trajectory, targets, opts: EchoOpts, *, t_start: float,
                  target_velocity=(0.0, 0.0, 0.0), rx_offset: float = 0.0,
                  device=None) -> torch.Tensor:
    """One channel's raw phase history: (num_pulses, num_samples) complex64
    on ``device`` (None: the card; a RuntimeError where there is none, so
    pass ``device="cpu"`` there).

    trajectory: geometry.orbit.Trajectory (float64 times/positions/
    velocities); targets: scene.targets.PointTargets; t_start: receive-window
    opening time [s]; target_velocity: rigid velocity of the cluster [m/s];
    rx_offset: along-track Rx phase-center offset from the Tx [m].
    """
    device = entry_device(device)
    return _phase_history(
        *_inputs(trajectory, targets, target_velocity, device),
        [float(rx_offset)], float(t_start), opts)


def multi_channel_phase_history(trajectory, targets, opts: EchoOpts, *,
                                t_start: float, rx_offsets,
                                target_velocity=(0.0, 0.0, 0.0),
                                channels_as_tuple: Optional[bool] = None,
                                device=None):
    """All receive channels: a (num_channels, P, Ns) complex64 tensor on
    ``device`` (None: the card, as :func:`phase_history`), or with
    ``channels_as_tuple=True`` a tuple of its (P, Ns) channels. The 'freq'
    and 'pallas' backends run every channel in one pass (the channels'
    scalar fields stacked on the pulse axis). (The reference returns a
    tuple for 'freq' by default, a TPU layout workaround; here the stack is
    the default everywhere.)"""
    device = entry_device(device)
    offs = [float(o) for o in np.asarray(rx_offsets, np.float64).reshape(-1)]
    with span("echo"):
        args = _inputs(trajectory, targets, target_velocity, device)
        out = _phase_history(*args, offs, float(t_start), opts).reshape(
            len(offs), args[0].shape[0], opts.num_samples)
    return tuple(out) if channels_as_tuple else out


def scalar_fields(trajectory, targets, opts: EchoOpts, *, t_start: float,
                  rx_offsets, target_velocity=(0.0, 0.0, 0.0), device=None):
    """The first pass of the 'freq' and 'pallas' backends of
    :func:`multi_channel_phase_history` (the same arguments): (tau_rel,
    carrier, amp), each (C * P, B) float32 on ``device`` (None: the card),
    the channels stacked on the pulse axis and, for 'freq', the targets in
    delay order. The second pass takes them as they are."""
    device = entry_device(device)
    _check_backend(opts)
    if opts.backend == "jnp":
        raise ValueError("scalar_fields: the 'jnp' engine has no scalar-field"
                         " pass")
    offs = [float(o) for o in np.asarray(rx_offsets, np.float64).reshape(-1)]
    t, p, v, pos, rcs, tv = _inputs(trajectory, targets, target_velocity,
                                    device)
    return _fields(t, p, v, pos, _amplitudes(rcs, opts), tv, offs,
                   float(t_start), opts)
