"""Two-channel ATI/DPCA GMTI pipeline.

Counterpart of ``nis_sar_amtigmti_video_tpu/models/gmti.py``: bistatic
two-channel echo of (moving ship + stationary clutter), DPCA one-pulse-shift
co-registration, dual CSA focusing, ATI/DPCA products, channel balancing,
cancellation metric, radial-velocity map and CFAR detection. Everything
after the host-side trajectory build runs on the caller's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.config import ScenarioConfig
from nis_sar_amtigmti_video_tpu_torch.geometry import orbit
from nis_sar_amtigmti_video_tpu_torch.gmti import ati, cfar, dpca, velocity
from nis_sar_amtigmti_video_tpu_torch.gmti import fused as fused_mod
from nis_sar_amtigmti_video_tpu_torch.models.stripmap import echo_opts_for
from nis_sar_amtigmti_video_tpu_torch.ops import csa as csa_ops
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import csa_kernel
from nis_sar_amtigmti_video_tpu_torch.ops.echo import (
    multi_channel_phase_history, window_start_time)
from nis_sar_amtigmti_video_tpu_torch.scene.targets import PointTargets


class GmtiProducts(NamedTuple):
    slc1: torch.Tensor            # channel-1 SLC (azimuth, range)
    slc2: torch.Tensor            # channel-2 SLC (balanced if requested)
    ati_phase: torch.Tensor       # interferometric phase [rad]
    dpca_mag: torch.Tensor        # |slc1 - slc2| clutter-cancelled magnitude
    velocity_map: torch.Tensor    # radial velocity from ATI phase [m/s]
    detections: cfar.CfarResult
    cancellation_ratio: torch.Tensor
    cal_phase: torch.Tensor       # applied channel-balance phase [rad]
    range_axis: np.ndarray
    cross_range: np.ndarray
    v_amb: float                  # unambiguous radial velocity span [m/s]


def simulate_two_channel(sc: ScenarioConfig, moving: PointTargets,
                         target_velocity,
                         static: Optional[PointTargets] = None, *,
                         device=None):
    """Raw phase histories of both channels: ((2, P, Ns) complex64 on
    ``device``, trajectory, window start time t0).

    The moving and stationary scatterer sets are simulated separately (each
    with its own rigid velocity) and summed."""
    r, g, c = sc.radar, sc.geometry, sc.collect
    n_p = c.num_pulses(r.prf_hz)
    traj = orbit.make_trajectory(
        g, orbit.slow_time_grid(c.integration_time_s, n_p))
    opts = echo_opts_for(sc)
    t0 = window_start_time(g.slant_range_m, opts, c.window_length_s,
                           c.window_start_mode)
    offs = sc.channels.rx_offsets()
    raw = multi_channel_phase_history(traj, moving, opts, t_start=t0,
                                      rx_offsets=offs,
                                      target_velocity=target_velocity,
                                      device=device)
    if static is not None and static.num > 0:
        raw = raw + multi_channel_phase_history(traj, static, opts,
                                                t_start=t0, rx_offsets=offs,
                                                device=device)
    return raw, traj, t0


def focus_and_products(raw2ch, sc: ScenarioConfig, t0: float, *,
                       shift_pulses: int = 1, balance: bool = True,
                       mask_threshold: float = 0.05,
                       cfar_params: cfar.CfarParams = cfar.CfarParams(),
                       path: str = "auto") -> GmtiProducts:
    """DPCA shift -> dual CSA -> ATI/DPCA/velocity/CFAR products, on the
    device of ``raw2ch`` ((2, P, Ns) complex64, or a pair of channels).

    path: 'composed' (CSA x2 with torch.fft, then the products op by op),
    'kernel_fused' (gmti/fused.py::gmti_cpi: the four CUDA kernels on a CUDA
    device, their plain versions on the CPU; needs a CPI shape the kernels
    take, else ValueError), or 'auto' (kernel_fused where the config opted
    into the kernel numeric class with ``sc.processing.fft_impl='pallas'``,
    the shape is supported and the data is on CUDA; composed otherwise).
    """
    r, g = sc.radar, sc.geometry
    raw1, raw2 = dpca.pulse_shift_coregister(raw2ch[0], raw2ch[1],
                                             shift_pulses)
    n_p, n_s = raw1.shape
    p = csa_ops.CsaParams(
        wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
        prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m, t_start_fast=t0,
        num_pulses=n_p, num_samples=n_s)
    if path not in ("composed", "kernel_fused", "auto"):
        raise ValueError(f"unknown GMTI path {path!r}")
    supported = csa_kernel.supported(n_p, n_s)
    if path == "kernel_fused" and not supported:
        raise ValueError(
            f"path='kernel_fused' needs a CPI of power-of-two sides in "
            f"[{csa_kernel.MIN_N}, {csa_kernel.MAX_N}]; got {(n_p, n_s)}")
    kernels = path == "kernel_fused" or (
        path == "auto" and supported and sc.processing.fft_impl == "pallas"
        and raw1.device.type == "cuda")
    f = csa_ops.csa_factors(p, raw1.device)
    # velocity inversion uses the phase-center progression speed (the
    # platform's true along-track velocity), not the focusing V_eff
    v_platform = g.speed_mps
    v_amb = velocity.ambiguous_velocity(r.wavelength_m, v_platform,
                                        sc.channels.baseline_m)
    if kernels:
        (s1r, s1i, s2r, s2i, cal, phase, dmag, det) = fused_mod.gmti_cpi(
            raw1.real.contiguous(), raw1.imag.contiguous(),
            raw2.real.contiguous(), raw2.imag.contiguous(), f,
            balance=balance, mask_threshold=mask_threshold,
            cfar_params=cfar_params)
        slc1 = torch.complex(s1r, s1i)
        slc2 = torch.complex(s2r, s2i)
        if balance:
            slc2 = ati.apply_balance(slc2, cal)
        # cancellation ratio on the kernel's |dpca| plane (abs is a no-op)
        ratio = dpca.cancellation_ratio(slc1, dmag)
    else:
        slc1 = csa_ops.apply_csa_fused(raw1, f)
        slc2 = csa_ops.apply_csa_fused(raw2, f)
        cal = ati.channel_balance_phase(slc1, slc2)
        if balance:
            slc2 = ati.apply_balance(slc2, cal)
        phase = ati.masked_phase(slc1, slc2, mask_threshold)
        diff = dpca.dpca_difference(slc1, slc2)
        dmag = torch.abs(diff)
        det = cfar.ca_cfar(dmag ** 2, cfar_params)
        ratio = dpca.cancellation_ratio(slc1, diff)
    vmap_ = velocity.velocity_from_phase(phase, r.wavelength_m, v_platform,
                                         sc.channels.baseline_m)
    rax, cax = csa_ops.csa_axes(p)
    return GmtiProducts(slc1=slc1, slc2=slc2, ati_phase=phase, dpca_mag=dmag,
                        velocity_map=vmap_, detections=det,
                        cancellation_ratio=ratio, cal_phase=cal,
                        range_axis=rax, cross_range=cax, v_amb=v_amb)


def run(sc: ScenarioConfig, moving: PointTargets, target_velocity,
        static: Optional[PointTargets] = None, *, device=None,
        **kw) -> GmtiProducts:
    """Scene -> two-channel echo on ``device`` -> CPI products
    (``kw`` go to :func:`focus_and_products`)."""
    raw, _, t0 = simulate_two_channel(sc, moving, target_velocity, static,
                                      device=device)
    return focus_and_products(raw, sc, t0, **kw)
