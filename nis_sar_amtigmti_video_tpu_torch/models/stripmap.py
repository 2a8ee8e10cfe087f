"""Single-channel stripmap pipeline (spaceborne or airborne).

Counterpart of ``nis_sar_amtigmti_video_tpu/models/stripmap.py``: the
upstream's ``sar_satellite_sim.py`` / ``sar_vehicle_sim.py`` chain,
geometry -> targets -> echo -> radar-equation noise -> RDA or CSA focus.
The reference's ``jax.random`` key becomes ``seed`` (None: no noise), drawn
from ``ops/noise.py::generator(seed)`` on the run's device, so the two
packages give different noise from the same seed.

:func:`focus` is the held-raw entry (a recorded collect in, its SLC out):
:func:`run` simulates, then calls it. Its stage record is ``focus`` ⊃
``focus.csa`` (the CSA branch) or the RDA's ``focus.range``,
``focus.azimuth``, ``focus.rcmc``, ``focus.compress`` (``ops/rda.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.config import ScenarioConfig
from nis_sar_amtigmti_video_tpu_torch.geometry import orbit
from nis_sar_amtigmti_video_tpu_torch.ops import csa as csa_ops
from nis_sar_amtigmti_video_tpu_torch.ops import noise as noise_ops
from nis_sar_amtigmti_video_tpu_torch.ops import rda as rda_ops
from nis_sar_amtigmti_video_tpu_torch.ops.echo import (EchoOpts,
                                                       phase_history,
                                                       window_start_time)
from nis_sar_amtigmti_video_tpu_torch.scene.targets import PointTargets
from nis_sar_amtigmti_video_tpu_torch.utils.device import entry_device
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import span


class StripmapProducts(NamedTuple):
    raw: torch.Tensor                 # (P, Ns) complex64 phase history (w/ noise)
    image: torch.Tensor               # focused SLC, (azimuth, range)
    intermediates: Optional[rda_ops.RdaProducts]   # RDA chain (None for CSA)
    range_axis: np.ndarray
    cross_range: np.ndarray
    doppler_axis: Optional[np.ndarray]
    snr_db: float


def echo_opts_for(sc: ScenarioConfig) -> EchoOpts:
    r, c = sc.radar, sc.collect
    return EchoOpts(
        fc_hz=r.fc_hz, chirp_rate=r.chirp_rate, pulse_width_s=r.pulse_width_s,
        fs_hz=r.fs_hz, num_samples=c.num_samples(r.fs_hz),
        endpoint_grid=(c.window_start_mode == "reference"),
        chirp_centering="leading", amplitude="sqrt_rcs",
        backend=c.echo_backend, freq_oversample=c.echo_oversample)


def simulate_raw(sc: ScenarioConfig, targets: PointTargets, *,
                 target_velocity=(0.0, 0.0, 0.0), seed: int | None = None,
                 avg_rcs: float | None = None, device=None):
    """Trajectory + echo + (with ``seed``) noise on ``device`` (None: the
    card). Returns (raw, trajectory, t_start, snr_db)."""
    device = entry_device(device)
    r, g, c = sc.radar, sc.geometry, sc.collect
    n_p = c.num_pulses(r.prf_hz)
    traj = orbit.make_trajectory(g, orbit.slow_time_grid(
        c.integration_time_s, n_p))
    opts = echo_opts_for(sc)
    t0 = window_start_time(g.slant_range_m, opts, c.window_length_s,
                           c.window_start_mode)
    raw = phase_history(traj, targets, opts, t_start=t0,
                        target_velocity=target_velocity, device=device)
    rcs = avg_rcs if avg_rcs is not None else targets.total_rcs
    snr, _ = noise_ops.snr_db(sc.noise, g.slant_range_m, rcs,
                              r.wavelength_m, r.bandwidth_hz,
                              c.integration_time_s)
    if seed is not None:
        raw = noise_ops.add_ocean_noise(
            noise_ops.generator(seed, 0, raw.device), raw, snr,
            sc.noise.scr_db, sc.noise.k_shape)
    return raw, traj, t0, snr


def csa_params(sc: ScenarioConfig, t0: float, n_p: int,
               n_s: int) -> csa_ops.CsaParams:
    r, g = sc.radar, sc.geometry
    return csa_ops.CsaParams(
        wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
        prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m, t_start_fast=t0, num_pulses=n_p,
        num_samples=n_s)


def rda_params(sc: ScenarioConfig, n_p: int, n_s: int) -> rda_ops.RdaParams:
    r, g, pr = sc.radar, sc.geometry, sc.processing
    return rda_ops.RdaParams(
        wavelength_m=r.wavelength_m, pulse_width_s=r.pulse_width_s,
        chirp_rate=r.chirp_rate, fs_hz=r.fs_hz, prf_hz=r.prf_hz,
        velocity_mps=g.effective_velocity_mps, range_ref_m=g.slant_range_m,
        num_pulses=n_p, num_samples=n_s, range_window=pr.range_window,
        azimuth_window=pr.azimuth_window, rcmc_mode=pr.rcmc_mode)


def focus(raw: torch.Tensor, sc: ScenarioConfig, t0: float, *,
          intermediates: bool = True):
    """A held (P, Ns) complex64 raw -> (SLC, the RDA's viewer planes or
    None), on raw's device, by ``sc.processing.algorithm`` ('rda' or
    'csa'; ``t0``, the receive window's start, places the CSA's range
    axis). ``intermediates=False`` returns (SLC, None) and keeps no viewer
    plane."""
    n_p, n_s = raw.shape
    algo = sc.processing.algorithm
    if algo not in ("rda", "csa"):
        raise ValueError(f"unknown algorithm {algo!r} for stripmap")
    with span("focus"):
        if algo == "csa":
            with span("focus.csa"):
                return csa_ops.focus_csa(raw, csa_params(sc, t0, n_p,
                                                         n_s)), None
        prod = rda_ops.focus_rda(raw, rda_params(sc, n_p, n_s),
                                 intermediates=intermediates)
        return prod.image, (prod if intermediates else None)


def run(sc: ScenarioConfig, targets: PointTargets, *,
        target_velocity=(0.0, 0.0, 0.0), seed: int | None = None,
        avg_rcs: float | None = None, device=None) -> StripmapProducts:
    """A single-channel collect simulated on ``device`` (None: the card)
    and focused as the scenario config says."""
    raw, _, t0, snr = simulate_raw(sc, targets,
                                   target_velocity=target_velocity,
                                   seed=seed, avg_rcs=avg_rcs, device=device)
    n_p, n_s = raw.shape
    image, prod = focus(raw, sc, t0)
    if sc.processing.algorithm == "csa":
        rax, cax = csa_ops.csa_axes(csa_params(sc, t0, n_p, n_s))
        return StripmapProducts(raw=raw, image=image, intermediates=None,
                                range_axis=rax, cross_range=cax,
                                doppler_axis=None, snr_db=snr)
    _, r_centered, cax, fd = rda_ops.rda_axes(rda_params(sc, n_p, n_s))
    return StripmapProducts(raw=raw, image=image, intermediates=prod,
                            range_axis=r_centered, cross_range=cax,
                            doppler_axis=fd, snr_db=snr)
