"""Radar-equation SNR + thermal / K-distributed sea-clutter injection.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/noise.py``. The reference's
``jax.random`` keys become ``torch.Generator`` objects on the data's device:
the two give different numbers from the same seed, so tests compare powers
and distributions, never samples. :func:`generator` derives one generator
from (seed, stream index), the counterpart of ``jax.random.fold_in``.
"""

from __future__ import annotations

import math

import torch

from nis_sar_amtigmti_video_tpu_torch import constants as k
from nis_sar_amtigmti_video_tpu_torch.config import NoiseConfig


def snr_db(cfg: NoiseConfig, r_slant_m: float, rcs_m2: float,
           wavelength_m: float, bandwidth_hz: float,
           integration_time_s: float | None = None) -> tuple[float, float]:
    """(snr_db, gain_db) from the radar equation (the reference's float
    math, unchanged).

    With ``integration_time_s`` this is the coherent-integration SNR;
    without, the raw per-pulse SNR. ``snr_boost_db`` from the config is
    added.
    """
    area = cfg.antenna_length_m * cfg.antenna_width_m * cfg.aperture_efficiency
    gain = 4.0 * math.pi * area / wavelength_m ** 2
    num = cfg.tx_power_w * gain ** 2 * wavelength_m ** 2 * rcs_m2
    if integration_time_s is not None:
        num *= integration_time_s
    den = ((4.0 * math.pi) ** 3 * r_slant_m ** 4 * k.K_BOLTZMANN
           * cfg.system_temp_k * bandwidth_hz
           * 10.0 ** (cfg.loss_db / 10.0)
           * 10.0 ** (cfg.noise_figure_db / 10.0))
    return (10.0 * math.log10(num / den) + cfg.snr_boost_db,
            10.0 * math.log10(gain))


def generator(seed: int, stream: int = 0, device=None) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, stream): the same pair
    always draws the same numbers, different streams independent ones."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream)) % (2 ** 63))
    return g


def sample_k_clutter(gen: torch.Generator, shape, clutter_power,
                     k_shape: float = 1.0, device=None):
    """K-distributed sea clutter: intensity = power * Gamma(nu, 1/nu)
    texture * Exp(1) speckle, uniform phase. complex64 on ``device``."""
    f32 = torch.float32
    alpha = torch.full(tuple(shape), float(k_shape), dtype=f32,
                       device=device)
    texture = torch._standard_gamma(alpha, generator=gen) / k_shape
    speckle = torch.empty(tuple(shape), dtype=f32,
                          device=device).exponential_(generator=gen)
    phase = torch.rand(tuple(shape), dtype=f32, device=device,
                       generator=gen) * (2.0 * math.pi)
    amp = torch.sqrt(clutter_power * texture * speckle)
    return torch.complex(amp * torch.cos(phase), amp * torch.sin(phase))


def sample_thermal(gen: torch.Generator, shape, noise_power, device=None):
    """Circular complex Gaussian at the given total power (complex64)."""
    f32 = torch.float32
    std = torch.sqrt(torch.as_tensor(noise_power / 2.0)).to(f32)
    re = torch.randn(tuple(shape), dtype=f32, device=device, generator=gen)
    im = torch.randn(tuple(shape), dtype=f32, device=device, generator=gen)
    return torch.complex(std * re, std * im)


def add_ocean_noise(gen: torch.Generator, raw: torch.Tensor, snr_db_val,
                    scr_db: float = 10.0, k_shape: float = 1.0,
                    ref_power=None, ref_power_mode: str = "mean"):
    """raw + thermal + K-clutter, drawn from ``gen`` (a generator on raw's
    device).

    ``ref_power_mode='mean'`` scales to mean signal power; ``'peak'`` to
    peak power. Pass ``ref_power`` to pin it explicitly.
    """
    if ref_power is None:
        p = raw.abs() ** 2
        ref_power = p.mean() if ref_power_mode == "mean" else p.max()
    noise_power = ref_power / 10.0 ** (snr_db_val / 10.0)
    clutter_power = ref_power / 10.0 ** (scr_db / 10.0)
    dev = raw.device
    return (raw
            + sample_thermal(gen, raw.shape, noise_power, dev)
            + sample_k_clutter(gen, raw.shape, clutter_power, k_shape, dev))
