"""Plain reference of the ocean noise added to a raw segment.

The upstream's noise as the repo's float64 NumPy oracle describes it
(oracle/pipeline.py::snr_db_radar_equation, add_ocean_noise): the per-pulse
radar-equation SNR of sar_batch_sim.py:53-63 plus its SNR_BOOST_DB; thermal
circular Gaussian noise at ref_power / 10^(snr / 10) and K-distributed sea
clutter at ref_power / 10^(scr / 10), its intensity a Gamma(nu, 1/nu)
texture times an Exp(1) speckle, its phase uniform; ref_power the
segment's peak |raw|^2, as the VideoSAR collect scales it.

The unit draws are input data that the reference shares with the program,
as the scene is: a torch.Generator on the data's device, seeded from
(seed, stream) as (seed x 1,000,003 + stream) mod 2^63, gives float32
draws of the segment's shape in the order thermal real, thermal imaginary,
texture, speckle, phase. Everything after the draws is float64."""

from __future__ import annotations

import math

import torch

K_BOLTZMANN = 1.380649e-23


def snr_db(r_slant: float, rcs: float, wavelength: float, bandwidth: float,
           n: dict) -> float:
    """The per-pulse SNR (dB) of a target of ``rcs`` at ``r_slant``;
    ``n``: tx_power_w, antenna_length_m, antenna_width_m,
    aperture_efficiency, system_temp_k, noise_figure_db, loss_db,
    snr_boost_db."""
    area = n["antenna_length_m"] * n["antenna_width_m"] \
        * n["aperture_efficiency"]
    gain = 4.0 * math.pi * area / wavelength ** 2
    num = n["tx_power_w"] * gain ** 2 * wavelength ** 2 * rcs
    den = ((4.0 * math.pi) ** 3 * r_slant ** 4 * K_BOLTZMANN
           * n["system_temp_k"] * bandwidth * 10.0 ** (n["loss_db"] / 10.0)
           * 10.0 ** (n["noise_figure_db"] / 10.0))
    return 10.0 * math.log10(num / den) + n["snr_boost_db"]


def add(raw: torch.Tensor, seed: int, stream: int, snr: float,
        scr_db: float, k_shape: float) -> torch.Tensor:
    """raw (complex128) + its segment's thermal noise and sea clutter."""
    dev, shape = raw.device, tuple(raw.shape)
    f32, f64 = torch.float32, torch.float64
    g = torch.Generator(device=dev)
    g.manual_seed((int(seed) * 1_000_003 + int(stream)) % (2 ** 63))
    re = torch.randn(shape, dtype=f32, device=dev, generator=g).to(f64)
    im = torch.randn(shape, dtype=f32, device=dev, generator=g).to(f64)
    alpha = torch.full(shape, float(k_shape), dtype=f32, device=dev)
    texture = torch._standard_gamma(alpha, generator=g).to(f64) / k_shape
    del alpha
    speckle = torch.empty(shape, dtype=f32, device=dev).exponential_(
        generator=g).to(f64)
    phase = torch.rand(shape, dtype=f32, device=dev,
                       generator=g).to(f64) * (2.0 * math.pi)
    ref_power = float((raw.abs() ** 2).max())
    noise_power = ref_power / 10.0 ** (snr / 10.0)
    clutter_power = ref_power / 10.0 ** (scr_db / 10.0)
    thermal = math.sqrt(noise_power / 2.0) * torch.complex(re, im)
    del re, im
    clutter = torch.polar(torch.sqrt(clutter_power * texture * speckle),
                          phase)
    return raw + thermal + clutter
