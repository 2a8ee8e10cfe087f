"""Discrete ocean-clutter scatterer fields.

The reference scatters 5,000 uniform points over a +/-3 km patch with
exponentially distributed RCS derived from a surface reflectivity sigma0
(``sar_ati_dcpa_sim_csa.py:75-103``). Here the field is generated with an
explicit numpy Generator on the host, for reproducibility.

Copy of the reference package's module of the same path; the port's tests
hold the two to the same output.
"""

from __future__ import annotations

import numpy as np

from nis_sar_amtigmti_video_tpu_torch.scene.targets import PointTargets


def ocean_clutter_field(
    rng: np.random.Generator,
    num_points: int = 5000,
    half_width_m: float = 3000.0,
    sigma0_db: float = 5.0,
) -> PointTargets:
    """Uniform random scatterers with exponential RCS.

    Mean per-point RCS = area * 10^(sigma0/10) / N, matching
    sar_ati_dcpa_sim_csa.py:78-93.
    """
    area = (2.0 * half_width_m) ** 2
    mean_rcs = area * 10.0 ** (sigma0_db / 10.0) / num_points
    xy = rng.uniform(-half_width_m, half_width_m, size=(num_points, 2))
    pos = np.concatenate([xy, np.zeros((num_points, 1))], axis=1)
    rcs = rng.exponential(mean_rcs, size=num_points)
    return PointTargets(pos, rcs, tuple(f"clutter_{i}" for i in range(num_points)))
