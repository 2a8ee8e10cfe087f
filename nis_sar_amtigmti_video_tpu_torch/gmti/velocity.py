"""Radial-velocity estimation from ATI phase.

Counterpart of ``nis_sar_amtigmti_video_tpu/gmti/velocity.py``; plain
arithmetic, so it serves floats, numpy arrays and tensors alike.

Sign convention: v_r is the *closing* (line-of-sight, positive toward the
radar) velocity. The two-way ATI phase of a mover, for physical along-track
baseline B and platform velocity V, is

    phi = (2*pi*B / (lambda*V)) * v_r        (effective lag B/(2V), two-way)

(the trailing channel sees the scene the lag later; an approaching target has
shortened its range, giving positive relative phase with the pulse-shift
co-registration of gmti/dpca.py). phi reaches +/-pi at
v_amb = lambda*V/(2B) — the quantity the ``fastmover.html`` demo displays
(fastmover.html:313-322) — so velocities are unambiguous on (-v_amb, +v_amb].
Inverting phi gives the GMTI velocity map; wrapping beyond +/-v_amb is
resolved by the dual-baseline CRT solver (gmti/crt.py).
"""

from __future__ import annotations

import math


def ambiguous_velocity(wavelength_m: float, v_platform: float,
                       baseline_m: float) -> float:
    """Unambiguous radial-velocity span lambda*V/(2B)."""
    return wavelength_m * v_platform / (2.0 * baseline_m)


def velocity_from_phase(phase, wavelength_m: float, v_platform: float,
                        baseline_m: float):
    """v_r = phi * lambda * V / (2*pi*B) (mod v_amb)."""
    return phase * (wavelength_m * v_platform
                    / (2.0 * math.pi * baseline_m))


def phase_from_velocity(v_r, wavelength_m: float, v_platform: float,
                        baseline_m: float):
    return v_r * (2.0 * math.pi * baseline_m
                  / (wavelength_m * v_platform))


def azimuth_displacement(v_r, range_m, v_platform):
    """A mover's image shifts in azimuth by v_r * R / V (the 'train off the
    track' effect the moving-scenario sims demonstrate)."""
    return v_r * range_m / v_platform
