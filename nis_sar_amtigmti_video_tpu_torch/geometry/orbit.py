"""Platform trajectories: circular great-circle orbits and linear tracks.

Scene frame: target-grid origin at (0,0,0) on the surface, Earth center at
(0,0,-Re). The spaceborne trajectory is a great circle about the Earth center
through the broadside point, P(t) = S0 cos(wt) + R v_hat sin(wt), as in
``sar_satellite_sim.py:130-172`` (along-track = +X) and
``sar_ati_dcpa_sim_csa.py:50-66`` (along-track = +Y). The airborne track is a
constant-altitude straight line (``sar_vehicle_sim.py:58-71``).

Everything here is closed-form, vectorized float64 — trajectories are tiny
(num_pulses x 3) and feed the f64 geometry path of the echo engine.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from nis_sar_amtigmti_video_tpu_torch.config import GeometryConfig


class Trajectory(NamedTuple):
    """Platform state sampled at pulse times (host-side float64)."""

    times: np.ndarray       # (P,)   slow time [s], 0 at aperture center
    positions: np.ndarray   # (P, 3) [m] in the scene frame
    velocities: np.ndarray  # (P, 3) [m/s]

    @property
    def num_pulses(self) -> int:
        return self.times.shape[0]

    def slice(self, i0: int, i1: int) -> "Trajectory":
        return Trajectory(self.times[i0:i1], self.positions[i0:i1],
                          self.velocities[i0:i1])


def slow_time_grid(integration_time_s: float, num_pulses: int) -> np.ndarray:
    """Reference convention: linspace over [-T/2, +T/2] inclusive
    (sar_satellite_sim.py:90) — NOT a uniform 1/PRF comb; endpoints included."""
    return np.linspace(-integration_time_s / 2.0, integration_time_s / 2.0,
                       num_pulses)


def _axis_vectors(geom: GeometryConfig):
    """Initial radius vector (from Earth center) and along-track unit vector."""
    sin_g = np.sin(geom.earth_angle_rad)
    cos_g = np.cos(geom.earth_angle_rad)
    r = geom.orbit_radius_m
    if geom.along_track_axis == "x":
        # look right (+Y is cross-track): sat offset to -Y (sar_satellite_sim.py:136)
        s0 = np.array([0.0, -r * sin_g, r * cos_g])
        v_unit = np.array([1.0, 0.0, 0.0])
    elif geom.along_track_axis == "y":
        # sat offset to -X (sar_ati_dcpa_sim_csa.py:53)
        s0 = np.array([-r * sin_g, 0.0, r * cos_g])
        v_unit = np.array([0.0, 1.0, 0.0])
    else:
        raise ValueError(f"along_track_axis must be 'x' or 'y', got {geom.along_track_axis!r}")
    return s0, v_unit


def orbit_trajectory(geom: GeometryConfig, times: np.ndarray) -> Trajectory:
    """Great-circle orbit through the broadside geometry at t=0."""
    s0, v_unit = _axis_vectors(geom)
    v_sat = geom.orbital_velocity_mps
    omega = v_sat / geom.orbit_radius_m
    wt = omega * times[:, None]
    center_offset = np.array([0.0, 0.0, -geom.earth_radius_m])

    pos = s0 * np.cos(wt) + (geom.orbit_radius_m * v_unit) * np.sin(wt) + center_offset
    vel = (v_sat * v_unit) * np.cos(wt) - (s0 * omega) * np.sin(wt)
    return Trajectory(times=np.asarray(times, np.float64), positions=pos,
                      velocities=vel)


def linear_trajectory(geom: GeometryConfig, times: np.ndarray) -> Trajectory:
    """Straight constant-altitude track, along-track = +Y, looking +X-down."""
    r0 = geom.slant_range_m
    look = np.radians(geom.look_angle_deg)
    x = -r0 * np.sin(look)
    z = r0 * np.cos(look)
    v = geom.platform_velocity_mps
    pos = np.stack([np.full_like(times, x), v * times, np.full_like(times, z)],
                   axis=1)
    vel = np.broadcast_to(np.array([0.0, v, 0.0]), pos.shape).copy()
    return Trajectory(times=np.asarray(times, np.float64), positions=pos,
                      velocities=vel)


def make_trajectory(geom: GeometryConfig, times: np.ndarray) -> Trajectory:
    if geom.platform == "orbit":
        return orbit_trajectory(geom, times)
    if geom.platform == "linear":
        return linear_trajectory(geom, times)
    raise ValueError(f"unknown platform {geom.platform!r}")
