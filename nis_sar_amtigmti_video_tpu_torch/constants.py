"""Physical constants — the single source of truth.

The reference repeats these as module globals in every script and drifts
between them (two Earth radii: ``sar_satellite_sim.py:24`` uses 6371000.0 while
``sar_vehicle_sim.py:23`` uses the WGS84 6378137.0). Here each constant exists
once; per-scenario presets that need the reference's exact (sometimes
inconsistent) values carry them in their config, not here.
"""

# Speed of light [m/s] (sar_satellite_sim.py:23)
C = 299792458.0

# Mean spherical Earth radius [m] used by the spaceborne reference scripts
# (sar_satellite_sim.py:24)
RE_MEAN = 6371000.0

# WGS84 equatorial radius [m] used by the airborne reference script
# (sar_vehicle_sim.py:23)
RE_WGS84 = 6378137.0

# Earth gravitational parameter GM [m^3/s^2] (sar_satellite_sim.py:27)
GM_EARTH = 3.986004418e14

# Boltzmann constant [J/K] (sar_satellite_sim.py:314)
K_BOLTZMANN = 1.380649e-23

# Sidereal-ish day used by the JS constellation designers [s]
# (VideoSAR constellation.html — earth rotation 2*pi/86400)
EARTH_DAY_S = 86400.0
