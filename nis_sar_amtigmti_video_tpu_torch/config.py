"""Typed configuration tree + named presets.

Replaces the reference's copy-pasted module-level constant blocks
(``sar_satellite_sim.py:22-59``, ``sar_ati_dcpa_sim_csa.py:17-43``,
``sar_batch_sim.py:12-49``, ``sar_vehicle_sim.py:21-44``). Every preset below
reproduces one reference script's exact constants so golden tests can pin
behavior; new scenarios compose the same dataclasses.

All configs are plain frozen dataclasses of Python scalars (hashable, so
they can key caches).

Copy of the reference package's ``config.py``: the port cannot import it,
because importing any module of the reference package loads JAX. The port's
tests hold every preset to the reference field by field.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from nis_sar_amtigmti_video_tpu_torch import constants as k


@dataclass(frozen=True)
class RadarConfig:
    """Waveform + RF front-end parameters."""

    fc_hz: float = 9.65e9           # carrier (sar_satellite_sim.py:32)
    bandwidth_hz: float = 500e6     # chirp bandwidth (sar_satellite_sim.py:33)
    prf_hz: float = 6000.0          # pulse repetition frequency (sar_satellite_sim.py:35)
    pulse_width_s: float = 20e-6    # LFM pulse width (sar_satellite_sim.py:36)
    fs_hz: float = 600e6            # ADC rate (sar_satellite_sim.py:245)

    @property
    def wavelength_m(self) -> float:
        return k.C / self.fc_hz

    @property
    def chirp_rate(self) -> float:
        """LFM rate K_r [Hz/s]."""
        return self.bandwidth_hz / self.pulse_width_s


@dataclass(frozen=True)
class GeometryConfig:
    """Platform / look geometry. ``platform='orbit'`` is a circular great-circle
    orbit (sar_satellite_sim.py:130-172); ``'linear'`` is a straight airborne
    track (sar_vehicle_sim.py:58-71)."""

    platform: str = "orbit"          # 'orbit' | 'linear'
    altitude_m: float = 350000.0     # (sar_satellite_sim.py:25)
    look_angle_deg: float = 45.0     # (sar_satellite_sim.py:40)
    earth_radius_m: float = k.RE_MEAN
    platform_velocity_mps: float = 0.0   # only used for 'linear'; orbit derives from GM
    along_track_axis: str = "x"      # 'x' (sar_satellite_sim) | 'y' (sar_ati_dcpa / vehicle)

    # ------ derived (all closed-form; see geometry/orbit.py for arrays) ------
    @property
    def orbit_radius_m(self) -> float:
        return self.earth_radius_m + self.altitude_m

    @property
    def orbital_velocity_mps(self) -> float:
        """Circular orbital speed sqrt(GM/R) (~7697 m/s at 350 km)."""
        return math.sqrt(k.GM_EARTH / self.orbit_radius_m)

    @property
    def incidence_angle_rad(self) -> float:
        """sin(theta_inc) = (R_sat/Re) sin(theta_look) (sar_satellite_sim.py:50)."""
        if self.platform == "linear":
            return math.radians(self.look_angle_deg)
        return math.asin(
            (self.orbit_radius_m / self.earth_radius_m)
            * math.sin(math.radians(self.look_angle_deg))
        )

    @property
    def earth_angle_rad(self) -> float:
        """Earth central angle gamma = theta_inc - theta_look (sar_satellite_sim.py:54)."""
        if self.platform == "linear":
            return 0.0
        return self.incidence_angle_rad - math.radians(self.look_angle_deg)

    @property
    def slant_range_m(self) -> float:
        """Slant range to scene center.

        Orbit: law of cosines on Earth-center/target/sat triangle
        (sar_satellite_sim.py:59). Linear: h / cos(look) (sar_vehicle_sim.py:37).
        """
        if self.platform == "linear":
            return self.altitude_m / math.cos(math.radians(self.look_angle_deg))
        re, rs, g = self.earth_radius_m, self.orbit_radius_m, self.earth_angle_rad
        return math.sqrt(re * re + rs * rs - 2.0 * re * rs * math.cos(g))

    @property
    def speed_mps(self) -> float:
        if self.platform == "linear":
            return self.platform_velocity_mps
        return self.orbital_velocity_mps

    @property
    def effective_velocity_mps(self) -> float:
        """Curved-earth focusing velocity V_eff = V_sat*sqrt(Re/R_sat)
        (sar_satellite_sim.py:182); equals platform speed for a linear track."""
        if self.platform == "linear":
            return self.platform_velocity_mps
        return self.orbital_velocity_mps * math.sqrt(
            self.earth_radius_m / self.orbit_radius_m
        )


@dataclass(frozen=True)
class CollectConfig:
    """Slow-time / fast-time sampling of one collect."""

    integration_time_s: float = 1.2       # (sar_satellite_sim.py:82)
    window_length_s: float = 22e-6        # receive window (sar_satellite_sim.py:248)
    window_start_mode: str = "reference"  # 'reference': 2R0/c - Tp/2 - 1us
                                          # 'centered':  2R0/c - win/2 (sar_batch_sim.py:89)
    even_pulses: bool = True              # round pulse count up to even (FFT-friendly)
    echo_backend: str = "jnp"             # 'jnp' | 'pallas' | 'freq' (ops/echo.py)
    # 'freq' backend spreading oversample. 2 is golden-grade with the
    # exact-edge split (acceptance budgets hold at mid/full scale —
    # ops/echo_freq.py accuracy class) AND keeps the conv FFT length inside
    # the fused kernel's 65,536 ceiling; 4 (the round-1 approximate-mode
    # margin) doubles the grid and forces the XLA-FFT fallback — the
    # measured 1.22 -> 0.73 s/channel full-ATI gap (ROUND4_NOTES).
    echo_oversample: int = 2

    def num_pulses(self, prf_hz: float) -> int:
        n = int(math.ceil(self.integration_time_s * prf_hz))
        if self.even_pulses and n % 2 != 0:
            n += 1
        return n

    def num_samples(self, fs_hz: float, even: bool = False) -> int:
        if self.window_start_mode == "reference":
            # the reference truncates here (int(22e-6*fs),
            # sar_satellite_sim.py:248)
            n = int(self.window_length_s * fs_hz)
        else:
            # ...but ceils for the spotlight window (sar_batch_sim.py:86)
            n = int(math.ceil(self.window_length_s * fs_hz))
        if even and n % 2 != 0:
            n += 1
        return n


@dataclass(frozen=True)
class ChannelConfig:
    """Multichannel receiver layout (along-track phase centers).

    ``dpca_baseline(prf)`` gives the classic one-PRI two-way coincidence
    separation d = 2 V / PRF (sar_ati_dcpa_sim_csa.py:42)."""

    num_channels: int = 1
    baseline_m: float = 0.0   # total along-track Rx separation for 2-channel ATI/DPCA

    def rx_offsets(self) -> tuple:
        """Along-track offsets of each Rx phase center from the Tx [m]."""
        if self.num_channels == 1:
            return (0.0,)
        if self.num_channels == 2:
            return (-self.baseline_m / 2.0, self.baseline_m / 2.0)
        # uniform array centered on Tx
        n = self.num_channels
        return tuple((i - (n - 1) / 2.0) * self.baseline_m / (n - 1) for i in range(n))

    @staticmethod
    def dpca_baseline(v_platform: float, prf_hz: float) -> float:
        return 2.0 * v_platform / prf_hz


@dataclass(frozen=True)
class NoiseConfig:
    """Radar-equation SNR + K-distributed sea clutter (sar_satellite_sim.py:307-344)."""

    tx_power_w: float = 1000.0
    antenna_length_m: float = 3.5
    antenna_width_m: float = 0.5
    aperture_efficiency: float = 0.6
    system_temp_k: float = 290.0
    noise_figure_db: float = 5.0
    loss_db: float = 3.0
    scr_db: float = 10.0        # signal-to-clutter ratio
    k_shape: float = 1.0        # K-distribution shape nu
    snr_boost_db: float = 0.0   # extra SNR applied on top (sar_batch_sim.py:49 uses 26)


@dataclass(frozen=True)
class ProcessingConfig:
    """Image formation options."""

    algorithm: str = "csa"        # 'csa' | 'rda' | 'bp'
    azimuth_window: str = "hamming"   # RDA azimuth taper (reference behavior)
    range_window: str = "hamming"     # RDA matched-filter taper
    rcmc_mode: str = "exact"      # RDA RCMC: 'exact'|'fast'|'phase'|'czt'
                                  # ('phase' = gather-free TPU mode, ~11x
                                  # faster at 4k²; see ops/rda.py)
    bp_grid: int = 512            # BP pixels per side (sar_batch_sim.py:173)
    bp_scene_size_m: float = 500.0
    bp_presum: int = 0            # azimuth presum: 0 = auto (ops/bp.py::
                                  # presum_factor), 1 = off, N = explicit
    out_size: int = 0             # 0 = native size; else pad/crop for formation
    csa_fused: bool = True        # grid-free fused phases (ops/csa.py)
    # 'auto' (MXU matmul FFT on TPU — at the full-scale reference aperture
    # the non-pow2 XLA TPU FFT is ~15x slower — stock jnp.fft elsewhere) |
    # 'xla' | 'hybrid' | 'mxu' (ops/fft.py) | 'pallas' (VMEM megakernel)
    fft_impl: str = "auto"


@dataclass(frozen=True)
class VideoConfig:
    """VideoSAR frame scheduling (sar_batch_sim.py:244-252)."""

    duration_s: float = 5.0
    fps: float = 10.0
    cpi_s: float = 0.5

    def num_frames(self) -> int:
        return int(self.duration_s * self.fps)

    def step_pulses(self, prf_hz: float) -> int:
        return int(prf_hz / self.fps)

    def cpi_pulses(self, prf_hz: float) -> int:
        return int(math.ceil(self.cpi_s * prf_hz))

    def total_pulses(self, prf_hz: float) -> int:
        return int(math.ceil(self.duration_s * prf_hz))


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. Axes: 'data' shards independent frames/scenarios,
    'chan' shards receive channels, 'seq' shards the slow-time(pulse)/range
    axes with corner turns between domains (the SAR sequence-parallel axis)."""

    data: int = 1
    chan: int = 1
    seq: int = 1

    @property
    def axis_names(self) -> tuple:
        return ("data", "chan", "seq")

    @property
    def shape(self) -> tuple:
        return (self.data, self.chan, self.seq)


@dataclass(frozen=True)
class ScenarioConfig:
    """Full scenario = radar + geometry + collect + channels + noise + processing."""

    name: str = "scenario"
    radar: RadarConfig = RadarConfig()
    geometry: GeometryConfig = GeometryConfig()
    collect: CollectConfig = CollectConfig()
    channels: ChannelConfig = ChannelConfig()
    noise: NoiseConfig = NoiseConfig()
    processing: ProcessingConfig = ProcessingConfig()
    video: VideoConfig = VideoConfig()
    mesh: MeshConfig = MeshConfig()

    def replace(self, **kw) -> "ScenarioConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Named presets reproducing each reference script's exact constants
# --------------------------------------------------------------------------

def satellite_stripmap() -> ScenarioConfig:
    """sar_satellite_sim.py: 350 km orbit, X-band 500 MHz, PRF 6 kHz, RDA."""
    return ScenarioConfig(
        name="satellite_stripmap",
        radar=RadarConfig(fc_hz=9.65e9, bandwidth_hz=500e6, prf_hz=6000.0,
                          pulse_width_s=20e-6, fs_hz=600e6),
        geometry=GeometryConfig(platform="orbit", altitude_m=350e3,
                                look_angle_deg=45.0, along_track_axis="x"),
        collect=CollectConfig(integration_time_s=1.2, window_length_s=22e-6,
                              window_start_mode="reference", even_pulses=True),
        noise=NoiseConfig(tx_power_w=1000.0, antenna_length_m=3.5,
                          antenna_width_m=0.5, noise_figure_db=5.0),
        processing=ProcessingConfig(algorithm="rda"),
    )


def satellite_moving() -> ScenarioConfig:
    """sar_satellite_moving_sim.py: same radar, +Y along-track, moving targets."""
    cfg = satellite_stripmap()
    return cfg.replace(
        name="satellite_moving",
        geometry=dataclasses.replace(cfg.geometry, along_track_axis="y"),
        # the reference also rounds the pulse count up to even
        # (sar_satellite_moving_sim.py:70-71)
    )


def ati_dpca() -> ScenarioConfig:
    """sar_ati_dcpa_sim_csa.py: two-channel bistatic ATI/DPCA with CSA focusing."""
    geo = GeometryConfig(platform="orbit", altitude_m=350e3,
                         look_angle_deg=45.0, along_track_axis="y")
    radar = RadarConfig(fc_hz=9.65e9, bandwidth_hz=500e6, prf_hz=6000.0,
                        pulse_width_s=20e-6, fs_hz=600e6)
    baseline = ChannelConfig.dpca_baseline(geo.orbital_velocity_mps, radar.prf_hz)
    return ScenarioConfig(
        name="ati_dpca",
        radar=radar,
        geometry=geo,
        collect=CollectConfig(integration_time_s=1.2, window_length_s=22e-6,
                              window_start_mode="reference", even_pulses=False),
        channels=ChannelConfig(num_channels=2, baseline_m=baseline),
        processing=ProcessingConfig(algorithm="csa"),
    )


def airborne_vehicle() -> ScenarioConfig:
    """sar_vehicle_sim.py: 20 km airborne linear track, 10 GHz, 300 MHz, RDA."""
    return ScenarioConfig(
        name="airborne_vehicle",
        radar=RadarConfig(fc_hz=10e9, bandwidth_hz=300e6, prf_hz=2000.0,
                          pulse_width_s=1.0e-6, fs_hz=360e6),
        geometry=GeometryConfig(platform="linear", altitude_m=20000.0,
                                look_angle_deg=45.0,
                                earth_radius_m=k.RE_WGS84,
                                platform_velocity_mps=150.0,
                                along_track_axis="y"),
        collect=CollectConfig(integration_time_s=32768 / 2000.0,
                              window_length_s=2048 / 360e6,
                              window_start_mode="centered", even_pulses=False),
        noise=NoiseConfig(tx_power_w=2000.0, antenna_length_m=1.5,
                          antenna_width_m=0.3, noise_figure_db=4.0),
        processing=ProcessingConfig(algorithm="rda"),
    )


def videosar() -> ScenarioConfig:
    """sar_batch_sim.py: spotlight VideoSAR, PRF 5 kHz, 0.5 s CPI, 10 fps, BP."""
    return ScenarioConfig(
        name="videosar",
        radar=RadarConfig(fc_hz=9.65e9, bandwidth_hz=500e6, prf_hz=5000.0,
                          pulse_width_s=20e-6, fs_hz=600e6),
        geometry=GeometryConfig(platform="orbit", altitude_m=350e3,
                                look_angle_deg=45.0, along_track_axis="x"),
        collect=CollectConfig(
            integration_time_s=0.5,
            # win = 2000/c + Tp + 10us (sar_batch_sim.py:85)
            window_length_s=2000.0 / k.C + 20e-6 + 10e-6,
            window_start_mode="centered", even_pulses=False),
        noise=NoiseConfig(snr_boost_db=26.0),
        processing=ProcessingConfig(algorithm="bp", bp_grid=512,
                                    bp_scene_size_m=500.0),
        video=VideoConfig(duration_s=5.0, fps=10.0, cpi_s=0.5),
    )
