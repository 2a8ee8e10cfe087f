"""The PyTorch port's slice end to end against the JAX reference: the copied
NumPy modules, the direct echo engine, ``focus_and_products`` on both paths
and ``run``; plus the port's own contracts (no JAX import, shape gate, CPU
runs launch no kernel)."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nis_sar_amtigmti_video_tpu import config as jcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu.geometry import orbit as jorbit  # noqa
from nis_sar_amtigmti_video_tpu.models import gmti as jgmti  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import echo as jecho  # noqa: E402
from nis_sar_amtigmti_video_tpu.scene import clutter as jclutter  # noqa
from nis_sar_amtigmti_video_tpu.scene import targets as jtargets  # noqa
from nis_sar_amtigmti_video_tpu_torch import config as tcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.geometry import orbit  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.models import gmti  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops import echo  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    csa_kernel, gmti_kernel)
from nis_sar_amtigmti_video_tpu_torch.scene import clutter, targets  # noqa

# one intra-op thread: the suite runs in several processes at once,
# and a torch OpenMP pool per process oversubscribes the cores
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "nis_sar_amtigmti_video_tpu_torch"
PRESETS = ["satellite_stripmap", "satellite_moving", "ati_dpca",
           "airborne_vehicle", "videosar"]
C = 299792458.0


def _small(cfg_mod, n_pulses, n_samples):
    """The slice scenario at a test size: ati_dpca with the CLI's --small
    waveform rule (BW 120 MHz, Tp 2 us, fs 150 MHz)."""
    sc = cfg_mod.ati_dpca()
    return sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                  pulse_width_s=2e-6, fs_hz=150e6),
        collect=dataclasses.replace(sc.collect,
                                    integration_time_s=n_pulses / 6000.0,
                                    window_length_s=n_samples / 150e6))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _launches():
    return (gmti_kernel.k1_gmti_planes.launches,
            csa_kernel.k2_pair_call.launches,
            gmti_kernel.k3_gmti_planes.launches,
            gmti_kernel.k4_epilogue_planes.launches)


# --------------------------------------------------------------------------
# the copied NumPy-only modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_config_presets_match_reference(preset):
    got, want = getattr(tcfg, preset)(), getattr(jcfg, preset)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for attr in ("wavelength_m", "chirp_rate"):
        assert getattr(got.radar, attr) == getattr(want.radar, attr)
    for attr in ("slant_range_m", "speed_mps", "effective_velocity_mps",
                 "incidence_angle_rad"):
        assert getattr(got.geometry, attr) == getattr(want.geometry, attr)
    r = want.radar
    assert got.collect.num_pulses(r.prf_hz) == want.collect.num_pulses(
        r.prf_hz)
    assert got.collect.num_samples(r.fs_hz) == want.collect.num_samples(
        r.fs_hz)
    assert got.channels.rx_offsets() == want.channels.rx_offsets()


@pytest.mark.parametrize("preset", ["satellite_stripmap", "ati_dpca",
                                    "airborne_vehicle"])
def test_trajectory_matches_reference(preset):
    got_g, want_g = getattr(tcfg, preset)().geometry, \
        getattr(jcfg, preset)().geometry
    t = orbit.slow_time_grid(0.5, 33)
    np.testing.assert_array_equal(t, jorbit.slow_time_grid(0.5, 33))
    for a, b in zip(orbit.make_trajectory(got_g, t),
                    jorbit.make_trajectory(want_g, t)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(jtargets.VEHICLES))
def test_targets_match_reference(name):
    got = targets.VEHICLES[name]((3.0, -2.0, 0.0)).rotate_z(30.0)
    want = jtargets.VEHICLES[name]((3.0, -2.0, 0.0)).rotate_z(30.0)
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.rcs, want.rcs)
    assert got.names == want.names


def test_clutter_and_point_target_match_reference():
    got = clutter.ocean_clutter_field(np.random.default_rng(7), 64)
    want = jclutter.ocean_clutter_field(np.random.default_rng(7), 64)
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.rcs, want.rcs)
    p = targets.point_target((1.0, 2.0, 0.0), 4.0)
    q = jtargets.point_target((1.0, 2.0, 0.0), 4.0)
    np.testing.assert_array_equal(p.positions, q.positions)
    assert p.total_rcs == q.total_rcs


# --------------------------------------------------------------------------
# echo engine
# --------------------------------------------------------------------------

def _scene():
    ship = targets.destroyer()
    clut = clutter.ocean_clutter_field(np.random.default_rng(3),
                                       num_points=50, half_width_m=600.0)
    return ship, clut


def test_two_channel_echo_matches_reference():
    """Moving destroyer + 50 stationary clutter points, both channels."""
    ship, clut = _scene()
    vel = (15.0, 0.0, 0.0)
    raw, traj, t0 = gmti.simulate_two_channel(_small(tcfg, 129, 256), ship,
                                              vel, clut, device="cpu")
    want, jtraj, jt0 = jgmti.simulate_two_channel(_small(jcfg, 129, 256),
                                                  ship, vel, clut)
    want = np.asarray(want)
    assert t0 == jt0 and raw.shape == want.shape == (2, 129, 256)
    assert raw.dtype == torch.complex64
    np.testing.assert_array_equal(traj.positions, jtraj.positions)
    assert np.abs(_np(raw) - want).max() < 1e-4 * np.abs(want).max()


_OPTION_SETS = {
    "centered_uniform": dict(chirp_centering="centered",
                             endpoint_grid=False),
    "rcs_amplitude": dict(amplitude="rcs"),
    "stop_and_go": dict(stop_and_go=True),
    "antenna": dict(antenna_length_m=3.5),
}


@pytest.mark.parametrize("opt", sorted(_OPTION_SETS))
def test_echo_options_match_reference(opt):
    sc = _small(jcfg, 48, 256)
    g, r = sc.geometry, sc.radar
    kw = dict(fc_hz=r.fc_hz, chirp_rate=r.chirp_rate,
              pulse_width_s=r.pulse_width_s, fs_hz=r.fs_hz, num_samples=256,
              **_OPTION_SETS[opt])
    traj = jorbit.make_trajectory(g, jorbit.slow_time_grid(0.008, 48))
    ship, _ = _scene()
    t0 = jecho.window_start_time(g.slant_range_m, jecho.EchoOpts(**kw),
                                 256 / 150e6, "reference")
    args = dict(t_start=t0, target_velocity=(4.0, -3.0, 0.0),
                rx_offset=1.7)
    want = np.asarray(jecho.phase_history(traj, ship, jecho.EchoOpts(**kw),
                                          **args))
    got = _np(echo.phase_history(traj, ship, echo.EchoOpts(**kw), **args,
                                 device="cpu"))
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


def test_echo_chunk_plan_invariance():
    sc = _small(tcfg, 40, 256)
    traj = orbit.make_trajectory(sc.geometry,
                                 orbit.slow_time_grid(40 / 6000.0, 40))
    ship, clut = _scene()
    scene = targets.PointTargets.concatenate([ship, clut])
    base = dict(fc_hz=sc.radar.fc_hz, chirp_rate=sc.radar.chirp_rate,
                pulse_width_s=sc.radar.pulse_width_s, fs_hz=sc.radar.fs_hz,
                num_samples=256)
    t0 = echo.window_start_time(sc.geometry.slant_range_m,
                                echo.EchoOpts(**base), 0.0, "reference")
    a = _np(echo.phase_history(traj, scene, echo.EchoOpts(**base),
                               t_start=t0, device="cpu"))
    b = _np(echo.phase_history(traj, scene, echo.EchoOpts(
        **base, max_elements=256 * 8, target_chunk=7), t_start=t0,
        device="cpu"))
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-4 * np.abs(a).max())


def test_echo_empty_scene_and_grids():
    opts = echo.EchoOpts(fc_hz=9.65e9, chirp_rate=6e13, pulse_width_s=2e-6,
                         fs_hz=150e6, num_samples=64)
    jopts = jecho.EchoOpts(fc_hz=9.65e9, chirp_rate=6e13, pulse_width_s=2e-6,
                           fs_hz=150e6, num_samples=64)
    traj = orbit.make_trajectory(tcfg.ati_dpca().geometry,
                                 orbit.slow_time_grid(0.001, 4))
    empty = targets.PointTargets(np.zeros((0, 3)), np.zeros(0), ())
    out = echo.phase_history(traj, empty, opts, t_start=0.0, device="cpu")
    assert out.shape == (4, 64) and not out.abs().any()
    for endpoint in (True, False):
        np.testing.assert_array_equal(
            echo.fast_time_grid(dataclasses.replace(
                opts, endpoint_grid=endpoint)),
            jecho.fast_time_grid(dataclasses.replace(
                jopts, endpoint_grid=endpoint)))
    for mode in ("reference", "centered"):
        assert echo.window_start_time(5e5, opts, 2e-5, mode) == \
            jecho.window_start_time(5e5, jopts, 2e-5, mode)
    with pytest.raises(ValueError, match="window mode"):
        echo.window_start_time(5e5, opts, 2e-5, "nope")


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret", "freq"])
def test_scalar_field_echo_backends(backend):
    """The scalar-field echo backends through simulate_two_channel on the
    CPU: 'pallas' runs the direct-echo kernel's plain version and matches
    the direct engine; 'pallas_interpret' raises (no kernel interpreter);
    'freq' refuses the slice's endpoint fast-time grid, as the reference
    does."""
    sc = _small(tcfg, 8, 256)
    sc_b = sc.replace(collect=dataclasses.replace(sc.collect,
                                                  echo_backend=backend))
    ship, _ = _scene()
    if backend == "pallas":
        got = gmti.simulate_two_channel(sc_b, ship, (3.0, 0.0, 0.0),
                                        device="cpu")[0]
        want = gmti.simulate_two_channel(sc, ship, (3.0, 0.0, 0.0),
                                         device="cpu")[0]
        assert got.shape == want.shape == (2, 8, 256)
        assert float(want.abs().max()) > 0
        assert float((got - want).abs().max()) \
            < 2e-4 * float(want.abs().max())
        return
    err = NotImplementedError if backend == "pallas_interpret" else ValueError
    with pytest.raises(err, match="interpret|uniform fast-time"):
        gmti.simulate_two_channel(sc_b, ship, (0.0, 0.0, 0.0), device="cpu")


# --------------------------------------------------------------------------
# focus_and_products and run
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def random_raw():
    """Seeded (2, 257, 256) raw pair (256 x 256 after the DPCA shift) and
    the reference's composed and kernel-fused (interpret) products."""
    sc = _small(jcfg, 257, 256)
    rng = np.random.default_rng(11)
    raw = (rng.standard_normal((2, 257, 256))
           + 1j * rng.standard_normal((2, 257, 256))).astype(np.complex64)
    t0 = 2.0 * sc.geometry.slant_range_m / C - 2e-6
    want = {path: jgmti.focus_and_products(jnp.asarray(raw), sc, t0,
                                           path=path, interpret=True)
            for path in ("composed", "kernel_fused")}
    return raw, t0, want


def _assert_products_close(got, want):
    """The bounds the reference holds its kernel path to against its
    composed path (tests/test_gmti.py::TestModelKernelPath)."""
    s = np.abs(np.asarray(want.slc1)).max()
    assert np.abs(_np(got.slc1) - np.asarray(want.slc1)).max() / s < 2e-3
    assert np.abs(_np(got.slc2) - np.asarray(want.slc2)).max() / s < 2e-3
    assert np.abs(_np(got.dpca_mag)
                  - np.asarray(want.dpca_mag)).max() / s < 2e-3
    assert abs(float(got.cal_phase) - float(want.cal_phase)) < 1e-3
    m = np.abs(np.asarray(want.ati_phase)) > 1e-6
    d = np.abs(_np(got.ati_phase) - np.asarray(want.ati_phase))
    assert np.median(d[m]) < 5e-3
    assert (abs(float(got.cancellation_ratio)
                - float(want.cancellation_ratio))
            / float(want.cancellation_ratio) < 5e-3)
    np.testing.assert_array_equal(got.range_axis, want.range_axis)
    np.testing.assert_array_equal(got.cross_range, want.cross_range)
    assert got.v_amb == want.v_amb


@pytest.mark.parametrize("path", ["composed", "kernel_fused"])
def test_focus_and_products_match_reference(random_raw, path):
    raw, t0, want = random_raw
    got = gmti.focus_and_products(torch.from_numpy(raw), _small(tcfg, 257,
                                                                256),
                                  t0, path=path)
    _assert_products_close(got, want[path])
    snr_w = np.asarray(want[path].detections.snr)
    np.testing.assert_allclose(_np(got.detections.snr), snr_w, rtol=5e-3,
                               atol=5e-3)


@pytest.fixture(scope="module")
def run_reference():
    ship, clut = _scene()
    sc = _small(jcfg, 257, 256)
    return jgmti.run(sc, ship, (15.0, 0.0, 0.0), clut)


@pytest.mark.parametrize("path", ["composed", "kernel_fused", "auto"])
def test_run_matches_reference(run_reference, path):
    """Scene -> echo -> CPI products, end to end, against the reference's
    run (its default path on this host is the composed one)."""
    ship, clut = _scene()
    before = _launches()
    got = gmti.run(_small(tcfg, 257, 256), ship, (15.0, 0.0, 0.0), clut,
                   path=path, device="cpu")
    assert _launches() == before == (0, 0, 0, 0)   # CPU: plain versions
    _assert_products_close(got, run_reference)
    assert got.slc1.shape == (256, 256) and got.slc1.dtype == torch.complex64
    for plane in (got.ati_phase, got.dpca_mag, got.velocity_map,
                  got.detections.snr):
        assert torch.isfinite(plane).all()


def test_auto_path_on_cpu_is_composed(random_raw):
    """'auto' takes the kernel path only for CUDA data, even when the
    config opts into the kernel numeric class."""
    raw, t0, _ = random_raw
    sc = _small(tcfg, 257, 256)
    sc = sc.replace(processing=dataclasses.replace(sc.processing,
                                                   fft_impl="pallas"))
    a = gmti.focus_and_products(torch.from_numpy(raw), sc, t0, path="auto")
    b = gmti.focus_and_products(torch.from_numpy(raw), sc, t0,
                                path="composed")
    torch.testing.assert_close(a.slc1, b.slc1, rtol=0, atol=0)
    torch.testing.assert_close(a.ati_phase, b.ati_phase, rtol=0, atol=0)


def test_kernel_path_rejects_bad_shape():
    sc = _small(tcfg, 257, 256)
    raw = torch.zeros((2, 193, 256), dtype=torch.complex64)  # 192 not 2^k
    with pytest.raises(ValueError, match="kernel_fused"):
        gmti.focus_and_products(raw, sc, 1e-3, path="kernel_fused")
    with pytest.raises(ValueError, match="unknown GMTI path"):
        gmti.focus_and_products(raw, sc, 1e-3, path="nope")


# --------------------------------------------------------------------------
# the port imports no JAX
# --------------------------------------------------------------------------

def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib",
                               "nis_sar_amtigmti_video_tpu"), \
                f"{f.relative_to(REPO)} imports {mod}"


def test_port_import_loads_no_jax():
    code = ("import sys\n"
            "import nis_sar_amtigmti_video_tpu_torch.models.gmti\n"
            "import nis_sar_amtigmti_video_tpu_torch.utils.profiling\n"
            "import chip_smoke\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
