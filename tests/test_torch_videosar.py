"""The port's VideoSAR slice against the JAX package: ``videosar.run`` on
the reduced configurations of tests/test_models.py (every algorithm, the
streaming modes), the scheduler, pipeline, noise and CSA grid-phase path;
the slice's errors; the device default of the entry points; and a process
that imports every port module with JAX made unimportable."""

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
from nis_sar_amtigmti_video_tpu.models import videosar as jvs  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import csa as jcsa  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import noise as jnoise  # noqa: E402
from nis_sar_amtigmti_video_tpu.video import scheduler as jsched  # noqa
from nis_sar_amtigmti_video_tpu.scene import targets as jT  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch import config as tcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.models import gmti  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.models import videosar  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops import csa, noise  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    fft_kernel)
from nis_sar_amtigmti_video_tpu_torch.parallel import pipeline  # noqa
from nis_sar_amtigmti_video_tpu_torch.scene import targets as T  # noqa
from nis_sar_amtigmti_video_tpu_torch.video import scheduler  # noqa: E402

# one intra-op thread: the suite runs in several processes at once,
# and a torch OpenMP pool per process oversubscribes the cores
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "nis_sar_amtigmti_video_tpu_torch"
MOVER = dict(heading_deg=90.0, speed_mps=30.0, frames_per_batch=2)


def _reduced(cfg, window=512, grid=48):
    """tests/test_models.py::TestVideoSar._reduced (window 512, grid 48) and
    its streaming twin (window 9000, grid 32: nfft 16,384)."""
    sc = cfg.videosar()
    return sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                  pulse_width_s=2e-6, fs_hz=150e6,
                                  prf_hz=1000.0),
        collect=dataclasses.replace(sc.collect,
                                    window_length_s=window / 150e6),
        processing=dataclasses.replace(sc.processing, bp_grid=grid,
                                       bp_scene_size_m=400.0),
        video=cfg.VideoConfig(duration_s=1.0, fps=5.0, cpi_s=0.4))


def _stream(cfg):
    return _reduced(cfg, 9000, 32)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


RUNS = {"mbp": dict(algorithm="mbp", bp_backend="fast"),
        "stdbp": dict(algorithm="stdbp", bp_backend="fast"),
        "fast_factor": dict(algorithm="mbp", bp_backend="fast_factor"),
        "exact": dict(algorithm="mbp", bp_backend="exact"),
        "csa": dict(algorithm="csa")}


@pytest.fixture(scope="module")
def reference_runs():
    pt = jT.point_target((0.0, 0.0, 0.0), 50.0)
    return {k: jvs.run(_reduced(jcfg), pt, **MOVER, **kw).images
            for k, kw in RUNS.items()}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_matches_reference(reference_runs, name):
    got = videosar.run(_reduced(tcfg), T.point_target((0.0, 0.0, 0.0), 50.0),
                       device="cpu", **MOVER, **RUNS[name])
    want = reference_runs[name]
    assert got.images.shape == want.shape and got.images.shape[0] >= 3
    assert got.images.dtype == np.complex64
    assert _rel(got.images, want) < 2e-3
    assert got.scene_size_m == 400.0


@pytest.fixture(scope="module")
def stream_reference():
    return jvs.run(_stream(jcfg), jT.point_target((0.0, 0.0, 0.0), 50.0),
                   algorithm="mbp", bp_backend="fast_factor",
                   noise_mode="per_segment", **MOVER).images


@pytest.mark.parametrize("stream", [False, True, "ring"])
def test_stream_modes_match_reference(stream_reference, stream):
    """Per-frame recentre (the fused kernel's plain version), the cached-
    spectra concat and the ring, against the reference's per-frame path."""
    launches = (fft_kernel.forward_spectra.launches,
                fft_kernel.recentre_from_spectra.launches,
                fft_kernel.recenter_presum.launches)
    got = videosar.run(_stream(tcfg), T.point_target((0.0, 0.0, 0.0), 50.0),
                       algorithm="mbp", bp_backend="fast_factor",
                       noise_mode="per_segment", stream_spectra=stream,
                       device="cpu", **MOVER)
    assert got.images.shape == stream_reference.shape
    assert _rel(got.images, stream_reference) < 2e-3
    assert (fft_kernel.forward_spectra.launches,
            fft_kernel.recentre_from_spectra.launches,
            fft_kernel.recenter_presum.launches) == launches   # CPU: plain


def test_ring_with_noise_equals_concat():
    kw = dict(algorithm="mbp", bp_backend="fast_factor", seed=3,
              noise_mode="per_segment", device="cpu", **MOVER)
    pt = T.point_target((0.0, 0.0, 0.0), 50.0)
    concat = videosar.run(_stream(tcfg), pt, stream_spectra=True, **kw)
    ring = videosar.run(_stream(tcfg), pt, stream_spectra="ring", **kw)
    clean = videosar.run(_stream(tcfg), pt, stream_spectra=True,
                         **{**kw, "seed": None})
    np.testing.assert_allclose(ring.images, concat.images, rtol=0,
                               atol=1e-6 * np.abs(concat.images).max())
    assert np.abs(concat.images - clean.images).max() > 0   # noise is on


def test_frame_subset_draws_the_same_noise():
    kw = dict(algorithm="mbp", bp_backend="fast", seed=5, device="cpu",
              **MOVER)
    pt = T.point_target((0.0, 0.0, 0.0), 50.0)
    full = videosar.run(_reduced(tcfg), pt, **kw)
    sub = videosar.run(_reduced(tcfg), pt, frame_indices=[2, 0], **kw)
    np.testing.assert_array_equal(sub.images[1], full.images[2])
    np.testing.assert_array_equal(sub.images[0], full.images[0])


def _raises(exc, match, **kw):
    with pytest.raises(exc, match=match):
        videosar.run(kw.pop("sc", _reduced(tcfg)),
                     T.point_target((0.0, 0.0, 0.0), 50.0),
                     device="cpu", **kw)


ERRORS = {
    "noise_mode": (ValueError, "unknown noise_mode", dict(noise_mode="x")),
    "backend": (ValueError, "unknown BP backend", dict(bp_backend="x")),
    "algorithm": (ValueError, "unknown algorithm", dict(algorithm="x")),
    "stream_algorithm": (ValueError, "fast-BP backend",
                         dict(algorithm="csa", stream_spectra=True)),
    "stream_exact": (ValueError, "fast-BP backend",
                     dict(bp_backend="exact", stream_spectra=True)),
    "stream_noise": (ValueError, "per.segment",
                     dict(bp_backend="fast_factor", seed=0,
                          stream_spectra=True)),
    "stream_nfft": (ValueError, "supported range",
                    dict(bp_backend="fast_factor", stream_spectra=True)),
    "stream_value": (ValueError, "unknown stream_spectra",
                     dict(sc=_stream(tcfg), bp_backend="fast_factor",
                          stream_spectra="x")),
    "ring_gaps": (ValueError, "contiguous",
                  dict(sc=_stream(tcfg), bp_backend="fast_factor",
                       stream_spectra="ring", frame_indices=[0, 2])),
    "ring_presum": (ValueError, "step % presum",
                    dict(sc=_stream(tcfg).replace(
                        processing=dataclasses.replace(
                            _stream(tcfg).processing, bp_presum=3)),
                        bp_backend="fast_factor", stream_spectra="ring")),
    "segments": (ValueError, "segment-aligned",
                 dict(sc=_stream(tcfg), bp_backend="fast_factor",
                      stream_spectra=True, num_frames=1)),
    # the grid-phase CSA has no kernel route: 'pallas' raises, as the
    # reference's get_impl does (the fused form runs the CSA kernels)
    "csa_pallas": (ValueError, "unknown fft impl 'pallas'",
                   dict(algorithm="csa", sc=_reduced(tcfg).replace(
                       processing=dataclasses.replace(
                           _reduced(tcfg).processing, fft_impl="pallas",
                           csa_fused=False)))),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_run_errors(name):
    exc, match, kw = ERRORS[name]
    _raises(exc, match, **dict(kw))


def test_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default runs on it")
    pt = T.point_target((0.0, 0.0, 0.0), 50.0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        videosar.run(_reduced(tcfg), pt)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gmti.run(tcfg.ati_dpca(), pt, (0.0, 0.0, 0.0))


# --------------------------------------------------------------------------
# scheduler, pipeline, noise, CSA grid phases
# --------------------------------------------------------------------------

def test_schedule_matches_reference():
    for v in (tcfg.VideoConfig(), tcfg.VideoConfig(1.0, 5.0, 0.4)):
        got = scheduler.make_schedule(v, 5000.0)
        want = jsched.make_schedule(jcfg.VideoConfig(*dataclasses.astuple(v)),
                                    5000.0)
        np.testing.assert_array_equal(got.starts, want.starts)
        assert got[1:] == want[1:] and got.num_frames == want.num_frames
    sched = scheduler.make_schedule(tcfg.VideoConfig(1.0, 5.0, 0.4), 100.0)
    stream = torch.arange(sched.total_pulses * 2).reshape(-1, 2)
    want = jsched.gather_frames(jnp.asarray(stream.numpy()), sched)
    np.testing.assert_array_equal(scheduler.gather_frames(stream, sched),
                                  np.asarray(want))
    a = np.arange(sched.total_pulses, dtype=np.float64)
    np.testing.assert_array_equal(scheduler.frame_slices_host([a], sched)[0],
                                  jsched.frame_slices_host([a], sched)[0])


def test_pipeline_keeps_order_and_depth():
    events = []

    def dispatch(x):
        events.append(("d", x))
        return x

    def fetch(h):
        events.append(("f", h))
        return 10 * h

    assert list(pipeline.pipelined(dispatch, range(4), depth=2,
                                   fetch=fetch)) == [0, 10, 20, 30]
    assert events[:4] == [("d", 0), ("d", 1), ("d", 2), ("f", 0)]
    with pytest.raises(ValueError):
        list(pipeline.pipelined(dispatch, range(2), depth=0))


def test_snr_db_equals_reference():
    for cfg_name in ("videosar", "ati_dpca", "satellite_stripmap"):
        sc_t, sc_j = getattr(tcfg, cfg_name)(), getattr(jcfg, cfg_name)()
        r, g = sc_t.radar, sc_t.geometry
        for t_int in (None, 0.5):
            assert noise.snr_db(sc_t.noise, g.slant_range_m, 5000.0,
                                r.wavelength_m, r.bandwidth_hz, t_int) == \
                jnoise.snr_db(sc_j.noise, g.slant_range_m, 5000.0,
                              r.wavelength_m, r.bandwidth_hz, t_int)


def test_noise_powers_and_seeds():
    n = 200_000
    th = noise.sample_thermal(noise.generator(1), (n,), 4.0)
    assert abs(float((th.abs() ** 2).mean()) / 4.0 - 1) < 0.05
    assert th.dtype == torch.complex64
    for nu in (1.0, 3.0):
        kc = noise.sample_k_clutter(noise.generator(2), (n,), 2.0, nu)
        want = jnoise.sample_k_clutter(jax.random.PRNGKey(2), (n,), 2.0, nu)
        pk, pw = float((kc.abs() ** 2).mean()), float(
            jnp.mean(jnp.abs(want) ** 2))
        assert abs(pk / 2.0 - 1) < 0.05 and abs(pk / pw - 1) < 0.05
        # K-distribution: intensity second moment 2 (1 + 1/nu) P^2
        m2 = float((kc.abs() ** 4).mean()) / 4.0
        assert abs(m2 / (2 * (1 + 1 / nu)) - 1) < 0.1
    raw = torch.ones((64, 256), dtype=torch.complex64)
    a = noise.add_ocean_noise(noise.generator(7, 3), raw, 10.0,
                              ref_power_mode="peak")
    b = noise.add_ocean_noise(noise.generator(7, 3), raw, 10.0,
                              ref_power_mode="peak")
    c = noise.add_ocean_noise(noise.generator(7, 4), raw, 10.0,
                              ref_power_mode="peak")
    assert torch.equal(a, b) and not torch.equal(a, c)
    # thermal at -10 dB plus clutter at -10 dB of the unit signal
    assert abs(float(((a - raw).abs() ** 2).mean()) / 0.2 - 1) < 0.05


def test_csa_grid_phase_path_matches_reference():
    p_kw = dict(wavelength_m=0.031, chirp_rate=6e13, fs_hz=150e6,
                prf_hz=1000.0, velocity_mps=7000.0, range_ref_m=5e5,
                t_start_fast=2 * 5e5 / 299792458.0 - 3e-6, num_pulses=64,
                num_samples=128)
    rng = np.random.default_rng(9)
    raw = (rng.standard_normal((64, 128))
           + 1j * rng.standard_normal((64, 128))).astype(np.complex64)
    want = np.asarray(jcsa.focus_csa(jnp.asarray(raw),
                                     jcsa.CsaParams(**p_kw)))
    got = csa.focus_csa(torch.from_numpy(raw), csa.CsaParams(**p_kw))
    assert _rel(got.numpy(), want) < 1e-4
    fused = csa.apply_csa_fused(torch.from_numpy(raw),
                                csa.csa_factors(csa.CsaParams(**p_kw)))
    assert _rel(got.numpy(), fused.numpy()) < 1e-3
    ph = csa.csa_phases(csa.CsaParams(**p_kw))
    jph = jcsa.csa_phases(jcsa.CsaParams(**p_kw))
    for a, b in zip(ph, jph):
        assert _rel(a.numpy(), np.asarray(b)) < 1e-5


# --------------------------------------------------------------------------
# the port imports no JAX
# --------------------------------------------------------------------------

def test_every_port_module_imports_without_jax():
    mods = sorted(
        ".".join(f.relative_to(REPO).with_suffix("").parts)
        for f in PORT.rglob("*.py") if f.name != "__init__.py")
    assert {"nis_sar_amtigmti_video_tpu_torch.models.videosar",
            "nis_sar_amtigmti_video_tpu_torch.ops.cuda.csa_kernel",
            "nis_sar_amtigmti_video_tpu_torch.ops.cuda.gmti_kernel",
            "nis_sar_amtigmti_video_tpu_torch.gmti.fused"} <= set(mods)
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['nis_sar_amtigmti_video_tpu'] = None\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
