"""HRWS reconstruction of the PyTorch port (``models/hrws.py``) against the
JAX reference on the same inputs, on the CPU: ``tests/test_hrws.py``'s
unsharded scenes (the out-of-band tone, ghost suppression, four channels,
the DPCA condition), the steering matrix, the band layout, the condition
numbers and the PRF helpers; the same scenes against the benchmark's plain
float64 reference (``bench_torch/reference/hrws.py``); and a small
``collect_reconstruct_focus`` end to end, whose CSA kernel route
(``fft_impl='pallas'``: the kernels' plain versions here) equals the
grid-phase ``focus_csa`` route, with its stage record."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bench_torch.reference import hrws as ref_hrws  # noqa: E402
from nis_sar_amtigmti_video_tpu import config as jcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu.geometry import orbit as jorbit  # noqa: E402
from nis_sar_amtigmti_video_tpu.models import hrws as jhrws  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import csa as jcsa  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import echo as jecho  # noqa: E402
from nis_sar_amtigmti_video_tpu.scene import targets as jtargets  # noqa: E402
from nis_sar_amtigmti_video_tpu.utils import cplx  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch import config as tcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.geometry import orbit  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.models import hrws  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops import csa  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops import echo  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.scene import targets  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.utils import profiling  # noqa: E402

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

V = 7000.0


def params(k, prf, spacing, m=0):
    """Matching (JAX, port) HrwsParams."""
    return (jhrws.HrwsParams(num_channels=k, spacing_m=spacing, prf_hz=prf,
                             velocity_mps=V, num_bands=m),
            hrws.HrwsParams(num_channels=k, spacing_m=spacing, prf_hz=prf,
                            velocity_mps=V, num_bands=m))


def synth_multichannel(p, n_az: int, n_rg: int, doppler_tones):
    """tests/test_hrws.py's signal: Doppler tones beyond the base Nyquist,
    each channel delayed by x_k / (2 V); (K, n_az, n_rg) complex64."""
    t = np.arange(n_az) / p.prf_hz
    chans = np.zeros((p.num_channels, n_az, n_rg), np.complex64)
    for k, x in enumerate(p.rx_offsets()):
        tk = t + x / (2.0 * p.velocity_mps)
        sig = np.zeros(n_az, np.complex128)
        for f0, amp in doppler_tones:
            sig += amp * np.exp(2j * np.pi * f0 * tk)
        chans[k] = sig[:, None].astype(np.complex64)
    return chans


# tests/test_hrws.py::TestReconstruction's scenes: (K, PRF, spacing,
# pulses, range columns, tones)
SCENES = {
    "out_of_band_tone": (2, 1000.0, 2 * V / 1000.0 / 2, 128, 4,
                         [(700.0, 1.0)]),
    "ghost_suppression": (2, 1000.0, V / 1000.0, 256, 2,
                          [(200.0, 1.0), (800.0, 1.0)]),
    "four_channels": (4, 500.0, 2 * V / (4 * 500.0), 64, 2,
                      [(900.0, 1.0)]),
}


def scene(name):
    k, prf, sp, n_az, n_rg, tones = SCENES[name]
    jp, tp = params(k, prf, sp)
    return jp, tp, synth_multichannel(tp, n_az, n_rg, tones), tones


def spectrum(rec, p):
    """|FFT| of range column 0 of a reconstruction and its frequencies."""
    n = rec.shape[0]
    return (np.abs(np.fft.fft(rec[:, 0])),
            np.fft.fftfreq(n, 1.0 / p.effective_prf))


@pytest.mark.parametrize("name", list(SCENES))
def test_reconstruct_matches_reference(name):
    """The port's reconstruction equals the JAX package's to float32
    rounding (1e-5 of the peak: both form the same loaded normal equations
    of complex64 steering matrices; the port solves them once in float64,
    the reference per call in complex64), and shows the scene's physics:
    each tone at its true frequency, the ghosts 20 dB down."""
    jp, tp, x, tones = scene(name)
    want = np.asarray(cplx.to_host(jhrws.reconstruct(jnp.asarray(x), jp)))
    got = hrws.reconstruct(torch.from_numpy(x), tp).numpy()
    assert got.shape == want.shape == (tp.bands * x.shape[1], x.shape[2])
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    spec, freqs = spectrum(got, tp)
    res = tp.effective_prf / got.shape[0]
    if len(tones) == 1:
        assert freqs[spec.argmax()] == pytest.approx(tones[0][0], abs=2 * res)
    for f0, _ in tones:
        true = spec[np.argmin(np.abs(freqs - f0))]
        ghost = spec[np.argmin(np.abs(freqs + f0))]
        assert true > 0.4 * spec.max() and ghost < 0.1 * true


@pytest.mark.parametrize("name", list(SCENES))
def test_reconstruct_matches_plain_reference(name):
    """The port against the benchmark's plain float64 reference, written
    from the published equations (1e-5 of the peak: float32 FFTs of a few
    hundred points)."""
    _, tp, x, _ = scene(name)
    got = hrws.reconstruct(torch.from_numpy(x), tp).numpy()
    want = ref_hrws.reconstruct(
        torch.from_numpy(x), dict(rx_offsets=tp.rx_offsets(),
                                  velocity_mps=V, prf_hz=tp.prf_hz,
                                  bands=tp.bands)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_reconstruct_takes_channels_as_a_list_and_refuses_too_few():
    _, tp, x, _ = scene("four_channels")
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(hrws.reconstruct(list(t), tp).numpy(),
                                  hrws.reconstruct(t, tp).numpy())
    _, few = params(2, 500.0, 2.0, m=3)
    with pytest.raises(ValueError, match="need >= 3 channels"):
        hrws.reconstruct(t[:2], few)


@pytest.mark.parametrize("k,m,prf,spacing", [
    (2, 0, 1000.0, 7.0), (4, 0, 500.0, 7.0), (4, 3, 500.0, 1.9),
    (3, 2, 800.0, 2.1)], ids=["k2", "k4", "k4m3", "k3m2"])
def test_steering_band_layout_and_conditioning(k, m, prf, spacing):
    """``_band_layout`` equals the reference's exactly; the steering matrix
    (float64 phase, float32 cast) and the condition numbers to float32
    rounding; every band of a bin lands at the bin's offset within its
    block (the permutation the port folds into the unfold operator);
    unequal K and M reconstruct as the reference does."""
    jp, tp = params(k, prf, spacing, m)
    n = 64
    j_idx, j_f = jhrws._band_layout(jp, n)
    t_idx, t_f = hrws._band_layout(tp, n)
    np.testing.assert_array_equal(t_idx, np.asarray(j_idx))
    np.testing.assert_array_equal(t_f, np.asarray(j_f))
    assert (t_idx % n == np.arange(n)[:, None]).all()
    a_j = np.asarray(cplx.to_host(jhrws.steering_matrix(jp, jnp.asarray(
        j_f))))
    a_t = hrws.steering_matrix(tp, t_f).numpy()
    assert a_t.shape == (n, k, tp.bands)
    np.testing.assert_allclose(a_t, a_j, atol=2e-6)
    np.testing.assert_allclose(hrws.condition_numbers(tp, n),
                               np.asarray(jhrws.condition_numbers(jp, n)),
                               rtol=1e-4)
    x = np.random.default_rng(7).standard_normal((k, n, 3, 2)).astype(
        np.float32).view(np.complex64)[..., 0]
    want = np.asarray(cplx.to_host(jhrws.reconstruct(jnp.asarray(x), jp)))
    got = hrws.reconstruct(torch.from_numpy(x), tp).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("fn,args,want", [
    ("dpca_condition_prf", (7000.0, 2.8), 5000.0),
    ("ghost_free_prf", (6000.0, 4), 1500.0),
    ("uniform_sampling_prf", (7000.0, 2.8, 4), 1250.0),
    ("uniform_sampling_spacing", (7000.0, 1250.0, 4), 2.8)])
def test_prf_helpers(fn, args, want):
    got = getattr(hrws, fn)(*args)
    assert got == pytest.approx(want)
    assert got == pytest.approx(getattr(jhrws, fn)(*args))


def test_uniform_spacing_is_well_conditioned_and_dpca_degenerate():
    """At the uniform-sampling spacing every bin's steering matrix is
    unitary up to scale; at the DPCA condition it is singular, and the
    loaded solve still returns finite values."""
    prf = 1500.0
    good = hrws.HrwsParams(4, hrws.uniform_sampling_spacing(V, prf, 4), prf,
                           V)
    np.testing.assert_allclose(hrws.condition_numbers(good, 32), 1.0,
                               atol=1e-5)
    bad = hrws.HrwsParams(2, 2 * V / prf, prf, V)
    assert hrws.dpca_condition_prf(V, bad.spacing_m) == pytest.approx(prf)
    assert hrws.condition_numbers(bad, 32).max() > 1e6
    x = torch.ones(2, 32, 2, dtype=torch.complex64)
    assert torch.isfinite(hrws.reconstruct(x, bad)).all()


def test_unfold_operator_is_built_once_and_the_stages_are_recorded():
    """A second reconstruction of the same (params, pulses, device) takes
    the kept operator; the stage record holds ``hrws.reconstruct`` over
    its three stages and counts the bands unfolded."""
    _, tp, x, _ = scene("four_channels")
    t = torch.from_numpy(x)
    hrws.reconstruct(t, tp)
    before = hrws.unfold_operator.cache_info()
    with profiling.recording() as rec:
        hrws.reconstruct(t, tp)
        hrws.reconstruct(t, tp)
    after = hrws.unfold_operator.cache_info()
    assert after.misses == before.misses
    assert after.hits == before.hits + 2
    tree = rec.tree()
    for stage in ("spectra", "unfold", "inverse"):
        assert tree[f"hrws.reconstruct/hrws.{stage}"][0] == 2
    assert rec.counters == {"hrws.bands": 8}


@pytest.mark.parametrize("fft_impl", ["xla", "pallas"])
def test_reconstruct_focus_records_both_halves(fft_impl):
    """``reconstruct_focus`` under the stage record opens
    ``hrws.reconstruct`` and then ``hrws.focus``, whose span holds the
    whole focus (the kernel route's spans, and the planes' split and join
    around them), on either route."""
    _, tp, _, tones = scene("four_channels")
    x = synth_multichannel(tp, 64, 96, tones)
    n_az, n_rg = tp.bands * 64, 96
    cp = csa.CsaParams(
        wavelength_m=0.03, chirp_rate=6e13, fs_hz=150e6,
        prf_hz=tp.effective_prf, velocity_mps=V, range_ref_m=6e5,
        t_start_fast=4e-3, num_pulses=n_az, num_samples=n_rg)
    with profiling.recording() as r:
        hrws.reconstruct_focus(torch.from_numpy(x), tp, cp, fft_impl)
    rec, foc = [s for s in r.spans if s.parent_id == 0]
    assert (rec.name, foc.name) == ("hrws.reconstruct", "hrws.focus")
    assert rec.end_ns <= foc.start_ns
    kernels = {f"hrws.focus/focus.{k}": 1 for k in ("k1", "k2", "k3")}
    assert {k: v[0] for k, v in r.tree().items()
            if k.startswith("hrws.focus")} \
        == {"hrws.focus": 1, **(kernels if fft_impl == "pallas" else {})}


def _small_collect(k: int):
    """Matching (JAX, port) inputs of a small HRWS collect on the
    ati_dpca orbit: k channels at a system PRF of 1,500 Hz, uniform
    effective sampling for V_eff, a 50 MHz / 2 us chirp at fs 60 MHz, 400
    pulses a channel (0.27 s: a Doppler span of ~1.9 kHz, which one
    channel at 1.5 kHz aliases; 400 k after the unfold, no power of two) x
    96 samples, one point target."""
    sc = tcfg.ati_dpca()
    g = sc.geometry
    v = g.effective_velocity_mps
    prf, n_p, n_s = 1500.0, 400, 96
    kw = dict(num_channels=k, prf_hz=prf, velocity_mps=v,
              spacing_m=hrws.uniform_sampling_spacing(v, prf, k))
    jp, tp = jhrws.HrwsParams(**kw), hrws.HrwsParams(**kw)
    ekw = dict(fc_hz=sc.radar.fc_hz, chirp_rate=50e6 / 2e-6,
               pulse_width_s=2e-6, fs_hz=60e6, num_samples=n_s,
               endpoint_grid=False, chirp_centering="centered")
    jopts, topts = jecho.EchoOpts(**ekw), echo.EchoOpts(**ekw)
    t0 = float(echo.window_start_time(g.slant_range_m, topts, n_s / 60e6,
                                      "centered"))
    ckw = dict(wavelength_m=sc.radar.wavelength_m, chirp_rate=50e6 / 2e-6,
               fs_hz=60e6, prf_hz=k * prf, velocity_mps=v,
               range_ref_m=g.slant_range_m, t_start_fast=t0,
               num_pulses=k * n_p, num_samples=n_s)
    jg = jcfg.ati_dpca().geometry
    return dict(
        jax=(jorbit.make_trajectory(jg, jorbit.slow_time_grid(n_p / prf,
                                                              n_p)),
             jtargets.point_target((0.0, 0.0, 0.0), 100.0), jopts, jp,
             jcsa.CsaParams(**ckw)),
        port=(orbit.make_trajectory(g, orbit.slow_time_grid(n_p / prf,
                                                            n_p)),
              targets.point_target((0.0, 0.0, 0.0), 100.0), topts, tp,
              csa.CsaParams(**ckw)),
        t0=t0)


def test_collect_reconstruct_focus_matches_reference():
    """The JAX package's unsharded end-to-end chain on a two-channel
    collect: the port's reconstruction within 2e-5 of its peak (the
    reference's tolerance for its own sharded run) and its grid-phase SLC
    within 1e-3 of the image's peak in magnitude."""
    c = _small_collect(2)
    j_rec, j_slc = jhrws.collect_reconstruct_focus(*c["jax"], t_start=c["t0"])
    t_rec, t_slc = hrws.collect_reconstruct_focus(*c["port"], t_start=c["t0"],
                                                  device="cpu")
    want = np.asarray(cplx.to_host(j_rec))
    np.testing.assert_allclose(t_rec.numpy(), want,
                               atol=2e-5 * np.abs(want).max())
    img = np.abs(np.asarray(cplx.to_host(j_slc)))
    np.testing.assert_allclose(np.abs(t_slc.numpy()), img,
                               atol=1e-3 * img.max())


def test_kernel_route_equals_grid_phase_route():
    """Four channels, 1,600 x 96 after the unfold: ``fft_impl='pallas'``
    (apply_csa_fused on K1, K2 single and K3; their plain versions on the
    CPU) against the grid-phase focus_csa route within 2e-5 of the SLC's
    peak (float32: the fused route forms the phases from 1-D factors, the
    grid route from float64 grids; both run 1,600- and 96-point float32
    FFTs). The kernel route records its three kernels' spans under
    ``hrws.focus``, beside ``hrws.reconstruct``, and counts
    the plane's azimuth transforms (forward and inverse) as chirp-z, 1,600
    being no power of two, and its range transforms as mixed radix, 96
    being none either; the unfold leaves no azimuth ghost 20 dB up."""
    c = _small_collect(4)
    traj, tgt, opts, p, cp = c["port"]
    raw = echo.multi_channel_phase_history(traj, tgt, opts, t_start=c["t0"],
                                           rx_offsets=p.rx_offsets(),
                                           device="cpu")
    rec, grid = hrws.reconstruct_focus(raw, p, cp)
    np.testing.assert_array_equal(
        grid.numpy(), csa.focus_csa(rec, cp).numpy())
    with profiling.recording() as r:
        rec_k, slc_k = hrws.reconstruct_focus(raw, p, cp, fft_impl="pallas")
    np.testing.assert_array_equal(rec_k.numpy(), rec.numpy())
    peak = grid.abs().max()
    assert float((slc_k - grid).abs().max()) < 2e-5 * float(peak)
    tree = r.tree()
    assert tree["hrws.reconstruct"][0] == tree["hrws.focus"][0] == 1
    for k in ("k1", "k2", "k3"):
        assert tree[f"hrws.focus/focus.{k}"][0] == 1
    assert r.counters == {"hrws.bands": 4, "cpi.chirpz_axes": 2,
                          "cpi.mixed_radix_axes": 2}
    # the unfold puts the point target's energy in one azimuth cell
    img = slc_k.abs().numpy()
    prof = img[:, img.max(axis=0).argmax()]
    pk = int(prof.argmax())
    d = np.minimum((np.arange(prof.size) - pk) % prof.size,
                   (pk - np.arange(prof.size)) % prof.size)
    assert prof[d > 24].max() < 0.1 * prof[pk]
