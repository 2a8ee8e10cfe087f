"""The port's backprojection modules (ops/bp.py, ops/bp_fast.py, ops/czt.py,
ops/interp.py) against the JAX package on the same seeded inputs, and the
port's fast BP against its own float64 exact BP (the reference's oracle
recipe: 8x FFT-upsampled range data, tests/test_bp_fast.py)."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nis_sar_amtigmti_video_tpu import config as jcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu.geometry import orbit  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import bp as jbp  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import bp_fast as jbpf  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import czt as jczt  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import interp as jinterp  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops.echo import (  # noqa: E402
    EchoOpts, phase_history, window_start_time)
from nis_sar_amtigmti_video_tpu.scene import targets as jT  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops import bp, bp_fast  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.czt import czt_eval  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.interp import (  # noqa: E402
    interp_uniform)

# one intra-op thread: the suite runs in several processes at once,
# and a torch OpenMP pool per process oversubscribes the cores
torch.set_num_threads(1)

C = 299792458.0
SCENES = {"static": {}, "mbp": dict(vel=(12.0, 5.0, 0.0)),
          "squint": dict(t_offset=0.08), "stride2": dict(fs=360e6, ns=2048),
          "presum": dict(n_p=251)}


def _scene(n_p=192, fs=180e6, ns=1024, vel=(0.0, 0.0, 0.0), t_offset=0.0):
    """tests/test_bp_fast.py::_scene: three point targets, videosar
    geometry, raw echo from the JAX engine (numpy), f64 BpParams kwargs."""
    g = jcfg.videosar().geometry
    traj = orbit.make_trajectory(
        g, orbit.slow_time_grid(n_p / 5000.0, n_p) + t_offset)
    tgts = jT.PointTargets.concatenate([
        jT.point_target((0.0, 0.0, 0.0), 30.0),
        jT.point_target((150.0, -120.0, 0.0), 20.0),
        jT.point_target((-170.0, 140.0, 0.0), 25.0)])
    opts = EchoOpts(fc_hz=9.65e9, chirp_rate=150e6 / 2e-6, pulse_width_s=2e-6,
                    fs_hz=fs, num_samples=ns, endpoint_grid=False,
                    chirp_centering="centered", amplitude="rcs",
                    stop_and_go=True,
                    antenna_length_m=C / 9.65e9 * g.slant_range_m / 500.0)
    t0 = window_start_time(g.slant_range_m, opts, ns / fs, "centered")
    raw = np.asarray(phase_history(traj, tgts, opts, t_start=t0,
                                   target_velocity=np.asarray(vel)))
    kw = dict(fc_hz=opts.fc_hz, chirp_rate=opts.chirp_rate, fs_hz=fs,
              pulse_width_s=opts.pulse_width_s, num_samples=ns, nx=64, ny=64,
              scene_size_m=400.0)
    return raw, traj, kw, float(t0), np.asarray(vel, float)


def _port_oracle(raw, traj, kw, t0, vf, u=8):
    """The port's exact f64 BP on u-times FFT-upsampled range data."""
    p = bp.BpParams(**kw, precision="f64")
    rc = bp.bp_range_compress(torch.from_numpy(raw), p).numpy()
    n_p, ns = raw.shape
    spec = np.fft.fft(rc, axis=-1)
    h = ns // 2
    spec_u = np.zeros((n_p, ns * u), np.complex128)
    spec_u[:, :h], spec_u[:, -h:] = spec[:, :h], spec[:, -h:]
    spec_u[:, h] *= 0.5
    spec_u[:, -h] *= 0.5
    rc_u = (np.fft.ifft(spec_u, axis=-1) * u).astype(np.complex64)
    p_u = dataclasses.replace(p, fs_hz=p.fs_hz * u, num_samples=ns * u)
    t0_u = t0 + 0.5 * (u - 1) / (u * p.fs_hz)
    return bp.backproject(torch.from_numpy(rc_u), traj.positions,
                          traj.velocities, traj.times, vf, t0_u,
                          p_u).numpy()


def _check(fast, want, peak_db=0.1, peak_phase=0.01, field=0.01):
    a_f, a_w = np.abs(fast), np.abs(want)
    pk = np.unravel_index(a_w.argmax(), a_w.shape)
    assert abs(20 * np.log10(a_f[pk] / a_w[pk])) < peak_db
    assert abs(np.angle(fast[pk] * np.conj(want[pk]))) < peak_phase
    assert np.abs(a_f - a_w).max() / a_w.max() < field


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _presum(kw):
    g = jcfg.videosar().geometry
    return bp.presum_factor(bp.BpParams(**kw), 5000.0, C / 9.65e9,
                            g.slant_range_m, g.effective_velocity_mps)


@pytest.fixture(scope="module")
def scenes():
    return {k: _scene(**v) for k, v in SCENES.items()}


# --------------------------------------------------------------------------
# ops/bp.py, czt, interp
# --------------------------------------------------------------------------

def test_range_compress_and_filter_match_reference(scenes):
    raw, _, kw, _, _ = scenes["static"]
    want = np.asarray(jbp.bp_range_compress(jnp.asarray(raw),
                                            jbp.BpParams(**kw)))
    got = bp.bp_range_compress(torch.from_numpy(raw), bp.BpParams(**kw))
    assert _rel(got, want) < 1e-5
    np.testing.assert_array_equal(
        bp_fast.matched_filter_spectrum(bp.BpParams(**kw), 2048),
        jbpf.matched_filter_spectrum(jbp.BpParams(**kw), 2048))
    np.testing.assert_array_equal(bp.pixel_grid(bp.BpParams(**kw)),
                                  jbp.pixel_grid(jbp.BpParams(**kw)))


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_exact_backproject_matches_reference(scenes, precision):
    raw, traj, kw, t0, _ = scenes["mbp"]
    vf = np.array([12.0, 5.0, 0.0])
    jp = jbp.BpParams(**kw, precision=precision)
    rc = np.asarray(jbp.bp_range_compress(jnp.asarray(raw), jp))[:48]
    sl = slice(0, 48)
    want = np.asarray(jbp.backproject(
        jnp.asarray(rc), jnp.asarray(traj.positions[sl]),
        jnp.asarray(traj.velocities[sl]), jnp.asarray(traj.times[sl]),
        jnp.asarray(vf), jnp.float64(t0), jp))
    got = bp.backproject(torch.from_numpy(rc), traj.positions[sl],
                         traj.velocities[sl], traj.times[sl], vf, t0,
                         bp.BpParams(**kw, precision=precision))
    assert got.shape == (64, 64) and got.dtype == torch.complex64
    assert _rel(got, want) < (1e-3 if precision == "f32" else 1e-5)


def test_presum_helpers_match_reference(scenes):
    raw, traj, kw, t0, _ = scenes["presum"]
    vf = np.array([3.0, -1.0, 0.0])
    jp, p = jbp.BpParams(**kw), bp.BpParams(**kw)
    g = jcfg.videosar().geometry
    args = (5000.0, C / 9.65e9, g.slant_range_m, g.effective_velocity_mps)
    d = bp.presum_factor(p, *args)
    assert d == jbp.presum_factor(jp, *args) and d >= 2
    jt = (jnp.asarray(traj.positions), jnp.asarray(traj.velocities),
          jnp.asarray(traj.times), jnp.asarray(vf))
    np.testing.assert_allclose(
        bp.presum_droop_correction(traj.positions, traj.velocities,
                                   traj.times, vf, p, d).numpy(),
        np.asarray(jbp.presum_droop_correction(*jt, jp, d)), rtol=1e-6)
    rc = np.asarray(jbp.bp_range_compress(jnp.asarray(raw), jp))
    want = jbp.presum_recenter(jnp.asarray(rc), *jt, jnp.float64(t0), jp, d)
    got = bp.presum_recenter(torch.from_numpy(rc), traj.positions,
                             traj.velocities, traj.times, vf, t0, p, d)
    assert _rel(got[0], want[0]) < 1e-4
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("per_slice", [False, True])
def test_czt_matches_reference(per_slice):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((24, 40))
         + 1j * rng.standard_normal((24, 40))).astype(np.complex64)
    start = (rng.uniform(-3, 3, 40) if per_slice else 2.5)
    want = np.asarray(jczt.czt_eval(jnp.asarray(x), 17, 0.73,
                                    jnp.asarray(start), axis=0))
    got = czt_eval(torch.from_numpy(x), 17, 0.73, start, axis=0)
    assert got.shape == (17, 40)
    assert _rel(got, want) < 1e-5


def test_interp_uniform_matches_reference():
    rng = np.random.default_rng(5)
    sig = (rng.standard_normal((3, 50))
           + 1j * rng.standard_normal((3, 50))).astype(np.complex64)
    u = rng.uniform(-3, 53, (3, 70)).astype(np.float32)
    want = np.asarray(jinterp.interp_uniform(jnp.asarray(sig),
                                             jnp.asarray(u)))
    got = interp_uniform(torch.from_numpy(sig), torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# ops/bp_fast.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("factorize", [False, True])
@pytest.mark.parametrize("case", sorted(SCENES))
def test_make_plan_equals_reference(scenes, case, factorize):
    _, traj, kw, t0, _ = scenes[case]
    got = bp_fast.make_plan(bp.BpParams(**kw), traj.positions, traj.times,
                            t0, factorize=factorize)
    want = jbpf.make_plan(jbp.BpParams(**kw), traj.positions, traj.times,
                          t0, factorize=factorize)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if factorize:
        assert got.sub_raw > 0


def test_upsample_matrices_equal_reference(scenes):
    _, traj, kw, t0, _ = scenes["static"]
    plan = bp_fast.make_plan(bp.BpParams(**kw), traj.positions, traj.times,
                             t0, factorize=True)
    jplan = jbpf.FastBpPlan(**dataclasses.asdict(plan))
    np.testing.assert_array_equal(bp_fast._upsample_matrix(plan),
                                  jbpf._upsample_matrix(jplan))
    np.testing.assert_array_equal(bp_fast._upsample_matrix_l1(plan),
                                  jbpf._upsample_matrix_l1(jplan))


FOCUS = [("static", "xla"), ("mbp", "factor"), ("squint", "factor2"),
         ("stride2", "factor2"), ("presum", "factor")]


@pytest.mark.parametrize("case,acc", FOCUS)
def test_focus_bp_fast_matches_reference_and_oracle(scenes, case, acc):
    raw, traj, kw, t0, vf = scenes[case]
    d = _presum(kw) if case == "presum" else 1
    # the anchored fit (stride 16) on the 4x-presummed pulses of the short
    # presum scene interpolates over 64 raw pulses: exact fit there
    fs = 0 if case == "presum" else 16
    plan = bp_fast.make_plan(bp.BpParams(**kw), traj.positions, traj.times,
                             t0, factorize=acc != "xla")
    got = bp_fast.focus_bp_fast(
        torch.from_numpy(raw), traj.positions, traj.velocities, traj.times,
        vf, t0, bp.BpParams(**kw), presum=d, plan=plan, accumulate=acc,
        fit_stride=fs).numpy()
    want = np.asarray(jbpf.focus_bp_fast(
        jnp.asarray(raw), traj.positions, traj.velocities, traj.times, vf,
        t0, jbp.BpParams(**kw), presum=d,
        plan=jbpf.FastBpPlan(**dataclasses.asdict(plan)), accumulate=acc,
        fit_stride=fs))
    assert got.shape == (64, 64)
    assert _rel(got, want) < 2e-4
    ck = dict(presum=dict(peak_db=0.15, peak_phase=0.02, field=0.015),
              squint=dict(peak_db=0.12, peak_phase=0.02, field=0.012)
              ).get(case, {})
    _check(got, _port_oracle(raw, traj, kw, t0, vf), **ck)


def test_fused_recentre_accumulate_matches_plain_recentre(scenes):
    """'factor2_pallas' (the recentre kernel's plain version, band-limited)
    equals 'factor2' (bp_fast.recenter_presum) on an nfft the kernel
    takes."""
    raw, traj, kw, t0, vf = _scene(n_p=64, ns=10000)
    p = bp.BpParams(**kw)
    plan = bp_fast.make_plan(p, traj.positions, traj.times, t0,
                             factorize=True)
    args = (torch.from_numpy(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p)
    want = bp_fast.focus_bp_fast(*args, presum=2, plan=plan,
                                 accumulate="factor").numpy()
    got = bp_fast.focus_bp_fast(*args, presum=2, plan=plan,
                                accumulate="factor_pallas").numpy()
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("acc", ["pallas_interpret",
                                 "factor_kernel_interpret"])
def test_unported_accumulates_raise(scenes, acc):
    raw, traj, kw, t0, vf = scenes["static"]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        bp_fast.focus_bp_fast(torch.from_numpy(raw), traj.positions,
                              traj.velocities, traj.times, vf, t0,
                              bp.BpParams(**kw), accumulate=acc)


@pytest.mark.parametrize("acc", ["factor_pallas", "factor2_pallas"])
def test_kernel_accumulates_need_a_kernel_nfft(scenes, acc):
    """A '*_pallas' accumulate runs the recentre kernel or raises; it never
    falls back to the plain recentre (the static scene's nfft is 1024)."""
    raw, traj, kw, t0, vf = scenes["static"]
    with pytest.raises(ValueError, match="recentre kernel"):
        bp_fast.focus_bp_fast(torch.from_numpy(raw), traj.positions,
                              traj.velocities, traj.times, vf, t0,
                              bp.BpParams(**kw), accumulate=acc)


def test_bad_modes_raise(scenes):
    raw, traj, kw, t0, vf = scenes["static"]
    args = (torch.from_numpy(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, bp.BpParams(**kw))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        bp_fast.focus_bp_fast(*args, math_mode="fast")
    with pytest.raises(ValueError, match="math_mode"):
        bp_fast.focus_bp_fast(*args, math_mode="nope")
    with pytest.raises(ValueError, match="accumulate"):
        bp_fast.focus_bp_fast(*args, accumulate="nope")
    plan = bp_fast.make_plan(bp.BpParams(**kw), traj.positions, traj.times,
                             t0)
    spec = torch.zeros((192, 8, 128), dtype=torch.complex64)
    with pytest.raises(ValueError, match="raw_spectra needs"):
        bp_fast.backproject_fast(None, *args[1:5], bp.BpParams(**kw), plan,
                                 compress=True, raw_spectra=spec)
    big = dataclasses.replace(bp.BpParams(**kw), num_samples=512,
                              scene_size_m=3000.0)
    with pytest.raises(ValueError, match="does not fit"):
        bp_fast.make_plan(big, traj.positions, traj.times, t0)
