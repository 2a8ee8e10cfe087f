"""The fast-BP recentre kernels' plain versions (ops/cuda/fft_kernel.py)
against the JAX package's Pallas kernels run in interpret mode and its XLA
``recenter_presum``, on the same seeded inputs at nfft 16,384; the ring
contract; the spectra layout converters. The kernels themselves are held
to these plain versions on the card (tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nis_sar_amtigmti_video_tpu import config as jcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu.geometry import orbit  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import bp as jbp  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import bp_fast as jbpf  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops.pallas import (  # noqa: E402
    fft_kernel as jfk)
from nis_sar_amtigmti_video_tpu_torch.ops import bp, bp_fast  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    fft_kernel)

# one intra-op thread: the suite runs in several processes at once,
# and a torch OpenMP pool per process oversubscribes the cores
torch.set_num_threads(1)

C = 299792458.0
NS = 10000                     # nfft 16,384 (B1 = 128)
BP_KW = dict(fc_hz=9.65e9, chirp_rate=150e6 / 2e-6, fs_hz=180e6,
             pulse_width_s=2e-6, num_samples=NS, nx=64, ny=64,
             scene_size_m=400.0)


def _case(n_p, seed):
    traj = orbit.make_trajectory(jcfg.videosar().geometry,
                                 orbit.slow_time_grid(n_p / 5000.0, n_p))
    rng = np.random.default_rng(seed)
    rc = (rng.standard_normal((n_p, NS))
          + 1j * rng.standard_normal((n_p, NS))).astype(np.complex64)
    t_ref = float(2.0 * np.linalg.norm(traj.positions, axis=1).mean() / C)
    vf = np.array([4.0, -3.0, 0.0])
    return rc, traj, vf, t_ref


def _jtraj(traj, vf):
    return (jnp.asarray(traj.positions), jnp.asarray(traj.velocities),
            jnp.asarray(traj.times), jnp.asarray(vf, jnp.float64))


def _ttraj(traj, vf):
    return tuple(torch.from_numpy(np.asarray(a, np.float64)) for a in
                 (traj.positions, traj.velocities, traj.times, vf))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def case6():
    """n_p 6, d 3: the JAX fused kernel, its split pair and its XLA twin."""
    rc, traj, vf, t_ref = _case(6, 7)
    jp = jbp.BpParams(**BP_KW)
    jt = _jtraj(traj, vf)
    fused = jfk.recenter_presum_pallas(jnp.asarray(rc), *jt, jp, 3, t_ref,
                                       interpret=True)
    spec = jfk.forward_spectra_pallas(jnp.asarray(rc), jp, interpret=True)
    split = jfk.recentre_from_spectra_pallas(spec, *jt, jp, 3, t_ref,
                                             interpret=True, out_rows=(40, 90))
    xla = jbpf.recenter_presum(jnp.asarray(rc), *jt, jp, 3, t_ref,
                               ref_conj=jbpf.matched_filter_spectrum(
                                   jp, 16384))
    return rc, traj, vf, t_ref, dict(
        fused=[np.asarray(v) for v in fused], spec=np.asarray(spec),
        split=[np.asarray(v) for v in split],
        xla=[np.asarray(v) for v in xla])


def test_supported_matches_reference():
    for nfft in (1024, 8192, 16384, 32768, 65536, 131072, 3 * 16384):
        assert fft_kernel.supported(nfft) == jfk.supported(nfft), nfft


def test_forward_spectra_plain_matches_reference(case6):
    rc, _, _, _, want = case6
    got = fft_kernel.forward_spectra(torch.from_numpy(rc),
                                     bp.BpParams(**BP_KW))
    assert got.shape == (6, 128, 128) and got.dtype == torch.complex64
    ref = fft_kernel.spectra_from_reference_layout(want["spec"])
    assert _rel(got, ref) < 3e-4


def test_recenter_presum_plain_matches_reference(case6):
    rc, traj, vf, t_ref, want = case6
    got = fft_kernel.recenter_presum(torch.from_numpy(rc), *_ttraj(traj, vf),
                                     bp.BpParams(**BP_KW), 3, t_ref)
    assert got[0].shape == want["fused"][0].shape == (2, 16384)
    assert _rel(got[0], want["fused"][0]) < 3e-4
    assert _rel(got[0], want["xla"][0]) < 3e-4
    for a, b in zip(got[1:], want["xla"][1:]):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_recentre_from_reference_spectra(case6):
    """One cached spectra buffer, the JAX kernel's, handed to both
    packages' recentre_from_spectra."""
    _, traj, vf, t_ref, want = case6
    spec = fft_kernel.spectra_from_reference_layout(want["spec"])
    got = fft_kernel.recentre_from_spectra(spec, *_ttraj(traj, vf),
                                           bp.BpParams(**BP_KW), 3, t_ref,
                                           out_rows=(40, 90))
    assert got[0].shape == (2, 50 * 128)
    assert _rel(got[0], want["split"][0]) < 3e-4
    # the band rows are the full output's columns [40*128, 90*128)
    assert _rel(got[0], want["fused"][0][:, 40 * 128:90 * 128]) < 3e-4


def test_layout_converters(case6):
    """Frequency f = k2 + 128*k1 sits at [k2, k1]; the converters are exact
    inverses of each other."""
    rc, _, _, _, want = case6
    spec = fft_kernel.spectra_from_reference_layout(want["spec"])
    np.testing.assert_array_equal(
        fft_kernel.spectra_to_reference_layout(spec), want["spec"])
    nat = np.fft.fft(rc.astype(np.complex128), n=16384, axis=-1) \
        * bp.reference_chirp_conj(bp.BpParams(**BP_KW), 16384)
    got = fft_kernel.spectra_natural(spec).numpy()
    assert _rel(got, nat) < 3e-4
    k2, k1 = 5, 77
    assert abs(spec[1, k2, k1] - nat[1, k2 + 128 * k1]) < 1e-3 * np.abs(
        nat).max()


@pytest.fixture(scope="module")
def case12():
    rc, traj, vf, t_ref = _case(12, 11)
    p = bp.BpParams(**BP_KW)
    spec = fft_kernel.forward_spectra(torch.from_numpy(rc), p)
    return spec, _ttraj(traj, vf), p, t_ref


@pytest.mark.parametrize("off", [3, 6, 9])
def test_ring_equals_chronological(case12, off):
    spec, traj, p, t_ref = case12
    want = fft_kernel.recentre_from_spectra(spec, *traj, p, 3, t_ref,
                                            out_rows=(40, 90))
    got = fft_kernel.recentre_from_spectra(torch.roll(spec, off, 0), *traj,
                                           p, 3, t_ref, out_rows=(40, 90),
                                           ring_offset=off)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


def test_ring_needs_whole_groups(case12):
    spec, traj, p, t_ref = case12
    with pytest.raises(ValueError, match="ring_offset"):
        fft_kernel.recentre_from_spectra(spec[:-2], *(t[:-2] for t in
                                                      traj[:3]), traj[3], p,
                                         3, t_ref, ring_offset=3)
    with pytest.raises(ValueError, match="ring_offset"):
        fft_kernel.recentre_from_spectra(spec, *traj, p, 3, t_ref,
                                         ring_offset=4)


def test_band_and_nfft_checks(case12):
    spec, traj, p, t_ref = case12
    with pytest.raises(ValueError, match="out_rows"):
        fft_kernel.recentre_from_spectra(spec, *traj, p, 3, t_ref,
                                         out_rows=(90, 40))
    small = torch.zeros((4, 1000), dtype=torch.complex64)
    with pytest.raises(ValueError, match="unsupported"):
        fft_kernel.forward_spectra(small, p)
    with pytest.raises(ValueError, match="unsupported"):
        fft_kernel.recenter_presum(small, *(t[:4] for t in traj[:3]),
                                   traj[3], p, 2, t_ref)


def test_plain_split_equals_plain_fused(case12):
    """forward_spectra then recentre_from_spectra == recenter_presum."""
    spec, traj, p, t_ref = case12
    rc, _, _, _ = _case(12, 11)
    fused = fft_kernel.recenter_presum(torch.from_numpy(rc), *traj, p, 3,
                                       t_ref, out_rows=(40, 90))
    split = fft_kernel.recentre_from_spectra(spec, *traj, p, 3, t_ref,
                                             out_rows=(40, 90))
    assert _rel(split[0], fused[0]) < 1e-5


def test_cpu_wrappers_launch_nothing(case12):
    spec, traj, p, t_ref = case12
    before = (fft_kernel.forward_spectra.launches,
              fft_kernel.recentre_from_spectra.launches,
              fft_kernel.recenter_presum.launches)
    fft_kernel.recentre_from_spectra(spec, *traj, p, 3, t_ref)
    assert (fft_kernel.forward_spectra.launches,
            fft_kernel.recentre_from_spectra.launches,
            fft_kernel.recenter_presum.launches) == before


def test_bp_fast_band_rows_match_reference():
    """bp_fast.band_rows is the (p0, p1) rule of the reference's
    backproject_fast."""
    plan = bp_fast.FastBpPlan(ny_i=1664, nx_i=768, w_win=32, stride=1,
                              band_start=10613, nfft=32768, dx_m=1.0,
                              t_ref=1e-3, n_org=1e4)
    band_end = plan.band_start + plan.stride * (plan.ny_i - 1) + plan.w_win
    assert bp_fast.band_rows(plan) == (plan.band_start // 128,
                                       -(-band_end // 128)) == (82, 97)
