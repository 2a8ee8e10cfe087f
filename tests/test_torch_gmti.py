"""The PyTorch port's GMTI layer against the JAX reference on the same
inputs: ATI / DPCA / velocity / CA-CFAR, the composed product step, the
plain versions of the K1g / K3g / K4 kernels against the Pallas kernels
(interpret mode), and the whole CPI (``gmti_cpi`` on the CPU) against
``gmti_cpi_pallas``."""

import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nis_sar_amtigmti_video_tpu import config as jcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu.gmti import ati as jati  # noqa: E402
from nis_sar_amtigmti_video_tpu.gmti import cfar as jcfar  # noqa: E402
from nis_sar_amtigmti_video_tpu.gmti import dpca as jdpca  # noqa: E402
from nis_sar_amtigmti_video_tpu.gmti import fused as jfused  # noqa: E402
from nis_sar_amtigmti_video_tpu.gmti import velocity as jvel  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import csa as jcsa  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops.pallas import (  # noqa: E402
    csa_kernel as jck, gmti_kernel as jgk)
from nis_sar_amtigmti_video_tpu_torch.gmti import ati, cfar, dpca  # noqa
from nis_sar_amtigmti_video_tpu_torch.gmti import fused, velocity  # noqa
from nis_sar_amtigmti_video_tpu_torch.ops import csa as tcsa  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    _build, gmti_kernel as tgk)

# one intra-op thread: the suite runs in several processes at once,
# and a torch OpenMP pool per process oversubscribes the cores
torch.set_num_threads(1)

SIZE = 256
CP = cfar.CfarParams(guard=2, train=8)
JCP = jcfar.CfarParams(guard=2, train=8)
H_OUT, H_IN = CP.guard + CP.train, CP.guard


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pair(seed, shape=(96, 128), corr=0.31):
    """Two correlated complex64 SLC-like images."""
    rng = np.random.default_rng(seed)
    s1 = (rng.standard_normal(shape)
          + 1j * rng.standard_normal(shape)).astype(np.complex64)
    s2 = (s1 * np.exp(1j * corr) + 0.05 * (
        rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
          ).astype(np.complex64)
    return s1, s2


def _slice_factors(n_az, n_rg):
    """JAX CsaFactors of the slice's scenario (ati_dpca, 150 MHz waveform)
    and the same values as the port's tensors."""
    sc = jcfg.ati_dpca()
    r = dataclasses.replace(sc.radar, bandwidth_hz=120e6, pulse_width_s=2e-6,
                            fs_hz=150e6)
    g = sc.geometry
    t0 = 2.0 * g.slant_range_m / 299792458.0 - r.pulse_width_s / 2 - 1e-6
    p = jcsa.CsaParams(wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate,
                       fs_hz=r.fs_hz, prf_hz=r.prf_hz,
                       velocity_mps=g.effective_velocity_mps,
                       range_ref_m=g.slant_range_m, t_start_fast=t0,
                       num_pulses=n_az, num_samples=n_rg)
    jf = jcsa.csa_factors(p)
    tf = tcsa.csa_factors_from_numpy(
        {k: np.asarray(v) for k, v in jf._asdict().items()})
    return jf, tf


def _wrapped(d):
    return np.angle(np.exp(1j * d))


# --------------------------------------------------------------------------
# ATI / DPCA / velocity / CFAR
# --------------------------------------------------------------------------

_PAIR_OPS = {
    "interferogram": (jati.interferogram, ati.interferogram),
    "ati_phase": (jati.ati_phase, ati.ati_phase),
    "masked_phase": (jati.masked_phase, ati.masked_phase),
    "channel_balance_phase": (jati.channel_balance_phase,
                              ati.channel_balance_phase),
    "dpca_difference": (jdpca.dpca_difference, dpca.dpca_difference),
    "cancellation_ratio": (jdpca.cancellation_ratio,
                           dpca.cancellation_ratio),
}


@pytest.mark.parametrize("op", sorted(_PAIR_OPS))
def test_pair_ops_match_reference(op):
    s1, s2 = _pair(1)
    jfn, tfn = _PAIR_OPS[op]
    want = np.asarray(jfn(jnp.asarray(s1), jnp.asarray(s2)))
    got = _np(tfn(_t(s1), _t(s2)))
    assert got.shape == want.shape
    if op in ("ati_phase", "masked_phase"):
        np.testing.assert_allclose(_wrapped(got - want), 0.0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def test_apply_balance_matches_reference():
    s1, s2 = _pair(2)
    want = np.asarray(jati.apply_balance(jnp.asarray(s2), 0.7))
    got = _np(ati.apply_balance(_t(s2), 0.7))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pulse_shift_coregister():
    a = np.arange(24, dtype=np.float32).reshape(6, 4)
    for s in (0, 1, 2):
        for got, want in zip(dpca.pulse_shift_coregister(_t(a), _t(a + 1), s),
                             jdpca.pulse_shift_coregister(
                                 jnp.asarray(a), jnp.asarray(a + 1), s)):
            np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert dpca.dpca_baseline(7600.0, 6000.0) == jdpca.dpca_baseline(
        7600.0, 6000.0)


@pytest.mark.parametrize("fn", ["ambiguous_velocity", "velocity_from_phase",
                                "phase_from_velocity"])
def test_velocity_matches_reference(fn):
    x = np.linspace(-3.0, 3.0, 17).astype(np.float32)
    args = (0.031, 7600.0, 2.5) if fn != "ambiguous_velocity" else ()
    if fn == "ambiguous_velocity":
        assert velocity.ambiguous_velocity(0.031, 7600.0, 2.5) == \
            pytest.approx(jvel.ambiguous_velocity(0.031, 7600.0, 2.5),
                          rel=1e-12)
        return
    want = np.asarray(getattr(jvel, fn)(jnp.asarray(x), *args))
    got = _np(getattr(velocity, fn)(_t(x), *args))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert velocity.azimuth_displacement(2.0, 5e5, 7600.0) == \
        jvel.azimuth_displacement(2.0, 5e5, 7600.0)


@pytest.mark.parametrize("case", ["exponential", "dynamic_90db"])
def test_ca_cfar_matches_reference(case):
    rng = np.random.default_rng(4)
    power = rng.exponential(1.0, (80, 112)).astype(np.float32)
    if case == "dynamic_90db":
        power[20, 30] = 1e9                 # 90 dB above the floor
    want = jcfar.ca_cfar(jnp.asarray(power), JCP)
    got = cfar.ca_cfar(_t(power), CP)
    # cells whose window holds the 90 dB cell difference two sums of ~1e9
    # (in both implementations): compare those only through detections
    far = np.ones(power.shape, bool)
    if case == "dynamic_90db":
        far[20 - H_OUT:20 + H_OUT + 1, 30 - H_OUT:30 + H_OUT + 1] = False
        np.testing.assert_allclose(_np(got.noise)[40:, 50:], 1.0, atol=0.25)
    for name in ("snr", "noise"):
        np.testing.assert_allclose(_np(getattr(got, name))[far],
                                   np.asarray(getattr(want, name))[far],
                                   rtol=1e-5)
    np.testing.assert_array_equal(_np(got.detections),
                                  np.asarray(want.detections))


def test_cfar_counts_exact():
    for n, h in ((64, 10), (7, 3), (256, 2)):
        np.testing.assert_array_equal(_np(cfar._count_1d(n, h)),
                                      np.asarray(jcfar._count_1d(n, h)))
    np.testing.assert_array_equal(_np(cfar._box_count((20, 33), 4)),
                                  np.asarray(jcfar._box_count((20, 33), 4)))
    assert CP.alpha == JCP.alpha and CP.num_train_cells == JCP.num_train_cells


def test_cfar_precision_after_bright_target():
    """A 100 dB scatterer must not poison training sums downstream."""
    power = torch.full((64, 64), 1.0)
    power[5, 5] = 1e10
    res = cfar.ca_cfar(power, cfar.CfarParams(guard=2, train=6, pfa=1e-6))
    np.testing.assert_allclose(_np(res.noise)[40:, 40:], 1.0, atol=1e-3)


def test_detection_list_matches_reference():
    power = np.zeros((3, 32, 32), np.float32)
    power[0, 5, 7], power[2, 20, 11], power[2, 3, 3] = 500.0, 400.0, 300.0
    p = cfar.CfarParams(guard=1, train=3, pfa=1e-4)
    got = cfar.detection_list(cfar.ca_cfar(_t(power), p), max_detections=4)
    want = jcfar.detection_list(
        jcfar.ca_cfar(jnp.asarray(power),
                      jcfar.CfarParams(guard=1, train=3, pfa=1e-4)),
        max_detections=4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5)


@pytest.mark.parametrize("balance", [True, False])
def test_gmti_product_step_matches_reference(balance):
    s1, s2 = _pair(5)
    cal_w, ph_w, dm_w, det_w = jfused.gmti_product_step(
        jnp.asarray(s1), jnp.asarray(s2), balance=balance, cfar_params=JCP)
    cal, ph, dm, det = fused.gmti_product_step(_t(s1), _t(s2),
                                               balance=balance,
                                               cfar_params=CP)
    assert abs(float(cal) - float(cal_w)) < 1e-6
    np.testing.assert_allclose(_wrapped(_np(ph) - np.asarray(ph_w)), 0.0,
                               atol=2e-5)
    np.testing.assert_allclose(_np(dm), np.asarray(dm_w), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(det.snr), np.asarray(det_w.snr),
                               rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# K1g / K3g / K4 plain versions vs the Pallas kernels, and the whole CPI
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kernel_chain():
    """The reference's four Pallas kernels (interpret) run once on seeded
    planes, each stage's inputs kept for the port's plain versions."""
    jf, tf = _slice_factors(SIZE, SIZE)
    rng = np.random.default_rng(17)
    x1 = (rng.standard_normal((SIZE, SIZE))
          + 1j * rng.standard_normal((SIZE, SIZE))).astype(np.complex64)
    x2 = (x1 * np.exp(1j * 0.31) + 0.05 * (
        rng.standard_normal((SIZE, SIZE))
        + 1j * rng.standard_normal((SIZE, SIZE)))).astype(np.complex64)
    x = [np.ascontiguousarray(v, np.float32)
         for v in (x1.real, x1.imag, x2.real, x2.imag)]
    j = jnp.asarray
    with jax.enable_x64(False):
        k1 = [np.asarray(v) for v in jgk.k1_gmti_planes(
            *map(j, x), jf, interpret=True)]
        k2 = [np.asarray(v) for v in jck.k2_pair_call(
            *map(j, k1[:4]), jf, int(math.isqrt(SIZE)), True, "bf16x3",
            rows=32)]
        cal = np.float32(np.arctan2(k1[5], k1[4]))
        cal_cs = np.array([[np.cos(cal), np.sin(cal)]], np.float32)
        k3 = [np.asarray(v) for v in jgk.k3_gmti_planes(
            *map(j, k2), j(cal_cs), h_out=H_OUT, h_in=H_IN,
            interpret=True)]
        thr = np.float32(0.05 ** 2 * k3[9].max())
        k4 = [np.asarray(v) for v in jgk.k4_epilogue_planes(
            *map(j, (k3[7], k3[8], k3[6], k3[4], k3[5])), j(thr),
            h_out=H_OUT, h_in=H_IN, interpret=True)]
    cpi = jfused.gmti_cpi_pallas(*map(j, x), jf, cfar_params=JCP,
                                 interpret=True)
    return dict(x=x, tf=tf, k1=k1, k2=k2, cal_cs=cal_cs[0], k3=k3, thr=thr,
                k4=k4, cpi=[np.asarray(v) for v in cpi[:7]],
                cpi_det=cpi[7])


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_k1g_matches_pallas(kernel_chain, entry):
    c = kernel_chain
    fn = tgk.k1_gmti_plain if entry == "plain" else tgk.k1_gmti_planes
    got = fn(*map(_t, c["x"]), c["tf"])
    for g, w in zip(got[:4], c["k1"][:4]):
        assert _rel(g, w) < 1e-4
    # the raw balance sums: association differs, the angle must not
    cal_g = math.atan2(float(got[5]), float(got[4]))
    cal_w = math.atan2(float(c["k1"][5]), float(c["k1"][4]))
    assert abs(cal_g - cal_w) < 1e-6
    assert _rel(np.array([float(got[4]), float(got[5])]),
                np.array([c["k1"][4], c["k1"][5]])) < 1e-5


def test_k1g_without_balance():
    _, tf = _slice_factors(64, 128)
    x = [torch.ones(64, 128) for _ in range(4)]
    out = tgk.k1_gmti_planes(*x, tf, balance=False)
    assert float(out[4]) == 0.0 and float(out[5]) == 0.0


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_k3g_matches_pallas(kernel_chain, entry):
    c = kernel_chain
    fn = tgk.k3_gmti_plain if entry == "plain" else tgk.k3_gmti_planes
    got = fn(*map(_t, c["k2"]), _t(c["cal_cs"]), h_out=H_OUT, h_in=H_IN)
    assert len(got) == 10
    for i in (0, 1, 2, 3, 5):               # SLCs, |s1|^2
        assert _rel(got[i], c["k3"][i]) < 1e-4, i
    # DPCA power and its column sums: the two channels agree to ~5 % here,
    # so the difference carries ~20x the reference's ~5e-6 (bf16x3) error
    for i in (6, 7, 8):
        assert _rel(got[i], c["k3"][i]) < 5e-4, i
    # the per-column peaks reduce to the same peak2
    assert _rel(_np(got[9]).max(), c["k3"][9].max()) < 1e-5
    # unmasked ATI phase where |s1| is well above the floor
    mag = c["k3"][5]
    strong = mag > 1e-2 * mag.max()
    d = np.abs(_wrapped(_np(got[4])[strong] - c["k3"][4][strong]))
    assert np.median(d) < 1e-4 and d.max() < 2e-3


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_k4_matches_pallas(kernel_chain, entry):
    c = kernel_chain
    k3 = [_t(v) for v in c["k3"]]
    fn = tgk.k4_epilogue_plain if entry == "plain" \
        else tgk.k4_epilogue_planes
    snr, phase, dmag, noise = fn(k3[7], k3[8], k3[6], k3[4], k3[5],
                                 float(c["thr"]), h_out=H_OUT, h_in=H_IN)
    w_snr, w_phase, w_dmag, w_noise = c["k4"]
    np.testing.assert_array_equal(_np(phase), w_phase)
    np.testing.assert_allclose(_np(dmag), w_dmag, rtol=1e-6)
    for g, w in ((snr, w_snr), (noise, w_noise)):
        np.testing.assert_allclose(_np(g), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())


def test_gmti_cpi_matches_pallas_cpi(kernel_chain):
    """gmti_cpi on CPU tensors (the four plain versions) vs
    gmti_cpi_pallas(interpret=True), at the tolerances the reference holds
    its own fused CPI to."""
    c = kernel_chain
    (s1r, s1i, s2r, s2i, cal, phase, dmag,
     det) = fused.gmti_cpi(*map(_t, c["x"]), c["tf"], cfar_params=CP)
    w = c["cpi"]
    np.testing.assert_allclose(_np(s1r), w[0], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(_np(s2i), w[3], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(_np(s1i), w[1], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(_np(s2r), w[2], rtol=1e-5, atol=1e-3)
    assert abs(float(cal) - float(w[4])) < 1e-4
    np.testing.assert_allclose(_np(dmag), w[6],
                               atol=2e-3 * np.abs(w[6]).max())
    np.testing.assert_allclose(_np(det.snr), np.asarray(c["cpi_det"].snr),
                               rtol=5e-3, atol=5e-3)
    mag = _np(s1r) ** 2 + _np(s1i) ** 2
    thr = 0.05 ** 2 * mag.max()
    clear = np.abs(mag - thr) > 1e-3 * mag.max()
    assert np.abs(_wrapped(_np(phase) - w[5])[clear]).max() < 2e-3


def test_gmti_cpi_module_state():
    """GmtiCpi keeps the per-configuration state (buffers, and the
    kernels' axis plans, which .to() moves with them) and gives the
    functional entry's result."""
    _, tf = _slice_factors(64, 128)
    cpi = fused.GmtiCpi(tf, CP)
    names = {n for n, _ in cpi.named_buffers()}
    assert set(tcsa.CsaFactors._fields) <= names
    assert {"ch_o", "ch_i", "cw_o", "cw_i"} <= names
    assert cpi.az.tw.shape == (32,) and cpi.rg.tw.shape == (64,)
    moved = fused.GmtiCpi(tf, CP).to("meta")
    assert moved.az.tw.device.type == moved.rg.tw.device.type == "meta"
    rng = np.random.default_rng(9)
    x = [_t(rng.standard_normal((64, 128)).astype(np.float32))
         for _ in range(4)]
    a = cpi(*x, balance=True)
    b = fused.gmti_cpi(*x, tf, cfar_params=CP)
    for u, v in zip(a[:7], b[:7]):
        np.testing.assert_array_equal(_np(u), _np(v))


def test_wrappers_refuse_other_devices():
    _, tf = _slice_factors(64, 64)
    x = [torch.empty((64, 64), device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="no kernel for device"):
        tgk.k1_gmti_planes(*x, tf)
    assert _build.on_cpu(torch.zeros(1))
