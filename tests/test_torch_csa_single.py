"""The single-channel CSA kernels (K1, K2 single, K3) and the raw balance
kernel of the PyTorch port against the JAX reference on the same inputs:
their plain versions (and the wrappers on CPU tensors, which run them)
against the Pallas kernels in interpret mode, the planes entry against the
reference's torch-free formation, the ``fft_impl`` routing of
``apply_csa_fused``, GMTI's composed path and VideoSAR's CSA formation, and
the split GMTI CPI against the reference's and the port's fused one."""

import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nis_sar_amtigmti_video_tpu import config as jcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu.gmti import cfar as jcfar  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import csa as jcsa  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops.pallas import (  # noqa: E402
    csa_kernel as jck, gmti_kernel as jgk)
from nis_sar_amtigmti_video_tpu_torch import config as tcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.gmti import cfar, fused  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.models import gmti  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.models import videosar  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops import csa as tcsa  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    csa_kernel as tck, gmti_kernel as tgk)

# one intra-op thread: the suite runs in several processes at once,
# and a torch OpenMP pool per process oversubscribes the cores
torch.set_num_threads(1)

SIZE = 256
A = int(math.isqrt(SIZE))
CP = cfar.CfarParams(guard=2, train=8)
JCP = jcfar.CfarParams(guard=2, train=8)


def _slice_params(n_az, n_rg):
    """Matching (JAX, port) CsaParams of the slice's scenario (ati_dpca with
    the CLI's --small waveform: BW 120 MHz, Tp 2 us, fs 150 MHz), where
    Phi2 stays within a few hundred rad (ROADMAP §4's caveat)."""
    sc = jcfg.ati_dpca()
    r = dataclasses.replace(sc.radar, bandwidth_hz=120e6, pulse_width_s=2e-6,
                            fs_hz=150e6)
    g = sc.geometry
    kw = dict(wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate,
              fs_hz=r.fs_hz, prf_hz=r.prf_hz,
              velocity_mps=g.effective_velocity_mps,
              range_ref_m=g.slant_range_m,
              t_start_fast=2.0 * g.slant_range_m / 299792458.0
              - r.pulse_width_s / 2 - 1e-6,
              num_pulses=n_az, num_samples=n_rg)
    return jcsa.CsaParams(**kw), tcsa.CsaParams(**kw)


def _factors(n_az=SIZE, n_rg=SIZE):
    """(JAX factors, the same values as the port's tensors)."""
    jf = jcsa.csa_factors(_slice_params(n_az, n_rg)[0])
    return jf, tcsa.csa_factors_from_numpy(
        {k: np.asarray(v) for k, v in jf._asdict().items()})


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _wrapped(d):
    return np.angle(np.exp(1j * d))


@pytest.fixture(scope="module")
def chain():
    """The reference's K1 -> K2 -> K3 (Pallas, interpret) on channel 1 of a
    seeded correlated raw pair, each stage fed the one before; the raw
    balance kernel on the pair; and the reference's split CPI
    (``gmti_cpi_pallas(k1_impl='split')``: balance, K1 + K2 per channel,
    K3g, K4) composed from those calls as that function composes them, so
    that each interpret call runs once."""
    jf, tf = _factors()
    rng = np.random.default_rng(31)
    x1 = (rng.standard_normal((SIZE, SIZE))
          + 1j * rng.standard_normal((SIZE, SIZE))).astype(np.complex64)
    x2 = (x1 * np.exp(1j * 0.31) + 0.05 * (
        rng.standard_normal((SIZE, SIZE))
        + 1j * rng.standard_normal((SIZE, SIZE)))).astype(np.complex64)
    x = [np.ascontiguousarray(v, np.float32)
         for v in (x1.real, x1.imag, x2.real, x2.imag)]
    j = jnp.asarray

    def k12(zr, zi):
        zr, zi = jck._k1_call(zr, zi, jf.u.reshape(1, -1),
                              jf.c1.reshape(-1, 1), jf.w.reshape(-1, 1), A,
                              True, "bf16x3")
        return (zr, zi), jck._k2_call(zr, zi, jf, A, True, "bf16x3",
                                      variant="dots")

    h_out, h_in = JCP.guard + JCP.train, JCP.guard
    with jax.enable_x64(False):
        xs_re, xs_im = jgk.raw_balance_pallas(*map(j, x), interpret=True)
        k1, k2 = k12(j(x[0]), j(x[1]))
        k3 = jck._k3_call(*k2, A, True, "bf16x3")
        _, z2 = k12(j(x[2]), j(x[3]))
        cal = jnp.arctan2(xs_im, xs_re)
        cal_cs = jnp.stack([jnp.cos(cal), jnp.sin(cal)]).reshape(1, 2)
        (s1r, s1i, s2r, s2i, ph_raw, mag, power, cso, csi,
         peaks) = jgk.k3_gmti_planes(*k2, *z2, cal_cs, h_out=h_out,
                                     h_in=h_in, interpret=True)
        snr, phase, dmag, _ = jgk.k4_epilogue_planes(
            cso, csi, power, ph_raw, mag, 0.05 ** 2 * jnp.max(peaks),
            h_out=h_out, h_in=h_in, interpret=True)

    def fetch(vs):
        return [np.asarray(v) for v in vs]

    return dict(x=x, tf=tf, k1=fetch(k1), k2=fetch(k2), k3=fetch(k3),
                bal=fetch((xs_re, xs_im)),
                cpi=fetch((s1r, s1i, s2r, s2i, cal, phase, dmag)),
                cpi_snr=np.asarray(snr))


# --------------------------------------------------------------------------
# K1, K2 single, K3 and balance vs the Pallas kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_k1_matches_pallas(chain, entry):
    fn = tck.k1_plain if entry == "plain" else tck.k1_call
    got = fn(_t(chain["x"][0]), _t(chain["x"][1]), chain["tf"])
    assert len(got) == 2
    for g, w in zip(got, chain["k1"]):
        assert g.is_contiguous() and g.dtype == torch.float32
        assert _rel(g, w) < 1e-4


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_k2_matches_pallas(chain, entry):
    fn = tck.k2_plain if entry == "plain" else tck.k2_call
    got = fn(*map(_t, chain["k1"]), chain["tf"])
    for g, w in zip(got, chain["k2"]):
        assert g.is_contiguous() and _rel(g, w) < 1e-4


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_k3_matches_pallas(chain, entry):
    fn = tck.k3_plain if entry == "plain" else tck.k3_call
    got = fn(*map(_t, chain["k2"]))
    for g, w in zip(got, chain["k3"]):
        assert g.is_contiguous() and _rel(g, w) < 1e-4


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_raw_balance_matches_pallas(chain, entry):
    """Sums to 1e-5 relative (another association order), angle to
    1e-5 rad."""
    fn = tgk.raw_balance_plain if entry == "plain" else tgk.raw_balance
    xs_re, xs_im = fn(*map(_t, chain["x"]))
    assert xs_re.dim() == 0 and xs_re.dtype == torch.float32
    w_re, w_im = (float(v) for v in chain["bal"])
    assert _rel(np.array([float(xs_re), float(xs_im)]),
                np.array([w_re, w_im])) < 1e-5
    assert abs(math.atan2(float(xs_im), float(xs_re))
               - math.atan2(w_im, w_re)) <= 1e-5


def test_single_channel_plain_equals_the_pair():
    """One channel through K1 / K2 / K3 gives the two-channel plain
    versions' planes for it, bit for bit (the CUDA kernels share their
    device code the same way)."""
    _, tf = _factors(64, 128)
    rng = np.random.default_rng(7)
    x = [_t(rng.standard_normal((64, 128)).astype(np.float32))
         for _ in range(4)]
    pair = tgk.k1_gmti_plain(*x, tf)
    for a, b in zip(tck.k1_plain(x[2], x[3], tf), pair[2:4]):
        assert torch.equal(a, b)
    pair = tck.k2_pair_plain(*x, tf)
    for a, b in zip(tck.k2_plain(x[0], x[1], tf), pair[:2]):
        assert torch.equal(a, b)
    g = tgk.k3_gmti_plain(*x, torch.tensor([1.0, 0.0]), h_out=10, h_in=2)
    for a, b in zip(tck.k3_plain(x[0], x[1]), g[:2]):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the public entries and fft_impl routing
# --------------------------------------------------------------------------

def _raw(shape, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_apply_csa_pallas_planes_matches_reference():
    """Batch (2, 256, 256) of planes vs the reference's XLA formation."""
    jf, tf = _factors()
    x = _raw((2, SIZE, SIZE))
    want = np.asarray(jcsa.apply_csa_fused(jnp.asarray(x), jf, "xla"))
    our, oui = tck.apply_csa_pallas_planes(
        _t(np.ascontiguousarray(x.real)), _t(np.ascontiguousarray(x.imag)),
        tf)
    assert our.shape == oui.shape == (2, SIZE, SIZE)
    assert _rel(_np(our) + 1j * _np(oui), want) < 1e-4
    got = tck.apply_csa_pallas(_t(x), tf)
    assert got.dtype == torch.complex64
    assert torch.equal(got, torch.complex(our, oui))


@pytest.mark.parametrize("impl", ["auto", "xla", "mxu", "hybrid", "pallas"])
def test_apply_csa_fused_fft_impl(impl):
    """Every name the reference takes runs; on the CPU 'pallas' runs the
    kernels' plain versions and equals torch.fft to 1e-4, the others are
    torch.fft itself."""
    _, tf = _factors(128, SIZE)
    x = torch.from_numpy(_raw((128, SIZE)))
    want = tcsa.apply_csa_fused(x, tf, "xla")
    got = tcsa.apply_csa_fused(x, tf, impl)
    if impl == "pallas":
        assert _rel(got, want) < 1e-4
    else:
        assert torch.equal(got, want)


def test_fft_impl_errors_and_refused_shapes():
    # 272 = 16 x 17: a prime factor outside the mixed-radix plan's
    _, tf = _factors(192, 272)
    x = torch.from_numpy(_raw((192, 272)))
    with pytest.raises(ValueError, match="unknown fft impl"):
        tcsa.apply_csa_fused(x, tf, "cufft")
    with pytest.raises(ValueError,
                       match=r"prime factors in .*\(192, 272\)"):
        tck.apply_csa_pallas_planes(x.real.contiguous(),
                                    x.imag.contiguous(), tf)
    # on the CPU a refused shape takes the reference's torch.fft route
    assert torch.equal(tcsa.apply_csa_fused(x, tf, "pallas"),
                       tcsa.apply_csa_fused(x, tf, "auto"))
    # the grid-phase path has no kernel route: 'pallas' raises there
    ph = tcsa.csa_phases(_slice_params(192, 272)[1])
    with pytest.raises(ValueError, match="unknown fft impl 'pallas'"):
        tcsa.apply_csa(x, ph, "pallas")


def _gmti_sc(fft_impl):
    sc = tcfg.ati_dpca()
    return sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                  pulse_width_s=2e-6, fs_hz=150e6),
        processing=dataclasses.replace(sc.processing, fft_impl=fft_impl))


@pytest.mark.parametrize("entry", ["apply_csa_fused", "composed", "auto"])
def test_pallas_refused_shape_raises_off_the_cpu(entry):
    """Off the CPU (a meta device reaches the check without tensor work)
    'pallas' at a shape the kernels refuse raises, naming the route that
    takes it, and never runs torch.fft in the kernels' place: directly and
    through focus_and_products under both paths."""
    with pytest.raises(ValueError, match="fft_impl='auto'"):
        if entry == "apply_csa_fused":
            _, tf = _factors(192, 272)
            tcsa.apply_csa_fused(torch.empty((192, 272), device="meta",
                                             dtype=torch.complex64),
                                 tf, "pallas")
        else:
            raw = torch.empty((2, 193, 272), device="meta",
                              dtype=torch.complex64)
            gmti.focus_and_products(raw, _gmti_sc("pallas"), 4e-3,
                                    path=entry)


@pytest.mark.parametrize("path", ["composed", "auto"])
def test_gmti_composed_honours_fft_impl(path):
    """focus_and_products with fft_impl='pallas' on the CPU: the kernels'
    plain versions, equal to the torch.fft composed route to f32
    rounding."""
    raw = torch.from_numpy(_raw((2, SIZE + 1, SIZE), 5))
    t0 = 2.0 * tcfg.ati_dpca().geometry.slant_range_m / 299792458.0 - 2e-6
    got = gmti.focus_and_products(raw, _gmti_sc("pallas"), t0, path=path)
    want = gmti.focus_and_products(raw, _gmti_sc("auto"), t0,
                                   path="composed")
    assert _rel(got.slc1, want.slc1) < 1e-4
    assert _rel(got.slc2, want.slc2) < 1e-4
    assert _rel(got.dpca_mag, want.dpca_mag) < 1e-4
    assert abs(float(got.cal_phase) - float(want.cal_phase)) < 1e-5


def test_form_frames_csa_pallas():
    """VideoSAR CSA formation with fft_impl='pallas' on CPU frames equals
    the torch.fft route; the grid-phase form refuses it."""
    _, p = _slice_params(SIZE, SIZE)
    frames = torch.from_numpy(_raw((2, SIZE, SIZE), 9))
    got = videosar.form_frames_csa(frames, p, fft_impl="pallas")
    want = videosar.form_frames_csa(frames, p, fft_impl="xla")
    assert got.shape == (2, SIZE, SIZE) and _rel(got, want) < 1e-4
    with pytest.raises(ValueError, match="unknown fft impl 'pallas'"):
        videosar.form_frames_csa(frames, p, fused=False, fft_impl="pallas")


# --------------------------------------------------------------------------
# the split CPI
# --------------------------------------------------------------------------

def test_split_cpi_matches_pallas_split(chain):
    """gmti_cpi(k1_impl='split') on CPU tensors vs the reference's split CPI
    (its Pallas kernels in interpret mode), at the tolerances of the fused
    CPI's parity test."""
    (s1r, s1i, s2r, s2i, cal, phase, dmag,
     det) = fused.gmti_cpi(*map(_t, chain["x"]), chain["tf"],
                           cfar_params=CP, k1_impl="split")
    w = chain["cpi"]
    for g, i in ((s1r, 0), (s1i, 1), (s2r, 2), (s2i, 3)):
        np.testing.assert_allclose(_np(g), w[i], rtol=1e-5, atol=1e-3)
    assert abs(float(cal) - float(w[4])) < 1e-4
    np.testing.assert_allclose(_np(dmag), w[6],
                               atol=2e-3 * np.abs(w[6]).max())
    np.testing.assert_allclose(_np(det.snr), chain["cpi_snr"], rtol=5e-3,
                               atol=5e-3)
    mag = _np(s1r) ** 2 + _np(s1i) ** 2
    thr = 0.05 ** 2 * mag.max()
    clear = np.abs(mag - thr) > 1e-3 * mag.max()
    assert np.abs(_wrapped(_np(phase) - w[5])[clear]).max() < 2e-3


@pytest.mark.parametrize("balance", [True, False])
def test_split_cpi_matches_fused2ch(chain, balance):
    """The port's two routes on the same raw pair: cal to 1e-5 rad, SLC
    planes and dmag to 1e-5 of the peak (the reference's own test of this
    pair runs 'fused2ch' on both sides)."""
    x = list(map(_t, chain["x"]))
    a = fused.gmti_cpi(*x, chain["tf"], cfar_params=CP, balance=balance,
                       k1_impl="split")
    b = fused.gmti_cpi(*x, chain["tf"], cfar_params=CP, balance=balance)
    assert abs(float(a[4]) - float(b[4])) <= 1e-5
    if not balance:
        assert float(a[4]) == 0.0
    for i in (0, 1, 2, 3, 6):
        assert _rel(a[i], b[i]) <= 1e-5, i
    np.testing.assert_allclose(_np(a[7].snr), _np(b[7].snr), rtol=1e-4,
                               atol=1e-4)


def test_unknown_k1_impl_raises():
    _, tf = _factors(64, 64)
    x = [torch.zeros(64, 64) for _ in range(4)]
    with pytest.raises(ValueError, match="unknown k1_impl"):
        fused.gmti_cpi(*x, tf, k1_impl="fused")
