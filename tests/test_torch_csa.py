"""The PyTorch port's CSA layer against the JAX reference on the same inputs:
the 1-D factors, the composed torch.fft formation, and the K2 pair kernel's
plain version against the Pallas kernel (interpret mode)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nis_sar_amtigmti_video_tpu import config as jcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import csa as jcsa  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops.echo import (  # noqa: E402
    window_start_time)
from nis_sar_amtigmti_video_tpu.ops.pallas import (  # noqa: E402
    csa_kernel as jck)
from nis_sar_amtigmti_video_tpu_torch.ops import csa as tcsa  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    csa_kernel as tck)

SIZE = 256


def _slice_scenario():
    """ati_dpca with the CLI's --small waveform (BW 120 MHz, Tp 2 us,
    fs 150 MHz): the port's slice scenario."""
    sc = jcfg.ati_dpca()
    return sc.replace(radar=dataclasses.replace(
        sc.radar, bandwidth_hz=120e6, pulse_width_s=2e-6, fs_hz=150e6))


def _params(preset, n_az=None, n_rg=None):
    """Matching (JAX, port) CsaParams of a preset's geometry and waveform
    ('slice': :func:`_slice_scenario`); the preset's own CPI size unless
    given."""
    sc = _slice_scenario() if preset == "slice" else getattr(jcfg, preset)()
    g, r, c = sc.geometry, sc.radar, sc.collect
    t0 = window_start_time(g.slant_range_m, None, c.window_length_s,
                           "centered")
    kw = dict(wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate,
              fs_hz=r.fs_hz, prf_hz=r.prf_hz,
              velocity_mps=g.effective_velocity_mps,
              range_ref_m=g.slant_range_m, t_start_fast=t0,
              num_pulses=n_az or c.num_pulses(r.prf_hz),
              num_samples=n_rg or c.num_samples(r.fs_hz))
    return jcsa.CsaParams(**kw), tcsa.CsaParams(**kw)


def _np_factors(jf):
    return {k: np.asarray(v) for k, v in jf._asdict().items()}


@pytest.fixture(scope="module")
def k2_case():
    """The reference K2 pair (Pallas, interpret) on seeded planes, once.
    The slice's waveform keeps Phi2 within a few hundred rad, where float32
    phase rounding stays well under the bound (the full 600 MHz preset at
    this size reaches 1.1e4 rad, whose f32 rounding alone is ~5e-4)."""
    jp, _ = _params("slice", SIZE, SIZE)
    jf = jcsa.csa_factors(jp)
    rng = np.random.default_rng(21)
    planes = [rng.standard_normal((SIZE, SIZE)).astype(np.float32)
              for _ in range(4)]
    want = jck.k2_pair_call(*(jnp.asarray(p) for p in planes), jf,
                            int(math.isqrt(SIZE)), True, "bf16x3")
    return planes, _np_factors(jf), [np.asarray(w) for w in want]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("preset", ["videosar", "ati_dpca", "slice"])
def test_csa_factors_match_reference(preset):
    jp, tp = _params(preset)
    jf = _np_factors(jcsa.csa_factors(jp))
    tf = tcsa.csa_factors(tp)
    for name in tcsa.CsaFactors._fields:
        got = getattr(tf, name).numpy()
        want = jf[name]
        assert got.dtype == np.float32 and got.shape == want.shape, name
        if name in ("rphase", "cphase"):          # wrapped phases
            d = np.angle(np.exp(1j * (got.astype(np.float64) - want)))
            assert np.abs(d).max() <= 4e-6, name
        else:
            # u and dr cross zero: the absolute floor is 1e-6 of the scale
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=name)


def test_factors_from_numpy_bit_exact():
    jp, _ = _params("ati_dpca", 128, 96)
    d = _np_factors(jcsa.csa_factors(jp))
    tf = tcsa.csa_factors_from_numpy(d)
    for name in tcsa.CsaFactors._fields:
        np.testing.assert_array_equal(getattr(tf, name).numpy(), d[name])


def test_apply_csa_fused_matches_reference():
    jp, _ = _params("ati_dpca", 128, SIZE)
    jf = jcsa.csa_factors(jp)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((128, SIZE))
         + 1j * rng.standard_normal((128, SIZE))).astype(np.complex64)
    want = np.asarray(jcsa.apply_csa_fused(jnp.asarray(x), jf, "xla"))
    got = tcsa.apply_csa_fused(torch.from_numpy(x),
                               tcsa.csa_factors_from_numpy(_np_factors(jf)))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < 1e-4


def test_csa_axes_match_reference():
    jp, tp = _params("videosar", 64, 96)
    for got, want in zip(tcsa.csa_axes(tp), jcsa.csa_axes(jp)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_k2_pair_matches_pallas(k2_case, entry):
    """The plain K2 pair, and the wrapper on CPU tensors (which runs it),
    against the Pallas kernel's bf16x3 result."""
    planes, d, want = k2_case
    fn = tck.k2_pair_plain if entry == "plain" else tck.k2_pair_call
    got = fn(*(torch.from_numpy(p) for p in planes),
             tcsa.csa_factors_from_numpy(d))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == torch.float32
        assert _rel(g.numpy(), w) < 1e-4


@pytest.mark.parametrize("shape,ok", [
    ((256, 256), True), ((4096, 4096), True), ((64, 128), True),
    ((192, 256), False), ((257, 256), False), ((32, 64), False),
    ((8192, 8192), False)])
def test_supported_shapes(shape, ok):
    assert tck.supported(*shape) is ok


def test_twiddle_table():
    tw = tck.twiddle_table(16)
    assert tw.dtype == torch.complex64 and tw.shape == (8,)
    want = np.exp(-2j * np.pi * np.arange(8) / 16)
    np.testing.assert_allclose(tw.numpy(), want, atol=1e-7)
