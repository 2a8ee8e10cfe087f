"""The port's NUFFT echo (``ops/echo_freq.py``, the ``'freq'`` backend of
``ops/echo.py``) against the JAX package on the same seeded inputs, at the
reference tests' scenes and tolerances (tests/test_echo_freq.py): every
spreader (the spread kernel's plain version against the reference's Pallas
kernel in interpret mode), the group-window spread units, the FFT conv's
plain version against the reference's conv kernel in interpret mode, the
anchored and channel-batched geometry, the approximate mode and the error
paths. On the CPU no kernel launches."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import dataclasses  # noqa: E402

from nis_sar_amtigmti_video_tpu import config as jcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu.geometry import orbit as jorbit  # noqa
from nis_sar_amtigmti_video_tpu.models import gmti as jgmti  # noqa: E402
from nis_sar_amtigmti_video_tpu.models import stripmap as jstripmap  # noqa
from nis_sar_amtigmti_video_tpu.models import videosar as jvideosar  # noqa
from nis_sar_amtigmti_video_tpu.ops import echo as jecho  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import echo_freq as jef  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops.pallas import (  # noqa: E402
    fft_kernel as jfft_kernel)
from nis_sar_amtigmti_video_tpu.scene import clutter as jclutter  # noqa
from nis_sar_amtigmti_video_tpu.scene import targets as jtargets  # noqa
from nis_sar_amtigmti_video_tpu_torch import config as tcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.models import gmti  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.models import stripmap  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.models import videosar  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops import echo  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops import echo_freq  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    fft_kernel, spread_kernel)

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

KR = 50e6 / 2e-6   # BW 50 MHz < fs 60 MHz: a physical waveform


def _kw(backend, **kw):
    base = dict(fc_hz=9.65e9, chirp_rate=KR, pulse_width_s=2e-6, fs_hz=60e6,
                num_samples=360, endpoint_grid=False,
                chirp_centering="leading", backend=backend)
    base.update(kw)
    return base


def _both(backend, **kw):
    """(port EchoOpts, reference EchoOpts) of the same fields."""
    return echo.EchoOpts(**_kw(backend, **kw)), jecho.EchoOpts(
        **_kw(backend, **kw))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _rel(got, want):
    return float(np.abs(_np(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _launches():
    return (spread_kernel.spread_windows_pallas.launches,
            spread_kernel.spread_windows_pallas.launches_qr,
            fft_kernel.fft_conv_pallas.launches)


@pytest.fixture(scope="module")
def scene():
    """tests/test_echo_freq.py's interference-rich scene: the destroyer and
    100 clutter points over 8 pulses, a centred 360-sample window."""
    g = jcfg.satellite_stripmap().geometry
    traj = jorbit.make_trajectory(g, jorbit.slow_time_grid(8 / 6000.0, 8))
    tgts = jtargets.PointTargets.concatenate(
        [jtargets.destroyer(),
         jclutter.ocean_clutter_field(np.random.default_rng(0), 100, 400.0)])
    t0 = jecho.window_start_time(g.slant_range_m, None, 360 / 60e6,
                                 "centered")
    return g, traj, tgts, t0


@pytest.fixture(scope="module")
def fields():
    """Seeded delay-sorted (P, B) scalar fields inside the window."""
    rng = np.random.default_rng(5)
    p, b = 4, 64
    tau = np.sort(rng.uniform(-1e-6, 6.5e-6, (p, b)), axis=1)
    car = rng.uniform(-np.pi, np.pi, (p, b)).astype(np.float32)
    amp = rng.uniform(0.5, 2.0, (p, b)).astype(np.float32)
    return tau.astype(np.float32), car, amp


# reference spreader for each of the port's, and the bound (of the peak).
# The reference's dense routes split every value into bf16 hi and lo halves
# (16 mantissa bits, ~4e-6 relative per value: a Mosaic/MXU workaround);
# the port's are exact float32, so the two agree at that class (2.3e-6
# measured), under the 1e-5 the reference holds its reassociated qr route
# to; within the port, the dense routes equal the scatter one to 1e-6
# (test_dense_spreaders_match_scatter).
SPREADERS = {"scatter": ("scatter", 2e-5), "dense": ("dense", 1e-5),
             "dense_kernel": ("dense_kernel_interpret", 1e-5),
             "dense_kernel_qr": ("dense_kernel_qr_interpret", 1e-5)}


@pytest.mark.parametrize("spreader", sorted(SPREADERS))
def test_synthesize_spreaders_match_reference(fields, spreader):
    ref_name, bound = SPREADERS[spreader]
    opts, jopts = _both("freq")
    tau, car, amp = fields
    want = np.asarray(jef.synthesize(jnp.asarray(tau), jnp.asarray(car),
                                     jnp.asarray(amp), jopts,
                                     spreader=ref_name))
    before = _launches()
    got = echo_freq.synthesize(*map(torch.from_numpy, (tau, car, amp)),
                               opts, spreader=spreader)
    assert _launches() == before
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert np.abs(want).max() > 0
    assert _rel(got, want) < bound


@pytest.mark.parametrize("spreader", ["dense", "dense_kernel",
                                      "dense_kernel_qr"])
def test_dense_spreaders_match_scatter(fields, spreader):
    """The port's float32 dense routes against its scatter route: sums of
    the same values in other orders."""
    opts = echo.EchoOpts(**_kw("freq"))
    args = (*map(torch.from_numpy, fields), opts)
    want = echo_freq.synthesize(*args, spreader="scatter")
    got = echo_freq.synthesize(*args, spreader=spreader)
    assert float((got - want).abs().max()) < 1e-6 * float(want.abs().max())


def _spread_args(seed, pc, num_b, k, l_out, offsets, sort=True, i0=None):
    rng = np.random.default_rng(seed)
    if i0 is None:
        i0 = rng.integers(-40, l_out + 20, (pc, num_b))
        if sort:
            i0 = np.sort(i0, axis=1)
    sets = [(rng.normal(size=(pc, num_b, k)).astype(np.float32),
             rng.normal(size=(pc, num_b, k)).astype(np.float32), off)
            for off in offsets]
    return np.asarray(i0, np.int32), sets


def _spread_both(i0, sets, l_out, win, grp, lo, impl, ref_impl):
    want = jef._spread_dense(
        jnp.asarray(i0), [(jnp.asarray(a), jnp.asarray(b), o)
                          for a, b, o in sets], l_out, win, grp, lo=lo,
        impl=ref_impl)
    got = echo_freq._spread_dense(
        torch.from_numpy(i0), [(torch.from_numpy(a), torch.from_numpy(b), o)
                               for a, b, o in sets], l_out, win, grp, lo=lo,
        impl=impl)
    return got, want


IMPLS = {"xla": "xla", "pallas": "pallas_interpret",
         "pallas_qr": "pallas_qr_interpret"}


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_spread_dense_units_two_sets(impl):
    """Duplicate cells, out-of-grid targets and two value sets (offsets 0
    and 37), against the reference's same route (its kernels in interpret
    mode)."""
    i0, sets = _spread_args(7, 3, 200, 6, 900, (0, 37))
    (gr, gi), (wr, wi) = _spread_both(i0, sets, 900, 512, 8, 64, impl,
                                      IMPLS[impl])
    scale = float(np.abs(np.asarray(wr)).max()) + 1e-9
    assert np.abs(_np(gr) - np.asarray(wr)).max() < 1e-5 * scale
    assert np.abs(_np(gi) - np.asarray(wi)).max() < 1e-5 * scale


@pytest.mark.parametrize("impl", ["pallas", "pallas_qr"])
def test_spread_kernel_drops_all_taps_of_masked_targets(impl):
    """A target dropped by the group cell-spread rule (c = -1 with nonzero
    tap values) deposits nothing at any tap."""
    i0 = np.tile(np.array([[0, 5, 9, 400, 0, 3, 7, 420]]), (2, 1))
    i0, sets = _spread_args(11, 2, 8, 6, 600, (0,), i0=i0)
    (gr, gi), (wr, wi) = _spread_both(i0, sets, 600, 128, 2, 16, impl,
                                      "xla")
    scale = float(np.abs(np.asarray(wr)).max()) + 1e-9
    assert np.abs(_np(gr) - np.asarray(wr)).max() < 1e-5 * scale
    assert np.abs(_np(gi) - np.asarray(wi)).max() < 1e-5 * scale


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_spread_dense_counts_dropped_targets(impl):
    """The stage record counts the (pulse, target) pairs whose group window
    cannot hold them (``echo.dropped``): the far target of each group of
    four on both pulses where a window of 256 cells holds the near three
    (a group's window starts up to 127 cells below its first target, at a
    128-cell boundary), none where 1,024 cells hold them all."""
    from nis_sar_amtigmti_video_tpu_torch.utils import profiling
    i0 = np.tile(np.array([[0, 5, 9, 400, 0, 3, 7, 420]]), (2, 1))
    i0, sets = _spread_args(11, 2, 8, 6, 600, (0,), i0=i0)
    vals = [(torch.from_numpy(a), torch.from_numpy(b), o)
            for a, b, o in sets]
    for win, dropped in ((256, 4), (1024, 0)):
        with profiling.recording() as rec:
            echo_freq._spread_dense(torch.from_numpy(i0), vals, 600, win,
                                    2, impl=impl)
        assert rec.counters == {"echo.dropped": dropped}


@pytest.mark.parametrize("qr", [False, True])
def test_spread_windows_plain_definition(qr):
    """The plain windows against a direct float64 loop over targets and
    taps: duplicates, masked targets (-1) and cells near the window's end
    (the roll order wraps them, the one-accumulator order drops them)."""
    rng = np.random.default_rng(3)
    pc, grp, bg, n_sets, k, win = 2, 3, 9, 2, 4, 128
    c = rng.integers(-1, win, (pc, grp, bg)).astype(np.int32)
    c[0, 0, :3] = 5                      # duplicates
    c[1, 2, :2] = win - 2                # taps past the window's end
    v = rng.normal(size=(pc, grp, n_sets, 2 * k, bg)).astype(np.float32)
    want = np.zeros((pc, grp, 2 * n_sets, win))
    for p in range(pc):
        for g in range(grp):
            for b in range(bg):
                if c[p, g, b] < 0:
                    continue
                for kk in range(k):
                    j = c[p, g, b] + kk
                    if j >= win:
                        if qr:
                            continue
                        j -= win
                    for s in range(n_sets):
                        want[p, g, 2 * s, j] += v[p, g, s, kk, b]
                        want[p, g, 2 * s + 1, j] += v[p, g, s, k + kk, b]
    got = spread_kernel.spread_windows_pallas(torch.from_numpy(c),
                                              torch.from_numpy(v), win, qr=qr)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)


def test_fft_conv_plain_matches_reference_kernel():
    """fft_conv_pallas on CPU tensors (its plain version) vs the reference's
    fused conv kernel in interpret mode at l_fft 16,384, band rows."""
    rng = np.random.default_rng(13)
    nfft, l_in, rows = 16384, 15000, (40, 100)
    fr, fi = (rng.normal(size=(3, l_in)).astype(np.float32)
              for _ in range(2))
    filt = (rng.normal(size=nfft) + 1j * rng.normal(size=nfft)) / 8.0
    cr, ci = jfft_kernel.fft_conv_pallas(jnp.asarray(fr), jnp.asarray(fi),
                                         filt, nfft, out_rows=rows,
                                         interpret=True)
    want = np.asarray(cr) + 1j * np.asarray(ci)
    got = fft_kernel.fft_conv_pallas(torch.from_numpy(fr),
                                     torch.from_numpy(fi), filt, nfft,
                                     out_rows=rows)
    assert got.shape == want.shape == (3, 60 * 128)
    assert _rel(got, want) < 3e-5


@pytest.fixture(scope="module")
def conv_case():
    """Seeded fields at num_samples 4000 (l_fft 16,384, inside the conv
    kernel's range) and the reference's synthesis through its conv kernel
    in interpret mode."""
    opts, jopts = _both("freq", num_samples=4000)
    rng = np.random.default_rng(11)
    p, b = 3, 48
    tau = np.sort(rng.uniform(5e-6, 5.5e-5, (p, b)), axis=1)
    car = rng.uniform(-np.pi, np.pi, (p, b)).astype(np.float32)
    amp = rng.uniform(0.5, 2.0, (p, b)).astype(np.float32)
    lead = int(round(2e-6 * 60e6 * 2)) + 2 + 8
    assert fft_kernel.supported(1 << (lead + 8000 + 10 - 1).bit_length())
    want = np.asarray(jef.synthesize(jnp.asarray(tau), jnp.asarray(car),
                                     jnp.asarray(amp), jopts,
                                     conv="pallas_interpret"))
    return opts, (tau, car, amp), want


@pytest.mark.parametrize("conv", ["xla", "pallas"])
def test_synthesize_conv_matches_reference_kernel(conv_case, conv):
    """The port's conv routes (torch.fft, the kernel's plain version)
    through synthesize vs the reference's conv kernel."""
    opts, fields, want = conv_case
    got = echo_freq.synthesize(*map(torch.from_numpy, fields), opts,
                               conv=conv)
    assert _rel(got, want) < 3e-5


@pytest.mark.parametrize("spreader", ["dense_kernel", "dense_kernel_qr"])
def test_kernel_operands_are_the_first_chunks(conv_case, monkeypatch,
                                              spreader):
    """kernel_operands gives exactly what synthesize hands the spread and
    conv wrappers for its first pulse chunk (two chunks of 2 pulses here):
    the main spread, the one shared-flank edge spread and the conv; the
    formed taps' operands on 'dense_kernel', the values on
    'dense_kernel_qr'."""
    opts, fields, _ = conv_case
    tau, car, amp = map(torch.from_numpy, fields)
    kw = dict(spreader=spreader, conv="pallas", pulse_chunk=2)
    seen = {"spread": [], "conv": []}
    spread, conv = (spread_kernel.spread_windows_pallas,
                    fft_kernel.fft_conv_pallas)

    def spread_rec(c_ok, vals, win, qr=False, taps=None):
        seen["spread"].append((c_ok, vals, win, qr, taps))
        return spread(c_ok, vals, win, qr, taps)

    def conv_rec(fr, fi, filt, nfft, out_rows=None):
        seen["conv"].append((fr, fi, filt, nfft, out_rows))
        return conv(fr, fi, filt, nfft, out_rows)

    monkeypatch.setattr(spread_kernel, "spread_windows_pallas", spread_rec)
    monkeypatch.setattr(fft_kernel, "fft_conv_pallas", conv_rec)
    echo_freq.synthesize(tau, car, amp, opts, **kw)
    assert len(seen["spread"]) == 4 and len(seen["conv"]) == 2
    ops = echo_freq.kernel_operands(tau, car, amp, opts, **kw)
    assert len(ops["spread edge"]) == 1
    qr = spreader == "dense_kernel_qr"
    for (c, v, win), (c_t, o_t, win_t, taps), (c_s, v_s, win_s, qr_s,
                                               taps_s) in zip(
            [ops["spread main"], *ops["spread edge"]],
            [ops["spread main taps"], *ops["spread edge taps"]],
            seen["spread"][:2]):
        assert torch.equal(c, c_s) and torch.equal(c_t, c_s)
        assert (win, win_t, qr) == (win_s, win_s, qr_s)
        assert torch.equal(v, spread_kernel.pack_values(
            spread_kernel.tap_sets(o_t, taps), c.shape[1]))
        if qr:
            assert torch.equal(v, v_s) and taps_s is None
        else:
            assert torch.equal(o_t, v_s) and taps == taps_s
    fr, fi, filt, nfft, rows = ops["conv"]
    fr_s, fi_s, filt_s, nfft_s, rows_s = seen["conv"][0]
    assert torch.equal(fr, fr_s) and torch.equal(fi, fi_s)
    assert torch.equal(filt, filt_s) and (nfft, rows) == (nfft_s, rows_s)


@pytest.mark.parametrize("kw", [dict(spreader="scatter", conv="pallas"),
                                dict(spreader="dense", conv="xla"),
                                dict(spreader="dense", conv="pallas",
                                     edge_taper=0.0)])
def test_kernel_operands_refuses_other_routes(conv_case, kw):
    opts, fields, _ = conv_case
    with pytest.raises(ValueError, match="kernel_operands needs"):
        echo_freq.kernel_operands(*map(torch.from_numpy, fields), opts, **kw)


def test_scalar_fields_feed_synthesize(scene):
    """echo.scalar_fields and synth_options give the freq backend's two
    passes: synthesize on them is the channel-batched phase history."""
    g, traj, tgts, t0 = scene
    opts = echo.EchoOpts(**_kw("freq", freq_spreader="dense"))
    offs = (-1.3, 1.3)
    fields = echo.scalar_fields(traj, tgts, opts, t_start=t0,
                                rx_offsets=offs, target_velocity=(3.0, 0, 0),
                                device="cpu")
    assert all(f.shape == (2 * 8, tgts.num) and f.dtype == torch.float32
               for f in fields)
    assert bool((torch.diff(fields[0][4]) >= -1e-9).all())   # delay order
    got = echo_freq.synthesize(*fields, opts, **echo.synth_options(opts))
    want = echo.multi_channel_phase_history(traj, tgts, opts, t_start=t0,
                                            rx_offsets=offs,
                                            target_velocity=(3.0, 0, 0),
                                            device="cpu")
    assert torch.equal(got.reshape(want.shape), want)
    with pytest.raises(ValueError, match="no scalar-field"):
        echo.scalar_fields(traj, tgts, echo.EchoOpts(**_kw("jnp")),
                           t_start=t0, rx_offsets=offs, device="cpu")


@pytest.mark.parametrize("case", ["single", "batched", "split"])
def test_freq_phase_history_matches_reference(scene, case):
    """The freq phase history over 40 pulses (the anchored geometry, stride
    8) against the reference's, single-channel, channel-batched and with the
    'split' interpolation (scatter spreader on both sides)."""
    g, _, tgts, t0 = scene
    traj = jorbit.make_trajectory(g, jorbit.slow_time_grid(40 / 6000.0, 40))
    kw = dict(freq_geom_stride=8, freq_spreader="scatter")
    if case == "split":
        kw["freq_geom_interp"] = "split"
    opts, jopts = _both("freq", **kw)
    if case == "batched":
        offs = (-1.3, 1.3)
        want = np.stack([np.asarray(c) for c in
                         jecho.multi_channel_phase_history(
                             traj, tgts, jopts, t_start=t0,
                             rx_offsets=offs)])
        got = echo.multi_channel_phase_history(traj, tgts, opts, t_start=t0,
                                               rx_offsets=offs, device="cpu")
        parts = echo.multi_channel_phase_history(
            traj, tgts, opts, t_start=t0, rx_offsets=offs, device="cpu",
            channels_as_tuple=True)
        assert isinstance(parts, tuple) and len(parts) == 2
        assert torch.equal(torch.stack(parts), got)
    else:
        want = np.asarray(jecho.phase_history(traj, tgts, jopts, t_start=t0,
                                              rx_offset=0.4))
        got = echo.phase_history(traj, tgts, opts, t_start=t0,
                                 rx_offset=0.4, device="cpu")
    assert got.shape == want.shape
    assert _rel(got, want) < 2e-5


def test_freq_approximate_mode_matches_reference(scene):
    """freq_edge_taper=0 (no exact-edge pass) at oversample 4."""
    g, traj, tgts, t0 = scene
    opts, jopts = _both("freq", freq_oversample=4, freq_edge_taper=0.0)
    want = np.asarray(jecho.phase_history(traj, tgts, jopts, t_start=t0))
    got = echo.phase_history(traj, tgts, opts, t_start=t0, device="cpu")
    assert _rel(got, want) < 2e-5


def test_freq_matches_direct_engine(scene):
    """The port's own fidelity class: field RMS error < -55 dB against its
    direct engine (tests/test_echo_freq.py's budget)."""
    g, traj, tgts, t0 = scene
    a = _np(echo.phase_history(traj, tgts, echo.EchoOpts(**_kw("jnp")),
                               t_start=t0, device="cpu"))
    b = _np(echo.phase_history(traj, tgts, echo.EchoOpts(
        **_kw("freq", freq_spreader="dense_kernel")), t_start=t0,
        device="cpu"))
    err_db = 10 * np.log10(np.mean(np.abs(a - b) ** 2)
                           / np.mean(np.abs(a) ** 2))
    assert err_db < -55.0


def test_freq_far_target_drops(scene):
    g, traj, _, t0 = scene
    far = jtargets.point_target((0.0, 30000.0, 0.0), 1e6)
    r = _np(echo.phase_history(traj, far, echo.EchoOpts(**_kw("freq")),
                               t_start=t0, device="cpu"))
    assert np.isfinite(r).all() and np.abs(r).max() < 1e-3


@pytest.mark.parametrize("kw,err,match", [
    (dict(endpoint_grid=True), ValueError, "uniform fast-time"),
    (dict(freq_spread_win=300), ValueError, "spread_win must"),
    (dict(freq_spread_win=384), ValueError, "spread_win must be a 256"),
    (dict(freq_spread_win_edge=200), ValueError, "spread_win_edge"),
    (dict(freq_spreader="dense_kernel_interpret"), NotImplementedError,
     "interpret"),
    (dict(freq_conv="pallas_interpret"), NotImplementedError, "interpret"),
    (dict(freq_spreader="nope"), ValueError, "unknown spreader"),
    (dict(freq_geom_interp="fast"), ValueError, "freq_geom_interp"),
    (dict(backend="pallas_interpret"), NotImplementedError, "interpret"),
])
def test_freq_error_paths(scene, kw, err, match):
    g, traj, tgts, t0 = scene
    with pytest.raises(err, match=match):
        echo.phase_history(traj, tgts, echo.EchoOpts(**{**_kw("freq"),
                                                         **kw}),
                           t_start=t0, device="cpu")


def test_routes_on_cpu(fields):
    """'auto' takes the scatter spreader and torch.fft on CPU tensors; an
    explicit conv='pallas' at a length the kernel does not take runs
    torch.fft there (the reference's fallback), launching nothing."""
    opts = echo.EchoOpts(**_kw("freq"))
    assert echo_freq._resolve_routes("auto", "auto", 1024, False) == (
        "scatter", "xla")
    assert echo_freq._resolve_routes("auto", "auto", 65536, True) == (
        "dense_kernel", "pallas")
    assert echo_freq._resolve_routes("auto", "auto", 1024, True) == (
        "dense_kernel", "xla")
    with pytest.raises(ValueError, match="l_fft"):
        echo_freq._resolve_routes("dense", "pallas", 1024, True)
    tau, car, amp = map(torch.from_numpy, fields)
    before = _launches()
    a = echo_freq.synthesize(tau, car, amp, opts, conv="pallas")
    b = echo_freq.synthesize(tau, car, amp, opts, conv="xla")
    assert torch.equal(a, b) and _launches() == before


def test_phase_history_needs_a_device_without_cuda(scene):
    g, traj, tgts, t0 = scene
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None means the card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        echo.phase_history(traj, tgts, echo.EchoOpts(**_kw("jnp")),
                           t_start=t0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        echo.multi_channel_phase_history(
            traj, tgts, echo.EchoOpts(**_kw("freq")), t_start=t0,
            rx_offsets=(0.0, 1.0))


def _freq_collect(cfg_mod, preset, **kw):
    sc = getattr(cfg_mod, preset)()
    return sc.replace(collect=dataclasses.replace(
        sc.collect, echo_backend="freq", echo_oversample=4, **kw))


def test_models_pass_the_freq_options():
    """echo_opts_for and spotlight_echo_opts carry the collect's backend
    and oversampling into the echo options, as the reference's do."""
    for preset in ("ati_dpca", "videosar"):
        got = stripmap.echo_opts_for(_freq_collect(tcfg, preset))
        want = jstripmap.echo_opts_for(_freq_collect(jcfg, preset))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.freq_oversample == 4
    got = videosar.spotlight_echo_opts(_freq_collect(tcfg, "videosar"), 3.0)
    want = jvideosar.spotlight_echo_opts(_freq_collect(jcfg, "videosar"),
                                         3.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_simulate_two_channel_freq_matches_reference():
    """gmti.simulate_two_channel with echo_backend='freq' (the centred
    window's uniform grid) at the CLI's --small waveform, 16 pulses x 256
    samples, against the reference's (which returns a channel tuple)."""
    def small(cfg_mod):
        sc = cfg_mod.ati_dpca()
        return sc.replace(
            radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                      pulse_width_s=2e-6, fs_hz=150e6),
            collect=dataclasses.replace(
                sc.collect, integration_time_s=16 / 6000.0,
                window_length_s=256 / 150e6, echo_backend="freq",
                window_start_mode="centered"))
    ship = jtargets.destroyer()
    want, _, t0 = jgmti.simulate_two_channel(small(jcfg), ship,
                                             (4.0, 0.0, 0.0))
    want = np.stack([np.asarray(c) for c in want])
    got, _, t0_p = gmti.simulate_two_channel(small(tcfg), ship,
                                             (4.0, 0.0, 0.0), device="cpu")
    assert t0_p == t0 and got.shape == want.shape == (2, 16, 256)
    assert _rel(got, want) < 2e-5
