"""The Range-Doppler Algorithm of the PyTorch port (``ops/rda.py``,
``ops/windows.py``, ``ops/interp.py::interp_nonuniform_src``, the RCMC
kernel's plain version in ``ops/cuda/rcmc_kernel.py`` and
``models/stripmap.py``) against the JAX reference on the same inputs, on
the CPU, at the CLI's ``--small`` cuts of ``satellite_stripmap`` (256 x 768)
and ``airborne_vehicle`` (2,048 x 2,048, 10 cells of RCM spread along a
row): windows, axes, matched filter, range compression, the four RCMC
modes, the whole chain, the closed-form interval against searchsorted, the
natural-order route against the shifted one, ``stripmap.run`` on both
branches, its noise, and the stage record."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nis_sar_amtigmti_video_tpu import config as jcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu.models import stripmap as jstripmap  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import interp as jinterp  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import rda as jrda  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import windows as jwindows  # noqa: E402
from nis_sar_amtigmti_video_tpu.scene import targets as jtargets  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch import config as tcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.models import stripmap  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops import interp, rda, windows  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import rcmc_kernel  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.scene import targets  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.utils import profiling  # noqa: E402

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

CONFIGS = ("satellite_stripmap", "airborne_vehicle")


def small(cfg_mod, name: str, algorithm: str = "rda", mode: str = "exact"):
    """The CLI's ``--small`` cut of a preset of ``cfg_mod`` (either
    package's config module)."""
    sc = getattr(cfg_mod, name)()
    if name == "satellite_stripmap":
        sc = sc.replace(
            radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                      pulse_width_s=2e-6, fs_hz=150e6),
            collect=dataclasses.replace(
                sc.collect, integration_time_s=256 / sc.radar.prf_hz,
                window_length_s=768 / 150e6))
    else:
        sc = sc.replace(collect=dataclasses.replace(
            sc.collect, integration_time_s=2048 / sc.radar.prf_hz))
    return sc.replace(processing=dataclasses.replace(
        sc.processing, algorithm=algorithm, rcmc_mode=mode))


def params(name: str, mode: str = "exact", n_az=None):
    """Matching (JAX, port) RdaParams of a small preset; ``n_az`` another
    pulse count."""
    sc = small(tcfg, name)
    r, g, c = sc.radar, sc.geometry, sc.collect
    kw = dict(wavelength_m=r.wavelength_m, pulse_width_s=r.pulse_width_s,
              chirp_rate=r.chirp_rate, fs_hz=r.fs_hz, prf_hz=r.prf_hz,
              velocity_mps=g.effective_velocity_mps,
              range_ref_m=g.slant_range_m,
              num_pulses=n_az or c.num_pulses(r.prf_hz),
              num_samples=c.num_samples(r.fs_hz), rcmc_mode=mode)
    return jrda.RdaParams(**kw), rda.RdaParams(**kw)


def noise(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("n", [1, 7, 64, 301, 2048])
@pytest.mark.parametrize("name", sorted(windows.WINDOWS))
def test_windows_match_reference(name, n):
    want = np.asarray(jwindows.get_window(name, n, dtype=jnp.float64))
    got = windows.get_window(name, n, dtype=torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-15)
    assert windows.get_window(name, n).dtype == torch.float32


def test_get_window_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown window 'kaiser'"):
        windows.get_window("kaiser", 8)


@pytest.mark.parametrize("seed", range(4))
def test_interp_nonuniform_src_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n, m = 200, 300
    x_src = np.sort(rng.uniform(-5.0, 5.0, n))
    y = noise((n,), seed)
    # outside the grid both ways, on grid points and in between
    x_out = np.concatenate([rng.uniform(-6.0, 6.0, m - 20), x_src[:20]])
    want = np.asarray(jinterp.interp_nonuniform_src(
        jnp.asarray(x_src), jnp.asarray(y), jnp.asarray(x_out)))
    got = interp.interp_nonuniform_src(torch.from_numpy(x_src),
                                       torch.from_numpy(y),
                                       torch.from_numpy(x_out))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.all(got.numpy()[(x_out < x_src[0]) | (x_out > x_src[-1])] == 0)


def test_interp_nonuniform_src_rows_are_independent():
    """A batch of rows, each on its own grid, equals the rows one by one."""
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(np.sort(rng.uniform(0, 10, (5, 64)), axis=-1))
    ys = torch.from_numpy(noise((5, 64), 7))
    xo = torch.from_numpy(rng.uniform(-1, 11, (5, 80)))
    got = interp.interp_nonuniform_src(xs, ys, xo)
    for k in range(5):
        assert torch.equal(got[k], interp.interp_nonuniform_src(
            xs[k], ys[k], xo[k]))


@pytest.mark.parametrize("n_az", [256, 255])
@pytest.mark.parametrize("name", CONFIGS)
def test_rda_axes_match_reference(name, n_az):
    jp, tp = params(name, n_az=n_az)
    for w, g in zip(jrda.rda_axes(jp), rda.rda_axes(tp)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", CONFIGS)
def test_range_compress_matches_reference(name):
    jp, tp = params(name)
    np.testing.assert_array_equal(rda.matched_filter(tp).numpy(),
                                  np.asarray(jrda.matched_filter(jp)))
    ph = noise((8, tp.num_samples))
    got = rda.range_compress(torch.from_numpy(ph), tp)
    assert rel(got, jrda.range_compress(jnp.asarray(ph), jp)) < 1e-6
    # and np.convolve's 'same' mode, the upstream's per-pulse loop
    mf = rda.matched_filter(tp).numpy().astype(np.complex128)
    want = np.stack([np.convolve(row.astype(np.complex128), mf, "same")
                     for row in ph])
    assert rel(got, want) < 1e-6


@pytest.mark.parametrize("name", CONFIGS)
def test_rda_grids_match_reference(name):
    jp, tp = params(name)
    jd, jh, jr = jrda._rda_grids(jp)
    d, h, r = rda.rda_grids(tp)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-14)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    assert np.abs(h.numpy() - np.asarray(jh)).max() < 1e-6


@pytest.mark.parametrize("mode", rda.RCMC_MODES)
@pytest.mark.parametrize("name", CONFIGS)
def test_rcmc_matches_reference(name, mode):
    jp, tp = params(name)
    jd, _, jr = jrda._rda_grids(jp)
    d, _, r = rda.rda_grids(tp)
    rd = noise((tp.num_pulses, tp.num_samples), 3)
    want = np.asarray(jrda.rcmc(jnp.asarray(rd), jd, jr, mode))
    with profiling.recording() as rec:
        got = rda.rcmc(torch.from_numpy(rd), d, r, mode)
    assert rel(got, want) < 2e-6
    assert rec.counters == {"rda.rcmc_rows": tp.num_pulses}


def test_rcmc_refuses_an_unknown_mode():
    _, tp = params("satellite_stripmap")
    d, _, r = rda.rda_grids(tp)
    with pytest.raises(ValueError, match="unknown rcmc mode 'cubic'"):
        rda.rcmc(torch.zeros(d.shape, dtype=torch.complex64), d, r, "cubic")


@pytest.mark.parametrize("name", CONFIGS)
def test_phase_rcmc_inrow_cells_and_refusal(name):
    jp, tp = params(name, "phase")
    assert rda.phase_rcmc_inrow_cells(tp) == jrda.phase_rcmc_inrow_cells(jp)
    raw = torch.from_numpy(noise((tp.num_pulses, tp.num_samples)))
    if rda.phase_rcmc_inrow_cells(tp) > 0.5:
        with pytest.raises(ValueError, match="constant per Doppler row"):
            rda.focus_rda(raw, tp)
    else:
        assert rda.focus_rda(raw, tp).image.shape == raw.shape


# 'phase' is refused at the airborne geometry (tested above)
@pytest.mark.parametrize("name,mode", [
    (n, m) for n in CONFIGS for m in rda.RCMC_MODES
    if (n, m) != ("airborne_vehicle", "phase")])
def test_focus_rda_matches_reference(name, mode):
    jp, tp = params(name, mode)
    raw = noise((tp.num_pulses, tp.num_samples), 5)
    want = jrda.focus_rda(jnp.asarray(raw), jp)
    got = rda.focus_rda(torch.from_numpy(raw), tp)
    for f in rda.RdaProducts._fields:
        assert getattr(got, f).dtype == torch.complex64
        assert rel(getattr(got, f), getattr(want, f)) < 1e-6, f


@pytest.mark.parametrize("n_az", [256, 255])
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_focus_rda_without_intermediates_equals_the_shifted_route(mode,
                                                                  n_az):
    """The natural-order transforms with the kernel reading Doppler row
    (p + n_az // 2) mod n_az give the shifted route's image, even and odd
    n_az, and keep no viewer plane."""
    _, tp = params("satellite_stripmap", mode, n_az=n_az)
    raw = torch.from_numpy(noise((n_az, tp.num_samples), 9))
    want = rda.focus_rda(raw, tp)
    got = rda.focus_rda(raw, tp, intermediates=False)
    assert got[1:] == (None, None, None, None)
    assert rel(got.image, want.image) < 1e-6


def random_rows(seed: int):
    """An affine range axis r and per-row delta_R factors g, as the RDA's,
    at random scale: up to ~600 cells of migration."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 3000))
    r0, dr = rng.uniform(1e3, 1e6), rng.uniform(0.05, 5.0)
    r = torch.from_numpy((np.arange(n) - n / 2) * dr + r0)
    g = torch.from_numpy(np.concatenate([
        [0.0], rng.uniform(0.0, 600 * dr / r0, 40)]))[:, None]
    return r, g


def closed_form_interval(r: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """csrc/rcmc_kernel.cu's search in PyTorch: the interval of each cell x
    = r(j) on the source grid s(m) = r(m) - r(m) g of each row of ``g``
    ((n_az, 1)), estimated in closed form (s is affine in m) and moved
    while s(m + 1) <= x or s(m) > x. (n_az, n) int64."""
    n = r.shape[0]
    r0 = r[0]
    step = (r[-1] - r0) / (n - 1)
    a = 1.0 / (step * (1.0 - g))
    b = r0 / step
    x = r[None, :]

    def s(m):
        return r[m] - r[m] * g
    m = (x * a - b).clamp(0.0, n - 2.0).floor().to(torch.int64)
    while bool((up := (m < n - 2) & (s(m + 1) <= x)).any()):
        m = m + up.to(torch.int64)
    while bool((down := (m > 0) & (s(m) > x)).any()):
        m = m - down.to(torch.int64)
    return m


@pytest.mark.parametrize("seed", range(8))
def test_exact_interval_equals_searchsorted(seed):
    """The kernel's closed-form interval is searchsorted's, clipped to [0,
    n - 2], on every cell, in and outside the source grid."""
    r, g = random_rows(seed)
    n = r.shape[0]
    got = closed_form_interval(r, g)
    src = r[None, :] - r[None, :] * g
    want = torch.searchsorted(src, r.expand(src.shape).contiguous(),
                              right=True) - 1
    assert torch.equal(got, want.clamp(0, max(n - 2, 0)))


@pytest.mark.parametrize("row_shift", ["shifted", "natural"])
@pytest.mark.parametrize("name", CONFIGS)
def test_rcmc_filter_plain_matches_rcmc_times_h(name, row_shift):
    """The kernel's plain version: :func:`rda.rcmc` ('exact') on the grids,
    then H, rows in either order."""
    _, tp = params(name)
    n_az = tp.num_pulses
    d, h, r = rda.rda_grids(tp)
    rd = torch.from_numpy(noise((n_az, tp.num_samples), 11))
    want_rcmc = rda.rcmc(rd, d, r, "exact")
    want = want_rcmc * h
    shift = n_az // 2 if row_shift == "natural" else 0
    t = rda.rcmc_tables(tp, torch.device("cpu"))
    out, v = rcmc_kernel.rcmc_filter(
        torch.roll(rd, -shift, 0), t.r, t.fd, lam2=t.lam2, den=t.den,
        hk=t.hk, row_shift=shift, keep=True)
    assert rel(torch.roll(v, shift, 0), want_rcmc) < 1e-6
    assert rel(torch.roll(out, shift, 0), want) < 1e-6


def test_rcmc_zeroed_counts_cells_outside_the_window():
    """``rda.rcmc_zeroed`` counts the zero-filled cells, only with device
    counts on; ``rda.rcmc_rows`` the rows."""
    _, tp = params("airborne_vehicle")
    t = rda.rcmc_tables(tp, torch.device("cpu"))
    rd = torch.from_numpy(noise((tp.num_pulses, tp.num_samples), 13))
    kw = dict(lam2=t.lam2, den=t.den, hk=t.hk)
    with profiling.recording() as rec:
        out, v = rcmc_kernel.rcmc_filter(rd, t.r, t.fd, keep=True, **kw)
    # the source of a zeroed cell lies past the grid's far end
    g, _ = rcmc_kernel.row_factors(t.fd, tp.num_pulses, 0, t.lam2, t.den,
                                   t.hk)
    last = t.r[-1] - t.r[-1] * g
    want = int((t.r[None, :] > last).sum())
    assert want > 0
    assert rec.counters == {"rda.rcmc_rows": tp.num_pulses,
                            "rda.rcmc_zeroed": want}
    assert int((v == 0).sum()) >= want
    with profiling.recording(device_counts=False) as rec:
        rcmc_kernel.rcmc_filter(rd, t.r, t.fd, **kw)
    assert rec.counters == {"rda.rcmc_rows": tp.num_pulses}


@pytest.mark.parametrize("algorithm", ["rda", "csa"])
@pytest.mark.parametrize("name", CONFIGS)
def test_stripmap_run_matches_reference(name, algorithm):
    """The whole noise-free collect on both branches: raw, image, axes and
    SNR against the JAX package's ``stripmap.run``."""
    jsc, sc = small(jcfg, name, algorithm), small(tcfg, name, algorithm)
    want = jstripmap.run(jsc, jtargets.destroyer().rotate_z(90.0),
                         avg_rcs=50000.0)
    got = stripmap.run(sc, targets.destroyer().rotate_z(90.0),
                       avg_rcs=50000.0, device="cpu")
    assert rel(got.raw, want.raw) < 1e-5
    assert rel(got.image, want.image) < 1e-5
    assert got.snr_db == pytest.approx(want.snr_db, rel=1e-12)
    np.testing.assert_allclose(got.range_axis, want.range_axis, rtol=1e-12)
    np.testing.assert_allclose(got.cross_range, want.cross_range,
                               rtol=1e-12, atol=1e-9)
    if algorithm == "csa":
        assert got.intermediates is None and got.doppler_axis is None
    else:
        np.testing.assert_array_equal(got.doppler_axis, want.doppler_axis)
        for f in rda.RdaProducts._fields:
            assert rel(getattr(got.intermediates, f),
                       getattr(want.intermediates, f)) < 1e-5, f


def test_stripmap_noise_is_the_radar_equations():
    """With a seed the raw gains thermal noise and K clutter at the
    reference's powers (different draws: powers, not samples, compare)
    and the image keeps its brightest pixel (within a cell: the target
    lies between two pulses); the same seed gives the same raw."""
    sc = small(tcfg, "satellite_stripmap")
    tgt = targets.point_target((0.0, 0.0, 0.0), 1e4)
    clean = stripmap.run(sc, tgt, device="cpu")
    noisy = stripmap.run(sc, tgt, seed=3, avg_rcs=1e8, device="cpu")
    again, _, _, _ = stripmap.simulate_raw(sc, tgt, seed=3, avg_rcs=1e8,
                                           device="cpu")
    assert torch.equal(noisy.raw, again)
    ps = float((clean.raw.abs() ** 2).mean())
    pn = float(((noisy.raw - clean.raw).abs() ** 2).mean())
    want = ps * (10 ** (-noisy.snr_db / 10) + 10 ** (-sc.noise.scr_db / 10))
    assert pn == pytest.approx(want, rel=0.05)
    n_s = clean.image.shape[1]
    pc, pm = int(clean.image.abs().argmax()), int(noisy.image.abs().argmax())
    assert abs(pc // n_s - pm // n_s) <= 1 and abs(pc % n_s - pm % n_s) <= 1


def test_stripmap_focus_of_a_held_raw_and_its_record():
    """``focus`` of a held raw: the SLC of ``run``, the spans under
    ``focus`` and the rows counted; without intermediates no viewer
    plane."""
    sc = small(tcfg, "satellite_stripmap")
    tgt = targets.destroyer().rotate_z(90.0)
    raw, _, t0, _ = stripmap.simulate_raw(sc, tgt, device="cpu")
    with profiling.recording() as rec:
        slc, prod = stripmap.focus(raw, sc, t0, intermediates=False)
    assert prod is None
    full = stripmap.run(sc, tgt, device="cpu")
    assert rel(slc, full.image) < 1e-6
    tree = rec.tree()
    assert [k for k in tree] == ["focus", "focus/focus.range",
                                 "focus/focus.azimuth", "focus/focus.rcmc",
                                 "focus/focus.compress"]
    assert all(n == 1 for n, _ in tree.values())
    assert rec.counters["rda.rcmc_rows"] == raw.shape[0]
    assert rec.counters["rda.rcmc_zeroed"] > 0
    csa = sc.replace(processing=dataclasses.replace(sc.processing,
                                                    algorithm="csa"))
    with profiling.recording() as rec:
        slc, prod = stripmap.focus(raw, csa, t0)
    assert prod is None and slc.shape == raw.shape
    assert list(rec.tree()) == ["focus", "focus/focus.csa"]


def test_stripmap_refuses_an_unknown_algorithm_and_needs_a_device():
    sc = small(tcfg, "satellite_stripmap")
    bp = sc.replace(processing=dataclasses.replace(sc.processing,
                                                   algorithm="bp"))
    raw = torch.zeros((4, 8), dtype=torch.complex64)
    with pytest.raises(ValueError, match="unknown algorithm 'bp'"):
        stripmap.focus(raw, bp, 0.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            stripmap.run(sc, targets.point_target())
