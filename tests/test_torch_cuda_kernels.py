"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card: the GMTI and CSA kernels (K1g, K2 pair, K3g, K4, the raw
balance; K1, K2 single and K3, also bit for bit against their two-channel
twins) at 256^2 and at the slice's 4096^2, K3 and K3g also on rectangular
planes, twice for the same bits and at their columns' edges, the fast-BP
recentre kernels at nfft 16,384 and at the VideoSAR reference shape
(2,500 x 22,004 samples, nfft 32,768, presum 4), the fast-BP accumulate
kernels on synthetic operands and at the VideoSAR full width, and the
NUFFT echo's spread (both orders) and FFT-conv kernels and the direct-echo
kernel at small shapes and at the full-scale GMTI chain's (512-pulse
chunks, nfft 65,536), with the freq and pallas echo backends end to end on
the card. Marked ``cuda``: they skip
where no CUDA device is present (the kernels have no CPU mode). On a GPU
machine: ``python -m pytest tests/test_torch_cuda_kernels.py -q``."""

import dataclasses

import numpy as np
import pytest
import torch

from nis_sar_amtigmti_video_tpu_torch import config
from nis_sar_amtigmti_video_tpu_torch.gmti import fused
from nis_sar_amtigmti_video_tpu_torch.gmti.cfar import CfarParams
from nis_sar_amtigmti_video_tpu_torch.models import gmti, videosar
from nis_sar_amtigmti_video_tpu_torch.ops import csa
from nis_sar_amtigmti_video_tpu_torch.geometry import orbit
from nis_sar_amtigmti_video_tpu_torch.ops import bp, bp_fast
from nis_sar_amtigmti_video_tpu_torch.ops import echo, echo_freq
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (bp_factor_kernel,
                                                       bp_kernel, csa_kernel,
                                                       echo_kernel,
                                                       fft_kernel,
                                                       gmti_kernel,
                                                       spread_kernel)
from nis_sar_amtigmti_video_tpu_torch.ops.echo import window_start_time
from nis_sar_amtigmti_video_tpu_torch.scene import targets

pytestmark = pytest.mark.cuda
CP = CfarParams()
H_OUT, H_IN = CP.guard + CP.train, CP.guard


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _factors(n, dev):
    """The slice's CSA factors at (n, n) or at shape n."""
    n_az, n_rg = (n, n) if isinstance(n, int) else n
    sc = config.ati_dpca()
    r = dataclasses.replace(sc.radar, bandwidth_hz=120e6, pulse_width_s=2e-6,
                            fs_hz=150e6)
    g = sc.geometry
    return csa.csa_factors(csa.CsaParams(
        wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
        prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m,
        t_start_fast=2.0 * g.slant_range_m / 299792458.0 - 2e-6,
        num_pulses=n_az, num_samples=n_rg), dev)


def _planes(n, dev, seed=0):
    """Four seeded planes, (n, n) or of shape n."""
    rng = np.random.default_rng(seed)
    shape = (n, n) if isinstance(n, int) else n
    x1r, x1i, n2r, n2i = (rng.standard_normal(shape, dtype=np.float32)
                          for _ in range(4))
    c, s = np.float32(np.cos(0.31)), np.float32(np.sin(0.31))
    return [torch.from_numpy(v).to(dev) for v in
            (x1r, x1i, c * x1r - s * x1i + 0.05 * n2r,
             s * x1r + c * x1i + 0.05 * n2i)]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


# the column pass's shapes: square, one tile wide, one tile of rows per
# block, and a cluster of 4 over rectangular planes
COLUMN_SHAPES = [256, 4096, (4096, 64), (64, 4096), (1024, 4096)]


@pytest.mark.parametrize("n", COLUMN_SHAPES)
def test_k1g_matches_plain(dev, n):
    f, x = _factors(n, dev), _planes(n, dev)
    before = gmti_kernel.k1_gmti_planes.launches
    got = gmti_kernel.k1_gmti_planes(*x, f)
    torch.cuda.synchronize()
    assert gmti_kernel.k1_gmti_planes.launches == before + 1
    want = gmti_kernel.k1_gmti_plain(*x, f)
    for a, b in zip(got[:4], want[:4]):
        assert _rel(a, b) <= 1e-4
    assert _rel(torch.stack(got[4:]), torch.stack(want[4:])) <= 1e-4
    nb = gmti_kernel.k1_gmti_planes(*x, f, balance=False)
    assert float(nb[4]) == 0.0 and float(nb[5]) == 0.0


@pytest.mark.parametrize("n", [(4096, 256), (256, 64)])
def test_k1g_repeats_bit_for_bit(dev, n):
    """Two launches give the same bits in every plane and in the balance
    sums (no float atomics; the column sums reduce in a fixed order)."""
    f, x = _factors(n, dev), _planes(n, dev, 11)
    a = gmti_kernel.k1_gmti_planes(*x, f)
    b = gmti_kernel.k1_gmti_planes(*x, f)
    for i, (u, v) in enumerate(zip(a, b)):
        assert torch.equal(u, v), i


@pytest.mark.parametrize("n", [4096, (1024, 4096)])
def test_k1g_balance_angle(dev, n):
    """The balance phase atan2(xs_im, xs_re) of K1g's sums (from the
    spectra, by Parseval) within 1e-5 rad of the plain version's direct
    sum over the raw pair."""
    f, x = _factors(n, dev), _planes(n, dev, 12)
    got = gmti_kernel.k1_gmti_planes(*x, f)
    want = gmti_kernel.k1_gmti_plain(*x, f)
    d = float(torch.atan2(got[5], got[4]) - torch.atan2(want[5], want[4]))
    assert abs(d) <= 1e-5


@pytest.mark.parametrize("n", [256, 4096])
def test_k2_pair_matches_plain(dev, n):
    f, x = _factors(n, dev), _planes(n, dev, 1)
    got = csa_kernel.k2_pair_call(*x, f)
    want = csa_kernel.k2_pair_plain(*x, f)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-4


def _cal_cs(dev):
    return torch.tensor([np.cos(0.4), np.sin(0.4)], dtype=torch.float32,
                        device=dev)


@pytest.mark.parametrize("n", COLUMN_SHAPES)
def test_k3g_matches_plain(dev, n):
    x = _planes(n, dev, 2)
    cal_cs = _cal_cs(dev)
    got = gmti_kernel.k3_gmti_planes(*x, cal_cs, h_out=H_OUT, h_in=H_IN)
    want = gmti_kernel.k3_gmti_plain(*x, cal_cs, h_out=H_OUT, h_in=H_IN)
    for i in (0, 1, 2, 3, 5, 6, 7, 8, 9):
        assert got[i].shape == want[i].shape, i
        assert _rel(got[i], want[i]) <= 1e-4, i
    strong = want[5] > 1e-2 * want[5].max()
    d = torch.remainder(got[4] - want[4] + np.pi, 2 * np.pi) - np.pi
    assert float(d[strong].abs().max()) < 1e-3


@pytest.mark.parametrize("n", [(4096, 256), (256, 64)])
def test_k3g_repeats_bit_for_bit(dev, n):
    """Two launches give the same bits in every plane, peaks included (no
    float atomics; the peaks are a max in a fixed order)."""
    x = _planes(n, dev, 9)
    cal_cs = _cal_cs(dev)
    a = gmti_kernel.k3_gmti_planes(*x, cal_cs, h_out=H_OUT, h_in=H_IN)
    b = gmti_kernel.k3_gmti_planes(*x, cal_cs, h_out=H_OUT, h_in=H_IN)
    for i, (u, v) in enumerate(zip(a, b)):
        assert torch.equal(u, v), i


@pytest.mark.parametrize("n,h_out,h_in", [((4096, 64), H_OUT, H_IN),
                                          ((256, 64), H_OUT, H_IN),
                                          ((4096, 64), 40, 20)])
def test_k3g_box_sums_at_column_edges(dev, n, h_out, h_in):
    """The azimuth box sums at the first and last h_out rows of each column
    (windows clipped by the column's ends) and on both sides of every
    block's chunk of rows (windows closed over the rows other blocks hold:
    the halo copied beside the chunk, or, for half-widths beyond it, row by
    row) match the plain _window_sum."""
    x = _planes(n, dev, 10)
    cal_cs = _cal_cs(dev)
    got = gmti_kernel.k3_gmti_planes(*x, cal_cs, h_out=h_out, h_in=h_in)
    want = gmti_kernel.k3_gmti_plain(*x, cal_cs, h_out=h_out, h_in=h_in)
    n_az = got[0].shape[0]
    edges = [torch.arange(h_out), torch.arange(n_az - h_out, n_az)]
    plan = csa_kernel.column_plan(*got[0].shape, 2)
    chunk = n_az // plan.cluster // plan.cluster
    for b in range(chunk, n_az, chunk):
        edges.append(torch.arange(b - h_out, b + h_out))
    rows = torch.cat(edges).to(dev)
    for i in (7, 8):
        assert _rel(got[i][rows], want[i][rows]) <= 1e-4, i
        assert _rel(got[i], want[i]) <= 1e-4, i


@pytest.mark.parametrize("n", [256, 4096])
def test_k4_matches_plain(dev, n):
    x = _planes(n, dev, 3)
    cal_cs = torch.tensor([1.0, 0.0], device=dev)
    p3 = gmti_kernel.k3_gmti_plain(*x, cal_cs, h_out=H_OUT, h_in=H_IN)
    thr = 0.05 ** 2 * p3[9].max()
    args = (p3[7], p3[8], p3[6], p3[4], p3[5], thr)
    got = gmti_kernel.k4_epilogue_planes(*args, h_out=H_OUT, h_in=H_IN)
    want = gmti_kernel.k4_epilogue_plain(*args, h_out=H_OUT, h_in=H_IN)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-6)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=1e-4,
                               atol=1e-6 * float(want[3].abs().max()))


@pytest.mark.parametrize("n", COLUMN_SHAPES)
def test_k1_matches_plain_and_k1g(dev, n):
    """K1 vs its plain version, and bit for bit K1g's planes for the
    channel (k1_kernel<1, ...> and <2, ...> run the same code per channel
    on the same split of n_az)."""
    f, x = _factors(n, dev), _planes(n, dev, 4)
    before = csa_kernel.k1_call.launches
    got = csa_kernel.k1_call(x[0], x[1], f)
    torch.cuda.synchronize()
    assert csa_kernel.k1_call.launches == before + 1
    for a, b in zip(got, csa_kernel.k1_plain(x[0], x[1], f)):
        assert _rel(a, b) <= 1e-4
    pair = gmti_kernel.k1_gmti_planes(*x, f)
    for a, b in zip(got, pair[:2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [256, 4096])
def test_k2_matches_plain_and_pair(dev, n):
    f, x = _factors(n, dev), _planes(n, dev, 5)
    got = csa_kernel.k2_call(x[2], x[3], f)
    for a, b in zip(got, csa_kernel.k2_plain(x[2], x[3], f)):
        assert _rel(a, b) <= 1e-4
    pair = csa_kernel.k2_pair_call(*x, f)
    for a, b in zip(got, pair[2:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", COLUMN_SHAPES)
def test_k3_matches_plain_and_k3g(dev, n):
    x = _planes(n, dev, 6)
    got = csa_kernel.k3_call(x[0], x[1])
    for a, b in zip(got, csa_kernel.k3_plain(x[0], x[1])):
        assert _rel(a, b) <= 1e-4
    cal_cs = torch.tensor([1.0, 0.0], device=dev)
    g = gmti_kernel.k3_gmti_planes(*x, cal_cs, h_out=H_OUT, h_in=H_IN)
    for a, b in zip(got, g[:2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [256, 4096, (1024, 4096), (4096, 64),
                               (4097, 4096)])
def test_raw_balance_matches_plain_and_repeats(dev, n):
    x = _planes(n, dev, 7)
    before = gmti_kernel.raw_balance.launches
    got = gmti_kernel.raw_balance(*x)
    assert gmti_kernel.raw_balance.launches == before + 1
    assert all(g.dim() == 0 and g.dtype == torch.float32 for g in got)
    want = gmti_kernel.raw_balance_plain(*x)
    assert _rel(torch.stack(got), torch.stack(want)) <= 1e-4
    d = float(torch.atan2(got[1], got[0]) - torch.atan2(want[1], want[0]))
    assert abs(d) <= 1e-5
    again = gmti_kernel.raw_balance(*x)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_raw_balance_refuses_misaligned_and_ragged_planes(dev):
    x = _planes(256, dev, 7)
    base = torch.zeros(256 * 256 + 1, device=dev)
    off = base[1:].view(256, 256)               # 4 bytes past a boundary
    off.copy_(x[0])
    with pytest.raises(ValueError, match="16-byte"):
        gmti_kernel.raw_balance(off, *x[1:])
    with pytest.raises(ValueError, match="multiple of 4"):
        gmti_kernel.raw_balance(*(v[:, :254].contiguous() for v in x))


def test_csa_pallas_refuses_shapes_on_cuda(dev):
    """On the card fft_impl='pallas' at a shape the kernels refuse raises,
    naming the route that takes it, under path='composed' and 'auto'
    alike; with fft_impl='auto' both paths run torch.fft there."""
    f = csa.csa_factors(csa.CsaParams(
        wavelength_m=0.03, chirp_rate=6e13, fs_hz=150e6, prf_hz=6000.0,
        velocity_mps=7600.0, range_ref_m=6e5, t_start_fast=4e-3,
        num_pulses=192, num_samples=256), dev)
    x = torch.zeros((192, 256), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="fft_impl='auto'"):
        csa.apply_csa_fused(x, f, "pallas")
    sc = config.ati_dpca()
    sc = sc.replace(processing=dataclasses.replace(sc.processing,
                                                   fft_impl="pallas"))
    raw = torch.ones((2, 193, 256), dtype=torch.complex64, device=dev)
    before = csa_kernel.k1_call.launches
    for path in ("composed", "auto"):
        with pytest.raises(ValueError, match="fft_impl='auto'"):
            gmti.focus_and_products(raw, sc, 1e-3, path=path)
    sc = sc.replace(processing=dataclasses.replace(sc.processing,
                                                   fft_impl="auto"))
    for path in ("composed", "auto"):
        prod = gmti.focus_and_products(raw, sc, 1e-3, path=path)
        assert prod.slc1.shape == (192, 256)
    assert csa_kernel.k1_call.launches == before


def test_split_cpi_matches_fused2ch_on_card(dev):
    n = 256
    f = _factors(n, dev)
    x = _planes(n, dev, 8)
    before = gmti_kernel.raw_balance.launches
    a = fused.gmti_cpi(*x, f, cfar_params=CP, k1_impl="split")
    b = fused.gmti_cpi(*x, f, cfar_params=CP)
    assert gmti_kernel.raw_balance.launches == before + 1
    assert abs(float(a[4]) - float(b[4])) <= 1e-5
    for i in (0, 1, 2, 3, 6):
        assert _rel(a[i], b[i]) <= 1e-5, i


def test_gmti_cpi_kernel_path_matches_plain_path(dev):
    """The whole CPI on the card (four kernels) vs the same CPI on the CPU
    (four plain versions)."""
    n = 256
    f = _factors(n, dev)
    x = _planes(n, dev, 4)
    got = fused.gmti_cpi(*x, f, cfar_params=CP)
    want = fused.gmti_cpi(*(v.cpu() for v in x),
                          csa.CsaFactors(*(v.cpu() for v in f)),
                          cfar_params=CP)
    for a, b in zip(got[:4], want[:4]):
        assert _rel(a.cpu(), b) <= 1e-4
    assert abs(float(got[4]) - float(want[4])) < 1e-5
    torch.testing.assert_close(got[7].snr.cpu(), want[7].snr, rtol=5e-3,
                               atol=5e-3)


def test_auto_path_takes_kernels_on_cuda(dev):
    sc = config.ati_dpca()
    sc = sc.replace(processing=dataclasses.replace(sc.processing,
                                                   fft_impl="pallas"))
    rng = np.random.default_rng(5)
    raw = torch.from_numpy((rng.standard_normal((2, 257, 256))
                            + 1j * rng.standard_normal((2, 257, 256))
                            ).astype(np.complex64)).to(dev)
    before = csa_kernel.k2_pair_call.launches
    auto = gmti.focus_and_products(raw, sc, 1e-3, path="auto")
    assert csa_kernel.k2_pair_call.launches == before + 1
    comp = gmti.focus_and_products(raw, sc, 1e-3, path="composed")
    s = float(comp.slc1.abs().max())
    assert float((auto.slc1 - comp.slc1).abs().max()) / s < 2e-3


def test_wrappers_reject_bad_planes(dev):
    f, x = _factors(256, dev), _planes(256, dev)
    with pytest.raises(ValueError, match="contiguous"):
        gmti_kernel.k1_gmti_planes(x[0].t(), *x[1:], f)
    with pytest.raises(TypeError, match="float32"):
        csa_kernel.k2_pair_call(x[0].double(), *x[1:], f)
    with pytest.raises(ValueError, match="not supported"):
        gmti_kernel.k1_gmti_planes(*(v[:192] for v in x), f)
    with pytest.raises(ValueError, match="on cpu"):
        gmti_kernel.k1_gmti_planes(x[0], x[1].cpu(), *x[2:], f)


# --------------------------------------------------------------------------
# fast-BP recentre kernels
# --------------------------------------------------------------------------

BP_CASES = {"small": (12, 10000, 3, (40, 90)),        # nfft 16,384
            "reference": (2500, 22004, 4, (82, 97)),  # nfft 32,768
            "wide": (8, 40000, 2, (100, 300))}        # nfft 65,536
RING_OFFSETS = {"small": (3, 6, 9), "reference": (500, 1000, 2000),
                "wide": (2, 4, 6)}


def _bp_case(name, dev):
    """Seeded raw pulses on the card, the videosar geometry's float64
    trajectory there, BpParams and t_ref, presum d and band rows."""
    n_p, ns, d, rows = BP_CASES[name]
    sc = config.videosar()
    r = sc.radar
    traj = orbit.make_trajectory(sc.geometry,
                                 orbit.slow_time_grid(n_p / r.prf_hz, n_p))
    p = bp.BpParams(fc_hz=r.fc_hz, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
                    pulse_width_s=r.pulse_width_s, num_samples=ns)
    rng = np.random.default_rng(21)
    rc = torch.from_numpy((rng.standard_normal((n_p, ns))
                           + 1j * rng.standard_normal((n_p, ns))
                           ).astype(np.complex64)).to(dev)
    f64 = [torch.as_tensor(a, device=dev) for a in
           (traj.positions, traj.velocities, traj.times)]
    vf = torch.tensor([3.0, -2.0, 0.0], dtype=torch.float64, device=dev)
    t_ref = float(2.0 * np.linalg.norm(traj.positions, axis=1).mean()
                  / 299792458.0)
    return rc, f64, vf, p, t_ref, d, rows


@pytest.mark.parametrize("case", sorted(BP_CASES))
def test_forward_spectra_matches_plain(dev, case):
    rc, _, _, p, _, _, _ = _bp_case(case, dev)
    before = fft_kernel.forward_spectra.launches
    got = fft_kernel.forward_spectra(rc, p)
    torch.cuda.synchronize()
    assert fft_kernel.forward_spectra.launches == before + 1
    assert _rel(got, fft_kernel.forward_spectra_plain(rc, p)) <= 1e-4


def _pulses(n_p, ns, dev, seed=5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((n_p, ns))
                             + 1j * rng.standard_normal((n_p, ns))
                             ).astype(np.complex64)).to(dev)


@pytest.mark.parametrize("n_p", [1, 7, 500])
def test_forward_spectra_pulse_counts(dev, n_p):
    """The tails of the launch: one, a few and a ring step of pulses at the
    reference length."""
    _, _, _, p, _, _, _ = _bp_case("small", dev)
    p = dataclasses.replace(p, num_samples=22004)
    rc = _pulses(n_p, 22004, dev)
    assert _rel(fft_kernel.forward_spectra(rc, p),
                fft_kernel.forward_spectra_plain(rc, p)) <= 1e-4


@pytest.mark.parametrize("ns", [20480, 16384, 32768])
def test_forward_spectra_unpadded_lengths(dev, ns):
    """ns a multiple of 128 and ns = nfft (no padding), with and without
    the filter."""
    _, _, _, p, _, _, _ = _bp_case("small", dev)
    p = dataclasses.replace(p, num_samples=ns)
    rc = _pulses(5, ns, dev)
    for compress in (True, False):
        got = fft_kernel.forward_spectra(rc, p, filter_compress=compress)
        want = fft_kernel.forward_spectra_plain(rc, p,
                                                filter_compress=compress)
        assert _rel(got, want) <= 1e-4


def test_forward_spectra_batch_independent_and_repeatable(dev):
    """A pulse's spectrum depends on that pulse alone, bit for bit, and two
    launches give the same bits (the ring path relies on both)."""
    rc, _, _, p, _, _, _ = _bp_case("reference", dev)
    full = fft_kernel.forward_spectra(rc, p)
    assert torch.equal(fft_kernel.forward_spectra(rc, p), full)
    for a, b in ((0, 500), (700, 1207), (2499, 2500)):
        part = fft_kernel.forward_spectra(rc[a:b].contiguous(), p)
        assert torch.equal(part, full[a:b]), (a, b)


@pytest.mark.parametrize("case", sorted(BP_CASES))
def test_recentre_kernels_match_plain(dev, case):
    rc, traj, vf, p, t_ref, d, rows = _bp_case(case, dev)
    want = fft_kernel.recenter_presum_plain(rc, *traj, vf, p, d, t_ref,
                                            out_rows=rows)
    fused = fft_kernel.recenter_presum(rc, *traj, vf, p, d, t_ref,
                                       out_rows=rows)
    assert fused[0].shape == want[0].shape
    assert _rel(fused[0], want[0]) <= 1e-4
    for a, b in zip(fused[1:], want[1:]):
        assert torch.equal(a, b)
    spec = fft_kernel.forward_spectra(rc, p)
    split = fft_kernel.recentre_from_spectra(spec, *traj, vf, p, d, t_ref,
                                             out_rows=rows)
    plain = fft_kernel.recentre_from_spectra_plain(spec, *traj, vf, p, d,
                                                   t_ref, out_rows=rows)
    assert _rel(split[0], plain[0]) <= 1e-4
    assert _rel(split[0], fused[0]) <= 1e-4
    # a ragged last group (P % d != 0) outside ring mode
    rag = fft_kernel.recenter_presum(rc[:-1], *(t[:-1] for t in traj), vf,
                                     p, d, t_ref, out_rows=rows)
    rag_w = fft_kernel.recenter_presum_plain(rc[:-1], *(t[:-1] for t in traj),
                                             vf, p, d, t_ref, out_rows=rows)
    assert _rel(rag[0], rag_w[0]) <= 1e-4


@pytest.mark.parametrize("case", sorted(BP_CASES))
def test_ring_is_bit_identical(dev, case):
    rc, traj, vf, p, t_ref, d, rows = _bp_case(case, dev)
    spec = fft_kernel.forward_spectra(rc, p)
    want = fft_kernel.recentre_from_spectra(spec, *traj, vf, p, d, t_ref,
                                            out_rows=rows)[0]
    for off in RING_OFFSETS[case]:
        got = fft_kernel.recentre_from_spectra(
            torch.roll(spec, off, 0), *traj, vf, p, d, t_ref, out_rows=rows,
            ring_offset=off)[0]
        assert torch.equal(got, want), off


# --------------------------------------------------------------------------
# fast-BP accumulate kernels
# --------------------------------------------------------------------------

def _acc_operands(dev, n_p, ny, nx, w, seed, scales, stride=1, nx_c=0,
                  sub_raw=0):
    """tests/test_bp_fast.py's synthetic accumulate operands, on the card:
    band_start 7 of 512 samples per pulse."""
    plan = bp_fast.FastBpPlan(ny_i=ny, nx_i=nx, w_win=w, stride=stride,
                              band_start=7, nfft=512, dx_m=1.0, t_ref=1e-3,
                              n_org=100.0, sub_raw=sub_raw, nx_c=nx_c)
    u0_mid, pb_s, pc_s, bt_s, ct_s = scales
    rng = np.random.default_rng(seed)
    rc2 = (rng.standard_normal((n_p, 512))
           + 1j * rng.standard_normal((n_p, 512))).astype(np.complex64)
    f32 = np.float32
    ops = (rc2, (u0_mid + 2.0 * rng.standard_normal((n_p, ny))).astype(f32),
           rng.uniform(-3, 3, (n_p, ny)).astype(f32),
           (pb_s * rng.standard_normal((n_p, ny))).astype(f32),
           (pc_s * rng.standard_normal((n_p, ny))).astype(f32),
           (bt_s * rng.standard_normal(n_p)).astype(f32),
           (ct_s * rng.standard_normal(n_p)).astype(f32))
    return tuple(torch.from_numpy(a).to(dev) for a in ops), plan


def _collect_operands(dev, factor):
    """Full width: config.videosar()'s first CPI of seeded raw pulses
    through the fused recentre kernel and the coefficient fit, with the
    collect's 64-sample-window plan (pixel) or the first CPI's factor plan;
    the accumulate sees a band_start relative to the kernel's band rows."""
    sc = config.videosar()
    g, r, v = sc.geometry, sc.radar, sc.video
    opts = videosar.spotlight_echo_opts(
        sc, videosar.antenna_length_for_swath(sc, sc.processing.bp_scene_size_m))
    t0 = window_start_time(g.slant_range_m, opts, sc.collect.window_length_s,
                           "centered")
    p = videosar.bp_params_for(sc, opts)
    d = bp.presum_factor(p, r.prf_hz, r.wavelength_m, g.slant_range_m,
                         g.effective_velocity_mps)
    cpi = v.cpi_pulses(r.prf_hz)
    traj = orbit.make_trajectory(g, np.linspace(
        -v.duration_s / 2.0, v.duration_s / 2.0, v.total_pulses(r.prf_hz)))
    n = cpi if factor else len(traj.times)
    plan = bp_fast.make_plan(p, traj.positions[:n], traj.times[:n], float(t0),
                             w_win=32 if factor else 64, factorize=factor)
    rng = np.random.default_rng(8)
    rc = torch.from_numpy((rng.standard_normal((cpi, opts.num_samples))
                           + 1j * rng.standard_normal((cpi, opts.num_samples))
                           ).astype(np.complex64)).to(dev)
    tr = [torch.as_tensor(a[:cpi], device=dev) for a in
          (traj.positions, traj.velocities, traj.times)]
    vf = torch.tensor([3.0, -2.0, 0.0], dtype=torch.float64, device=dev)
    rows = bp_fast.band_rows(plan)
    t_mean = tr[2].mean()
    rc2, pos2, vel2, t2 = fft_kernel.recenter_presum(
        rc, *tr, vf, p, d, plan.t_ref, t_mean=t_mean, out_rows=rows)
    rdir, cdir, dy = bp_fast._frame_geometry(pos2[pos2.shape[0] // 2], p,
                                             plan)
    co = bp_fast._fit_coeffs(pos2, vel2, t2, vf, p, plan, t_mean, rdir, cdir,
                             dy, fit_stride=16 if factor else 0)
    plan_acc = dataclasses.replace(plan,
                                   band_start=plan.band_start - rows[0] * 128)
    return (rc2, *(c.contiguous() for c in co)), plan_acc, d


PIXEL_SCALES = (30.0, 0.01, 1e-4, 0.05, 1e-4)
FACTOR_SCALES = (15.0, 0.003, 3e-6, 0.01, 1e-5)


@pytest.mark.parametrize("n_p,stride", [(5, 1), (21, 2), (300, 1)])
def test_accumulate_pallas_matches_plain(dev, n_p, stride):
    """21 and 300 pulses are not multiples of the TPU kernel's 16-pulse
    block; two launches are bit-identical (no atomics)."""
    ops, plan = _acc_operands(dev, n_p, 128, 256, 64, 3, PIXEL_SCALES,
                              stride)
    before = bp_kernel.accumulate_pallas.launches
    got = bp_kernel.accumulate_pallas(*ops, plan)
    torch.cuda.synchronize()
    assert bp_kernel.accumulate_pallas.launches == before + 1
    assert _rel(got, bp_kernel.accumulate_pallas_plain(*ops, plan)) <= 1e-4
    assert torch.equal(got, bp_kernel.accumulate_pallas(*ops, plan))


@pytest.mark.parametrize("n_p,sub_p", [(11, 4), (130, 64)])
def test_accumulate_factor_matches_plain(dev, n_p, sub_p):
    """Ragged last sub-apertures (3 of 4 and 2 of 64 pulses)."""
    ops, plan = _acc_operands(dev, n_p, 128, 512, 32, 5, FACTOR_SCALES,
                              nx_c=128, sub_raw=sub_p)
    before = bp_factor_kernel.accumulate_factor_pallas.launches
    got = bp_factor_kernel.accumulate_factor_pallas(*ops, plan, sub_p)
    torch.cuda.synchronize()
    assert bp_factor_kernel.accumulate_factor_pallas.launches == before + 1
    want = bp_factor_kernel.accumulate_factor_pallas_plain(*ops, plan, sub_p)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("factor", [False, True])
def test_accumulate_kernels_match_plain_full_width(dev, factor):
    ops, plan, d = _collect_operands(dev, factor)
    assert plan.band_start > 0
    if factor:
        assert bp_factor_kernel.supported(plan)
        sub_p = plan.sub_raw // d
        got = bp_factor_kernel.accumulate_factor_pallas(*ops, plan, sub_p)
        want = bp_factor_kernel.accumulate_factor_pallas_plain(*ops, plan,
                                                               sub_p)
    else:
        assert bp_kernel.supported(plan)
        got = bp_kernel.accumulate_pallas(*ops, plan)
        want = bp_kernel.accumulate_pallas_plain(*ops, plan)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("sub_raw,nx_c", [(0, 128), (4, 64)])
def test_factor_kernel_route_raises_where_the_kernel_refuses(dev, sub_raw,
                                                             nx_c):
    """On the card, accumulate='factor_kernel' never runs a plain
    accumulate: a plan the kernel refuses raises, naming the route that
    takes it."""
    ops, plan = _acc_operands(dev, 11, 128, 512, 32, 5, FACTOR_SCALES,
                              nx_c=nx_c, sub_raw=sub_raw)
    before = bp_factor_kernel.accumulate_factor_pallas.launches
    with pytest.raises(ValueError, match="pick 'factor_pallas'"):
        bp_fast.accumulate_grid("factor_kernel", (*ops, plan), 1)
    assert bp_factor_kernel.accumulate_factor_pallas.launches == before


def test_run_fast_pallas_raises_on_a_plan_the_kernel_refuses(dev):
    """A 480 m scene at the 512-sample window gives a 400-row w_win=64
    plan; on the card 'fast_pallas' raises instead of running 'fast'."""
    sc = config.videosar()
    sc = sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                  pulse_width_s=2e-6, fs_hz=150e6,
                                  prf_hz=1000.0),
        collect=dataclasses.replace(sc.collect, window_length_s=512 / 150e6),
        processing=dataclasses.replace(sc.processing, bp_grid=48,
                                       bp_scene_size_m=480.0),
        video=config.VideoConfig(duration_s=1.0, fps=5.0, cpi_s=0.4))
    with pytest.raises(ValueError, match="pick 'fast'"):
        videosar.run(sc, targets.point_target((0.0, 0.0, 0.0), 50.0),
                     heading_deg=90.0, speed_mps=30.0, algorithm="mbp",
                     bp_backend="fast_pallas", device=dev)


def test_accumulate_wrappers_reject_bad_operands(dev):
    ops, plan = _acc_operands(dev, 5, 128, 256, 64, 3, PIXEL_SCALES)
    bad = {1: (lambda x: x.double(), TypeError, "float32"),
           2: (lambda x: x.cpu(), ValueError, "on cpu"),
           3: (lambda x: x[:, :64], ValueError, "shape"),
           4: (lambda x: x.t().contiguous().t(), ValueError, "contiguous"),
           0: (lambda x: x.to(torch.complex128), TypeError, "complex64")}
    for i, (f, err, match) in bad.items():
        args = list(ops)
        args[i] = f(args[i])
        with pytest.raises(err, match=match):
            bp_kernel.accumulate_pallas(*args, plan)
    fops, fplan = _acc_operands(dev, 11, 128, 512, 32, 5, FACTOR_SCALES,
                                nx_c=128, sub_raw=4)
    with pytest.raises(ValueError, match="shape"):
        bp_factor_kernel.accumulate_factor_pallas(fops[0], fops[1][:, :64],
                                                  *fops[2:], fplan, 4)


# --------------------------------------------------------------------------
# the NUFFT echo's spread and FFT-conv kernels, the direct-echo kernel
# --------------------------------------------------------------------------

def _spread_operands(dev, pc, grp, bg, win, n_sets, k, seed=0):
    """Sorted cells inside [0, win - k] with duplicates and dropped (-1)
    targets, and seeded values."""
    rng = np.random.default_rng(seed)
    c = np.sort(rng.integers(0, win - k + 1, (pc, grp, bg)), axis=-1)
    c[:, :, 1::7] = c[:, :, 0::7][:, :, :c[:, :, 1::7].shape[-1]]
    c[:, :, 3::11] = -1
    v = rng.normal(size=(pc, grp, n_sets, 2 * k, bg)).astype(np.float32)
    return (torch.from_numpy(c.astype(np.int32)).to(dev),
            torch.from_numpy(v).to(dev))


# (pc, grp, bg, win, n_sets, K): a small case; the full-scale chain's main
# and edge passes (512-pulse chunks of 5,036 targets in 16 groups)
SPREAD_CASES = {"small": (4, 3, 50, 256, 2, 6),
                "main": (512, 16, 315, 4096, 1, 8),
                "edge": (512, 16, 315, 2048, 2, 6)}


@pytest.mark.parametrize("qr", [False, True])
@pytest.mark.parametrize("case", sorted(SPREAD_CASES))
def test_spread_windows_match_plain(dev, case, qr):
    """The kernel at the case's shape against its plain version on up to
    16 pulses (the plain one-hot of a full chunk would be 51 GB); two
    launches bit-identical (no float atomics)."""
    pc, grp, bg, win, n_sets, k = SPREAD_CASES[case]
    c, v = _spread_operands(dev, pc, grp, bg, win, n_sets, k)
    def counts():
        return (spread_kernel.spread_windows_pallas.launches,
                spread_kernel.spread_windows_pallas.launches_qr)

    before = counts()
    got = spread_kernel.spread_windows_pallas(c, v, win, qr=qr)
    again = spread_kernel.spread_windows_pallas(c, v, win, qr=qr)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 2 * (not qr), before[1] + 2 * qr)
    assert torch.equal(got, again)
    cut = min(pc, 16)
    want = spread_kernel.spread_windows_plain(c[:cut], v[:cut], win, qr=qr)
    assert _rel(got[:cut], want) <= 1e-5


@pytest.mark.parametrize("qr", [False, True])
def test_spread_windows_one_cell_groups(dev, qr):
    """Whole groups on one cell (targets outside the grid clamp onto its
    edges), at the full-scale main pass's group size."""
    c, v = _spread_operands(dev, 24, 16, 315, 4096, 1, 8, seed=2)
    c[:, ::2] = 7
    c[:, 1::4] = 4088
    got = spread_kernel.spread_windows_pallas(c, v, 4096, qr=qr)
    want = spread_kernel.spread_windows_plain(c, v, 4096, qr=qr)
    assert _rel(got, want) <= 1e-5


def test_spread_windows_refuses_on_cuda(dev):
    c, v = _spread_operands(dev, 2, 2, 4000, 4096, 2, 8)
    with pytest.raises(ValueError, match="shared memory"):
        spread_kernel.spread_windows_pallas(c, v, 4096)
    c, v = _spread_operands(dev, 2, 2, 40, 256, 1, 4)
    with pytest.raises(TypeError, match="int32"):
        spread_kernel.spread_windows_pallas(c.long(), v, 256)


@pytest.mark.parametrize("nfft,l_in,rows", [(16384, 15000, (40, 100)),
                                            (65536, 50420, (187, 394))])
def test_fft_conv_matches_plain(dev, nfft, l_in, rows):
    """The conv kernel (clusters of 2 and 8 blocks) against torch.fft."""
    gen = torch.Generator(device=dev).manual_seed(3)
    fr, fi = (torch.randn((64, l_in), generator=gen, device=dev)
              for _ in range(2))
    filt = torch.complex(torch.randn(nfft, generator=gen, device=dev),
                         torch.randn(nfft, generator=gen, device=dev))
    before = fft_kernel.fft_conv_pallas.launches
    got = fft_kernel.fft_conv_pallas(fr, fi, filt, nfft, out_rows=rows)
    torch.cuda.synchronize()
    assert fft_kernel.fft_conv_pallas.launches == before + 1
    want = fft_kernel.fft_conv_plain(fr, fi, filt, nfft, out_rows=rows)
    assert got.shape == want.shape == (64, (rows[1] - rows[0]) * 128)
    assert _rel(got, want) <= 3e-5
    with pytest.raises(ValueError, match="unsupported"):
        fft_kernel.fft_conv_pallas(fr, fi, filt, 8192)


@pytest.mark.parametrize("waveform", ["slice", "full"])
def test_echo_accumulate_matches_plain(dev, waveform):
    """The direct-echo kernel against its plain version; 'full' is the
    500 MHz / 20 us waveform, whose phase reaches ~7.9e3 rad."""
    bw, tp, fs, ns = ((120e6, 2e-6, 150e6, 1024) if waveform == "slice"
                      else (500e6, 20e-6, 600e6, 13200))
    rng = np.random.default_rng(9)
    p, b = 24, 300
    t_fast = torch.from_numpy((np.arange(ns) / fs).astype(np.float32))
    tau = rng.uniform(-0.3 * tp, ns / fs, (p, b)).astype(np.float32)
    car = rng.uniform(-np.pi, np.pi, (p, b)).astype(np.float32)
    amp = rng.uniform(0.2, 1.5, (p, b)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (tau, car, amp)]
    kw = dict(k_pi=float(np.pi * bw / tp), shift=tp / 2, half=tp / 2)
    before = echo_kernel.echo_accumulate.launches
    got = echo_kernel.echo_accumulate(*args, t_fast.to(dev), **kw)
    torch.cuda.synchronize()
    assert echo_kernel.echo_accumulate.launches == before + 1
    want = echo_kernel.echo_accumulate_plain(*args, t_fast.to(dev), **kw)
    assert _rel(got, want) <= 2e-4


def _freq_kw(**kw):
    base = dict(fc_hz=9.65e9, chirp_rate=50e6 / 2e-6, pulse_width_s=2e-6,
                fs_hz=60e6, num_samples=4000, endpoint_grid=False,
                backend="freq")
    base.update(kw)
    return echo.EchoOpts(**base)


@pytest.mark.parametrize("spreader", ["auto", "dense_kernel_qr", "dense"])
def test_freq_synthesize_on_card_matches_cpu(dev, spreader):
    """synthesize on the card ('auto': the spread and conv kernels) against
    the CPU's scatter route on the same scalar fields (l_fft 16,384)."""
    rng = np.random.default_rng(11)
    p, b = 40, 200
    tau = np.sort(rng.uniform(5e-6, 5.5e-5, (p, b)), axis=1).astype(
        np.float32)
    car = rng.uniform(-np.pi, np.pi, (p, b)).astype(np.float32)
    amp = rng.uniform(0.5, 2.0, (p, b)).astype(np.float32)
    cpu = [torch.from_numpy(a) for a in (tau, car, amp)]
    want = echo_freq.synthesize(*cpu, _freq_kw(), spreader="scatter")
    def counts():
        return (spread_kernel.spread_windows_pallas.launches,
                spread_kernel.spread_windows_pallas.launches_qr,
                fft_kernel.fft_conv_pallas.launches)

    before = counts()
    got = echo_freq.synthesize(*(a.to(dev) for a in cpu), _freq_kw(),
                               spreader=spreader)
    torch.cuda.synchronize()
    rises = tuple(a - b for a, b in zip(counts(), before))
    # one chunk: the main spread, the shared two-set edge spread, the conv
    assert rises == {"auto": (2, 0, 1), "dense_kernel_qr": (0, 2, 1),
                     "dense": (0, 0, 1)}[spreader]
    assert _rel(got.cpu(), want) <= 2e-5


def test_freq_kernel_routes_refuse_on_card(dev):
    tau = torch.zeros((2, 3), device=dev)
    with pytest.raises(ValueError, match="l_fft"):
        echo_freq.synthesize(tau, tau, tau, _freq_kw(num_samples=360),
                             conv="pallas")


def test_pallas_echo_backend_on_card(dev):
    """backend='pallas' through simulate_two_channel on the card: the
    kernel launches and the raw equals the direct engine's."""
    sc = config.ati_dpca()
    sc = sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                  pulse_width_s=2e-6, fs_hz=150e6),
        collect=dataclasses.replace(sc.collect, integration_time_s=64 / 6000,
                                    window_length_s=512 / 150e6))
    sc_p = sc.replace(collect=dataclasses.replace(sc.collect,
                                                  echo_backend="pallas"))
    ship = targets.destroyer()
    before = echo_kernel.echo_accumulate.launches
    got = gmti.simulate_two_channel(sc_p, ship, (4.0, 0.0, 0.0),
                                    device=dev)[0]
    torch.cuda.synchronize()
    assert echo_kernel.echo_accumulate.launches == before + 1
    want = gmti.simulate_two_channel(sc, ship, (4.0, 0.0, 0.0),
                                     device=dev)[0]
    assert _rel(got, want) <= 2e-4
