"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card: the GMTI and CSA kernels (K1g, K2 pair, K3g, K4, the raw
balance; K1, K2 single and K3, also bit for bit against their two-channel
twins) at 256^2 and at the slice's 4096^2, K3 and K3g also on rectangular
planes, twice for the same bits and at their columns' edges, K2 and its
pair at every row length they take and on rectangular planes, twice and
with a passed axis plan for the same bits, the fast-BP recentre
kernels at nfft 16,384 and 65,536 and at the VideoSAR reference shape
(2,500 x 22,004 samples, nfft 32,768, presum 4; also each presum
group's rows from its own pulses alone, bit for bit), the fast-BP accumulate
kernels on synthetic operands (also on more tiles than the card holds at
once, twice for the same bits) and at the VideoSAR full width, and the
NUFFT echo's spread (both orders; cells sorted, reversed, nearly sorted,
on one cell, at the window's ends; the taps it forms, bit for bit against
the values PyTorch forms, small and at the full-scale chain's first chunk,
and no per-tap tensor on the echo's route), window placement (bit for bit,
at a small shape and at the full-scale chain's first chunk, both passes;
never the plain loop on the card) and FFT-conv kernels (every nfft, on
column views of wider planes, bands at both ends) and the direct-echo
kernel at small shapes and at the full-scale GMTI chain's (512-pulse
chunks, nfft 65,536), with the freq and pallas echo backends end to end on
the card; the CPI kernels also at the upstream's 7,199 x 13,200 and
7,200 x 13,200 (the factored azimuth) and at small odd shapes (chirp-z and
factored azimuth, mixed-radix range, tiles cut at the range edge), both
CPI routes, and the auto path
at the upstream's CPI with its spans and counters; HRWS's reconstruct_focus
on the card against the CPU, and the spread's count of dropped targets
against the CPU's. Marked ``cuda``: they skip
where no CUDA device is present (the kernels have no CPU mode). On a GPU
machine: ``python -m pytest tests/test_torch_cuda_kernels.py -q``."""

import dataclasses
import math

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
from nis_sar_amtigmti_video_tpu_torch.models.stripmap import echo_opts_for
from nis_sar_amtigmti_video_tpu_torch.ops.echo import window_start_time
from nis_sar_amtigmti_video_tpu_torch.scene import targets
from nis_sar_amtigmti_video_tpu_torch.scene.clutter import ocean_clutter_field

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
    plan = csa_kernel.azimuth_plan(x[0].shape[0], dev)
    passed = gmti_kernel.k1_gmti_planes(*x, f, plan=plan)
    assert all(torch.equal(a, b) for a, b in zip(got, passed))


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


# K2's shapes: every row length the kernels take (one instantiation of
# K2Plan<N> each), and n_az != n_rg both ways
K2_SHAPES = [64, 128, 256, 512, 1024, 2048, 4096, (64, 4096), (4096, 64)]


@pytest.mark.parametrize("n", K2_SHAPES)
def test_k2_pair_matches_plain(dev, n):
    """Within 1e-4 of the peak of the plain version; a second launch, and
    one given the range plan the wrapper would build, give the same
    bits."""
    f, x = _factors(n, dev), _planes(n, dev, 1)
    before = csa_kernel.k2_pair_call.launches
    got = csa_kernel.k2_pair_call(*x, f)
    torch.cuda.synchronize()
    assert csa_kernel.k2_pair_call.launches == before + 1
    want = csa_kernel.k2_pair_plain(*x, f)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-4
    again = csa_kernel.k2_pair_call(*x, f)
    plan = csa_kernel.range_plan(x[0].shape[1], dev)
    passed = csa_kernel.k2_pair_call(*x, f, plan=plan)
    for i, (a, b, c) in enumerate(zip(got, again, passed)):
        assert torch.equal(a, b) and torch.equal(a, c), i


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
    plan = csa_kernel.azimuth_plan(x[0].shape[0], dev)
    passed = gmti_kernel.k3_gmti_planes(*x, cal_cs, h_out=H_OUT, h_in=H_IN,
                                        plan=plan)
    assert all(torch.equal(a, b) for a, b in zip(got, passed))


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
    plan = csa_kernel.azimuth_plan(x[0].shape[0], dev)
    passed = csa_kernel.k1_call(x[0], x[1], f, plan=plan)
    assert all(torch.equal(a, b) for a, b in zip(got, passed))


@pytest.mark.parametrize("n", K2_SHAPES)
def test_k2_matches_plain_and_pair(dev, n):
    """K2 on each channel within 1e-4 of the peak of the plain version and
    bit for bit the pair's planes for it; a second launch and a passed
    range plan give the same bits."""
    f, x = _factors(n, dev), _planes(n, dev, 5)
    pair = csa_kernel.k2_pair_call(*x, f)
    plan = csa_kernel.range_plan(x[0].shape[1], dev)
    for ch in (0, 1):
        xr, xi = x[2 * ch], x[2 * ch + 1]
        before = csa_kernel.k2_call.launches
        got = csa_kernel.k2_call(xr, xi, f)
        torch.cuda.synchronize()
        assert csa_kernel.k2_call.launches == before + 1
        for a, b in zip(got, csa_kernel.k2_plain(xr, xi, f)):
            assert _rel(a, b) <= 1e-4, ch
        again = csa_kernel.k2_call(xr, xi, f)
        passed = csa_kernel.k2_call(xr, xi, f, plan=plan)
        for a, b, c, d in zip(got, pair[2 * ch:2 * ch + 2], again, passed):
            assert torch.equal(a, b), ch
            assert torch.equal(a, c) and torch.equal(a, d), ch


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
    """Planes off a 16-byte boundary and ragged views (not contiguous) are
    refused; contiguous planes of any width are taken (the last n mod 4
    floats by the last block)."""
    x = _planes(256, dev, 7)
    base = torch.zeros(256 * 256 + 1, device=dev)
    off = base[1:].view(256, 256)               # 4 bytes past a boundary
    off.copy_(x[0])
    with pytest.raises(ValueError, match="16-byte"):
        gmti_kernel.raw_balance(off, *x[1:])
    with pytest.raises(ValueError, match="contiguous"):
        gmti_kernel.raw_balance(*(v[:, :254] for v in x))
    for cols in (254, 165):
        y = [v[:, :cols].contiguous() for v in x]
        got = gmti_kernel.raw_balance(*y)
        want = gmti_kernel.raw_balance_plain(*y)
        assert _rel(torch.stack(got), torch.stack(want)) <= 1e-4


def test_csa_pallas_refuses_shapes_on_cuda(dev):
    """On the card fft_impl='pallas' at a shape the kernels refuse raises,
    naming the route that takes it, under path='composed' and 'auto'
    alike; with fft_impl='auto' both paths run torch.fft there."""
    f = csa.csa_factors(csa.CsaParams(
        wavelength_m=0.03, chirp_rate=6e13, fs_hz=150e6, prf_hz=6000.0,
        velocity_mps=7600.0, range_ref_m=6e5, t_start_fast=4e-3,
        num_pulses=192, num_samples=272), dev)
    x = torch.zeros((192, 272), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="fft_impl='auto'"):
        csa.apply_csa_fused(x, f, "pallas")
    sc = config.ati_dpca()
    sc = sc.replace(processing=dataclasses.replace(sc.processing,
                                                   fft_impl="pallas"))
    raw = torch.ones((2, 193, 272), dtype=torch.complex64, device=dev)
    before = csa_kernel.k1_call.launches
    for path in ("composed", "auto"):
        with pytest.raises(ValueError, match="fft_impl='auto'"):
            gmti.focus_and_products(raw, sc, 1e-3, path=path)
    sc = sc.replace(processing=dataclasses.replace(sc.processing,
                                                   fft_impl="auto"))
    for path in ("composed", "auto"):
        prod = gmti.focus_and_products(raw, sc, 1e-3, path=path)
        assert prod.slc1.shape == (192, 272)
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
        gmti_kernel.k1_gmti_planes(*(torch.zeros((192, 272), device=dev)
                                     for _ in range(4)), f)
    with pytest.raises(ValueError, match="on cpu"):
        gmti_kernel.k1_gmti_planes(x[0], x[1].cpu(), *x[2:], f)


# --------------------------------------------------------------------------
# the CPI kernels at sides that are not powers of two: azimuth by chirp-z,
# range by the mixed-radix plan, tiles cut at the range edge
# --------------------------------------------------------------------------

# the upstream's CPI after the one-pulse shift and unshifted, two small odd
# shapes (a prime azimuth over an odd range; 23 x 313... over 8 x 15), and
# the family's far corners, so every radix of the mixed-radix plan runs:
# 13^3 under the direct column pass at its longest (8,192 on a cluster of
# 16); 9 x 7 x 11 under chirp-z at 4,097; the longest row, 16,384 (16^3 x
# 4, a 128 KB row) under the shortest azimuth; 8,192 (16^3 x 2) under
# chirp-z at 8,191 (the 16,384-point stages)
ODD_SHAPES = [(7199, 13200), (7200, 13200), (97, 165), (313, 120),
              (8192, 2197), (4097, 693), (64, 16384), (8191, 8192)]
ODD_IDS = [f"{a}x{b}" for a, b in ODD_SHAPES]
# the chirp-z corners beside ODD_SHAPES' for the column kernels: the
# longest chirp-z side over the longest row, the shortest (m = 256, one
# block a cluster), and the shortest on 8,192 points (clusters of 16)
COLUMN_SHAPES_CZ = ODD_SHAPES + [(8191, 16384), (65, 64), (2049, 693)]
# the factored kind beside the upstream's 7,199 (23 x 313, Rader on 312) and
# 7,200 (32 x 225): each outer leg (8, 16, 32, 23), smooth local legs of one
# and two passes (15; 7 x 9), Rader's on 22, 28 and 256 points (16 x 16),
# a last tile cut at the range edge; and the chirp-z side 7,193
FACTORED_SHAPES = [(120, 165), (1008, 693), (96, 64), (184, 165),
                   (667, 120), (5911, 693), (7193, 13200)]
COLUMN_SHAPES = COLUMN_SHAPES_CZ + FACTORED_SHAPES


@pytest.mark.parametrize("n", COLUMN_SHAPES,
                         ids=[f"{a}x{b}" for a, b in COLUMN_SHAPES])
def test_column_kernels_match_plain_at_other_sides(dev, n):
    """K1g, K1, K3g and K3 against their plain versions (1e-4 of the peak;
    the ATI phase on strong pixels 1e-3 rad), the one-channel kernels bit
    for bit their pairs' channel, two launches (the second given the plan)
    the same bits; one launch a call (the chirp-z and factored transforms'
    too)."""
    assert csa_kernel.supported(*n)
    f, x = _factors(n, dev), _planes(n, dev, 21)
    plan = csa_kernel.azimuth_plan(n[0], dev)
    before = gmti_kernel.k1_gmti_planes.launches
    got = gmti_kernel.k1_gmti_planes(*x, f)
    assert gmti_kernel.k1_gmti_planes.launches == before + plan.launches
    want = gmti_kernel.k1_gmti_plain(*x, f)
    for a, b in zip(got[:4], want[:4]):
        assert _rel(a, b) <= 1e-4
    d = float(torch.atan2(got[5], got[4]) - torch.atan2(want[5], want[4]))
    assert abs(d) <= 1e-5
    again = gmti_kernel.k1_gmti_planes(*x, f, plan=plan)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    one = csa_kernel.k1_call(x[0], x[1], f)
    assert all(torch.equal(a, b) for a, b in zip(one, got[:2]))
    del got, want, again, one
    cal_cs = _cal_cs(dev)
    got = gmti_kernel.k3_gmti_planes(*x, cal_cs, h_out=H_OUT, h_in=H_IN)
    want = gmti_kernel.k3_gmti_plain(*x, cal_cs, h_out=H_OUT, h_in=H_IN)
    for i in (0, 1, 2, 3, 5, 6, 7, 8, 9):
        assert got[i].shape == want[i].shape, i
        assert _rel(got[i], want[i]) <= 1e-4, i
    strong = want[5] > 1e-2 * want[5].max()
    dph = torch.remainder(got[4] - want[4] + np.pi, 2 * np.pi) - np.pi
    assert float(dph[strong].abs().max()) < 1e-3
    del want
    one = csa_kernel.k3_call(x[0], x[1])
    assert all(torch.equal(a, b) for a, b in zip(one, got[:2]))


@pytest.mark.parametrize("n", [(4097, 693), (7193, 13200)],
                         ids=["4097x693", "7193x13200"])
def test_chirpz_column_kernels_hold_no_planes(dev, n):
    """A chirp-z K1g call and a chirp-z K3g call each count one launch and
    allocate no (m, n_rg) plane: the rise of the card's peak allocation
    during the call stays below its outputs plus the plan's tables (the
    chirp-z planes of the two-launch form were 4 x m x n_rg floats, 2.3x
    the outputs of K1g at 7,193 rows)."""
    f, x = _factors(n, dev), _planes(n, dev, 26)
    plan = csa_kernel.azimuth_plan(n[0], dev)
    assert plan.m == csa_kernel.chirpz_length(n[0]) > n[0]
    tables = sum(t.numel() * t.element_size()
                 for t in plan.tensors().values())
    planes = 4 * plan.m * n[1] * 4
    cal_cs = _cal_cs(dev)
    for name, kernel, call in (
            ("k1g", gmti_kernel.k1_gmti_planes,
             lambda: gmti_kernel.k1_gmti_planes(*x, f, plan=plan)),
            ("k3g", gmti_kernel.k3_gmti_planes,
             lambda: gmti_kernel.k3_gmti_planes(*x, cal_cs, h_out=H_OUT,
                                                h_in=H_IN, plan=plan))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        before = kernel.launches
        got = call()
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, name
        outputs = sum(t.numel() * t.element_size() for t in got)
        rise = torch.cuda.max_memory_allocated(dev) - base
        assert outputs <= rise < outputs + tables, (name, rise, outputs)
        assert rise < outputs + planes // 2, name
        del got


@pytest.mark.parametrize("n", [(7199, 13200), (7200, 13200)],
                         ids=["7199x13200", "7200x13200"])
def test_factored_column_kernels_hold_no_planes(dev, n):
    """The factored kind at the upstream's sides: K1g and K3g at 7,199 (23 x
    313, Rader) and K1 and K3 at 7,200 (32 x 225) each count one launch per
    call, allocate nothing beyond their outputs (the local transform and
    the gather stay in the cluster's shared memory), give the same bits on
    a second call, and the CPI and the formation stream count two azimuth
    transforms as prime-factor transforms and none by chirp-z."""
    from nis_sar_amtigmti_video_tpu_torch.utils import profiling
    f, x = _factors(n, dev), _planes(n, dev, 27)
    plan = csa_kernel.azimuth_plan(n[0], dev)
    assert plan.kind == "factored" and plan.m == n[0]
    tables = sum(t.numel() * t.element_size()
                 for t in plan.tensors().values())
    cal_cs = _cal_cs(dev)
    calls = (
        ("k1g", gmti_kernel.k1_gmti_planes,
         lambda: gmti_kernel.k1_gmti_planes(*x, f, plan=plan)),
        ("k3g", gmti_kernel.k3_gmti_planes,
         lambda: gmti_kernel.k3_gmti_planes(*x, cal_cs, h_out=H_OUT,
                                            h_in=H_IN, plan=plan))) \
        if n[0] == 7199 else (
        ("k1", csa_kernel.k1_call,
         lambda: csa_kernel.k1_call(x[0], x[1], f, plan=plan)),
        ("k3", csa_kernel.k3_call,
         lambda: csa_kernel.k3_call(x[0], x[1], plan=plan)))
    for name, kernel, call in calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        before = kernel.launches
        got = call()
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, name
        outputs = sum(t.numel() * t.element_size() for t in got)
        rise = torch.cuda.max_memory_allocated(dev) - base
        assert outputs <= rise < outputs + tables + (1 << 20), (name, rise)
        again = call()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
        del got, again
    if n[0] == 7199:
        cpi = fused.GmtiCpi(f)
        assert (cpi.factored_axes, cpi.chirpz_axes) == (2, 0)
    else:
        with profiling.recording() as rec:
            csa_kernel.apply_csa_pallas_planes(x[0], x[1], f)
        assert rec.counters == {"cpi.chirpz_axes": 0, "cpi.factored_axes": 2,
                                "cpi.mixed_radix_axes": 2}


@pytest.mark.parametrize("n", ODD_SHAPES, ids=ODD_IDS)
def test_k2_k4_and_balance_match_plain_at_other_sides(dev, n):
    """K2 pair and single (mixed-radix plan where n_rg takes it) against the
    plain version and bit for bit each other; K4 and the raw balance
    against theirs."""
    f, x = _factors(n, dev), _planes(n, dev, 22)
    got = csa_kernel.k2_pair_call(*x, f)
    want = csa_kernel.k2_pair_plain(*x, f)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-4
    del want
    plan = csa_kernel.range_plan(n[1], dev)
    for ch in (0, 1):
        one = csa_kernel.k2_call(x[2 * ch], x[2 * ch + 1], f, plan=plan)
        assert all(torch.equal(a, b)
                   for a, b in zip(one, got[2 * ch:2 * ch + 2])), ch
    del got, one
    bal = gmti_kernel.raw_balance(*x)
    want = gmti_kernel.raw_balance_plain(*x)
    assert _rel(torch.stack(bal), torch.stack(want)) <= 1e-4
    cal_cs = torch.tensor([1.0, 0.0], device=dev)
    p3 = gmti_kernel.k3_gmti_plain(*x, cal_cs, h_out=H_OUT, h_in=H_IN)
    thr = 0.05 ** 2 * p3[9].max()
    args = (p3[7], p3[8], p3[6], p3[4], p3[5], thr)
    got = gmti_kernel.k4_epilogue_planes(*args, h_out=H_OUT, h_in=H_IN)
    want = gmti_kernel.k4_epilogue_plain(*args, h_out=H_OUT, h_in=H_IN)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-6)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)


@pytest.mark.parametrize("k1_impl", ["fused2ch", "split"])
@pytest.mark.parametrize("n", ODD_SHAPES, ids=ODD_IDS)
def test_gmti_cpi_routes_at_other_sides(dev, n, k1_impl):
    """The whole CPI on the card, both routes, against the CPI of the
    plain versions (on the CPU at the small shapes, on the card at the
    upstream's): planes 1e-4 of the peak, cal 1e-5 rad, SNR as the 256^2
    test holds it."""
    f, x = _factors(n, dev), _planes(n, dev, 23)
    got = fused.gmti_cpi(*x, f, cfar_params=CP, k1_impl=k1_impl)
    if n[0] * n[1] < 10 ** 6:
        want = fused.gmti_cpi(*(v.cpu() for v in x),
                              csa.CsaFactors(*(v.cpu() for v in f)),
                              cfar_params=CP, k1_impl=k1_impl)
    else:
        want = _plain_cpi(x, f)
    for a, b in zip(got[:4], want[:4]):
        assert _rel(a.cpu(), b.cpu()) <= 1e-4
    assert abs(float(got[4]) - float(want[4])) < 1e-5
    torch.testing.assert_close(got[7].snr.cpu(), want[7].snr.cpu(),
                               rtol=5e-3, atol=5e-3)


def _plain_cpi(x, f):
    """gmti_cpi's four stages by their plain versions on x's device."""
    p = CP
    z = gmti_kernel.k1_gmti_plain(*x, f)
    z = csa_kernel.k2_pair_plain(*z[:4], f) + z[4:]
    cal = torch.atan2(z[5], z[4])
    cal_cs = torch.stack([torch.cos(cal), torch.sin(cal)])
    s = gmti_kernel.k3_gmti_plain(*z[:4], cal_cs, h_out=H_OUT, h_in=H_IN)
    thr = 0.05 ** 2 * torch.max(s[9])
    snr, phase, dmag, noise = gmti_kernel.k4_epilogue_plain(
        s[7], s[8], s[6], s[4], s[5], thr, h_out=H_OUT, h_in=H_IN)
    det = fused.cfar_mod.CfarResult(detections=snr > p.alpha, snr=snr,
                                    noise=noise)
    return (*s[:4], cal, phase, dmag, det)


def test_auto_path_takes_kernels_at_the_upstream_cpi(dev):
    """focus_and_products(path='auto') with fft_impl='pallas' runs K1g, K2
    pair, K3g and K4 at 7,199 x 13,200 (the upstream's raw after the
    one-pulse shift), with their spans and the counters: two azimuth
    transforms as prime-factor transforms (23 x 313), two range transforms
    by the mixed-radix plan; the slc against the composed route's."""
    from nis_sar_amtigmti_video_tpu_torch.utils import profiling
    sc = config.ati_dpca()
    sc = sc.replace(processing=dataclasses.replace(sc.processing,
                                                   fft_impl="pallas"))
    raw = torch.complex(
        torch.randn((2, 7200, 13200), generator=torch.Generator(
            device=dev).manual_seed(24), device=dev),
        torch.randn((2, 7200, 13200), generator=torch.Generator(
            device=dev).manual_seed(25), device=dev))
    before = [k.launches for k in (gmti_kernel.k1_gmti_planes,
                                   csa_kernel.k2_pair_call,
                                   gmti_kernel.k3_gmti_planes,
                                   gmti_kernel.k4_epilogue_planes)]
    with profiling.recording() as rec:
        auto = gmti.focus_and_products(raw, sc, 1e-3, path="auto")
    after = [k.launches for k in (gmti_kernel.k1_gmti_planes,
                                  csa_kernel.k2_pair_call,
                                  gmti_kernel.k3_gmti_planes,
                                  gmti_kernel.k4_epilogue_planes)]
    # one launch each, K1g's and K3g's factored transforms too
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1, 1]
    assert rec.counters == {"cpi.chirpz_axes": 0, "cpi.factored_axes": 2,
                            "cpi.mixed_radix_axes": 2}
    tree = rec.tree()
    for k in ("k1g", "k2", "k3g", "k4"):
        assert f"focus/focus.cpi_kernels/focus.{k}" in tree, k
    slc = auto.slc1
    del auto
    comp = gmti.focus_and_products(raw, sc.replace(
        processing=dataclasses.replace(sc.processing, fft_impl="auto")),
        1e-3, path="composed")
    assert float((slc - comp.slc1).abs().max()) \
        / float(comp.slc1.abs().max()) < 2e-3


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


@pytest.mark.parametrize("case", sorted(BP_CASES))
def test_recentre_groups_are_local(dev, case):
    """A presum group's rows depend on its own pulses alone: the pulses
    [a, b) of whole groups (with the whole launch's t_mean, on which the
    ramps depend) give rows [a/d, b/d) of the whole launch bit for bit,
    through both recentre kernels."""
    rc, traj, vf, p, t_ref, d, rows = _bp_case(case, dev)
    t_mean = traj[2].mean()
    spec = fft_kernel.forward_spectra(rc, p)
    fused = fft_kernel.recenter_presum(rc, *traj, vf, p, d, t_ref,
                                       out_rows=rows)[0]
    split = fft_kernel.recentre_from_spectra(spec, *traj, vf, p, d, t_ref,
                                             out_rows=rows)[0]
    n_g = rc.shape[0] // d
    for ga, gb in ((0, 1), (1, n_g - 1), (n_g // 2, n_g)):
        a, b = ga * d, gb * d
        sub = [t[a:b] for t in traj]
        got = fft_kernel.recenter_presum(rc[a:b], *sub, vf, p, d, t_ref,
                                         t_mean=t_mean, out_rows=rows)[0]
        assert torch.equal(got, fused[ga:gb]), (a, b)
        got = fft_kernel.recentre_from_spectra(spec[a:b], *sub, vf, p, d,
                                               t_ref, t_mean=t_mean,
                                               out_rows=rows)[0]
        assert torch.equal(got, split[ga:gb]), (a, b)


def test_recenter_presum_on_a_row_window_of_a_collect(dev):
    """The held-collect path hands the kernel a CPI that is a row window of
    a (25,000, 22,004) collect: read in place, the same bits as on a
    contiguous copy."""
    _, traj, vf, p, t_ref, d, rows = _bp_case("reference", dev)
    big = torch.empty((25000, 22004), dtype=torch.complex64, device=dev)
    torch.view_as_real(big).normal_(
        generator=torch.Generator(device=dev).manual_seed(3))
    a = 11500
    win = big[a:a + 2500]
    assert win.is_contiguous()
    assert win.data_ptr() == big.data_ptr() + 8 * a * 22004
    got = fft_kernel.recenter_presum(win, *traj, vf, p, d, t_ref,
                                     out_rows=rows)
    want = fft_kernel.recenter_presum(win.clone(), *traj, vf, p, d, t_ref,
                                      out_rows=rows)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_held_collect_run_equals_the_simulated_run(dev):
    """``videosar.run(raw=...)`` at config.videosar()'s full size on the
    kernel route: frames of the recorded collect equal the simulated
    per-segment run's bit for bit, one recentre + presum launch and one
    ``frame.held`` a frame."""
    from nis_sar_amtigmti_video_tpu_torch.utils import profiling
    sc = config.videosar()
    ship = targets.destroyer()
    kw = dict(heading_deg=45.0, speed_mps=15.0, device=dev)
    frames = [0, 22, 45]
    raw = videosar.record(sc, ship, seed=11, avg_rcs=5000.0, **kw)
    assert raw.shape == (25000, 22004)
    sim = videosar.run(sc, ship, bp_backend="fast_pallas",
                       noise_mode="per_segment", seed=11, avg_rcs=5000.0,
                       frame_indices=frames, **kw)
    before = fft_kernel.recenter_presum.launches
    with profiling.recording() as rec:
        held = videosar.run(sc, ship, bp_backend="fast_pallas", raw=raw,
                            frame_indices=frames, **kw)
    assert fft_kernel.recenter_presum.launches - before == 3
    assert rec.counters["frame.held"] == 3
    assert held.images.shape == (3, 512, 512)
    np.testing.assert_array_equal(held.images, sim.images)


# --------------------------------------------------------------------------
# fast-BP accumulate kernels
# --------------------------------------------------------------------------

def _acc_operands(dev, n_p, ny, nx, w, seed, scales, stride=1, nx_c=0,
                  sub_raw=0, n=512):
    """tests/test_bp_fast.py's synthetic accumulate operands, on the card:
    band_start 7 of ``n`` samples per pulse."""
    plan = bp_fast.FastBpPlan(ny_i=ny, nx_i=nx, w_win=w, stride=stride,
                              band_start=7, nfft=512, dx_m=1.0, t_ref=1e-3,
                              n_org=100.0, sub_raw=sub_raw, nx_c=nx_c)
    u0_mid, pb_s, pc_s, bt_s, ct_s = scales
    rng = np.random.default_rng(seed)
    rc2 = (rng.standard_normal((n_p, n))
           + 1j * rng.standard_normal((n_p, n))).astype(np.complex64)
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
    assert torch.equal(got, bp_factor_kernel.accumulate_factor_pallas(
        *ops, plan, sub_p))


@pytest.mark.parametrize("factor", [False, True])
def test_accumulate_kernels_second_wave_repeats_bit_for_bit(dev, factor):
    """More tiles than the card holds at once (one block an SM): W 64 on
    8 x 40 = 320 tiles of 24 pulses, W 32 on 40 row tiles x 13 sub-
    apertures of 16 pulses (the last of 8) = 520; the last wave is partial.
    Two launches give the same bits (fixed pulse order, no atomics)."""
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    if factor:
        ops, plan = _acc_operands(dev, 200, 1280, 512, 32, 5, FACTOR_SCALES,
                                  nx_c=128, sub_raw=16, n=1536)
        tiles = 1280 // 32 * -(-200 // 16)
        got = bp_factor_kernel.inner_sums(*ops, plan, 16)
        again = bp_factor_kernel.inner_sums(*ops, plan, 16)
        want = bp_factor_kernel.accumulate_factor_pallas_plain(*ops, plan, 16)
        img = bp_factor_kernel.accumulate_factor_pallas(*ops, plan, 16)
        assert _rel(img, want) <= 1e-4
    else:
        ops, plan = _acc_operands(dev, 24, 1280, 1024, 64, 3, PIXEL_SCALES,
                                  n=1536)
        tiles = 1024 // 128 * 1280 // 32
        got = bp_kernel.accumulate_pallas(*ops, plan)
        again = bp_kernel.accumulate_pallas(*ops, plan)
        assert _rel(got, bp_kernel.accumulate_pallas_plain(*ops, plan)) \
            <= 1e-4
    torch.cuda.synchronize()
    assert tiles > blocks and tiles % blocks
    assert torch.equal(got, again)


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


@pytest.mark.parametrize("taper_pow", [0, 2, 3])
@pytest.mark.parametrize("factor", [False, True])
def test_accumulate_kernels_match_plain_at_other_taper_powers(dev, factor,
                                                              taper_pow):
    """The plans use taper power 4; the kernel's epilogue takes any power
    in [0, 15] (an odd one meets the 1e-4 floor where the sine is
    negative, as in the plain version)."""
    if factor:
        ops, plan = _acc_operands(dev, 11, 128, 512, 32, 5, FACTOR_SCALES,
                                  nx_c=128, sub_raw=4)
        plan = dataclasses.replace(plan, taper_pow=taper_pow)
        got = bp_factor_kernel.accumulate_factor_pallas(*ops, plan, 4)
        want = bp_factor_kernel.accumulate_factor_pallas_plain(*ops, plan, 4)
    else:
        ops, plan = _acc_operands(dev, 21, 128, 256, 64, 3, PIXEL_SCALES)
        plan = dataclasses.replace(plan, taper_pow=taper_pow)
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
    # the epilogue's branch-free power by squaring takes 4 bits
    before = (bp_kernel.accumulate_pallas.launches,
              bp_factor_kernel.accumulate_factor_pallas.launches)
    with pytest.raises(ValueError, match="taper_pow 0 to 15, got 16"):
        bp_kernel.accumulate_pallas(
            *ops, dataclasses.replace(plan, taper_pow=16))
    with pytest.raises(ValueError, match="taper_pow 0 to 15, got 16"):
        bp_factor_kernel.accumulate_factor_pallas(
            *fops, dataclasses.replace(fplan, taper_pow=16), 4)
    assert before == (bp_kernel.accumulate_pallas.launches,
                      bp_factor_kernel.accumulate_factor_pallas.launches)


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


def _spread_kind(dev, kind, pc, grp, bg, win, n_sets, k, seed=4):
    """Cells of one kind at (pc, grp, bg): 'sorted' (duplicates, dropped
    targets), 'reversed', 'one cell' (every group on one cell, one target
    dropped), 'near sorted' (the sorted cells with adjacent swaps), 'edges'
    (cells at both ends of the window and beyond it); seeded values."""
    c, v = _spread_operands(dev, pc, grp, bg, win, n_sets, k, seed=seed)
    rng = np.random.default_rng(seed)
    if kind == "reversed":
        c = c.flip(-1).contiguous()
    elif kind == "one cell":
        c[:] = 11
        c[:, :, 5] = -1
    elif kind == "near sorted":
        i = torch.from_numpy(rng.integers(0, bg - 1, 40))
        c[:, :, i], c[:, :, i + 1] = c[:, :, i + 1].clone(), c[:, :, i].clone()
    elif kind == "edges":
        c[:, :, ::3] = torch.from_numpy(
            rng.integers(0, 3, c[:, :, ::3].shape).astype(np.int32)).to(dev)
        c[:, :, 1::3] = torch.from_numpy(rng.integers(
            win - 3, win + 2, c[:, :, 1::3].shape).astype(np.int32)).to(dev)
    return c, v


@pytest.mark.parametrize("qr", [False, True])
@pytest.mark.parametrize("kind", ["sorted", "reversed", "one cell",
                                  "near sorted", "edges"])
@pytest.mark.parametrize("part", ["main", "edge"])
def test_spread_windows_cell_orders(dev, part, kind, qr):
    """The kernel at the full-scale chain's main and edge shapes (the edge
    pass: two value sets sharing one cell list) for cells sorted, reversed,
    nearly sorted, all on one cell and at the window's ends, with dropped
    targets: within 1e-5 of the plain version on 16 pulses, two launches
    bit-identical."""
    pc, grp, bg, win, n_sets, k = SPREAD_CASES[part]
    c, v = _spread_kind(dev, kind, 32, grp, bg, win, n_sets, k)
    got = spread_kernel.spread_windows_pallas(c, v, win, qr=qr)
    again = spread_kernel.spread_windows_pallas(c, v, win, qr=qr)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = spread_kernel.spread_windows_plain(c[:16], v[:16], win, qr=qr)
    assert _rel(got[:16], want) <= 1e-5


@pytest.mark.parametrize("impl", ["pallas", "pallas_qr"])
def test_spread_dense_two_sets_with_offset_on_card(dev, impl):
    """_spread_dense through the kernel on the card, two value sets on one
    cell list with the second 37 cells on (the exact-edge pass's shape of
    operands), duplicate and out-of-grid cells, against the plain windows
    on the CPU."""
    rng = np.random.default_rng(7)
    i0 = np.sort(rng.integers(-40, 920, (6, 200)), axis=1).astype(np.int32)
    sets = [(rng.normal(size=(6, 200, 6)).astype(np.float32),
             rng.normal(size=(6, 200, 6)).astype(np.float32), off)
            for off in (0, 37)]

    def run(d, route):
        return echo_freq._spread_dense(
            torch.from_numpy(i0).to(d),
            [(torch.from_numpy(a).to(d), torch.from_numpy(b).to(d), o)
             for a, b, o in sets], 900, 512, 8, lo=64, impl=route)

    got = run(dev, impl)
    want = run(torch.device("cpu"), "xla")
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w) <= 1e-5


def test_spread_windows_refuses_too_many_taps(dev):
    c, v = _spread_operands(dev, 2, 2, 40, 256, 1, 31)
    before = spread_kernel.spread_windows_pallas.launches
    with pytest.raises(ValueError, match="taps"):
        spread_kernel.spread_windows_pallas(c, v, 256)
    assert spread_kernel.spread_windows_pallas.launches == before


def _wide_views(dev, num_p, l_in, gen, pad=(96, 40)):
    """(fr, fi): column views of wider seeded planes, as the padded field's."""
    wide = [torch.randn((num_p, pad[0] + l_in + pad[1]), generator=gen,
                        device=dev) for _ in range(2)]
    return [w[:, pad[0]:pad[0] + l_in] for w in wide]


@pytest.mark.parametrize("case", ["band at 0", "band at B1", "all rows",
                                  "short field"])
@pytest.mark.parametrize("nfft", [16384, 32768, 65536])
def test_fft_conv_on_views_at_every_nfft(dev, nfft, case):
    """The conv kernel on each plan (clusters of 4 and 8, 256 and 512
    threads) reading column views of wider planes through their row
    stride: bands at row 0, at row B1, every row, and a field shorter than
    nfft / 2; within 3e-5 of the plain version, two launches bit-identical,
    equal to the launch on contiguous copies."""
    b1 = nfft // 128
    l_in, rows = {"band at 0": (nfft - 3000, (0, 9)),
                  "band at B1": (nfft - 3000, (b1 - 9, b1)),
                  "all rows": (nfft, (0, b1)),
                  "short field": (nfft // 2 - 1000, (3, b1 // 2))}[case]
    gen = torch.Generator(device=dev).manual_seed(nfft + len(case))
    fr, fi = _wide_views(dev, 40, l_in, gen)
    filt = torch.complex(torch.randn(nfft, generator=gen, device=dev),
                         torch.randn(nfft, generator=gen, device=dev))
    before = fft_kernel.fft_conv_pallas.launches
    got = fft_kernel.fft_conv_pallas(fr, fi, filt, nfft, out_rows=rows)
    again = fft_kernel.fft_conv_pallas(fr, fi, filt, nfft, out_rows=rows)
    dense = fft_kernel.fft_conv_pallas(fr.contiguous(), fi.contiguous(), filt,
                                       nfft, out_rows=rows)
    torch.cuda.synchronize()
    assert fft_kernel.fft_conv_pallas.launches == before + 3
    assert torch.equal(got, again) and torch.equal(got, dense)
    want = fft_kernel.fft_conv_plain(fr, fi, filt, nfft, out_rows=rows)
    assert got.shape == want.shape == (40, (rows[1] - rows[0]) * 128)
    assert _rel(got, want) <= 3e-5


def test_fft_conv_refuses_strided_rows(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    fr, fi = _wide_views(dev, 4, 2 * 9000, gen)
    filt = torch.ones(16384, dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="rows are not contiguous"):
        fft_kernel.fft_conv_pallas(fr[:, ::2], fi[:, ::2], filt, 16384)


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


# the direct engine's fused route (echo_kernel.echo_direct, the 'jnp'
# backend on the card) at the spotlight waveform: 500 MHz, 20 us, fs 600
# MHz, 22,004 samples, stop-and-go, the sinc^2 antenna, the destroyer at
# 15 m/s, 40 pulses
C0 = 299792458.0
DIRECT_CASES = {
    "spotlight": {},
    "two channels": dict(offsets=(-1.5, 1.5)),
    "endpoint grid": dict(opts=dict(endpoint_grid=True)),
    "leading": dict(opts=dict(chirp_centering="leading")),
    "gate over the start": dict(edge="start"),
    "gate over the end": dict(edge="end"),
    "empty scene": dict(empty=True),
}


def _direct_operands(dev, case, n_p=40):
    """The spotlight collect's 40 pulses about broadside and the heading-
    60 destroyer at 15 m/s on ``dev`` (float64, as ``_phase_history``
    takes them), its echo options, Rx offsets and window start (centred,
    or a start that puts the gates over the window's first or last
    sample)."""
    c = DIRECT_CASES[case]
    sc = config.videosar()
    g = sc.geometry
    opts = dataclasses.replace(videosar.spotlight_echo_opts(
        sc, videosar.antenna_length_for_swath(sc, 500.0)),
        **c.get("opts", {}))
    traj = orbit.make_trajectory(
        g, (np.arange(n_p) - n_p / 2) / sc.radar.prf_hz)
    ship = targets.destroyer().rotate_z(60.0)
    if c.get("empty"):
        ship = targets.PointTargets(np.zeros((0, 3)), np.zeros(0), ())
    vel = (15.0 * math.cos(math.radians(60.0)),
           15.0 * math.sin(math.radians(60.0)), 0.0)
    win, tau_c = opts.num_samples / opts.fs_hz, 2.0 * g.slant_range_m / C0
    lo = tau_c + opts.chirp_shift - opts.half_width
    t0 = {None: window_start_time(g.slant_range_m, opts,
                                  sc.collect.window_length_s, "centered"),
          "start": lo + 0.3 * opts.pulse_width_s,
          "end": lo + opts.pulse_width_s - win - 0.3 * opts.pulse_width_s,
          }[c.get("edge")]
    return (echo._inputs(traj, ship, vel, dev), opts,
            list(c.get("offsets", (0.0,))), float(t0))


@pytest.mark.parametrize("case", sorted(DIRECT_CASES))
def test_direct_echo_kernel_matches_plain(dev, case):
    """The direct engine on the card (one echo_accumulate_kernel<true>
    launch a channel, the float64 geometry formed in the kernel) against
    its plain chunked code (_direct) on the same card tensors, channel by
    channel: within 2e-4 of the peak, as the kernel's 'pallas' form is held
    to its plain version; the launch count and the ``echo.direct`` counter
    rise by one a channel; the gate cases reach the window's edge."""
    from nis_sar_amtigmti_video_tpu_torch.utils import profiling
    args, opts, offs, t0 = _direct_operands(dev, case)
    t, p, v, pos, rcs, tv = args
    before = echo_kernel.echo_direct.launches
    with profiling.recording() as rec:
        got = echo._phase_history(*args, offs, t0, opts)
        torch.cuda.synchronize()
    assert echo_kernel.echo_direct.launches == before + len(offs)
    assert rec.counters == {"echo.direct": len(offs)}
    assert got.shape == (len(offs) * 40, opts.num_samples)
    if pos.shape[0] == 0:
        assert not bool(got.abs().any())
        return
    want = torch.cat([echo._direct(t, p, v, pos, echo._amplitudes(rcs, opts),
                                   tv, off, t0, opts) for off in offs])
    assert float(want.abs().max()) > 0
    assert _rel(got, want) <= 2e-4
    edge = DIRECT_CASES[case].get("edge")
    if edge is not None:
        assert float(got[:, 0 if edge == "start" else -1].abs().max()) > 0


def test_direct_echo_launches_only_its_kernel(dev):
    """The direct engine's device work on the card is one
    echo_accumulate_kernel<true> launch a channel and nothing else (its
    fast-time grid on the card from the first call)."""
    args, opts, _, t0 = _direct_operands(dev, "spotlight")
    echo._phase_history(*args, [-1.5, 1.5], t0, opts)
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        echo._phase_history(*args, [-1.5, 1.5], t0, opts)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2, kernels
    assert all("echo_accumulate_kernel<true>" in k for k in kernels), kernels


def test_direct_echo_refuses_what_the_kernel_does_not_take(dev):
    """echo_direct on the card raises, and launches nothing, for float32
    or non-contiguous pulses, targets on another device and a misshapen
    target velocity; it never falls back to the plain chain."""
    args, opts, offs, t0 = _direct_operands(dev, "spotlight")
    t, p, v, pos, rcs, tv = args
    before = echo_kernel.echo_direct.launches
    bad = {"float32 times": ((t.float(), p, v, pos, rcs, tv), TypeError),
           "strided positions": ((t, torch.cat([p, p], 1)[:, ::2], v, pos,
                                  rcs, tv), ValueError),
           "targets on the host": ((t, p, v, pos.cpu(), rcs, tv),
                                   ValueError),
           "velocity (1, 3)": ((t, p, v, pos, rcs, tv[None]), ValueError)}
    for name, (a, err) in bad.items():
        with pytest.raises(err):
            echo_kernel.echo_direct(*a, opts, rx_offsets=offs, t_start=t0)
    assert echo_kernel.echo_direct.launches == before


def test_segment_raw_has_no_host_sync_on_card(dev):
    """A VideoSAR segment (the spotlight collect's 500 pulses, echo and
    noise) from the device-resident trajectory and targets: no host
    synchronise once the run is set up (``set_sync_debug_mode('error')``),
    one direct launch a segment, and the echo within 2e-4 of the peak of
    the direct engine's plain code on the same rows."""
    from nis_sar_amtigmti_video_tpu_torch.video import scheduler
    sc = config.videosar()
    sched = scheduler.make_schedule(sc.video, sc.radar.prf_hz)
    step, seed = sched.step_pulses, 2 ** 33 + 5
    g = videosar._scene(sc, targets.destroyer(), sched, 60.0, 15.0, seed,
                        None, dev)
    videosar._segment_raw(sc, g, 0, step, seed, dev)    # the grid's copy
    torch.cuda.synchronize()
    before = echo_kernel.echo_direct.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        noisy = videosar._segment_raw(sc, g, 7, step, seed, dev)
        clean = videosar._segment_raw(sc, g._replace(snr_raw=None), 7, step,
                                      None, dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert echo_kernel.echo_direct.launches == before + 2
    assert noisy.shape == clean.shape == (step, g.opts.num_samples)
    assert bool(torch.isfinite(torch.view_as_real(noisy)).all())
    pos, vel, ts = videosar._window(g.on.traj, 7 * step, step)
    want = echo._direct(ts, pos, vel, g.on.tgt_pos,
                        echo._amplitudes(g.on.tgt_rcs, g.opts), g.on.tgt_vel,
                        0.0, g.t0, g.opts)
    assert _rel(clean, want) <= 2e-4


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
                fft_kernel.fft_conv_pallas.launches,
                spread_kernel.place_windows.launches,
                spread_kernel.spread_windows_pallas.launches_taps)

    before = counts()
    got = echo_freq.synthesize(*(a.to(dev) for a in cpu), _freq_kw(),
                               spreader=spreader)
    torch.cuda.synchronize()
    rises = tuple(a - b for a, b in zip(counts(), before))
    # one chunk: the main spread, the shared two-set edge spread (formed
    # taps on 'auto'), the conv, the main and edge placements (every dense
    # spreader)
    assert rises == {"auto": (0, 0, 1, 2, 2),
                     "dense_kernel_qr": (0, 2, 1, 2, 0),
                     "dense": (0, 0, 1, 2, 0)}[spreader]
    assert _rel(got.cpu(), want) <= 2e-5


def _formed_case(dev, case, seed=21):
    """(c_ok, ops, win, taps) of a formed-taps spread on synthetic operands:
    'es' (the main pass's ES taps), 'es weights' (amplitude 1: the windows
    are the weights), 'flanks' (both flanks of the full-scale waveform on
    one cell list), 'leading' and 'trailing' (one flank a spread), 'flank
    gate' (phase 0, amplitude 1: the windows are the gated flank weights),
    'flank phase' (tap 0 at the leading gate's edge, weight 1: the windows
    there are the rotated amplitudes). 8 pulses of 3 groups of 14 targets,
    40 of them (2 padded); the cells sorted with duplicates, dropped (-1)
    and at both ends of the window and past it; the isolated cases one
    target every K cells."""
    rng = np.random.default_rng(seed)
    pc, grp, num_b = 8, 3, 40
    bg = -(-num_b // grp)
    fs, t_edge = 600e6, 4.0 / 600e6
    if case.startswith("es"):
        taps = spread_kernel.EsTaps(8, 2.30 * 8)
    else:
        leading = {"leading": (True,), "trailing": (False,)}.get(
            case, (True, False))
        c2 = 0.0 if case == "flank gate" else (math.pi * 500e6 / 20e-6
                                               / fs ** 2)
        taps = spread_kernel.FlankTaps(6, fs, c2, t_edge, leading)
    k = taps.k_taps
    isolated = case in ("es weights", "flank gate", "flank phase")
    if isolated:
        win = bg * k + 64
        c = np.broadcast_to(np.arange(bg) * k, (pc, grp, bg)).copy()
    else:
        win = 256
        c = np.sort(rng.integers(0, win - k + 1, (pc, grp, bg)), axis=-1)
        c[:, :, 1::7] = c[:, :, 0::7][:, :, :c[:, :, 1::7].shape[-1]]
        c[:, :, 3::11] = -1
        c[:, :, 4::9] = rng.integers(0, 3, c[:, :, 4::9].shape)
        c[:, :, 6::9] = rng.integers(win - k, win + 3, c[:, :, 6::9].shape)
    amp = rng.normal(size=(2, pc, num_b))
    if case in ("es weights", "flank gate"):
        amp = np.stack([np.ones((pc, num_b)), np.zeros((pc, num_b))])
    if isinstance(taps, spread_kernel.EsTaps):
        frac = rng.uniform(0.0, 1.0, (pc, num_b))
        frac[:, ::5] = 0.0                  # u = K/2 at the last tap
        rows = [frac, *amp]
    else:
        rows = list(amp)
        for _ in taps.leading:
            # tap 0's flank-local time, around and inside both gate ends
            e0 = rng.uniform(-3e-12, 1.0 / fs, (pc, num_b))
            e0[:, ::4] = rng.choice([0.0, -5e-13, -1e-12, -2e-12, 1e-13],
                                    e0[:, ::4].shape)
            e0[:, 1::4] = t_edge - rng.integers(0, 6, e0[:, 1::4].shape) / fs \
                + rng.choice([0.0, 5e-13, 1e-12, 2e-12, -1e-13],
                             e0[:, 1::4].shape)
            c0, c1 = rng.uniform(-np.pi, np.pi, (2, pc, num_b))
            if case == "flank gate":
                c0[:] = c1[:] = 0.0
            elif case == "flank phase":
                e0[:] = 0.0
            rows += [e0, c0, c1]
    ops = torch.from_numpy(np.stack(rows, axis=1).astype(np.float32))
    return (torch.from_numpy(c.astype(np.int32)).to(dev), ops.to(dev), win,
            taps)


def _same_windows(got, want):
    """Bit for bit, with the first differing cells in the message."""
    a, b = got.view(torch.int32), want.view(torch.int32)
    bad = (a != b).nonzero()
    assert bad.shape[0] == 0, (
        f"{bad.shape[0]} of {a.numel()} window cells differ; first "
        + ", ".join(f"{tuple(i.tolist())}: {got[tuple(i)].item()!r} vs "
                    f"{want[tuple(i)].item()!r}" for i in bad[:6]))


@pytest.mark.parametrize("case", ["es", "es weights", "flanks", "leading",
                                  "trailing", "flank gate", "flank phase"])
def test_formed_taps_match_values_staging(dev, case):
    """The formed-taps stagings against the values staging fed the values
    PyTorch forms on the card from the same operands (the echo's operators
    before the kernel formed its taps), bit for bit, twice the same bits:
    dropped targets, cells at both window ends and past them, padded
    targets, the ES weights alone, the flank's gate and weight alone, its
    rotation alone."""
    c, ops, win, taps = _formed_case(dev, case)
    sw = spread_kernel.spread_windows_pallas
    before = (sw.launches, sw.launches_taps)
    got = sw(c, ops, win, taps=taps)
    again = sw(c, ops, win, taps=taps)
    vals = spread_kernel.pack_values(spread_kernel.tap_sets(ops, taps),
                                     c.shape[1])
    want = sw(c, vals, win)
    torch.cuda.synchronize()
    assert (sw.launches, sw.launches_taps) == (before[0] + 1, before[1] + 2)
    assert float(want.abs().max()) > 0
    _same_windows(got, want)
    _same_windows(again, got)


@pytest.fixture(scope="module")
def fullscale_fields(dev):
    """The full-scale chain's scalar fields of one 512-pulse chunk a
    channel (config.ati_dpca(): 13,200 samples, fs 600 MHz, Tp 20 us, the
    centred window; the destroyer turned by 90 degrees in 5,000 clutter
    points) and its echo options."""
    sc = config.ati_dpca()
    g, c = sc.geometry, sc.collect
    opts = dataclasses.replace(echo_opts_for(sc), backend="freq",
                               endpoint_grid=False)
    t0 = window_start_time(g.slant_range_m, opts, c.window_length_s,
                           "centered")
    scene = targets.PointTargets.concatenate(
        [targets.destroyer().rotate_z(90.0),
         ocean_clutter_field(np.random.default_rng(0))])
    traj = orbit.make_trajectory(g, orbit.slow_time_grid(
        512 / sc.radar.prf_hz, 512))
    fields = echo.scalar_fields(traj, scene, opts, t_start=t0,
                                rx_offsets=sc.channels.rx_offsets(),
                                device=dev)
    return fields, opts


@pytest.mark.parametrize("part", ["main", "edge"])
def test_formed_taps_match_values_staging_at_full_scale(dev, fullscale_fields,
                                                        part):
    """At the full-scale chain's first chunk (512 pulses, 16 groups of 315
    targets; win 4,096 and 2,048) the spread of the formed taps equals the
    values staging's of kernel_operands' values bit for bit."""
    fields, opts = fullscale_fields
    ops = echo_freq.kernel_operands(*fields, opts,
                                    **echo.synth_options(opts))
    if part == "main":
        (c, v, win), (c_t, o_t, win_t, taps) = (ops["spread main"],
                                                ops["spread main taps"])
    else:
        ((c, v, win),), ((c_t, o_t, win_t, taps),) = (ops["spread edge"],
                                                      ops["spread edge taps"])
    assert torch.equal(c, c_t) and win == win_t
    assert tuple(c.shape) == (512, 16, 315)
    got = spread_kernel.spread_windows_pallas(c_t, o_t, win_t, taps=taps)
    want = spread_kernel.spread_windows_pallas(c, v, win)
    torch.cuda.synchronize()
    _same_windows(got, want)


@pytest.mark.parametrize("flanks", ["shared", "apart"])
def test_synthesize_forms_no_tap_tensor_on_card(dev, monkeypatch, flanks):
    """On the card synthesize ('auto': the spread forms the taps) never
    forms a tap in PyTorch or packs a value tensor: ES weights, flank taps,
    tap sets and the packing raise if reached. Each chunk adds two formed-
    taps launches to ``echo.spread_taps`` (both flanks on one cell list) or
    three (one spread a flank) and none of values."""
    from nis_sar_amtigmti_video_tpu_torch.utils import profiling

    def per_tap(*a, **k):
        raise AssertionError("a per-tap tensor was formed on the card")

    for name in ("es_weights", "flank_taps", "tap_sets", "pack_values"):
        monkeypatch.setattr(spread_kernel, name, per_tap)
    rng = np.random.default_rng(14)
    p, b = 40, 200
    tau = np.sort(rng.uniform(5e-6, 5.5e-5, (p, b)), axis=1)
    fields = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in
              (tau, rng.uniform(-np.pi, np.pi, (p, b)),
               rng.uniform(0.5, 2.0, (p, b)))]
    opts = _freq_kw(pulse_width_s=2e-6 if flanks == "shared" else 2.01e-6)
    sw = spread_kernel.spread_windows_pallas
    before = (sw.launches, sw.launches_qr, sw.launches_taps)
    with profiling.recording() as rec:
        out = echo_freq.synthesize(*fields, opts, pulse_chunk=16)
    torch.cuda.synchronize()
    per_chunk = 2 if flanks == "shared" else 3
    assert rec.counters["echo.spread_taps"] == 3 * per_chunk
    assert (sw.launches, sw.launches_qr, sw.launches_taps) == (
        before[0], before[1], before[2] + 3 * per_chunk)
    assert bool(torch.isfinite(torch.view_as_real(out)).all())


def _place_calls(fields, opts, **kw):
    """The place_windows calls (wins, base, offsets, start, l_out,
    complex_out) of synthesize on ``fields``' first pulse chunk: the main
    pass's, then the exact-edge pass's."""
    n = echo_freq._plan(fields[0], opts, **kw).pulse_chunk
    calls, place = [], spread_kernel.place_windows

    def rec(*args):
        calls.append(args)
        return place(*args)

    rec.launches = 0          # the wrapper counts on what holds its name

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spread_kernel, "place_windows", rec)
        echo_freq.synthesize(*(f[:n] for f in fields), opts, **kw)
    torch.cuda.synchronize()
    return calls


def _small_place_calls(dev):
    rng = np.random.default_rng(12)
    p, b = 24, 300
    tau = np.sort(rng.uniform(5e-6, 5.5e-5, (p, b)), axis=1)
    fields = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in
              (tau, rng.uniform(-np.pi, np.pi, (p, b)),
               rng.uniform(0.5, 2.0, (p, b)))]
    return _place_calls(fields, _freq_kw(), spreader="dense_kernel")


@pytest.fixture(scope="module")
def fullscale_place_calls(fullscale_fields):
    """The placements of the full-scale chain's first 512-pulse chunk."""
    fields, opts = fullscale_fields
    return _place_calls(fields, opts, **echo.synth_options(opts))


def _re_im(x):
    if isinstance(x, tuple):
        return x
    return torch.view_as_real(x)[..., 0], torch.view_as_real(x)[..., 1]


@pytest.mark.parametrize("part", ["main", "edge"])
@pytest.mark.parametrize("shape", ["small", "full-scale"])
def test_place_windows_matches_plain_bit_for_bit(dev, request, shape, part):
    """The placement kernel against its plain version (the row loop, run
    on the card's tensors) bit for bit, twice the same bits, on the
    operands synthesize hands it: the main pass's planes (rows a
    128-multiple of floats apart, as the conv reads them) and the
    exact-edge pass's complex64 (its two flanks on one cell list). Full
    scale: 512 pulses, 16 groups, win 4,096 and 2,048, 13,200 samples."""
    calls = (_small_place_calls(dev) if shape == "small"
             else request.getfixturevalue("fullscale_place_calls"))
    assert len(calls) == 2
    wins, base, offsets, start, l_out, complex_out = calls[
        ["main", "edge"].index(part)]
    assert complex_out == (part == "edge")
    assert len(offsets) == (2 if part == "edge" else 1)
    if shape == "full-scale":
        assert tuple(wins.shape) == ((512, 16, 2, 4096) if part == "main"
                                     else (512, 16, 4, 2048))
        assert l_out == (50420 if part == "main" else 13200)
    before = spread_kernel.place_windows.launches
    got = spread_kernel.place_windows(wins, base, offsets, start, l_out,
                                      complex_out)
    again = spread_kernel.place_windows(wins, base, offsets, start, l_out,
                                        complex_out)
    torch.cuda.synchronize()
    assert spread_kernel.place_windows.launches == before + 2
    want = spread_kernel.place_windows_plain(wins, base, offsets, start,
                                             l_out, complex_out)
    for a, b, w in zip(_re_im(got), _re_im(again), _re_im(want)):
        assert a.shape == w.shape == (wins.shape[0], l_out)
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        if not complex_out:
            assert a.stride(1) == 1 and a.stride(0) % 128 == 0
    assert float(want[0].abs().max() if not complex_out
                 else want.abs().max()) > 0


@pytest.mark.parametrize("spreader", ["dense", "dense_kernel",
                                      "dense_kernel_qr"])
def test_place_windows_never_runs_the_loop_on_card(dev, monkeypatch,
                                                   spreader):
    """Every dense spreader places through the kernel on the card, two
    launches a chunk; the plain loop is never reached."""
    def loop(*args, **kw):
        raise AssertionError("the plain placement ran on the card")

    monkeypatch.setattr(spread_kernel, "place_windows_plain", loop)
    rng = np.random.default_rng(13)
    p, b = 40, 200
    tau = np.sort(rng.uniform(5e-6, 5.5e-5, (p, b)), axis=1)
    fields = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in
              (tau, rng.uniform(-np.pi, np.pi, (p, b)),
               rng.uniform(0.5, 2.0, (p, b)))]
    before = spread_kernel.place_windows.launches
    out = echo_freq.synthesize(*fields, _freq_kw(), spreader=spreader,
                               pulse_chunk=16)
    torch.cuda.synchronize()
    assert spread_kernel.place_windows.launches == before + 2 * 3
    assert bool(torch.isfinite(torch.view_as_real(out)).all())


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


def test_hrws_reconstruct_focus_on_card(dev):
    """HRWS on the card: ``reconstruct_focus(fft_impl='pallas')`` of a
    seeded 4 x 200 x 165 collect (800 x 165 unfolded: chirp-z azimuth,
    mixed-radix range) against the same on the CPU (the kernels' plain
    versions): the reconstruction within 1e-5 of its peak (cuFFT and the
    batched product written through the unfolded spectrum's transposed
    view against the CPU's), the SLC within 2e-5 of its peak; a second
    product builds no operator, factors or axis plans (no host copy); the
    spans and counters as on the CPU."""
    from nis_sar_amtigmti_video_tpu_torch.models import hrws
    from nis_sar_amtigmti_video_tpu_torch.utils import profiling
    sc = config.ati_dpca()
    g, prf, n_p, n_s = sc.geometry, 1500.0, 200, 165
    v = g.effective_velocity_mps
    p = hrws.HrwsParams(4, hrws.uniform_sampling_spacing(v, prf, 4), prf, v)
    cp = csa.CsaParams(
        wavelength_m=sc.radar.wavelength_m, chirp_rate=120e6 / 2e-6,
        fs_hz=150e6, prf_hz=4 * prf, velocity_mps=v,
        range_ref_m=g.slant_range_m,
        t_start_fast=2.0 * g.slant_range_m / 299792458.0 - 1e-6,
        num_pulses=4 * n_p, num_samples=n_s)
    gen = torch.Generator().manual_seed(22)
    raw = torch.randn((4, n_p, n_s), dtype=torch.complex64, generator=gen)
    want_rec, want = hrws.reconstruct_focus(raw, p, cp, fft_impl="pallas")
    hrws.reconstruct_focus(raw.to(dev), p, cp, fft_impl="pallas")
    caches = (hrws.unfold_operator, hrws._factors, csa_kernel.axis_plans)
    misses = [c.cache_info().misses for c in caches]
    with profiling.recording() as rec:
        rec_d, slc_d = hrws.reconstruct_focus(raw.to(dev), p, cp,
                                              fft_impl="pallas")
        torch.cuda.synchronize()
    assert [c.cache_info().misses for c in caches] == misses
    got_rec, got = rec_d.cpu(), slc_d.cpu()
    assert float((got_rec - want_rec).abs().max()) \
        <= 1e-5 * float(want_rec.abs().max())
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())
    # 800 = 32 x 25: the factored kind
    assert rec.counters == {"hrws.bands": 4, "cpi.chirpz_axes": 0,
                            "cpi.factored_axes": 2, "cpi.mixed_radix_axes": 2}
    tree = rec.tree()
    assert tree["hrws.focus"][0] == 1
    assert all(tree[f"hrws.focus/focus.{k}"][0] == 1
               for k in ("k1", "k2", "k3"))
    assert tree["hrws.reconstruct/hrws.unfold"][0] == 1


def test_echo_dropped_counts_on_card(dev):
    """The card's spread route (``dense_kernel``) counts the (pulse,
    target) pairs its group windows drop as the CPU's one-hot route does
    on the same scene: none at the default windows, the same number where
    the windows are cut to hold no group (``echo.dropped``)."""
    from nis_sar_amtigmti_video_tpu_torch.utils import profiling
    sc = config.ati_dpca()
    g = sc.geometry
    traj = orbit.make_trajectory(g, orbit.slow_time_grid(32 / 6000, 32))
    scene = targets.PointTargets.concatenate([
        targets.destroyer(), ocean_clutter_field(np.random.default_rng(5),
                                                 num_points=60)])
    base = dict(fc_hz=sc.radar.fc_hz, chirp_rate=120e6 / 2e-6,
                pulse_width_s=2e-6, fs_hz=150e6, num_samples=512,
                endpoint_grid=False, backend="freq")
    t0 = float(window_start_time(g.slant_range_m,
                                 echo.EchoOpts(**base), 512 / 150e6,
                                 "centered"))
    counts = {}
    for win, grp in ((None, None), (512, 1)):
        for d, spreader in ((dev, "dense_kernel"), ("cpu", "dense")):
            opts = echo.EchoOpts(**base, freq_spreader=spreader,
                                 freq_spread_win=win, freq_spread_grp=grp)
            with profiling.recording() as rec:
                echo.multi_channel_phase_history(
                    traj, scene, opts, t_start=t0, rx_offsets=(0.0,),
                    device=d)
            counts[win, str(d)] = rec.counters.get("echo.dropped", 0)
    assert counts[None, str(dev)] == counts[None, "cpu"] == 0
    assert counts[512, str(dev)] == counts[512, "cpu"] > 0
