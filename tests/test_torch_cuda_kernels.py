"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card: the GMTI kernels at 256^2 and at the slice's 4096^2, the
fast-BP recentre kernels at nfft 16,384 and at the VideoSAR reference shape
(2,500 x 22,004 samples, nfft 32,768, presum 4). Marked ``cuda``: they skip
where no CUDA device is present (the kernels have no CPU mode). On a GPU
machine: ``python -m pytest tests/test_torch_cuda_kernels.py -q``."""

import dataclasses

import numpy as np
import pytest
import torch

from nis_sar_amtigmti_video_tpu_torch import config
from nis_sar_amtigmti_video_tpu_torch.gmti import fused
from nis_sar_amtigmti_video_tpu_torch.gmti.cfar import CfarParams
from nis_sar_amtigmti_video_tpu_torch.models import gmti
from nis_sar_amtigmti_video_tpu_torch.ops import csa
from nis_sar_amtigmti_video_tpu_torch.geometry import orbit
from nis_sar_amtigmti_video_tpu_torch.ops import bp
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (csa_kernel, fft_kernel,
                                                       gmti_kernel)

pytestmark = pytest.mark.cuda
CP = CfarParams()
H_OUT, H_IN = CP.guard + CP.train, CP.guard


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _factors(n, dev):
    sc = config.ati_dpca()
    r = dataclasses.replace(sc.radar, bandwidth_hz=120e6, pulse_width_s=2e-6,
                            fs_hz=150e6)
    g = sc.geometry
    return csa.csa_factors(csa.CsaParams(
        wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
        prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m,
        t_start_fast=2.0 * g.slant_range_m / 299792458.0 - 2e-6,
        num_pulses=n, num_samples=n), dev)


def _planes(n, dev, seed=0):
    rng = np.random.default_rng(seed)
    x1r, x1i, n2r, n2i = (rng.standard_normal((n, n), dtype=np.float32)
                          for _ in range(4))
    c, s = np.float32(np.cos(0.31)), np.float32(np.sin(0.31))
    return [torch.from_numpy(v).to(dev) for v in
            (x1r, x1i, c * x1r - s * x1i + 0.05 * n2r,
             s * x1r + c * x1i + 0.05 * n2i)]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("n", [256, 4096])
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


@pytest.mark.parametrize("n", [256, 4096])
def test_k2_pair_matches_plain(dev, n):
    f, x = _factors(n, dev), _planes(n, dev, 1)
    got = csa_kernel.k2_pair_call(*x, f)
    want = csa_kernel.k2_pair_plain(*x, f)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("n", [256, 4096])
def test_k3g_matches_plain(dev, n):
    x = _planes(n, dev, 2)
    cal_cs = torch.tensor([np.cos(0.4), np.sin(0.4)], dtype=torch.float32,
                          device=dev)
    got = gmti_kernel.k3_gmti_planes(*x, cal_cs, h_out=H_OUT, h_in=H_IN)
    want = gmti_kernel.k3_gmti_plain(*x, cal_cs, h_out=H_OUT, h_in=H_IN)
    for i in (0, 1, 2, 3, 5, 6, 7, 8, 9):
        assert _rel(got[i], want[i]) <= 1e-4, i
    strong = want[5] > 1e-2 * want[5].max()
    d = torch.remainder(got[4] - want[4] + np.pi, 2 * np.pi) - np.pi
    assert float(d[strong].abs().max()) < 1e-3


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
