"""The GMTI CPI's kernel route at CPI sides that are not powers of two, on
the CPU (the kernels' plain versions): the family ``csa_kernel.supported``
takes and refuses, the plans the kernels are launched with there, the
axis plans ``GmtiCpi`` holds and their check, and ``focus_and_products(path="kernel_fused")``
at a 90 x 165 CPI against the composed route and against the plain float64
reference of the benchmark (bench_torch/reference/gmti_products.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from bench_torch.kinds.sim_focus import compare_products, radar_params
from bench_torch.reference import gmti_products as ref
from nis_sar_amtigmti_video_tpu_torch import config
from nis_sar_amtigmti_video_tpu_torch.gmti import fused
from nis_sar_amtigmti_video_tpu_torch.models import gmti
from nis_sar_amtigmti_video_tpu_torch.ops import csa
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import csa_kernel as tck

torch.set_num_threads(1)

# SMEM a block may take on the H100 (232,448 bytes)
SMEM_PER_BLOCK = 232448


@pytest.mark.parametrize("shape", [(7199, 13200), (7200, 13200), (65, 64),
                                   (8191, 16384), (8192, 14641), (97, 165),
                                   (313, 120), (4097, 4096), (90, 2197)])
def test_the_family_takes(shape):
    assert tck.supported(*shape)


@pytest.mark.parametrize("shape", [(63, 64), (8193, 64), (64, 63),
                                   (64, 16385), (64, 17 * 8),
                                   (7199, 13200 * 2), (96, 19 * 5)])
def test_the_family_refuses(shape):
    assert not tck.supported(*shape)
    with pytest.raises(ValueError, match="not supported"):
        tck.column_plan(*shape, 2)


@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("n_az", [65, 97, 313, 2049, 4097, 7199, 7200,
                                  8192])
def test_column_plan_at_other_sides(n_az, nch, forward):
    """The plan is the column pass's at the transform's length (n_az, or
    the chirp-z length), which splits into the kernels' clusters of at
    most 16 blocks; the shared memory fits a block; the tile covers n_rg
    with a last tile cut at the edge. A factored side (7,199, 7,200) runs
    at its own length on tiles of 8 columns, clusters of 8 and
    ``factored_smem``."""
    n_rg = 13200 if n_az > 4096 else 165
    plan = tck.column_plan(n_az, n_rg, nch, forward)
    n = tck.column_length(n_az)
    if tck.factored_split(n_az):
        assert n == n_az and not tck.chirpz(n_az)
        assert (plan.cols, plan.cluster) == (8, tck.FACTORED_CLUSTER)
        assert plan.smem == tck.factored_smem(
            n_az, 8, nch, forward, tck.column_threads(n_az, nch)) \
            <= SMEM_PER_BLOCK
        return
    assert n & (n - 1) == 0 and (n == n_az or n >= 2 * n_az - 1)
    assert plan.cluster == tck.column_cluster(n) <= 16
    qa, qb = tck.column_split(n, plan.cluster)
    assert qa * qb * plan.cluster == n and qb <= qa <= 2 * qb <= 64
    assert 8 <= plan.cols and plan.cols & (plan.cols - 1) == 0
    assert plan.smem == tck.column_smem(n, plan.cols, plan.cluster, nch,
                                        forward, tck.column_threads(n_az)
                                        ) <= SMEM_PER_BLOCK


# the chirp-z corners the card tests hold the kernels to: two primes over
# the upstream's range side (7,193 and 6,007, in the place of the upstream's
# 7,199 and 7,200, which the factored kind takes), the longest chirp-z side
# over the longest row, the shortest 16,384-point side, and the shortest
# chirp-z side (m = 256, one block a cluster)
CHIRPZ_CORNERS = [(7193, 13200), (6007, 13200), (8191, 16384), (4097, 693),
                  (65, 64)]


@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("shape", CHIRPZ_CORNERS,
                         ids=[f"{a}x{b}" for a, b in CHIRPZ_CORNERS])
def test_chirpz_launch_plan_at_the_corners(shape, forward, nch):
    """The plan a chirp-z launch of K1 / K1g (forward) or K3 / K3g takes
    at the corners is the one its instantiation is built for
    (csrc/gmti_kernel.cu, column_threads and chirpz_cols: the launcher
    refuses another width): blocks of 512 threads on clusters of 16, else
    256, tiles of max(8, threads / (nch QB)) columns, so the forward
    gather's J x cols tasks are whole tasks a thread, and the values a
    thread holds across the cluster barrier (tasks x nch x CS complex64)
    fit 64 floats, half the registers a 512-thread block allows; its shared
    memory is the direct pass's at m for that many threads and fits a
    block."""
    n_az, n_rg = shape
    m = tck.chirpz_length(n_az)
    plan = tck.column_plan(n_az, n_rg, nch, forward)
    threads = tck.column_threads(n_az)
    assert threads == (512 if plan.cluster == 16 else 256)
    qa, qb = tck.column_split(m, plan.cluster)
    q = qa * qb
    assert plan.cols == max(8, threads // (nch * qb))
    assert q % plan.cluster == 0
    tasks = (q // plan.cluster) * plan.cols
    assert tasks % threads == 0
    held = tasks // threads * nch * plan.cluster * 2
    assert held <= 64
    assert plan.smem == tck.column_smem(m, plan.cols, plan.cluster, nch,
                                        forward, threads) <= SMEM_PER_BLOCK


def test_chirpz_lengths():
    """The least power of two of at least 2 n - 1: 16,384 at 7,193 and
    8,191; 256 at 65. Which kind each side takes: a power of two the
    direct pass (4096), a side ``factored_split`` takes the factored kind
    at its own length (7,199 = 23 x 313, 7,200 = 32 x 225, 120 = 8 x 15),
    any other the chirp-z kind (7,193 and 8,191, primes; 4,097 = 17 x 241
    and 65 = 5 x 13, whose legs are no outer leg). One launch a
    column-pass call at every side."""
    assert tck.chirpz_length(7193) == tck.chirpz_length(8191) == 16384
    assert tck.chirpz_length(65) == 256 and tck.chirpz_length(4097) == 16384
    kinds = {n: tck.azimuth_plan(n).kind
             for n in (4096, 7199, 7200, 120, 7193, 8191, 4097, 65)}
    assert kinds == {4096: "direct", 7199: "factored", 7200: "factored",
                     120: "factored", 7193: "chirpz", 8191: "chirpz",
                     4097: "chirpz", 65: "chirpz"}
    assert tck.factored_split(7199) == (23, 313)
    assert tck.factored_split(7200) == (32, 225)
    assert not tck.chirpz(4096) and tck.chirpz(4097)
    assert not tck.chirpz(7199) and tck.chirpz(7193)
    assert tck.column_length(7199) == 7199
    assert tck.column_length(7193) == 16384
    assert all(tck.azimuth_plan(n).launches == 1 for n in kinds)
    assert not tck.k2_mixed(4096) and tck.k2_mixed(8192)
    assert tck.k2_mixed(13200) and tck.k2_mixed(96)


@pytest.mark.parametrize("shape", [(90, 165), (64, 128), (97, 8192),
                                   (184, 165), (120, 64)])
def test_gmti_cpi_tables(shape):
    """GmtiCpi holds the axis plans its kernels read: the direct column
    pass or the chirp-z transform's (its length, tables and one launch), the
    register or the mixed-radix plan (its tables and passes), which .to()
    moves tensor by tensor; counts the axes."""
    n_az, n_rg = shape
    f = csa.csa_factors(csa.CsaParams(
        wavelength_m=0.03, chirp_rate=6e13, fs_hz=150e6, prf_hz=6000.0,
        velocity_mps=7600.0, range_ref_m=6e5, t_start_fast=4e-3,
        num_pulses=n_az, num_samples=n_rg))
    cpi = fused.GmtiCpi(f)
    az, rg = cpi.az, cpi.rg
    assert isinstance(az, tck.AzimuthPlan) and isinstance(rg, tck.RangePlan)
    assert (az.n, rg.n) == shape
    if tck.chirpz(n_az):
        m = tck.chirpz_length(n_az)
        assert az.m == m and az.tw.shape == (m // 2,) and az.launches == 1
        assert az.fwd_chirp.shape == az.inv_chirp.shape == (n_az,)
        assert az.fwd_spec.shape == az.inv_spec.shape == (m,)
        assert (cpi.chirpz_axes, cpi.factored_axes) == (2, 0)
    elif tck.factored_split(n_az):
        n1, n2, local, passes = az.legs
        assert az.m == n_az and az.tw.shape == (local + n1,)
        assert az.index.shape == (2 + passes + 2 * n2,)
        assert az.fwd_chirp is None and az.inv_chirp is None
        assert (az.fwd_spec is None) == (local == n2)
        assert (cpi.chirpz_axes, cpi.factored_axes) == (0, 2)
    else:
        assert az.m == n_az and az.tw.shape == (n_az // 2,)
        assert az.launches == 1 and set(az.tensors()) == {"tw"}
        assert (cpi.chirpz_axes, cpi.factored_axes) == (0, 0)
    if tck.k2_mixed(n_rg):
        assert rg.tw.shape == rg.order.shape == (n_rg,)
        assert rg.radices.tolist() == list(tck.mixed_radices(n_rg))
        assert rg.passes == len(tck.mixed_radices(n_rg))
        assert cpi.mixed_radix_axes == 2
    else:
        assert rg.tw.shape == (n_rg // 2,) and rg.passes == 0
        assert rg.order is None and rg.radices is None
        assert cpi.mixed_radix_axes == 0
    cpi.to("meta")
    for plan, was in ((cpi.az, az), (cpi.rg, rg)):
        assert set(plan.tensors()) == set(was.tensors())
        assert all(t.device.type == "meta" for t in plan.tensors().values())
        assert all(t.device.type == "cpu" for t in was.tensors().values())


def _plan_for(axis, n, device="cpu"):
    return (tck.azimuth_plan if axis == "azimuth" else tck.range_plan)(
        n, device)


@pytest.mark.parametrize("n", [128, 165])
@pytest.mark.parametrize("axis", ["azimuth", "range"])
@pytest.mark.parametrize("wrong", ["another length", "the other axis",
                                   "another device"])
def test_plan_check_refuses(axis, n, wrong):
    """A plan's check takes the plan its wrapper would build and refuses
    one built for another length, the other axis's plan (at 128 the two
    tables have one shape) and one whose tables are on another device."""
    cls = tck.AzimuthPlan if axis == "azimuth" else tck.RangePlan
    cpu = torch.device("cpu")
    cls.check(_plan_for(axis, n), "k", n, cpu)
    plan = {"another length": _plan_for(axis, 2 * n),
            "the other axis": _plan_for(
                "range" if axis == "azimuth" else "azimuth", n),
            "another device": _plan_for(axis, n).map(
                lambda t: t.to("meta"))}[wrong]
    with pytest.raises(ValueError, match="^k: "):
        cls.check(plan, "k", n, cpu)


def _scenario(fft_impl):
    sc = config.ati_dpca()
    return sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                  pulse_width_s=2e-6, fs_hz=150e6),
        processing=dataclasses.replace(sc.processing, fft_impl=fft_impl))


def _raw(shape, seed):
    """A (2, P, Ns) pair: a correlated second channel, as DPCA sees."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2,) + shape) + 1j * rng.standard_normal(
        (2,) + shape)
    x[1] = 0.97 * np.exp(0.3j) * x[0] + 0.05 * x[1]
    return torch.from_numpy(x.astype(np.complex64))


def _errors(p, want):
    """The benchmark's numbers of products ``p`` against the reference's."""
    served = torch.stack([p.cal_phase.reshape(()).float(),
                          p.cancellation_ratio.reshape(()).float(),
                          p.detections.detections.sum().float()])
    return compare_products([(0, served)], [(0, (0, dict(
        slc1=p.slc1, slc2=p.slc2, ati_phase=p.ati_phase,
        dpca_mag=p.dpca_mag, snr=p.detections.snr)))], [want])


def test_kernel_fused_at_a_non_power_of_two_cpi():
    """A 91 x 165 raw pair (90 x 165 after the one-pulse shift: a chirp-z
    azimuth, a mixed-radix range of 11 x 5 x 3): the kernel route's
    products against the composed route's (1e-4 of the peak: the same
    float32 arithmetic in another order), and against the float64
    reference by the benchmark's own numbers: the planes within the
    fullscale cell's limits, and every number within twice the composed
    route's own or 1e-6, float32's rounding of a mean (on noise-like raw
    the ATI phase of pixels above a tenth of the peak, and the balance
    angle of a 90 x 165 sum, are limited by float32 alike on both
    routes)."""
    raw = _raw((91, 165), 7)
    sc = _scenario("pallas")
    t0 = 2.0 * sc.geometry.slant_range_m / 299792458.0 - 2e-6
    assert tck.supported(90, 165)
    got = gmti.focus_and_products(raw, sc, t0, path="kernel_fused")
    comp = gmti.focus_and_products(raw, _scenario("auto"), t0,
                                   path="composed")
    for a, b in ((got.slc1, comp.slc1), (got.slc2, comp.slc2),
                 (got.dpca_mag, comp.dpca_mag)):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-4
    assert abs(float(got.cal_phase) - float(comp.cal_phase)) < 1e-5
    g = {"shift_pulses": 1, "mask_threshold": 0.05, "guard": 2, "train": 8,
         "pfa": 1e-6}
    want = ref.products(raw, radar_params(sc, t0), g)
    e, c = _errors(got, want), _errors(comp, want)
    limits = {"slc_err": 1.2e-3, "dpca_err": 1e-4, "snr_err": 0.15,
              "ratio_err": 1e-2}
    assert all(e[k] <= v for k, v in limits.items()), e
    assert all(e[k] <= max(2.0 * c[k], 1e-6) for k in e), (e, c)
