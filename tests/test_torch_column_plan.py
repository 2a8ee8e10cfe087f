"""The column pass without a GPU, inverse (K3 / K3g) and forward (K1 /
K1g): its launch plans (``ops/cuda/csa_kernel.py::column_plan``) at every
shape the kernels take and the shared memory they give a block against the
slots the pass addresses, and the wrappers on rectangular CPU planes (their
plain versions) against the JAX package's Pallas kernels in interpret mode,
or against NumPy's float64 ``ifft`` at a shape those refuse."""

import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nis_sar_amtigmti_video_tpu import config as jcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import csa as jcsa  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops.pallas import (  # noqa: E402
    csa_kernel as jck, gmti_kernel as jgk)
from nis_sar_amtigmti_video_tpu_torch.gmti.cfar import (  # noqa: E402
    _window_sum)
from nis_sar_amtigmti_video_tpu_torch.ops import csa as tcsa  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    csa_kernel as tck, gmti_kernel as tgk)

torch.set_num_threads(1)

SIDES = [64, 128, 256, 512, 1024, 2048, 4096]
SMEM_PER_BLOCK = 232_448          # the most an H100 block may have
SMEM_PER_SM = 233_472             # an H100 SM's shared memory
H_OUT, H_IN = 10, 2


# --------------------------------------------------------------------------
# the launch plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("n_rg", SIDES)
@pytest.mark.parametrize("n_az", SIDES)
def test_column_plan_fits(n_az, n_rg, nch):
    """The plan tiles n_rg exactly, fits a block's shared memory, keeps the
    cluster at 8 blocks or fewer and the tile at 8 columns or more."""
    plan = tck.column_plan(n_az, n_rg, nch)
    assert n_rg % plan.cols == 0 and plan.cols & (plan.cols - 1) == 0
    assert 8 <= plan.cols <= tck.COLUMN_THREADS
    assert plan.smem <= SMEM_PER_BLOCK
    assert 1 <= plan.cluster <= 8 and n_az % plan.cluster == 0
    qa, qb = tck.column_split(n_az, plan.cluster)
    assert qa * qb * plan.cluster == n_az and qb <= qa <= 2 * qb <= 64
    assert plan.smem == tck.column_smem(n_az, plan.cols, plan.cluster, nch)
    # K3 and K3g split the transform alike (K3 is K3g's s1 bit for bit)
    assert plan.cluster == tck.column_plan(n_az, n_rg, 3 - nch).cluster


def test_column_plan_refuses_unsupported_shapes():
    for shape in ((32, 64), (64, 16896), (192, 272)):
        with pytest.raises(ValueError, match="not supported"):
            tck.column_plan(*shape, 1)


@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("n_az", SIDES)
def test_column_smem_holds_the_slots(n_az, nch):
    """The shared memory of the plan holds every slot the pass addresses: a
    channel's padded slot l + l // QA of its rows l < Q, and for K3g the
    power of CS chunks of J rows, each with COLUMN_HALO slots on either
    side, and one float a thread."""
    plan = tck.column_plan(n_az, 4096, nch)
    qa, qb = tck.column_split(n_az, plan.cluster)
    q = qa * qb
    j = q // plan.cluster
    assert j * plan.cluster == q
    ysz = q + qb                         # a channel's slots a column
    assert (q - 1) + (q - 1) // qa < ysz
    want = nch * ysz * plan.cols * 8
    if nch == 2:
        pcol = plan.cluster * (j + 2 * tck.COLUMN_HALO)
        want += (pcol * plan.cols + tck.COLUMN_THREADS) * 4
    assert plan.smem == want


@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("n_rg", SIDES)
@pytest.mark.parametrize("n_az", SIDES)
def test_forward_column_plan_fits(n_az, n_rg, nch):
    """The forward plan (K1, K1g) tiles n_rg exactly, fits a block's shared
    memory, keeps the cluster at 8 blocks or fewer and the tile at 8
    columns or more, and splits n_az as K3 / K3g do: by n_az alone, so K1
    and K1g split the transform alike (K1 is K1g's z1 bit for bit)."""
    plan = tck.column_plan(n_az, n_rg, nch, forward=True)
    assert n_rg % plan.cols == 0 and plan.cols & (plan.cols - 1) == 0
    assert 8 <= plan.cols <= tck.COLUMN_THREADS
    assert plan.smem <= SMEM_PER_BLOCK
    # two blocks an SM, as the kernels are built for (228 KB an SM, 1 KB
    # of it reserved a block)
    assert 2 * (plan.smem + 1024) <= SMEM_PER_SM
    assert 1 <= plan.cluster <= 8 and n_az % plan.cluster == 0
    qa, qb = tck.column_split(n_az, plan.cluster)
    assert qa * qb * plan.cluster == n_az and qb <= qa <= 2 * qb <= 64
    assert plan.smem == tck.column_smem(n_az, plan.cols, plan.cluster, nch,
                                        forward=True)
    other = tck.column_plan(n_az, n_rg, 3 - nch, forward=True)
    assert plan.cluster == other.cluster
    inverse = tck.column_plan(n_az, n_rg, nch)
    assert (plan.cols, plan.cluster) == inverse[:2]


def test_forward_column_plan_refuses_unsupported_shapes():
    for shape in ((32, 64), (64, 16896), (192, 272), (4096, 136)):
        for nch in (1, 2):
            with pytest.raises(ValueError, match="not supported"):
                tck.column_plan(*shape, nch, forward=True)


@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("n_az", SIDES)
def test_forward_column_smem_holds_the_slots(n_az, nch):
    """The shared memory of the forward plan holds every slot the pass
    addresses: a channel's padded slot l + l // QA of its rows l < Q, and
    for K1g one complex64 sum a thread and rank 0's slot (rank, c) of each
    block's column sums, and no power or halo slots."""
    plan = tck.column_plan(n_az, 4096, nch, forward=True)
    qa, qb = tck.column_split(n_az, plan.cluster)
    q = qa * qb
    ysz = q + qb                         # a channel's slots a column
    assert (q - 1) + (q - 1) // qa < ysz
    want = nch * ysz * plan.cols * 8
    if nch == 2:
        red = tck.COLUMN_THREADS         # one sum a thread
        part = plan.cluster * plan.cols  # slot (rank, c) in rank 0's
        want += (red + part) * 8
    assert plan.smem == want
    if nch == 1:
        assert plan.smem == tck.column_plan(n_az, 4096, 1).smem


@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("m", [256, 512, 1024, 2048, 4096, 8192, 16384])
def test_chirpz_column_smem_fits(m, forward, nch):
    """At every chirp-z length the one launch's plan (the forward pass, the
    gathered values held in registers and written back to the block's own
    slots, then the inverse pass, in the same shared memory) fits an H100
    block's 227 KB, for one and two channels, forward and inverse; the
    spectrum needs no slot beyond the direct pass's at m. Clusters of at
    most 8 blocks of 256 threads keep two blocks an SM; clusters of 16
    (8192 and 16,384 points) take 512 threads and one block an SM."""
    n_az = m // 4 + 1                    # chirp-z length m
    assert tck.chirpz_length(n_az) == m
    plan = tck.column_plan(n_az, 13200, nch, forward)
    threads = tck.column_threads(n_az)
    assert plan.cluster == tck.column_cluster(m)
    assert threads == (512 if plan.cluster == 16 else 256)
    assert plan.smem == tck.column_smem(m, plan.cols, plan.cluster, nch,
                                        forward, threads) <= SMEM_PER_BLOCK
    qa, qb = tck.column_split(m, plan.cluster)
    ysz = qa * qb + qb
    assert plan.smem >= nch * ysz * plan.cols * 8
    assert nch * qb * plan.cols >= threads
    if plan.cluster <= 8:
        assert 2 * (plan.smem + 1024) <= SMEM_PER_SM


# --------------------------------------------------------------------------
# the wrappers on rectangular CPU planes
# --------------------------------------------------------------------------

def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    x1r, x1i, n2r, n2i = (rng.standard_normal(shape).astype(np.float32)
                          for _ in range(4))
    c, s = np.float32(np.cos(0.31)), np.float32(np.sin(0.31))
    return [x1r, x1i, c * x1r - s * x1i + np.float32(0.05) * n2r,
            s * x1r + c * x1i + np.float32(0.05) * n2i]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("shape", [(256, 1024), (1024, 256)])
def test_k3_wrappers_match_pallas_on_rectangles(shape):
    """k3_call and k3_gmti_planes on CPU planes (their plain versions)
    against the reference's _k3_call and k3_gmti_planes (interpret mode),
    at the single-channel file's tolerance (1e-4 of the peak)."""
    assert jck.supported(*shape)
    x = _planes(shape, sum(shape))
    cal = 0.4
    cal_cs = np.array([np.cos(cal), np.sin(cal)], np.float32)
    a = int(np.sqrt(shape[0]))
    with jax.enable_x64(False):
        j = [jnp.asarray(v) for v in x]
        k3 = jck._k3_call(j[0], j[1], a, True, "bf16x3")
        k3g = jgk.k3_gmti_planes(*j, jnp.asarray(cal_cs).reshape(1, 2),
                                 h_out=H_OUT, h_in=H_IN, interpret=True)
    k3, k3g = [np.asarray(v) for v in k3], [np.asarray(v) for v in k3g]
    t = [torch.from_numpy(v) for v in x]
    got = tck.k3_call(t[0], t[1])
    for g, w in zip(got, k3):
        assert g.shape == shape and _rel(g, w) < 1e-4
    got = tgk.k3_gmti_planes(*t, torch.from_numpy(cal_cs), h_out=H_OUT,
                             h_in=H_IN)
    for i in (0, 1, 2, 3, 5, 6, 7, 8):
        assert got[i].shape == shape and _rel(got[i], k3g[i]) < 1e-4, i
    strong = k3g[5] > 1e-2 * k3g[5].max()
    d = np.angle(np.exp(1j * (got[4].numpy() - k3g[4])))
    assert np.abs(d[strong]).max() < 1e-3
    assert got[9].shape == (shape[1],)
    assert abs(float(got[9].max()) - float(k3g[9].max())) \
        <= 1e-4 * float(k3g[9].max())


def test_k3_wrappers_match_float64_where_pallas_refuses():
    """At (64, 256), which the reference's kernels refuse (64 is not a
    multiple of 128), against NumPy's float64 ifft and products."""
    shape = (64, 256)
    assert not jck.supported(*shape) and tck.supported(*shape)
    x = _planes(shape, 7)
    cal = 0.4
    t = [torch.from_numpy(v) for v in x]
    s1 = np.fft.ifft(x[0].astype(np.float64) + 1j * x[1], axis=0)
    s2 = np.fft.ifft(x[2].astype(np.float64) + 1j * x[3], axis=0)
    got = tck.k3_call(t[0], t[1])
    assert _rel(got[0], s1.real) < 1e-5 and _rel(got[1], s1.imag) < 1e-5
    got = tgk.k3_gmti_planes(*t, torch.tensor([np.cos(cal), np.sin(cal)],
                                              dtype=torch.float32),
                             h_out=H_OUT, h_in=H_IN)
    power = np.abs(s1 - s2 * np.exp(1j * cal)) ** 2
    mag = np.abs(s1) ** 2
    want = [s1.real, s1.imag, s2.real, s2.imag, None, mag, power,
            _window_sum(torch.from_numpy(power), H_OUT, 0).numpy(),
            _window_sum(torch.from_numpy(power), H_IN, 0).numpy(),
            mag.max(0)]
    for i, w in enumerate(want):
        if w is not None:
            assert _rel(got[i], w) < 1e-5, i
    ati = np.angle(s1 * np.conj(s2) * np.exp(-1j * cal))
    d = np.angle(np.exp(1j * (got[4].numpy() - ati)))
    assert np.abs(d[mag > 1e-2 * mag.max()]).max() < 1e-4


def _factors(n_az, n_rg):
    """JAX CsaFactors of the slice's scenario (ati_dpca, 150 MHz waveform)
    at (n_az, n_rg) and the same values as the port's tensors."""
    sc = jcfg.ati_dpca()
    r = dataclasses.replace(sc.radar, bandwidth_hz=120e6, pulse_width_s=2e-6,
                            fs_hz=150e6)
    g = sc.geometry
    t0 = 2.0 * g.slant_range_m / 299792458.0 - r.pulse_width_s / 2 - 1e-6
    jf = jcsa.csa_factors(jcsa.CsaParams(
        wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
        prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m, t_start_fast=t0, num_pulses=n_az,
        num_samples=n_rg))
    tf = tcsa.csa_factors_from_numpy(
        {k: np.asarray(v) for k, v in jf._asdict().items()})
    return jf, tf


@pytest.mark.parametrize("shape", [(256, 1024), (1024, 256)])
def test_k1_wrappers_match_pallas_on_rectangles(shape):
    """k1_call and k1_gmti_planes on CPU planes (their plain versions)
    against the reference's _k1_call and k1_gmti_planes (interpret mode):
    planes at 1e-4 of the peak, the balance sums at 1e-5 and their angle at
    1e-6 rad."""
    assert jck.supported(*shape)
    x = _planes(shape, 2 * sum(shape))
    jf, tf = _factors(*shape)
    a = math.isqrt(shape[0])
    with jax.enable_x64(False):
        j = [jnp.asarray(v) for v in x]
        k1 = jck._k1_call(j[0], j[1], jf.u.reshape(1, -1),
                          jf.c1.reshape(-1, 1), jf.w.reshape(-1, 1), a, True,
                          "bf16x3")
        k1g = jgk.k1_gmti_planes(*j, jf, interpret=True)
    k1, k1g = [np.asarray(v) for v in k1], [np.asarray(v) for v in k1g]
    t = [torch.from_numpy(v) for v in x]
    got = tck.k1_call(t[0], t[1], tf)
    for g, w in zip(got, k1):
        assert g.shape == shape and _rel(g, w) < 1e-4
    got = tgk.k1_gmti_planes(*t, tf)
    for i in range(4):
        assert got[i].shape == shape and _rel(got[i], k1g[i]) < 1e-4, i
    sums = np.array([float(got[4]), float(got[5])])
    assert _rel(sums, np.array([k1g[4], k1g[5]])) < 1e-5
    assert abs(math.atan2(sums[1], sums[0])
               - math.atan2(float(k1g[5]), float(k1g[4]))) < 1e-6
