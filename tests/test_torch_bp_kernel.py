"""The port's fast-BP accumulate kernels (ops/cuda/bp_kernel.py,
ops/cuda/bp_factor_kernel.py) on the CPU: their plain versions against the
JAX package's Pallas kernels in interpret mode on the reference's own
operands (tests/test_bp_fast.py), a NumPy model of the CUDA kernel's
arithmetic (csrc/bp_kernel.cu: the contraction as one stacked real product
in three TF32 passes, the column kernel from two phasor tables) against
the plain versions,
``focus_bp_fast`` on the two routes against the JAX package and the port's
float64 oracle, and ``videosar.run(bp_backend='fast_pallas')``."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nis_sar_amtigmti_video_tpu.ops import bp as jbp  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops import bp_fast as jbpf  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops.pallas import (  # noqa: E402
    bp_factor_kernel as jfk, bp_kernel as jbk)
from nis_sar_amtigmti_video_tpu_torch import config as tcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.geometry import orbit  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.models import videosar  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops import bp, bp_fast  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    bp_factor_kernel, bp_kernel)
from nis_sar_amtigmti_video_tpu_torch.ops.echo import (  # noqa: E402
    phase_history, window_start_time)
from nis_sar_amtigmti_video_tpu_torch.scene import targets as T  # noqa
from nis_sar_amtigmti_video_tpu_torch.video import scheduler  # noqa: E402
from test_torch_bp import _check, _port_oracle, _rel, _scene  # noqa: E402
from test_torch_videosar import MOVER, _reduced, _stream  # noqa: E402

# one intra-op thread: the suite runs in several processes at once,
# and a torch OpenMP pool per process oversubscribes the cores
torch.set_num_threads(1)


def _operands(n_p, ny, nx, w, seed, u0_mid, pb_s, pc_s, bt_s, ct_s,
              stride=1, nx_c=0, sub_raw=0):
    """tests/test_bp_fast.py's synthetic accumulate operands (numpy)."""
    plan = bp_fast.FastBpPlan(ny_i=ny, nx_i=nx, w_win=w, stride=stride,
                              band_start=7, nfft=512, dx_m=1.0, t_ref=1e-3,
                              n_org=100.0, sub_raw=sub_raw, nx_c=nx_c)
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
    return ops, plan


def _pixel_operands(n_p, stride=1):
    return _operands(n_p, 128, 128, 64, 3, 30.0, 0.01, 1e-4, 0.05, 1e-4,
                     stride=stride)


def _factor_operands(n_p=11):
    return _operands(n_p, 128, 512, 32, 5, 15.0, 0.003, 3e-6, 0.01, 1e-5,
                     nx_c=128, sub_raw=4)


def _torch(ops):
    return tuple(torch.from_numpy(a) for a in ops)


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero: cvt.rna.tf32.f32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _tf32_read(x):
    """A float32 as the tensor cores read a TF32 operand: its low 13
    mantissa bits dropped."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """The kernel's split x = hi + lo: hi = tf32(x), lo = x - hi in
    float32, as the tensor cores read it."""
    hi = _tf32(x)
    return hi, _tf32_read(np.float32(x) - hi)


def _phasors(u, w):
    """(..., w/8 + 8) complex64 phasor tables of z = exp(j 2 pi u / w):
    z^{8a} for a in [-w/16, w/16), then z^b for b in [0, 8)."""
    k = np.concatenate([8 * np.arange(-w // 16, w // 16), np.arange(8)])
    return np.exp(2j * np.pi * np.asarray(u, np.float64)[..., None] * k
                  / w).astype(np.complex64)


def _bins(w):
    """Per bin m of the window DFT: its a (entry a + w/16) and b (entry
    w/8 + b) in the phasor tables, k = 8 a + b the signed bin."""
    k = np.where(np.arange(w) < w // 2, np.arange(w), np.arange(w) - w)
    return (k >> 3) + w // 16, w // 8 + (k & 7)


def _kernel_model(ops, c0, c1, c2, xi, plan, sub_p, passes=3):
    """NumPy model of csrc/bp_kernel.cu: the tapered window DFT as 8-point
    DFTs, twiddles and (W/8)-point DFTs (float64); the ramp and the column
    kernel K[x][m] = z_x^{8a} z_x^b from two complex64 phasor tables; the
    complex contraction as one real product of depth 2W, [Kr | Ki] (columns
    x 2W) against the window spectra with real and imaginary parts
    interleaved along N, in float32 from TF32 operands split into hi and lo:
    hi.hi + hi.lo + lo.hi (``passes`` 3) or hi.hi alone (1); angle-sum
    taper; phase c1 xi + c2 xi^2; sums over blocks of ``sub_p`` pulses ->
    (n_sub, ny, len(xi))."""
    rc2, u0, _, _, _, bt, ct = (np.asarray(a, np.float64)
                                if a.dtype != np.complex64
                                else a.astype(np.complex128) for a in ops)
    c0, c1, c2, xi = (np.asarray(a, np.float64) for a in (c0, c1, c2, xi))
    n_p, w, ny = rc2.shape[0], plan.w_win, plan.ny_i
    r2, r1 = 8, w // 8
    s = np.arange(w)
    tapw = np.sin(np.pi * (s + 0.5) / w) ** plan.taper_pow / w
    tw = np.exp(-2j * np.pi * s / w)
    ea, eb = _bins(w)
    rows = plan.band_start + plan.stride * np.arange(ny)
    out = np.zeros((-(-n_p // sub_p), ny, xi.size), np.complex128)
    for t in range(n_p):
        xs = (rc2[t][rows[:, None] + s[None, :]] * tapw).reshape(ny, r2, r1)
        a = (np.einsum("yjs,jm->ysm", xs,
                       tw[(r1 * np.outer(np.arange(r2), np.arange(r2))) % w])
             * tw[np.outer(np.arange(r1), np.arange(r2)) % w])
        big_x = np.einsum("ysm,sl->ylm", a, tw[
            (r2 * np.outer(np.arange(r1), np.arange(r1))) % w]).reshape(ny, w)
        rz = _phasors(u0[t], w)                               # (ny, w/8 + 8)
        g = (big_x * rz[:, ea] * rz[:, eb]
             * np.exp(1j * c0[t])[:, None]).astype(np.complex64)
        e = bt[t] * xi + ct[t] * xi ** 2
        zc = _phasors(e, w)                                   # (nx, w/8 + 8)
        kern = zc[:, ea] * zc[:, eb]                          # (nx, w)
        a_mat = np.concatenate([kern.real, kern.imag], axis=1)
        b_mat = np.empty((2 * w, 2 * ny), np.float32)
        b_mat[:w, 0::2], b_mat[w:, 0::2] = g.real.T, -g.imag.T
        b_mat[:w, 1::2], b_mat[w:, 1::2] = g.imag.T, g.real.T
        (ah, al), (bh, bl) = _split(a_mat), _split(b_mat)
        d = ah @ bh if passes == 1 else ah @ bh + ah @ bl + al @ bh
        v = (d[:, 0::2] + 1j * d[:, 1::2]).T.astype(np.complex128)
        ay = np.pi * (u0[t] + 0.5) / w
        tap = (np.sin(ay)[:, None] * np.cos(np.pi * e / w)[None, :]
               + np.cos(ay)[:, None] * np.sin(np.pi * e / w)[None, :]
               ) ** plan.taper_pow
        out[t // sub_p] += (v / np.maximum(tap, 1e-4) * np.exp(
            1j * (c1[t][:, None] * xi + c2[t][:, None] * xi ** 2)))
    return out


# --------------------------------------------------------------------------
# the plain versions against the reference's Pallas kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_p,stride", [(5, 1), (21, 2)])
def test_accumulate_pallas_plain_matches_reference(n_p, stride):
    """Bound 2e-4 of the peak (tests/test_bp_fast.py's for the kernel vs
    the XLA accumulate); 21 pulses are not a multiple of the reference's
    16-pulse block."""
    ops, plan = _pixel_operands(n_p, stride)
    want = np.asarray(jbk.accumulate_pallas(
        *(jnp.asarray(a) for a in ops),
        jbpf.FastBpPlan(**dataclasses.asdict(plan)), interpret=True))
    before = bp_kernel.accumulate_pallas.launches
    got = bp_kernel.accumulate_pallas(*_torch(ops), plan)
    assert bp_kernel.accumulate_pallas.launches == before     # CPU: plain
    assert got.shape == (128, 128) and got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < 2e-4
    assert torch.equal(got, bp_kernel.accumulate_pallas_plain(*_torch(ops),
                                                              plan))


def test_accumulate_factor_plain_matches_reference():
    """11 pulses in sub-apertures of 4: a ragged last one. Bound 2e-4."""
    ops, plan = _factor_operands()
    assert bp_factor_kernel.supported(plan)
    want = np.asarray(jfk.accumulate_factor_pallas(
        *(jnp.asarray(a) for a in ops),
        jbpf.FastBpPlan(**dataclasses.asdict(plan)), 4, interpret=True,
        feed="windows"))
    before = bp_factor_kernel.accumulate_factor_pallas.launches
    got = bp_factor_kernel.accumulate_factor_pallas(*_torch(ops), plan, 4)
    assert bp_factor_kernel.accumulate_factor_pallas.launches == before
    assert got.shape == (128, 512)
    assert _rel(got.numpy(), want) < 2e-4


def test_supported_follows_reference():
    ops, plan = _factor_operands()
    _, pplan = _pixel_operands(5)
    for p in (plan, pplan, dataclasses.replace(pplan, ny_i=136),
              dataclasses.replace(plan, nx_c=64),
              dataclasses.replace(plan, sub_raw=0)):
        jp = jbpf.FastBpPlan(**dataclasses.asdict(p))
        assert bp_kernel.supported(p) == jbk.supported(jp)
        assert bp_factor_kernel.supported(p) == jfk.supported(jp)
    with pytest.raises(ValueError, match="w_win=64"):
        bp_kernel.accumulate_pallas(*_torch(ops), plan)
    with pytest.raises(ValueError, match="w_win=32"):
        bp_factor_kernel.accumulate_factor_pallas(*_torch(ops), pplan, 4)


# --------------------------------------------------------------------------
# the CUDA kernel's arithmetic, modelled with NumPy
# --------------------------------------------------------------------------

def test_split_is_tf32():
    """hi keeps 10 mantissa bits, rounded to nearest; lo is x - hi with its
    low 13 bits dropped; hi + lo is x to 2^-21 of |x|."""
    x = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any()
    assert np.abs(hi - x).max() <= np.abs(x).max() * 2.0 ** -11
    assert np.abs((hi.astype(np.float64) + lo) - x).max() \
        <= np.abs(x).max() * 2.0 ** -21
    assert _tf32(np.float32(1 + 2 ** -11)) == np.float32(1 + 2 ** -10)


@pytest.mark.parametrize("n_p,stride", [(5, 1), (21, 2)])
def test_kernel_model_matches_pixel_plain(n_p, stride):
    """The kernel's formulation (e^{j pa} in the ramp, split window DFT,
    phasor-table column kernel, the stacked real product in three TF32
    passes, angle-sum taper) equals _accumulate to 1e-5 of the peak."""
    ops, plan = _pixel_operands(n_p, stride)
    xi = bp_fast._fm_xi(plan, "cpu")[1].numpy()
    got = _kernel_model(ops, ops[2], ops[3], ops[4], xi, plan, n_p)[0]
    want = bp_kernel.accumulate_pallas_plain(*_torch(ops), plan).numpy()
    assert _rel(got, want) < 1e-5


def _factor_model_image(ops, plan, sub_p, passes=3):
    """The factor wrapper's decomposition with the kernel modelled: residual
    phases against each sub-aperture's anchor (ad wrapped, into the ramp),
    inner sums over the live pulses only (the model), then
    merge_subaperture in order."""
    t_ops = _torch(ops)
    ad, bd, cd = bp_factor_kernel.residual_phases(*t_ops[2:5], sub_p)
    assert float(ad.abs().max()) <= np.pi + 1e-6
    xic = bp_fast._coarse_cols(plan.nx_c, plan.nx_i, "cpu")
    j_s = torch.from_numpy(_kernel_model(ops, ad, bd, cd, xic, plan, sub_p,
                                         passes).astype(np.complex64))
    ci = bp_fast.subaperture_anchors(ops[0].shape[0], sub_p, "cpu")
    assert ci.tolist() == [2, 6, 10]
    u_mat = torch.from_numpy(bp_fast._upsample_matrix(plan))
    xi = bp_fast._fm_xi(plan, "cpu")[1]
    img = torch.zeros((plan.ny_i, plan.nx_i), dtype=torch.complex64)
    for s in range(j_s.shape[0]):
        img = bp_fast.merge_subaperture(img, j_s[s], u_mat, t_ops[2][ci[s]],
                                        t_ops[3][ci[s]], t_ops[4][ci[s]], xi)
    return img.numpy()


def test_kernel_model_and_merge_match_factor_plain():
    """The factor wrapper's decomposition (_factor_model_image: the model
    at W 32, a stacked depth of 64) equals _accumulate_factor to 1e-5 of
    the peak."""
    ops, plan = _factor_operands()
    want = bp_factor_kernel.accumulate_factor_pallas_plain(*_torch(ops), plan,
                                                           4)
    assert _rel(_factor_model_image(ops, plan, 4), want.numpy()) < 1e-5


@pytest.mark.parametrize("factor", [False, True])
def test_kernel_model_needs_three_tf32_passes(factor):
    """Why three passes: one TF32 pass (hi.hi, 11 significant bits) lands
    an order of magnitude above the 1e-5 bound, three land well inside it
    (and inside 1e-4, the kernel-vs-plain bound on the card)."""
    if factor:
        ops, plan = _factor_operands()
        want = bp_factor_kernel.accumulate_factor_pallas_plain(
            *_torch(ops), plan, 4).numpy()
        errs = {p: _rel(_factor_model_image(ops, plan, 4, p), want)
                for p in (1, 3)}
    else:
        ops, plan = _pixel_operands(5)
        xi = bp_fast._fm_xi(plan, "cpu")[1].numpy()
        want = bp_kernel.accumulate_pallas_plain(*_torch(ops), plan).numpy()
        errs = {p: _rel(_kernel_model(ops, *ops[2:5], xi, plan, 5, p)[0],
                        want) for p in (1, 3)}
    assert errs[3] < 1e-5 < errs[1] and errs[1] > 10 * errs[3], errs


@pytest.mark.parametrize("bad,err,match", [
    (dict(rc2=lambda x: x.to(torch.complex128)), TypeError, "complex64"),
    (dict(u0=lambda x: x[:, :64]), ValueError, "shape"),
    (dict(pa=lambda x: x.t().contiguous().t()), ValueError, "contiguous"),
    (dict(b_t=lambda x: x.double()), TypeError, "float32"),
    (dict(rc2=lambda x: x[:, :150].contiguous()), ValueError, "band"),
])
def test_launch_checks_operands(bad, err, match):
    """The launch refuses what the kernel does not take, before any build."""
    ops, plan = _pixel_operands(5)
    names = ("rc2", "u0", "pa", "pb", "pc", "b_t", "c_t")
    args = [bad[k](v) if k in bad else v for k, v in zip(names, _torch(ops))]
    xi = bp_fast._fm_xi(plan, "cpu")[1]
    with pytest.raises(err, match=match):
        bp_kernel.launch_accumulate("k", *args, xi, plan, 5, 1)


# --------------------------------------------------------------------------
# focus_bp_fast on the kernel routes
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kernel_scene():
    return _scene(n_p=64, ns=10000)            # nfft 16,384: kernel nfft


@pytest.mark.parametrize("acc,w,factorize", [("pallas", 64, False),
                                             ("factor_kernel", 32, True)])
def test_focus_kernel_routes_match_reference_and_oracle(kernel_scene, acc, w,
                                                        factorize):
    """The port on the CPU (recentre and accumulate kernels' plain
    versions) vs the reference's interpret-mode route to 2e-4, and vs the
    port's f64 oracle within the presum budgets."""
    raw, traj, kw, t0, vf = kernel_scene
    p = bp.BpParams(**kw)
    plan = bp_fast.make_plan(p, traj.positions, traj.times, t0, w_win=w,
                             factorize=factorize)
    assert plan.w_win == w and (plan.sub_raw > 0) == factorize
    args = (traj.positions, traj.velocities, traj.times, vf, t0)
    got = bp_fast.focus_bp_fast(torch.from_numpy(raw), *args, p, presum=2,
                                plan=plan, accumulate=acc).numpy()
    want = np.asarray(jbpf.focus_bp_fast(
        jnp.asarray(raw), *args, jbp.BpParams(**kw), presum=2,
        plan=jbpf.FastBpPlan(**dataclasses.asdict(plan)),
        accumulate=acc + "_interpret"))
    assert _rel(got, want) < 2e-4
    _check(got, _port_oracle(raw, traj, kw, t0, vf), peak_db=0.15,
           peak_phase=0.02, field=0.015)
    if acc == "pallas":                    # the default plan has w_win 64
        np.testing.assert_array_equal(got, bp_fast.focus_bp_fast(
            torch.from_numpy(raw), *args, p, presum=2,
            accumulate=acc).numpy())


@pytest.mark.parametrize("sub_raw,nx_c", [(0, 128), (4, 64)])
def test_factor_kernel_routing_off_the_kernel(sub_raw, nx_c):
    """Plans the coarse-tile kernel refuses (no sub-aperture; a 64-column
    coarse grid): on CPU tensors the reference's routing, to the plain
    iso-range or factorized accumulate, exactly; off the CPU a ValueError
    naming the plan, never a quiet plain run."""
    ops, plan = _factor_operands()
    plan = dataclasses.replace(plan, sub_raw=sub_raw, nx_c=nx_c)
    assert not bp_factor_kernel.supported(plan)
    coeffs = (*_torch(ops), plan)
    before = bp_factor_kernel.accumulate_factor_pallas.launches
    got = bp_fast.accumulate_grid("factor_kernel", coeffs, 1)
    want = (bp_fast._accumulate_factor(*coeffs, sub_raw) if sub_raw
            else bp_fast._accumulate(*coeffs))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bp_factor_kernel.accumulate_factor_pallas.launches == before
    meta = tuple(torch.empty_like(t, device="meta") for t in coeffs[:-1])
    with pytest.raises(ValueError, match="pick 'factor_pallas'"):
        bp_fast.accumulate_grid("factor_kernel", (*meta, plan), 1)


def test_pallas_needs_a_kernel_nfft():
    raw, traj, kw, t0, vf = _scene()                 # nfft 1024
    with pytest.raises(ValueError, match="pick 'xla'"):
        bp_fast.focus_bp_fast(torch.from_numpy(raw), traj.positions,
                              traj.velocities, traj.times, vf, t0,
                              bp.BpParams(**kw), accumulate="pallas")


# --------------------------------------------------------------------------
# videosar.run(bp_backend='fast_pallas')
# --------------------------------------------------------------------------

def _direct_frames(sc, pt):
    """Each schedule frame of ``run`` (MOVER, mBP, noise off) by a direct
    focus_bp_fast(accumulate='pallas') call, and the plan ``run`` builds."""
    r, g, v = sc.radar, sc.geometry, sc.video
    sched = scheduler.make_schedule(v, r.prf_hz)
    traj = orbit.make_trajectory(g, np.linspace(
        -v.duration_s / 2.0, v.duration_s / 2.0, sched.total_pulses))
    phi = np.radians(MOVER["heading_deg"])
    vel = MOVER["speed_mps"] * np.array([np.cos(phi), np.sin(phi), 0.0])
    swath = sc.processing.bp_scene_size_m
    opts = videosar.spotlight_echo_opts(
        sc, videosar.antenna_length_for_swath(sc, swath))
    t0 = window_start_time(g.slant_range_m, opts, sc.collect.window_length_s,
                           "centered")
    p = videosar.bp_params_for(sc, opts)
    d = sc.processing.bp_presum or bp.presum_factor(
        p, r.prf_hz, r.wavelength_m, g.slant_range_m,
        g.effective_velocity_mps)
    plan = bp_fast.make_plan(p, traj.positions, traj.times, float(t0),
                             w_win=64)
    frames = []
    for i0 in sched.starts:
        sl = traj.slice(int(i0), int(i0) + sched.cpi_pulses)
        raw = phase_history(sl, pt.rotate_z(MOVER["heading_deg"]), opts,
                            t_start=t0, target_velocity=vel, device="cpu")
        frames.append(bp_fast.focus_bp_fast(
            raw, sl.positions, sl.velocities, sl.times, vel, float(t0), p,
            presum=d, plan=plan, accumulate="pallas").numpy())
    return np.stack(frames), plan


@pytest.fixture(scope="module")
def pallas_runs():
    pt = T.point_target((0.0, 0.0, 0.0), 50.0)
    kw = dict(algorithm="mbp", bp_backend="fast_pallas",
              noise_mode="per_segment", device="cpu", **MOVER)
    return {mode: videosar.run(_stream(tcfg), pt, stream_spectra=mode,
                               **kw).images for mode in (False, "ring")}


def test_run_fast_pallas_equals_direct_calls(pallas_runs):
    want, plan = _direct_frames(_stream(tcfg),
                                T.point_target((0.0, 0.0, 0.0), 50.0))
    assert plan.w_win == 64 and bp_kernel.supported(plan)
    got = pallas_runs[False]
    assert got.shape == want.shape and got.shape[0] >= 3
    for f in range(got.shape[0]):
        assert _rel(got[f], want[f]) < 1e-5, f


def test_run_fast_pallas_ring_agrees_with_per_frame(pallas_runs):
    """The spectra ring (forward spectra + recentre from spectra) against
    the per-frame fused recentre: the reference's 2e-3 bound."""
    a, b = pallas_runs[False], pallas_runs["ring"]
    assert a.shape == b.shape
    assert _rel(b, a) < 2e-3


def _unsupported_pallas_scene():
    """A 480 m scene at the 512-sample window: a 400-row w_win=64 plan,
    which the pixel-tile kernel refuses."""
    return _reduced(tcfg).replace(processing=dataclasses.replace(
        _reduced(tcfg).processing, bp_scene_size_m=480.0))


def test_run_fast_pallas_falls_back_on_an_unsupported_plan():
    """On the CPU, 'fast_pallas' runs 'fast' (32-sample windows) on a plan
    the kernel refuses, as the reference does."""
    sc = _unsupported_pallas_scene()
    pt = T.point_target((0.0, 0.0, 0.0), 50.0)
    kw = dict(algorithm="mbp", device="cpu", **MOVER)
    before = bp_kernel.accumulate_pallas.launches
    got = videosar.run(sc, pt, bp_backend="fast_pallas", **kw).images
    np.testing.assert_array_equal(
        got, videosar.run(sc, pt, bp_backend="fast", **kw).images)
    assert bp_kernel.accumulate_pallas.launches == before


def test_run_fast_pallas_refuses_an_unsupported_plan_off_the_cpu():
    """Off the CPU the same plan raises (the plan is built before any
    tensor work, so a meta device reaches the check here)."""
    with pytest.raises(ValueError, match="400 x .*pick 'fast'"):
        videosar.run(_unsupported_pallas_scene(),
                     T.point_target((0.0, 0.0, 0.0), 50.0), algorithm="mbp",
                     bp_backend="fast_pallas", device="meta", **MOVER)
