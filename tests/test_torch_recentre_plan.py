"""The recentre kernels' plan (``csrc/fft_kernel.cu``: recenter_presum_kernel
and recentre_spectra_kernel on forward spectra's Fwd<B1, R> clusters),
modelled in NumPy and torch on the CPU, with no launch:

- the factored ramp: E2[k2] E1[k1] as the kernels build it (ramp_factor)
  equals the per-point ramp exp(j (2 pi / N ((f si) mod N + f_signed sf) +
  car)) and the plain version's exp(j 2 pi f_signed shift / N + j car) for
  every f, in float64 to 1e-12, and in float32 (the kernels' arithmetic) to
  the float32 per-point ramp's own error class;
- the kernels' data movement in float64: the thread-to-point map (rank, tid,
  q = 8 i + ka') <-> f = k2 + B1 (kb' + 16 ka'), the d-pulse accumulation in
  that layout, and the FFT conv's inverse digit order (the rows' inverse 8-
  and 16-point DFTs, the push to the column owners, the columns' inverse A-
  and 16-point DFTs) down to the band rows n2 = a + A b, against
  np.fft.ifft of the presummed spectra;
- the per-pulse scalars the kernels form from the trajectory (their plain
  version, ``kernel_scalars_plain``): a ring's scalars are the
  chronological ones rolled, the trajectory at each group's centre pulse;
- the fused kernel's filter table is forward spectra's ``_filter_layout``,
  and both kernels take the float64 trajectory, the ring offset and the
  plain version's constants (the wrappers' launch arguments, captured on
  CPU tensors).

The kernels themselves are held to their plain versions on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py phase 6)."""

import dataclasses

import numpy as np
import pytest
import torch

from nis_sar_amtigmti_video_tpu_torch import config
from nis_sar_amtigmti_video_tpu_torch.geometry import orbit
from nis_sar_amtigmti_video_tpu_torch.ops import bp
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build, fft_kernel

torch.set_num_threads(1)

# nfft -> the launchers' Fwd<B1, R>
PLANS = {16384: (128, 32), 32768: (256, 32), 65536: (512, 64)}


def _si_cases(n, rng):
    return [0, 1, n // 2, n - 1, int(rng.integers(2, n - 1))]


def ramp_factors(n, si, sf, car, d, dtype):
    """The kernels' ramp_factor for one pulse in ``dtype`` (float64 or
    float32): E2[k2] for every k2 < B1 and E1[k1] / d for k1 < 128, each
    phase formed from (k si) mod N, the signed frequency and the carrier as
    the kernel forms it."""
    b1 = n // 128
    f = np.dtype(dtype).type
    two_pi_n = f(2 * np.pi) / f(n)
    k2 = np.arange(b1, dtype=np.int64)
    ph2 = ((k2 * si) % n).astype(dtype) + k2.astype(dtype) * f(sf)
    e2 = np.exp(1j * (ph2 * two_pi_n)).astype(
        np.complex128 if f is np.float64 else np.complex64)
    k1 = np.arange(128, dtype=np.int64)
    ks = b1 * k1 - n * (k1 >= 64)
    ph1 = (((b1 * k1 * si) % n).astype(dtype) + ks.astype(dtype) * f(sf)) \
        * two_pi_n + f(car)
    if f is np.float32:
        e1 = (np.cos(ph1) + 1j * np.sin(ph1)).astype(np.complex64)
        e1 = e1 * np.float32(1.0 / d)
    else:
        e1 = np.exp(1j * ph1) / d
    return e2, e1


@pytest.mark.parametrize("nfft", sorted(PLANS))
def test_factored_ramp_is_the_per_point_ramp(nfft):
    """E2[f % B1] E1[f // B1] against the per-point ramp, every f, for si
    in {0, 1, N/2, N-1, seeded} and seeded sf in [-0.5, 0.5], carrier in
    [-pi, pi], d 4."""
    rng = np.random.default_rng(nfft)
    b1, d = nfft // 128, 4
    f = np.arange(nfft)
    fs = np.where(f >= nfft // 2, f - nfft, f)
    worst32 = worst_pp32 = 0.0
    for si in _si_cases(nfft, rng):
        for sf in (-0.5, 0.5, *rng.uniform(-0.5, 0.5, 3)):
            car = float(rng.uniform(-np.pi, np.pi))
            per_point = np.exp(1j * (2 * np.pi / nfft
                                     * ((f * si) % nfft + fs * sf) + car))
            # the plain version's ramp of shift = si + sf (mod N)
            plain = np.exp(1j * (2 * np.pi * fs * (si + sf) / nfft + car))
            np.testing.assert_allclose(per_point, plain, rtol=0, atol=1e-9)
            e2, e1 = ramp_factors(nfft, si, sf, car, d, np.float64)
            got = e2[f % b1] * e1[f // b1] * d
            assert np.abs(got - per_point).max() < 1e-12, (si, sf)
            e2, e1 = ramp_factors(nfft, si, sf, car, d, np.float32)
            got = (e2[f % b1] * e1[f // b1]).astype(np.complex128) * d
            worst32 = max(worst32, float(np.abs(got - per_point).max()))
            # the first design's per-point ramp in float32, for its class
            two_pi_n = np.float32(2 * np.pi) / np.float32(nfft)
            ph = (((f * si) % nfft).astype(np.float32)
                  + fs.astype(np.float32) * np.float32(sf)) * two_pi_n \
                + np.float32(car)
            pp32 = np.cos(ph) + 1j * np.sin(ph)
            worst_pp32 = max(worst_pp32, float(np.abs(pp32 - per_point).max()))
    # float32: a few 1e-7 rad from each phase's rounding and the product's;
    # the per-point ramp's own error is of the same class
    assert worst32 < 4e-6, worst32
    assert worst32 < 4 * worst_pp32 + 1e-6, (worst32, worst_pp32)


def _dft(x, axis, inverse):
    """Unnormalised DFT along ``axis`` (inverse: exp(+j ...))."""
    n = x.shape[axis]
    k = np.arange(n)
    w = np.exp((2j if inverse else -2j) * np.pi * np.outer(k, k) / n)
    return np.moveaxis(np.tensordot(np.moveaxis(x, axis, -1), w, axes=(-1, 0)),
                       -1, axis)


def accumulate_model(spec, ramps, d, b1, r):
    """The thread-to-point map and the presum: acc[rank, tid, q] = sum over
    the group's pulses of spectrum x ramp / d at f = k2 + B1 k1, k2 = rank R
    + r', k1 = kb' + 16 ka', for q = 8 i + ka' of item j = tid + i T (r' =
    j // 16, kb' = j % 16). Returns acc and the f of each slot."""
    cs, t = b1 // r, 8 * r
    rank, tid, i, ka = np.meshgrid(np.arange(cs), np.arange(t), np.arange(2),
                                   np.arange(8), indexing="ij")
    j = tid + i * t
    k2, k1 = rank * r + j // 16, j % 16 + 16 * ka
    f = (k2 + b1 * k1).reshape(cs, t, 16)
    acc = np.zeros((cs, t, 16), np.complex128)
    for p in range(d):                       # in order, as the kernels add
        acc += spec[p][f] * ramps[p][f] / d
    return acc, f


def inverse_model(acc, b1, r, p0, p1):
    """The kernels' presum_inverse (the FFT conv's inverse) in float64:
    acc[rank, tid, q] -> band rows [p0, p1) of the inverse / N as out[n2 -
    p0, n1]."""
    n = 128 * b1
    cs, t, c_w, a_w = b1 // r, 8 * r, 128 // (b1 // r), b1 // 16
    # rows, inverse first half: per item (r', kb') the inverse DFT8 over
    # ka', conj W128^(a' kb'), into the transpose [kb'][r'][a']
    u = _dft(acc.reshape(cs, t, 2, 8), 3, True)
    j = np.arange(t)[:, None] + np.arange(2)[None, :] * t       # [tid, i]
    kb, rr = j % 16, j // 16
    u = u * np.exp(2j * np.pi * np.arange(8)[None, None, None, :]
                   * kb[None, :, :, None] / 128)
    rows = np.zeros((cs, 16, r, 8), np.complex128)
    rows[:, kb, rr, :] = u
    # rows, inverse second half: thread (r', a') the inverse DFT16 over kb'
    # (n1 = a' + 8 b'), conj WN^(k2 n1), pushed to the owner of n1 at
    # [k2][n1 % C]
    y = _dft(rows, 1, True)                          # [rank, b', r', a']
    k2 = np.arange(cs)[:, None, None, None] * r \
        + np.arange(r)[None, None, :, None]
    n1 = np.arange(8)[None, None, None, :] + 8 * np.arange(16)[None, :, None,
                                                               None]
    y = y * np.exp(2j * np.pi * k2 * n1 / n)
    cols = np.zeros((cs, b1, c_w), np.complex128)           # [owner][k2][c]
    k2b, n1b = np.broadcast_arrays(k2, n1)
    cols[n1b // c_w, k2b, n1b % c_w] = y
    # columns, inverse first half: per (c, kb) the inverse DFT-A over ka
    # (k2 = kb + 16 ka), conj WB1^(kb a), into [a][kb][c]
    w = _dft(cols.reshape(cs, a_w, 16, c_w), 1, True)       # [o, a, kb, c]
    w = w * np.exp(2j * np.pi * np.arange(a_w)[None, :, None, None]
                   * np.arange(16)[None, None, :, None] / b1)
    # columns, inverse second half: thread (c, a) the inverse DFT16 over kb,
    # n2 = a + A b
    z = _dft(w, 2, True) / n                                 # [o, a, b, c]
    x = np.zeros((b1, 128), np.complex128)                   # [n2][n1]
    o, a, b, c = np.meshgrid(np.arange(cs), np.arange(a_w), np.arange(16),
                             np.arange(c_w), indexing="ij")
    x[a + a_w * b, o * c_w + c] = z
    return x[p0:p1]


@pytest.mark.parametrize("nfft", sorted(PLANS))
def test_data_movement_model_matches_ifft(nfft):
    b1, r = PLANS[nfft]
    d, p0, p1 = 3, b1 // 3, b1 // 3 + 11
    rng = np.random.default_rng(nfft + 1)
    spec = rng.standard_normal((d, nfft)) + 1j * rng.standard_normal((d, nfft))
    ramps = []
    f = np.arange(nfft)
    fs = np.where(f >= nfft // 2, f - nfft, f)
    for _ in range(d):
        si, sf = int(rng.integers(nfft)), float(rng.uniform(-0.5, 0.5))
        car = float(rng.uniform(-np.pi, np.pi))
        e2, e1 = ramp_factors(nfft, si, sf, car, 1, np.float64)
        ramps.append(e2[f % b1] * e1[f // b1])
        np.testing.assert_allclose(
            ramps[-1], np.exp(1j * (2 * np.pi * fs * (si + sf) / nfft + car)),
            rtol=0, atol=1e-9)
    acc, slots = accumulate_model(spec, ramps, d, b1, r)
    # the map covers every frequency once
    assert np.array_equal(np.sort(slots.ravel()), f)
    got = inverse_model(acc, b1, r, p0, p1)
    want = np.fft.ifft(sum(s * m for s, m in zip(spec, ramps)) / d)
    want = want[p0 * 128:p1 * 128].reshape(p1 - p0, 128)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _trajectory(n_p):
    sc = config.videosar()
    r = sc.radar
    traj = orbit.make_trajectory(sc.geometry,
                                 orbit.slow_time_grid(n_p / r.prf_hz, n_p))
    p = bp.BpParams(fc_hz=r.fc_hz, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
                    pulse_width_s=r.pulse_width_s, num_samples=10000)
    tr = [torch.as_tensor(a) for a in
          (traj.positions, traj.velocities, traj.times)]
    return tr, torch.tensor([3.0, -2.0, 0.0], dtype=torch.float64), p


@pytest.mark.parametrize("off", [3, 6, 9])
def test_kernel_scalars_ring_order(off):
    """What the recentre kernels form for each pulse (``pulse_scalars``;
    its plain version): slot j of a ring holds pulse (j - off) mod P, so the
    ring's scalars are the chronological ones rolled; si + sf is the shift
    mod nfft and car the carrier mod 2 pi; the trajectory is at each group's
    centre pulse min(g d + d // 2, P - 1), chronological."""
    n_p, d, nfft, t_ref = 12, 3, 16384, 1e-4
    tr, vf, p = _trajectory(n_p)
    args = (*tr, vf, p, d, t_ref, nfft)
    chrono = fft_kernel.kernel_scalars_plain(*args)
    ring = fft_kernel.kernel_scalars_plain(*args, ring_offset=off)
    si, sf, car = chrono[:3]
    assert (si.dtype, sf.dtype, car.dtype) == (torch.int32, torch.float32,
                                               torch.float32)
    assert int(si.min()) >= 0 and int(si.max()) < nfft
    assert float(sf.abs().max()) <= 0.5 and float(car.abs().max()) <= np.pi
    shift, carrier = fft_kernel.bp_fast.recentre_scalars(tr[0], tr[2], vf, p,
                                                         t_ref)
    dsh = torch.remainder(si.double() + sf.double() - shift + nfft / 2,
                          nfft) - nfft / 2
    dcar = torch.remainder(car.double() - carrier + np.pi, 2 * np.pi) - np.pi
    assert float(dsh.abs().max()) <= 1e-6 and float(dcar.abs().max()) <= 1e-6
    for a, b in zip(ring[:3], chrono[:3]):
        assert torch.equal(a, torch.roll(b, off))
    ci = [min(g * d + d // 2, n_p - 1) for g in range(n_p // d)]
    for got, full in zip(ring[3:], tr):
        assert torch.equal(got, full[ci])
    with pytest.raises(ValueError, match="ring_offset"):
        fft_kernel.kernel_scalars_plain(*args, ring_offset=4)


@pytest.fixture
def captured(monkeypatch):
    """The wrappers' launches on CPU tensors, recorded instead of run:
    (launcher name, tensors, ints, doubles) each."""
    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda x: False)
    monkeypatch.setattr(_build, "check", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch",
                        lambda name, tensors, ints, floats=(), doubles=():
                        calls.append((name, tensors, ints, doubles)))
    return calls


def _check_trajectory(args, doubles, tr, vf, p, t_ref):
    """A recentre launch's trajectory operands: float64 pos (P, 3), ts (P),
    vf (3), contiguous, the CPI's mean time, and the plain version's
    constants (c, t_ref, fs, 2 pi 2 fc / c)."""
    pos, ts, v, t_m = args
    for got, want in ((pos, tr[0]), (ts, tr[2]), (v, vf)):
        assert got.dtype == torch.float64 and got.is_contiguous()
        assert torch.equal(got, want.double())
    assert tuple(t_m.shape) == (1,) and float(t_m[0]) == float(ts.mean())
    c = fft_kernel.bp_fast._C
    assert doubles == (c, t_ref, p.fs_hz, 2 * np.pi * (2 * p.fc_hz / c))


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("nfft", sorted(PLANS))
def test_fused_filter_is_forward_spectra_table(captured, nfft, compress):
    """recenter_presum hands its kernel forward spectra's table: the
    spectra layout (B1, 128), k1 natural, the very tensor forward_spectra
    passes; and the float64 trajectory from which the kernel forms each
    pulse's ramp, with no launch before its own."""
    ns = nfft - 5000
    n_p, d, t_ref = 8, 4, 1e-4
    tr, vf, p = _trajectory(n_p)
    p = dataclasses.replace(p, num_samples=ns)
    rc = torch.zeros((n_p, ns), dtype=torch.complex64)
    fft_kernel.recenter_presum(rc, *tr, vf, p, d, t_ref,
                               filter_compress=compress)
    fft_kernel.forward_spectra(rc, p, filter_compress=compress)
    (fused, f_t, f_i, f_d), (fwd, w_t, _, _) = captured
    assert (fused, fwd) == ("recenter_presum_launch", "forward_spectra_launch")
    _check_trajectory(f_t[2:6], f_d, tr, vf, p, t_ref)
    table = fft_kernel._filter_layout(p, nfft, compress, torch.device("cpu"))
    assert f_t[1] is table and w_t[1] is table
    assert tuple(table.shape) == (nfft // 128, 128) and table.is_contiguous()
    assert f_i == (n_p, ns, d, nfft, 0, nfft // 128)


@pytest.mark.parametrize("off", [None, 0, 4, 8, -4])
def test_spectra_launch_takes_trajectory_and_ring_offset(captured, off):
    """recentre_from_spectra hands its kernel the chronological float64
    trajectory and the ring offset mod P (slot j holds pulse (j - off) mod
    P), with no launch before its own."""
    n_p, d, t_ref, b1 = 12, 4, 1e-4, 128
    tr, vf, p = _trajectory(n_p)
    spec = torch.zeros((n_p, b1, 128), dtype=torch.complex64)
    fft_kernel.recentre_from_spectra(spec, *tr, vf, p, d, t_ref,
                                     out_rows=(3, 9), ring_offset=off)
    ((name, t, ints, doubles),) = captured
    assert name == "recentre_spectra_launch" and t[0] is spec
    _check_trajectory(t[1:5], doubles, tr, vf, p, t_ref)
    assert ints == (n_p, d, b1 * 128, 3, 9, (off or 0) % n_p)
