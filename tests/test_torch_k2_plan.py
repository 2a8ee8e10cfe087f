"""K2's plan (``csrc/csa_kernel.cu``: k2_kernel<N> on K2Plan<N>, the range
pass of CSA focusing for one channel or the pair), modelled in NumPy and
torch on the CPU, with no launch, for every row length the kernels take:

- the load and store map: thread tau of a row holds the points tau + T m (T
  = n / 16) in register m; over a block and the plane it is a bijection,
  and each warp's accesses of a plane cover whole 128-byte lines (each
  single access one line from n = 512 up);
- the passes in float64, as the kernel runs them: pass 1's R1-point DFTs of
  the thread's items, the 16-point DFTs after it (dft16: 4 x 4 with
  constant twiddles), the twiddles between passes as products of powers
  of two n-point table values, W^m and W^(4 m) (twiddle_row,
  twiddle_pow), the shared buffer of 17 n / 16 slots a row
  written and read at the kernel's addresses. The forward leaves X[tau + T m]
  in register m (the output digits in natural order, no permutation pass):
  against np.fft.fft to 1e-12; the inverse, the same plan on conjugate
  twiddles, takes that layout back to n x[tau + T m]. Every transpose
  writes each slot it reads, once, inside the row's buffer, and no two
  threads of a half-warp meet in a bank;
- the whole pass in float32 on CPU tensors: the load, the forward passes,
  Phi2 = exp(j (alpha f + beta) f) at fr[tau + T m], the inverse, Phi3 and
  1/n folded into one multiply, the stores, against ``k2_plain`` at the
  port's CSA kernel tolerance (1e-4 of the peak);
- ``k2_plan``'s constants against the launcher's rule and the source's
  K2Plan: 256 threads, 4096 / n rows a block, 34 KB of shared memory,
  three blocks an SM within an H100 SM's 228 KB and 2,048 threads.

The kernel itself is held to its plain version on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py phases 3 and 3b)."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from nis_sar_amtigmti_video_tpu_torch import config
from nis_sar_amtigmti_video_tpu_torch.ops import csa
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build, csa_kernel

torch.set_num_threads(1)

SIDES = [64, 128, 256, 512, 1024, 2048, 4096]


class Model:
    """K2Plan<n> of the kernel: the pass lengths, pitches and buffer, and
    the transform on register arrays v[m] of shape (rows, T) (row of the
    block, thread tau of the row), in the dtype of ``v``. Each access of the
    shared buffer is recorded as (kind, per-thread slot of the block)."""

    def __init__(self, n):
        self.n = n
        self.plan = csa_kernel.k2_plan(n)
        self.t = n // 16
        self.rows = self.plan.rows
        self.slots = 17 * n // 16
        self.passes = len(self.plan.radices)
        self.accesses = []

    def length(self, p):
        """Length of the sequences pass p (from 1) transforms."""
        return self.n if p == 1 else (self.n // self.plan.radices[0]) \
            >> (4 * (p - 2))

    def pitch(self, p):
        return 17 if p == self.passes else self.length(p)

    def twiddle(self, m, inverse, cdtype):
        """twiddle_pow: W_n^m from the table exp(-2 pi i k / n), k < n / 2,
        negated for m >= n / 2, conjugated for the inverse."""
        m = np.asarray(m)
        assert ((0 <= m) & (m < self.n)).all()
        h = self.n // 2
        tw = np.exp(-2j * np.pi * np.arange(h) / self.n).astype(cdtype)
        w = np.where(m < h, tw[m % h], -tw[m % h])
        return np.conj(w) if inverse else w

    def twiddle_row(self, m, k, inverse, cdtype):
        """twiddle_row: W_n^(m k) as W^(m a) W^(4 m b), k = a + 4 b, each
        factor a power of one table value (W^m, W^(4 m)) by products."""
        a, b = k % 4, k // 4
        w = np.ones(np.shape(m), cdtype)
        for _ in range(a):
            w = w * self.twiddle(m, inverse, cdtype)
        for _ in range(b):
            w = w * self.twiddle(4 * m, inverse, cdtype)
        return w

    @staticmethod
    def dft(u, inverse):
        if len(u) == 16:
            return dft16_model(u, inverse, np.real(u[0]).dtype)
        r = len(u)
        k = np.arange(r)
        w = np.exp((2j if inverse else -2j) * np.pi * np.outer(k, k) / r)
        w = w.astype(u[0].dtype)
        return list(np.tensordot(w, np.stack(u), axes=(1, 0)))

    def _access(self, kind, slot):
        """Record a buffer access of every thread (slot: (T,) in the row's
        buffer) and return it as (rows, T) slots of the block."""
        assert ((0 <= slot) & (slot < self.slots)).all()
        full = np.arange(self.rows)[:, None] * self.slots + slot[None, :]
        self.accesses.append((kind, full))
        return full

    def transform(self, v, inverse):
        n, t, cdtype = self.n, self.t, v[0].dtype
        tau = np.arange(t)
        buf = np.full((self.rows * self.slots,), np.nan, cdtype)
        written = set()
        r1 = self.plan.radices[0]
        g, pitch = 16 // r1, self.pitch(2)
        for i in range(g):
            u = self.dft([v[i + g * j] for j in range(r1)], inverse)
            s = tau + t * i
            for k in range(r1):
                val = u[k] if k == 0 else u[k] * self.twiddle_row(
                    s, k, inverse, cdtype)
                at = self._access("write", k * pitch + s)
                assert not written & set(at.ravel().tolist())
                written |= set(at.ravel().tolist())
                buf[at] = val
        for p in range(2, self.passes + 1):
            length, pitch = self.length(p), self.pitch(p)
            s_len, q = length // 16, n // length
            prefix, s = tau // s_len, tau % s_len
            u = []
            for j in range(16):
                at = self._access("read", prefix * pitch + s + s_len * j)
                assert set(at.ravel().tolist()) <= written
                u.append(buf[at])
            u = self.dft(u, inverse)
            if p == self.passes:
                return u
            nxt = self.pitch(p + 1)
            u = [u[0]] + [u[k] * self.twiddle_row(q * s, k, inverse, cdtype)
                          for k in range(1, 16)]
            buf = np.full_like(buf, np.nan)
            written = set()
            for k in range(16):
                at = self._access("write", (prefix + q * k) * nxt + s)
                assert not written & set(at.ravel().tolist())
                written |= set(at.ravel().tolist())
                buf[at] = u[k]
        raise AssertionError("unreachable")

    def load(self, x):
        """v[m] = x[row, tau + T m] for a (rows, n) block of rows."""
        return [x[:, np.arange(self.t) + self.t * m] for m in range(16)]

    def store(self, v):
        out = np.empty((v[0].shape[0], self.n), v[0].dtype)
        for m in range(16):
            out[:, np.arange(self.t) + self.t * m] = v[m]
        return out


def dft16_model(u, inverse, dtype):
    """The kernel's dft16 on 16 arrays: the 4-point DFTs over n2 of n = n1 +
    4 n2, W_16^(n1 k1) from constants cos(2 pi e / 16) rounded to
    ``dtype``, the 4-point DFTs over n1, the renaming k1 + 4 k2."""
    sign = 1 if inverse else -1
    e = np.arange(16)
    cos16 = np.cos(2 * np.pi * e / 16).astype(dtype)
    sin16 = np.sin(2 * np.pi * e / 16).astype(dtype)

    def dft4(x0, x1, x2, x3):
        a0, a1, b0 = x0 + x2, x0 - x2, x1 + x3
        b1 = (x1 - x3) * (1j * sign)
        return a0 + b0, a1 + b1, a0 - b0, a1 - b1

    u = list(u)
    for n1 in range(4):
        u[n1], u[n1 + 4], u[n1 + 8], u[n1 + 12] = dft4(
            u[n1], u[n1 + 4], u[n1 + 8], u[n1 + 12])
    for n1 in range(1, 4):
        for k1 in range(1, 4):
            w = n1 * k1 % 16
            u[n1 + 4 * k1] = u[n1 + 4 * k1] * (cos16[w] + sign * 1j
                                               * sin16[w])
    for k1 in range(4):
        u[4 * k1:4 * k1 + 4] = dft4(*u[4 * k1:4 * k1 + 4])
    return [u[4 * (k % 4) + k // 4] for k in range(16)]


@pytest.mark.parametrize("inverse", [False, True])
def test_dft16_is_the_16_point_dft(inverse):
    """The kernel's constant-twiddle 16-point DFT against np.fft: to 1e-12
    with float64 constants, to float32 rounding with float32 ones."""
    rng = np.random.default_rng(16)
    x = rng.standard_normal((16, 8)) + 1j * rng.standard_normal((16, 8))
    want = (np.fft.ifft(x, axis=0) * 16 if inverse
            else np.fft.fft(x, axis=0))
    got = np.stack(dft16_model(list(x), inverse, np.float64))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    got = np.stack(dft16_model(list(x.astype(np.complex64)), inverse,
                               np.float32))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("n", SIDES)
def test_load_map_is_a_bijection_of_whole_lines(n):
    """(block row, tau, m) -> row n + tau + T m covers each point of a
    block's rows once; each warp's 16 accesses of a plane cover whole
    128-byte lines (32 float32), and from n = 512 each access is one."""
    plan = csa_kernel.k2_plan(n)
    t = n // 16
    tid = np.arange(plan.threads)
    row, tau = tid // t, tid % t
    idx = row[:, None] * n + tau[:, None] + t * np.arange(16)[None, :]
    assert np.array_equal(np.sort(idx.ravel()), np.arange(plan.rows * n))
    for w in range(plan.threads // 32):
        warp = idx[32 * w:32 * (w + 1)]
        lines, counts = np.unique(warp // 32, return_counts=True)
        assert (counts == 32).all(), (w, lines, counts)
        if n >= 512:
            for m in range(16):
                col = warp[:, m]
                assert col.min() % 32 == 0 and np.array_equal(
                    col, col.min() + np.arange(32))


@pytest.mark.parametrize("n", SIDES)
def test_passes_match_numpy_fft_in_float64(n):
    """The forward passes leave X[tau + T m] in register m (natural digit
    order) to 1e-12 of np.fft.fft; the inverse passes take that layout to
    n x[tau + T m] (np.fft.ifft x n)."""
    model = Model(n)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((model.rows, n)) \
        + 1j * rng.standard_normal((model.rows, n))
    spec = model.store(model.transform(model.load(x), inverse=False))
    want = np.fft.fft(x, axis=-1)
    assert np.abs(spec - want).max() <= 1e-12 * np.abs(want).max()
    back = model.store(model.transform(model.load(want), inverse=True))
    assert np.abs(back - n * x).max() <= 1e-12 * n * np.abs(x).max()


@pytest.mark.parametrize("n", SIDES)
def test_transposes_are_free_of_bank_conflicts(n):
    """Every access of the shared buffer: the 16 threads of each half-warp
    touch 16 different 8-byte banks (slot mod 16), and the passes' radices
    multiply to n with the first 2^(log2 n mod 4) and the rest 16."""
    model = Model(n)
    radices = model.plan.radices
    assert int(np.prod(radices)) == n and all(r == 16 for r in radices[1:])
    low = (n.bit_length() - 1) % 4
    assert radices[0] == (1 << low if low else 16)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((model.rows, n)).astype(np.complex128)
    model.transform(model.load(x), inverse=False)
    assert len(model.accesses) > 0
    for kind, slots in model.accesses:
        per_thread = slots.reshape(-1)       # block threads in tid order
        for h in range(0, per_thread.size, 16):
            banks = per_thread[h:h + 16] % 16
            assert len(set(banks.tolist())) == 16, (kind, h, banks)


def _factors(n_az, n_rg):
    """The slice's CSA factors (ati_dpca with the CLI's --small waveform)."""
    sc = config.ati_dpca()
    r = dataclasses.replace(sc.radar, bandwidth_hz=120e6, pulse_width_s=2e-6,
                            fs_hz=150e6)
    g = sc.geometry
    return csa.csa_factors(csa.CsaParams(
        wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
        prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m,
        t_start_fast=2.0 * g.slant_range_m / 299792458.0 - 2e-6,
        num_pulses=n_az, num_samples=n_rg), torch.device("cpu"))


def k2_model(xr, xi, f):
    """The kernel's pass in float32, block by block: loads, forward passes,
    Phi2 at fr[tau + T m] with the kernel's argument (al f + be) f, inverse
    passes, Phi3 x 1/n, stores."""
    n_az, n = xr.shape
    model = Model(n)
    t = model.t
    x = (xr.numpy() + 1j * xi.numpy()).astype(np.complex64)
    fr, usq = f.fr.numpy(), (f.u * f.u).numpy()
    cph, dr = f.cphase.numpy(), f.dr.numpy()
    out = np.empty_like(x)
    for b in range(0, n_az, model.rows):
        rows = slice(b, b + model.rows)
        v = model.transform(model.load(x[rows]), inverse=False)
        al = f.alpha.numpy()[rows, None]
        be = f.beta.numpy()[rows, None]
        for m in range(16):
            fm = fr[np.arange(t) + t * m][None, :]
            ph = (al * fm + be) * fm
            v[m] = v[m] * (np.cos(ph) + 1j * np.sin(ph)).astype(np.complex64)
        v = model.transform(v, inverse=True)
        rp = f.rphase.numpy()[rows, None]
        gg = f.g.numpy()[rows, None]
        cc = f.c3.numpy()[rows, None]
        for m in range(16):
            i = np.arange(t) + t * m
            ph = rp + cph[i] + gg * dr[i] - cc * usq[i]
            v[m] = (v[m] * np.float32(1.0 / n)) \
                * (np.cos(ph) + 1j * np.sin(ph)).astype(np.complex64)
        out[rows] = model.store(v)
    return out


@pytest.mark.parametrize("shape", [(64, n) for n in SIDES] + [(128, 64)])
def test_whole_pass_matches_k2_plain(shape):
    """The plan's float32 pass (Phi2 in the forward's digit order, the
    inverse back to natural order, 1/n in Phi3) against k2_plain on CPU
    tensors, at 1e-4 of the peak."""
    n_az, n_rg = shape
    f = _factors(n_az, n_rg)
    rng = np.random.default_rng(n_rg)
    xr, xi = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
              for _ in range(2))
    got = k2_model(xr, xi, f)
    wr, wi = csa_kernel.k2_plain(xr, xi, f)
    want = wr.numpy() + 1j * wi.numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _source_plan():
    """K2Plan's constants as csrc/csa_kernel.cu states them."""
    src = (_build.SOURCE_DIR / "csa_kernel.cu").read_text()
    body = src[src.index("struct K2Plan"):]
    body = body[:body.index("\n};")]

    def const(name):
        return re.search(rf"\b{name} = ([^;]+);", body).group(1).strip()
    return {k: const(k) for k in ("kThreads", "kBlocksPerSm", "kRowSlots",
                                  "T", "kRows")}


@pytest.mark.parametrize("n", SIDES)
def test_plan_constants_follow_the_launcher(n):
    """k2_plan: 256 threads of 16 points, n / 16 a row, 4096 / n rows a
    block (a divisor of every supported n_az), 17 n / 16 slots of 8 bytes a
    row; three blocks an SM fit 228 KB (1 KB of it the runtime's a block)
    and 2,048 threads. The source's K2Plan states the same rule."""
    plan = csa_kernel.k2_plan(n)
    assert plan.threads == csa_kernel.K2_THREADS == 256
    assert plan.rows * n // csa_kernel.K2_POINTS == plan.threads
    assert plan.rows == 4096 // n
    assert all(n_az % plan.rows == 0 for n_az in SIDES)
    assert plan.smem == plan.rows * (17 * n // 16) * 8 == 34816
    assert plan.blocks_per_sm * (plan.smem + 1024) <= 233472
    assert plan.blocks_per_sm * plan.threads <= 2048
    src = _source_plan()
    assert src == {"kThreads": str(csa_kernel.K2_THREADS),
                   "kBlocksPerSm": str(csa_kernel.K2_BLOCKS_PER_SM),
                   "kRowSlots": "17 * N / 16", "T": "N / 16",
                   "kRows": "kThreads / T"}


def test_plan_refuses_unsupported_sides():
    for n in (32, 96, 8192):
        with pytest.raises(ValueError):
            csa_kernel.k2_plan(n)
