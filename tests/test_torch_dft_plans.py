"""The CPI kernels' DFT plans at sides that are not powers of two, emulated
in plain NumPy with the factorisation, the tables and the order of work the
kernels read, and held to NumPy's float64 FFT.

* K2's mixed-radix plan (``csrc/csa_kernel.cu``, ``k2_kernel<0>``): the
  forward transform decimates in frequency, in place, one pass per radix of
  ``csa_kernel.mixed_radices`` (the tables of ``csa_kernel.range_plan``);
  the spectrum lies at the positions of ``csa_kernel.mixed_order``; the
  inverse runs the passes backwards with conjugate twiddles and leaves the
  natural order.
* The factored azimuth transform (``csrc/gmti_kernel.cu``, STAGE
  kFactored): the Good-Thomas split n = n1 x n2 of
  ``csa_kernel.factored_split`` with the index maps, the local passes
  (``csa_kernel.local_radices``, or Rader's convolution for a prime n2),
  the slots of ``csa_kernel.azimuth_plan``'s index table and the n1-point
  gather across the cluster.
* The chirp-z azimuth transform (``csrc/gmti_kernel.cu``, the column pass's
  one chirp-z launch): the chirp, the convolution's spectrum and the
  m-point twiddle table of ``csa_kernel.azimuth_plan``, the column pass's
  split of m into CS x QA x QB (``column_split``), a forward transform,
  the product with the spectrum, the spectrum moved block by block from the
  forward gather to the inverse pass A as the kernel moves it in shared
  memory, an inverse transform and the chirp again.

The plans' DFTs of a few points run as dense products with the table's
values (the kernels' register DFTs are the same sums in another order)."""

import numpy as np
import pytest
import torch

from nis_sar_amtigmti_video_tpu_torch.ops.cuda import csa_kernel as tck

torch.set_num_threads(1)


def _c64(t):
    return t.numpy() if isinstance(t, torch.Tensor) else t


def _small(u, r, tw, n, inverse):
    """The r-point DFT over u's last axis with W_r^q = tw[q n / r] of the
    n-point table ``tw`` (complex64)."""
    q = (np.outer(np.arange(r), np.arange(r)) % r) * (n // r)
    w = tw[q]
    if inverse:
        w = np.conj(w)
    return (u @ w).astype(np.complex64)


def mixed_forward(x, tw, inverse=False, radices=None, sign=None):
    """K2's mixed-radix plan over x's last axis (complex64): forward
    (spectrum at mixed_order's positions) or, with ``inverse``, the
    unnormalised inverse from those positions to the natural order.
    ``radices`` (mixed_radices(n) when None) and ``sign`` (the direction of
    the DFTs and twiddles; ``inverse`` when None) serve the factored kind's
    local passes, whose forward passes also run the inverse DFT (K3)."""
    n = x.shape[-1]
    tw = _c64(tw)
    lead = x.shape[:-1]
    sign = inverse if sign is None else sign
    passes, left = [], n
    for r in radices or tck.mixed_radices(n):
        passes.append((left, r))
        left //= r
    v = x.astype(np.complex64)
    for ln, r in (reversed(passes) if inverse else passes):
        s_len = ln // r
        # position base + s + s_len j of each block of ln
        u = v.reshape(lead + (n // ln, r, s_len))
        s = np.arange(s_len)[:, None]
        k = np.arange(r)[None, :]
        w = tw[(s * k * (n // ln)) % n]            # W_ln^(s k)
        if sign:
            w = np.conj(w)
        u = np.swapaxes(u, -1, -2)                 # (..., blk, s, j)
        if inverse:
            u = _small(u * w, r, tw, n, sign)
        else:
            u = _small(u, r, tw, n, sign) * w
        v = np.swapaxes(u, -1, -2).reshape(lead + (n,)).astype(np.complex64)
    return v


MIXED_SIDES = [120, 165, 693, 2197, 8192, 13200]


@pytest.mark.parametrize("n", MIXED_SIDES)
def test_mixed_radix_plan_is_the_dft(n):
    """Forward: the spectrum at mixed_order's positions; inverse from
    there: n x the natural-order inverse; both to float32 rounding."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
         ).astype(np.complex64)
    plan = tck.range_plan(n)
    tw = (plan.tw if plan.passes else tck.full_twiddle_table(n)).numpy()
    order = tck.mixed_order(n)
    got = mixed_forward(x, tw)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    err = np.abs(got - want[:, order]).max() / np.abs(want).max()
    assert err < 2e-6
    back = mixed_forward(got, tw, inverse=True)
    assert np.abs(back / n - x).max() / np.abs(x).max() < 2e-6
    assert not plan.passes or np.array_equal(plan.order.numpy(), order)


def test_mixed_radices_and_order():
    assert tck.mixed_radices(13200) == (16, 11, 5, 5, 3)
    assert tck.mixed_radices(16384) == (16, 16, 16, 4)
    assert tck.mixed_radices(165) == (11, 5, 3)
    for n in (96, 120, 13200):
        o = tck.mixed_order(n)
        assert o.dtype == np.int32 and np.array_equal(np.sort(o),
                                                      np.arange(n))
    with pytest.raises(ValueError, match="prime factor"):
        tck.mixed_radices(17 * 16)


def _twp(tw, m, n, inverse):
    """W_n^m from the n-point half table, as nis::twiddle_pow reads it."""
    m = np.asarray(m) % n
    h = n // 2
    w = tw[np.where(m < h, m, m - h)]
    w = np.where(m < h, w, -w)
    return np.conj(w) if inverse else w


def column_passes(x, tw, cs, inverse):
    """Passes A and B of the column pass's unnormalised DFT of x's rows
    (m, cols) in its four-step split n = n1 + CS q, q = qb + QB qa: pass A
    (QA points), x W_Q^(qb ja), pass B (QB points), x W_m^(n1 j). Returns
    Y (CS, Q, cols): block n1's Y_n1[j], j = ja + QA jb."""
    m = x.shape[0]
    qa, qb = tck.column_split(m, cs)
    tw = _c64(tw)
    # x[n1 + cs (qb + QB qa)] -> (n1, qb, qa, col)
    v = x.reshape(qa, qb, cs, -1).transpose(2, 1, 0, 3)
    wa = _twp(tw, np.outer(np.arange(qa), np.arange(qa)) * (m // qa), m,
              inverse)
    v = np.einsum("nbac,aj->nbjc", v, wa)
    v = v * _twp(tw, cs * np.outer(np.arange(qb), np.arange(qa)), m,
                 inverse)[None, :, :, None]
    wb = _twp(tw, np.outer(np.arange(qb), np.arange(qb)) * (m // qb), m,
              inverse)
    v = np.einsum("nbjc,bk->nkjc", v, wb)       # (n1, jb, ja, col)
    j = np.arange(qa)[None, :] + qa * np.arange(qb)[:, None]
    v = v * _twp(tw, np.arange(cs)[:, None, None] * j[None], m,
                 inverse)[..., None]
    return v.reshape(cs, qa * qb, -1).astype(np.complex64)


def column_gather(y, tw, cs, inverse, js):
    """The gather's CS-point DFT of Y_n1[j] over the blocks n1 for the
    output rows j in ``js``: (len(js), CS, cols), X[j + Q k1] at [., k1]."""
    m = cs * y.shape[1]
    wc = _twp(_c64(tw), np.outer(np.arange(cs), np.arange(cs)) * (m // cs),
              m, inverse)
    return np.einsum("njc,nl->jlc", y[:, js], wc).astype(np.complex64)


def column_dft(x, tw, cs, inverse):
    """The column pass's unnormalised DFT of x's rows (m, cols): passes A
    and B, then the gather of every output row k = j + Q k1."""
    y = column_passes(x, tw, cs, inverse)
    q = y.shape[1]
    v = column_gather(y, tw, cs, inverse, np.arange(q))    # (j, k1, col)
    return v.transpose(1, 0, 2).reshape(cs * q, -1)


def fused_convolution(a, tw, spec, cs):
    """The chirp-z launch's data movement (csrc/gmti_kernel.cu,
    chirpz_convolve) over the chirped rows a (m, cols): passes A and B
    forward; block r gathers its rows j = r + CS jj, multiplies by the
    spectrum and, after every block has read every Y, writes point q = jj +
    J k1 (row r + CS q) to its own slot qa + QA qb (q = qb + QB qa, slot l
    at l + l // QA of the padded layout); its inverse pass A task (qb, col)
    reads the QA points of slots qa + QA qb as rows r + CS (qb + QB qa).
    Returns the inverse column pass's input (m, cols) as the blocks read
    it, and each block's slots (written once each)."""
    m = a.shape[0]
    qa, qb = tck.column_split(m, cs)
    q = qa * qb
    jn = q // cs
    y = column_passes(a, tw, cs, False)
    ysz = q + qb
    inverse_in = np.full_like(a, np.nan)
    for r in range(cs):
        held = column_gather(y, tw, cs, False, r + cs * np.arange(jn))
        qs = np.arange(jn)[:, None] + jn * np.arange(cs)[None, :]
        held = held * spec[r + cs * qs][..., None]
        # the cluster barrier: every block has gathered; now the writes
        slots = np.full((ysz,) + a.shape[1:], np.nan, np.complex64)
        ell = qs // qb + qa * (qs % qb)
        pad = ell + ell // qa
        assert np.unique(pad).size == pad.size and pad.max() < ysz
        slots[pad] = held
        for b in range(qb):
            for p in range(qa):
                ell = p + qa * b
                inverse_in[r + cs * (b + qb * p)] = slots[ell + ell // qa]
    return inverse_in


def chirpz_dft(x, plan, inverse):
    """The column pass's chirp-z transform over x's rows with an
    ``azimuth_plan``'s tables, as its one launch moves the data: the
    chirped rows, zero beyond n, forward, times the spectrum
    (:func:`fused_convolution`); the inverse over m, 1 / m, the chirp again,
    rows below n."""
    n, m = x.shape[0], plan.m
    cs = tck.column_plan(n, 64, 1).cluster
    tw, chirp, spec = (t.numpy() for t in plan.tables(inverse)[:3])
    a = np.zeros((m,) + x.shape[1:], np.complex64)
    a[:n] = x * chirp[:, None]
    a = fused_convolution(a, tw, spec, cs)
    assert not np.isnan(a).any()
    c = column_dft(a, tw, cs, True) * np.float32(1.0 / m)
    return (c[:n] * chirp[:, None]).astype(np.complex64)


def factored_dft(x, plan, inverse):
    """The factored kind's transform over x's rows (n, cols) with an
    ``azimuth_plan``'s tables, as its one launch moves the data: block
    rank = i1 mod CS reads the rows (n2 i1 + (n1 i2) mod n) mod n of each
    of its i1 into the slots the index table gives, runs the local passes
    there (forward passes of the launch's direction; for a prime n2
    Rader's: forward passes, x the spectrum with x0 added at frequency 0
    and X[0] = x0 + A[0] kept in slot L, inverse passes), then the gather
    reads X_i1[k2] from the slot of k2 of every i1, runs the n1-point DFT
    and writes row (e1 k1 + e2 k2) mod n (x 1/n inverse)."""
    n = x.shape[0]
    n1, n2, local, passes = plan.legs
    tw = plan.tw.numpy()
    tl, to = tw[:local], tw[local:]
    idx = plan.index.numpy().astype(np.int64)
    e1, e2 = idx[:2]
    radices = [int(r) for r in idx[2:2 + passes]]
    rowof = idx[2 + passes:2 + passes + n2]
    slot_of = idx[2 + passes + n2:]
    assert np.prod(radices) == local
    rows = (n2 * np.arange(n1)[:, None] + rowof[None, :]) % n
    y = np.moveaxis(x[rows], -1, 1)                # (i1, col, slot)
    if local != n2:
        spec = plan.tables(inverse)[2].numpy()
        x0 = y[..., local].copy()
        a = mixed_forward(y[..., :local], tl, radices=radices, sign=False)
        a0 = a[..., 0].copy()
        a = (a * spec).astype(np.complex64)
        a[..., 0] += x0
        c = mixed_forward(a, tl, inverse=True, radices=radices)
        y = np.concatenate([c, (x0 + a0)[..., None]], axis=-1)
    else:
        y = mixed_forward(y, tl, radices=radices, sign=inverse)
    g = y[..., slot_of]                            # (i1, col, k2)
    got = np.moveaxis(_small(np.moveaxis(g, 0, -1), n1, to, n1, inverse),
                      -1, 0)                       # (k1, col, k2)
    out = np.empty_like(x)
    k = (e1 * np.arange(n1)[:, None] + e2 * np.arange(n2)[None, :]) % n
    out[k] = np.moveaxis(got, 1, -1)
    if inverse:
        out = out * np.float32(1.0 / n)
    return out.astype(np.complex64)


FACTORED_SIDES = [7199, 7200, 120, 184, 1008, 5911, 667, 96, 6000]


@pytest.mark.parametrize("n", FACTORED_SIDES)
def test_factored_plan_is_the_dft(n):
    """The factored kind, forward and inverse (with its 1/n), against
    float64 to float32 rounding: the index maps cover every row once, the
    output weights are the CRT's, and each side takes the split the rule
    gives (smooth local legs and Rader's at 7,199 = 23 x 313, 184 = 8 x 23,
    5,911 = 23 x 257, 667 = 23 x 29)."""
    rng = np.random.default_rng(n + 2)
    x = (rng.standard_normal((n, 8)) + 1j * rng.standard_normal((n, 8))
         ).astype(np.complex64)
    plan = tck.azimuth_plan(n)
    n1, n2, local, passes = plan.legs
    assert plan.kind == "factored" and (plan.m, n1 * n2) == (n, n)
    assert (n1, n2) == tck.factored_split(n) and np.gcd(n1, n2) == 1
    assert local == (n2 if tck._smooth(n2) else n2 - 1)
    assert passes == len(tck.local_radices(local))
    idx = plan.index.numpy().astype(np.int64)
    rowof = idx[2 + passes:2 + passes + n2]
    rows = (n2 * np.arange(n1)[:, None] + rowof[None, :]) % n
    assert np.array_equal(np.sort(rows.ravel()), np.arange(n))
    assert np.array_equal(np.sort(idx[2 + passes + n2:]), np.arange(n2))
    e1, e2 = idx[:2]
    assert (e1 % n1, e1 % n2, e2 % n1, e2 % n2) == (1, 0, 0, 1)
    x64 = x.astype(np.complex128)
    for inverse, want in ((False, np.fft.fft(x64, axis=0)),
                          (True, np.fft.ifft(x64, axis=0))):
        got = factored_dft(x, plan, inverse)
        assert np.abs(got - want).max() / np.abs(want).max() < 5e-6


# sides that keep the chirp-z kind (7,193 and 6,007 in the place of the
# upstream's 7,199 and 7,200, and 5,003 in that of 120, which the factored
# kind now takes: primes above 512)
CHIRPZ_SIDES = [65, 97, 5003, 165, 313, 719, 4097, 7193, 6007, 8191]


@pytest.mark.parametrize("n", CHIRPZ_SIDES)
def test_chirpz_plan_is_the_dft(n):
    """Forward and inverse (with its 1/n) against float64, to float32
    rounding, on the chirp-z length's power-of-two column split."""
    rng = np.random.default_rng(n + 1)
    x = (rng.standard_normal((n, 8)) + 1j * rng.standard_normal((n, 8))
         ).astype(np.complex64)
    plan = tck.azimuth_plan(n)
    m = tck.chirpz_length(n)
    assert plan.m == m and plan.launches == 1
    assert m >= 2 * n - 1 and m & (m - 1) == 0 and m < 4 * n
    x64 = x.astype(np.complex128)
    for inverse, want in ((False, np.fft.fft(x64, axis=0)),
                          (True, np.fft.ifft(x64, axis=0))):
        got = chirpz_dft(x, plan, inverse)
        assert np.abs(got - want).max() / np.abs(want).max() < 5e-6


@pytest.mark.parametrize("m", [256, 1024, 8192, 16384])
def test_column_split_is_the_dft(m):
    """The column pass's split of every chirp-z length (and of 8192 as an
    azimuth side) is the DFT, both directions."""
    cs = tck.column_cluster(m)
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((m, 2)) + 1j * rng.standard_normal((m, 2))
         ).astype(np.complex64)
    tw = tck.twiddle_table(m).numpy()
    for inverse in (False, True):
        want = np.fft.fft(x.astype(np.complex128), axis=0)
        if inverse:
            want = np.fft.ifft(x.astype(np.complex128), axis=0) * m
        got = column_dft(x, tw, cs, inverse)
        assert np.abs(got - want).max() / np.abs(want).max() < 5e-6
