"""Host-side logic of the NUFFT echo's spread and FFT-conv kernels
(``ops/cuda/spread_kernel.py``, ``ops/cuda/fft_kernel.py``) on the CPU: the
conv's filter table and its cache, the conv on strided row views (the padded
field's columns, as ``ops/echo_freq.py`` passes them, with no copy) against
the contiguous result and the JAX package's conv kernel in interpret mode,
the row-stride check, the spread's shared-memory size, and a NumPy model of
the spread kernel's arithmetic (occupancy bits, occupied-cell index, stable
target list, 4-cell groups) held bit for bit to the first design's walk over
every window cell and tap and to the plain version; a NumPy model of the
window placement kernel's per-cell walk held bit for bit to its plain
version, and that to the row loop it replaced, with synthesize's bits and
kernel_operands' shapes unchanged by it. On the CPU no kernel launches."""

import math

import numpy as np
import pytest
import torch

from nis_sar_amtigmti_video_tpu_torch.ops import echo, echo_freq
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (_build, fft_kernel,
                                                       spread_kernel)

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _filter(nfft, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=nfft) + 1j * rng.normal(size=nfft)
    return torch.from_numpy(z.astype(np.complex64))


@pytest.mark.parametrize("nfft", [16384, 32768, 65536])
def test_conv_filter_is_the_spectra_layout(nfft):
    """The conv kernel's filter table holds f = k2 + B1 k1 at [k2, k1]: the
    order its rows leave the spectrum in (k1 natural)."""
    filt = _filter(nfft)
    tab = fft_kernel.conv_filter(filt)
    b1 = nfft // 128
    assert tab.shape == (b1, 128) and tab.is_contiguous()
    k2, k1 = np.meshgrid(np.arange(b1), np.arange(128), indexing="ij")
    assert torch.equal(tab, filt[torch.from_numpy(k2 + b1 * k1)])


def test_conv_filter_is_cached_per_tensor():
    """Built once per filter tensor; rebuilt after an in-place change; a
    new tensor of the same values gets its own table."""
    filt = _filter(16384, seed=1)
    tab = fft_kernel.conv_filter(filt)
    assert fft_kernel.conv_filter(filt) is tab
    filt.mul_(2.0)
    tab2 = fft_kernel.conv_filter(filt)
    assert tab2 is not tab and torch.equal(tab2, 2.0 * tab)
    other = filt.clone()
    assert fft_kernel.conv_filter(other) is not tab2
    assert torch.equal(fft_kernel.conv_filter(other), tab2)


def _field_views(seed, num_p, l_in, pad_lo=96, pad_hi=40):
    """(fr, fi) as column views [pad_lo, pad_lo + l_in) of wider planes."""
    rng = np.random.default_rng(seed)
    wide = [torch.from_numpy(rng.normal(size=(num_p, pad_lo + l_in + pad_hi))
                             .astype(np.float32)) for _ in range(2)]
    return [w[:, pad_lo:pad_lo + l_in] for w in wide]


@pytest.mark.parametrize("nfft,l_in,rows", [(16384, 15000, (40, 100)),
                                            (16384, 5000, (0, 128)),
                                            (32768, 30000, (0, 7)),
                                            (65536, 50420, (187, 394))])
def test_fft_conv_on_row_views_equals_contiguous(nfft, l_in, rows):
    fr, fi = _field_views(3, 2, l_in)
    assert not fr.is_contiguous() and fr.stride() == (l_in + 136, 1)
    filt = _filter(nfft, seed=4)
    got = fft_kernel.fft_conv_pallas(fr, fi, filt, nfft, out_rows=rows)
    want = fft_kernel.fft_conv_pallas(fr.contiguous(), fi.contiguous(), filt,
                                      nfft, out_rows=rows)
    assert got.shape == (2, (rows[1] - rows[0]) * 128)
    assert torch.equal(got, want)
    assert torch.equal(
        fft_kernel.fft_conv_plain(fr, fi, filt, nfft, out_rows=rows), want)


def test_fft_conv_on_row_views_matches_reference_kernel():
    """The conv on column views against the JAX package's fused conv
    kernel in interpret mode on the same (contiguous) field."""
    jax = pytest.importorskip("jax")
    from nis_sar_amtigmti_video_tpu.ops.pallas import (
        fft_kernel as jfft_kernel)
    nfft, l_in, rows = 16384, 15000, (40, 100)
    fr, fi = _field_views(13, 3, l_in)
    filt = _filter(nfft, seed=6) / 8.0
    cr, ci = jfft_kernel.fft_conv_pallas(
        jax.numpy.asarray(fr.contiguous().numpy()),
        jax.numpy.asarray(fi.contiguous().numpy()), filt.numpy(), nfft,
        out_rows=rows, interpret=True)
    want = torch.from_numpy(np.asarray(cr) + 1j * np.asarray(ci))
    got = fft_kernel.fft_conv_pallas(fr, fi, filt, nfft, out_rows=rows)
    assert _rel(got, want) < 3e-5


def test_row_check_takes_views_and_refuses_strided_rows():
    cpu = torch.device("cpu")
    fr, _ = _field_views(0, 3, 50)
    fft_kernel._check_rows("t", (fr,), (3, 50), cpu)
    with pytest.raises(ValueError, match="not contiguous"):
        _build.check("t", (fr,), (3, 50), cpu)
    with pytest.raises(ValueError, match="rows are not contiguous"):
        fft_kernel._check_rows("t", (fr[:, ::2],), (3, 25), cpu)
    with pytest.raises(ValueError, match=r"needs \(2, 3\)"):
        fft_kernel._check_rows("t", (torch.zeros(2, 3, 4),), (2, 3), cpu)
    with pytest.raises(TypeError, match="float32"):
        fft_kernel._check_rows("t", (fr.double(),), (3, 50), cpu)


def _freq_case(b=48):
    opts = echo.EchoOpts(fc_hz=9.65e9, chirp_rate=50e6 / 2e-6,
                         pulse_width_s=2e-6, fs_hz=60e6, num_samples=4000,
                         endpoint_grid=False, backend="freq")
    rng = np.random.default_rng(11)
    p = 3
    tau = np.sort(rng.uniform(5e-6, 5.5e-5, (p, b)), axis=1)
    car = rng.uniform(-np.pi, np.pi, (p, b))
    amp = rng.uniform(0.5, 2.0, (p, b))
    return opts, [torch.from_numpy(a.astype(np.float32))
                  for a in (tau, car, amp)]


def test_synthesize_hands_the_conv_field_views(monkeypatch):
    """synthesize and kernel_operands give the conv the padded field's
    column views (no copy), and the result equals the conv of contiguous
    planes."""
    opts, fields = _freq_case()
    kw = dict(spreader="dense_kernel", conv="pallas")
    seen = []
    conv = fft_kernel.fft_conv_pallas

    def conv_rec(fr, fi, filt, nfft, out_rows=None):
        seen.append((fr, fi))
        return conv(fr, fi, filt, nfft, out_rows)

    monkeypatch.setattr(fft_kernel, "fft_conv_pallas", conv_rec)
    got = echo_freq.synthesize(*fields, opts, **kw)
    monkeypatch.setattr(fft_kernel, "fft_conv_pallas",
                        lambda fr, fi, *a, **k: conv(fr.contiguous(),
                                                     fi.contiguous(), *a, **k))
    want = echo_freq.synthesize(*fields, opts, **kw)
    assert torch.equal(got, want)
    ops = echo_freq.kernel_operands(*fields, opts, **kw)
    for fr, fi in (seen[0], ops["conv"][:2]):
        assert not fr.is_contiguous() and not fi.is_contiguous()
        assert fr.stride(1) == 1 and fr.stride(0) > fr.shape[1]
        assert fr._base is not None and fi._base is not None


@pytest.mark.parametrize("bg,win,n_sets,k", [(315, 4096, 1, 8),
                                             (315, 2048, 2, 6),
                                             (50, 250, 2, 6)])
def test_spread_smem_bytes(bg, win, n_sets, k):
    """The values rounded up to 16 bytes, 5 bg + 1 target ints, the
    occupancy words with a zero word after them and their prefix; at the
    full-scale chain's main and edge passes six blocks fit an SM's 228 KB
    (1 KB of it the runtime's for each block)."""
    nv = n_sets * 2 * k * bg
    nw = -(-win // 32)
    want = 4 * (-(-nv // 4) * 4 + (5 * bg + 1) + 2 * (nw + 1))
    assert spread_kernel.smem_bytes(bg, win, n_sets, k) == want
    if bg == 315:       # the full-scale passes: six blocks fit an SM
        assert 6 * (want + 1024) <= 233_472


# --------------------------------------------------------------------------
# a NumPy model of csrc/spread_kernel.cu's arithmetic
# --------------------------------------------------------------------------

def _occupancy(words, lo, win, wrap):
    """The kernel's occupancy bits: bit t is cell lo + t's."""
    if lo >= 0:
        w = lo >> 5
        x = int(words[w]) | (int(words[w + 1]) << 32)
        return x >> (lo & 31)
    x = 0
    for t in range(33):
        i = lo + t
        if i < 0:
            if not wrap:
                continue
            i %= win
        if i < win and (int(words[i >> 5]) >> (i & 31)) & 1:
            x |= 1 << t
    return x


def _window(cells, vals, win, qr, walk_all):
    """One (pulse, group)'s (2S, win) float32 window, in the first design's
    walk over every window cell and tap (``walk_all``) or this design's:
    each window cell visits its occupied predecessors found through the
    occupancy bits and the occupied-cell index (where the bits start at a
    cell >= 0, that cell's index plus the bits below), adding a one-target
    cell's value,
    or a cell of several targets as the walk does (its per-tap partial in
    list order from +0.0, or in the one-accumulator order each term); the
    sums in float32 in the kernel's order."""
    n_sets, k_taps = vals.shape[0], vals.shape[1] // 2
    f32 = np.float32
    lists = {}
    for b, c in enumerate(cells):                   # stable: index order
        if 0 <= c < win:
            lists.setdefault(int(c), []).append(b)
    occupied = sorted(lists)
    nw = -(-win // 32)
    words = np.zeros(nw + 1, np.int64)
    for c in occupied:
        words[c >> 5] |= 1 << (c & 31)
    pre = np.concatenate([[0], np.cumsum([bin(int(w)).count("1")
                                          for w in words[:nw]])])
    out = np.zeros((2 * n_sets, win), np.float32)

    def walk_term(s, k, i, acc_r, acc_i):
        vr, vi = vals[s, k], vals[s, k_taps + k]
        if qr:
            for b in lists.get(i, []):
                acc_r, acc_i = f32(acc_r + vr[b]), f32(acc_i + vi[b])
            return acc_r, acc_i
        pr = pi = f32(0.0)
        for b in lists.get(i, []):
            pr, pi = f32(pr + vr[b]), f32(pi + vi[b])
        return f32(acc_r + pr), f32(acc_i + pi)

    for j in range(win):
        j0, d = j - j % 4, j % 4
        lo = j0 - k_taps + 1
        bits = _occupancy(words, lo, win, not qr) & ((1 << (k_taps + 3)) - 1)
        for s in range(n_sets):
            acc_r = acc_i = f32(0.0)
            if walk_all:
                for k in range(k_taps):
                    i = j - k
                    if i < 0:
                        if qr:
                            break
                        i %= win
                    acc_r, acc_i = walk_term(s, k, i, acc_r, acc_i)
                out[2 * s, j], out[2 * s + 1, j] = acc_r, acc_i
                continue
            m = (bits >> d) & ((1 << k_taps) - 1)
            while m:
                t = m.bit_length() - 1                  # least k first
                m &= ~(1 << t)
                k = k_taps - 1 - t
                i = (j - k) % win
                if lo >= 0:      # cell lo's index plus the bits below
                    w = lo >> 5
                    u = (int(pre[w])
                         + bin(int(words[w]) & ((1 << (lo & 31)) - 1)).count(
                             "1")
                         + bin(bits & ((1 << (d + t)) - 1)).count("1"))
                else:
                    u = int(pre[i >> 5]) + bin(
                        int(words[i >> 5]) & ((1 << (i & 31)) - 1)).count("1")
                assert occupied[u] == i
                if len(lists[i]) == 1:           # v where the walk adds 0 + v
                    b = lists[i][0]
                    acc_r = f32(acc_r + vals[s, k, b])
                    acc_i = f32(acc_i + vals[s, k_taps + k, b])
                else:
                    acc_r, acc_i = walk_term(s, k, i, acc_r, acc_i)
            out[2 * s, j], out[2 * s + 1, j] = acc_r, acc_i
    return out


def _spread_case(kind, seed=0, grp=3, bg=40, win=256, n_sets=2, k=6):
    """Cells of one kind ('sorted' with duplicates and dropped targets,
    'reversed', 'one cell', 'edges': cells at both ends of the window, some
    outside it) and seeded values (pc = 2)."""
    rng = np.random.default_rng(seed)
    c = np.sort(rng.integers(0, win - k + 1, (2, grp, bg)), axis=-1)
    c[:, :, 1::5] = c[:, :, 0::5][:, :, :c[:, :, 1::5].shape[-1]]
    c[:, :, 3::11] = -1
    if kind == "reversed":
        c = c[:, :, ::-1].copy()
    elif kind == "one cell":
        c[:] = 3
        c[:, :, 7] = -1
    elif kind == "edges":
        c[:, :, ::3] = rng.integers(0, 3, c[:, :, ::3].shape)
        c[:, :, 1::3] = rng.integers(win - 3, win + 2, c[:, :, 1::3].shape)
    v = rng.normal(size=(2, grp, n_sets, 2 * k, bg)).astype(np.float32)
    v[0, 0, :, :, 2] = -0.0
    return c.astype(np.int32), v


@pytest.mark.parametrize("qr", [False, True])
@pytest.mark.parametrize("kind,win", [("sorted", 256), ("reversed", 256),
                                      ("one cell", 256), ("edges", 256),
                                      ("edges", 250), ("sorted", 70)])
def test_spread_kernel_model_equals_first_design_bit_for_bit(kind, win, qr):
    """Visiting only the occupied cells (through the occupancy bits, the
    occupied-cell index and the stable list), a one-target cell adding its
    value, gives the walk over every cell and tap bit for bit, in both
    orders (values of -0.0 included), and both agree with the plain
    version; a window that is no multiple of 4 or 32 takes the kernel's
    scalar and per-bit paths."""
    c, v = _spread_case(kind, win=win)
    plain = spread_kernel.spread_windows_plain(
        torch.from_numpy(c), torch.from_numpy(v), win, qr=qr).numpy()
    for p in range(c.shape[0]):
        for g in range(c.shape[1]):
            new = _window(c[p, g], v[p, g], win, qr, walk_all=False)
            old = _window(c[p, g], v[p, g], win, qr, walk_all=True)
            assert np.array_equal(new.view(np.int32), old.view(np.int32))
            scale = np.abs(plain[p, g]).max()
            assert np.abs(new - plain[p, g]).max() <= 1e-5 * scale


# --------------------------------------------------------------------------
# the window placement (spread_kernel.place_windows): a NumPy model of
# csrc/spread_kernel.cu's per-cell walk, the plain version and the row loop
# _spread_dense ran before the placement kernel
# --------------------------------------------------------------------------

def _loop_placement(wins, base, offsets, l_out, win, lo, rows_tot):
    """The row loop of ops/echo_freq.py::_spread_dense before the
    placement kernel, verbatim: (pc, l_out) float32 re/im fields."""
    pc, dev = wins.shape[0], wins.device
    grp = wins.shape[1]
    fr = torch.zeros((pc * rows_tot, 128), dtype=torch.float32, device=dev)
    fi = torch.zeros_like(fr)
    row0 = (torch.arange(pc, device=dev) * rows_tot)[:, None]
    for si, offset in enumerate(offsets):
        out_r, out_i = wins[:, :, 2 * si], wins[:, :, 2 * si + 1]
        # sub-row part of the offset: pad one row and roll the windows
        off_mod = offset % 128
        if off_mod:
            out_r, out_i = (torch.roll(torch.nn.functional.pad(o, (0, 128)),
                                       off_mod, dims=-1)
                            for o in (out_r, out_i))
        nwr = out_r.shape[-1] // 128
        base_eff = base + (offset - off_mod)
        rowpos = (echo_freq._floor_div(base_eff, 128)[:, :, None]
                  + torch.arange(nwr, device=dev))            # (pc, grp, nwr)
        # group by group: one group's rows are distinct, so each update is
        # a plain gather, add and store (a fixed order of the sums)
        for g in range(grp):
            idx = (row0 + rowpos[:, g]).reshape(-1)
            fr[idx] = fr[idx] + out_r[:, g].reshape(-1, 128)
            fi[idx] = fi[idx] + out_i[:, g].reshape(-1, 128)
    fr = fr.reshape(pc, rows_tot * 128)
    fi = fi.reshape(pc, rows_tot * 128)
    return (fr[:, win + lo:win + lo + l_out],
            fi[:, win + lo:win + lo + l_out])


def _old_spread_dense(i0, val_sets, l_out, win, grp, lo=0, impl="xla"):
    """_spread_dense as it was before the placement kernel (its windows,
    its padded field's rows, the row loop)."""
    max_off = max(off for _, _, off in val_sets)
    c_ok, vals, base, lo = echo_freq._group_cells(i0, val_sets, l_out, win,
                                                  grp, lo)
    rows_tot = -(-(l_out + 2 * win + lo + max_off + 256) // 128)
    if impl == "xla":
        wins = spread_kernel.spread_windows_plain(c_ok, vals, win)
    else:
        wins = spread_kernel.spread_windows_pallas(c_ok, vals, win,
                                                   qr=impl == "pallas_qr")
    return _loop_placement(wins, base, [o for _, _, o in val_sets], l_out,
                           win, lo, rows_tot)


def _old_edge_exact(pl, tau, a_re, a_im):
    """_edge_exact's dense branch before the placement kernel."""
    pc, ns, dev = tau.shape[0], pl.opts.num_samples, tau.device
    flanks = _parent_edge_flanks(pl, tau, a_re, a_im)
    assert pl.spreader != "scatter"
    corr_r = torch.zeros((pc, ns), dtype=torch.float32, device=dev)
    corr_i = torch.zeros_like(corr_r)
    for call in _parent_edge_spread_calls(pl, flanks):
        er, ei = _old_spread_dense(*call, impl=pl.d_impl)
        corr_r = corr_r + er
        corr_i = corr_i + ei
    return torch.complex(corr_r, corr_i)


def _place_model(wins, base, offsets, start, l_out):
    """The kernel's walk per field cell x: for each set, then each group in
    order, add window cell j = x + start - (base + offset) where 0 <= j <
    win, from +0.0 in float32. Returns (2, pc, l_out) float32 (re, im)."""
    w, b = wins.numpy(), base.numpy()
    pc, grp, _, win = w.shape
    x = np.arange(l_out)
    out = np.zeros((2, pc, l_out), np.float32)
    for p in range(pc):
        for s, off in enumerate(offsets):
            for g in range(grp):
                j = x + start - (int(b[p, g]) + off)
                ok = (j >= 0) & (j < win)
                for c in range(2):
                    out[c, p, ok] = out[c, p, ok] + w[p, g, 2 * s + c, j[ok]]
    return out


def _clustered(rng, pc, grp, bg, lo_cell, hi_cell, span):
    """Sorted tap-0 cells: each group's bg targets within ``span`` cells of
    a centre, the centres spread over [lo_cell, hi_cell)."""
    c = np.sort(rng.integers(lo_cell, hi_cell, (pc, grp)), axis=1)
    return np.sort((c[:, :, None] + rng.integers(0, span, (pc, grp, bg)))
                   .reshape(pc, grp * bg), axis=1)


# name -> (pc, targets, taps, l_out, win, grp, lo, offsets, i0 clamp)
PLACE_CASES = {
    "one set": (2, 60, 8, 3000, 512, 4, 0, (0,), (-256, 3256)),
    "two sets at delta": (2, 160, 6, 13200, 256, 4, 11996 + 256,
                          (0, 11996), (-11996 - 256, 13200 + 256)),
    "overlapping windows": (2, 96, 8, 2000, 1024, 6, 0, (0,), (-256, 2256)),
    "dropped targets": (2, 60, 8, 2000, 256, 3, 0, (0,), (-256, 2256)),
    "far-out clamped": (2, 40, 8, 1500, 512, 4, 0, (0,), (-256, 1756)),
}


def _place_case(name, seed=3):
    """The case's group windows, bases and start, through _group_cells and
    the plain spread, as _spread_dense builds them."""
    pc, num_b, k, l_out, win, grp, lo, offsets, (c_lo, c_hi) = \
        PLACE_CASES[name]
    rng = np.random.default_rng(seed)
    bg = num_b // grp
    if name == "two sets at delta":
        # the trailing set of the group at -11,400 lands on the leading
        # sets of the two groups that share [560, 710)
        centre = np.array([-11400, 560, 560, 12470])
        i0 = (centre[None, :, None]
              + rng.integers(0, 150, (pc, grp, bg))).reshape(pc, num_b)
    elif name == "overlapping windows":
        # in no delay order: every group's window spans the same cells
        i0 = rng.integers(300, 900, (pc, num_b))
    elif name == "dropped targets":
        i0 = np.sort(rng.integers(0, 2000, (pc, num_b)), axis=1)
    elif name == "far-out clamped":
        i0 = _clustered(rng, pc, grp, bg, 0, l_out, 100)
        i0[:, :5] = -10 ** 6
        i0[:, -5:] = 10 ** 6
    else:
        i0 = _clustered(rng, pc, grp, bg, -40, l_out + 20, 200)
    i0 = torch.clamp(torch.from_numpy(i0.astype(np.int32)), c_lo, c_hi)
    sets = []
    for off in offsets:
        vr, vi = (rng.normal(size=(pc, num_b, k)).astype(np.float32)
                  for _ in range(2))
        vr[0, 3] = -0.0
        sets.append((torch.from_numpy(vr), torch.from_numpy(vi), off))
    c_ok, vals, base, lo_r = echo_freq._group_cells(i0, sets, l_out, win,
                                                    grp, lo)
    wins = spread_kernel.spread_windows_plain(c_ok, vals, win)
    rows_tot = -(-(l_out + 2 * win + lo_r + max(offsets) + 256) // 128)
    return wins, base, list(offsets), l_out, win, lo_r, rows_tot, c_ok


def _bits(t):
    return t.contiguous().numpy().view(np.int32)


@pytest.mark.parametrize("complex_out", [False, True])
@pytest.mark.parametrize("case", sorted(PLACE_CASES))
def test_place_windows_model_plain_and_loop_bit_for_bit(case, complex_out):
    """The kernel's per-cell walk (NumPy), place_windows_plain and the row
    loop _spread_dense ran before the placement kernel give the same bits
    (values of -0.0 included): one set at offset 0; two sets at the
    full-scale edge pass's offset (sub-row part 92) with lo > 0;
    overlapping group windows; dropped targets; far-out cells clamped at
    the grid's edges. On a CPU tensor place_windows is the plain
    version."""
    wins, base, offsets, l_out, win, lo, rows_tot, c_ok = _place_case(case)
    assert base.dtype == torch.int32
    if case == "dropped targets":
        assert int((c_ok < 0).sum()) > 10
    if case in ("overlapping windows", "two sets at delta"):
        # cells that sum terms of three or more windows: the order shows
        w, b = wins.numpy(), base.numpy()
        terms = np.zeros((wins.shape[0], l_out), int)
        for p in range(wins.shape[0]):
            for s, off in enumerate(offsets):
                for g in range(wins.shape[1]):
                    j = np.arange(l_out) + win + lo - (int(b[p, g]) + off)
                    ok = (j >= 0) & (j < win)
                    terms[p, ok] += w[p, g, 2 * s, j[ok]] != 0
        assert int((terms >= 3).sum()) > 10
    start = win + lo
    model = _place_model(wins, base, offsets, start, l_out)
    assert np.abs(model).max() > 0
    loop = _loop_placement(wins, base, offsets, l_out, win, lo, rows_tot)
    plain = spread_kernel.place_windows_plain(wins, base, offsets, start,
                                              l_out, complex_out)
    got = spread_kernel.place_windows(wins, base, offsets, start, l_out,
                                      complex_out)
    if complex_out:
        assert plain.dtype == torch.complex64
        plain = (torch.view_as_real(plain)[..., 0],
                 torch.view_as_real(plain)[..., 1])
        got = (torch.view_as_real(got)[..., 0],
               torch.view_as_real(got)[..., 1])
    for c in range(2):
        assert plain[c].shape == (wins.shape[0], l_out)
        assert np.array_equal(_bits(plain[c]), model[c].view(np.int32))
        assert np.array_equal(_bits(plain[c]), _bits(loop[c]))
        assert np.array_equal(_bits(got[c]), _bits(plain[c]))


def test_place_windows_refuses_bad_operands():
    wins, base, offsets, l_out, win, lo, _, _ = _place_case("one set")
    with pytest.raises(ValueError, match="2S, win"):
        spread_kernel.place_windows(wins, base, [0, 5], win + lo, l_out)
    with pytest.raises(ValueError, match="bases"):
        spread_kernel.place_windows(wins, base[:, :2], offsets, win + lo,
                                    l_out)
    with pytest.raises(ValueError, match="l_out"):
        spread_kernel.place_windows(wins, base, offsets, win + lo, 0)


# --------------------------------------------------------------------------
# the NUFFT echo's per-tap operands as ops/echo_freq.py formed them in
# PyTorch before the spread kernel formed the taps, verbatim (module names
# through echo_freq, so that a test's monkeypatch of _spread_dense reaches
# them)
# --------------------------------------------------------------------------

def _parent_pack_vals(val_sets, b_pad: int, grp: int) -> torch.Tensor:
    """Every set's [re | im] taps (pc, B, 2K), padded to b_pad targets, as
    the kernel's (pc, grp, S, 2K, bg) float32."""
    v = torch.stack([torch.cat([vr, vi], dim=-1) for vr, vi, _ in val_sets],
                    dim=1)                                   # (pc, S, B, 2K)
    pc, n_sets, num_b, k2 = v.shape
    v = torch.nn.functional.pad(v, (0, 0, 0, b_pad - num_b))
    return v.reshape(pc, n_sets, grp, b_pad // grp, k2).permute(
        0, 2, 1, 4, 3).to(torch.float32).contiguous()


def _parent_es_weights(pl, tau):
    """The chunk's impulses on the oversampled grid: tap-0 cells i0 (pc, B)
    int32 and the ES weights (pc, B, W) float32 of their taps."""
    _W, _BETA = echo_freq._W, echo_freq._BETA
    dev = tau.device
    s = (tau.to(torch.float64) + pl.x0) * (pl.opts.fs_hz * pl.os) + pl.lead
    s_fl = torch.floor(s)
    i0 = s_fl.to(torch.int32) - (_W // 2 - 1)
    frac = (s - s_fl).to(torch.float32)
    # ES weights at u = pos - s = offs - (W/2-1) - frac
    offs_w = torch.arange(_W, dtype=torch.int32, device=dev)
    u = (offs_w.to(torch.float32) - (_W // 2 - 1)) - frac[:, :, None]
    z2 = torch.clamp(1.0 - (2.0 * u / _W) ** 2, 0.0, 1.0)
    beta = torch.tensor(_BETA, dtype=torch.float32, device=dev)
    w = torch.where(torch.abs(u) < _W / 2.0,
                    torch.exp(beta * (torch.sqrt(z2) - 1.0)), 0.0)
    return i0, w


def _parent_main_spread_call(pl, i0, w, a_re, a_im):
    """The main pass's :func:`_spread_dense` arguments (i0, val_sets, l_out,
    win, grp, lo)."""
    i0_d = torch.clamp(i0, -256, pl.l_imp + 256)
    return (i0_d, [(w * a_re[:, :, None], w * a_im[:, :, None], 0)],
            pl.l_imp, pl.win, pl.grp, 0)


def _parent_main_field(pl, tau, a_re, a_im):
    """The chunk's impulses spread onto the oversampled grid: (pc, l_imp)
    float32 re/im fields."""
    _W = echo_freq._W
    i0, w = _parent_es_weights(pl, tau)
    if pl.spreader != "scatter":
        return echo_freq._spread_dense(
            *_parent_main_spread_call(pl, i0, w, a_re, a_im), impl=pl.d_impl)
    pc, l_imp, dev = tau.shape[0], pl.l_imp, tau.device
    pos = i0[:, :, None] + torch.arange(_W, dtype=torch.int32, device=dev)
    ok = (pos >= 0) & (pos < l_imp)
    wv = torch.where(ok, w, 0.0)
    flat = (torch.arange(pc, device=dev)[:, None, None] * l_imp
            + torch.clamp(pos, 0, l_imp - 1)).reshape(-1)
    fr, fi = (torch.zeros(pc * l_imp, dtype=torch.float32,
                          device=dev).index_add_(
        0, flat, (wv * a[:, :, None]).reshape(-1)).reshape(pc, l_imp)
        for a in (a_re, a_im))
    return fr, fi


def _parent_edge_flanks(pl, tau, a_re, a_im):
    """Exact native-rate samples of chirp x (rect - taper) at both gate
    flanks: per flank (cell0 (pc, B) float64, the first native sample at or
    after the flank's start; gate (pc, B, n_edge) bool; tap, the flank
    weights; rot_r, rot_i, the rotated amplitude of each tap)."""
    _wrap32, _TWO_PI = echo_freq._wrap32, echo_freq._TWO_PI
    opts, dev, f32 = pl.opts, tau.device, torch.float32
    tau64 = tau.to(torch.float64)
    offs_f = torch.arange(pl.n_edge, device=dev)[None, None, :].to(f32)
    c2 = torch.tensor(math.pi * opts.chirp_rate / (opts.fs_hz ** 2),
                      dtype=f32, device=dev)
    fs32 = torch.tensor(opts.fs_hz, dtype=f32, device=dev)
    t_edge_s, x0 = pl.t_edge_s, pl.x0
    ar, ai = a_re[:, :, None], a_im[:, :, None]
    flanks = []
    for edge_off, leading in ((0.0, True),
                              (opts.pulse_width_s - t_edge_s, False)):
        # first native sample index at/after the flank start
        start = (tau64 + x0 + edge_off) * opts.fs_hz             # (pc, B)
        cell0 = torch.ceil(start - 1e-9)
        # flank-local coordinate of tap 0 (small f64 -> exact f32)
        e0 = cell0 / opts.fs_hz - tau64 - x0 - edge_off
        arg0 = e0 + edge_off + x0 - opts.chirp_shift
        c0 = _wrap32(math.pi * opts.chirp_rate * arg0 * arg0)
        c1 = _wrap32((_TWO_PI * opts.chirp_rate / opts.fs_hz) * arg0)
        ph = (c0[:, :, None] + c1[:, :, None] * offs_f
              + c2 * offs_f * offs_f)
        e = e0.to(f32)[:, :, None] + offs_f / fs32
        if leading:
            gate = e >= -1e-12
            d = e
        else:
            gate = e <= t_edge_s + 1e-12
            d = t_edge_s - e
        z = torch.clamp(d / t_edge_s, 0.0, 1.0)
        tap = 0.5 + 0.5 * torch.cos(math.pi * z)       # 1 - raised cosine
        cs, sn = torch.cos(ph), torch.sin(ph)
        flanks.append((cell0, gate, tap, cs * ar - sn * ai, cs * ai + sn * ar))
    return flanks


def _parent_edge_spread_calls(pl, flanks):
    """The dense spreaders' :func:`_spread_dense` arguments (i0, val_sets,
    l_out, win, grp, lo) of the exact-edge pass: one call of both flanks on
    a shared cell list where the flanks sit a whole number of samples apart,
    else one call a flank."""
    ns = pl.opts.num_samples
    vals = [(torch.where(gate, tap, 0.0) * rr, torch.where(gate, tap, 0.0)
             * ri) for _, gate, tap, rr, ri in flanks]
    if pl.share:
        i0 = torch.clamp(flanks[0][0], -pl.delta - 256.0, ns + 256.0)
        return [(i0.to(torch.int32), [(*vals[0], 0), (*vals[1], pl.delta)],
                 ns, pl.win_e, pl.grp_e, pl.delta + 256)]
    return [(torch.clamp(f[0], -256.0, ns + 256.0).to(torch.int32),
             [(*v, 0)], ns, pl.win_e, pl.grp_e, 0)
            for f, v in zip(flanks, vals)]


def _parent_edge_exact(pl, tau, a_re, a_im):
    """The exact-edge correction field of the chunk: (pc, Ns) complex64."""
    pc, ns, dev = tau.shape[0], pl.opts.num_samples, tau.device
    flanks = _parent_edge_flanks(pl, tau, a_re, a_im)
    if pl.spreader != "scatter":
        corr = None
        for call in _parent_edge_spread_calls(pl, flanks):
            e = echo_freq._spread_dense(*call, impl=pl.d_impl,
                                        complex_out=True)
            corr = e if corr is None else corr + e
        return corr
    corr_r = torch.zeros((pc * ns,), dtype=torch.float32, device=dev)
    corr_i = torch.zeros_like(corr_r)
    offs = torch.arange(pl.n_edge, device=dev)[None, None, :]
    for cell0, gate, tap, rot_r, rot_i in flanks:
        nidx = cell0.to(torch.int64)[:, :, None] + offs
        ok = (nidx >= 0) & (nidx < ns)
        t_ok = torch.where(gate & ok, tap, 0.0)
        pos = torch.clamp(nidx, 0, ns - 1)
        flat = (torch.arange(pc, device=dev)[:, None, None] * ns
                + pos).reshape(-1)
        corr_r.index_add_(0, flat, (t_ok * rot_r).reshape(-1))
        corr_i.index_add_(0, flat, (t_ok * rot_i).reshape(-1))
    return torch.complex(corr_r, corr_i).reshape(pc, ns)


@pytest.mark.parametrize("flanks", ["shared", "apart"])
@pytest.mark.parametrize("spreader", ["dense", "dense_kernel"])
def test_synthesize_bits_unchanged_by_the_placement(monkeypatch, spreader,
                                                    flanks):
    """synthesize on the CPU gives the bits it gave with the row loop and
    the exact-edge pass's zeros / add / complex: both flanks on one cell
    list (Tp fs an integer) or one call a flank."""
    opts, fields = _freq_case()
    if flanks == "apart":
        opts = echo.EchoOpts(**{**opts.__dict__, "pulse_width_s": 2.01e-6})
    kw = dict(spreader=spreader, conv="xla")
    pl = echo_freq._plan(fields[0], opts, **kw)
    assert pl.share == (flanks == "shared")
    after = echo_freq.synthesize(*fields, opts, **kw)
    monkeypatch.setattr(echo_freq, "_spread_dense", _old_spread_dense)
    monkeypatch.setattr(echo_freq, "_main_field", _parent_main_field)
    monkeypatch.setattr(echo_freq, "_edge_exact", _old_edge_exact)
    before = echo_freq.synthesize(*fields, opts, **kw)
    assert np.array_equal(_bits(torch.view_as_real(after)),
                          _bits(torch.view_as_real(before)))


def test_kernel_operands_shapes():
    """kernel_operands' operands keep their shapes: the main spread's
    (pc, grp, bg) cells and (pc, grp, 1, 2W, bg) values, one shared-flank
    edge spread of two sets, the conv's (pc, l_imp) planes with rows a
    128-multiple of floats apart."""
    opts, fields = _freq_case()
    kw = dict(spreader="dense_kernel", conv="pallas")
    pl = echo_freq._plan(fields[0], opts, **kw)
    ops = echo_freq.kernel_operands(*fields, opts, **kw)
    pc, bg = fields[0].shape[0], -(-fields[0].shape[1] // pl.grp)
    c, v, win = ops["spread main"]
    assert (tuple(c.shape), tuple(v.shape), win) == (
        (pc, pl.grp, bg), (pc, pl.grp, 1, 2 * echo_freq._W, bg), pl.win)
    (ce, ve, win_e), = ops["spread edge"]
    assert (tuple(ce.shape), tuple(ve.shape), win_e) == (
        (pc, pl.grp_e, bg), (pc, pl.grp_e, 2, 2 * pl.n_edge, bg), pl.win_e)
    fr, fi, filt, nfft, rows = ops["conv"]
    for f in (fr, fi):
        assert f.shape == (pc, pl.l_imp) and f.stride(1) == 1
        assert f.stride(0) % 128 == 0
    assert (tuple(filt.shape), nfft, rows) == ((pl.l_fft,), pl.l_fft,
                                               pl.rows)
    # the formed taps' operands: (pc, rows, B) beside the same cells
    num_b = fields[0].shape[1]
    c_t, o_t, win_t, taps = ops["spread main taps"]
    assert torch.equal(c_t, c) and win_t == win
    assert tuple(o_t.shape) == (pc, 3, num_b) and taps.k_taps == echo_freq._W
    (ce_t, oe_t, win_et, taps_e), = ops["spread edge taps"]
    assert torch.equal(ce_t, ce) and win_et == win_e
    assert tuple(oe_t.shape) == (pc, 8, num_b) and taps_e.leading == (
        True, False)


def _parent_spreads(pl, fields):
    """The parent's _spread_dense calls (i0, val_sets, l_out, win, grp, lo)
    of the first chunk: the main pass's, then the exact-edge pass's."""
    tau = fields[0][:pl.pulse_chunk]
    a_re, a_im = echo_freq._rotated(*(f[:pl.pulse_chunk] for f in
                                      fields[1:]))
    i0, w = _parent_es_weights(pl, tau)
    return [_parent_main_spread_call(pl, i0, w, a_re, a_im),
            *_parent_edge_spread_calls(pl, _parent_edge_flanks(
                pl, tau, a_re, a_im))]


@pytest.mark.parametrize("num_b", [48, 50])
@pytest.mark.parametrize("flanks", ["shared", "apart"])
def test_formed_taps_plain_equals_parent_values(flanks, num_b):
    """spread_windows_pallas with formed taps on CPU tensors (its plain
    version) gives, from the operands synthesize now builds, the cells,
    values and windows of the parent's per-tap operands (_es_weights,
    _edge_flanks, _pack_vals) and spread_windows_plain, bit for bit: the
    ES taps, the flank taps on one cell list or one spread a flank, with
    and without padded targets (50 in 16 groups of 4: 14 padded)."""
    opts, fields = _freq_case(num_b)
    if flanks == "apart":
        opts = echo.EchoOpts(**{**opts.__dict__, "pulse_width_s": 2.01e-6})
    pl = echo_freq._plan(fields[0], opts, spreader="dense_kernel",
                         conv="xla")
    assert pl.share == (flanks == "shared")
    tau = fields[0][:pl.pulse_chunk]
    a_re, a_im = echo_freq._rotated(*(f[:pl.pulse_chunk] for f in
                                      fields[1:]))
    new = [echo_freq._main_spread(pl, tau, a_re, a_im),
           *echo_freq._edge_spreads(pl, tau, a_re, a_im)]
    old = _parent_spreads(pl, fields)
    assert len(new) == len(old) == (2 if flanks == "shared" else 3)
    for sp, (i0, val_sets, l_out, win, grp, lo) in zip(new, old):
        assert torch.equal(sp.i0, i0)
        assert (sp.l_out, sp.win, sp.grp, sp.lo) == (l_out, win, grp, lo)
        assert list(sp.offsets) == [off for _, _, off in val_sets]
        c_ok, base, lo_r = echo_freq._cells(sp.i0, sp.taps.k_taps, l_out,
                                            win, grp, lo)
        c_old, _, base_old, lo_old = echo_freq._group_cells(
            i0, val_sets, l_out, win, grp, lo)
        assert torch.equal(c_ok, c_old) and torch.equal(base, base_old)
        assert lo_r == lo_old
        bg = c_ok.shape[2]
        v_old = _parent_pack_vals(val_sets, bg * grp, grp)
        v_new = spread_kernel.pack_values(
            spread_kernel.tap_sets(sp.ops, sp.taps), grp)
        assert np.array_equal(_bits(v_new), _bits(v_old))
        got = spread_kernel.spread_windows_pallas(c_ok, sp.ops, win,
                                                  taps=sp.taps)
        want = spread_kernel.spread_windows_plain(c_old, v_old, win)
        assert np.abs(want.numpy()).max() > 0
        assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("flanks", ["shared", "apart"])
@pytest.mark.parametrize("spreader", ["scatter", "dense", "dense_kernel",
                                      "dense_kernel_qr"])
def test_synthesize_bits_unchanged_by_the_formed_taps(monkeypatch, spreader,
                                                      flanks):
    """synthesize on the CPU gives the bits it gave when _main_field and
    _edge_exact formed every tap in PyTorch (the parent's, monkeypatched
    in), on every spreader: both flanks on one cell list or one spread a
    flank."""
    opts, fields = _freq_case(50)
    if flanks == "apart":
        opts = echo.EchoOpts(**{**opts.__dict__, "pulse_width_s": 2.01e-6})
    kw = dict(spreader=spreader, conv="xla")
    after = echo_freq.synthesize(*fields, opts, **kw)
    monkeypatch.setattr(echo_freq, "_main_field", _parent_main_field)
    monkeypatch.setattr(echo_freq, "_edge_exact", _parent_edge_exact)
    before = echo_freq.synthesize(*fields, opts, **kw)
    assert float(before.abs().max()) > 0
    assert np.array_equal(_bits(torch.view_as_real(after)),
                          _bits(torch.view_as_real(before)))


def test_formed_taps_refuse_bad_operands(monkeypatch):
    """The formed taps refuse operands of another shape, the one-accumulator
    order, and (on the card's route) too many taps or too much shared
    memory, before any launch."""
    opts, fields = _freq_case(50)
    kw = dict(spreader="dense_kernel", conv="pallas")
    ops = echo_freq.kernel_operands(*fields, opts, **kw)
    c, o, win, taps = ops["spread main taps"]
    (ce, oe, win_e, taps_e), = ops["spread edge taps"]
    sw = spread_kernel.spread_windows_pallas
    for bad in (o[:, :2], o[:1], o[:, :, :40], o[:, :, None]):
        with pytest.raises(ValueError, match="formed taps need operands"):
            sw(c, bad, win, taps=taps)
    with pytest.raises(ValueError, match="formed taps need operands"):
        sw(ce, oe, win_e, taps=spread_kernel.FlankTaps(
            taps_e.k_taps, taps_e.fs_hz, taps_e.c2, taps_e.t_edge_s,
            (True,)))
    with pytest.raises(ValueError, match="roll order"):
        sw(c, o, win, qr=True, taps=taps)

    def no_launch(*a, **k):
        raise AssertionError("launched")

    # the card's route on CPU tensors: its checks run, no launch is reached
    monkeypatch.setattr(_build, "on_cpu", lambda x: False)
    monkeypatch.setattr(_build, "launch", no_launch)
    before = sw.launches_taps
    with pytest.raises(ValueError, match="taps exceed"):
        sw(c, o, win, taps=spread_kernel.EsTaps(31, taps.beta))
    pc = oe.shape[0]
    big = torch.zeros((pc, 8, 5000))
    big_c = torch.zeros((pc, 1, 5000), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        sw(big_c, big, win_e, taps=taps_e)
    assert sw.launches_taps == before


@pytest.mark.parametrize("fs,chirp,t_edge_n", [(600e6, 500e6 / 20e-6, 4.0),
                                               (60e6, 50e6 / 2e-6, 4.0),
                                               (150e6, 120e6 / 2e-6, 2.5)])
def test_formed_taps_kernel_constants(fs, chirp, t_edge_n):
    """The constants the formed taps read are the float32 numbers PyTorch's
    operators of tap_sets use on the card: each Python scalar rounded to
    float32 (beta, c2, fs, t_edge, pi, the gates' limits) and a division
    by a scalar as the product with its float32 reciprocal (1 / K, 1 /
    t_edge)."""
    f32 = np.float32
    taps = spread_kernel.FlankTaps(6, fs, math.pi * chirp / fs ** 2,
                                   t_edge_n / fs, (True, False))
    ints, floats = spread_kernel._tap_args(taps, 5000)
    assert ints == (2, 5000, 1)
    t32 = f32(taps.t_edge_s)
    want = (0.0, 0.0, f32(taps.c2), f32(fs), t32, f32(1) / t32, f32(math.pi),
            f32(-1e-12), f32(taps.t_edge_s + 1e-12))
    assert floats == tuple(float(x) for x in want)
    trailing = spread_kernel.FlankTaps(6, fs, taps.c2, taps.t_edge_s,
                                       (False,))
    assert spread_kernel._tap_args(trailing, 7)[0] == (2, 7, 0)
    es_ints, es_floats = spread_kernel._tap_args(
        spread_kernel.EsTaps(8, 18.4), 5000)
    assert es_ints == (1, 5000, 0)
    assert es_floats == (float(f32(18.4)), 0.125) + (0.0,) * 7
