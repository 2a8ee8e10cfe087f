"""Frequency-domain (NUFFT) echo synthesis: the fast backend for large
scenes.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/echo_freq.py``. The echo is
a convolution,

    raw(t) = sum_b A_b g(t - tau_b),   g(x) = gate(x) e^{j pi K (x - shift)^2},

with A_b = amp_b e^{j carrier_b}. Each impulse A_b delta(t - tau_b) is
spread over W = 8 taps of an os-times oversampled grid with an
exponential-of-semicircle kernel, the field is FFT-convolved with the
sampled chirp over the spreading kernel's transform, and the result is
decimated at the window's samples. With the exact-edge split (``edge_taper``
> 0, the default) the NUFFT path carries the chirp with raised-cosine
flanks, and the two gate-edge flanks are synthesised exactly per (pulse,
target) at the native rate and spread into a correction field.

Spreaders: ``'scatter'`` (index_add), ``'dense'`` (the reference's one-hot
spreader in plain PyTorch: :func:`_spread_dense` with ``impl='xla'``),
``'dense_kernel'`` / ``'dense_kernel_qr'`` (the same windows from the
hand-written spread kernel of ``ops/cuda/spread_kernel.py``, in the roll or
the one-accumulator order; its plain version for CPU tensors), or
``'auto'`` (``'dense_kernel'`` on the card, ``'scatter'`` on the CPU).
Every dense spreader takes the pass as a few float32 operands a (pulse,
target) (:class:`_Spread`); ``'dense_kernel'`` hands them to the spread
kernel, which forms the taps itself, and the others form the (pulse,
target, tap) values in PyTorch (``spread_kernel.tap_sets``): the same
bits.
``conv``: ``'xla'`` (torch.fft), ``'pallas'`` (the FFT-conv kernel of
``ops/cuda/fft_kernel.py``; on a CPU tensor its plain version, or torch.fft
where the kernel does not take the FFT length) or ``'auto'`` (the kernel on
the card where it takes the length, torch.fft otherwise). On the card an
explicit kernel route that refuses the shape raises ``ValueError``; the
``*_interpret`` names raise: the port has no kernel interpreter. The
accuracy class is the reference's: field RMS error < -55 dB against the
direct engine with edge_taper 4 and os 2 on a physical waveform (chirp
bandwidth < fs).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.ops.cuda import fft_kernel
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import spread_kernel
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import (
    count_device, span)

_W = 8                      # spreading taps
_BETA = 2.30 * _W           # ES-kernel beta (FINUFFT's rule of thumb)
_LANE_C = 128               # conv output rows are 128 samples wide
_TWO_PI = 2.0 * math.pi
# the dense spreaders and the _spread_dense route each takes
_D_IMPL = {"dense": "xla", "dense_kernel": "pallas",
           "dense_kernel_qr": "pallas_qr"}
_ES_TAPS = spread_kernel.EsTaps(_W, _BETA)     # the main pass's formed taps


def _next_fast_len(n: int) -> int:
    """Next power of two >= n (the reference's rule: the conv kernel and
    its plain version take power-of-two lengths)."""
    return 1 << (n - 1).bit_length()


def _es_kernel(u):
    """exp(beta*(sqrt(1-(2u/W)^2)-1)) on |u|<=W/2, else 0."""
    z = 2.0 * np.asarray(u, np.float64) / _W
    inside = np.abs(z) < 1.0
    val = np.exp(_BETA * (np.sqrt(np.maximum(1.0 - z * z, 0.0)) - 1.0))
    return np.where(inside, val, 0.0)


@lru_cache(maxsize=None)
def _kernel_ft(l_fft: int) -> np.ndarray:
    """phi_hat(nu_k) for all DFT bins (numerical quadrature, host, cached)."""
    nu = np.fft.fftfreq(l_fft)                      # cycles/sample
    uq = np.linspace(-_W / 2, _W / 2, 8 * _W + 1)
    wq = _es_kernel(uq)
    # trapezoid weights
    tw = np.full(uq.shape, uq[1] - uq[0])
    tw[0] *= 0.5
    tw[-1] *= 0.5
    ft = (wq * tw) @ np.exp(-2j * np.pi * np.outer(uq, nu))
    # clamp far out-of-band values so deconvolution cannot blow up where the
    # chirp spectrum is ~0 anyway
    mag = np.abs(ft)
    floor = mag.max() * 1e-6
    ft = np.where(mag < floor, floor, ft)
    return ft.astype(np.complex128)


def chirp_kernel(opts, oversample: int, edge_taper_samples: float = 0.0):
    """(g taps complex64, x0) — g sampled at os*fs over its gate support.

    ``edge_taper_samples`` > 0 applies raised-cosine flanks of that width
    (in *native* samples) inside the gate: the smooth part for the
    exact-edge split (see :func:`synthesize`)."""
    dt = 1.0 / (opts.fs_hz * oversample)
    n = int(round(opts.pulse_width_s / dt)) + 1
    x0 = opts.chirp_shift - opts.half_width
    arg = x0 + np.arange(n) * dt - opts.chirp_shift
    gate = np.abs(arg) <= opts.half_width + 1e-15
    g = np.exp(1j * math.pi * opts.chirp_rate * arg ** 2) * gate
    if edge_taper_samples > 0.0:
        # gate-local coordinate: arg is chirp-centred, the gate starts at
        # arg = -half_width
        g = g * _edge_taper(arg + opts.half_width, opts.pulse_width_s,
                            edge_taper_samples / opts.fs_hz)
    return g.astype(np.complex64), x0


def _edge_taper(u, width_s: float, t_edge_s: float):
    """Raised-cosine flanks inside [0, width]: 0 at the gate edges, 1 in the
    interior beyond t_edge (host numpy)."""
    d = np.minimum(u, width_s - u)                 # distance to nearest edge
    z = np.clip(d / t_edge_s, 0.0, 1.0)
    return np.where(d < 0, 0.0, 0.5 - 0.5 * np.cos(np.pi * z))


def _floor_div(x: torch.Tensor, m: int) -> torch.Tensor:
    return torch.div(x, m, rounding_mode="floor")


def _cells(i0, k_max: int, l_out: int, win: int, grp: int, lo: int = 0):
    """The group windows' cells of :func:`_spread_dense`: (c_ok (pc, grp,
    bg) int32 window-relative tap-0 cells, -1 for a dropped target; base
    (pc, grp) int32 each window's cell in the padded field; lo rounded up to
    128), for value sets of at most ``k_max`` taps."""
    pc, num_b = i0.shape
    bg = -(-num_b // grp)
    b_pad = bg * grp
    far = -(10 ** 6)
    i0p = torch.nn.functional.pad(i0.to(torch.int32), (0, b_pad - num_b),
                                  value=far)

    # ``lo`` + one window of margin below, margin + tap offsets above: every
    # set's group window then sits inside the padded field, and out-of-grid
    # taps land in the margins (cropped at the end: the scatter ok-mask
    # equivalent). ``lo`` > 0 admits i0 down to -lo (offset sets can still
    # land such targets' taps in-grid).
    lo = -(-lo // 128) * 128
    i0g = i0p.reshape(pc, grp, bg) + win + lo
    live = i0g > far // 2
    base = torch.amin(torch.where(live, i0g, 10 ** 6), dim=2) - 8
    base = torch.clamp(_floor_div(base, 128) * 128, 0, l_out + win + lo)
    c_rel = i0g - base[:, :, None]

    # one cell list serves every value set (built with the widest tap margin)
    ok = live & (c_rel >= 0) & (c_rel <= win - k_max)
    # (pulse, target) pairs whose group window cannot hold them
    count_device("echo.dropped", lambda: (live & ~ok).sum())
    c_ok = torch.where(ok, c_rel, -1).to(torch.int32).contiguous()
    return c_ok, base, lo


def _group_cells(i0, val_sets, l_out: int, win: int, grp: int, lo: int = 0):
    """The group-window operands of :func:`_spread_dense`: :func:`_cells`'
    (c_ok, base, lo) with the sets' values, (pc, grp, S, 2K, bg) float32,
    between the cells and the bases."""
    c_ok, base, lo = _cells(i0, max(v[0].shape[-1] for v in val_sets), l_out,
                            win, grp, lo)
    return c_ok, spread_kernel.pack_values([(vr, vi) for vr, vi, _ in
                                            val_sets], grp), base, lo


def _spread_dense(i0, val_sets, l_out: int, win: int, grp: int,
                  lo: int = 0, impl: str = "xla", complex_out: bool = False):
    """Spreading by group windows of delay-ordered targets: values at
    integer cells, each group of B/grp consecutive targets spread into a
    window of ``win`` cells of its own, the windows then added into the
    field at their 128-aligned bases.

    i0: (pc, B) int32 cell of tap 0 (may be out of grid: such taps carry
    zero weight, matching the scatter path's clip).
    val_sets: sequence of (vr (pc, B, K), vi, offset): each set's taps land
    at cells i0 + offset + k, all sets sharing one cell list (the exact-edge
    pass: the trailing gate flank sits an integer number of cells after the
    leading one). Targets whose group window cannot hold them (group cell
    spread > win - K) drop; callers size win/grp so sane scenes never hit
    that, and the stage record counts the (pulse, target) pairs dropped
    (``echo.dropped``, summed on the card).
    impl: 'xla' (the plain one-hot windows,
    ``spread_kernel.spread_windows_plain``), 'pallas' or 'pallas_qr'
    (``spread_kernel.spread_windows_pallas``: the kernel on the card, its
    plain version on the CPU; 'pallas_qr' in the one-accumulator order).
    The windows go into the field through ``spread_kernel.place_windows``
    (the placement kernel on the card, the reference's row loop on the
    CPU). Returns (pc, l_out) float32 re/im fields, or with
    ``complex_out`` the (pc, l_out) complex64 field.
    """
    if impl not in ("xla", "pallas", "pallas_qr"):
        raise ValueError(f"unknown spread impl {impl!r}")
    c_ok, vals, base, lo = _group_cells(i0, val_sets, l_out, win, grp, lo)
    if impl == "xla":
        wins = spread_kernel.spread_windows_plain(c_ok, vals, win)
    else:
        wins = spread_kernel.spread_windows_pallas(c_ok, vals, win,
                                                   qr=impl == "pallas_qr")
    return spread_kernel.place_windows(wins, base,
                                       [off for _, _, off in val_sets],
                                       win + lo, l_out, complex_out)


class _Spread(NamedTuple):
    """One pass's spread before any tap value exists: the tap-0 cells i0
    (pc, B) int32, the (pc, rows, B) float32 operands of the formed taps
    and their staging (``spread_kernel.EsTaps`` or ``FlankTaps``), each
    set's cell offset, and :func:`_spread_dense`'s l_out, win, grp, lo."""

    i0: torch.Tensor
    ops: torch.Tensor
    taps: object
    offsets: tuple
    l_out: int
    win: int
    grp: int
    lo: int


def _value_sets(sp: _Spread) -> list:
    """The pass's value sets for :func:`_spread_dense`: (vr, vi, offset)
    with the taps formed in PyTorch (``spread_kernel.tap_sets``)."""
    return [(vr, vi, off) for (vr, vi), off in
            zip(spread_kernel.tap_sets(sp.ops, sp.taps), sp.offsets)]


def _spread(pl, sp: _Spread, complex_out: bool = False):
    """The pass spread by the plan's dense spreader: 'dense_kernel' hands
    the spread wrapper the operands (the kernel forms the taps on the card;
    its plain version forms them in PyTorch on the CPU) and places the
    windows as :func:`_spread_dense` does; the other dense spreaders
    :func:`_spread_dense` the value sets."""
    if pl.spreader != "dense_kernel":
        return _spread_dense(sp.i0, _value_sets(sp), sp.l_out, sp.win, sp.grp,
                             sp.lo, impl=pl.d_impl, complex_out=complex_out)
    c_ok, base, lo = _cells(sp.i0, sp.taps.k_taps, sp.l_out, sp.win, sp.grp,
                            sp.lo)
    wins = spread_kernel.spread_windows_pallas(c_ok, sp.ops, sp.win,
                                               taps=sp.taps)
    return spread_kernel.place_windows(wins, base, list(sp.offsets),
                                       sp.win + lo, sp.l_out, complex_out)


def _wrap32(x64: torch.Tensor) -> torch.Tensor:
    return (x64 - _TWO_PI * torch.round(x64 / _TWO_PI)).to(torch.float32)


def _resolve_routes(spreader: str, conv: str, l_fft: int, on_card: bool):
    """The spreader and conv routes the reference's rules pick."""
    if spreader == "auto":
        spreader = "dense_kernel" if on_card else "scatter"
    if conv == "auto":
        conv = "pallas" if on_card and fft_kernel.supported(l_fft) else "xla"
    for name, val in (("spreader", spreader), ("conv", conv)):
        if val.endswith("_interpret"):
            raise NotImplementedError(
                f"{name}={val!r}: interpret mode is not ported (the port has "
                "no kernel interpreter); pass CPU tensors with "
                f"{val[:-len('_interpret')]!r} to run the kernel's plain "
                "version")
    if spreader != "scatter" and spreader not in _D_IMPL:
        raise ValueError(f"unknown spreader {spreader!r}")
    if conv not in ("xla", "pallas"):
        raise ValueError(f"unknown conv {conv!r}")
    if conv == "pallas" and not fft_kernel.supported(l_fft):
        if on_card:
            raise ValueError(
                f"conv='pallas': the FFT-conv kernel does not take l_fft="
                f"{l_fft}; use conv='auto' or 'xla'")
        conv = "xla"          # the reference's fallback, for CPU tensors
    return spreader, conv


@dataclass
class _Plan:
    """What :func:`synthesize` fixes once per call: the grids, the filter,
    the routes, the group windows and the pulse chunk."""

    opts: object
    os: int                   # oversampling of the spreading grid
    x0: float                 # chirp support start [s]
    lead: int                 # field cells before the window's first sample
    l_imp: int                # field length
    l_fft: int
    filt: torch.Tensor        # (l_fft,) complex64 chirp / spreader response
    rows: tuple               # the conv kernel's band rows [p0c, p1c)
    off_c: int                # first window cell inside the band rows
    pulse_chunk: int
    spreader: str
    conv: str
    win: int                  # main pass group window and group count
    grp: int
    win_e: int                # exact-edge pass, at the native rate
    grp_e: int
    n_edge: int               # taps a flank (0: no exact-edge pass)
    t_edge_s: float           # flank width [s]
    delta: int                # trailing flank's offset from the leading one
    share: bool               # both flanks in one cell list

    @property
    def d_impl(self):
        return _D_IMPL.get(self.spreader)


def _plan(tau_rel, opts, oversample: int = 2,
          pulse_chunk: int | None = None, edge_taper: float = 4.0,
          spreader: str = "auto", spread_win: int | None = None,
          spread_grp: int | None = None, conv: str = "auto",
          spread_win_edge: int | None = None,
          spread_grp_edge: int | None = None) -> _Plan:
    """The plan of :func:`synthesize` (its options, its defaults)."""
    num_p, num_b = tau_rel.shape
    dev = tau_rel.device
    ns = opts.num_samples
    os_ = oversample
    fs_os = opts.fs_hz * os_
    d_win, d_grp = spread_win or 4096, spread_grp or 16
    # the edge pass works at the native rate (half the oversampled grid's
    # span), so its window scales as spread_win / 2
    d_win_e, d_grp_e = (spread_win_edge
                        or (spread_win // 2 if spread_win else 2048),
                        spread_grp_edge or spread_grp or 16)
    # the windows place as whole 128-sample rows at both rates
    if d_win % 128:
        raise ValueError(f"spread_win must be a 128-multiple (got "
                         f"{spread_win})")
    if d_win_e % 128 or d_win_e < 256:
        if spread_win_edge:
            raise ValueError(f"spread_win_edge must be a 128-multiple of at "
                             f"least 256 (got {spread_win_edge})")
        raise ValueError(
            f"spread_win must be a 256-multiple of at least 512 (got "
            f"{spread_win}): the exact-edge pass's window is spread_win // 2"
            " unless spread_win_edge is given")

    g, x0 = chirp_kernel(opts, os_, edge_taper)
    lead = int(round(opts.pulse_width_s * fs_os)) + os_ + _W     # L0
    l_imp = lead + ns * os_ + os_ + _W
    # circular-wrap sizing: the wrapped tail of the linear convolution stays
    # inside the lead margin, never the cropped window [lead, ...)
    l_fft = _next_fast_len(l_imp)
    assert l_imp + g.shape[0] - 1 - l_fft <= lead
    spreader, conv = _resolve_routes(spreader, conv, l_fft,
                                     dev.type == "cuda")
    # combined spectral filter: chirp response deconvolved by the spreader
    filt = torch.from_numpy((np.fft.fft(g.astype(np.complex128), n=l_fft)
                             / _kernel_ft(l_fft)).astype(np.complex64)).to(dev)
    # inverse-band rows for the fused conv: only the window's rows
    p0c = lead // _LANE_C
    p1c = -(-(lead + ns * os_) // _LANE_C)

    if pulse_chunk is None:
        per_pulse = max(num_b * _W, l_fft)
        pulse_chunk = max(1, opts.max_elements // per_pulse)
    t_edge_s = edge_taper / opts.fs_hz
    # with an integer flank separation (Tp fs an integer: every reference
    # waveform) both flanks share one cell list, the trailing set offset by
    # delta cells
    delta_f = (opts.pulse_width_s - t_edge_s) * opts.fs_hz
    delta = int(round(delta_f))
    return _Plan(
        opts=opts, os=os_, x0=x0, lead=lead, l_imp=l_imp, l_fft=l_fft,
        filt=filt, rows=(p0c, p1c), off_c=lead - p0c * _LANE_C,
        pulse_chunk=max(1, min(pulse_chunk, max(num_p, 1))),
        spreader=spreader, conv=conv, win=d_win, grp=d_grp, win_e=d_win_e,
        grp_e=d_grp_e,
        n_edge=int(math.ceil(edge_taper)) + 2 if edge_taper > 0 else 0,
        t_edge_s=t_edge_s, delta=delta, share=abs(delta_f - delta) < 1e-6)


def _es_cells(pl: _Plan, tau):
    """The chunk's impulses on the oversampled grid: tap-0 cells i0 (pc, B)
    int32 and each impulse's position past its cell, frac (pc, B)
    float32."""
    s = (tau.to(torch.float64) + pl.x0) * (pl.opts.fs_hz * pl.os) + pl.lead
    s_fl = torch.floor(s)
    return s_fl.to(torch.int32) - (_W // 2 - 1), (s - s_fl).to(torch.float32)


def _main_spread(pl: _Plan, tau, a_re, a_im) -> _Spread:
    """The main pass's spread: ES taps of (frac, a_re, a_im)."""
    i0, frac = _es_cells(pl, tau)
    # clamp far-out cells near the grid edges: their taps land in the
    # margins (dropped, as the scatter path's ok-mask drops them) without
    # dragging their group's window away
    i0_d = torch.clamp(i0, -256, pl.l_imp + 256)
    return _Spread(i0_d, torch.stack([frac, a_re, a_im], dim=1), _ES_TAPS,
                   (0,), pl.l_imp, pl.win, pl.grp, 0)


def _main_field(pl: _Plan, tau, a_re, a_im):
    """The chunk's impulses spread onto the oversampled grid: (pc, l_imp)
    float32 re/im fields."""
    if pl.spreader != "scatter":
        return _spread(pl, _main_spread(pl, tau, a_re, a_im))
    i0, frac = _es_cells(pl, tau)
    w = spread_kernel.es_weights(frac, _W, _BETA)
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


def _conv(pl: _Plan, fr, fi):
    """The fields convolved with the filter, decimated to the window's
    samples: (pc, Ns) complex64."""
    ns, os_ = pl.opts.num_samples, pl.os
    if pl.conv == "pallas":
        # the field planes are column views of the padded field: the kernel
        # reads them through their row stride, no copy
        conv_c = fft_kernel.fft_conv_pallas(fr, fi, pl.filt, pl.l_fft,
                                            out_rows=pl.rows)
        return conv_c[:, pl.off_c:pl.off_c + ns * os_:os_]
    conv_c = fft_kernel.fft_conv_plain(fr, fi, pl.filt, pl.l_fft)
    return conv_c[:, pl.lead:pl.lead + ns * os_:os_]


def _flanks(pl: _Plan, tau):
    """Both gate flanks of the exact-edge pass, leading then trailing, per
    (pulse, target): cell0 (pc, B) float64, the first native sample at or
    after the flank's start, and its taps' float32 operands e0 (tap 0's
    flank-local time), c0 and c1 (the flank phase c0 + c1 k + c2 k^2 is
    quadratic in the tap k; c0 and c1 computed and wrapped in float64)."""
    opts, x0 = pl.opts, pl.x0
    tau64 = tau.to(torch.float64)
    flanks = []
    for edge_off in (0.0, opts.pulse_width_s - pl.t_edge_s):
        # first native sample index at/after the flank start
        start = (tau64 + x0 + edge_off) * opts.fs_hz             # (pc, B)
        cell0 = torch.ceil(start - 1e-9)
        # flank-local coordinate of tap 0 (small f64 -> exact f32)
        e0 = cell0 / opts.fs_hz - tau64 - x0 - edge_off
        arg0 = e0 + edge_off + x0 - opts.chirp_shift
        flanks.append((cell0, e0.to(torch.float32),
                       _wrap32(math.pi * opts.chirp_rate * arg0 * arg0),
                       _wrap32((_TWO_PI * opts.chirp_rate / opts.fs_hz)
                               * arg0)))
    return flanks


def _flank_taps(pl: _Plan, leading: tuple):
    """The flank taps of sets that are leading or trailing flanks."""
    opts = pl.opts
    return spread_kernel.FlankTaps(
        pl.n_edge, opts.fs_hz, math.pi * opts.chirp_rate / (opts.fs_hz ** 2),
        pl.t_edge_s, leading)


def _edge_spreads(pl: _Plan, tau, a_re, a_im) -> list:
    """The exact-edge pass's spreads: one of both flanks on a shared cell
    list where the flanks sit a whole number of samples apart, else one a
    flank."""
    ns = pl.opts.num_samples
    flanks = _flanks(pl, tau)
    if pl.share:
        i0 = torch.clamp(flanks[0][0], -pl.delta - 256.0, ns + 256.0)
        ops = torch.stack([a_re, a_im, *flanks[0][1:], *flanks[1][1:]],
                          dim=1)
        return [_Spread(i0.to(torch.int32), ops,
                        _flank_taps(pl, (True, False)), (0, pl.delta), ns,
                        pl.win_e, pl.grp_e, pl.delta + 256)]
    return [_Spread(torch.clamp(f[0], -256.0, ns + 256.0).to(torch.int32),
                    torch.stack([a_re, a_im, *f[1:]], dim=1),
                    _flank_taps(pl, (leading,)), (0,), ns, pl.win_e, pl.grp_e,
                    0)
            for f, leading in zip(flanks, (True, False))]


def _edge_exact(pl: _Plan, tau, a_re, a_im):
    """The exact-edge correction field of the chunk: (pc, Ns) complex64."""
    pc, ns, dev = tau.shape[0], pl.opts.num_samples, tau.device
    if pl.spreader != "scatter":
        # one spread where the flanks share a cell list; else the two
        # spreads' fields add in order
        corr = None
        for sp in _edge_spreads(pl, tau, a_re, a_im):
            e = _spread(pl, sp, complex_out=True)
            corr = e if corr is None else corr + e
        return corr
    corr_r = torch.zeros((pc * ns,), dtype=torch.float32, device=dev)
    corr_i = torch.zeros_like(corr_r)
    offs = torch.arange(pl.n_edge, device=dev)[None, None, :]
    for (cell0, *ops), leading in zip(_flanks(pl, tau), (True, False)):
        gate, tap, rot_r, rot_i = spread_kernel.flank_taps(
            *ops, a_re, a_im, _flank_taps(pl, (leading,)), leading)
        nidx = cell0.to(torch.int64)[:, :, None] + offs
        ok = (nidx >= 0) & (nidx < ns)
        t_ok = torch.where(gate & ok, tap, 0.0)
        pos = torch.clamp(nidx, 0, ns - 1)
        flat = (torch.arange(pc, device=dev)[:, None, None] * ns
                + pos).reshape(-1)
        corr_r.index_add_(0, flat, (t_ok * rot_r).reshape(-1))
        corr_i.index_add_(0, flat, (t_ok * rot_i).reshape(-1))
    return torch.complex(corr_r, corr_i).reshape(pc, ns)


def _rotated(car, am):
    return am * torch.cos(car), am * torch.sin(car)


def synthesize(tau_rel, carrier, amp, opts, oversample: int = 2,
               pulse_chunk: int | None = None, edge_taper: float = 4.0,
               spreader: str = "auto", spread_win: int | None = None,
               spread_grp: int | None = None, conv: str = "auto",
               spread_win_edge: int | None = None,
               spread_grp_edge: int | None = None) -> torch.Tensor:
    """(P, B) per-(pulse, target) float32 scalars on one device -> (P, Ns)
    complex64 raw data there.

    tau_rel: delay of each echo relative to the window start [s]; carrier:
    wrapped carrier phase [rad]; amp: real amplitude. The target axis must
    be sorted by delay for the dense spreaders (the echo engine's freq
    branch sorts it). Pulses go in chunks sized from ``opts.max_elements``
    (the reference's rule), bounding the spreading temporaries ((pc, B, W)
    tap values where PyTorch forms them) and the (pc, l_fft) field.
    ``edge_taper`` > 0 enables the exact-edge split; 0 restores the
    approximate mode (~-25 dB field floor).
    ``spread_win`` / ``spread_grp`` (and ``*_edge`` for the exact-edge
    pass, whose window defaults to half the main one) size the dense
    spreaders' group windows.
    """
    with span("echo.synthesize"):
        pl = _plan(tau_rel, opts, oversample, pulse_chunk, edge_taper,
                   spreader, spread_win, spread_grp, conv, spread_win_edge,
                   spread_grp_edge)
        num_p, ns = tau_rel.shape[0], opts.num_samples
        out = torch.empty((num_p, ns), dtype=torch.complex64,
                          device=tau_rel.device)
        for p0 in range(0, num_p, pl.pulse_chunk):
            with span("echo.chunk", p0=p0):
                tau = tau_rel[p0:p0 + pl.pulse_chunk]
                a_re, a_im = _rotated(carrier[p0:p0 + pl.pulse_chunk],
                                      amp[p0:p0 + pl.pulse_chunk])
                with span("echo.spread"):
                    field = _main_field(pl, tau, a_re, a_im)
                with span("echo.conv"):
                    out_c = _conv(pl, *field)
                if pl.n_edge:
                    with span("echo.edge"):
                        out_c = out_c + _edge_exact(pl, tau, a_re, a_im)
                out[p0:p0 + tau.shape[0]] = out_c
        return out


def kernel_operands(tau_rel, carrier, amp, opts, **synth_kw) -> dict:
    """The operands that :func:`synthesize` (the same arguments) hands its
    kernel wrappers for its first pulse chunk, to time the kernels at the
    path's shapes: ``"spread main taps"`` (c_ok, ops, win, taps) and
    ``"spread edge taps"``, a list of the same, one a spread of the
    exact-edge pass, for ``spread_kernel.spread_windows_pallas(c_ok, ops,
    win, taps=taps)`` (the 'dense_kernel' route); ``"spread main"`` (c_ok,
    vals, win) and ``"spread edge"``, the same spreads with their values
    formed in PyTorch, as the other dense spreaders hand them the wrapper;
    ``"conv"`` (fr, fi, filt, l_fft, rows) for
    ``fft_kernel.fft_conv_pallas``, the field planes as the column views of
    the padded field that :func:`synthesize` passes. The routes must be a
    dense spreader, the conv kernel and the exact-edge pass (ValueError
    otherwise)."""
    pl = _plan(tau_rel, opts, **synth_kw)
    if pl.spreader == "scatter" or pl.conv != "pallas" or not pl.n_edge:
        raise ValueError(
            f"kernel_operands needs a dense spreader, the conv kernel and the"
            f" exact-edge pass (got spreader {pl.spreader!r}, conv "
            f"{pl.conv!r}, {pl.n_edge} edge taps)")
    n = pl.pulse_chunk
    tau = tau_rel[:n]
    a_re, a_im = _rotated(carrier[:n], amp[:n])
    main = _main_spread(pl, tau, a_re, a_im)
    edge = _edge_spreads(pl, tau, a_re, a_im)
    fr, fi = _spread(pl, main)

    def values(sp):
        return _group_cells(sp.i0, _value_sets(sp), sp.l_out, sp.win, sp.grp,
                            sp.lo)[:2] + (sp.win,)

    def formed(sp):
        return (_cells(sp.i0, sp.taps.k_taps, sp.l_out, sp.win, sp.grp,
                       sp.lo)[0], sp.ops, sp.win, sp.taps)

    return {"spread main": values(main),
            "spread edge": [values(sp) for sp in edge],
            "spread main taps": formed(main),
            "spread edge taps": [formed(sp) for sp in edge],
            "conv": (fr, fi, pl.filt, pl.l_fft, pl.rows)}
