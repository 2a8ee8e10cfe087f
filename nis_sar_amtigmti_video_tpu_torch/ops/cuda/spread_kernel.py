"""The NUFFT echo's group-window spread.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/pallas/spread_kernel.py``
(``spread_windows_pallas`` with its bodies ``_kernel`` and ``_kernel_qr``):
the windows that ``ops/echo_freq.py::_spread_dense`` places into the
oversampled impulse field. Per (pulse, group) of delay-ordered targets, with
c_b the window-relative cell of target b's tap 0 and v[k, b] its tap values,

    roll order (``qr=False``):  out[j] = sum_k part_k[(j - k) mod win],
                                part_k[i] = sum_{b: c_b = i} v[k, b]
    one accumulator (``qr=True``): out[j] = sum_{k, b: c_b + k = j} v[k, b]

for every value set sharing the one cell list. A target with c outside
[0, win) drops at every tap. :func:`spread_windows_pallas` runs its plain
version (one-hot contractions, bounded in memory by pulse blocks) for CPU
tensors, and launches the hand-written CUDA kernel of
``csrc/spread_kernel.cu`` or raises for CUDA tensors. The kernel (one block
a (pulse, group)) lists each occupied cell's targets stably (an occupancy
bitmask of the window, warp matches), and each window cell visits only its
occupied predecessors, so it gives the same bits as a walk over every
window cell and tap. The reference's bf16 hi/lo split (a Mosaic
workaround) is not ported: values are float32.

Layout: cells (pc, grp, bg) int32; values (pc, grp, S, 2K, bg) float32,
[re | im] on the tap axis, S value sets; windows (pc, grp, 2S, win) float32,
row 2s the real and 2s + 1 the imaginary part of set s. The reference takes
a list of per-set (pc, grp, 2K, bg) tensors and returns per-set pairs; the
stacked layout lets one launch read every set.

Formed taps (``taps=``, the roll order): the kernel forms the values
itself from a few float32 operands a target, (pc, rows, B) with target b of
group g in column g bg + b, and the value tensor never exists. Two
stagings, each the float32 arithmetic of :func:`tap_sets` (the plain
version's, operation for operation): :class:`EsTaps`, the NUFFT echo's
main pass (rows frac, a_re, a_im: ES-kernel weights times the amplitude),
and :class:`FlankTaps`, its exact-edge pass (rows a_re, a_im, then e0, c0,
c1 of each set: raised-cosine gate flanks times the rotated amplitude).

:func:`place_windows` adds the windows into the field at their bases (set
s at its integer cell offset), in one launch of a kernel that replaces no
Pallas kernel: the reference places them with jnp, a gather, add and store
of each group's rows, and :func:`place_windows_plain` is that loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build
from nis_sar_amtigmti_video_tpu_torch.utils import profiling

SMEM_MAX = 232_448             # bytes of shared memory a block may use
K_MAX = 30           # taps the kernel takes: 4 cells read K + 3 <= 33 bits
_PLAIN_ELEMENTS = 1 << 26      # one-hot elements per pulse block (plain)
PLACE_SETS = 4                 # value sets the placement kernel takes
PLACE_GROUPS = 12_288          # groups: their bases in 48 KB of shared memory


def smem_bytes(bg: int, win: int, n_sets: int, k_taps: int) -> int:
    """The kernel's shared memory (``smem_bytes`` in the source): the
    group's values rounded up to 16 bytes; the target keys and the stable
    target list (bg each); the counts, the least targets and the
    starts of the occupied cells (bg, bg, bg + 1); the window's occupancy
    words (win / 32 rounded up, one zero word after them) and their
    popcount prefix (as many). Within ``SMEM_MAX``, bg stays below 2^15,
    as the kernel needs (it packs a target index and a count in one
    word)."""
    nv = n_sets * 2 * k_taps * bg
    nw = -(-win // 32)
    return 4 * (-(-nv // 4) * 4 + 5 * bg + 2 * nw + 3)


@dataclass(frozen=True)
class EsTaps:
    """Formed taps of the NUFFT echo's main pass: one set of ``k_taps``
    exponential-of-semicircle weights times the target's amplitude;
    operand rows frac, a_re, a_im."""

    k_taps: int
    beta: float

    n_sets = 1
    rows = 3
    staging = 1               # the kernel's kEsTaps


@dataclass(frozen=True)
class FlankTaps:
    """Formed taps of the NUFFT echo's exact-edge pass: ``k_taps`` native
    samples of a gate flank (raised cosine of width ``t_edge_s``, a leading
    or a trailing flank a set) times the target's amplitude rotated by the
    chirp phase c0 + c1 k + c2 k^2; operand rows a_re, a_im, then e0 (the
    flank-local time of tap 0), c0 and c1 of each set."""

    k_taps: int
    fs_hz: float
    c2: float                 # rad a tap^2
    t_edge_s: float
    leading: tuple            # per set

    staging = 2               # the kernel's kFlankTaps

    @property
    def n_sets(self) -> int:
        return len(self.leading)

    @property
    def rows(self) -> int:
        return 2 + 3 * self.n_sets


def es_weights(frac: torch.Tensor, k_taps: int, beta: float) -> torch.Tensor:
    """The (..., K) float32 weights of taps k at u = (k - (K/2 - 1)) -
    frac: exp(beta (sqrt(1 - (2u/K)^2) - 1)) on |u| < K/2, else 0."""
    dev = frac.device
    offs = torch.arange(k_taps, dtype=torch.int32, device=dev)
    u = (offs.to(torch.float32) - (k_taps // 2 - 1)) - frac[..., None]
    z2 = torch.clamp(1.0 - (2.0 * u / k_taps) ** 2, 0.0, 1.0)
    b = torch.tensor(beta, dtype=torch.float32, device=dev)
    return torch.where(torch.abs(u) < k_taps / 2.0,
                       torch.exp(b * (torch.sqrt(z2) - 1.0)), 0.0)


def flank_taps(e0, c0, c1, a_re, a_im, taps: FlankTaps, leading: bool):
    """One flank's (gate, tap, rot_r, rot_i), each (..., K): tap k at
    flank-local time e = e0 + k / fs is inside the gate where e >= 0
    (leading) or e <= t_edge (trailing), up to 1e-12 s; tap, the flank
    weight 1 - raised cosine of the distance to the gate edge over t_edge;
    rot, the amplitude rotated by c0 + c1 k + c2 k^2."""
    f32, dev = torch.float32, e0.device
    offs_f = torch.arange(taps.k_taps, device=dev).to(f32)
    c2 = torch.tensor(taps.c2, dtype=f32, device=dev)
    fs32 = torch.tensor(taps.fs_hz, dtype=f32, device=dev)
    t_edge_s = taps.t_edge_s
    ph = c0[..., None] + c1[..., None] * offs_f + c2 * offs_f * offs_f
    e = e0[..., None] + offs_f / fs32
    if leading:
        gate = e >= -1e-12
        d = e
    else:
        gate = e <= t_edge_s + 1e-12
        d = t_edge_s - e
    z = torch.clamp(d / t_edge_s, 0.0, 1.0)
    tap = 0.5 + 0.5 * torch.cos(math.pi * z)       # 1 - raised cosine
    cs, sn = torch.cos(ph), torch.sin(ph)
    ar, ai = a_re[..., None], a_im[..., None]
    return gate, tap, cs * ar - sn * ai, cs * ai + sn * ar


def tap_sets(ops: torch.Tensor, taps) -> list:
    """The formed taps' value sets [(vr, vi) (pc, B, K) float32, ...] of
    the (pc, rows, B) operands: what the kernel forms, in plain PyTorch."""
    if isinstance(taps, EsTaps):
        w = es_weights(ops[:, 0], taps.k_taps, taps.beta)
        return [(w * ops[:, 1, :, None], w * ops[:, 2, :, None])]
    sets = []
    for s, leading in enumerate(taps.leading):
        gate, tap, rot_r, rot_i = flank_taps(*ops[:, 2 + 3 * s:5 + 3 * s]
                                             .unbind(1), ops[:, 0],
                                             ops[:, 1], taps, leading)
        sets.append((torch.where(gate, tap, 0.0) * rot_r,
                     torch.where(gate, tap, 0.0) * rot_i))
    return sets


def pack_values(sets, grp: int) -> torch.Tensor:
    """Value sets [(vr, vi) (pc, B, K), ...] as the kernel's (pc, grp, S,
    2K, bg) float32, [re | im] on the tap axis, B padded with zeros to grp
    bg targets."""
    v = torch.stack([torch.cat([vr, vi], dim=-1) for vr, vi in sets],
                    dim=1)                                   # (pc, S, B, 2K)
    pc, n_sets, num_b, k2 = v.shape
    bg = -(-num_b // grp)
    v = torch.nn.functional.pad(v, (0, 0, 0, bg * grp - num_b))
    return v.reshape(pc, n_sets, grp, bg, k2).permute(
        0, 2, 1, 4, 3).to(torch.float32).contiguous()


def _f32(x: float) -> float:
    return float(np.float32(x))


def _tap_args(taps, num_b: int):
    """The formed-taps launcher's ints (staging, B, leading bits) and
    float32 constants (beta, 1 / K, c2, fs, t_edge, 1 / t_edge, pi, the
    leading and the trailing gate's limits), each rounded as the PyTorch
    operators of :func:`tap_sets` round their Python scalars on the card:
    a scalar to float32, a division by a scalar as the product with its
    float32 reciprocal."""
    if isinstance(taps, EsTaps):
        return ((taps.staging, num_b, 0),
                (_f32(taps.beta), _f32(1.0 / taps.k_taps)) + (0.0,) * 7)
    t_edge = _f32(taps.t_edge_s)
    lead = sum(1 << s for s, a in enumerate(taps.leading) if a)
    return ((taps.staging, num_b, lead),
            (0.0, 0.0, _f32(taps.c2), _f32(taps.fs_hz), t_edge,
             _f32(1.0 / t_edge), _f32(math.pi), _f32(-1e-12),
             _f32(taps.t_edge_s + 1e-12)))


def _check_shapes(name, c_ok, vals, win, taps=None):
    pc, grp, bg = c_ok.shape
    if win < 1:
        raise ValueError(f"{name}: win must be positive, got {win}")
    if taps is not None:
        if vals.dim() != 3 or vals.shape[:2] != (pc, taps.rows) \
                or -(-vals.shape[2] // grp) != bg:
            raise ValueError(
                f"{name}: formed taps need operands (pc, rows, B) = ({pc}, "
                f"{taps.rows}, B) with B / {grp} rounded up {bg}, got "
                f"{tuple(vals.shape)}")
        return pc, grp, bg, taps.n_sets, taps.k_taps
    if vals.dim() != 5 or vals.shape[:2] != (pc, grp) \
            or vals.shape[4] != bg or vals.shape[3] % 2:
        raise ValueError(
            f"{name}: values must be (pc, grp, S, 2K, bg) = ({pc}, {grp}, S,"
            f" 2K, {bg}), got {tuple(vals.shape)}")
    return pc, grp, bg, vals.shape[2], vals.shape[3] // 2


def spread_windows_plain(c_ok: torch.Tensor, vals: torch.Tensor, win: int,
                         qr: bool = False, taps=None) -> torch.Tensor:
    """Plain version of :func:`spread_windows_pallas`: a float32 one-hot
    of the cells (per tap with ``qr``) contracted with the values, then
    (without ``qr``) the roll chain over the taps, k = 0 first. With
    ``taps``, the values are :func:`tap_sets` of the operands ``vals``."""
    pc, grp, bg, n_sets, k_taps = _check_shapes("spread_windows_plain",
                                                c_ok, vals, win, taps)
    if taps is not None:
        vals = pack_values(tap_sets(vals, taps), grp)
    out = torch.empty((pc, grp, 2 * n_sets, win), dtype=torch.float32,
                      device=vals.device)
    iota = torch.arange(win, device=vals.device, dtype=torch.int32)
    step = max(1, _PLAIN_ELEMENTS // max(1, grp * bg * win))
    for p0 in range(0, pc, step):
        c = c_ok[p0:p0 + step]
        v = vals[p0:p0 + step].reshape(c.shape[0], grp, n_sets * 2 * k_taps,
                                       bg)
        if not qr:
            oh = (c[..., None] == iota).to(torch.float32)   # (., g, bg, win)
            part = torch.matmul(v, oh).reshape(c.shape[0], grp, n_sets,
                                               2 * k_taps, win)
            acc = part[:, :, :, 0::k_taps]                   # re, im of k=0
            for k in range(1, k_taps):
                acc = acc + torch.roll(part[:, :, :, k::k_taps], k, dims=-1)
        else:
            v = v.reshape(c.shape[0], grp, n_sets, 2 * k_taps, bg)
            acc = None
            for k in range(k_taps):
                ck = torch.where(c < 0, torch.full_like(c, -win), c + k)
                oh = (ck[..., None] == iota).to(torch.float32)
                term = torch.matmul(v[:, :, :, k::k_taps], oh[:, :, None])
                acc = term if acc is None else acc + term
        out[p0:p0 + step] = acc.reshape(c.shape[0], grp, 2 * n_sets, win)
    return out


def spread_windows_pallas(c_ok: torch.Tensor, vals: torch.Tensor, win: int,
                          qr: bool = False, taps=None) -> torch.Tensor:
    """The group windows (pc, grp, 2S, win) float32 of ``vals`` (pc, grp,
    S, 2K, bg) float32 at the window-relative tap-0 cells ``c_ok`` (pc, grp,
    bg) int32 (-1 drops a target). ``qr`` sums each window cell's taps and
    targets in one accumulator (the reference's digit-factorized
    ``_kernel_qr``); otherwise taps add in the roll-chain order. With
    ``taps`` (an :class:`EsTaps` or :class:`FlankTaps`, the roll order)
    ``vals`` holds the (pc, rows, B) float32 operands and the kernel forms
    the values, :func:`tap_sets`' bit for bit. Each launch adds one to
    ``spread_windows_pallas.launches_qr`` with ``qr``, to ``.launches_taps``
    and the stage record's ``echo.spread_taps`` with ``taps``, else to
    ``.launches``."""
    pc, grp, bg, n_sets, k_taps = _check_shapes("spread_windows_pallas",
                                                c_ok, vals, win, taps)
    if taps is not None and qr:
        raise ValueError("spread_windows_pallas: formed taps add in the roll"
                         " order (qr=False)")
    if _build.on_cpu(c_ok):
        return spread_windows_plain(c_ok, vals, win, qr, taps)
    if k_taps > K_MAX:
        raise ValueError(f"spread_windows_pallas: {k_taps} taps exceed the "
                         f"kernel's {K_MAX}")
    smem = smem_bytes(bg, win, n_sets, k_taps)
    if smem > SMEM_MAX:
        raise ValueError(
            f"spread_windows_pallas: {smem} bytes of shared memory for bg "
            f"{bg}, win {win}, {n_sets} value sets of {k_taps} taps exceed "
            f"{SMEM_MAX}: use more groups (freq_spread_grp) or a smaller "
            "window")
    dev = c_ok.device
    _build.check("spread_windows_pallas", (c_ok,), (pc, grp, bg), dev,
                 torch.int32)
    _build.check("spread_windows_pallas", (vals,),
                 vals.shape if taps is not None
                 else (pc, grp, n_sets, 2 * k_taps, bg), dev)
    out = torch.empty((pc, grp, 2 * n_sets, win), dtype=torch.float32,
                      device=dev)
    if taps is not None:
        ints, floats = _tap_args(taps, vals.shape[2])
        _build.launch("spread_taps_launch", (c_ok, vals, out),
                      (pc, grp, bg, win, n_sets, k_taps, *ints), floats)
        spread_windows_pallas.launches_taps += 1
        profiling.count("echo.spread_taps")
        return out
    _build.launch("spread_windows_launch", (c_ok, vals, out),
                  (pc * grp, bg, win, n_sets, k_taps, int(qr)))
    if qr:
        spread_windows_pallas.launches_qr += 1
    else:
        spread_windows_pallas.launches += 1
    return out


# launches in the roll order of given values, in the one-accumulator order,
# and in the roll order of formed taps
spread_windows_pallas.launches = 0
spread_windows_pallas.launches_qr = 0
spread_windows_pallas.launches_taps = 0


def _check_place(name, wins, base, offsets, start, l_out):
    if wins.dim() != 4 or wins.shape[2] != 2 * len(offsets) \
            or not offsets:
        raise ValueError(f"{name}: windows must be (pc, grp, 2S, win) for "
                         f"the {len(offsets)} offsets, got "
                         f"{tuple(wins.shape)}")
    pc, grp, _, win = wins.shape
    if tuple(base.shape) != (pc, grp):
        raise ValueError(f"{name}: bases must be ({pc}, {grp}), got "
                         f"{tuple(base.shape)}")
    if l_out < 1 or start < 0:
        raise ValueError(f"{name}: needs l_out >= 1 and start >= 0 (got "
                         f"{l_out}, {start})")
    return pc, grp, win


def place_windows_plain(wins: torch.Tensor, base: torch.Tensor, offsets,
                        start: int, l_out: int, complex_out: bool = False):
    """Plain version of :func:`place_windows`: a zeroed field padded to
    whole 128-sample rows, each set's windows rolled by the sub-row part
    of its offset, then group by group a gather, add and store of the
    group's rows (one group's rows are distinct, so the order of the sums
    is fixed), cropped to [start, start + l_out). Needs win, start and the
    bases in 128-multiples, the bases in [0, l_out + start]."""
    pc, grp, win = _check_place("place_windows_plain", wins, base, offsets,
                                start, l_out)
    dev = wins.device
    rows_tot = -(-(l_out + start + win + max(offsets) + 256) // 128)
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
        rowpos = (torch.div(base_eff, 128, rounding_mode="floor")[:, :, None]
                  + torch.arange(nwr, device=dev))            # (pc, grp, nwr)
        for g in range(grp):
            idx = (row0 + rowpos[:, g]).reshape(-1)
            fr[idx] = fr[idx] + out_r[:, g].reshape(-1, 128)
            fi[idx] = fi[idx] + out_i[:, g].reshape(-1, 128)
    fr = fr.reshape(pc, rows_tot * 128)[:, start:start + l_out]
    fi = fi.reshape(pc, rows_tot * 128)[:, start:start + l_out]
    return torch.complex(fr, fi) if complex_out else (fr, fi)


def place_windows(wins: torch.Tensor, base: torch.Tensor, offsets,
                  start: int, l_out: int, complex_out: bool = False):
    """The field of the group windows ``wins`` ((pc, grp, 2S, win)
    float32, :func:`spread_windows_pallas`'s) placed at their field cells:
    window (p, g) of set s covers field cells base[p, g] + offsets[s] + j,
    j in [0, win), and the field is cropped to cells [start, start +
    l_out). Each cell sums its windows' values set by set, group by group
    in order, from +0.0 (the row loop's order: the same bits). ``base``
    (pc, grp) int32. Returns the (re, im) planes, (pc, l_out) float32 views
    of rows a 128-multiple of floats apart (the conv reads them through
    their row stride), or with ``complex_out`` the (pc, l_out) complex64.

    CPU tensors run :func:`place_windows_plain`; CUDA tensors launch
    ``place_windows_kernel`` of ``csrc/spread_kernel.cu`` (bound by bytes:
    one read of every window cell in the cropped field, one write of every
    field cell) or raise. Each launch adds one to
    ``place_windows.launches`` and to the stage record's ``echo.place``."""
    pc, grp, win = _check_place("place_windows", wins, base, offsets, start,
                                l_out)
    if _build.on_cpu(wins):
        return place_windows_plain(wins, base, offsets, start, l_out,
                                   complex_out)
    if len(offsets) > PLACE_SETS or grp > PLACE_GROUPS or pc > 65_535:
        raise ValueError(
            f"place_windows: {len(offsets)} value sets, {grp} groups and "
            f"{pc} pulses; the kernel takes at most {PLACE_SETS}, "
            f"{PLACE_GROUPS} and 65,535")
    dev = wins.device
    _build.check("place_windows", (wins,), (pc, grp, 2 * len(offsets), win),
                 dev)
    _build.check("place_windows", (base,), (pc, grp), dev, torch.int32)
    offs = [int(o) for o in offsets] + [0] * (PLACE_SETS - len(offsets))
    if complex_out:
        out = torch.empty((pc, l_out), dtype=torch.complex64, device=dev)
        res = out
        out_r = out_i = torch.view_as_real(out)
        row_stride = 2 * l_out
    else:
        row_stride = -(-l_out // 128) * 128
        planes = torch.empty((2, pc, row_stride), dtype=torch.float32,
                             device=dev)
        out_r, out_i = planes[0], planes[1]
        res = (out_r[:, :l_out], out_i[:, :l_out])
    _build.launch("place_windows_launch", (wins, base, out_r, out_i),
                  (pc, grp, len(offsets), win, start, l_out, row_stride,
                   int(complex_out), *offs))
    place_windows.launches += 1
    profiling.count("echo.place")
    return res


place_windows.launches = 0
