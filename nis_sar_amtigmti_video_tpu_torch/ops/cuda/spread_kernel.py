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

:func:`place_windows` adds the windows into the field at their bases (set
s at its integer cell offset), in one launch of a kernel that replaces no
Pallas kernel: the reference places them with jnp, a gather, add and store
of each group's rows, and :func:`place_windows_plain` is that loop.
"""

from __future__ import annotations

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


def _check_shapes(name, c_ok, vals, win):
    pc, grp, bg = c_ok.shape
    if vals.dim() != 5 or vals.shape[:2] != (pc, grp) \
            or vals.shape[4] != bg or vals.shape[3] % 2:
        raise ValueError(
            f"{name}: values must be (pc, grp, S, 2K, bg) = ({pc}, {grp}, S,"
            f" 2K, {bg}), got {tuple(vals.shape)}")
    if win < 1:
        raise ValueError(f"{name}: win must be positive, got {win}")
    return pc, grp, bg, vals.shape[2], vals.shape[3] // 2


def spread_windows_plain(c_ok: torch.Tensor, vals: torch.Tensor, win: int,
                         qr: bool = False) -> torch.Tensor:
    """Plain version of :func:`spread_windows_pallas`: a float32 one-hot
    of the cells (per tap with ``qr``) contracted with the values, then
    (without ``qr``) the roll chain over the taps, k = 0 first."""
    pc, grp, bg, n_sets, k_taps = _check_shapes("spread_windows_plain",
                                                c_ok, vals, win)
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
                          qr: bool = False) -> torch.Tensor:
    """The group windows (pc, grp, 2S, win) float32 of ``vals`` (pc, grp,
    S, 2K, bg) float32 at the window-relative tap-0 cells ``c_ok`` (pc, grp,
    bg) int32 (-1 drops a target). ``qr`` sums each window cell's taps and
    targets in one accumulator (the reference's digit-factorized
    ``_kernel_qr``); otherwise taps add in the roll-chain order. Each
    launch adds one to ``spread_windows_pallas.launches_qr`` with ``qr``,
    else to ``spread_windows_pallas.launches``."""
    pc, grp, bg, n_sets, k_taps = _check_shapes("spread_windows_pallas",
                                                c_ok, vals, win)
    if _build.on_cpu(c_ok):
        return spread_windows_plain(c_ok, vals, win, qr)
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
                 (pc, grp, n_sets, 2 * k_taps, bg), dev)
    out = torch.empty((pc, grp, 2 * n_sets, win), dtype=torch.float32,
                      device=dev)
    _build.launch("spread_windows_launch", (c_ok, vals, out),
                  (pc * grp, bg, win, n_sets, k_taps, int(qr)))
    if qr:
        spread_windows_pallas.launches_qr += 1
    else:
        spread_windows_pallas.launches += 1
    return out


# launches in the roll order and in the one-accumulator order
spread_windows_pallas.launches = 0
spread_windows_pallas.launches_qr = 0


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
