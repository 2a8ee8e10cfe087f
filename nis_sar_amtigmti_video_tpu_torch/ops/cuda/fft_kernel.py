"""The fast-BP recentre kernels (forward spectra, recentre from spectra and
the fused recentre + presum) and the NUFFT echo's FFT convolution.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/pallas/fft_kernel.py``
(``supported``, ``forward_spectra_pallas``, ``recentre_from_spectra_pallas``,
``recenter_presum_pallas``, ``fft_conv_pallas``); in this package the
``*_pallas`` option names of ``ops/bp_fast.py`` and ``ops/echo_freq.py``
reach these hand-written CUDA kernels (``csrc/fft_kernel.cu``). Each
wrapper runs its plain PyTorch version (``*_plain``: torch.fft, and
``bp_fast``'s own ``presum_spectra`` / ``recenter_presum``) for CPU
tensors, and launches its kernel or raises for CUDA tensors. The kernels
run one thread-block cluster per pulse, row or presum group, holding its
spectrum in the cluster's shared memory and registers. On the card the two
recentre kernels form each pulse's scalars (the ramp's integer and
fractional shift, the wrapped carrier: :func:`kernel_scalars_plain`) from
the float64 trajectory themselves, where the reference forms them with jnp
beside its kernels. The TPU knobs ``mode``, ``groups``, ``impl``,
``unroll`` and ``interpret`` are not ported; ``filter_compress`` is.

Spectra layout: (P, nfft/128, 128) complex64, frequency f = k2 + B1*k1 at
[k2, k1] (B1 = nfft/128) — the TPU kernel's (k, [m|m]) digit order with
real and imaginary parts joined; :func:`spectra_from_reference_layout` and
:func:`spectra_to_reference_layout` convert. Recentred outputs are the band
rows [p0*128, p1*128) of ``out_rows`` (all nfft samples when None), with the
trajectory at each group's centre pulse min(g*d + d//2, P-1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from nis_sar_amtigmti_video_tpu_torch.ops import bp as bp_ops
from nis_sar_amtigmti_video_tpu_torch.ops import bp_fast
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build
from nis_sar_amtigmti_video_tpu_torch.ops.cuda.csa_kernel import twiddle_table

_LANE = 128
C64 = torch.complex64


def supported(nfft: int) -> bool:
    """nfft = 128 * B1 with B1 a power of two in [128, 512]."""
    b1 = nfft // _LANE
    return b1 * _LANE == nfft and 128 <= b1 <= 512 and (b1 & (b1 - 1)) == 0


def _nfft_of(ns: int) -> int:
    return 1 << (ns - 1).bit_length()


def _band(out_rows, b1):
    if out_rows is None:
        return 0, b1
    p0, p1 = out_rows
    if not (0 <= p0 < p1 <= b1):
        raise ValueError(f"out_rows {out_rows} outside [0, {b1}]")
    return p0, p1


def spectra_from_reference_layout(a: np.ndarray) -> torch.Tensor:
    """The JAX kernel's (P, B1, 256) float32 spectra (real part of f =
    m*B1 + k at [k, m], imaginary at [k, 128 + m]) -> the port's (P, B1,
    128) complex64 (CPU)."""
    a = np.asarray(a, np.float32)
    return torch.complex(torch.from_numpy(a[..., :_LANE].copy()),
                         torch.from_numpy(a[..., _LANE:].copy()))


def spectra_to_reference_layout(spec: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`spectra_from_reference_layout`."""
    s = spec.detach().cpu()
    return np.concatenate([s.real.numpy(), s.imag.numpy()], axis=-1)


def spectra_natural(spec: torch.Tensor) -> torch.Tensor:
    """(P, B1, 128) port layout -> (P, nfft) natural frequency order."""
    return spec.transpose(1, 2).reshape(spec.shape[0], -1)


def _to_layout(nat: torch.Tensor) -> torch.Tensor:
    b1 = nat.shape[-1] // _LANE
    return nat.reshape(nat.shape[0], _LANE, b1).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _tables(nfft: int, device: torch.device):
    """The twiddle tables, float64-built: nfft-point as two levels
    [exp(-2 pi i b / nfft), b < 256 | exp(-2 pi i 256 a / nfft), a <
    nfft / 256], then the B1- and 128-point tables."""
    lo = np.exp(-2j * np.pi * np.arange(256) / nfft)
    hi = np.exp(-2j * np.pi * 256 * np.arange(nfft // 256) / nfft)
    tw_n = torch.from_numpy(np.concatenate([lo, hi]).astype(np.complex64))
    return (tw_n.to(device), twiddle_table(nfft // _LANE, device),
            twiddle_table(_LANE, device))


@functools.lru_cache(maxsize=None)
def matched_filter(p: bp_ops.BpParams, nfft: int,
                   device: torch.device) -> torch.Tensor:
    """Conjugate reference-chirp spectrum (nfft,) complex64 in natural
    order on ``device``, built once per (p, nfft, device)."""
    return torch.from_numpy(bp_ops.reference_chirp_conj(p, nfft)).to(device)


@functools.lru_cache(maxsize=None)
def _filter_layout(p: bp_ops.BpParams, nfft: int, compress: bool,
                   device: torch.device) -> torch.Tensor:
    """Matched-filter spectrum (ones without compression) in the spectra
    layout (B1, 128), k1 in natural order: the table forward spectra and
    the fused recentre kernel read."""
    if not compress:
        return torch.ones((nfft // _LANE, _LANE), dtype=C64, device=device)
    return _to_layout(matched_filter(p, nfft, device)[None, :])[0]


def _traj_at(sat_pos, sat_vel, t_slow, num_p: int, d: int):
    """The float64 trajectory at each presum group's centre pulse."""
    dev = sat_pos.device if isinstance(sat_pos, torch.Tensor) else None
    ci = bp_fast.centre_pulses(num_p, d, dev)
    return tuple(bp_ops._f64(a, dev)[ci] for a in (sat_pos, sat_vel, t_slow))


def _output(name, out, shape, device) -> torch.Tensor:
    """Where a recentre kernel writes its (rows, band) complex64 result on
    ``device``: ``out``, checked, or a new tensor where ``out`` is None."""
    if out is None:
        return torch.empty(shape, dtype=C64, device=device)
    _build.check(name, (out,), shape, device, C64)
    return out


def _ring_offset(num_p: int, d: int, ring_offset) -> int:
    """``ring_offset`` as an int (0 for None), checked."""
    if ring_offset is None:
        return 0
    off = int(ring_offset)
    if num_p % d or off % d:
        raise ValueError(
            "ring_offset needs P % d == 0 and ring_offset % d == 0 (no "
            f"presum group may straddle the ring seam): P={num_p}, "
            f"d={d}, ring_offset={off}")
    return off


def _recentre_inputs(sat_pos, t_slow, vel_focus, p, t_ref, t_mean, num_p, d,
                     ring_offset):
    """Chronological float64 (shift, car), checked and rolled into ring
    order (roll(x, off)[j] = x[(j - off) % P]) when ``ring_offset`` is
    given."""
    off = _ring_offset(num_p, d, ring_offset)
    shift, car = bp_fast.recentre_scalars(sat_pos, t_slow, vel_focus, p,
                                          t_ref, t_mean)
    if ring_offset is not None:
        shift, car = torch.roll(shift, off), torch.roll(car, off)
    return shift, car


def kernel_scalars_plain(sat_pos, sat_vel, t_slow, vel_focus, p, d: int,
                         t_ref: float, nfft: int, t_mean=None,
                         ring_offset=None):
    """What the recentre kernels form for each pulse from the float64
    trajectory (``csrc/fft_kernel.cu::pulse_scalars``), in plain PyTorch:
    si = round(shift) mod nfft (int32), sf = shift - round(shift) and the
    carrier wrapped mod 2 pi (float32), in ring order (slot j holds pulse
    (j - ring_offset) mod P) when ``ring_offset`` is given; then the float64
    trajectory at each presum group's centre pulse (pos2, vel2, t2)."""
    num_p = len(t_slow)
    shift, car = _recentre_inputs(sat_pos, t_slow, vel_focus, p, t_ref,
                                  t_mean, num_p, d, ring_offset)
    si = torch.round(shift)
    sf = (shift - si).to(torch.float32)
    si = torch.remainder(si, nfft).to(torch.int32)
    car = bp_ops._wrap(car).to(torch.float32)
    return (si, sf, car, *_traj_at(sat_pos, sat_vel, t_slow, num_p, d))


def _kernel_trajectory(name, sat_pos, t_slow, vel_focus, p, t_ref, t_mean,
                       device):
    """The recentre launchers' trajectory operands on ``device``: float64
    pos (P, 3), ts (P), vf (3) and t_mean (1) (the mean of ts when None),
    checked; and the doubles (c, t_ref, fs, 2 pi 2 fc / c)."""
    pos, ts, vf = (bp_ops._f64(a, device).contiguous()
                   for a in (sat_pos, t_slow, vel_focus))
    num_p = ts.shape[0]
    t_m = (ts.mean() if t_mean is None
           else bp_ops._f64(t_mean, device)).reshape(1)
    f64 = torch.float64
    _build.check(name, (pos,), (num_p, 3), device, f64)
    _build.check(name, (ts,), (num_p,), device, f64)
    _build.check(name, (vf,), (3,), device, f64)
    return ((pos, ts, vf, t_m),
            (bp_fast._C, t_ref, p.fs_hz,
             bp_fast._TWO_PI * (2.0 * p.fc_hz / bp_fast._C)))


# --------------------------------------------------------------------------
# forward spectra
# --------------------------------------------------------------------------

def forward_spectra_plain(rc: torch.Tensor, p: bp_ops.BpParams,
                          filter_compress: bool = True) -> torch.Tensor:
    """Plain version of :func:`forward_spectra`."""
    nfft = _nfft_of(rc.shape[1])
    spec = torch.fft.fft(rc, n=nfft, dim=-1)
    if filter_compress:
        spec = spec * matched_filter(p, nfft, rc.device)
    return _to_layout(spec.to(C64))


def forward_spectra(rc: torch.Tensor, p: bp_ops.BpParams,
                    filter_compress: bool = True) -> torch.Tensor:
    """Per raw pulse (P, ns) complex64: the nfft-point DFT of the zero-
    padded pulse times the conjugate reference-chirp spectrum (with
    ``filter_compress``), as (P, nfft/128, 128) complex64 spectra. One
    thread-block cluster per pulse, so a pulse's spectrum depends on that
    pulse alone: ``forward_spectra(rc[a:b])`` is ``forward_spectra(rc)[a:b]``
    bit for bit."""
    num_p, ns = rc.shape
    nfft = _nfft_of(ns)
    if not supported(nfft):
        raise ValueError(f"forward_spectra: nfft={nfft} unsupported")
    if _build.on_cpu(rc):
        return forward_spectra_plain(rc, p, filter_compress)
    dev = rc.device
    _build.check("forward_spectra", (rc,), (num_p, ns), dev, C64)
    out = torch.empty((num_p, nfft // _LANE, _LANE), dtype=C64, device=dev)
    _build.launch("forward_spectra_launch",
                  (rc, _filter_layout(p, nfft, filter_compress, dev),
                   *_tables(nfft, dev), out),
                  (num_p, ns, nfft))
    forward_spectra.launches += 1
    return out


forward_spectra.launches = 0


# --------------------------------------------------------------------------
# recentre from spectra
# --------------------------------------------------------------------------

def recentre_from_spectra_plain(spec, sat_pos, sat_vel, t_slow, vel_focus,
                                p, d: int, t_ref: float, t_mean=None,
                                out_rows=None, ring_offset=None, out=None):
    """Plain version of :func:`recentre_from_spectra`."""
    num_p, b1 = spec.shape[0], spec.shape[1]
    p0, p1 = _band(out_rows, b1)
    shift, car = _recentre_inputs(sat_pos, t_slow, vel_focus, p, t_ref,
                                  t_mean, num_p, d, ring_offset)
    rc_b = bp_fast.presum_spectra(spectra_natural(spec), shift, car,
                                  d)[:, p0 * _LANE:p1 * _LANE]
    if ring_offset is not None:
        rc_b = torch.roll(rc_b, -(int(ring_offset) // d), dims=0)
    return (rc_b if out is None else out.copy_(rc_b),
            *_traj_at(sat_pos, sat_vel, t_slow, num_p, d))


def recentre_from_spectra(spec, sat_pos, sat_vel, t_slow, vel_focus, p,
                          d: int, t_ref: float, t_mean=None, out_rows=None,
                          ring_offset=None, out=None):
    """Recentre ramp + carrier + frequency-domain presum by ``d`` + band-
    limited inverse on cached spectra (P, nfft/128, 128) complex64 from
    :func:`forward_spectra`. The trajectory (float64, chronological) gives
    each pulse's shift and carrier. Returns (rc2 (ceil(P/d), (p1-p0)*128)
    complex64, pos2, vel2, t2).

    ``ring_offset`` (pulses): the buffer is a ring — slot j holds
    chronological pulse (j - ring_offset) % P. The per-pulse scalars roll
    into ring order and the kernel stores each presummed row at its
    chronological place; needs P % d == 0 and
    ring_offset % d == 0, so every group holds the same pulses in the same
    order and the result equals the chronological call bit for bit.

    ``out``: a (ceil(P/d), (p1-p0)*128) complex64 tensor to write rc2 into
    (and return) in place of a new one."""
    num_p, b1 = spec.shape[0], spec.shape[1]
    nfft = b1 * _LANE
    if not supported(nfft):
        raise ValueError(f"recentre_from_spectra: nfft={nfft} unsupported")
    if _build.on_cpu(spec):
        return recentre_from_spectra_plain(
            spec, sat_pos, sat_vel, t_slow, vel_focus, p, d, t_ref,
            t_mean=t_mean, out_rows=out_rows, ring_offset=ring_offset,
            out=out)
    dev = spec.device
    _build.check("recentre_from_spectra", (spec,), (num_p, b1, _LANE), dev,
                 C64)
    p0, p1 = _band(out_rows, b1)
    off = _ring_offset(num_p, d, ring_offset)
    tr, doubles = _kernel_trajectory("recentre_from_spectra", sat_pos, t_slow,
                                     vel_focus, p, t_ref, t_mean, dev)
    out = _output("recentre_from_spectra", out,
                  (-(-num_p // d), (p1 - p0) * _LANE), dev)
    _build.launch("recentre_spectra_launch",
                  (spec, *tr, *_tables(nfft, dev), out),
                  (num_p, d, nfft, p0, p1, off % num_p), doubles=doubles)
    recentre_from_spectra.launches += 1
    return (out, *_traj_at(sat_pos, sat_vel, t_slow, num_p, d))


recentre_from_spectra.launches = 0


# --------------------------------------------------------------------------
# fused recentre + presum
# --------------------------------------------------------------------------

def recenter_presum_plain(rc, sat_pos, sat_vel, t_slow, vel_focus, p,
                          d: int, t_ref: float, filter_compress: bool = True,
                          t_mean=None, out_rows=None, out=None):
    """Plain version of :func:`recenter_presum`: ``bp_fast.recenter_presum``
    with the cached matched filter, cut to the band rows."""
    nfft = _nfft_of(rc.shape[1])
    p0, p1 = _band(out_rows, nfft // _LANE)
    ref = matched_filter(p, nfft, rc.device) if filter_compress else None
    rc_b, *traj = bp_fast.recenter_presum(rc, sat_pos, sat_vel, t_slow,
                                          vel_focus, p, d, t_ref,
                                          ref_conj=ref, t_mean=t_mean)
    rc_b = rc_b[:, p0 * _LANE:p1 * _LANE]
    return (rc_b if out is None else out.copy_(rc_b), *traj)


def recenter_presum(rc, sat_pos, sat_vel, t_slow, vel_focus, p, d: int,
                    t_ref: float, filter_compress: bool = True, t_mean=None,
                    out_rows=None, out=None):
    """Raw pulses (P, ns) complex64 -> forward DFT x matched filter x
    recentre ramp and carrier -> presum by ``d`` in the frequency domain ->
    band-limited inverse, in one kernel: a group's spectra stay on the
    thread-block cluster that serves it, so device memory sees only the
    raw pulses and the band rows. A group's rows depend on its own pulses
    alone: ``recenter_presum(rc[a:b])`` with a and b multiples of ``d``
    (and the same ``t_mean``) is rows [a/d, b/d) of ``recenter_presum(rc)``
    bit for bit. Same return and ``out`` as
    :func:`recentre_from_spectra`."""
    num_p, ns = rc.shape
    nfft = _nfft_of(ns)
    if not supported(nfft):
        raise ValueError(f"recenter_presum: nfft={nfft} unsupported")
    if _build.on_cpu(rc):
        return recenter_presum_plain(rc, sat_pos, sat_vel, t_slow, vel_focus,
                                     p, d, t_ref, filter_compress,
                                     t_mean=t_mean, out_rows=out_rows,
                                     out=out)
    dev = rc.device
    _build.check("recenter_presum", (rc,), (num_p, ns), dev, C64)
    p0, p1 = _band(out_rows, nfft // _LANE)
    tr, doubles = _kernel_trajectory("recenter_presum", sat_pos, t_slow,
                                     vel_focus, p, t_ref, t_mean, dev)
    out = _output("recenter_presum", out,
                  (-(-num_p // d), (p1 - p0) * _LANE), dev)
    _build.launch("recenter_presum_launch",
                  (rc, _filter_layout(p, nfft, filter_compress, dev), *tr,
                   *_tables(nfft, dev), out),
                  (num_p, ns, d, nfft, p0, p1), doubles=doubles)
    recenter_presum.launches += 1
    return (out, *_traj_at(sat_pos, sat_vel, t_slow, num_p, d))


recenter_presum.launches = 0


# --------------------------------------------------------------------------
# FFT convolution (the NUFFT echo)
# --------------------------------------------------------------------------

def fft_conv_plain(fr: torch.Tensor, fi: torch.Tensor, filt: torch.Tensor,
                   nfft: int, out_rows=None) -> torch.Tensor:
    """Plain version of :func:`fft_conv_pallas`: torch.fft's transform, the
    filter, the inverse, cut to the band rows."""
    p0, p1 = _band(out_rows, nfft // _LANE)
    spec = torch.fft.fft(torch.complex(fr, fi), n=nfft, dim=-1) * filt
    return torch.fft.ifft(spec, dim=-1)[:, p0 * _LANE:p1 * _LANE]


# filter spectrum -> (its version, the kernel's table), held while the
# filter lives
_CONV_FILTERS = WeakIdKeyDictionary()


def conv_filter(filt: torch.Tensor) -> torch.Tensor:
    """The conv kernel's filter table: ``filt`` ((nfft,) complex64, natural
    order) in the spectra layout (B1, 128), k1 natural, as the kernel's rows
    leave the spectrum. Built once per filter tensor (and again if it is
    changed in place), not per call."""
    hit = _CONV_FILTERS.get(filt)
    if hit is None or hit[0] != filt._version:
        hit = (filt._version, _to_layout(filt[None])[0])
        _CONV_FILTERS[filt] = hit
    return hit[1]


def _check_rows(name: str, tensors, shape, device) -> None:
    """Each tensor float32, of ``shape`` (P, L), on ``device``, its rows
    contiguous each at a row stride below 2^31 elements (a view of columns
    of a wider array will do)."""
    for i, t in enumerate(tensors):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: argument {i} is {t.dtype}, needs "
                            "torch.float32")
        if t.device != device or tuple(t.shape) != shape:
            raise ValueError(f"{name}: argument {i} is {tuple(t.shape)} on "
                             f"{t.device}, needs {shape} on {device}")
        if (shape[1] > 1 and t.stride(1) != 1) \
                or not 0 <= t.stride(0) < 2 ** 31:
            raise ValueError(f"{name}: argument {i}'s rows are not "
                             f"contiguous (strides {t.stride()})")


def fft_conv_pallas(fr: torch.Tensor, fi: torch.Tensor, filt, nfft: int,
                    out_rows=None) -> torch.Tensor:
    """Row-wise linear FFT convolution ifft(fft(field, nfft) * filt)[:,
    p0*128 : p1*128] of the field rows fr + j fi ((P, L) float32, L <=
    nfft) with the spectrum ``filt`` ((nfft,) complex, natural order): one
    thread-block cluster per row holds its spectrum, so device memory sees
    the field rows in and the band rows out. The rows may be views with any
    row stride (each row contiguous), as the padded field's columns are.
    Returns (P, (p1 - p0) * 128) complex64 (the reference returns its real
    and imaginary planes)."""
    if not supported(nfft):
        raise ValueError(f"fft_conv_pallas: nfft={nfft} unsupported")
    num_p, l_in = fr.shape
    if l_in > nfft:
        raise ValueError(f"field length {l_in} exceeds nfft={nfft}")
    p0, p1 = _band(out_rows, nfft // _LANE)
    filt = torch.as_tensor(filt).to(device=fr.device, dtype=C64)
    if _build.on_cpu(fr):
        return fft_conv_plain(fr, fi, filt, nfft, out_rows)
    dev = fr.device
    _check_rows("fft_conv_pallas", (fr, fi), (num_p, l_in), dev)
    _build.check("fft_conv_pallas", (filt,), (nfft,), dev, C64)
    out = torch.empty((num_p, (p1 - p0) * _LANE), dtype=C64, device=dev)
    if num_p == 0:
        return out
    _build.launch("fft_conv_launch",
                  (fr, fi, conv_filter(filt), *_tables(nfft, dev), out),
                  (num_p, l_in, fr.stride(0), fi.stride(0), nfft, p0, p1))
    fft_conv_pallas.launches += 1
    return out


fft_conv_pallas.launches = 0
