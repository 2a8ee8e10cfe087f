"""The GMTI CPI's azimuth passes and epilogue: K1g, K3g, K4 and the raw
balance reduction.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/pallas/gmti_kernel.py``
(``k1_gmti_planes``, ``k3_gmti_planes``, ``k4_epilogue_planes``,
``raw_balance_pallas``). The CUDA source is ``csrc/gmti_kernel.cu``.
Beside each wrapper is its plain PyTorch version (``*_plain``, same
signature and return tuple), which the wrapper runs for CPU tensors; for
CUDA tensors it launches the kernel or raises.

Why the balance phase can come from the raw pair: K1 = Phi1 . W_az and the
range pass K2 are unitary up to a positive scale and K3 is W_az^H / N_az,
so sum(s1 conj s2) over the image is a positive multiple of the same sum
over the raw phase histories, and angle() ignores the scale. K1g therefore
returns the raw sums and the caller takes atan2 before K3g; the split CPI
(single-channel K1 and K2) takes them from :func:`raw_balance`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nis_sar_amtigmti_video_tpu_torch.gmti.cfar import _count_1d, _window_sum
from nis_sar_amtigmti_video_tpu_torch.ops.csa import CsaFactors, expj
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build
from nis_sar_amtigmti_video_tpu_torch.ops.cuda.csa_kernel import (
    AzimuthPlan, azimuth_plan, column_plan, plane_shape)


# --------------------------------------------------------------------------
# K1g: azimuth FFT + Phi1 for both channels, raw balance partial sums
# --------------------------------------------------------------------------

def k1_gmti_plain(x1r, x1i, x2r, x2i, f: CsaFactors, *, balance=True,
                  plan=None):
    """Plain version of :func:`k1_gmti_planes`."""
    du = f.u[None, :] - f.w[:, None]
    phi1 = expj(f.c1[:, None] * du * du)
    out = []
    for xr, xi in ((x1r, x1i), (x2r, x2i)):
        z = torch.fft.fft(torch.complex(xr, xi), dim=0) * phi1
        out += [z.real.contiguous(), z.imag.contiguous()]
    if balance:
        xs_re, xs_im = raw_balance_plain(x1r, x1i, x2r, x2i)
    else:
        xs_re = xs_im = torch.zeros((), dtype=torch.float32,
                                    device=x1r.device)
    return (*out, xs_re, xs_im)


def k1_gmti_planes(x1r, x1i, x2r, x2i, f: CsaFactors, *, balance=True,
                   plan=None):
    """Two-channel K1 + raw balance sums in one pass: the forward column
    pass on tiles of adjacent columns (``column_plan(..., 2,
    forward=True)``).

    Returns (z1r, z1i, z2r, z2i, xs_re, xs_im): the azimuth FFT of each
    channel times Phi1 = exp(j c1 (u - w)^2), and re/im of
    sum(x1 conj x2) over the raw pair (zeros when balance=False) as 0-d
    tensors. The kernel writes each column's sum, from the two spectra by
    Parseval (sum_k X1 conj X2 / n_az) and reduced in a fixed order, so two
    launches give the same bits; the columns are summed here. By chirp-z
    where ``plan`` takes it (the sums from the forward spectra, / m), or
    as a prime-factor transform (from the gathered spectra, / n_az).
    ``plan``: the ``azimuth_plan`` of n_az (built when None)."""
    if _build.on_cpu(x1r):
        return k1_gmti_plain(x1r, x1i, x2r, x2i, f, balance=balance)
    n_az, n_rg = plane_shape("k1_gmti_planes", x1r)
    dev = x1r.device
    _build.check("k1_gmti_planes", (x1r, x1i, x2r, x2i), (n_az, n_rg), dev)
    _build.check("k1_gmti_planes", (f.u,), (n_rg,), dev)
    _build.check("k1_gmti_planes", (f.c1, f.w), (n_az,), dev)
    if plan is None:
        plan = azimuth_plan(n_az, dev)
    AzimuthPlan.check(plan, "k1_gmti_planes", n_az, dev)
    out = [torch.empty_like(x1r) for _ in range(4)]
    bal = torch.empty((2, n_rg), dtype=torch.float32, device=dev)
    _build.launch("k1g_launch",
                  (x1r, x1i, x2r, x2i, f.u, f.c1, f.w,
                   *plan.tables(inverse=False), *out, bal),
                  (n_az, plan.m, *plan.legs, n_rg, int(balance),
                   *column_plan(n_az, n_rg, 2, forward=True)))
    k1_gmti_planes.launches += plan.launches
    # per-column sums -> two scalars
    xs = torch.sum(bal, dim=1)
    return (*out, xs[0], xs[1])


k1_gmti_planes.launches = 0


# --------------------------------------------------------------------------
# Raw balance: sum(x1 conj x2) over the raw pair in one pass
# --------------------------------------------------------------------------

def raw_balance_plain(x1r, x1i, x2r, x2i):
    """Plain version of :func:`raw_balance`."""
    return (torch.sum(x1r * x2r + x1i * x2i),
            torch.sum(x1i * x2r - x1r * x2i))


def balance_grid(n_az: int, n_rg: int, loads_per_block: int,
                 max_blocks: int) -> int:
    """Blocks of the balance kernel over (n_az, n_rg) planes: enough for one
    full round of ``loads_per_block`` float4 loads a block, at most
    ``max_blocks`` (:func:`balance_limits`). A function of the shape alone
    on a given card, so the summation order, and the bits, never change."""
    n4 = n_az * n_rg // 4
    return max(1, min(max_blocks, -(-n4 // loads_per_block)))


@functools.lru_cache(maxsize=None)
def balance_limits(dev: torch.device) -> tuple[int, int]:
    """(float4 loads of a plane a block makes in one round, blocks the card
    holds at once) for the balance kernel on ``dev``: its constants from the
    library times the card's SM count."""
    lib = _build.library()
    per_block, per_sm = lib.balance_loads_per_block, lib.balance_blocks_per_sm
    for fn in (per_block, per_sm):
        fn.argtypes, fn.restype = [], ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return per_block(), per_sm() * sms


# (device, stream handle) -> the balance kernel's workspace there: its
# ticket (one zero uint32, which every launch leaves zero) and then room for
# the partials of the most blocks; launches on one stream run in turn, so
# they share it
_WORKSPACES: dict = {}


def _workspace(dev: torch.device, stream: int) -> torch.Tensor:
    work = _WORKSPACES.get((dev, stream))
    if work is None:
        work = torch.zeros(1 + 2 * balance_limits(dev)[1],
                           dtype=torch.float32, device=dev)
        _WORKSPACES[(dev, stream)] = work
    return work


def raw_balance(x1r, x1i, x2r, x2i):
    """(xs_re, xs_im): re and im of sum(x1 conj x2) over the raw pair, as
    0-d float32 tensors; the caller takes atan2. One launch over the four
    (n_az, n_rg) planes (16-byte aligned; the last n_az n_rg mod 4 floats
    added by the last block): per-block
    partials on :func:`balance_grid`'s blocks, summed in block order by the
    last block to finish (no float atomics), so a launch gives the same bits
    every time."""
    if _build.on_cpu(x1r):
        return raw_balance_plain(x1r, x1i, x2r, x2i)
    if x1r.dim() != 2:
        raise ValueError("raw_balance: needs (n_az, n_rg) planes, got shape "
                         f"{tuple(x1r.shape)}")
    n_az, n_rg = x1r.shape
    dev = x1r.device
    _build.check("raw_balance", (x1r, x1i, x2r, x2i), (n_az, n_rg), dev)
    if any(t.data_ptr() % 16 for t in (x1r, x1i, x2r, x2i)):
        raise ValueError("raw_balance: planes must start on 16-byte "
                         "boundaries (the kernel reads float4)")
    stream = _build.stream_handle(dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    _build.launch("balance_launch",
                  (x1r, x1i, x2r, x2i, _workspace(dev, stream), out),
                  (n_az, n_rg, balance_grid(n_az, n_rg,
                                            *balance_limits(dev))))
    raw_balance.launches += 1
    return out.unbind()


raw_balance.launches = 0


# --------------------------------------------------------------------------
# K3g: azimuth IFFT of both channels + every product plane
# --------------------------------------------------------------------------

def k3_gmti_plain(x1r, x1i, x2r, x2i, cal_cos_sin, *, h_out: int, h_in: int,
                  plan=None):
    """Plain version of :func:`k3_gmti_planes`."""
    s1 = torch.fft.ifft(torch.complex(x1r, x1i), dim=0)
    s2 = torch.fft.ifft(torch.complex(x2r, x2i), dim=0)
    s1r, s1i = s1.real.contiguous(), s1.imag.contiguous()
    s2r, s2i = s2.real.contiguous(), s2.imag.contiguous()
    cr, ci = cal_cos_sin[0], cal_cos_sin[1]
    pr = s1r * s2r + s1i * s2i                 # s1 conj(s2) e^{-j cal}
    pi = s1i * s2r - s1r * s2i
    phase = torch.atan2(pi * cr - pr * ci, pr * cr + pi * ci)
    mag = s1r * s1r + s1i * s1i
    dr_ = s1r - (s2r * cr - s2i * ci)          # s1 - s2 e^{j cal}
    di_ = s1i - (s2r * ci + s2i * cr)
    power = dr_ * dr_ + di_ * di_
    return (s1r, s1i, s2r, s2i, phase, mag, power,
            _window_sum(power, h_out, 0), _window_sum(power, h_in, 0),
            torch.amax(mag, dim=0))


def k3_gmti_planes(x1r, x1i, x2r, x2i, cal_cos_sin, *, h_out: int,
                   h_in: int, plan=None):
    """Inverse azimuth FFT (1/N) of both channels' K2 outputs with the GMTI
    products written from the same pass.

    ``cal_cos_sin``: (2,) float32 tensor (cos, sin) of the balance phase.
    Returns (s1r, s1i, s2r, s2i, phase_unmasked, mag1_sq, power,
    colsum_outer, colsum_inner, peaks): the colsums are the azimuth halves
    of the CFAR box sums of ``power`` (half-widths h_out, h_in); ``peaks``
    is the (n_rg,) max |s1|^2 of each range column. By chirp-z or as a
    prime-factor transform where ``plan`` takes it. ``plan``: the
    ``azimuth_plan`` of n_az (built when None)."""
    if _build.on_cpu(x1r):
        return k3_gmti_plain(x1r, x1i, x2r, x2i, cal_cos_sin, h_out=h_out,
                             h_in=h_in)
    n_az, n_rg = plane_shape("k3_gmti_planes", x1r)
    dev = x1r.device
    _build.check("k3_gmti_planes", (x1r, x1i, x2r, x2i), (n_az, n_rg), dev)
    _build.check("k3_gmti_planes", (cal_cos_sin,), (2,), dev)
    if plan is None:
        plan = azimuth_plan(n_az, dev)
    AzimuthPlan.check(plan, "k3_gmti_planes", n_az, dev)
    out = [torch.empty_like(x1r) for _ in range(9)]
    peaks = torch.empty((n_rg,), dtype=torch.float32, device=dev)
    _build.launch("k3g_launch",
                  (x1r, x1i, x2r, x2i, cal_cos_sin, *plan.tables(inverse=True),
                   *out, peaks),
                  (n_az, plan.m, *plan.legs, n_rg, h_out, h_in,
                   *column_plan(n_az, n_rg, 2)))
    k3_gmti_planes.launches += plan.launches
    return (*out, peaks)


k3_gmti_planes.launches = 0


# --------------------------------------------------------------------------
# K4: range box sums, counts, noise / SNR, phase mask, dmag
# --------------------------------------------------------------------------

def cfar_counts(n_az: int, n_rg: int, h_out: int, h_in: int, device=None):
    """(ch_o, ch_i, cw_o, cw_i): the 1-D factors of the exact outer / inner
    training-window counts (gmti/cfar.py::_count_1d)."""
    return (_count_1d(n_az, h_out, device), _count_1d(n_az, h_in, device),
            _count_1d(n_rg, h_out, device), _count_1d(n_rg, h_in, device))


def k4_epilogue_plain(cso, csi, power, ph_raw, mag, thr_scalar, *,
                      h_out: int, h_in: int, counts=None):
    """Plain version of :func:`k4_epilogue_planes`."""
    n_az, n_rg = cso.shape
    ch_o, ch_i, cw_o, cw_i = counts if counts is not None else \
        cfar_counts(n_az, n_rg, h_out, h_in, cso.device)
    outer = _window_sum(cso, h_out, 1)
    inner = _window_sum(csi, h_in, 1)
    n_train = torch.clamp(ch_o[:, None] * cw_o[None, :]
                          - ch_i[:, None] * cw_i[None, :], min=1.0)
    noise = (outer - inner) / n_train
    snr = power / torch.clamp(noise, min=1e-30)
    thr = torch.as_tensor(thr_scalar, dtype=torch.float32,
                          device=cso.device)
    phase = torch.where(mag > thr, ph_raw, torch.zeros_like(ph_raw))
    return snr, phase, torch.sqrt(power), noise


def k4_epilogue_planes(cso, csi, power, ph_raw, mag, thr_scalar, *,
                       h_out: int, h_in: int, counts=None):
    """(snr, phase_masked, dmag, noise) from K3g's planes in one pass over
    whole range rows.

    The range halves of the box sums close here (K3g applied the azimuth
    halves); training counts are the exact rank-1 form (``counts`` from
    :func:`cfar_counts`, built when None). ``thr_scalar`` =
    mask_threshold^2 * peak2, a float or 0-d tensor."""
    if _build.on_cpu(cso):
        return k4_epilogue_plain(cso, csi, power, ph_raw, mag, thr_scalar,
                                 h_out=h_out, h_in=h_in, counts=counts)
    n_az, n_rg = plane_shape("k4_epilogue_planes", cso)
    dev = cso.device
    _build.check("k4_epilogue_planes", (cso, csi, power, ph_raw, mag),
                 (n_az, n_rg), dev)
    ch_o, ch_i, cw_o, cw_i = counts if counts is not None else \
        cfar_counts(n_az, n_rg, h_out, h_in, dev)
    _build.check("k4_epilogue_planes", (ch_o, ch_i), (n_az,), dev)
    _build.check("k4_epilogue_planes", (cw_o, cw_i), (n_rg,), dev)
    thr = torch.as_tensor(thr_scalar, dtype=torch.float32,
                          device=dev).reshape(1).contiguous()
    out = [torch.empty_like(cso) for _ in range(4)]
    _build.launch("k4_launch", (cso, csi, power, ph_raw, mag, thr, ch_o,
                                ch_i, cw_o, cw_i, *out),
                  (n_az, n_rg, h_out, h_in))
    k4_epilogue_planes.launches += 1
    return tuple(out)


k4_epilogue_planes.launches = 0
