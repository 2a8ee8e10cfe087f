"""Gather-free fast backprojection.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/bp_fast.py``:

1. **Recentre + presum**: every pulse is resampled so the scene origin sits
   at a fixed sample bin, then slow time is coherently decimated by D. The
   matched filter rides the same FFT round trip (``compress=True``).
2. **Iso-range internal grid**: rows advance the range index by an exact
   integer ``stride`` of samples, so row windows are strided views.
3. **Separable evaluation**: the tapered window is interpolated in its
   w-point Fourier basis; a per-pulse (ny x w) @ (w x nx) complex product.
4. **Phase** per pixel from a per-(t,y) quadratic-in-x fit of the exact
   float64 phase (anchored in slow time at ``fit_stride``).
5. An affine output resample by two chirp-Z passes (ops/czt.py).

The plan (:func:`make_plan`) is host numpy in float64, equal field by field
to the reference's. The complex contractions run on ``torch.matmul`` in
full float32. The accumulates of ``KERNEL_ACCUMULATE`` and
``raw_spectra=`` recentre in the hand-written CUDA kernels of
``ops/cuda/fft_kernel.py``; ``accumulate='pallas'`` then accumulates in
``ops/cuda/bp_kernel.py`` and ``'factor_kernel'`` in
``ops/cuda/bp_factor_kernel.py`` (the ``pallas`` names mean "the
hand-written CUDA kernel" in this package). On CPU tensors those wrappers
run their plain versions. The ``*_interpret`` names raise: the port has no
kernel interpreter.
"""

from __future__ import annotations

import collections
import math
import warnings
from dataclasses import dataclass, replace as _dc_replace
from functools import lru_cache, partial

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.ops import bp as bp_ops
from nis_sar_amtigmti_video_tpu_torch.ops.bp import BpParams, expj
from nis_sar_amtigmti_video_tpu_torch.ops.czt import czt_eval
from nis_sar_amtigmti_video_tpu_torch.utils.anchors import (anchor_plan as
                                                            _anchor_plan)
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import count, span

_TWO_PI = 2.0 * math.pi
_C = 299792458.0
F32, F64 = torch.float32, torch.float64

# accumulate names; those that run the recentre kernel, each with the plain
# accumulate that takes other nffts; the reference's interpret-mode names
ACCUMULATE = ("xla", "factor", "factor2", "factor_pallas", "factor2_pallas",
              "pallas", "factor_kernel")
KERNEL_ACCUMULATE = {"pallas": "xla", "factor_kernel": "factor",
                     "factor_pallas": "factor", "factor2_pallas": "factor2"}
INTERPRET = ("pallas_interpret", "factor_kernel_interpret")


# --------------------------------------------------------------------------
# plan (host-side, static): internal grid + band geometry
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FastBpPlan:
    """Static geometry of the internal iso-range grid (hashable). One plan
    serves every CPI of a collect; per-frame directions are computed from
    the centre pulse by :func:`_frame_geometry`."""
    ny_i: int              # internal rows (iso-range lines)
    nx_i: int              # internal columns (along iso-range)
    w_win: int             # per-row window length (samples)
    stride: int            # integer samples of range walk per internal row
    band_start: int        # first recentred sample used by row 0's window
    nfft: int              # recentred fast-time length (power of two)
    dx_m: float            # internal column pitch (= output pitch)
    t_ref: float           # fixed recentre delay (s): origin bin position
    n_org: float           # (t_ref - t_start) * fs, the origin's sample index
    taper_pow: int = 4     # cos^p window taper power
    sub_raw: int = 0       # factorized: raw pulses per sub-aperture
    nx_c: int = 0          # factorized: coarse column count
    sub_raw1: int = 0      # two-level: level-1 sub-aperture raw pulses
    nx_c1: int = 0         # two-level: level-1 coarse columns
    grp: int = 0           # two-level: level-1 images per level-2 group


def _look_geometry(p: BpParams, pos_c: np.ndarray):
    """CPI-centre look geometry (host numpy): iso-range row direction,
    range-gradient column direction, ground projection norm."""
    u = pos_c / np.linalg.norm(pos_c)
    ug = np.array([u[0], u[1]])
    g = float(np.linalg.norm(ug))
    if g < 1e-12:
        ug = np.array([0.0, 1.0]); g = 1.0
    cdir = -ug / np.linalg.norm(ug)
    rdir = np.array([cdir[1], -cdir[0]])
    if rdir[0] < 0:
        rdir = -rdir
    return (np.array([rdir[0], rdir[1], 0.0]),
            np.array([cdir[0], cdir[1], 0.0]), g)


# --------------------------------------------------------------------------
# host-built constants of a frame's formation, built and copied to the
# device once per key (a copy from pageable memory waits for the device);
# shared, so never written in place. Kept for the process's life, as the
# kernels' tables are: a captured frame graph reads them by address, so an
# eviction would free memory that its replays still read
# --------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _y_axis(device: torch.device) -> torch.Tensor:
    """float64 (0, 1): the row direction of a look straight down."""
    return torch.tensor([0.0, 1.0], dtype=F64, device=device)


@lru_cache(maxsize=None)
def _fit_offsets(a_max: float, device: torch.device) -> torch.Tensor:
    """float64 (-a_max, 0, a_max): the fit's three column offsets."""
    return torch.tensor([-a_max, 0.0, a_max], dtype=F64, device=device)


@lru_cache(maxsize=None)
def _anchor_tables(num_p: int, h: int, device: torch.device):
    """:func:`_anchor_plan`'s (needed, trip, w) on ``device``."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _anchor_plan(num_p, h))


@lru_cache(maxsize=None)
def _internal_cols(nx_i: int, dx_m: float,
                   device: torch.device) -> torch.Tensor:
    """float64 (nx_i,) along-row offsets [m] of the internal columns."""
    return torch.as_tensor((np.arange(nx_i) - (nx_i - 1) / 2.0) * dx_m,
                           device=device)


@lru_cache(maxsize=None)
def _output_rows(scene_size_m: float, ny: int,
                 device: torch.device) -> torch.Tensor:
    """float64 (ny,) output-grid row positions [m] (NumPy's linspace)."""
    half = scene_size_m / 2.0
    return torch.as_tensor(np.linspace(-half, half, ny), device=device)


def _frame_geometry(pos_c: torch.Tensor, p: BpParams, plan: FastBpPlan):
    """Per-CPI grid geometry from the centre-pulse position (float64 tensor
    on the device, no host sync): (row_dir(3,), col_dir(3,), dy_m)."""
    u = pos_c / torch.linalg.norm(pos_c)
    ug = u[:2]
    gn = torch.linalg.norm(ug)
    ug = torch.where(gn < 1e-12, _y_axis(ug.device), ug / gn)
    gn = torch.clamp(gn, min=1e-12)
    zero = torch.zeros((1,), dtype=F64, device=ug.device)
    cdir = torch.cat([-ug, zero])
    rdir = torch.stack([cdir[1], -cdir[0], zero[0]])
    rdir = torch.where(rdir[0] < 0, -rdir, rdir)
    dy_m = plan.stride * (_C / (2.0 * p.fs_hz)) / gn
    return rdir, cdir, dy_m


def _factor_bounds(p: BpParams, sat_pos: np.ndarray, ny_i: int, nx_i: int,
                   dy_m: float, dx_m: float):
    """Host-side bandwidth bounds for the factorized accumulate sizing:
    (f_val, dpb_raw, dpcx_raw) — the value field's x-bandwidth and the
    per-raw-pulse Doppler-rate bounds of the linear and quadratic terms."""
    pos_c = sat_pos[len(sat_pos) // 2]
    rdir, cdir, u_g = _look_geometry(p, pos_c)
    xi_max = (nx_i - 1) / 2.0
    a_max = xi_max * dx_m
    k_ph = 4.0 * math.pi * p.fc_hz / _C
    k_ix = 2.0 * p.fs_hz / _C

    pb_t, pcx_t = [], []
    f_val = 0.0
    for ci in (0, len(sat_pos) // 2, len(sat_pos) - 1):
        pos = sat_pos[ci]
        d0 = np.linalg.norm(pos)
        pb_y, pcx_y, bt_y, ctx_y = [], [], [], []
        for b in (-(ny_i - 1) / 2.0 * dy_m, 0.0, (ny_i - 1) / 2.0 * dy_m):
            g = (b * cdir[None, :]
                 + np.array([-a_max, 0.0, a_max])[:, None] * rdir[None, :])
            delta = np.linalg.norm(g - pos[None, :], axis=1) - d0
            ph = k_ph * delta
            ix = k_ix * delta
            pb_y.append((ph[2] - ph[0]) / (2.0 * xi_max))
            pcx_y.append((ph[2] + ph[0] - 2.0 * ph[1]) / (2.0 * xi_max ** 2)
                         * 2.0 * xi_max)
            bt_y.append((ix[2] - ix[0]) / (2.0 * xi_max))
            ctx_y.append((ix[2] + ix[0] - 2.0 * ix[1]) / (2.0 * xi_max ** 2)
                         * 2.0 * xi_max)
        pb_t.append(pb_y)
        pcx_t.append(pcx_y)
        f_val = max(f_val, 0.5 * (max(abs(v) for v in bt_y)
                                  + max(abs(v) for v in ctx_y)))
    n_half = max(1, (len(sat_pos) - 1) // 2)
    pb_t, pcx_t = np.asarray(pb_t), np.asarray(pcx_t)
    dpb_raw = float(np.abs(np.diff(pb_t, axis=0)).max() / n_half)
    dpcx_raw = float(np.abs(np.diff(pcx_t, axis=0)).max() / n_half)
    return f_val, dpb_raw, dpcx_raw


# merge-stage interpolation kernel (continuous Kaiser-windowed sinc)
_UPS_FC = 0.4      # lowpass cutoff [cycles / coarse sample]
_UPS_D = 10        # one-sided support [coarse samples]
_UPS_BETA = 10.0   # Kaiser shape
_UPS1_D = 6        # level-1 merge kernel (factor2)
_UPS1_BETA = 7.0


def _interp_matrix(n_from: int, n_to: int, h_from: float, h_to: float,
                   fc: float, d_sup: int, beta: float) -> np.ndarray:
    """(n_from, n_to) f32 band-limited Kaiser-sinc interpolation matrix
    between two centred grids with pitches ``h_from``/``h_to``."""
    xt = (np.arange(n_to) - (n_to - 1) / 2.0) * h_to
    xf = (np.arange(n_from) - (n_from - 1) / 2.0) * h_from
    d = (xt[None, :] - xf[:, None]) / h_from
    w = np.zeros_like(d)
    m = np.abs(d) < d_sup
    w[m] = np.i0(beta * np.sqrt(1.0 - (d[m] / d_sup) ** 2)) / np.i0(beta)
    return (2.0 * fc * np.sinc(2.0 * fc * d) * w).astype(np.float32)


def _upsample_matrix(plan: FastBpPlan) -> np.ndarray:
    """(nx_c, nx_i) coarse inner-sum columns -> fine internal grid."""
    return _interp_matrix(plan.nx_c, plan.nx_i, plan.nx_i / plan.nx_c, 1.0,
                          _UPS_FC, _UPS_D, _UPS_BETA)


_UPSAMPLE_ON = {}      # (nx_c, nx_i, device) -> _upsample_matrix there


def upsample_matrix(plan: FastBpPlan, dev) -> torch.Tensor:
    """:func:`_upsample_matrix` on ``dev``, built once per grid and device
    (the factorized merges read it every call)."""
    key = (plan.nx_c, plan.nx_i, torch.device(dev))
    if key not in _UPSAMPLE_ON:
        _UPSAMPLE_ON[key] = torch.from_numpy(_upsample_matrix(plan)).to(dev)
    return _UPSAMPLE_ON[key]


def _upsample_matrix_l1(plan: FastBpPlan) -> np.ndarray:
    """(nx_c1, nx_c) level-1 -> level-2 merge matrix (factor2)."""
    return _interp_matrix(plan.nx_c1, plan.nx_c, plan.nx_i / plan.nx_c1,
                          plan.nx_i / plan.nx_c, _UPS_FC, _UPS1_D, _UPS1_BETA)


def make_plan(p: BpParams, sat_pos: np.ndarray, t_slow: np.ndarray,
              t_start: float, w_win: int = 32,
              factorize: bool = False) -> FastBpPlan:
    """Build the static plan from concrete (numpy) trajectory geometry; the
    reference's rules line for line (``sat_pos``/``t_slow`` may span a whole
    collect: sizing covers the worst-case look rotation across it)."""
    sat_pos = np.asarray(sat_pos, np.float64)
    t_slow = np.asarray(t_slow, np.float64)

    bw = abs(p.chirp_rate) * p.pulse_width_s
    stride = max(1, int(p.fs_hz / max(bw, 1e-3)))
    dr_per_sample = _C / (2.0 * p.fs_hz)
    dx_m = p.scene_size_m / (p.nx - 1)

    half = p.scene_size_m / 2.0
    b_half, a_half, dy_min = 0.0, 0.0, np.inf
    for ci in (0, sat_pos.shape[0] // 2, sat_pos.shape[0] - 1):
        row_dir, col_dir, u_g = _look_geometry(p, sat_pos[ci])
        b_half = max(b_half, half * (abs(col_dir[0]) + abs(col_dir[1])))
        a_half = max(a_half, half * (abs(row_dir[0]) + abs(row_dir[1])))
        dy_min = min(dy_min, stride * dr_per_sample / u_g)
    margin_rows = 16
    margin_cols = 12 + (64 if factorize else 0)
    ny_req = 2 * (int(np.ceil(b_half / dy_min)) + margin_rows)
    nx_i = 2 * (int(np.ceil(a_half / dx_m)) + margin_cols)
    nx_i = -(-nx_i // 128) * 128

    nfft = 1 << (p.num_samples - 1).bit_length()
    d0 = np.linalg.norm(sat_pos, axis=1)
    t_ref = float(2.0 * np.mean(d0) / _C)
    n_org = (t_ref - float(t_start)) * p.fs_hz
    # the fused matched filter is a circular convolution at nfft: keep the
    # band clear of the wrap interval [0, ns + n_ref - 1 - nfft) if possible
    n_ref = int(p.pulse_width_s * p.fs_hz)
    wrap_end = max(0, p.num_samples + n_ref - 1 - nfft)
    candidates = (-(-ny_req // 128) * 128, -(-ny_req // 8) * 8)

    def _placement(ny_i):
        bs = int(round(n_org - 0.5 - ((ny_i - 1) / 2.0) * stride
                       - w_win / 2.0))
        return bs, stride * (ny_i - 1) + w_win

    band_start = n_band = ny_i = 0
    for ny_i in candidates:
        band_start, n_band = _placement(ny_i)
        if band_start >= 0 and band_start + n_band <= nfft:
            break
    else:
        raise ValueError(
            f"scene band [{band_start}, {band_start + n_band}) does not fit "
            f"the receive window (nfft={nfft}); enlarge num_samples or "
            "reduce scene_size_m")
    if band_start < wrap_end:
        warnings.warn(
            f"fast-BP band [{band_start}, {band_start + n_band}) overlaps "
            f"the circular-convolution wrap interval [0, {wrap_end}) of "
            "the fused matched filter (compress=True); compression "
            "semantics deviate from the linear variant there",
            stacklevel=2)

    sub_raw = nx_c = 0
    sub_raw1 = nx_c1 = grp = 0
    if factorize:
        nx_c = 128 if nx_i >= 512 else max(32, nx_i // 4)
        h = nx_i / nx_c
        row_dir_c, col_dir_c, u_gc = _look_geometry(
            p, sat_pos[sat_pos.shape[0] // 2])
        dy_c = stride * dr_per_sample / u_gc
        f_val, dpb_raw, dpcx_raw = _factor_bounds(p, sat_pos, ny_i, nx_i,
                                                  dy_c, dx_m)
        avail = 0.8 * 0.25 / h - f_val
        rate = dpb_raw + dpcx_raw
        if avail > 0.1 * 0.25 / h and rate > 0.0:
            sub_raw = int(2.0 * avail * _TWO_PI / rate)
            sub_raw = max(1, min(sub_raw, sat_pos.shape[0]))
        if sub_raw == 0:
            nx_c = 0
        else:
            nx_c1 = nx_c // 2
            h1 = nx_i / nx_c1
            s1 = 0.8 * 0.25 / h1 - f_val
            s2 = 0.8 * 0.25 / h - 0.8 * 0.25 / h1
            if (nx_c1 >= 16 and s1 > 0.1 * 0.25 / h1 and rate > 0.0
                    and _UPS1_D * h1 <= margin_cols - 4):
                sub_raw1 = int(2.0 * s1 * _TWO_PI / rate)
                sub_raw1 = max(1, min(sub_raw1, sub_raw))
                grp = 1 + int(2.0 * s2 * _TWO_PI / (rate * sub_raw1))
            if sub_raw1 < 1 or grp < 2:
                sub_raw1 = nx_c1 = grp = 0
    return FastBpPlan(
        ny_i=ny_i, nx_i=nx_i, w_win=w_win, stride=stride,
        band_start=band_start, nfft=nfft, dx_m=float(dx_m),
        t_ref=t_ref, n_org=float(n_org), sub_raw=sub_raw, nx_c=nx_c,
        sub_raw1=sub_raw1, nx_c1=nx_c1, grp=grp)


def band_rows(plan: FastBpPlan):
    """(p0, p1): the 128-sample rows [p0*128, p1*128) that hold the band
    the accumulate reads."""
    band_end = plan.band_start + plan.stride * (plan.ny_i - 1) + plan.w_win
    return plan.band_start // 128, -(-band_end // 128)


# --------------------------------------------------------------------------
# recentred presum
# --------------------------------------------------------------------------

def matched_filter_spectrum(p: BpParams, nfft: int) -> np.ndarray:
    """Conjugate reference-chirp spectrum at the padded length ``nfft``
    (host numpy complex64), so compression fuses into the recentre FFT."""
    return bp_ops.reference_chirp_conj(p, nfft)


def recentre_scalars(sat_pos, t_slow, vel_focus, p: BpParams, t_ref: float,
                     t_mean=None):
    """Per-pulse float64 (shift [samples], carrier [rad]) of the moving
    scene origin at the fixed delay ``t_ref``, on the trajectory's device."""
    pos, ts = bp_ops._f64(sat_pos), bp_ops._f64(t_slow)
    vf = bp_ops._f64(vel_focus, pos.device)
    dt = ts - (ts.mean() if t_mean is None else bp_ops._f64(t_mean,
                                                            pos.device))
    d0 = torch.linalg.norm(pos - vf[None, :] * dt[:, None], dim=1)
    shift = (2.0 * d0 / _C - t_ref) * p.fs_hz
    car = _TWO_PI * (2.0 * p.fc_hz / _C) * d0
    return shift, car


def _ramp(phase64: torch.Tensor) -> torch.Tensor:
    return expj(bp_ops._wrap(phase64).to(F32))


def centre_pulses(num_p: int, d: int, device=None) -> torch.Tensor:
    """Index of each presum group's centre pulse, min(g*d + d//2, P-1)."""
    return (torch.arange(-(-num_p // d), device=device) * d + d // 2).clamp(
        max=num_p - 1)


def presum_spectra(spec, shift, car, d: int) -> torch.Tensor:
    """Per pulse of ``spec`` (P, nfft) natural order: x recentre ramp of
    its float64 ``shift`` [samples] -> inverse FFT -> x carrier ``car``
    [rad]; then the box presum of groups of ``d`` (pad pulses weigh 0) / d.
    Returns (ceil(P/d), nfft) complex64."""
    num_p, nfft = spec.shape
    dev = spec.device
    p_pad = -(-num_p // d) * d
    edge = torch.arange(p_pad, device=dev).clamp(max=num_p - 1)
    w = (torch.arange(p_pad, device=dev) < num_p).to(torch.complex64)
    shift, car = shift.to(dev)[edge], car.to(dev)[edge]
    f_bins = torch.fft.fftfreq(nfft, dtype=F64, device=dev)
    spec = spec[edge] * _ramp(_TWO_PI * f_bins[None, :] * shift[:, None])
    rc_c = torch.fft.ifft(spec, dim=-1) * _ramp(car)[:, None]
    rc_b = (rc_c.reshape(-1, d, nfft) * w.reshape(-1, d)[:, :, None]
            ).sum(dim=1) / d
    return rc_b.to(torch.complex64)


def recenter_presum(rc, sat_pos, sat_vel, t_slow, vel_focus, p: BpParams,
                    d: int, t_ref: float, ref_conj=None, t_mean=None):
    """Recentre every pulse to the moving scene origin at the fixed delay
    ``t_ref`` and box-presum by ``d``, returning the recentred pulses
    (rc_c2[P2, nfft], pos2, vel2, t2). ``ref_conj`` (nfft,) fuses range
    compression into the same FFT round trip."""
    dev = rc.device
    pos, vel = bp_ops._f64(sat_pos, dev), bp_ops._f64(sat_vel, dev)
    ts = bp_ops._f64(t_slow, dev)
    num_p, ns = rc.shape
    shift, car = recentre_scalars(pos, ts, vel_focus, p, t_ref, t_mean)
    spec = torch.fft.fft(rc, n=1 << (ns - 1).bit_length(), dim=-1)
    if ref_conj is not None:
        spec = spec * torch.as_tensor(ref_conj, device=dev)[None, :]
    ci = centre_pulses(num_p, d, dev)
    return presum_spectra(spec, shift, car, d), pos[ci], vel[ci], ts[ci]


# --------------------------------------------------------------------------
# exact per-(pulse,row) coefficients (f64 delta-range physics, 3-point fit)
# --------------------------------------------------------------------------

def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _idx_phase_exact(g, pos, vel, vf, p: BpParams, plan: FastBpPlan):
    """Exact recentred (sample index, unwrapped phase) for pixel positions
    g (..., 3) seen from pos/vel (..., 3), all float64 (delta-range Newton,
    Doppler re-centering, stop-and-go Rx)."""
    d0 = torch.linalg.norm(pos, dim=-1)
    num = _dot(g, g) - 2.0 * _dot(g, pos)
    d1 = num / (2.0 * d0)
    delta = num / (2.0 * d0 + d1)
    d_tx = d0 + delta

    u = g - pos
    v_rad = _dot(vel - vf, u) / d_tx
    t_shift = (-p.fc_hz * 2.0 / (_C * p.chirp_rate)) * v_rad

    tau_a = 2.0 * d_tx / _C
    w_vec = (vf - vel) * tau_a[..., None]
    uw = 2.0 * _dot(u, w_vec) + _dot(w_vec, w_vec)
    drx1 = uw / (2.0 * d_tx)
    delta_rx = uw / (2.0 * d_tx + drx1)

    dtau = (2.0 * delta + delta_rx) / _C
    idx = plan.n_org + (dtau + t_shift) * p.fs_hz - 0.5
    phase = (_TWO_PI * p.fc_hz / _C) * (2.0 * delta + delta_rx)
    return idx, phase


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    return bp_ops._wrap(v).to(F32)


def _fit_coeffs(pos2, vel2, t2, vel_focus, p: BpParams, plan: FastBpPlan,
                t_mean, rdir, cdir, dy_m, fit_stride: int = 0):
    """Per-(t,y) window offset u0 and phase quadratic (Pa, Pb, Pc); per-t
    index quadratic (B, C). ``fit_stride`` > 1 evaluates the exact physics
    at anchor pulses only and interpolates the derived coefficients
    quadratically in slow time (the reference's anchored fit)."""
    dev = pos2.device
    ny, nx = plan.ny_i, plan.nx_i
    b = (torch.arange(ny, dtype=F64, device=dev) - (ny - 1) / 2.0) * dy_m
    xi_max = (nx - 1) / 2.0
    a_max = xi_max * plan.dx_m
    vf = bp_ops._f64(vel_focus, dev)

    num_p = pos2.shape[0]
    use_anchor = fit_stride > 1 and num_p > 3 * fit_stride
    if use_anchor:
        needed_t, trip_t, w64 = _anchor_tables(num_p, fit_stride, dev)
        pos2_a, vel2_a, t2_a = pos2[needed_t], vel2[needed_t], t2[needed_t]
    else:
        pos2_a, vel2_a, t2_a = pos2, vel2, t2

    org = vf[None, :] * (t2_a - t_mean)[:, None]
    base = b[None, :, None, None] * cdir[None, None, None, :]
    xoff = (_fit_offsets(a_max, dev)[None, None, :, None]
            * rdir[None, None, None, :])
    g = base + xoff
    pos = (pos2_a - org)[:, None, None, :]
    vel = vel2_a[:, None, None, :]
    idx, ph = _idx_phase_exact(g, pos, vel, vf, p, plan)
    row0 = plan.band_start + plan.stride * torch.arange(ny, device=dev)
    cidx = ny // 2

    if use_anchor:
        a0, a1, a2 = trip_t.unbind(1)

        def qinterp(v, w):
            sh = (-1,) + (1,) * (v.dim() - 1)
            return (w[:, 0].reshape(sh) * v[a0]
                    + w[:, 1].reshape(sh) * v[a1]
                    + w[:, 2].reshape(sh) * v[a2])

        w32 = w64.to(F32)
        u0 = qinterp((idx[..., 1] - row0[None, :]).to(F32), w32)
        pb = qinterp(((ph[..., 2] - ph[..., 0]) / (2.0 * xi_max)).to(F32),
                     w32)
        pc = qinterp(((ph[..., 2] + ph[..., 0] - 2.0 * ph[..., 1])
                      / (2.0 * xi_max ** 2)).to(F32), w32)
        b_t = qinterp(((idx[:, cidx, 2] - idx[:, cidx, 0])
                       / (2.0 * xi_max)).to(F32), w32)
        c_t = qinterp(((idx[:, cidx, 2] + idx[:, cidx, 0]
                        - 2.0 * idx[:, cidx, 1])
                       / (2.0 * xi_max ** 2)).to(F32), w32)
        # pa is ~1e6 rad unwrapped: per-anchor and per-row marginals stay
        # f64, the ~1e3-rad cross residual is f32-safe
        pa_a = ph[..., 1]
        ca = pa_a[:, cidx]
        ea = pa_a[pa_a.shape[0] // 2] - ca[pa_a.shape[0] // 2]
        ra = (pa_a - ca[:, None] - ea[None, :]).to(F32)
        pa_sum = (_wrap32(qinterp(ca, w64))[:, None] + _wrap32(ea)[None, :]
                  + qinterp(ra, w32))
        pa_w = pa_sum - float(np.float32(_TWO_PI)) * torch.round(
            pa_sum / float(np.float32(_TWO_PI)))
        return u0, pa_w, pb, pc, b_t, c_t

    pa = ph[..., 1]
    pb = (ph[..., 2] - ph[..., 0]) / (2.0 * xi_max)
    pc = (ph[..., 2] + ph[..., 0] - 2.0 * ph[..., 1]) / (2.0 * xi_max ** 2)
    pa_w = _wrap32(pa)
    u0 = (idx[..., 1] - row0[None, :]).to(F32)
    b_t = ((idx[:, cidx, 2] - idx[:, cidx, 0]) / (2.0 * xi_max)).to(F32)
    c_t = ((idx[:, cidx, 2] + idx[:, cidx, 0] - 2.0 * idx[:, cidx, 1])
           / (2.0 * xi_max ** 2)).to(F32)
    return u0, pa_w, pb.to(F32), pc.to(F32), b_t, c_t


# --------------------------------------------------------------------------
# windowed-Fourier row interpolation + phase accumulation
# --------------------------------------------------------------------------

def _taper(u, w: int, power: int):
    """Continuous periodic cosine-power taper, >0 away from window edges."""
    return torch.sin(math.pi * (u + 0.5) / w) ** power


@lru_cache(maxsize=None)
def _window_matrix(w: int, taper_pow: int) -> np.ndarray:
    """(w, w) complex64: tapered window DFT / w, [sample s, bin m]."""
    s = np.arange(w)
    fmat = np.exp(-2j * np.pi * np.outer(s, s) / w) / w
    tap = np.sin(np.pi * (s + 0.5) / w) ** taper_pow
    return (tap[:, None] * fmat).astype(np.complex64)


def _window_spectra(band: torch.Tensor, plan: FastBpPlan) -> torch.Tensor:
    """(T, n_band) complex -> (T, w, ny) tapered window spectra: the ny
    strided windows (a view) times the tapered DFT matrix."""
    w, k = plan.w_win, plan.stride
    win = band.unfold(-1, w, k)[:, :plan.ny_i]             # (T, ny, w)
    gm = torch.from_numpy(_window_matrix(w, plan.taper_pow)).to(band.device)
    return torch.matmul(win, gm).transpose(1, 2)


def _cmatmul_real(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """complex a @ real m, as two real products."""
    return torch.complex(a.real @ m, a.imag @ m)


def _band(rc2, plan):
    return rc2[:, plan.band_start:
               plan.band_start + plan.stride * (plan.ny_i - 1) + plan.w_win]


def _edge_pad(x: torch.Tensor, n: int, edge: bool):
    """Pad the leading axis to ``n`` rows: repeat the last row, or zeros."""
    if x.shape[0] == n:
        return x
    if edge:
        return x[torch.arange(n, device=x.device).clamp(max=x.shape[0] - 1)]
    pad = torch.zeros((n - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad])


def _fm_xi(plan, dev):
    w = plan.w_win
    f_m = torch.fft.fftfreq(w, device=dev).to(F32)
    xi = torch.arange(plan.nx_i, dtype=F32, device=dev) - (plan.nx_i - 1) / 2.0
    return f_m, xi


def _accumulate(rc2, u0, pa, pb, pc, b_t, c_t, plan: FastBpPlan,
                block: int = 32):
    """sum_t value[t,y,x] * expj(phase[t,y,x]) over pulse blocks."""
    dev = rc2.device
    num_p, w = rc2.shape[0], plan.w_win
    f_m, xi = _fm_xi(plan, dev)
    band = _band(rc2, plan)
    img = torch.zeros((plan.ny_i, plan.nx_i), dtype=torch.complex64,
                      device=dev)
    for b0 in range(0, num_p, block):
        s = slice(b0, min(b0 + block, num_p))
        u0_b, bt_b, ct_b = u0[s], b_t[s], c_t[s]
        w_hat = _window_spectra(band[s], plan)
        g = w_hat * expj(_TWO_PI * f_m[None, :, None] * u0_b[:, None, :])
        e_t = bt_b[:, None] * xi[None, :] + ct_b[:, None] * xi[None, :] ** 2
        kern = expj(_TWO_PI * f_m[None, :, None] * e_t[:, None, :])
        val = torch.matmul(g.transpose(1, 2), kern)
        u = u0_b[:, :, None] + e_t[:, None, :]
        val = val / torch.clamp(_taper(u, w, plan.taper_pow), min=1e-4)
        phase = (pa[s][:, :, None] + pb[s][:, :, None] * xi[None, None, :]
                 + pc[s][:, :, None] * xi[None, None, :] ** 2)
        img = img + torch.sum(val * expj(phase), dim=0)
    return img


def _taper_field(u0_b, e_t, w: int, taper_pow: int):
    """Taper at u = u0[t,y] + e_t[t,x] via the angle-sum identity: trig on
    the (t,y) and (t,x) marginals only."""
    if taper_pow % 2 == 0:
        aa = (math.pi / w) * (u0_b + 0.5)
        bb = (math.pi / w) * e_t
        s_u = (torch.sin(aa)[:, :, None] * torch.cos(bb)[:, None, :]
               + torch.cos(aa)[:, :, None] * torch.sin(bb)[:, None, :])
        t2_ = s_u * s_u
        return t2_ * t2_ if taper_pow == 4 else t2_ ** (taper_pow // 2)
    return _taper(u0_b[:, :, None] + e_t[:, None, :], w, taper_pow)


def _inner_values(band_b, u0_b, bt_b, ct_b, xic, f_m, plan):
    """Window-interpolated values on coarse columns ``xic``: (T, ny, nxc)
    and the column offsets e_t (T, nxc)."""
    w_hat = _window_spectra(band_b, plan)
    g = w_hat * expj(_TWO_PI * f_m[None, :, None] * u0_b[:, None, :])
    e_t = bt_b[:, None] * xic[None, :] + ct_b[:, None] * xic[None, :] ** 2
    kern = expj(_TWO_PI * f_m[None, :, None] * e_t[:, None, :])
    val = torch.matmul(g.transpose(1, 2), kern)
    return val / torch.clamp(_taper_field(u0_b, e_t, plan.w_win,
                                          plan.taper_pow), min=1e-4)


def _coarse_cols(n: int, nx: int, dev):
    return (torch.arange(n, dtype=F32, device=dev) - (n - 1) / 2.0) \
        * float(np.float32(nx / n))


def _accumulate_factor(rc2, u0, pa, pb, pc, b_t, c_t, plan: FastBpPlan,
                       sub_p: int):
    """Factorized (sub-aperture) accumulation: inner sums against each
    sub-aperture's anchor pulse on ``plan.nx_c`` coarse columns, merged to
    the fine grid by one Kaiser-sinc matmul and the anchor carrier."""
    dev = rc2.device
    num_p = rc2.shape[0]
    ny, nx, nxc = plan.ny_i, plan.nx_i, plan.nx_c
    f_m, xi = _fm_xi(plan, dev)
    xic = _coarse_cols(nxc, nx, dev)
    u_mat = upsample_matrix(plan, dev)
    band = _band(rc2, plan)
    ci = subaperture_anchors(num_p, sub_p, dev)
    n_sub = ci.shape[0]
    p_pad = n_sub * sub_p
    pa_c, pb_c, pc_c = pa[ci], pb[ci], pc[ci]
    band, wl = _edge_pad(band, p_pad, False), _edge_pad(
        torch.ones((num_p,), dtype=F32, device=dev), p_pad, False)
    u0, pa, pb, pc, b_t, c_t = (_edge_pad(v, p_pad, True)
                                for v in (u0, pa, pb, pc, b_t, c_t))
    img = torch.zeros((ny, nx), dtype=torch.complex64, device=dev)
    for s in range(n_sub):
        t = slice(s * sub_p, (s + 1) * sub_p)
        val = _inner_values(band[t], u0[t], b_t[t], c_t[t], xic, f_m, plan)
        xc = xic[None, None, :]
        d_ph = ((pa[t] - pa_c[s][None])[:, :, None]
                + (pb[t] - pb_c[s][None])[:, :, None] * xc
                + (pc[t] - pc_c[s][None])[:, :, None] * xc ** 2)
        j_s = torch.sum(val * expj(d_ph) * wl[t][:, None, None], dim=0)
        img = merge_subaperture(img, j_s, u_mat, pa_c[s], pb_c[s], pc_c[s],
                                xi)
    return img


def subaperture_anchors(num_p: int, sub_p: int, dev) -> torch.Tensor:
    """The anchor (centre) pulse of each sub-aperture of ``sub_p`` pulses,
    min(s*sub_p + sub_p//2, P-1), so a ragged last one anchors on a live
    pulse."""
    return (torch.arange(-(-num_p // sub_p), device=dev) * sub_p
            + sub_p // 2).clamp(max=num_p - 1)


def merge_subaperture(img, j_s, u_mat, pa_c, pb_c, pc_c, xi):
    """``img`` plus one sub-aperture's coarse inner sums ``j_s`` (ny, nx_c)
    upsampled to the fine grid by ``u_mat`` and remodulated by its anchor
    carrier exp(j (pa_c + pb_c xi + pc_c xi^2))."""
    carrier = expj(pa_c[:, None] + pb_c[:, None] * xi[None, :]
                   + pc_c[:, None] * xi[None, :] ** 2)
    return img + carrier * _cmatmul_real(j_s, u_mat)


def _accumulate_factor2(rc2, u0, pa, pb, pc, b_t, c_t, plan: FastBpPlan,
                        sub_p1: int, grp: int):
    """Two-level factorized accumulation: level-1 inner sums on
    ``plan.nx_c1`` columns against level-1 anchors, merged in groups of
    ``grp`` onto the nx_c grid against level-2 anchors, then to the fine
    grid. Phase totals telescope exactly (a2 + (a1 - a2) + (t - a1))."""
    dev = rc2.device
    num_p = rc2.shape[0]
    ny, nx, nxc, nxc1 = plan.ny_i, plan.nx_i, plan.nx_c, plan.nx_c1
    f_m, xi = _fm_xi(plan, dev)
    xic = _coarse_cols(nxc, nx, dev)
    xic1 = _coarse_cols(nxc1, nx, dev)
    u_mat = upsample_matrix(plan, dev)
    u12 = torch.from_numpy(_upsample_matrix_l1(plan)).to(dev)
    band = _band(rc2, plan)

    t_grp = grp * sub_p1
    n_sub2 = -(-num_p // t_grp)
    p_pad = n_sub2 * t_grp
    ci1 = (torch.arange(n_sub2 * grp, device=dev) * sub_p1
           + sub_p1 // 2).clamp(max=num_p - 1)
    cj = (torch.arange(n_sub2, device=dev) * t_grp + t_grp // 2).clamp(
        max=num_p - 1)
    a1 = [v[ci1].reshape(n_sub2, grp, ny) for v in (pa, pb, pc)]
    a2 = [v[cj] for v in (pa, pb, pc)]
    band, wl = _edge_pad(band, p_pad, False), _edge_pad(
        torch.ones((num_p,), dtype=F32, device=dev), p_pad, False)
    u0, pa, pb, pc, b_t, c_t = (_edge_pad(v, p_pad, True)
                                for v in (u0, pa, pb, pc, b_t, c_t))
    img = torch.zeros((ny, nx), dtype=torch.complex64, device=dev)
    for s in range(n_sub2):
        t = slice(s * t_grp, (s + 1) * t_grp)
        pa1, pb1, pc1 = (v[s] for v in a1)                    # (grp, ny)
        pa2, pb2, pc2 = (v[s] for v in a2)                    # (ny,)
        val = _inner_values(band[t], u0[t], b_t[t], c_t[t], xic1, f_m, plan)
        pa_r, pb_r, pc_r = (torch.repeat_interleave(v, sub_p1, dim=0)
                            for v in (pa1, pb1, pc1))
        d_ph = ((pa[t] - pa_r)[:, :, None]
                + (pb[t] - pb_r)[:, :, None] * xic1[None, None, :]
                + (pc[t] - pc_r)[:, :, None] * xic1[None, None, :] ** 2)
        contrib = val * expj(d_ph) * wl[t][:, None, None]
        j1 = contrib.reshape(grp, sub_p1, ny, nxc1).sum(dim=1)
        j12 = _cmatmul_real(j1, u12)                          # (grp, ny, nxc)
        car12 = expj((pa1 - pa2[None])[:, :, None]
                     + (pb1 - pb2[None])[:, :, None] * xic[None, None, :]
                     + (pc1 - pc2[None])[:, :, None] * xic[None, None, :] ** 2)
        j2 = torch.sum(car12 * j12, dim=0)
        j_up = _cmatmul_real(j2, u_mat)
        carrier = expj(pa2[:, None] + pb2[:, None] * xi[None, :]
                       + pc2[:, None] * xi[None, :] ** 2)
        img = img + carrier * j_up
    return img


# --------------------------------------------------------------------------
# internal -> output grid resample, finalize
# --------------------------------------------------------------------------

def _resample_output(img_i, plan: FastBpPlan, p: BpParams, rdir, cdir, dy_m):
    """Internal (ny_i, nx_i) iso-range image -> (ny, nx) output grid by two
    chirp-Z passes whose per-slice starts carry the shear terms."""
    dev = img_i.device
    r1, r2 = rdir[0], rdir[1]
    c1, c2 = cdir[0], cdir[1]
    half = p.scene_size_m / 2.0
    dy_out = p.scene_size_m / (p.ny - 1)
    dx_out = p.scene_size_m / (p.nx - 1)

    a_cols = _internal_cols(plan.nx_i, plan.dx_m, dev)
    shear_b = (c1 / r1) * a_cols / dy_m
    scale_b = c2 - c1 * r2 / r1
    step_r = scale_b * dy_out / dy_m
    start_r = (scale_b * -half) / dy_m + (plan.ny_i - 1) / 2.0
    img = czt_eval(img_i, p.ny, step_r, start_r + shear_b, axis=0)

    y = _output_rows(p.scene_size_m, p.ny, dev)
    shear_a = (r2 * y) / plan.dx_m
    step_c = r1 * dx_out / plan.dx_m
    start_c = (r1 * -half) / plan.dx_m + (plan.nx_i - 1) / 2.0
    return czt_eval(img, p.nx, step_c, start_c + shear_a, axis=1)


def _finalize(img_i, phase_coeffs, pos2, vel2, t2, vf, t_mean_v,
              p: BpParams, plan: FastBpPlan, rdir, cdir, dy_m):
    """Margin mask -> centre-pulse carrier demodulation -> chirp-Z output
    resample -> analytic output-grid remodulation."""
    dev = img_i.device
    pa, pb, pc = phase_coeffs
    half = p.scene_size_m / 2.0
    b_rows = (torch.arange(plan.ny_i, dtype=F64, device=dev)
              - (plan.ny_i - 1) / 2.0) * dy_m
    b_lim = half * (torch.abs(cdir[0]) + torch.abs(cdir[1])) + 4.0 * dy_m
    a_cols = _internal_cols(plan.nx_i, plan.dx_m, dev)
    a_lim = half * (torch.abs(rdir[0]) + torch.abs(rdir[1])) + 4.0 * plan.dx_m
    img_i = img_i * ((torch.abs(b_rows) <= b_lim)[:, None]
                     & (torch.abs(a_cols) <= a_lim)[None, :])

    tc = pos2.shape[0] // 2
    xi = torch.arange(plan.nx_i, dtype=F32, device=dev) - (plan.nx_i - 1) / 2.0
    ph_int = (pa[tc][:, None] + pb[tc][:, None] * xi[None, :]
              + pc[tc][:, None] * xi[None, :] ** 2)
    img_i = img_i * expj(-ph_int)

    img = _resample_output(img_i, plan, p, rdir, cdir, dy_m)

    x = torch.linspace(-half, half, p.nx, dtype=F64, device=dev)
    y = torch.linspace(-half, half, p.ny, dtype=F64, device=dev)
    org_tc = vf * (t2[tc] - t_mean_v)
    pos_tc = (pos2[tc] - org_tc)[None, None, :]
    vel_tc = vel2[tc][None, None, :]

    h_out = 8
    if p.nx > 3 * h_out and p.ny > 3 * h_out:
        nx_need, trip_x, w_x = _anchor_tables(p.nx, h_out, dev)
        ny_need, trip_y, w_y = _anchor_tables(p.ny, h_out, dev)
        gy, gx = torch.meshgrid(y[ny_need], x[nx_need], indexing="ij")
        g_sub = torch.stack([gx, gy, torch.zeros_like(gx)], dim=-1)
        _, ph_sub = _idx_phase_exact(g_sub, pos_tc, vel_tc, vf, p, plan)
        phx = torch.einsum("ank,nk->an", ph_sub[:, trip_x], w_x)
        ph_out64 = torch.einsum("mkn,mk->mn", phx[trip_y, :], w_y)
    else:
        gy, gx = torch.meshgrid(y, x, indexing="ij")
        g_out = torch.stack([gx, gy, torch.zeros_like(gx)], dim=-1)
        _, ph_out64 = _idx_phase_exact(g_out, pos_tc, vel_tc, vf, p, plan)
    return img * expj(_wrap32(ph_out64))


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------

def _check_modes(accumulate: str, math_mode: str) -> None:
    if accumulate in INTERPRET:
        raise NotImplementedError(
            f"accumulate={accumulate!r}: interpret mode is not ported yet "
            "(the port has no kernel interpreter); pass CPU tensors with "
            f"accumulate={accumulate[:-len('_interpret')]!r} to run the "
            "kernel's plain version")
    if accumulate not in ACCUMULATE:
        raise ValueError(f"unknown accumulate {accumulate!r}: pick one of "
                         f"{ACCUMULATE}")
    if math_mode == "fast":
        raise NotImplementedError(
            "math_mode='fast' (single-pass bf16 dots) is not ported yet")
    if math_mode != "exact":
        raise ValueError(f"unknown math_mode {math_mode!r}")


def backproject_fast(rc, sat_pos, sat_vel, t_slow, vel_focus, p: BpParams,
                     plan: FastBpPlan, presum: int = 1, t_mean=None,
                     compress: bool = False, accumulate: str = "xla",
                     fit_stride: int = 0, math_mode: str = "exact",
                     raw_spectra=None, ring_offset=None, device=None):
    """Gather-free BP of range-compressed (or, with ``compress=True``, raw)
    pulses onto the output grid.

    rc: (P, Ns) complex64 on the working device; the trajectory is float64
    (tensors or arrays, moved to the working device); ``plan`` from
    :func:`make_plan`. The caller applies the ``presum`` rescale and droop
    correction. ``raw_spectra``: cached (P, nfft/128, 128) complex64 forward
    spectra from :func:`forward_spectra` (``rc`` is then None); with
    ``ring_offset`` (pulses, a multiple of ``presum``) slot j holds
    chronological pulse (j - ring_offset) % P.

    ``accumulate``: 'xla' (plain iso-range), 'factor', 'factor2', or
    'factor_pallas' / 'factor2_pallas' (the same accumulates after the
    hand-written fused recentre+presum CUDA kernel), 'pallas' (the
    recentre kernel, then the pixel-tile accumulate kernel; needs a
    ``w_win=64`` plan) or 'factor_kernel' (the recentre kernel, then the
    coarse-tile factorized accumulate kernel where the plan takes it; see
    :func:`accumulate_grid`). Returns (ny, nx) complex64. On CUDA tensors
    the routes of ``GRAPH_ACCUMULATE`` form it by a CUDA graph replay
    (:class:`_FrameGraph`), with the eager formation's bits.
    """
    return _backproject(rc, sat_pos, sat_vel, t_slow, vel_focus, p, plan,
                        presum, t_mean, compress, accumulate, fit_stride,
                        math_mode, raw_spectra, ring_offset, device,
                        droop=False)


def _backproject(rc, sat_pos, sat_vel, t_slow, vel_focus, p: BpParams,
                 plan: FastBpPlan, presum: int, t_mean, compress: bool,
                 accumulate: str, fit_stride: int, math_mode: str,
                 raw_spectra, ring_offset, device, droop: bool):
    """:func:`backproject_fast`, then with ``droop`` (and a presum above 1)
    the presum rescale and droop correction of :func:`focus_bp_fast`: the
    recentre, then :func:`_form` eagerly or by a graph replay."""
    _check_modes(accumulate, math_mode)
    src = raw_spectra if raw_spectra is not None else rc
    dev = torch.device(device if device is not None else src.device)
    pos, vel, ts, vf = (bp_ops._f64(a, dev)
                        for a in (sat_pos, sat_vel, t_slow, vel_focus))
    t_mean_v = ts.mean() if t_mean is None else bp_ops._f64(t_mean, dev)
    d = max(1, presum)
    graph = None
    if _graphed(dev, accumulate):
        key = (plan, p, d, accumulate, fit_stride, droop and d > 1,
               raw_spectra is None, tuple(src.shape),
               tuple(t_mean_v.shape), dev)
        p0, p1 = band_rows(plan)
        graph = _live_graph(key, lambda: _FrameGraph(
            (-(-src.shape[0] // d), (p1 - p0) * 128), dev))
    rc2, pos2, vel2, t2, plan_acc = _recentre(
        rc, raw_spectra, pos, vel, ts, vf, t_mean_v, p, plan, d, compress,
        accumulate, ring_offset, out=None if graph is None else graph.rc2)
    ins = (rc2, pos2, vel2, t2, vf, t_mean_v) + (
        (pos, vel, ts) if droop and d > 1 else ())
    form = partial(_form, p=p, plan=plan, plan_acc=plan_acc, d=d,
                   accumulate=accumulate, fit_stride=fit_stride)
    if graph is None:
        return form(*ins)
    return graph.run(form, ins)


def _recentre(rc, raw_spectra, pos, vel, ts, vf, t_mean_v, p: BpParams,
              plan: FastBpPlan, d: int, compress: bool, accumulate: str,
              ring_offset, out=None):
    """The recentre (and presum by ``d``) of the raw pulses ``rc`` or of
    their ``raw_spectra``: (rc2, pos2, vel2, t2, plan_acc), ``plan_acc``
    the plan with its band start relative to the rows the recentre kept.
    ``out``: where the kernel routes write rc2."""
    from nis_sar_amtigmti_video_tpu_torch.ops.cuda import fft_kernel

    p0, p1 = band_rows(plan)
    band_plan = _dc_replace(plan, band_start=plan.band_start - p0 * 128)
    with span("bp.recentre"):
        if raw_spectra is not None:
            if not (compress and fft_kernel.supported(plan.nfft)):
                raise ValueError(
                    "raw_spectra needs compress=True and a kernel-supported "
                    f"plan.nfft (got nfft={plan.nfft})")
            if raw_spectra.shape[1] * 128 != plan.nfft:
                raise ValueError(
                    f"raw_spectra rows ({raw_spectra.shape[1]}) do not match "
                    f"plan.nfft={plan.nfft}: the spectra were built from "
                    "pulses with a different num_samples than the plan's")
            return (*fft_kernel.recentre_from_spectra(
                raw_spectra, pos, vel, ts, vf, p, d, plan.t_ref,
                t_mean=t_mean_v, out_rows=(p0, p1), ring_offset=ring_offset,
                out=out), band_plan)
        if accumulate in KERNEL_ACCUMULATE:
            if not fft_kernel.supported(plan.nfft):
                raise ValueError(
                    f"accumulate={accumulate!r} runs the recentre kernel, "
                    f"which does not take plan.nfft={plan.nfft}: pick "
                    f"{KERNEL_ACCUMULATE[accumulate]!r}")
            return (*fft_kernel.recenter_presum(
                rc, pos, vel, ts, vf, p, d, plan.t_ref,
                filter_compress=compress, t_mean=t_mean_v, out_rows=(p0, p1),
                out=out), band_plan)
        ref_conj = (matched_filter_spectrum(p, plan.nfft) if compress
                    else None)
        return (*recenter_presum(rc, pos, vel, ts, vf, p, d, plan.t_ref,
                                 ref_conj=ref_conj, t_mean=t_mean_v), plan)


def _form(rc2, pos2, vel2, t2, vf, t_mean_v, *droop_traj, p: BpParams,
          plan: FastBpPlan, plan_acc: FastBpPlan, d: int, accumulate: str,
          fit_stride: int):
    """A frame's formation after its recentre, on device tensors: the fit,
    the accumulate, the finalize and, given the CPI's float64 (pos, vel,
    ts) as ``droop_traj``, the presum rescale by ``d`` and droop
    correction. The routes of ``GRAPH_ACCUMULATE`` build every host
    constant once (cached on the device) and never synchronise here, so a
    CUDA graph can capture them."""
    with span("bp.fit"):
        rdir, cdir, dy_m = _frame_geometry(pos2[pos2.shape[0] // 2], p, plan)
        u0, pa, pb, pc, b_t, c_t = _fit_coeffs(pos2, vel2, t2, vf, p, plan,
                                               t_mean_v, rdir, cdir, dy_m,
                                               fit_stride=fit_stride)
    with span("bp.accumulate"):
        img_i = accumulate_grid(accumulate,
                                (rc2, u0, pa, pb, pc, b_t, c_t, plan_acc), d)
    with span("bp.finalize"):
        img = _finalize(img_i, (pa, pb, pc), pos2, vel2, t2, vf, t_mean_v,
                        p, plan, rdir, cdir, dy_m)
    if droop_traj:
        with span("bp.droop"):
            corr = bp_ops.presum_droop_correction(*droop_traj, vf, p, d,
                                                  device=img.device)
            img = d * corr * img
    return img


# the accumulates whose formation (:func:`_form`) is free of host syncs:
# on CUDA tensors a graph forms their frames
GRAPH_ACCUMULATE = ("pallas",)


def _graphed(dev: torch.device, accumulate: str) -> bool:
    """Whether frames of ``accumulate`` on ``dev`` are formed by a graph."""
    return dev.type == "cuda" and accumulate in GRAPH_ACCUMULATE


def _capture(form, ins):
    """(graph, out): ``form(*ins)`` captured as a CUDA graph, whose
    replays write ``out``. The cuBLAS workspace that the capture stream
    took was allocated in the graph's private pool: dropping the cached
    reference after the capture (as PyTorch's own graph trees do) leaves it
    to that pool, which keeps it for the replays, instead of holding a
    second 32 MiB workspace allocated for the process's life."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = form(*ins)
    torch._C._cuda_clearCublasWorkspaces()
    return graph, out


def _kernel_wrappers():
    """The accumulate kernels' wrappers, each counting its launches in
    ``.launches`` on the host: a capture counts launches that it only
    records, and a replay makes launches that nothing counts."""
    from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (bp_factor_kernel,
                                                           bp_kernel)
    return (bp_kernel.accumulate_pallas,
            bp_factor_kernel.accumulate_factor_pallas)


class _FrameGraph:
    """One key's frame formation (:func:`_form`) as a CUDA graph: ``rc2``
    the static buffer the recentre writes, the other inputs filled by
    on-device copies, captured after one eager run at the first frame (so
    cuFFT plans, kernel attributes and the cached constants exist) and
    replayed for every later one. A replay's frame is cloned out of the
    static output, so frames held together never share a buffer. The
    kernels' launch counters count what the card runs: not the capture's
    launches, and each replay's."""

    def __init__(self, rc2_shape, dev: torch.device):
        self.rc2 = torch.empty(rc2_shape, dtype=torch.complex64, device=dev)
        self.ins = self.out = self.graph = None
        self.launched = ()          # (wrapper, launches) of one replay

    def _fill(self, ins) -> None:
        if ins[0] is not self.rc2:
            raise RuntimeError("the recentre did not write the graph's rc2")
        for dst, src in zip(self.ins[1:], ins[1:]):
            dst.copy_(src)

    def run(self, form, ins) -> torch.Tensor:
        """The frame of ``ins`` (rc2 this graph's own, then the trajectory
        and focus tensors), by ``form`` at the first call (which captures
        it) and by a replay after."""
        if self.graph is None:
            with span("bp.capture"):
                self.ins = (self.rc2,) + tuple(
                    torch.empty(t.shape, dtype=t.dtype, device=t.device)
                    for t in ins[1:])
                self._fill(ins)
                img = form(*self.ins)
                wrappers = _kernel_wrappers()
                before = [w.launches for w in wrappers]
                self.graph, self.out = _capture(form, self.ins)
                self.launched = tuple((w, w.launches - n)
                                      for w, n in zip(wrappers, before))
                for w, n in self.launched:
                    w.launches -= n
                count("bp.graph_capture")
            return img
        with span("bp.replay"):
            self._fill(ins)
            self.graph.replay()
            for w, n in self.launched:
                w.launches += n
            count("bp.graph_replay")
            return self.out.clone()


# the live frame graphs by key, the least recently used first
_GRAPHS: collections.OrderedDict = collections.OrderedDict()


def _live_graph(key, make):
    """The live graph of ``key``, else ``make()``'s; past two live, the
    least recently used is dropped."""
    graph = _GRAPHS.pop(key, None) or make()
    _GRAPHS[key] = graph
    while len(_GRAPHS) > 2:
        _GRAPHS.popitem(last=False)
    return graph


def accumulate_grid(accumulate: str, coeffs, d: int):
    """The internal-grid image of ``accumulate`` on ``coeffs`` = (rc2, u0,
    pa, pb, pc, b_t, c_t, plan_acc): 'pallas' the pixel-tile kernel;
    'factor_kernel' the coarse-tile kernel where it takes the plan (on CPU
    tensors, as in the reference, the plain accumulate of 'factor' on other
    plans; on CUDA tensors a ValueError there); 'factor2*' where the plan
    has a second level, 'factor*' where it has a sub-aperture, else the
    plain iso-range accumulate (presum ``d`` scales the sub-aperture
    lengths)."""
    plan = coeffs[-1]
    if accumulate == "pallas":
        from nis_sar_amtigmti_video_tpu_torch.ops.cuda import bp_kernel
        return bp_kernel.accumulate_pallas(*coeffs)
    if accumulate == "factor_kernel":
        from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (
            bp_factor_kernel)
        if bp_factor_kernel.supported(plan):
            return bp_factor_kernel.accumulate_factor_pallas(
                *coeffs, max(1, plan.sub_raw // d))
        if coeffs[0].device.type != "cpu":
            got = (plan.w_win, plan.nx_c, plan.sub_raw, plan.ny_i, plan.nx_i)
            raise ValueError(
                "accumulate='factor_kernel': the coarse-tile kernel takes "
                "w_win 32, nx_c 128, a sub-aperture and a 128-multiple grid, "
                f"not (w_win, nx_c, sub_raw, ny_i, nx_i) = {got}: pick "
                "'factor_pallas'")
    if accumulate.startswith("factor2") and plan.sub_raw1 > 0:
        return _accumulate_factor2(*coeffs, max(1, plan.sub_raw1 // d),
                                   plan.grp)
    if accumulate.startswith("factor") and plan.sub_raw > 0:
        return _accumulate_factor(*coeffs, max(1, plan.sub_raw // d))
    return _accumulate(*coeffs)


def forward_spectra(raw: torch.Tensor, p: BpParams,
                    math_mode: str = "exact") -> torch.Tensor:
    """Cacheable forward half of the streaming recentre: matched-filtered
    forward spectra of raw pulses, (P, nfft/128, 128) complex64 (the
    hand-written CUDA kernel on CUDA tensors; see ops/cuda/fft_kernel.py)."""
    from nis_sar_amtigmti_video_tpu_torch.ops.cuda import fft_kernel

    _check_modes("xla", math_mode)
    return fft_kernel.forward_spectra(raw, p, filter_compress=True)


def focus_bp_fast(raw, sat_pos, sat_vel, t_slow, vel_focus, t_start,
                  p: BpParams, presum: int = 1, plan: FastBpPlan = None,
                  accumulate: str = "xla", fit_stride: int = 0,
                  math_mode: str = "exact", raw_spectra=None,
                  ring_offset=None):
    """Fused range compression + fast BP + presum rescale/droop: raw pulses
    see one fast-time FFT round trip end to end. ``raw_spectra`` (from
    :func:`forward_spectra`) skips the forward transform; ``raw`` may then
    be None, and ``ring_offset`` marks the spectra as a ring buffer.
    Without a ``plan``, 'pallas' builds one with 64-sample windows."""
    _check_modes(accumulate, math_mode)
    if plan is None:
        with span("bp.plan"):
            plan = make_plan(p, np.asarray(sat_pos), np.asarray(t_slow),
                             float(t_start),
                             w_win=64 if accumulate == "pallas" else 32,
                             factorize=accumulate.startswith("factor"))
    return _backproject(raw, sat_pos, sat_vel, t_slow, vel_focus, p, plan,
                        presum, t_mean=None, compress=True,
                        accumulate=accumulate, fit_stride=fit_stride,
                        math_mode=math_mode, raw_spectra=raw_spectra,
                        ring_offset=ring_offset, device=None, droop=True)
