"""CSA focusing in three kernels: K1, K2 (one channel or the GMTI pair), K3.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/pallas/csa_kernel.py``
(``supported``, ``_k1_call``, ``_k2_call``, ``_k3_call``, ``k2_pair_call``,
``apply_csa_pallas_planes``, ``apply_csa_pallas``):

    K1   azimuth FFT x Phi1                      (csrc/gmti_kernel.cu, the
                                                  column pass forward, K1g's
                                                  for one channel)
    K2   range FFT -> Phi2 -> range IFFT -> Phi3 (csrc/csa_kernel.cu)
    K3   azimuth IFFT (1/N)                      (csrc/gmti_kernel.cu, the
                                                  column pass inverse, K3g's
                                                  for one channel)

Beside each wrapper is its plain PyTorch version (``*_plain``, same
signature and return tuple), which the wrapper runs for CPU tensors; for
CUDA tensors it launches the kernel or raises. The kernels write new
tensors and never the caller's inputs. The reference's TPU knobs (``mode``,
``k2_variant``, ``lead_variant``, ``k2_rows``) are layout and precision
twins of the same function and have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.ops.csa import CsaFactors, expj
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build

# CPI sides the kernels take: powers of two in the range they were checked
# at; a K2 block holds 4096 / n_rg whole range lines of one channel (one
# instantiation per n_rg, 34 KB of shared memory, k2_plan), the column
# passes (K1, K3 and their pairs) split n_az over a cluster of at most 8
# blocks (column_plan)
MIN_N, MAX_N = 64, 4096


def supported(n_az: int, n_rg: int) -> bool:
    """Shapes the kernels take: both axes powers of two in [64, 4096]."""
    return all(MIN_N <= n <= MAX_N and n & (n - 1) == 0
               for n in (n_az, n_rg))


# K2's block (csrc/csa_kernel.cu, K2Plan<N>): threads, points a thread
# holds, blocks an SM, and the slots of a row's transpose buffer per point
# of the row (17 / 16)
K2_THREADS, K2_POINTS, K2_BLOCKS_PER_SM = 256, 16, 3


class K2Plan(NamedTuple):
    """Launch plan of K2 at one n_rg: the passes' DFT sizes in order (their
    product n_rg), ``rows`` range lines a block of ``threads`` threads,
    ``smem`` bytes of shared memory a block, ``blocks_per_sm``."""
    radices: tuple
    rows: int
    threads: int
    smem: int
    blocks_per_sm: int


def k2_plan(n_rg: int) -> K2Plan:
    """K2's plan at row length ``n_rg`` (a supported side): the first pass
    takes 2^(log2 n_rg mod 4) points (16 when that is 0), every later one
    16; a thread holds K2_POINTS points of a row, so n_rg / 16 threads a row
    and K2_THREADS of them a block; each row has a buffer of 17 n_rg / 16
    complex64 slots. The pair runs the same plan on twice the blocks."""
    if not supported(MIN_N, n_rg):
        raise ValueError(f"k2_plan: n_rg {n_rg} not supported")
    log = n_rg.bit_length() - 1
    r1 = 1 << (log % 4) if log % 4 else 16
    radices = (r1,) + (16,) * ((log - (r1.bit_length() - 1)) // 4)
    rows = K2_THREADS // (n_rg // K2_POINTS)
    return K2Plan(radices, rows, K2_THREADS, rows * (17 * n_rg // 16) * 8,
                  K2_BLOCKS_PER_SM)


# Threads a block of the column pass (K1 / K1g, K3 / K3g), and halo rows
# K3g keeps on either side of a chunk of its power (csrc/gmti_kernel.cu,
# kColThreads and kHalo)
COLUMN_THREADS, COLUMN_HALO = 256, 16


class ColumnPlan(NamedTuple):
    """Launch plan of the column pass (K1 / K1g forward, K3 / K3g inverse):
    ``cols`` adjacent range columns a tile, one tile a cluster of
    ``cluster`` blocks, ``smem`` bytes of dynamic shared memory a block."""
    cols: int
    cluster: int
    smem: int


def column_split(n_az: int, cluster: int):
    """(QA, QB) of the split n_az = cluster * QA * QB: QA = 2^ceil(l / 2),
    QB = 2^floor(l / 2) for l = log2(n_az / cluster)."""
    q = n_az // cluster
    qb = 1 << ((q.bit_length() - 1) // 2)
    return q // qb, qb


def column_smem(n_az: int, cols: int, cluster: int, nch: int,
                forward: bool = False) -> int:
    """Shared-memory bytes a block of the plan takes (the launchers compute
    the same and refuse a plan that disagrees): per channel (Q + QB) x cols
    complex64 slots; K1g (``forward``) adds one complex64 sum a thread and
    ``cluster`` x cols of block sums; K3g its Q x cols power slots, 2
    COLUMN_HALO x cols halo slots for each of its ``cluster`` chunks and one
    float32 a thread."""
    q = n_az // cluster
    n = nch * (q + column_split(n_az, cluster)[1]) * cols * 8
    if nch == 2 and forward:
        n += (COLUMN_THREADS + cluster * cols) * 8
    elif nch == 2:
        n += ((q + 2 * COLUMN_HALO * cluster) * cols + COLUMN_THREADS) * 4
    return n


def column_plan(n_az: int, n_rg: int, nch: int,
                forward: bool = False) -> ColumnPlan:
    """The plan of the column pass over (n_az, n_rg) planes of ``nch``
    channels: inverse (1: K3, 2: K3g) or ``forward`` (1: K1, 2: K1g). The
    cluster size and split depend on n_az alone, so the one- and
    two-channel kernels split the transform alike and K3 gives K3g's s1
    bits, K1 K1g's z1: one block holds up to 512 rows of a column. The tile
    is as wide as gives pass A one task a thread over the channels (nch x
    QB x cols = 256), never under 8 columns (one 32-byte sector of each
    plane's row segment). At 4096 x 4096 that is 16 columns for K1 and K3,
    8 for K1g and K3g, in clusters of 8 blocks of 68 KB (K1, K3), 70 KB
    (K1g) and 93 KB (K3g), two blocks an SM: for K3 / K3g the fastest of the
    plans timed on the H100 (scripts/probe_torch_column_plan.py)."""
    if not supported(n_az, n_rg):
        raise ValueError(f"column_plan: shape {(n_az, n_rg)} not supported")
    cluster = max(1, n_az // 512)
    qb = column_split(n_az, cluster)[1]
    cols = min(n_rg, max(8, COLUMN_THREADS // (nch * qb)))
    return ColumnPlan(cols, cluster,
                      column_smem(n_az, cols, cluster, nch, forward))


def plane_shape(name: str, x: torch.Tensor):
    """(n_az, n_rg) of a plane the kernels take; raises otherwise."""
    if x.dim() != 2:
        raise ValueError(f"{name}: needs (n_az, n_rg) planes, got shape "
                         f"{tuple(x.shape)}")
    n_az, n_rg = x.shape
    if not supported(n_az, n_rg):
        raise ValueError(f"{name}: shape {(n_az, n_rg)} not supported")
    return n_az, n_rg


def twiddle_table(n: int, device=None) -> torch.Tensor:
    """exp(-2 pi i k / n) for k < n/2: float64 on the host, then complex64
    (the kernels read it as float2)."""
    k = np.arange(n // 2)
    tw = np.exp(-2j * np.pi * k / n).astype(np.complex64)
    return torch.from_numpy(tw).to(device=device)


def twiddles_for(name: str, twiddles, n: int, device) -> torch.Tensor:
    """``twiddles`` checked as the n-point table on ``device``, or a new
    table when None."""
    if twiddles is None:
        return twiddle_table(n, device)
    if (twiddles.dtype != torch.complex64 or twiddles.shape != (n // 2,)
            or twiddles.device != device or not twiddles.is_contiguous()):
        raise ValueError(f"{name}: twiddles must be the contiguous "
                         f"complex64 ({n // 2},) table on {device}")
    return twiddles


def _k2_phases(f: CsaFactors):
    """(Phi2, Phi3) as complex64 (n_az, n_rg) grids: the plain versions'
    form of the phases K2 evaluates inline."""
    ph2 = (f.alpha[:, None] * f.fr[None, :] + f.beta[:, None]) \
        * f.fr[None, :]
    ph3 = f.rphase[:, None] + f.cphase[None, :] \
        + f.g[:, None] * f.dr[None, :] - f.c3[:, None] * (f.u * f.u)[None, :]
    return expj(ph2), expj(ph3)


def _range_pass(xr, xi, phi2, phi3):
    s = torch.fft.fft(torch.complex(xr, xi), dim=-1) * phi2
    s = torch.fft.ifft(s, dim=-1) * phi3
    return s.real.contiguous(), s.imag.contiguous()


def k2_pair_plain(x1r, x1i, x2r, x2i, f: CsaFactors, *, twiddles=None):
    """Plain version of :func:`k2_pair_call` (torch.fft; ``twiddles`` is
    accepted for the same signature and unused)."""
    phi2, phi3 = _k2_phases(f)
    return (*_range_pass(x1r, x1i, phi2, phi3),
            *_range_pass(x2r, x2i, phi2, phi3))


def _k2_args(name, planes, f: CsaFactors, twiddles):
    """Checks the planes and factors of a K2 launch; returns (n_az, n_rg,
    the factor tensors in the launcher's order, the twiddle table)."""
    n_az, n_rg = plane_shape(name, planes[0])
    dev = planes[0].device
    _build.check(name, planes, (n_az, n_rg), dev)
    usq = f.u * f.u
    _build.check(name, (f.fr, f.cphase, f.dr, usq), (n_rg,), dev)
    _build.check(name, (f.alpha, f.beta, f.rphase, f.g, f.c3), (n_az,), dev)
    tw = twiddles_for(name, twiddles, n_rg, dev)
    return n_az, n_rg, (f.fr, f.alpha, f.beta, f.cphase, f.dr, usq, f.rphase,
                        f.g, f.c3, tw)


def k2_pair_call(x1r, x1i, x2r, x2i, f: CsaFactors, *, twiddles=None):
    """K2 for both channels: per azimuth row, range FFT -> x Phi2 -> range
    IFFT (1/N) -> x Phi3; :func:`k2_call`'s kernel on twice the blocks, one
    channel a block (:func:`k2_plan`).

    (n_az, n_rg) float32 planes in, four planes out. ``twiddles``: the
    n_rg-point table of :func:`twiddle_table` (built when None). CPU tensors
    run :func:`k2_pair_plain`; CUDA tensors launch the kernel."""
    if _build.on_cpu(x1r):
        return k2_pair_plain(x1r, x1i, x2r, x2i, f)
    planes = (x1r, x1i, x2r, x2i)
    n_az, n_rg, fac = _k2_args("k2_pair_call", planes, f, twiddles)
    out = [torch.empty_like(x1r) for _ in range(4)]
    _build.launch("k2_pair_launch", (*planes, *fac, *out), (n_az, n_rg))
    k2_pair_call.launches += 1
    return tuple(out)


k2_pair_call.launches = 0


def k2_plain(xr, xi, f: CsaFactors, *, twiddles=None):
    """Plain version of :func:`k2_call`."""
    return _range_pass(xr, xi, *_k2_phases(f))


def k2_call(xr, xi, f: CsaFactors, *, twiddles=None):
    """K2 for one channel: :func:`k2_pair_call`'s kernel on one channel's
    blocks, so its result is the pair's for that channel bit for bit.

    (n_az, n_rg) float32 planes in, two planes out. ``twiddles``: the
    n_rg-point table (built when None)."""
    if _build.on_cpu(xr):
        return k2_plain(xr, xi, f)
    n_az, n_rg, fac = _k2_args("k2_call", (xr, xi), f, twiddles)
    out = [torch.empty_like(xr) for _ in range(2)]
    _build.launch("k2_launch", (xr, xi, *fac, *out), (n_az, n_rg))
    k2_call.launches += 1
    return tuple(out)


k2_call.launches = 0


# --------------------------------------------------------------------------
# K1 and K3: the single-channel azimuth passes
# --------------------------------------------------------------------------

def k1_plain(xr, xi, f: CsaFactors, *, twiddles=None):
    """Plain version of :func:`k1_call`."""
    du = f.u[None, :] - f.w[:, None]
    z = torch.fft.fft(torch.complex(xr, xi), dim=0) \
        * expj(f.c1[:, None] * du * du)
    return z.real.contiguous(), z.imag.contiguous()


def k1_call(xr, xi, f: CsaFactors, *, twiddles=None):
    """Azimuth FFT of one channel times Phi1 = exp(j c1(a) (u(r) - w(a))^2),
    Phi1 on natural azimuth frequencies: the forward column pass on tiles of
    adjacent columns (:func:`column_plan` with ``forward``), K1g's for one
    channel on the same split of n_az, so its result is K1g's for that
    channel bit for bit.

    (n_az, n_rg) float32 planes in, two planes out. ``twiddles``: the
    n_az-point table (built when None)."""
    if _build.on_cpu(xr):
        return k1_plain(xr, xi, f)
    n_az, n_rg = plane_shape("k1_call", xr)
    dev = xr.device
    _build.check("k1_call", (xr, xi), (n_az, n_rg), dev)
    _build.check("k1_call", (f.u,), (n_rg,), dev)
    _build.check("k1_call", (f.c1, f.w), (n_az,), dev)
    tw = twiddles_for("k1_call", twiddles, n_az, dev)
    out = [torch.empty_like(xr) for _ in range(2)]
    _build.launch("k1_launch", (xr, xi, f.u, f.c1, f.w, tw, *out),
                  (n_az, n_rg, *column_plan(n_az, n_rg, 1, forward=True)))
    k1_call.launches += 1
    return tuple(out)


k1_call.launches = 0


def k3_plain(xr, xi, *, twiddles=None, out=None):
    """Plain version of :func:`k3_call`."""
    s = torch.fft.ifft(torch.complex(xr, xi), dim=0)
    if out is None:
        return s.real.contiguous(), s.imag.contiguous()
    out[0].copy_(s.real)
    out[1].copy_(s.imag)
    return tuple(out)


def k3_call(xr, xi, *, twiddles=None, out=None):
    """Inverse azimuth FFT (1/N) of one channel: K3g's column pass (the same
    transform on the same :func:`column_plan` split), so its result is K3g's
    SLC for that channel bit for bit.

    (n_az, n_rg) float32 planes in, two planes out: new ones, or ``out``, a
    pair of contiguous planes of that shape to write (and return).
    ``twiddles``: the n_az-point table (built when None)."""
    if _build.on_cpu(xr):
        return k3_plain(xr, xi, out=out)
    n_az, n_rg = plane_shape("k3_call", xr)
    dev = xr.device
    _build.check("k3_call", (xr, xi), (n_az, n_rg), dev)
    tw = twiddles_for("k3_call", twiddles, n_az, dev)
    if out is None:
        out = [torch.empty_like(xr) for _ in range(2)]
    else:
        _build.check("k3_call", out, (n_az, n_rg), dev)
    _build.launch("k3_launch", (xr, xi, tw, *out),
                  (n_az, n_rg, *column_plan(n_az, n_rg, 1)))
    k3_call.launches += 1
    return tuple(out)


k3_call.launches = 0


# --------------------------------------------------------------------------
# public entries
# --------------------------------------------------------------------------

def apply_csa_pallas_planes(xr, xi, f: CsaFactors):
    """Planes-native CSA: re/im float32 (..., n_az, n_rg) raw -> re/im SLC,
    K1 -> K2 -> K3 per plane, the twiddle tables built once per call. This
    is the hot entry (the formation-only stream holds planes end to end).

    Raises ValueError at shapes the kernels do not take (:func:`supported`)
    on every device; ``ops/csa.py::apply_csa_fused`` routes those."""
    n_az, n_rg = xr.shape[-2], xr.shape[-1]
    if not supported(n_az, n_rg):
        raise ValueError(f"apply_csa_pallas needs power-of-two sides in "
                         f"[{MIN_N}, {MAX_N}], got {(n_az, n_rg)}")
    lead = xr.shape[:-2]
    xr = xr.reshape(-1, n_az, n_rg).contiguous()
    xi = xi.reshape(-1, n_az, n_rg).contiguous()
    dev = xr.device
    tw_az, tw_rg = twiddle_table(n_az, dev), twiddle_table(n_rg, dev)
    # K3 writes each SLC plane straight into its slot of the batch
    out_r, out_i = torch.empty_like(xr), torch.empty_like(xi)
    for zr, zi, sr, si in zip(xr, xi, out_r, out_i):
        zr, zi = k1_call(zr, zi, f, twiddles=tw_az)
        zr, zi = k2_call(zr, zi, f, twiddles=tw_rg)
        k3_call(zr, zi, twiddles=tw_az, out=(sr, si))
    return (out_r.reshape(lead + (n_az, n_rg)),
            out_i.reshape(lead + (n_az, n_rg)))


def apply_csa_pallas(phist, f: CsaFactors):
    """(..., n_az, n_rg) complex64 raw -> SLC through the three kernels:
    the same math as ``ops/csa.py::apply_csa_fused`` to f32 rounding.
    Splits into contiguous planes and recombines; callers that hold planes
    should use :func:`apply_csa_pallas_planes`."""
    our, oui = apply_csa_pallas_planes(phist.real, phist.imag, f)
    return torch.complex(our, oui)
