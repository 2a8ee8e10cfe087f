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

import functools
from typing import NamedTuple

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.ops.csa import CsaFactors, expj
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build

# CPI sides the kernels take. Azimuth: any side in [64, 8192]; powers of
# two up to 4096 run the column pass's own split of n_az over a cluster of
# at most 8 blocks (column_plan), 8192 over 16, and every other side runs
# as a chirp-z transform (Bluestein) on the power-of-two column pass of
# chirpz_length(n_az) points. Range: any side in [64, 16384] whose prime
# factors are in MIXED_PRIMES; powers of two up to 4096 run K2's register
# plan (k2_plan: a block holds 4096 / n_rg whole range lines of one channel,
# one instantiation per n_rg, 34 KB of shared memory), every other side the
# mixed-radix plan (mixed_radices: one range line a block in shared memory)
MIN_N, MAX_DIRECT = 64, 4096
MAX_AZ, MAX_RG = 8192, 16384
MIXED_PRIMES = (2, 3, 5, 7, 11, 13)


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _smooth(n: int) -> bool:
    for p in MIXED_PRIMES:
        while n % p == 0:
            n //= p
    return n == 1


def supported(n_az: int, n_rg: int) -> bool:
    """Shapes the kernels take: n_az any side in [64, 8192], n_rg any side
    in [64, 16384] whose prime factors are 2, 3, 5, 7, 11 or 13."""
    return (MIN_N <= n_az <= MAX_AZ and MIN_N <= n_rg <= MAX_RG
            and _smooth(n_rg))


def family() -> str:
    """The family :func:`supported` takes, in words (for error messages)."""
    return (f"n_az in [{MIN_N}, {MAX_AZ}] and n_rg in [{MIN_N}, {MAX_RG}] "
            f"with prime factors in {MIXED_PRIMES}")


def chirpz(n_az: int) -> bool:
    """True where the azimuth transforms of n_az points run as chirp-z
    transforms (every side that is not a power of two)."""
    return not _pow2(n_az)


def chirpz_length(n: int) -> int:
    """The power-of-two length of the chirp-z transform's circular
    convolution for an n-point DFT: the least one of at least 2 n - 1."""
    return 1 << (2 * n - 2).bit_length()


def column_launches(n_az: int) -> int:
    """Kernel launches of one column-pass call (K1 / K1g, K3 / K3g): the
    chirp-z transform's two stages, else one. The wrappers' ``.launches``
    counters add this."""
    return 2 if chirpz(n_az) else 1


def column_length(n_az: int) -> int:
    """Points of the column pass's transform: n_az, or the chirp-z
    length."""
    return chirpz_length(n_az) if chirpz(n_az) else n_az


def k2_mixed(n_rg: int) -> bool:
    """True where K2 runs the mixed-radix plan (every range side but the
    powers of two up to 4096)."""
    return not (_pow2(n_rg) and n_rg <= MAX_DIRECT)


def mixed_radices(n: int) -> tuple:
    """The mixed-radix plan's passes for an n-point DFT, in the forward
    order: as many 16-point passes as n's factor 2^a holds, then one pass
    of the rest of it (2, 4 or 8), then one pass per odd prime factor,
    largest first. Their product is n."""
    if not _smooth(n):
        raise ValueError(f"mixed_radices: {n} has a prime factor outside "
                         f"{MIXED_PRIMES}")
    a = (n & -n).bit_length() - 1
    radices = [16] * (a // 4) + ([1 << (a % 4)] if a % 4 else [])
    rest = n >> a
    for p in (13, 11, 7, 5, 3):
        while rest % p == 0:
            radices.append(p)
            rest //= p
    return tuple(radices)


def mixed_order(n: int) -> np.ndarray:
    """int32 (n,): the frequency whose value the mixed-radix plan's
    forward transform leaves at each position of the row. The forward
    passes decimate in frequency in place, so pass i's output digit k_i
    goes to position weight n / (R_0 ... R_i) and to frequency weight
    R_0 ... R_(i-1)."""
    return _mixed_order(n).copy()


@functools.lru_cache(maxsize=None)
def _mixed_order(n: int) -> np.ndarray:
    pos = np.zeros(1, np.int64)
    freq = np.zeros(1, np.int64)
    left, below = n, 1
    for r in mixed_radices(n):
        left //= r
        k = np.arange(r)
        pos = (pos[:, None] + k[None, :] * left).ravel()
        freq = (freq[:, None] + k[None, :] * below).ravel()
        below *= r
    order = np.empty(n, np.int32)
    order[pos] = freq
    return order


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
    """K2's register plan at row length ``n_rg`` (a power of two in [64,
    4096]; every other side runs :func:`mixed_radices`): the first pass
    takes 2^(log2 n_rg mod 4) points (16 when that is 0), every later one
    16; a thread holds K2_POINTS points of a row, so n_rg / 16 threads a row
    and K2_THREADS of them a block; each row has a buffer of 17 n_rg / 16
    complex64 slots. The pair runs the same plan on twice the blocks."""
    if n_rg < MIN_N or k2_mixed(n_rg):
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


def column_cluster(n: int) -> int:
    """Blocks a cluster of the column pass of n points (a power of two):
    one block holds up to 512 rows of a column, so n / 512, at least 1
    and at most 16 (8192 over 16 blocks of 512 rows, a chirp-z length of
    16,384 over 16 of 1,024)."""
    return min(16, max(1, n // 512))


def column_plan(n_az: int, n_rg: int, nch: int,
                forward: bool = False) -> ColumnPlan:
    """The plan of the column pass over (n_az, n_rg) planes of ``nch``
    channels: inverse (1: K3, 2: K3g) or ``forward`` (1: K1, 2: K1g). Its
    transform has :func:`column_length` (n_az) points: n_az, or the
    chirp-z length, whose two stages both run on this plan. The cluster
    size and split depend on that length alone, so the one- and
    two-channel kernels split the transform alike and K3 gives K3g's s1
    bits, K1 K1g's z1: one block holds up to 512 rows of a column, 1,024
    at the chirp-z length 16,384. The tile is as wide as gives pass A one
    task a thread over the channels (nch x QB x cols = 256), never under
    8 columns (one 32-byte sector of each plane's row segment); a last
    tile past n_rg is cut at the edge. At 4096 x 4096 that is 16 columns
    for K1 and K3, 8 for K1g and K3g, in clusters of 8 blocks of 68 KB
    (K1, K3), 70 KB (K1g) and 93 KB (K3g), two blocks an SM: for K3 / K3g
    the fastest of the plans timed on the H100
    (scripts/probe_torch_column_plan.py)."""
    if not supported(n_az, n_rg):
        raise ValueError(f"column_plan: shape {(n_az, n_rg)} not supported")
    n = column_length(n_az)
    cluster = column_cluster(n)
    qb = column_split(n, cluster)[1]
    cols = min(n_rg, max(8, COLUMN_THREADS // (nch * qb)))
    return ColumnPlan(cols, cluster,
                      column_smem(n, cols, cluster, nch, forward))


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


def full_twiddle_table(n: int, device=None) -> torch.Tensor:
    """exp(-2 pi i k / n) for k < n: float64 on the host, then complex64
    (the mixed-radix plan's table: n need not be even)."""
    tw = np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64)
    return torch.from_numpy(tw).to(device=device)


class MixedRadix(NamedTuple):
    """K2's tables at a mixed-radix n_rg: the full n-point twiddle table,
    the plan's frequency at each position of a row (:func:`mixed_order`)
    and the plan's radices in the forward order (:func:`mixed_radices`),
    both int32. The kernel runs the passes these radices name, so the
    order and the passes come from the one rule."""
    twiddles: torch.Tensor
    order: torch.Tensor
    radices: torch.Tensor


class ChirpZ(NamedTuple):
    """The column pass's tables for a chirp-z DFT of n points on m =
    :func:`chirpz_length` (n) points: ``tw`` the m-point twiddle table,
    and for the forward DFT (``fwd_*``) and the inverse with its 1/n
    (``inv_*``) the chirp (n,) and the spectrum of the convolution's
    kernel (m,), complex64. Forward: X[k] = c[k] (1/m) IDFT_m(DFT_m(c x)
    H)[k] with c[k] = exp(-j pi k^2 / n) and H the DFT of exp(j pi j^2 /
    n) for |j| < n, wrapped into m; the inverse conjugates c and H and
    scales H by 1/n."""
    tw: torch.Tensor
    fwd_chirp: torch.Tensor
    fwd_spec: torch.Tensor
    inv_chirp: torch.Tensor
    inv_spec: torch.Tensor


def chirpz_tables(n: int, device=None) -> ChirpZ:
    """The :class:`ChirpZ` tables of an n-point azimuth DFT: the chirp
    from k^2 mod 2n (exact in int64), then float64, the spectra by
    float64 FFT; each rounded once to complex64 (on the host once per
    n, then copied to ``device``)."""
    return ChirpZ(twiddle_table(chirpz_length(n), device),
                  *(t.to(device=device, copy=True)
                    for t in _chirpz_host(n)))


@functools.lru_cache(maxsize=None)
def _chirpz_host(n: int) -> tuple:
    m = chirpz_length(n)
    k = np.arange(n, dtype=np.int64)
    c = np.exp(-1j * np.pi * ((k * k) % (2 * n)) / n)
    h = np.zeros(m, np.complex128)
    h[:n] = np.conj(c)
    h[m - n + 1:] = np.conj(c[1:])[::-1]
    return tuple(torch.from_numpy(v.astype(np.complex64))
                 for v in (c, np.fft.fft(h), np.conj(c),
                           np.fft.fft(np.conj(h)) / n))


def azimuth_tables(n_az: int, device=None):
    """What the column pass reads for n_az-point azimuth transforms: the
    n_az-point :func:`twiddle_table` at a power of two, else the
    :class:`ChirpZ` tables."""
    return chirpz_tables(n_az, device) if chirpz(n_az) else \
        twiddle_table(n_az, device)


def range_tables(n_rg: int, device=None):
    """What K2 reads for n_rg-point range transforms: the n_rg-point
    :func:`twiddle_table` for its register plan, else the
    :class:`MixedRadix` tables."""
    if not k2_mixed(n_rg):
        return twiddle_table(n_rg, device)
    return MixedRadix(full_twiddle_table(n_rg, device),
                      torch.from_numpy(mixed_order(n_rg)).to(device=device),
                      torch.tensor(mixed_radices(n_rg), dtype=torch.int32,
                                   device=device))


def _check_table(name: str, t, shape, dtype, device) -> None:
    if (not isinstance(t, torch.Tensor) or t.dtype != dtype
            or t.shape != shape or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name}: twiddles must hold contiguous {dtype} "
                         f"tables of shape {shape} on {device}")


def azimuth_tables_for(name: str, twiddles, n_az: int, device):
    """``twiddles`` checked as :func:`azimuth_tables` (n_az) on
    ``device``, or new tables when None."""
    if twiddles is None:
        return azimuth_tables(n_az, device)
    if not chirpz(n_az):
        return twiddles_for(name, twiddles, n_az, device)
    if not isinstance(twiddles, ChirpZ):
        raise ValueError(f"{name}: n_az {n_az} needs the ChirpZ tables")
    m = chirpz_length(n_az)
    for t, shape in zip(twiddles, ((m // 2,), (n_az,), (m,), (n_az,),
                                   (m,))):
        _check_table(name, t, shape, torch.complex64, device)
    return twiddles


def range_tables_for(name: str, twiddles, n_rg: int, device):
    """``twiddles`` checked as :func:`range_tables` (n_rg) on ``device``,
    or new tables when None."""
    if twiddles is None:
        return range_tables(n_rg, device)
    if not k2_mixed(n_rg):
        return twiddles_for(name, twiddles, n_rg, device)
    if not isinstance(twiddles, MixedRadix):
        raise ValueError(f"{name}: n_rg {n_rg} needs the MixedRadix tables")
    _check_table(name, twiddles.twiddles, (n_rg,), torch.complex64, device)
    _check_table(name, twiddles.order, (n_rg,), torch.int32, device)
    _check_table(name, twiddles.radices, (len(mixed_radices(n_rg)),),
                 torch.int32, device)
    return twiddles


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
    """Checks the planes and factors of a K2 launch; returns (the launcher's
    name suffix, the factor tensors and tables in the launcher's order, its
    ints): '', the twiddle table and (n_az, n_rg) for the register plan;
    '_mixed', the full table, the order and the radices and (n_az, n_rg,
    passes) for the mixed-radix plan."""
    n_az, n_rg = plane_shape(name, planes[0])
    dev = planes[0].device
    _build.check(name, planes, (n_az, n_rg), dev)
    usq = f.u * f.u
    _build.check(name, (f.fr, f.cphase, f.dr, usq), (n_rg,), dev)
    _build.check(name, (f.alpha, f.beta, f.rphase, f.g, f.c3), (n_az,), dev)
    tab = range_tables_for(name, twiddles, n_rg, dev)
    fac = (f.fr, f.alpha, f.beta, f.cphase, f.dr, usq, f.rphase, f.g, f.c3)
    if k2_mixed(n_rg):
        return "_mixed", (*fac, *tab), (n_az, n_rg, tab.radices.numel())
    return "", (*fac, tab), (n_az, n_rg)


def k2_pair_call(x1r, x1i, x2r, x2i, f: CsaFactors, *, twiddles=None):
    """K2 for both channels: per azimuth row, range FFT -> x Phi2 -> range
    IFFT (1/N) -> x Phi3; :func:`k2_call`'s kernel on twice the blocks, one
    channel a block (:func:`k2_plan`, or the mixed-radix plan of
    :func:`mixed_radices`).

    (n_az, n_rg) float32 planes in, four planes out. ``twiddles``: the
    :func:`range_tables` of n_rg (built when None). CPU tensors run
    :func:`k2_pair_plain`; CUDA tensors launch the kernel."""
    if _build.on_cpu(x1r):
        return k2_pair_plain(x1r, x1i, x2r, x2i, f)
    planes = (x1r, x1i, x2r, x2i)
    plan, fac, ints = _k2_args("k2_pair_call", planes, f, twiddles)
    out = [torch.empty_like(x1r) for _ in range(4)]
    _build.launch(f"k2_pair{plan}_launch", (*planes, *fac, *out), ints)
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
    :func:`range_tables` of n_rg (built when None)."""
    if _build.on_cpu(xr):
        return k2_plain(xr, xi, f)
    plan, fac, ints = _k2_args("k2_call", (xr, xi), f, twiddles)
    out = [torch.empty_like(xr) for _ in range(2)]
    _build.launch(f"k2{plan}_launch", (xr, xi, *fac, *out), ints)
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


def chirpz_planes(n_az: int, n_rg: int, nch: int, device):
    """The (m, n_rg) float32 planes between the chirp-z stages, two a
    channel (m = :func:`chirpz_length` (n_az))."""
    m = chirpz_length(n_az)
    return [torch.empty((m, n_rg), dtype=torch.float32, device=device)
            for _ in range(2 * nch)]


def chirpz_args(tables: ChirpZ, inverse: bool):
    """(m-point table, chirp, spectrum) of a chirp-z launch's direction."""
    if inverse:
        return tables.tw, tables.inv_chirp, tables.inv_spec
    return tables.tw, tables.fwd_chirp, tables.fwd_spec


def k1_call(xr, xi, f: CsaFactors, *, twiddles=None):
    """Azimuth FFT of one channel times Phi1 = exp(j c1(a) (u(r) - w(a))^2),
    Phi1 on natural azimuth frequencies: the forward column pass on tiles of
    adjacent columns (:func:`column_plan` with ``forward``), K1g's for one
    channel on the same split of n_az, so its result is K1g's for that
    channel bit for bit. At an n_az that is not a power of two, the
    chirp-z transform: two launches through (m, n_rg) planes.

    (n_az, n_rg) float32 planes in, two planes out. ``twiddles``: the
    :func:`azimuth_tables` of n_az (built when None)."""
    if _build.on_cpu(xr):
        return k1_plain(xr, xi, f)
    n_az, n_rg = plane_shape("k1_call", xr)
    dev = xr.device
    _build.check("k1_call", (xr, xi), (n_az, n_rg), dev)
    _build.check("k1_call", (f.u,), (n_rg,), dev)
    _build.check("k1_call", (f.c1, f.w), (n_az,), dev)
    tab = azimuth_tables_for("k1_call", twiddles, n_az, dev)
    out = [torch.empty_like(xr) for _ in range(2)]
    plan = column_plan(n_az, n_rg, 1, forward=True)
    if chirpz(n_az):
        _build.launch("k1_chirpz_launch",
                      (xr, xi, f.u, f.c1, f.w, *chirpz_args(tab, False),
                       *chirpz_planes(n_az, n_rg, 1, dev), *out),
                      (n_az, chirpz_length(n_az), n_rg, *plan))
    else:
        _build.launch("k1_launch", (xr, xi, f.u, f.c1, f.w, tab, *out),
                      (n_az, n_rg, *plan))
    k1_call.launches += column_launches(n_az)
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
    SLC for that channel bit for bit; the chirp-z transform at an n_az that
    is not a power of two.

    (n_az, n_rg) float32 planes in, two planes out: new ones, or ``out``, a
    pair of contiguous planes of that shape to write (and return).
    ``twiddles``: the :func:`azimuth_tables` of n_az (built when None)."""
    if _build.on_cpu(xr):
        return k3_plain(xr, xi, out=out)
    n_az, n_rg = plane_shape("k3_call", xr)
    dev = xr.device
    _build.check("k3_call", (xr, xi), (n_az, n_rg), dev)
    tab = azimuth_tables_for("k3_call", twiddles, n_az, dev)
    if out is None:
        out = [torch.empty_like(xr) for _ in range(2)]
    else:
        _build.check("k3_call", out, (n_az, n_rg), dev)
    plan = column_plan(n_az, n_rg, 1)
    if chirpz(n_az):
        _build.launch("k3_chirpz_launch",
                      (xr, xi, *chirpz_args(tab, True),
                       *chirpz_planes(n_az, n_rg, 1, dev), *out),
                      (n_az, chirpz_length(n_az), n_rg, *plan))
    else:
        _build.launch("k3_launch", (xr, xi, tab, *out), (n_az, n_rg, *plan))
    k3_call.launches += column_launches(n_az)
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
        raise ValueError(f"apply_csa_pallas needs {family()}, got "
                         f"{(n_az, n_rg)}")
    lead = xr.shape[:-2]
    xr = xr.reshape(-1, n_az, n_rg).contiguous()
    xi = xi.reshape(-1, n_az, n_rg).contiguous()
    dev = xr.device
    tw_az, tw_rg = azimuth_tables(n_az, dev), range_tables(n_rg, dev)
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
