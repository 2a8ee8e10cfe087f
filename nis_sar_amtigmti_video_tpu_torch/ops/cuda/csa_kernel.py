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

Which transform runs a CPI axis is one plan object a side,
:func:`azimuth_plan` (the direct column pass, a prime-factor split of the
side's own length, or a chirp-z transform) and :func:`range_plan` (K2's
register or mixed-radix plan): the wrappers here
and in ``gmti_kernel.py`` take it as ``plan=`` and hand its tables to one C
launcher a kernel, which picks the dispatch from them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.ops.csa import CsaFactors, expj
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import count, span

# CPI sides the kernels take. Azimuth: any side in [64, 8192]; powers of
# two up to 4096 run the column pass's own split of n_az over a cluster of
# at most 8 blocks (column_plan), 8192 over 16; a side that factored_split
# takes runs as a prime-factor transform of its own length; every other
# side runs as a chirp-z transform (Bluestein) on the power-of-two column
# pass of chirpz_length(n_az) points. Range: any side in [64, 16384] whose
# prime factors are in MIXED_PRIMES; powers of two up to 4096 run K2's register
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
    transforms (every side that is neither a power of two nor taken by
    :func:`factored_split`)."""
    return not _pow2(n_az) and factored_split(n_az) is None


def _prime(n: int) -> bool:
    return n > 1 and all(n % d for d in range(2, int(n ** 0.5) + 1))


# The factored kind's legs (csrc/gmti_kernel.cu, STAGE kFactored): the
# outer leg runs in one thread's registers across the cluster, so the kernel
# is built for each of these lengths; the local leg runs in the block
FACTORED_OUTER = (32, 16, 8, 23)
FACTORED_CLUSTER = 8


@functools.lru_cache(maxsize=None)
def factored_split(n: int):
    """(n1, n2) where the azimuth transforms of n points run as a
    prime-factor (Good-Thomas) transform of n = n1 x n2, else None.

    The rule: n is not a power of two, and n1 is the first of
    FACTORED_OUTER (32, 16, 8, 23) that divides n with n2 = n / n1
    coprime to it, at least 2, and either smooth (its prime factors in
    MIXED_PRIMES: the local passes' radices) or a prime whose n2 - 1 is
    smooth (Rader's convolution on n2 - 1 points). 7,199 = 23 x 313 (Rader
    on 312 = 8 x 13 x 3) and 7,200 = 32 x 225 (15 x 15) take it; primes
    such as 7,193 and 8,191 do not, nor 4,097 = 17 x 241 (17 is no outer
    leg), and keep the chirp-z kind."""
    if _pow2(n):
        return None
    for n1 in FACTORED_OUTER:
        n2 = n // n1
        if (n % n1 == 0 and n2 >= 2 and math.gcd(n1, n2) == 1
                and (_smooth(n2) or (_prime(n2) and _smooth(n2 - 1)))):
            return n1, n2
    return None


def local_radices(n: int) -> tuple:
    """The factored kind's local passes for an n-point DFT (n smooth), in
    the forward order: :func:`mixed_radices`' powers of two, then its odd
    primes, largest first, each merged with the smallest primes left while
    the product stays at most 15 (225 = 15 x 15, 312 = 8 x 13 x 3). Their
    product is n."""
    radices = [r for r in mixed_radices(n) if r % 2 == 0]
    odd = sorted((r for r in mixed_radices(n) if r % 2), reverse=True)
    while odd:
        r = odd.pop(0)
        while odd and r * odd[-1] <= 15:
            r *= odd.pop()
        radices.append(r)
    return tuple(radices)


def chirpz_length(n: int) -> int:
    """The power-of-two length of the chirp-z transform's circular
    convolution for an n-point DFT: the least one of at least 2 n - 1."""
    return 1 << (2 * n - 2).bit_length()


def column_length(n_az: int) -> int:
    """Points of the column pass's transform: n_az (a power of two or a
    factored side), or the chirp-z length."""
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
    return digit_order(mixed_radices(n))


def digit_order(radices) -> np.ndarray:
    """int32: the frequency at each position of a row after the in-place
    forward passes of these radices (decimation in frequency), as
    :func:`mixed_order`."""
    n = int(np.prod(radices))
    pos = np.zeros(1, np.int64)
    freq = np.zeros(1, np.int64)
    left, below = n, 1
    for r in radices:
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
# kColThreads and kHalo); threads a block of the factored two-channel
# kernels (kFacPairThreads)
COLUMN_THREADS, COLUMN_HALO = 256, 16
FACTORED_PAIR_THREADS = 2 * COLUMN_THREADS


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
                forward: bool = False, threads: int = COLUMN_THREADS) -> int:
    """Shared-memory bytes a block of ``threads`` threads takes (the
    launchers compute the same and refuse a plan that disagrees): per
    channel (Q + QB) x cols complex64 slots; K1g (``forward``) adds one
    complex64 sum a thread and ``cluster`` x cols of block sums; K3g its Q
    x cols power slots, 2 COLUMN_HALO x cols halo slots for each of its
    ``cluster`` chunks and one float32 a thread."""
    q = n_az // cluster
    n = nch * (q + column_split(n_az, cluster)[1]) * cols * 8
    if nch == 2 and forward:
        n += (threads + cluster * cols) * 8
    elif nch == 2:
        n += ((q + 2 * COLUMN_HALO * cluster) * cols + threads) * 4
    return n


def factored_smem(n: int, cols: int, nch: int, forward: bool = False,
                  threads: int = COLUMN_THREADS) -> int:
    """Shared-memory bytes a block of the factored kind takes at n =
    n1 x n2 (:func:`factored_split`; the launchers compute the same): per
    channel u x n2 x cols complex64 slots, u = ceil(n1 / FACTORED_CLUSTER)
    local sequences; K1g (``forward``) adds one complex64 sum a thread and
    FACTORED_CLUSTER x cols of block sums; K3g the power of n1 chunks of
    ceil(n2 / FACTORED_CLUSTER) rows, each with 2 COLUMN_HALO halo slots,
    a column, and one float32 a thread."""
    n1, n2 = factored_split(n)
    cs = FACTORED_CLUSTER
    b = nch * -(-n1 // cs) * n2 * cols * 8
    if nch == 2 and forward:
        b += (threads + cs * cols) * 8
    elif nch == 2:
        b += (n1 * (-(-n2 // cs) + 2 * COLUMN_HALO) * cols + threads) * 4
    return b


def column_cluster(n: int) -> int:
    """Blocks a cluster of the column pass of n points (a power of two):
    one block holds up to 512 rows of a column, so n / 512, at least 1
    and at most 16 (8192 over 16 blocks of 512 rows, a chirp-z length of
    16,384 over 16 of 1,024)."""
    return min(16, max(1, n // 512))


def column_threads(n_az: int, nch: int = 1) -> int:
    """Threads a block of the column pass over n_az points and ``nch``
    channels: COLUMN_THREADS, or twice that for a chirp-z transform on
    clusters of 16 blocks (one block an SM, whose transforms wait on
    latency; csrc/gmti_kernel.cu, column_threads), or
    FACTORED_PAIR_THREADS for the factored two-channel kernels."""
    if factored_split(n_az):
        return FACTORED_PAIR_THREADS if nch == 2 else COLUMN_THREADS
    wide = chirpz(n_az) and column_cluster(column_length(n_az)) > 8
    return 2 * COLUMN_THREADS if wide else COLUMN_THREADS


def column_plan(n_az: int, n_rg: int, nch: int,
                forward: bool = False) -> ColumnPlan:
    """The plan of the column pass over (n_az, n_rg) planes of ``nch``
    channels: inverse (1: K3, 2: K3g) or ``forward`` (1: K1, 2: K1g). Its
    transform has :func:`column_length` (n_az) points: n_az, or the
    chirp-z length, whose one launch runs on this plan. The cluster
    size and split depend on that length alone, so the one- and
    two-channel kernels split the transform alike and K3 gives K3g's s1
    bits, K1 K1g's z1: one block holds up to 512 rows of a column, 1,024
    at the chirp-z length 16,384. The tile is as wide as gives pass A one
    task a thread over the channels (nch x QB x cols = the block's
    :func:`column_threads`), never under 8 columns (one 32-byte sector of
    each plane's row segment); a last tile past n_rg is cut at the edge.
    A factored side (:func:`factored_split`) takes tiles of 8 columns on
    clusters of FACTORED_CLUSTER blocks of COLUMN_THREADS threads
    (:func:`factored_smem`: at 7,199 rows 59 KB for K1 and K3, 122 KB for
    K1g, 171 KB for K3g, whose blocks take FACTORED_PAIR_THREADS). At
    4096 x 4096 it is 16 columns
    for K1 and K3, 8 for K1g and K3g, in clusters of 8 blocks of 68 KB
    (K1, K3), 70 KB (K1g) and 93 KB (K3g), two blocks an SM: for K3 / K3g
    the fastest of the plans timed on the H100
    (PERF.md §6, rows 3 and 10)."""
    if not supported(n_az, n_rg):
        raise ValueError(f"column_plan: shape {(n_az, n_rg)} not supported")
    if factored_split(n_az):
        return ColumnPlan(8, FACTORED_CLUSTER,
                          factored_smem(n_az, 8, nch, forward,
                                        column_threads(n_az, nch)))
    n = column_length(n_az)
    cluster = column_cluster(n)
    qb = column_split(n, cluster)[1]
    threads = column_threads(n_az)
    cols = min(n_rg, max(8, threads // (nch * qb)))
    return ColumnPlan(cols, cluster,
                      column_smem(n, cols, cluster, nch, forward, threads))


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


class _Plan:
    """What the axis plans share: their tensors, one move over them and the
    check of their tables."""

    def tensors(self) -> dict:
        """The plan's tensors by field (the fields that are None left out)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def map(self, fn):
        """The plan with ``fn`` applied to each of its tensors (``.to()``
        of a module that holds it)."""
        return dataclasses.replace(
            self, **{k: fn(v) for k, v in self.tensors().items()})

    def _check_tables(self, name: str, device, tables: dict) -> None:
        """Each field of ``tables`` a contiguous tensor of its (shape,
        dtype) on ``device``, or None where that is None."""
        for field, want in tables.items():
            t = getattr(self, field)
            if want is None and t is None:
                continue
            if (want is None or not isinstance(t, torch.Tensor)
                    or (t.shape, t.dtype) != want or t.device != device
                    or not t.is_contiguous()):
                raise ValueError(f"{name}: the plan's {field} must be "
                                 + ("None" if want is None else
                                    f"a contiguous {want[1]} table of shape "
                                    f"{want[0]} on {device}"))


@dataclasses.dataclass(frozen=True, eq=False)
class AzimuthPlan(_Plan):
    """How the column pass (K1 / K1g forward, K3 / K3g inverse) runs an
    n-point azimuth DFT, one launch a call whichever the kind
    (:attr:`kind`):

    ``direct``: n a power of two, on m = n points; ``tw`` the m-point
    :func:`twiddle_table`.

    ``factored``: n = n1 x n2 (:func:`factored_split`) as a Good-Thomas
    transform, no twiddles between the legs: input row (n2 i1 + n1 i2) mod
    n is point (i1, i2), output row k the one with k mod n1 = k1 and k mod
    n2 = k2. Each block of the cluster runs the n2-point DFTs of its i1 =
    rank + cluster u in shared memory on :func:`local_radices`' passes,
    natural order in, :func:`digit_order` out; a prime n2 runs Rader's
    convolution on L = n2 - 1 points there instead (the points g^-s
    forward, x the kernel's spectrum, inverse, X[g^q] at slot q, X[0] at
    slot L). The gather reads X_i1[k2] of every block and runs the n1-point
    DFT in registers. ``tw`` holds exp(-2 pi i k / L), k < L (L = n2 for a
    smooth n2), then exp(-2 pi i k / n1), k < n1; ``index`` (int32) the
    output weights e1 and e2 (row = (e1 k1 + e2 k2) mod n), the radices,
    the row offset (n1 i2) mod n of each slot and the slot of each k2;
    ``fwd_spec`` / ``inv_spec`` Rader's DFT_L(b) / L, b[q] = exp(-/+ 2 pi
    i g^q / n2), in the passes' order (None for a smooth n2). m = n.

    ``chirpz``: every other n, on m = :func:`chirpz_length` (n) points,
    the m-point spectrum kept in the cluster's shared memory; ``tw`` the
    m-point table, and the forward DFT (``fwd_*``) and the inverse with its
    1/n (``inv_*``) have the chirp (n,) and the spectrum of the
    convolution's kernel (m,), complex64. Forward: X[k] = c[k] (1/m)
    IDFT_m(DFT_m(c x) H)[k] with c[k] = exp(-j pi k^2 / n) and H the DFT of
    exp(j pi j^2 / n) for |j| < n, wrapped into m; the inverse conjugates c
    and H and scales H by 1/n."""
    n: int
    m: int
    tw: torch.Tensor
    fwd_chirp: torch.Tensor | None = None
    fwd_spec: torch.Tensor | None = None
    inv_chirp: torch.Tensor | None = None
    inv_spec: torch.Tensor | None = None
    index: torch.Tensor | None = None

    @property
    def kind(self) -> str:
        """``direct``, ``factored`` or ``chirpz``."""
        if self.index is not None:
            return "factored"
        return "direct" if self.m == self.n else "chirpz"

    @property
    def launches(self) -> int:
        """Kernel launches of one column-pass call: 1 at every side (the
        chirp-z transform's forward and inverse passes share the launch)."""
        return 1

    @property
    def legs(self) -> tuple:
        """(n1, n2, L, passes) of the factored kind (L the local transform's
        points, n2 or n2 - 1), zeros for the others: the launchers'
        ints."""
        return _legs(self.n) if self.index is not None else (0, 0, 0, 0)

    def check(self, name: str, n: int, device) -> None:
        """Raises ValueError unless this is :func:`azimuth_plan` (n) with its
        tables on ``device``; call it as ``AzimuthPlan.check(plan, ...)``,
        so that any other object is refused."""
        m = column_length(n)
        if not isinstance(self, AzimuthPlan) or (self.n, self.m) != (n, m):
            raise ValueError(f"{name}: needs the azimuth plan of {n} points")
        c64 = torch.complex64
        if factored_split(n):
            n1, n2, local, passes = self.legs
            spec = None if local == n2 else ((local,), c64)
            self._check_tables(name, device, dict(
                tw=((local + n1,), c64), fwd_chirp=None, fwd_spec=spec,
                inv_chirp=None, inv_spec=spec,
                index=((2 + passes + 2 * n2,), torch.int32)))
            return
        chirp, spec = ((n,), c64), ((m,), c64)
        if m == n:
            chirp = spec = None
        self._check_tables(name, device, dict(
            tw=((m // 2,), c64), fwd_chirp=chirp, fwd_spec=spec,
            inv_chirp=chirp, inv_spec=spec, index=None))

    def tables(self, inverse: bool) -> tuple:
        """(table, chirp, spectrum, index) of a launch's direction; None
        where the kind has no such table."""
        if inverse:
            return self.tw, self.inv_chirp, self.inv_spec, self.index
        return self.tw, self.fwd_chirp, self.fwd_spec, self.index


@functools.lru_cache(maxsize=None)
def _legs(n: int) -> tuple:
    n1, n2 = factored_split(n)
    local = n2 if _smooth(n2) else n2 - 1
    return n1, n2, local, len(local_radices(local))


def azimuth_plan(n: int, device=None) -> AzimuthPlan:
    """The :class:`AzimuthPlan` of n-point azimuth transforms on ``device``:
    integer maps exact in int64; the chirp from k^2 mod 2n, the factored
    kind's twiddles from k / L and k / n1, then float64, the spectra by
    float64 FFT, each rounded once to complex64 (on the host once per n,
    then copied)."""
    if factored_split(n):
        tw, index, fwd, inv = _factored_host(n)
        return AzimuthPlan(n, n, *(t.to(device=device, copy=True)
                                   if t is not None else None
                                   for t in (tw, None, fwd, None, inv,
                                             index)))
    if not chirpz(n):
        return AzimuthPlan(n, n, twiddle_table(n, device))
    m = chirpz_length(n)
    return AzimuthPlan(n, m, twiddle_table(m, device),
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


def _primitive_root(p: int) -> int:
    """The least generator of the integers mod the prime p."""
    q, fs = p - 1, set()
    for d in range(2, p):
        while q % d == 0:
            fs.add(d)
            q //= d
    return next(g for g in range(2, p)
                if all(pow(g, (p - 1) // f, p) != 1 for f in fs))


@functools.lru_cache(maxsize=None)
def _factored_host(n: int) -> tuple:
    """(tw, index, fwd_spec, inv_spec) of the factored kind at n on the
    host (the specs None for a smooth n2)."""
    n1, n2 = factored_split(n)
    rader = not _smooth(n2)
    local = n2 - 1 if rader else n2
    radices = local_radices(local)
    order = digit_order(radices)
    specs = (None, None)
    if rader:
        g = _primitive_root(n2)
        gq = np.array([pow(g, q, n2) for q in range(local)], np.int64)
        i2 = np.append(np.array([pow(g, -q, n2) for q in range(local)],
                                np.int64), 0)
        pos = np.empty(n2, np.int64)
        pos[gq] = np.arange(local)
        pos[0] = local
        specs = tuple(torch.from_numpy((np.fft.fft(np.exp(
            sign * 2j * np.pi * gq / n2))[order] / local).astype(
                np.complex64)) for sign in (-1, 1))
    else:
        i2 = np.arange(n2, dtype=np.int64)
        pos = np.argsort(order)
    e1 = n2 * pow(n2, -1, n1) % n
    e2 = n1 * pow(n1, -1, n2) % n
    tw = np.concatenate([np.exp(-2j * np.pi * np.arange(local) / local),
                         np.exp(-2j * np.pi * np.arange(n1) / n1)])
    index = np.concatenate([[e1, e2], radices, (n1 * i2) % n, pos])
    return (torch.from_numpy(tw.astype(np.complex64)),
            torch.from_numpy(index.astype(np.int32)), *specs)


@dataclasses.dataclass(frozen=True, eq=False)
class RangePlan(_Plan):
    """How K2 runs its n-point range DFTs: the register plan
    (:func:`k2_plan`) at a power of two up to 4096, reading the n-point
    :func:`twiddle_table` (n / 2 entries); else the mixed-radix plan,
    reading the :func:`full_twiddle_table`, ``order`` (the plan's frequency
    at each position of a row, :func:`mixed_order`) and ``radices`` (the
    plan's passes in the forward order, :func:`mixed_radices`), both int32
    and None on the register plan. The kernel runs the passes these
    radices name, so the order and the passes come from the one rule."""
    n: int
    tw: torch.Tensor
    order: torch.Tensor | None = None
    radices: torch.Tensor | None = None

    @property
    def passes(self) -> int:
        """The mixed-radix plan's passes; 0 on the register plan."""
        return 0 if self.radices is None else self.radices.numel()

    def check(self, name: str, n: int, device) -> None:
        """Raises ValueError unless this is :func:`range_plan` (n) with its
        tables on ``device``; call it as ``RangePlan.check(plan, ...)``, so
        that any other object is refused."""
        if not isinstance(self, RangePlan) or self.n != n:
            raise ValueError(f"{name}: needs the range plan of {n} points")
        i32, c64 = torch.int32, torch.complex64
        if k2_mixed(n):
            tables = dict(tw=((n,), c64), order=((n,), i32),
                          radices=((len(mixed_radices(n)),), i32))
        else:
            tables = dict(tw=((n // 2,), c64), order=None, radices=None)
        self._check_tables(name, device, tables)


def range_plan(n: int, device=None) -> RangePlan:
    """The :class:`RangePlan` of n-point range transforms on ``device``."""
    if not k2_mixed(n):
        return RangePlan(n, twiddle_table(n, device))
    return RangePlan(n, full_twiddle_table(n, device),
                     torch.from_numpy(mixed_order(n)).to(device=device),
                     torch.tensor(mixed_radices(n), dtype=torch.int32,
                                  device=device))


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


def k2_pair_plain(x1r, x1i, x2r, x2i, f: CsaFactors, *, plan=None):
    """Plain version of :func:`k2_pair_call` (torch.fft; ``plan`` is
    accepted for the same signature and unused)."""
    phi2, phi3 = _k2_phases(f)
    return (*_range_pass(x1r, x1i, phi2, phi3),
            *_range_pass(x2r, x2i, phi2, phi3))


def _k2_args(name, planes, f: CsaFactors, plan):
    """Checks the planes, factors and plan of a K2 launch; returns the
    factor tensors and the plan's tables in the launcher's order, and its
    ints (n_az, n_rg, passes)."""
    n_az, n_rg = plane_shape(name, planes[0])
    dev = planes[0].device
    _build.check(name, planes, (n_az, n_rg), dev)
    usq = f.u * f.u
    _build.check(name, (f.fr, f.cphase, f.dr, usq), (n_rg,), dev)
    _build.check(name, (f.alpha, f.beta, f.rphase, f.g, f.c3), (n_az,), dev)
    if plan is None:
        plan = range_plan(n_rg, dev)
    RangePlan.check(plan, name, n_rg, dev)
    return ((f.fr, f.alpha, f.beta, f.cphase, f.dr, usq, f.rphase, f.g,
             f.c3, plan.tw, plan.order, plan.radices),
            (n_az, n_rg, plan.passes))


def k2_pair_call(x1r, x1i, x2r, x2i, f: CsaFactors, *, plan=None):
    """K2 for both channels: per azimuth row, range FFT -> x Phi2 -> range
    IFFT (1/N) -> x Phi3; :func:`k2_call`'s kernel on twice the blocks, one
    channel a block (:func:`k2_plan`, or the mixed-radix plan of
    :func:`mixed_radices`).

    (n_az, n_rg) float32 planes in, four planes out. ``plan``: the
    :func:`range_plan` of n_rg (built when None). CPU tensors run
    :func:`k2_pair_plain`; CUDA tensors launch the kernel."""
    if _build.on_cpu(x1r):
        return k2_pair_plain(x1r, x1i, x2r, x2i, f)
    planes = (x1r, x1i, x2r, x2i)
    tables, ints = _k2_args("k2_pair_call", planes, f, plan)
    out = [torch.empty_like(x1r) for _ in range(4)]
    _build.launch("k2_pair_launch", (*planes, *tables, *out), ints)
    k2_pair_call.launches += 1
    return tuple(out)


k2_pair_call.launches = 0


def k2_plain(xr, xi, f: CsaFactors, *, plan=None):
    """Plain version of :func:`k2_call`."""
    return _range_pass(xr, xi, *_k2_phases(f))


def k2_call(xr, xi, f: CsaFactors, *, plan=None):
    """K2 for one channel: :func:`k2_pair_call`'s kernel on one channel's
    blocks, so its result is the pair's for that channel bit for bit.

    (n_az, n_rg) float32 planes in, two planes out. ``plan``: the
    :func:`range_plan` of n_rg (built when None)."""
    if _build.on_cpu(xr):
        return k2_plain(xr, xi, f)
    tables, ints = _k2_args("k2_call", (xr, xi), f, plan)
    out = [torch.empty_like(xr) for _ in range(2)]
    _build.launch("k2_launch", (xr, xi, *tables, *out), ints)
    k2_call.launches += 1
    return tuple(out)


k2_call.launches = 0


# --------------------------------------------------------------------------
# K1 and K3: the single-channel azimuth passes
# --------------------------------------------------------------------------

def k1_plain(xr, xi, f: CsaFactors, *, plan=None):
    """Plain version of :func:`k1_call`."""
    du = f.u[None, :] - f.w[:, None]
    z = torch.fft.fft(torch.complex(xr, xi), dim=0) \
        * expj(f.c1[:, None] * du * du)
    return z.real.contiguous(), z.imag.contiguous()


def k1_call(xr, xi, f: CsaFactors, *, plan=None):
    """Azimuth FFT of one channel times Phi1 = exp(j c1(a) (u(r) - w(a))^2),
    Phi1 on natural azimuth frequencies: the forward column pass on tiles of
    adjacent columns (:func:`column_plan` with ``forward``), K1g's for one
    channel on the same split of n_az, so its result is K1g's for that
    channel bit for bit; by chirp-z or as a
    prime-factor transform where ``plan`` takes it.

    (n_az, n_rg) float32 planes in, two planes out. ``plan``: the
    :func:`azimuth_plan` of n_az (built when None)."""
    if _build.on_cpu(xr):
        return k1_plain(xr, xi, f)
    n_az, n_rg = plane_shape("k1_call", xr)
    dev = xr.device
    _build.check("k1_call", (xr, xi), (n_az, n_rg), dev)
    _build.check("k1_call", (f.u,), (n_rg,), dev)
    _build.check("k1_call", (f.c1, f.w), (n_az,), dev)
    if plan is None:
        plan = azimuth_plan(n_az, dev)
    AzimuthPlan.check(plan, "k1_call", n_az, dev)
    out = [torch.empty_like(xr) for _ in range(2)]
    _build.launch("k1_launch",
                  (xr, xi, f.u, f.c1, f.w, *plan.tables(inverse=False),
                   *out),
                  (n_az, plan.m, *plan.legs, n_rg,
                   *column_plan(n_az, n_rg, 1, forward=True)))
    k1_call.launches += plan.launches
    return tuple(out)


k1_call.launches = 0


def k3_plain(xr, xi, *, plan=None, out=None):
    """Plain version of :func:`k3_call`."""
    s = torch.fft.ifft(torch.complex(xr, xi), dim=0)
    if out is None:
        return s.real.contiguous(), s.imag.contiguous()
    out[0].copy_(s.real)
    out[1].copy_(s.imag)
    return tuple(out)


def k3_call(xr, xi, *, plan=None, out=None):
    """Inverse azimuth FFT (1/N) of one channel: K3g's column pass (the same
    transform on the same :func:`column_plan` split), so its result is K3g's
    SLC for that channel bit for bit; by chirp-z or as a
    prime-factor transform where ``plan`` takes it.

    (n_az, n_rg) float32 planes in, two planes out: new ones, or ``out``, a
    pair of contiguous planes of that shape to write (and return).
    ``plan``: the :func:`azimuth_plan` of n_az (built when None)."""
    if _build.on_cpu(xr):
        return k3_plain(xr, xi, out=out)
    n_az, n_rg = plane_shape("k3_call", xr)
    dev = xr.device
    _build.check("k3_call", (xr, xi), (n_az, n_rg), dev)
    if plan is None:
        plan = azimuth_plan(n_az, dev)
    AzimuthPlan.check(plan, "k3_call", n_az, dev)
    if out is None:
        out = [torch.empty_like(xr) for _ in range(2)]
    else:
        _build.check("k3_call", out, (n_az, n_rg), dev)
    _build.launch("k3_launch", (xr, xi, *plan.tables(inverse=True), *out),
                  (n_az, plan.m, *plan.legs, n_rg,
                   *column_plan(n_az, n_rg, 1)))
    k3_call.launches += plan.launches
    return tuple(out)


k3_call.launches = 0


# --------------------------------------------------------------------------
# public entries
# --------------------------------------------------------------------------

def apply_csa_pallas_planes(xr, xi, f: CsaFactors):
    """Planes-native CSA: re/im float32 (..., n_az, n_rg) raw -> re/im SLC,
    K1 -> K2 -> K3 per plane, on the two axis plans of (n_az, n_rg), built
    once per shape and device and kept (:func:`axis_plans`). This is the
    hot entry (the formation-only stream holds planes end to end).

    Each kernel runs under its span (``focus.k1``, ``focus.k2``,
    ``focus.k3``), and each plane counts its axis transforms (azimuth
    forward and inverse, range forward and inverse) that ran by chirp-z
    (``cpi.chirpz_axes``), as a prime-factor transform
    (``cpi.factored_axes``) and by the mixed-radix plan
    (``cpi.mixed_radix_axes``), as the GMTI CPI counts its own.

    Raises ValueError at shapes the kernels do not take (:func:`supported`)
    on every device; ``ops/csa.py::apply_csa_fused`` routes those."""
    n_az, n_rg = xr.shape[-2], xr.shape[-1]
    if not supported(n_az, n_rg):
        raise ValueError(f"apply_csa_pallas needs {family()}, got "
                         f"{(n_az, n_rg)}")
    lead = xr.shape[:-2]
    xr = xr.reshape(-1, n_az, n_rg).contiguous()
    xi = xi.reshape(-1, n_az, n_rg).contiguous()
    az, rg = axis_plans(n_az, n_rg, xr.device)
    # K3 writes each SLC plane straight into its slot of the batch
    out_r, out_i = torch.empty_like(xr), torch.empty_like(xi)
    for zr, zi, sr, si in zip(xr, xi, out_r, out_i):
        count("cpi.chirpz_axes", 2 * (az.kind == "chirpz"))
        count("cpi.factored_axes", 2 * (az.kind == "factored"))
        count("cpi.mixed_radix_axes", 2 * (rg.passes > 0))
        with span("focus.k1"):
            zr, zi = k1_call(zr, zi, f, plan=az)
        with span("focus.k2"):
            zr, zi = k2_call(zr, zi, f, plan=rg)
        with span("focus.k3"):
            k3_call(zr, zi, plan=az, out=(sr, si))
    return (out_r.reshape(lead + (n_az, n_rg)),
            out_i.reshape(lead + (n_az, n_rg)))


@functools.lru_cache(maxsize=4)
def axis_plans(n_az: int, n_rg: int, device) -> tuple:
    """(:func:`azimuth_plan` (n_az), :func:`range_plan` (n_rg)) on
    ``device``, built on the first call for a shape and device and kept
    there: a later call copies nothing from the host (a pageable copy
    waits for the card)."""
    return azimuth_plan(n_az, device), range_plan(n_rg, device)


def apply_csa_pallas(phist, f: CsaFactors):
    """(..., n_az, n_rg) complex64 raw -> SLC through the three kernels:
    the same math as ``ops/csa.py::apply_csa_fused`` to f32 rounding.
    Splits into contiguous planes and recombines; callers that hold planes
    should use :func:`apply_csa_pallas_planes`."""
    our, oui = apply_csa_pallas_planes(phist.real, phist.imag, f)
    return torch.complex(our, oui)
