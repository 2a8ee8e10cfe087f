"""CSA range pass for both GMTI channels: the K2 pair kernel.

Counterpart of ``nis_sar_amtigmti_video_tpu/ops/pallas/csa_kernel.py``
(``supported``, ``k2_pair_call``). The CUDA source is
``csrc/csa_kernel.cu``; :func:`k2_pair_plain` is its plain PyTorch version,
which the wrapper runs for CPU tensors. The other kernels of that module
(single-channel K1 / K2 / K3) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.ops.csa import CsaFactors, expj
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build

# CPI sides the kernels take: powers of two (radix-2 FFTs) in the range they
# were checked at; a 4096 side holds 64-80 KB of shared memory per block
MIN_N, MAX_N = 64, 4096


def supported(n_az: int, n_rg: int) -> bool:
    """Shapes the kernels take: both axes powers of two in [64, 4096]."""
    return all(MIN_N <= n <= MAX_N and n & (n - 1) == 0
               for n in (n_az, n_rg))


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


def k2_pair_plain(x1r, x1i, x2r, x2i, f: CsaFactors, *, twiddles=None):
    """Plain version of :func:`k2_pair_call` (torch.fft; ``twiddles`` is
    accepted for the same signature and unused)."""
    ph2 = (f.alpha[:, None] * f.fr[None, :] + f.beta[:, None]) \
        * f.fr[None, :]
    ph3 = f.rphase[:, None] + f.cphase[None, :] \
        + f.g[:, None] * f.dr[None, :] - f.c3[:, None] * (f.u * f.u)[None, :]
    phi2, phi3 = expj(ph2), expj(ph3)
    out = []
    for xr, xi in ((x1r, x1i), (x2r, x2i)):
        s = torch.fft.fft(torch.complex(xr, xi), dim=-1) * phi2
        s = torch.fft.ifft(s, dim=-1) * phi3
        out += [s.real.contiguous(), s.imag.contiguous()]
    return tuple(out)


def k2_pair_call(x1r, x1i, x2r, x2i, f: CsaFactors, *, twiddles=None):
    """K2 for both channels: per azimuth row, range FFT -> x Phi2 -> range
    IFFT (1/N) -> x Phi3, Phi2/Phi3 evaluated once for the two channels.

    (n_az, n_rg) float32 planes in, four planes out. ``twiddles``: the
    n_rg-point table of :func:`twiddle_table` (built when None). CPU tensors
    run :func:`k2_pair_plain`; CUDA tensors launch the kernel."""
    if _build.on_cpu(x1r):
        return k2_pair_plain(x1r, x1i, x2r, x2i, f)
    n_az, n_rg = plane_shape("k2_pair_call", x1r)
    dev = x1r.device
    _build.check("k2_pair_call", (x1r, x1i, x2r, x2i), (n_az, n_rg), dev)
    usq = f.u * f.u
    _build.check("k2_pair_call", (f.fr, f.cphase, f.dr, usq), (n_rg,), dev)
    _build.check("k2_pair_call", (f.alpha, f.beta, f.rphase, f.g, f.c3),
                 (n_az,), dev)
    tw = twiddles_for("k2_pair_call", twiddles, n_rg, dev)
    out = [torch.empty_like(x1r) for _ in range(4)]
    _build.launch("k2_pair_launch",
                  (x1r, x1i, x2r, x2i, f.fr, f.alpha, f.beta, f.cphase,
                   f.dr, usq, f.rphase, f.g, f.c3, tw, *out), (n_az, n_rg))
    k2_pair_call.launches += 1
    return tuple(out)


k2_pair_call.launches = 0
