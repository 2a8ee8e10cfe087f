"""Plain reference of HRWS multichannel azimuth reconstruction (and, through
gmti_products.focus_csa, of its CSA focus).

Multichannel reconstruction of a uniformly or non-uniformly sampled
azimuth signal (Krieger, Gebert and Moreira, IEEE GRSL 1(4), 2004; Gebert,
Krieger and Moreira, IEEE TAES 45(2), 2009), as the repo's JAX package
states it: receive channel k at along-track offset x_k sees the
transmitter-centred signal advanced by x_k / (2 V), so its spectrum at the
system PRF is

    Y_k(f) = sum_n U(f_n) exp(j pi x_k f_n / V),

summed over the M frequencies f_n of the extended band [-M PRF / 2,
M PRF / 2) that alias onto f (f_n = f mod PRF). For each Doppler bin the
M band values U come from the loaded normal equations (H^H H + delta I)
U = H^H Y, with H[k, n] = exp(j pi x_k f_n / V) and delta = 1e-6 x the
mean diagonal of H^H H; U(f_n) is placed at f_n on the M P-point grid of
the effective PRF M PRF, and the inverse FFT (times M, the amplitude of a
sampling at M PRF) gives the slow-time signal. Written in plain torch on
the raw's device; imports nothing of the port.

mode 'f64': complex128 throughout. mode 'bf16' (the control): the raw,
the spectra, the steering and loaded operator, the band values and the
result each rounded to bfloat16, the stages computed in complex64. TF32 is
off for the reference's products."""

from __future__ import annotations

import contextlib
import math

import torch

from bench_torch.reference import _precision as P


@contextlib.contextmanager
def _no_tf32():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def reconstruct(raw: torch.Tensor, h: dict, mode: str = "f64") -> torch.Tensor:
    """(K, P, Ns) raw at the system PRF -> (M P, Ns) slow-time signal at
    M PRF. ``h``: rx_offsets (K along-track offsets, m), velocity_mps,
    prf_hz, bands (M)."""
    P.check(mode)
    k, n_p, n_s = raw.shape
    m, dev = int(h["bands"]), raw.device
    ct = P.ctype(mode)

    def q(x):
        return P.q(x, mode)

    with _no_tf32():
        y = q(torch.fft.fft(q(raw.to(ct)), dim=1))            # (K, P, Ns)
        # position j of the M P-point grid is base bin j mod P, band j // P
        f = torch.fft.fftfreq(m * n_p, 1.0 / (m * h["prf_hz"]),
                              dtype=torch.float64, device=dev)
        f = f.reshape(m, n_p).T                                # (P, M)
        x = torch.as_tensor(h["rx_offsets"], dtype=torch.float64,
                            device=dev)
        phase = (math.pi / h["velocity_mps"]) * x[None, :, None] \
            * f[:, None, :]                                    # (P, K, M)
        hm = torch.polar(torch.ones_like(phase), phase)
        hh = hm.conj().transpose(1, 2)                         # (P, M, K)
        g = hh @ hm
        delta = 1e-6 * torch.diagonal(g, dim1=1, dim2=2).real.mean()
        g = g + delta * torch.eye(m, dtype=g.dtype, device=dev)
        # the normal equations' solution for every range column of a bin:
        # U_b = (H_b^H H_b + delta I)^-1 H_b^H Y_b
        w = q(torch.linalg.solve(g, hh).to(ct))
        u = q(torch.matmul(w, y.transpose(0, 1)))              # (P, M, Ns)
        del y
        ext = u.transpose(0, 1).reshape(m * n_p, n_s)         # [n P + b]
        del u
        return q(torch.fft.ifft(ext, dim=0) * m)
