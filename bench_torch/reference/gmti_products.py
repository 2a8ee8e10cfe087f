"""Plain reference of the two-channel ATI/DPCA GMTI products of one CPI.

The upstream sar_ati_dcpa_sim_csa.py's chain as the repo's float64 NumPy
oracle describes it (oracle/pipeline.py::focus_csa, with fftshifted
frequency grids), and the viewer's products: DPCA one-pulse shift; CSA of
both channels (azimuth FFT, chirp scaling Phi1, range FFT, Phi2, range
IFFT, Phi3, azimuth IFFT); the channel balance angle(mean(s1 conj s2))
applied to channel 2; the ATI phase where |s1| exceeds ``mask`` of its
peak; |s1 - s2|; the cancellation ratio mean|s1| / mean|s1 - s2|; CA-CFAR
on |s1 - s2|^2 with zero-padded square windows and the count corrected at
the edges. Written in plain torch, on the raw's device; imports nothing of
the port."""

from __future__ import annotations

import math

import torch

from bench_torch.reference import _precision as P

C = 299792458.0


def _fftfreq_shifted(n: int, d: float, dev) -> torch.Tensor:
    return torch.fft.fftshift(torch.fft.fftfreq(n, d, dtype=torch.float64,
                                                device=dev))


def focus_csa(ph: torch.Tensor, r: dict, mode: str = "f64") -> torch.Tensor:
    """(n_az, n_rg) raw -> (n_az, n_rg) SLC. ``r``: wavelength_m,
    chirp_rate, fs_hz, prf_hz, velocity_mps (V_eff), range_ref_m,
    t_start_fast."""
    P.check(mode)
    n_az, n_rg = ph.shape
    dev = ph.device
    lam, kr, v, r_ref = (r["wavelength_m"], r["chirp_rate"],
                         r["velocity_mps"], r["range_ref_m"])
    tau = r["t_start_fast"] + torch.arange(
        n_rg, dtype=torch.float64, device=dev) / r["fs_hz"]
    fr = _fftfreq_shifted(n_rg, 1.0 / r["fs_hz"], dev)
    fa = _fftfreq_shifted(n_az, 1.0 / r["prf_hz"], dev)

    def q(x):
        return P.q(x, mode)

    x = q(ph.to(P.ctype(mode)))
    s = q(torch.fft.fftshift(torch.fft.fft(x, dim=0), dim=0))
    arg = 1.0 - (lam * fa / (2.0 * v)) ** 2
    d_fa = torch.sqrt(torch.where(arg < 0.0, torch.full_like(arg, 1e-9),
                                  arg))
    cs = 1.0 / d_fa - 1.0
    tau_ref = 2.0 * r_ref / (C * d_fa)
    s = q(s * P.expj(-math.pi * kr * cs[:, None]
                     * (tau[None, :] - tau_ref[:, None]) ** 2, mode))
    s = q(torch.fft.fftshift(torch.fft.fft(s, dim=1), dim=1))
    s = q(s * P.expj(math.pi * fr[None, :] ** 2
                     / (kr * (1.0 + cs[:, None]))
                     + 4.0 * math.pi * r_ref * cs[:, None] * fr[None, :] / C,
                     mode))
    s = q(torch.fft.ifft(torch.fft.ifftshift(s, dim=1), dim=1))
    r_vec = C * tau / 2.0
    tau_diff = tau - 2.0 * r_ref / C
    s = q(s * P.expj(4.0 * math.pi * r_vec[None, :] * d_fa[:, None] / lam
                     - math.pi * kr * cs[:, None] * (1.0 + cs[:, None])
                     * tau_diff[None, :] ** 2, mode))
    return q(torch.fft.ifft(torch.fft.ifftshift(s, dim=0), dim=0))


def _box_sum(x: torch.Tensor, half: int) -> torch.Tensor:
    """Sum over a (2 half + 1)^2 window, zeros outside, by prefix sums in
    float64."""
    x = x.to(torch.float64)
    h, w = x.shape
    k = 2 * half + 1
    xp = torch.nn.functional.pad(x, (half + 1, half, half + 1, half))
    s = xp.cumsum(0).cumsum(1)
    return (s[k:k + h, k:k + w] - s[:h, k:k + w] - s[k:k + h, :w]
            + s[:h, :w])


def _count(n: int, half: int, dev) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float64, device=dev)
    return (torch.clamp(i + half, max=n - 1) - torch.clamp(i - half, min=0)
            + 1)


def cfar(power: torch.Tensor, guard: int, train: int, pfa: float,
         mode: str = "f64"):
    """(snr, detections, alpha) of CA-CFAR on ``power``."""
    h, w = power.shape
    dev = power.device
    outer = _box_sum(power, guard + train)
    inner = _box_sum(power, guard)
    n_o = _count(h, guard + train, dev)[:, None] * _count(w, guard + train,
                                                          dev)[None, :]
    n_i = _count(h, guard, dev)[:, None] * _count(w, guard, dev)[None, :]
    noise = P.q(((outer - inner) / torch.clamp(n_o - n_i, min=1.0)).to(
        P.rtype(mode)), mode)
    snr = P.q(power / torch.clamp(noise, min=1e-30), mode)
    n = (2 * (guard + train) + 1) ** 2 - (2 * guard + 1) ** 2
    alpha = n * (pfa ** (-1.0 / n) - 1.0)
    return snr, snr > alpha, alpha


def products(raw2ch: torch.Tensor, r: dict, g: dict,
             mode: str = "f64") -> dict:
    """The CPI's products from a (2, P, Ns) raw pair. ``r`` as for
    :func:`focus_csa`; ``g``: shift_pulses, mask_threshold, guard, train,
    pfa."""
    s_ = g["shift_pulses"]
    s1 = focus_csa(raw2ch[0, s_:], r, mode)
    s2 = focus_csa(raw2ch[1, :-s_], r, mode)
    cal = torch.angle(torch.mean(s1 * torch.conj(s2)))
    s2 = P.q(s2 * torch.polar(torch.ones_like(cal), cal).to(s2.dtype), mode)
    a1 = torch.abs(s1)
    phase = torch.angle(s1 * torch.conj(s2))
    phase = torch.where(a1 > g["mask_threshold"] * a1.max(), phase,
                        torch.zeros_like(phase))
    diff = P.q(s1 - s2, mode)
    dmag = torch.abs(diff)
    ratio = torch.mean(a1) / (torch.mean(dmag) + 1e-12)
    snr, det, _ = cfar(P.q(dmag * dmag, mode), g["guard"], g["train"],
                       g["pfa"], mode)
    return dict(slc1=s1, slc2=s2, cal=cal, ati_phase=phase, dpca_mag=dmag,
                ratio=ratio, snr=snr, detections=det.sum())
