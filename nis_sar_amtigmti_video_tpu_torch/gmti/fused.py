"""The two-channel GMTI CPI: formation and every product in four kernels.

Counterpart of ``nis_sar_amtigmti_video_tpu/gmti/fused.py``:

* :func:`gmti_product_step` — the products composed after formation
  (balance sum + peak, then phase / DPCA power / CFAR) in plain PyTorch.
* :func:`gmti_cpi` / :class:`GmtiCpi` — raw phase-history planes in, SLC
  planes + products out, through the four kernels of ``ops/cuda``:

    K1g   azimuth FFT + Phi1 for both channels, raw balance sums
    K2    range FFT -> Phi2 -> range IFFT -> Phi3 for both channels
    K3g   azimuth IFFT; SLCs, ATI phase, |s1|^2, DPCA power, column box sums
    K4    range box sums, noise / SNR, phase mask, dmag

  Between them only scalars are reduced on the device: cal =
  atan2(sum im, sum re) of K1g's per-column sums, and peak2 = max of K3g's
  per-column peaks. The reference's TPU tiling knobs (mode, variants, rows,
  implementations) have no counterpart here.
"""

from __future__ import annotations

import torch
from torch import nn

from nis_sar_amtigmti_video_tpu_torch.gmti import cfar as cfar_mod
from nis_sar_amtigmti_video_tpu_torch.ops.csa import CsaFactors, expj
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import csa_kernel, gmti_kernel


def gmti_product_step(s1, s2, *, balance: bool = True,
                      mask_threshold: float = 0.05,
                      cfar_params: cfar_mod.CfarParams | None = None):
    """(s1, s2) SLCs -> (cal_phase, ati_phase, dpca_mag, cfar_detection).

    cal_phase is the applied balance rotation (0 when balance=False);
    ati_phase is magnitude-masked like ati.masked_phase (0 outside);
    dpca_mag = |s1 - s2 e^{j cal}|. The balanced channel is never formed:
    the rotation is folded into the interferogram and the difference.
    """
    prod = s1 * torch.conj(s2)
    xsum = torch.sum(prod)
    peak2 = torch.max(s1.real ** 2 + s1.imag ** 2)
    cal = torch.angle(xsum) if balance else torch.zeros(
        (), dtype=torch.float32, device=s1.device)

    rot = expj(cal).to(s1.dtype)
    phase = torch.angle(prod * torch.conj(rot)).to(torch.float32)
    mag1_2 = s1.real ** 2 + s1.imag ** 2
    mask = mag1_2 > (mask_threshold ** 2) * peak2
    phase = torch.where(mask, phase, torch.zeros_like(phase))
    diff = s1 - s2 * rot
    power = diff.real ** 2 + diff.imag ** 2
    dmag = torch.sqrt(power)

    det = cfar_mod.ca_cfar(power, cfar_params or cfar_mod.CfarParams())
    return cal, phase, dmag, det


class GmtiCpi(nn.Module):
    """The kernel-path CPI with its per-configuration state as buffers, so
    ``.to(device)`` moves it: the 1-D ``CsaFactors`` vectors, the azimuth
    and range twiddle tables and the CFAR count vectors."""

    def __init__(self, f: CsaFactors,
                 cfar_params: cfar_mod.CfarParams | None = None):
        super().__init__()
        self.cfar_params = cfar_params or cfar_mod.CfarParams()
        n_az, n_rg = f.c1.shape[0], f.u.shape[0]
        for name in CsaFactors._fields:
            self.register_buffer(name, getattr(f, name))
        dev = f.u.device
        self.register_buffer("tw_az", csa_kernel.twiddle_table(n_az, dev))
        self.register_buffer("tw_rg", csa_kernel.twiddle_table(n_rg, dev))
        p = self.cfar_params
        for name, v in zip(("ch_o", "ch_i", "cw_o", "cw_i"),
                           gmti_kernel.cfar_counts(n_az, n_rg,
                                                   p.guard + p.train,
                                                   p.guard, dev)):
            self.register_buffer(name, v)

    def factors(self) -> CsaFactors:
        return CsaFactors(*(getattr(self, n) for n in CsaFactors._fields))

    def forward(self, x1r, x1i, x2r, x2i, *, balance: bool = True,
                mask_threshold: float = 0.05):
        """Returns (s1r, s1i, s2r, s2i, cal, phase, dmag, CfarResult)."""
        p = self.cfar_params
        h_out, h_in = p.guard + p.train, p.guard
        f = self.factors()
        z1r, z1i, z2r, z2i, xs_re, xs_im = gmti_kernel.k1_gmti_planes(
            x1r, x1i, x2r, x2i, f, balance=balance, twiddles=self.tw_az)
        cal = (torch.atan2(xs_im, xs_re) if balance
               else torch.zeros((), dtype=torch.float32, device=x1r.device))
        cal_cs = torch.stack([torch.cos(cal), torch.sin(cal)])
        z1r, z1i, z2r, z2i = csa_kernel.k2_pair_call(
            z1r, z1i, z2r, z2i, f, twiddles=self.tw_rg)
        (s1r, s1i, s2r, s2i, ph_raw, mag, power, cso, csi,
         peaks) = gmti_kernel.k3_gmti_planes(
            z1r, z1i, z2r, z2i, cal_cs, h_out=h_out, h_in=h_in,
            twiddles=self.tw_az)
        del z1r, z1i, z2r, z2i      # free the K2 planes before K4's outputs
        thr = (mask_threshold ** 2) * torch.max(peaks)
        snr, phase, dmag, noise = gmti_kernel.k4_epilogue_planes(
            cso, csi, power, ph_raw, mag, thr, h_out=h_out, h_in=h_in,
            counts=(self.ch_o, self.ch_i, self.cw_o, self.cw_i))
        det = cfar_mod.CfarResult(detections=snr > p.alpha, snr=snr,
                                  noise=noise)
        return s1r, s1i, s2r, s2i, cal, phase, dmag, det


def gmti_cpi(x1r, x1i, x2r, x2i, f: CsaFactors, *, balance: bool = True,
             mask_threshold: float = 0.05,
             cfar_params: cfar_mod.CfarParams | None = None):
    """Full two-channel GMTI CPI — (n_az, n_rg) float32 raw planes of both
    channels in, SLC planes + products out — on the planes' device.

    Same products as :func:`gmti_product_step` composed after formation, to
    f32 rounding (the balance sum runs over the raw pair; see
    ``ops/cuda/gmti_kernel.py``). Returns (s1r, s1i, s2r, s2i, cal, phase,
    dmag, CfarResult)."""
    cpi = GmtiCpi(f, cfar_params).to(x1r.device)
    return cpi(x1r, x1i, x2r, x2i, balance=balance,
               mask_threshold=mask_threshold)
