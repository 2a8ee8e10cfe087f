"""The two-channel GMTI CPI: formation and every product in four kernels.

Counterpart of ``nis_sar_amtigmti_video_tpu/gmti/fused.py``:

* :func:`gmti_product_step` — the products composed after formation
  (balance sum + peak, then phase / DPCA power / CFAR) in plain PyTorch.
* :func:`gmti_cpi` / :class:`GmtiCpi` — raw phase-history planes in, SLC
  planes + products out, through the kernels of ``ops/cuda``:

    K1g   azimuth FFT + Phi1 for both channels, raw balance sums
    K2    range FFT -> Phi2 -> range IFFT -> Phi3 for both channels
    K3g   azimuth IFFT; SLCs, ATI phase, |s1|^2, DPCA power, column box sums
    K4    range box sums, noise / SNR, phase mask, dmag

  or, with ``k1_impl='split'`` (the reference's other route), the raw
  balance kernel, then K1 and K2 single for each channel, then K3g and K4.
  Between them only scalars are reduced on the device: cal =
  atan2(sum im, sum re) of the balance partial sums, and peak2 = max of
  K3g's per-column peaks. The reference's other TPU knobs (mode, variants,
  rows, ``balance_impl``, ``k2_impl``, ``epilogue``) have no counterpart
  here.

  Any CPI of ``csa_kernel.supported``: the upstream's 7,199 x 13,200 runs
  K1g and K3g as prime-factor transforms of 23 x 313 points (one launch
  each) and K2 on its mixed-radix plan. Each kernel runs under its span
  (``focus.k1g``, ``focus.k2``, ``focus.k3g``, ``focus.k4``; the split
  route's ``focus.balance`` and ``focus.k1``), and the counters
  ``cpi.chirpz_axes``, ``cpi.factored_axes`` and ``cpi.mixed_radix_axes``
  count the CPI's axis transforms (azimuth forward and inverse, range
  forward and inverse) that ran by chirp-z, as a prime-factor transform
  and by the mixed-radix plan.
"""

from __future__ import annotations

import torch
from torch import nn

from nis_sar_amtigmti_video_tpu_torch.gmti import cfar as cfar_mod
from nis_sar_amtigmti_video_tpu_torch.ops.csa import CsaFactors, expj
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import csa_kernel, gmti_kernel
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import count, span

K1_IMPLS = ("fused2ch", "split")


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
    """The kernel-path CPI with its per-configuration state, which
    ``.to(device)`` moves: the 1-D ``CsaFactors`` vectors and the CFAR
    count vectors as buffers, and the kernels' axis plans, as the wrappers
    take them: ``az`` (``csa_kernel.azimuth_plan``) and ``rg``
    (``csa_kernel.range_plan``)."""

    def __init__(self, f: CsaFactors,
                 cfar_params: cfar_mod.CfarParams | None = None):
        super().__init__()
        self.cfar_params = cfar_params or cfar_mod.CfarParams()
        n_az, n_rg = f.c1.shape[0], f.u.shape[0]
        for name in CsaFactors._fields:
            self.register_buffer(name, getattr(f, name))
        dev = f.u.device
        self.az = csa_kernel.azimuth_plan(n_az, dev)
        self.rg = csa_kernel.range_plan(n_rg, dev)
        # the CPI's axis transforms (forward and inverse) by each method
        self.chirpz_axes = 2 * (self.az.kind == "chirpz")
        self.factored_axes = 2 * (self.az.kind == "factored")
        self.mixed_radix_axes = 2 * (self.rg.passes > 0)
        p = self.cfar_params
        for name, v in zip(("ch_o", "ch_i", "cw_o", "cw_i"),
                           gmti_kernel.cfar_counts(n_az, n_rg,
                                                   p.guard + p.train,
                                                   p.guard, dev)):
            self.register_buffer(name, v)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self.az, self.rg = self.az.map(fn), self.rg.map(fn)
        return self

    def factors(self) -> CsaFactors:
        return CsaFactors(*(getattr(self, n) for n in CsaFactors._fields))

    def _k12(self, xr, xi, f: CsaFactors):
        """K1 then K2 single on one channel's raw planes."""
        with span("focus.k1"):
            zr, zi = csa_kernel.k1_call(xr, xi, f, plan=self.az)
        with span("focus.k2"):
            return csa_kernel.k2_call(zr, zi, f, plan=self.rg)

    def forward(self, x1r, x1i, x2r, x2i, *, balance: bool = True,
                mask_threshold: float = 0.05, k1_impl: str = "fused2ch"):
        """Returns (s1r, s1i, s2r, s2i, cal, phase, dmag, CfarResult).

        k1_impl: 'fused2ch' (K1g with the balance sums riding its read, K2
        pair) or 'split' (the raw balance kernel, then K1 and K2 single for
        each channel); the same products to f32 rounding."""
        if k1_impl not in K1_IMPLS:
            raise ValueError(f"unknown k1_impl {k1_impl!r}: "
                             f"{' | '.join(K1_IMPLS)}")
        p = self.cfar_params
        h_out, h_in = p.guard + p.train, p.guard
        f = self.factors()
        count("cpi.chirpz_axes", self.chirpz_axes)
        count("cpi.factored_axes", self.factored_axes)
        count("cpi.mixed_radix_axes", self.mixed_radix_axes)
        if k1_impl == "fused2ch":
            with span("focus.k1g"):
                z1r, z1i, z2r, z2i, xs_re, xs_im = \
                    gmti_kernel.k1_gmti_planes(x1r, x1i, x2r, x2i, f,
                                               balance=balance,
                                               plan=self.az)
            with span("focus.k2"):
                z1r, z1i, z2r, z2i = csa_kernel.k2_pair_call(
                    z1r, z1i, z2r, z2i, f, plan=self.rg)
        else:
            if balance:
                with span("focus.balance"):
                    xs_re, xs_im = gmti_kernel.raw_balance(x1r, x1i, x2r,
                                                           x2i)
            z1r, z1i, z2r, z2i = (
                *self._k12(x1r, x1i, f), *self._k12(x2r, x2i, f))
        cal = (torch.atan2(xs_im, xs_re) if balance
               else torch.zeros((), dtype=torch.float32, device=x1r.device))
        cal_cs = torch.stack([torch.cos(cal), torch.sin(cal)])
        with span("focus.k3g"):
            (s1r, s1i, s2r, s2i, ph_raw, mag, power, cso, csi,
             peaks) = gmti_kernel.k3_gmti_planes(
                z1r, z1i, z2r, z2i, cal_cs, h_out=h_out, h_in=h_in,
                plan=self.az)
        del z1r, z1i, z2r, z2i      # free the K2 planes before K4's outputs
        thr = (mask_threshold ** 2) * torch.max(peaks)
        with span("focus.k4"):
            snr, phase, dmag, noise = gmti_kernel.k4_epilogue_planes(
                cso, csi, power, ph_raw, mag, thr, h_out=h_out, h_in=h_in,
                counts=(self.ch_o, self.ch_i, self.cw_o, self.cw_i))
        det = cfar_mod.CfarResult(detections=snr > p.alpha, snr=snr,
                                  noise=noise)
        return s1r, s1i, s2r, s2i, cal, phase, dmag, det


def gmti_cpi(x1r, x1i, x2r, x2i, f: CsaFactors, *, balance: bool = True,
             mask_threshold: float = 0.05,
             cfar_params: cfar_mod.CfarParams | None = None,
             k1_impl: str = "fused2ch"):
    """Full two-channel GMTI CPI — (n_az, n_rg) float32 raw planes of both
    channels in, SLC planes + products out — on the planes' device.

    Same products as :func:`gmti_product_step` composed after formation, to
    f32 rounding (the balance sum runs over the raw pair; see
    ``ops/cuda/gmti_kernel.py``). ``k1_impl``: 'fused2ch' or 'split' (see
    :meth:`GmtiCpi.forward`). Returns (s1r, s1i, s2r, s2i, cal, phase, dmag,
    CfarResult)."""
    cpi = GmtiCpi(f, cfar_params).to(x1r.device)
    return cpi(x1r, x1i, x2r, x2i, balance=balance,
               mask_threshold=mask_threshold, k1_impl=k1_impl)
