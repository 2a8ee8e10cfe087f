"""HRWS multichannel azimuth-ambiguity (Doppler) reconstruction.

Counterpart of ``nis_sar_amtigmti_video_tpu/models/hrws.py`` (its
``HrwsParams``, ``steering_matrix``, ``_band_layout``, ``reconstruct``,
``collect_reconstruct_focus`` without a mesh, the PRF helpers and
``condition_numbers``). ``reconstruct_sharded`` and the mesh path of
``collect_reconstruct_focus`` wait for the port's multi-device layer.

K along-track receive channels at offsets x_k sample the azimuth (Doppler)
spectrum K times per PRI. A channel at offset x_k has its two-way phase
centre x_k/2 along track, so it sees the monostatic signal advanced by
x_k/(2V): s_k(t) = s0(t + x_k/(2V)), which in Doppler is

    Y_k(f) = sum_m U(f + m*PRF) * exp(+j*pi*x_k*(f + m*PRF)/V)

over the M aliased Doppler bands m. Per base Doppler bin this is a K x M
system, solved through Tikhonov-loaded normal equations. The unfolded
spectrum spans M*PRF: an effective PRF M times the system's, which
removes the azimuth ghosts a single channel shows at the low PRF.

On the device the per-bin solve is one operator a bin, W = (A^H A + eps
I)^-1 A^H, built once per (params, pulses, device) and kept there
(:func:`unfold_operator`): a product copies nothing from the host. Its
rows are put in the order of the unfolded spectrum's blocks (the band
scatter is a permutation within each bin) and carry the inverse FFT's
factor M, so the unfold is one batched product written straight into the
unfolded spectrum. The stage record: ``hrws.reconstruct`` ⊃
``hrws.spectra``, ``hrws.unfold``, ``hrws.inverse``, and the counter
``hrws.bands`` (bands unfolded).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.ops import csa as csa_ops
from nis_sar_amtigmti_video_tpu_torch.ops.echo import (
    multi_channel_phase_history)
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import count, span


@dataclass(frozen=True)
class HrwsParams:
    num_channels: int        # K receive channels
    spacing_m: float         # along-track offset spacing between channels
    prf_hz: float
    velocity_mps: float      # platform (phase-centre progression) velocity
    num_bands: int = 0       # M aliased bands to unfold; 0 -> K

    @property
    def bands(self) -> int:
        return self.num_bands or self.num_channels

    def rx_offsets(self) -> np.ndarray:
        """Channel offsets centred on the transmitter."""
        k = self.num_channels
        return (np.arange(k) - (k - 1) / 2.0) * self.spacing_m

    @property
    def effective_prf(self) -> float:
        return self.bands * self.prf_hz


def steering_matrix(p: HrwsParams, f_ext) -> torch.Tensor:
    """A[..., k, m] = exp(+j*pi*x_k*f_ext[..., m]/V) for extended (unfolded)
    Doppler frequencies f_ext (..., M), complex64 on f_ext's device (a
    tensor) or the host: the phase in float64, cast to float32, then
    exp(j phase)."""
    f = torch.as_tensor(f_ext, dtype=torch.float64)
    offs = torch.as_tensor(p.rx_offsets(), dtype=torch.float64,
                           device=f.device)
    phase = (math.pi / p.velocity_mps) * offs[:, None] * f[..., None, :]
    return csa_ops.expj(phase.to(torch.float32))


def _band_layout(p: HrwsParams, n_az: int):
    """For each (base bin b, band m): the unfolded array position in natural
    fft order of length M*n_az, and the *wrapped* continuous frequency it
    represents on the extended +/- M*PRF/2 grid (which band covers a base
    bin depends on the bin's sign: the candidates are the extended-grid
    frequencies congruent to f_base mod PRF). NumPy, both (n_az, M)."""
    m = p.bands
    freq_num = np.fft.fftfreq(n_az, 1.0 / n_az).astype(np.int64)  # b or b-P
    m_off = np.arange(m) - m // 2
    idx = (freq_num[:, None] + m_off[None, :] * n_az) % (m * n_az)
    f_ext = np.fft.fftfreq(m * n_az, 1.0 / (m * p.prf_hz))[idx]
    return idx, f_ext


@functools.lru_cache(maxsize=4)
def unfold_operator(p: HrwsParams, n_az: int, device) -> torch.Tensor:
    """(n_az, M, K) complex64 on ``device``: per base bin b, row j of W_b
    = M (A_b^H A_b + eps I)^-1 A_b^H for the band that lands in block j of
    the unfolded spectrum (position j n_az + b). A_b is
    :func:`steering_matrix` at the bin's :func:`_band_layout` frequencies
    (complex64, as the reference builds it); the Gram matrix, its loading
    eps = 1e-6 mean |diag|, which keeps the solve finite near the
    degenerate spacing, and the solve run in complex128 on the host, once
    per (params, pulses, device); the result is kept on the device."""
    m = p.bands
    idx, f_ext = _band_layout(p, n_az)
    a = steering_matrix(p, f_ext).to(torch.complex128)         # (P, K, M)
    ah = a.conj().transpose(-1, -2)
    gram = ah @ a
    eps = 1e-6 * torch.diagonal(gram, dim1=-2, dim2=-1).abs().mean()
    w = torch.linalg.solve(gram + eps * torch.eye(m, dtype=gram.dtype), ah)
    # the band at position idx[b, m] = block * n_az + b: its block is the
    # row it takes (the offset within the block is always b)
    block = torch.from_numpy(idx // n_az)
    rows = torch.empty_like(w)
    rows[torch.arange(n_az)[:, None], block] = w
    return (m * rows).to(torch.complex64).to(device)


def reconstruct(raw_channels, p: HrwsParams) -> torch.Tensor:
    """Unfold the aliased azimuth spectrum of a K-channel collection.

    raw_channels: (K, P, Ns) complex64, per-channel raw (or range-compressed)
    data at the *system* PRF, or a tuple / list of K (P, Ns) tensors
    (stacked here). Returns (M*P, Ns) complex64 on their device: the
    reconstructed single-channel-equivalent slow-time signal at PRF_eff =
    M*PRF (uniform grid, natural order after the inverse FFT)."""
    if isinstance(raw_channels, (tuple, list)):
        raw_channels = torch.stack(list(raw_channels), dim=0)
    k, n_az, n_rg = raw_channels.shape
    m = p.bands
    if k < m:
        raise ValueError(f"need >= {m} channels to unfold {m} bands, got {k}")
    with span("hrws.reconstruct"):
        with span("hrws.spectra"):
            # per-channel azimuth spectra at the base PRF: (K, P, Ns)
            spec = torch.fft.fft(raw_channels, dim=1)
        with span("hrws.unfold"):
            w = unfold_operator(p, n_az, raw_channels.device)
            # block j of the unfolded spectrum, bin b: sum_k W[b, j, k]
            # Y_k[b]; the product is written through the (P, M, Ns) view
            # of the (M, P, Ns) spectrum, so the band scatter costs nothing
            ext = torch.empty((m, n_az, n_rg), dtype=torch.complex64,
                              device=spec.device)
            torch.bmm(w, spec.transpose(0, 1), out=ext.transpose(0, 1))
            del spec
            count("hrws.bands", m)
        with span("hrws.inverse"):
            return torch.fft.ifft(ext.view(m * n_az, n_rg), dim=0)


def focus(rec: torch.Tensor, csa_params: csa_ops.CsaParams,
          fft_impl: str = "xla") -> torch.Tensor:
    """The reconstructed (M*P, Ns) signal -> SLC. ``fft_impl`` 'pallas':
    ``ops/csa.py::apply_csa_fused`` on the CSA kernels (K1, K2 single, K3;
    their plain versions on CPU tensors), the factors built once per
    (params, device) and kept there; any other: the grid-phase CSA
    (``apply_csa`` on ``csa_phases``, the reference's ``focus_csa``)."""
    with span("hrws.focus"):
        if fft_impl == "pallas":
            return csa_ops.apply_csa_fused(
                rec, _factors(csa_params, rec.device), "pallas")
        return csa_ops.apply_csa(
            rec, csa_ops.csa_phases(csa_params, rec.device), fft_impl)


@functools.lru_cache(maxsize=4)
def _factors(csa_params: csa_ops.CsaParams, device) -> csa_ops.CsaFactors:
    return csa_ops.csa_factors(csa_params, device)


def reconstruct_focus(raw_channels, p: HrwsParams,
                      csa_params: csa_ops.CsaParams, fft_impl: str = "xla"):
    """Held K-channel raw -> (reconstructed signal, focused SLC):
    :func:`reconstruct`, then :func:`focus` at PRF_eff.
    ``csa_params.num_pulses`` must equal M*P and ``csa_params.prf_hz`` the
    effective PRF."""
    rec = reconstruct(raw_channels, p)
    return rec, focus(rec, csa_params, fft_impl)


def collect_reconstruct_focus(trajectory, targets, echo_opts, p: HrwsParams,
                              csa_params, *, t_start: float,
                              target_velocity=(0.0, 0.0, 0.0),
                              fft_impl: str = "xla", device=None):
    """End-to-end HRWS pipeline: K-channel collection at the (deliberately
    sub-Nyquist) system PRF on ``device`` (None: the card) ->
    azimuth-spectrum unfolding -> CSA focusing at PRF_eff = M*PRF
    (:func:`reconstruct_focus`). The processing chain the reference's
    'doppler ambiguity' demo motivates (ghosts at low PRF,
    ``doppler ambiguity.html:556-570``). Returns (reconstructed slow-time
    signal, focused SLC)."""
    raw = multi_channel_phase_history(
        trajectory, targets, echo_opts, t_start=t_start,
        rx_offsets=p.rx_offsets(), target_velocity=target_velocity,
        device=device)
    return reconstruct_focus(raw, p, csa_params, fft_impl)


def ghost_free_prf(doppler_bandwidth_hz: float, num_channels: int) -> float:
    """Minimum system PRF for K channels to cover a Doppler bandwidth."""
    return doppler_bandwidth_hz / num_channels


def uniform_sampling_prf(v_platform: float, spacing_m: float,
                         num_channels: int) -> float:
    """PRF at which the K channels' effective phase centres sample slow time
    uniformly at K*PRF (best-conditioned reconstruction):
    spacing/(2V) = 1/(K*PRF)  =>  PRF = 2V/(K*spacing)."""
    return 2.0 * v_platform / (num_channels * spacing_m)


def uniform_sampling_spacing(v_platform: float, prf_hz: float,
                             num_channels: int) -> float:
    """Channel spacing for uniform effective sampling at this PRF."""
    return 2.0 * v_platform / (num_channels * prf_hz)


def dpca_condition_prf(v_platform: float, spacing_m: float) -> float:
    """PRF at which adjacent channels' effective phase centres *coincide*
    after one PRI (spacing = 2V/PRF): ideal for DPCA clutter cancellation
    but DEGENERATE for HRWS reconstruction (singular steering matrix): keep
    the operating PRF away from this point when unfolding."""
    return 2.0 * v_platform / spacing_m


def condition_numbers(p: HrwsParams, n_az: int) -> np.ndarray:
    """Per-Doppler-bin condition number of the steering matrix, (n_az,):
    the noise amplification diagnostic of the non-uniform-sampling
    tradeoff."""
    _, f_ext = _band_layout(p, n_az)
    return np.linalg.cond(steering_matrix(p, f_ext).numpy())
