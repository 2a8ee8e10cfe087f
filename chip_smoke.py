#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Drives the two-channel ATI/DPCA GMTI CPI of the port package
``nis_sar_amtigmti_video_tpu_torch`` (scene -> two-channel echo -> DPCA
shift -> CSA x2 -> balance / ATI / DPCA / CA-CFAR) at the 4096 x 4096 CPI
shape, through the four hand-written CUDA kernels (K1g, K2 pair, K3g, K4),
and the single-channel CSA kernels (K1, K2 single, K3) and the raw balance
kernel on the formation-only stream, the composed GMTI route with
fft_impl='pallas' and the split CPI. Phases, one line each; any failure
raises and the exit code is non-zero:

  1. device   the card's name and power limit (nvidia-smi); no CUDA: fail
  2. build    nvcc builds csrc/*.cu (timed)
  3. kernels  each GMTI kernel vs its plain PyTorch version on the card, on
              seeded 4096^2 planes with the slice scenario's factors: error
              and time (CUDA events, median of 5 after a warm-up) of both;
              K1g's time as a multiple of torch.fft.fft's over both
              channels' azimuth axis, the K2 pair's as a multiple of the
              composed torch.fft range pass's (fft, x Phi2, ifft, x Phi3 on
              both channels as a stack, the phases built outside the
              timing); K1g's, the K2 pair's and K3g's shares of their byte
              bounds, K1g's and K3g's column_plans and K2's k2_plan
  3c. upstream the same four kernels, and the raw balance, K1, K2 single
              and K3, at the upstream's CPI, 7,199 x 13,200 (the factored
              azimuth, 23 x 313; mixed-radix range) and 7,200 x 13,200 (32
              x 225), and at 7,193 x 13,200 (a chirp-z azimuth), with the
              axis plans built once: each vs its plain version to the card
              tests' bounds, its launches from counters reset just before
              one call (one each, the factored and chirp-z column passes
              too), its ms beside its byte bound and its share of it, with
              the azimuth plan's kind
  3b. csa     K1, K2 single, K3 and the raw balance on the same inputs vs
              their plain versions (<= 1e-4 of the peak, balance angle
              <= 1e-5 rad); K1, K2 single and K3 bit for bit against K1g, K2
              pair and K3g on channel 1; two balance launches bit for bit;
              times of each, its plain version and (K1, K3, balance) the
              one PyTorch call computing the same function, (K2 single)
              the composed torch.fft range pass on channel 1; K1's and
              K3's times as multiples of torch.fft.fft's / torch.fft.ifft's
              and their shares of their byte bounds and their column_plans,
              K2 single's as a multiple of the composed pass's and its
              share; the balance's as a multiple of torch.vdot's and its
              share
  4. main     models.gmti.run(path='kernel_fused') on the card: every launch
              counter must rise, every product plane be finite, and the
              products agree with path='composed' on the same raw; the CPI
              time of both paths, timed in 10 alternating pairs
  4b. form    the reference bench's formation-only stream: config.videosar()
              radar at 4096 x 4096, seeded (2, 2, 4096, 4096) planes through
              apply_csa_pallas_planes (each of K1 / K2 / K3 launched 4 times)
              vs apply_csa_fused(..., 'xla') on the same data (<= 2e-3 of the
              peak at the 600 MHz waveform); ms per plane, 5 alternating pairs
  4c. pallas  focus_and_products(path='composed') with fft_impl='pallas' on
              phase 4's raw pair (K1 / K2 / K3 twice each) vs the torch.fft
              composed route to phase 4's bounds; CPI ms, 5 alternating pairs
  4d. split   gmti_cpi(k1_impl='split') (raw balance, K1 + K2 single per
              channel, K3g, K4) vs 'fused2ch' on the same raw pair: cal
              <= 1e-5 rad, SLC planes and dmag <= 1e-5 of the peak, SNR by
              K4's rule away from the threshold where the power does not
              follow cal; with balance=False every product bit for bit; CPI
              ms, 5 alternating pairs
  5. golden   the kernel path and the 4c route (balance=False) against the
              float64 NumPy oracle's CSA of both shifted channels: < 0.1 dB
              intensity and < 1e-3 rad ATI phase on pixels above 5 % of the
              peak

Then the VideoSAR fast-backprojection slice at config.videosar()'s full
per-frame width (CPI 2,500 pulses x 22,004 samples, nfft 32,768, 512 x 512
output), through the three recentre kernels (forward spectra, recentre from
spectra, fused recentre + presum) and the two accumulate kernels (pixel
tile, coarse-tile factorized):

  6. bp       each recentre kernel vs its plain version on seeded raw pulses
              with the collect's plan, presum and band rows (<= 1e-4 of the
              peak); forward spectra then recentre from spectra vs the fused
              kernel; ring offsets 500 / 1000 / 2000 bit-identical to the
              chronological order; pulses [1000, 1500) alone give rows
              [250, 375) of both recentre kernels bit for bit; times
              (CUDA events, median of 5 after a warm-up) of each kernel,
              its plain version and cuFFT's transform beside the forward
              spectra, with its multiple of torch.fft.fft's time and its
              share of its byte bound; the forward spectra again at the
              ring path's launch shape (one 500-pulse step), bit for bit
              the first 500 pulses of the 2,500-pulse launch, with the same
              multiple and share
  7. acc      the two fast-BP accumulate kernels (pixel tile, coarse-tile
              factorized) vs their plain versions (<= 1e-4 of the peak) on
              operands made as backproject_fast makes them: the fused
              recentre kernel on the first CPI of seeded raw pulses, then the
              frame geometry and coefficient fit; the pixel kernel with the
              collect's 64-sample-window plan (1,664 x 640), the factorized
              one with the first CPI's factor plan (1,664 x 768, 10 sub-
              apertures); two launches bit for bit; times of each and its
              plain version; bounds with the contraction on the tensor
              cores (three TF32 passes) and on the f32 FMA pipe
  8. videosar models.videosar.run(num_frames=6) on the destroyer scene with
              bp_backend 'fast_factor' and 'fast_pallas' (the pixel-tile
              accumulate kernel), each per frame (mode A) and on the spectra
              ring (mode B): the kernels of each run launch, one
              direct-echo launch a segment (echo_direct, the 'jnp' engine
              on the card; counters reset just before each run), the
              (6, 512, 512) frames are finite and the modes agree to 2e-3 of
              the peak; formation ms per frame of both backends in each mode
              on held inputs, timed in alternating pairs; then
              focus_bp_fast(accumulate='factor_kernel') on the first CPI's
              factor plan, against
              accumulate='factor_pallas' on the same plan
  9. bp gold  frame 0 of mode A of both backends and the 'factor_kernel'
              frame against the port's exact float64 backprojection of
              8x-upsampled range data (computed once): < 0.15 dB and
              < 0.02 rad at the peak, < 1.5 % field error

Then the NUFFT echo and the full-scale two-channel chain of the reference
bench's e2e_fullscale (config.ati_dpca() at 7,200 pulses x 13,200 samples a
channel, 500 MHz, fs 600 MHz, Tp 20 us, the centred window; the destroyer
turned by 90 degrees plus 5,000 clutter points), through the spread (roll
and one-accumulator orders), FFT-conv and direct-echo kernels:

  10. echo    the operands of the e2e pass's first 512-pulse chunk
              (echo.scalar_fields, echo_freq.kernel_operands): the main
              spread (win 4,096, one set of 8 taps) and the edge spread (win
              2,048, two sets of 6) in both orders vs the plain version on
              its first 16 pulses (<= 1e-5 of the peak; two launches
              bit-identical), timed on the whole chunk; the conv (512 x
              50,420 column views of the placed field, rows 50,432 floats
              apart, as the pass hands them, nfft 65,536, band rows
              187-394) vs its plain version (<= 3e-5; two launches
              bit-identical) beside torch.fft's fft / multiply / ifft; the
              window placement of the chunk's main and edge passes (the
              arguments synthesize hands it) vs its plain version, the row
              loop, bit for bit; the spread of the taps it forms from the
              chunk's operands (ES taps, flank taps) vs the values
              staging's windows, bit for bit, timed beside it; the
              direct-echo kernel on the two launches of phase 12's pallas
              path (the ship's and the clutter's scalar fields, <= 2e-4);
              the fused direct engine (echo_direct) at a VideoSAR ring
              segment (500 pulses x 35 targets x 22,004 samples, as
              videosar.run holds them on the card) vs the plain chunked
              engine (echo._direct) on the same card tensors (<= 2e-4; two
              launches bit-identical); times of each launch and its plain
              version
  11. e2e     multi_channel_phase_history(backend='freq') then
              focus_and_products: the spread of formed taps 2 x 29 (of
              values none), placement 2 x 29 and conv 29 launches a pass,
              a finite (2, 7200, 13200) raw and finite products; warm sim
              pass / 2 and end to end (medians of 3); one pass under
              torch.profiler (device busy, idle share, device time by
              kernel and operator, aten::copy_ always); the same pass
              through the one-accumulator spread (<= 1e-5 of the peak)
  12. gold    the freq echo vs the port's plain direct engine (echo._direct
              on the card) at 7,200 x 13,200 for the destroyer moving at
              (0, 4, 0) m/s: field RMS error < -55 dB; after
              focus_and_products(balance=False), < 0.1 dB and < 1e-3 rad
              ATI phase above 5 % of the peak; the fused direct engine's
              raw there vs the plain one (<= 2e-4); then
              simulate_two_channel(echo_backend='pallas') on phase 4's scene
              and phase 4's raw (the fused engine) each vs the plain direct
              engine's raw of that scene (<= 2e-4; the kernel launches)

The line before the last is a JSON record of each kernel; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
A "[time]" line gives each phase's seconds. Imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import time

import numpy as np
import torch

import oracle
from bench_torch.peaks import bound_by, bound_ms
from nis_sar_amtigmti_video_tpu_torch import config
from nis_sar_amtigmti_video_tpu_torch.gmti import dpca, fused
from nis_sar_amtigmti_video_tpu_torch.gmti.cfar import CfarParams
from nis_sar_amtigmti_video_tpu_torch.geometry import orbit
from nis_sar_amtigmti_video_tpu_torch.models import gmti, videosar
from nis_sar_amtigmti_video_tpu_torch.models.stripmap import echo_opts_for
from nis_sar_amtigmti_video_tpu_torch.ops import (bp, bp_fast, csa, echo,
                                                  echo_freq)
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (_build,
                                                       bp_factor_kernel,
                                                       bp_kernel, csa_kernel,
                                                       echo_kernel,
                                                       fft_kernel,
                                                       gmti_kernel,
                                                       spread_kernel)
from nis_sar_amtigmti_video_tpu_torch.ops.echo import (
    multi_channel_phase_history, phase_history, window_start_time)
from nis_sar_amtigmti_video_tpu_torch.scene import targets
from nis_sar_amtigmti_video_tpu_torch.scene.clutter import ocean_clutter_field
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import (cuda_times_ms,
                                                               median_ms)
from nis_sar_amtigmti_video_tpu_torch.video import scheduler

N = 4096                      # the headline CPI: 4096 x 4096 after the shift
# the upstream's CPI (sar_ati_dcpa_sim_csa.py): 7,199 x 13,200 after the
# DPCA one-pulse shift, 7,200 x 13,200 unshifted
UPSTREAM_SHAPES = ((7199, 13200), (7200, 13200), (7193, 13200))
SHIP_VELOCITY = (15.0, 0.0, 0.0)
WRAPPERS = {                  # name -> (wrapper, source, TPU kernel replaced)
    "K1g": (gmti_kernel.k1_gmti_planes,
            "nis_sar_amtigmti_video_tpu_torch/csrc/gmti_kernel.cu",
            "nis_sar_amtigmti_video_tpu/ops/pallas/gmti_kernel.py:284"),
    "K2 pair": (csa_kernel.k2_pair_call,
                "nis_sar_amtigmti_video_tpu_torch/csrc/csa_kernel.cu",
                "nis_sar_amtigmti_video_tpu/ops/pallas/csa_kernel.py:412"),
    "K3g": (gmti_kernel.k3_gmti_planes,
            "nis_sar_amtigmti_video_tpu_torch/csrc/gmti_kernel.cu",
            "nis_sar_amtigmti_video_tpu/ops/pallas/gmti_kernel.py:362"),
    "K4": (gmti_kernel.k4_epilogue_planes,
           "nis_sar_amtigmti_video_tpu_torch/csrc/gmti_kernel.cu",
           "nis_sar_amtigmti_video_tpu/ops/pallas/gmti_kernel.py:460"),
}
CSA_WRAPPERS = {
    "K1": (csa_kernel.k1_call,
           "nis_sar_amtigmti_video_tpu_torch/csrc/gmti_kernel.cu",
           "nis_sar_amtigmti_video_tpu/ops/pallas/csa_kernel.py:230"),
    "K2 single": (csa_kernel.k2_call,
                  "nis_sar_amtigmti_video_tpu_torch/csrc/csa_kernel.cu",
                  "nis_sar_amtigmti_video_tpu/ops/pallas/csa_kernel.py:493"),
    "K3": (csa_kernel.k3_call,
           "nis_sar_amtigmti_video_tpu_torch/csrc/gmti_kernel.cu",
           "nis_sar_amtigmti_video_tpu/ops/pallas/csa_kernel.py:265"),
    "balance": (gmti_kernel.raw_balance,
                "nis_sar_amtigmti_video_tpu_torch/csrc/gmti_kernel.cu",
                "nis_sar_amtigmti_video_tpu/ops/pallas/gmti_kernel.py:162"),
}
BP_WRAPPERS = {
    "forward_spectra": (
        fft_kernel.forward_spectra,
        "nis_sar_amtigmti_video_tpu_torch/csrc/fft_kernel.cu",
        "nis_sar_amtigmti_video_tpu/ops/pallas/fft_kernel.py:570"),
    "recentre_from_spectra": (
        fft_kernel.recentre_from_spectra,
        "nis_sar_amtigmti_video_tpu_torch/csrc/fft_kernel.cu",
        "nis_sar_amtigmti_video_tpu/ops/pallas/fft_kernel.py:674"),
    "recenter_presum": (
        fft_kernel.recenter_presum,
        "nis_sar_amtigmti_video_tpu_torch/csrc/fft_kernel.cu",
        "nis_sar_amtigmti_video_tpu/ops/pallas/fft_kernel.py:418"),
}
ACC_WRAPPERS = {
    "accumulate_pallas": (
        bp_kernel.accumulate_pallas,
        "nis_sar_amtigmti_video_tpu_torch/csrc/bp_kernel.cu",
        "nis_sar_amtigmti_video_tpu/ops/pallas/bp_kernel.py:214"),
    "accumulate_factor_pallas": (
        bp_factor_kernel.accumulate_factor_pallas,
        "nis_sar_amtigmti_video_tpu_torch/csrc/bp_kernel.cu",
        "nis_sar_amtigmti_video_tpu/ops/pallas/bp_factor_kernel.py:230"),
}
BP_ALL = {**BP_WRAPPERS, **ACC_WRAPPERS}
ECHO_WRAPPERS = {
    "spread": (spread_kernel.spread_windows_pallas,
               "nis_sar_amtigmti_video_tpu_torch/csrc/spread_kernel.cu",
               "nis_sar_amtigmti_video_tpu/ops/pallas/spread_kernel.py:214"),
    "spread_qr": (spread_kernel.spread_windows_pallas,
                  "nis_sar_amtigmti_video_tpu_torch/csrc/spread_kernel.cu",
                  "nis_sar_amtigmti_video_tpu/ops/pallas/spread_kernel.py:"
                  "214"),
    "spread_taps": (spread_kernel.spread_windows_pallas,
                    "nis_sar_amtigmti_video_tpu_torch/csrc/spread_kernel.cu",
                    "nis_sar_amtigmti_video_tpu/ops/pallas/spread_kernel.py:"
                    "214 with the echo's per-tap operand math of "
                    "nis_sar_amtigmti_video_tpu/ops/echo_freq.py"),
    "fft_conv": (fft_kernel.fft_conv_pallas,
                 "nis_sar_amtigmti_video_tpu_torch/csrc/fft_kernel.cu",
                 "nis_sar_amtigmti_video_tpu/ops/pallas/fft_kernel.py:767"),
    "place": (spread_kernel.place_windows,
              "nis_sar_amtigmti_video_tpu_torch/csrc/spread_kernel.cu",
              "none (the reference places the windows with jnp: "
              "nis_sar_amtigmti_video_tpu/ops/echo_freq.py::_spread_dense)"),
    "echo_accumulate": (
        echo_kernel.echo_accumulate,
        "nis_sar_amtigmti_video_tpu_torch/csrc/echo_kernel.cu",
        "nis_sar_amtigmti_video_tpu/ops/pallas/echo_kernel.py:123"),
    "echo_direct": (
        echo_kernel.echo_direct,
        "nis_sar_amtigmti_video_tpu_torch/csrc/echo_kernel.cu",
        "none (the reference's direct engine is jnp: "
        "nis_sar_amtigmti_video_tpu/ops/echo.py::_direct)"),
}
ALL_WRAPPERS = {**WRAPPERS, **CSA_WRAPPERS, **BP_ALL, **ECHO_WRAPPERS}
# the wrapper attribute counting an entry's launches, where not .launches
COUNTER = {"spread_qr": "launches_qr", "spread_taps": "launches_taps"}
# f32 planes of N^2 each kernel reads plus writes (PR 1's bytes column)
GMTI_PLANES = {"K1g": 8, "K2 pair": 8, "K3g": 13, "K4": 9}
# and the single-channel kernels' (phase 3b's bytes)
CSA_PLANES = {"K1": 4, "K2 single": 4, "K3": 4, "balance": 4}
SHIP_SPEED, SHIP_HEADING = 15.0, 45.0
VS_FRAMES = 6
E2E_CHUNKS = 29        # 512-pulse chunks of the 2 x 7,200-pulse NUFFT echo
PLAIN_CUT = 16         # pulses of a chunk the plain spread is held on


def slice_scenario(n_pulses: int, n_samples: int):
    """config.ati_dpca() shrunk by the CLI's --small waveform rule (BW
    120 MHz, Tp 2 us, fs 150 MHz; aperture n_pulses / PRF, window
    n_samples / fs), with the durations nudged until float rounding gives
    exactly (n_pulses, n_samples) raw samples."""
    sc = config.ati_dpca()
    prf = sc.radar.prf_hz
    radar = dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                pulse_width_s=2e-6, fs_hz=150e6)
    t_int, win = n_pulses / prf, n_samples / 150e6
    for _ in range(8):
        collect = dataclasses.replace(sc.collect, integration_time_s=t_int,
                                      window_length_s=win)
        got = (collect.num_pulses(prf), collect.num_samples(150e6))
        if got == (n_pulses, n_samples):
            return sc.replace(radar=radar, collect=collect)
        t_int *= 1 - 1e-12 if got[0] > n_pulses else 1 + 1e-12
        win *= 1 + 1e-12 if got[1] < n_samples else 1 - 1e-12
    raise RuntimeError(f"cannot reach {(n_pulses, n_samples)}: got {got}")


def composed_range_pass(z, phi2, phi3):
    """One PyTorch composition of K2's function on complex rows: range FFT,
    x Phi2, range IFFT, x Phi3 (the library yardstick beside K2)."""
    return torch.fft.ifft(torch.fft.fft(z, dim=-1) * phi2, dim=-1) * phi3


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def phase_device(dev):
    name = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    print(f"[1 device] {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    return name


def phase_build():
    t = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"[2 build] {path.name} in {time.perf_counter() - t:.2f} s")


def kernel_inputs(dev, n_az: int = N, n_rg: int = N):
    """The slice scenario's factors at (n_az, n_rg) (4096^2 unless given)
    and four seeded planes: channel 2 is channel 1 rotated by 0.31 rad plus
    5 % independent noise."""
    sc = slice_scenario(n_az + 1, n_rg)
    g, r = sc.geometry, sc.radar
    t0 = 2.0 * g.slant_range_m / 299792458.0 - r.pulse_width_s / 2 - 1e-6
    f = csa.csa_factors(csa.CsaParams(
        wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
        prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m, t_start_fast=t0, num_pulses=n_az,
        num_samples=n_rg), dev)
    rng = np.random.default_rng(0)
    x1r, x1i, n2r, n2i = (rng.standard_normal((n_az, n_rg), dtype=np.float32)
                          for _ in range(4))
    c, s = np.float32(math.cos(0.31)), np.float32(math.sin(0.31))
    return f, [torch.from_numpy(v).to(dev) for v in
               (x1r, x1i, c * x1r - s * x1i + 0.05 * n2r,
                s * x1r + c * x1i + 0.05 * n2i)]


def phase_kernels(dev) -> dict:
    """Each kernel vs its plain version on the same seeded 4096^2 inputs
    (each stage fed the plain result of the stage before)."""
    f, x = kernel_inputs(dev)
    cp = CfarParams()
    h_out, h_in = cp.guard + cp.train, cp.guard
    # the per-configuration plans, built once as the main path's GmtiCpi
    # holds them (the wrappers would otherwise rebuild them per call)
    az, rg = csa_kernel.azimuth_plan(N, dev), csa_kernel.range_plan(N, dev)
    counts = gmti_kernel.cfar_counts(N, N, h_out, h_in, dev)
    rec = {}

    def timed(name, kernel, plain):
        ms = median_ms(kernel)
        plain_ms = median_ms(plain)
        rec[name].update(ms=ms, plain_ms=plain_ms)

    # K1g
    got = gmti_kernel.k1_gmti_planes(*x, f, plan=az)
    ref = gmti_kernel.k1_gmti_plain(*x, f)
    err = max(rel_err(a, b) for a, b in zip(got[:4], ref[:4]))
    bal = rel_err(torch.stack(got[4:]), torch.stack(ref[4:]))
    assert err <= 1e-4 and bal <= 1e-4, (err, bal)
    rec["K1g"] = dict(max_abs_err=max(float((a - b).abs().max())
                                      for a, b in zip(got[:4], ref[:4])))
    timed("K1g", lambda: gmti_kernel.k1_gmti_planes(*x, f, plan=az),
          lambda: gmti_kernel.k1_gmti_plain(*x, f))
    # cuFFT's azimuth transform of both channels, built outside the timing
    xc = torch.stack([torch.complex(x[0], x[1]), torch.complex(x[2], x[3])])
    rec["K1g"]["library_ms"] = median_ms(lambda: torch.fft.fft(xc, dim=1))
    del xc
    r = rec["K1g"]
    share = bound(GMTI_PLANES["K1g"] * 4.0 * N * N, 0.0)["bound_ms"] / r["ms"]
    print(f"[3 kernels] K1g  rel err {err:.2e} (balance sums {bal:.2e}); "
          f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms, one PyTorch "
          f"call {r['library_ms']:.3f} ms; {r['ms'] / r['library_ms']:.2f}x "
          f"torch.fft.fft's time (2 channels, dim 1), {share:.1%} of its byte"
          f" bound; plan {csa_kernel.column_plan(N, N, 2, forward=True)}")
    z, xs = ref[:4], ref[4:]
    del got, ref

    # K2 pair
    got = csa_kernel.k2_pair_call(*z, f, plan=rg)
    ref = csa_kernel.k2_pair_plain(*z, f)
    err = max(rel_err(a, b) for a, b in zip(got, ref))
    assert err <= 1e-4, err
    rec["K2 pair"] = dict(max_abs_err=max(float((a - b).abs().max())
                                          for a, b in zip(got, ref)))
    timed("K2 pair", lambda: csa_kernel.k2_pair_call(*z, f, plan=rg),
          lambda: csa_kernel.k2_pair_plain(*z, f))
    # the composed torch.fft range pass of both channels as a stack, the
    # phases built outside the timing
    phi2, phi3 = csa_kernel._k2_phases(f)
    zc = torch.stack([torch.complex(z[0], z[1]), torch.complex(z[2], z[3])])
    rec["K2 pair"]["library_ms"] = median_ms(
        lambda: composed_range_pass(zc, phi2, phi3))
    del zc, phi2, phi3
    r = rec["K2 pair"]
    share = bound(GMTI_PLANES["K2 pair"] * 4.0 * N * N, 0.0)["bound_ms"] \
        / r["ms"]
    print(f"[3 kernels] K2 pair rel err {err:.2e}; {r['ms']:.3f} ms vs plain "
          f"{r['plain_ms']:.3f} ms, the composed torch.fft pass "
          f"{r['library_ms']:.3f} ms; {r['ms'] / r['library_ms']:.2f}x its "
          f"time, {share:.1%} of its byte bound; plan "
          f"{csa_kernel.k2_plan(N)}")
    z = ref
    del got

    # K3g
    cal = torch.atan2(xs[1], xs[0])
    cal_cs = torch.stack([torch.cos(cal), torch.sin(cal)])
    got = gmti_kernel.k3_gmti_planes(*z, cal_cs, h_out=h_out, h_in=h_in,
                                     plan=az)
    ref = gmti_kernel.k3_gmti_plain(*z, cal_cs, h_out=h_out, h_in=h_in)
    errs = {i: rel_err(got[i], ref[i]) for i in (0, 1, 2, 3, 5, 6, 7, 8, 9)}
    assert max(errs.values()) <= 1e-4, errs
    mag, peak2 = ref[5], ref[9].max()
    thr = 0.05 ** 2 * peak2
    clear = (mag > thr) & ((mag - thr).abs() > 1e-3 * peak2)
    dphi = torch.remainder(got[4] - ref[4] + math.pi, 2 * math.pi) - math.pi
    med = float(dphi[clear].abs().median())
    assert med <= 1e-3, med
    rec["K3g"] = dict(max_abs_err=max(float((got[i] - ref[i]).abs().max())
                                      for i in errs))
    timed("K3g", lambda: gmti_kernel.k3_gmti_planes(
        *z, cal_cs, h_out=h_out, h_in=h_in, plan=az),
        lambda: gmti_kernel.k3_gmti_plain(*z, cal_cs, h_out=h_out,
                                          h_in=h_in))
    share = bound(GMTI_PLANES["K3g"] * 4.0 * N * N, 0.0)["bound_ms"] \
        / rec["K3g"]["ms"]
    print(f"[3 kernels] K3g  rel err {max(errs.values()):.2e}; median ATI "
          f"phase err {med:.2e} rad over {int(clear.sum())} px; "
          f"{rec['K3g']['ms']:.3f} ms vs plain {rec['K3g']['plain_ms']:.3f}"
          f" ms; {share:.1%} of its byte bound; plan "
          f"{csa_kernel.column_plan(N, N, 2)}")
    p3 = ref
    del got, z

    # K4
    args = (p3[7], p3[8], p3[6], p3[4], p3[5], thr)
    got = gmti_kernel.k4_epilogue_planes(*args, h_out=h_out, h_in=h_in,
                                         counts=counts)
    ref = gmti_kernel.k4_epilogue_plain(*args, h_out=h_out, h_in=h_in,
                                        counts=counts)
    away = (ref[0] - cp.alpha).abs() > 1e-2 * cp.alpha
    snr_bad = int(((got[0] - ref[0]).abs()
                   > 5e-3 * ref[0].abs() + 1e-6)[away].sum())
    assert snr_bad == 0, snr_bad
    assert torch.equal(got[1], ref[1])            # phase mask
    err = max(rel_err(got[i], ref[i]) for i in (2, 3))
    assert err <= 1e-4, err
    rec["K4"] = dict(max_abs_err=max(float((a - b).abs().max())
                                     for a, b in zip(got[1:], ref[1:])))
    timed("K4", lambda: gmti_kernel.k4_epilogue_planes(
        *args, h_out=h_out, h_in=h_in, counts=counts),
        lambda: gmti_kernel.k4_epilogue_plain(*args, h_out=h_out, h_in=h_in,
                                              counts=counts))
    snr_rel = float(((got[0] - ref[0]).abs() / ref[0].abs().clamp(
        min=1e-30))[away].max())
    print(f"[3 kernels] K4   snr rel err {snr_rel:.2e} away from the "
          f"threshold; dmag/noise rel err {err:.2e}; "
          f"{rec['K4']['ms']:.3f} ms vs plain {rec['K4']['plain_ms']:.3f} ms")
    return rec


def phase_upstream(dev) -> dict:
    """K1g, the K2 pair, K3g and K4, and the split route's raw balance, K1,
    K2 single and K3 (channel 1), at the upstream's CPI (UPSTREAM_SHAPES)
    on phase 3's seeded planes and slice factors at that shape, each stage
    fed the plain result of the stage before, the axis plans built once as
    GmtiCpi holds them: each against its plain version to the card tests'
    bounds (planes 1e-4 of the peak, balance angle 1e-5 rad, K3g's ATI
    phase 1e-3 rad on strong pixels, K4's SNR rtol 1e-4, phase mask exact,
    dmag rtol 1e-6); its launches, from the counters reset just before one
    call (one each, the factored and chirp-z column passes too); its time
    (CUDA events, median of 5 after a warm-up) beside its byte bound, with
    the azimuth plan's kind (``factored`` at 7,199 and 7,200, ``chirpz`` at
    7,193)."""
    cp = CfarParams()
    h_out, h_in = cp.guard + cp.train, cp.guard
    out = {}
    for n_az, n_rg in UPSTREAM_SHAPES:
        f, x = kernel_inputs(dev, n_az, n_rg)
        az = csa_kernel.azimuth_plan(n_az, dev)
        rg = csa_kernel.range_plan(n_rg, dev)
        counts = gmti_kernel.cfar_counts(n_az, n_rg, h_out, h_in, dev)
        key = f"{n_az}x{n_rg}"

        def run(name, kernel, plain, check):
            reset_launches()
            got = kernel()
            launches = launch_counts({**WRAPPERS, **CSA_WRAPPERS})[name]
            assert launches == 1, launches
            want = plain()
            err = check(got, want)
            ms = median_ms(kernel)
            b = bound({**GMTI_PLANES, **CSA_PLANES}[name] * 4.0 * n_az
                      * n_rg, 0.0)
            out.setdefault(name, {})[key] = dict(
                ms=ms, bound_ms=b["bound_ms"], launches=launches,
                rel_err=err)
            print(f"[3c upstream] {key} ({az.kind}) {name} rel err {err:.2e}; "
                  f"{ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
                  f"({b['bound_ms'] / ms:.1%}); {launches} launch(es)")
            return want

        def planes_err(got, want, idx):
            err = max(rel_err(got[i], want[i]) for i in idx)
            assert err <= 1e-4, err
            return err

        def k1g_check(got, want):
            d = abs(float(torch.atan2(got[5], got[4])
                          - torch.atan2(want[5], want[4])))
            assert d <= 1e-5, d
            return planes_err(got, want, range(4))

        ref = run("K1g", lambda: gmti_kernel.k1_gmti_planes(
            *x, f, plan=az), lambda: gmti_kernel.k1_gmti_plain(*x, f),
            k1g_check)

        def balance_check(got, want):
            d = abs(float(torch.atan2(got[1], got[0])
                          - torch.atan2(want[1], want[0])))
            assert d <= 1e-5, d
            err = rel_err(torch.stack(got), torch.stack(want))
            assert err <= 1e-4, err
            return err

        run("balance", lambda: gmti_kernel.raw_balance(*x),
            lambda: gmti_kernel.raw_balance_plain(*x), balance_check)
        run("K1", lambda: csa_kernel.k1_call(x[0], x[1], f, plan=az),
            lambda: csa_kernel.k1_plain(x[0], x[1], f),
            lambda got, want: planes_err(got, want, range(2)))
        z, xs = ref[:4], ref[4:]
        del x, ref
        run("K2 single",
            lambda: csa_kernel.k2_call(z[0], z[1], f, plan=rg),
            lambda: csa_kernel.k2_plain(z[0], z[1], f),
            lambda got, want: planes_err(got, want, range(2)))
        z = run("K2 pair",
                lambda: csa_kernel.k2_pair_call(*z, f, plan=rg),
                lambda: csa_kernel.k2_pair_plain(*z, f),
                lambda got, want: planes_err(got, want, range(4)))
        run("K3", lambda: csa_kernel.k3_call(z[0], z[1], plan=az),
            lambda: csa_kernel.k3_plain(z[0], z[1]),
            lambda got, want: planes_err(got, want, range(2)))
        cal = torch.atan2(xs[1], xs[0])
        cal_cs = torch.stack([torch.cos(cal), torch.sin(cal)])

        def k3g_check(got, want):
            err = planes_err(got, want, (0, 1, 2, 3, 5, 6, 7, 8, 9))
            strong = want[5] > 1e-2 * want[5].max()
            dph = torch.remainder(got[4] - want[4] + math.pi,
                                  2 * math.pi) - math.pi
            assert float(dph[strong].abs().max()) < 1e-3
            return err

        p3 = run("K3g", lambda: gmti_kernel.k3_gmti_planes(
            *z, cal_cs, h_out=h_out, h_in=h_in, plan=az),
            lambda: gmti_kernel.k3_gmti_plain(*z, cal_cs, h_out=h_out,
                                              h_in=h_in), k3g_check)
        del z
        args = (p3[7], p3[8], p3[6], p3[4], p3[5],
                0.05 ** 2 * p3[9].max())

        def k4_check(got, want):
            torch.testing.assert_close(got[0], want[0], rtol=1e-4,
                                       atol=1e-6)
            assert torch.equal(got[1], want[1])
            torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
            return max(rel_err(got[i], want[i]) for i in (0, 2, 3))

        run("K4", lambda: gmti_kernel.k4_epilogue_planes(
            *args, h_out=h_out, h_in=h_in, counts=counts),
            lambda: gmti_kernel.k4_epilogue_plain(
                *args, h_out=h_out, h_in=h_in, counts=counts), k4_check)
        del p3, args
        torch.cuda.empty_cache()
    return out


def phase_csa_kernels(dev) -> dict:
    """K1, K2 single, K3 and the raw balance vs their plain versions on
    phase 3's inputs (K2 and K3 fed the plain result of the stage before),
    and K1 / K2 single / K3 bit for bit against their two-channel twins."""
    f, x = kernel_inputs(dev)
    az, rg = csa_kernel.azimuth_plan(N, dev), csa_kernel.range_plan(N, dev)
    plane_bytes, fft_ops = 4.0 * N * N, 5.0 * N * N * math.log2(N)
    rec = {}

    def record(name, got, want, twin, kernel, plain, n_bytes, n_flops,
               lib=None):
        err = max(rel_err(a, b) for a, b in zip(got, want))
        assert err <= 1e-4, (name, err)
        if twin is not None:
            assert all(torch.equal(a, b) for a, b in zip(got, twin)), name
        rec[name] = dict(max_abs_err=max(float((a - b).abs().max())
                                         for a, b in zip(got, want)),
                         ms=median_ms(kernel), plain_ms=median_ms(plain),
                         library_ms=None if lib is None else median_ms(lib),
                         **bound(n_bytes, n_flops))
        r = rec[name]
        lib_s = ("" if lib is None
                 else f", one PyTorch call {r['library_ms']:.3f} ms")
        twin_s = "" if twin is None else "; bit-identical to its pair twin"
        print(f"[3b csa] {name} rel err {err:.2e}{twin_s}; {r['ms']:.3f} ms "
              f"vs plain {r['plain_ms']:.3f} ms{lib_s}; bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']})")

    # K1 (channel 1) against K1g's channel 1; cuFFT's azimuth fft beside it
    pair = gmti_kernel.k1_gmti_planes(*x, f, plan=az)
    xc = torch.complex(x[0], x[1])
    record("K1", csa_kernel.k1_call(x[0], x[1], f, plan=az),
           csa_kernel.k1_plain(x[0], x[1], f), pair[:2],
           lambda: csa_kernel.k1_call(x[0], x[1], f, plan=az),
           lambda: csa_kernel.k1_plain(x[0], x[1], f),
           4 * plane_bytes, fft_ops + 10.0 * N * N,
           lib=lambda: torch.fft.fft(xc, dim=0))
    r = rec["K1"]
    print(f"[3b csa] K1 {r['ms'] / r['library_ms']:.2f}x torch.fft.fft's "
          f"time, {r['bound_ms'] / r['ms']:.1%} of its byte bound; plan "
          f"{csa_kernel.column_plan(N, N, 1, forward=True)}")
    z = gmti_kernel.k1_gmti_plain(*x, f)[:4]
    del pair, xc

    # K2 single (channel 1) against the K2 pair's channel 1; the composed
    # torch.fft range pass of channel 1 beside it
    pair = csa_kernel.k2_pair_call(*z, f, plan=rg)
    phi2, phi3 = csa_kernel._k2_phases(f)
    zc = torch.complex(z[0], z[1])
    record("K2 single", csa_kernel.k2_call(z[0], z[1], f, plan=rg),
           csa_kernel.k2_plain(z[0], z[1], f), pair[:2],
           lambda: csa_kernel.k2_call(z[0], z[1], f, plan=rg),
           lambda: csa_kernel.k2_plain(z[0], z[1], f),
           4 * plane_bytes, 2 * fft_ops + 20.0 * N * N,
           lib=lambda: composed_range_pass(zc, phi2, phi3))
    r = rec["K2 single"]
    print(f"[3b csa] K2 single {r['ms'] / r['library_ms']:.2f}x the composed "
          f"torch.fft pass's time, {r['bound_ms'] / r['ms']:.1%} of its "
          f"byte bound; plan {csa_kernel.k2_plan(N)}")
    y = csa_kernel.k2_pair_plain(*z, f)
    del pair, z, zc, phi2, phi3

    # K3 (channel 1) against K3g's s1 (which neither cal nor the box
    # half-widths touch); cuFFT's azimuth ifft beside it
    cal_cs = torch.tensor([1.0, 0.0], device=dev)
    g3 = gmti_kernel.k3_gmti_planes(*y, cal_cs, h_out=10, h_in=2,
                                    plan=az)
    yc = torch.complex(y[0], y[1])
    record("K3", csa_kernel.k3_call(y[0], y[1], plan=az),
           csa_kernel.k3_plain(y[0], y[1]), g3[:2],
           lambda: csa_kernel.k3_call(y[0], y[1], plan=az),
           lambda: csa_kernel.k3_plain(y[0], y[1]),
           4 * plane_bytes, fft_ops + 2.0 * N * N,
           lib=lambda: torch.fft.ifft(yc, dim=0))
    r = rec["K3"]
    print(f"[3b csa] K3 {r['ms'] / r['library_ms']:.2f}x torch.fft.ifft's "
          f"time, {r['bound_ms'] / r['ms']:.1%} of its byte bound; plan "
          f"{csa_kernel.column_plan(N, N, 1)}")
    del g3, y, yc

    # raw balance: 0-d sums, angle, bit-identical repeat; torch.vdot beside
    got, want = gmti_kernel.raw_balance(*x), gmti_kernel.raw_balance_plain(*x)
    again = gmti_kernel.raw_balance(*x)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    dang = abs(float(torch.atan2(got[1], got[0])
                     - torch.atan2(want[1], want[0])))
    assert dang <= 1e-5, dang
    x1c, x2c = torch.complex(x[0], x[1]), torch.complex(x[2], x[3])
    vd = torch.vdot(x2c.flatten(), x1c.flatten())
    vang = abs(float(torch.angle(vd) - torch.atan2(want[1], want[0])))
    record("balance", [torch.stack(got)], [torch.stack(want)], None,
           lambda: gmti_kernel.raw_balance(*x),
           lambda: gmti_kernel.raw_balance_plain(*x),
           4 * plane_bytes, 8.0 * N * N,
           lib=lambda: torch.vdot(x2c.flatten(), x1c.flatten()))
    r = rec["balance"]
    blocks = gmti_kernel.balance_grid(N, N, *gmti_kernel.balance_limits(dev))
    print(f"[3b csa] balance angle {float(torch.atan2(got[1], got[0])):.7f}"
          f" rad, {dang:.1e} from plain (<= 1e-5), torch.vdot's "
          f"{vang:.1e}; two launches bit-identical; "
          f"{r['ms'] / r['library_ms']:.2f}x torch.vdot's time, "
          f"{r['bound_ms'] / r['ms']:.1%} of its byte bound on "
          f"{blocks} blocks")
    return rec


def paired_ms(fa, fb, pairs: int = 10):
    """CUDA-event ms of two callables timed in turns (a b, b a, a b, ...)
    after a warm-up of each, so both see the same card and host state."""
    fa()
    fb()
    ta, tb = [], []
    for i in range(pairs):
        turn = ((fa, ta), (fb, tb)) if i % 2 == 0 else ((fb, tb), (fa, ta))
        for fn, out in turn:
            out.append(cuda_times_ms(fn, warmup=0, reps=1)[0])
    return ta, tb


def quartiles(t) -> str:
    q1, q2, q3 = np.percentile(t, [25, 50, 75])
    return f"{q2:.3f} ms (quartiles {q1:.3f}-{q3:.3f})"


def reset_launches():
    """Every kernel's launch counter to 0."""
    for k, (wrapper, _, _) in ALL_WRAPPERS.items():
        setattr(wrapper, COUNTER.get(k, "launches"), 0)


def launch_counts(group: dict) -> dict:
    """Launch counters of the entries in ``group``."""
    return {k: getattr(w, COUNTER.get(k, "launches"))
            for k, (w, _, _) in group.items()}


def phase_main(dev):
    sc = slice_scenario(N + 1, N)
    ship = targets.destroyer()
    clut = ocean_clutter_field(np.random.default_rng(0), num_points=500)
    reset_launches()
    t = time.perf_counter()
    prod = gmti.run(sc, ship, SHIP_VELOCITY, clut, path="kernel_fused",
                    device=dev)
    torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t
    launches = {k: w.launches for k, (w, _, _) in WRAPPERS.items()}
    assert all(n > 0 for n in launches.values()), launches
    assert prod.slc1.shape == (N, N), prod.slc1.shape
    planes = dict(slc1=prod.slc1, slc2=prod.slc2, ati_phase=prod.ati_phase,
                  dpca_mag=prod.dpca_mag, velocity_map=prod.velocity_map,
                  snr=prod.detections.snr, noise=prod.detections.noise)
    bad = [k for k, v in planes.items() if not bool(torch.isfinite(v).all())]
    assert not bad, f"non-finite planes: {bad}"

    raw, _, t0 = gmti.simulate_two_channel(sc, ship, SHIP_VELOCITY, clut,
                                           device=dev)
    assert raw.shape == (2, N + 1, N), raw.shape
    comp = gmti.focus_and_products(raw, sc, t0, path="composed")
    s = float(comp.slc1.abs().max())
    agree = dict(
        slc1=float((prod.slc1 - comp.slc1).abs().max()) / s,
        dpca=float((prod.dpca_mag - comp.dpca_mag).abs().max()) / s,
        cal=abs(float(prod.cal_phase) - float(comp.cal_phase)))
    assert agree["slc1"] < 2e-3 and agree["dpca"] < 2e-3 \
        and agree["cal"] < 1e-3, agree
    del comp
    kern_ms, comp_ms = paired_ms(
        lambda: gmti.focus_and_products(raw, sc, t0, path="kernel_fused"),
        lambda: gmti.focus_and_products(raw, sc, t0, path="composed"))
    ratio_db = 20 * math.log10(float(prod.cancellation_ratio) + 1e-30)
    n_det = int(prod.detections.detections.sum())
    print(f"[4 main] run(path='kernel_fused') {tuple(raw.shape)} raw -> "
          f"{tuple(prod.slc1.shape)} CPI in {run_s:.2f} s (echo included); "
          f"launches {launches}; cal_phase {float(prod.cal_phase):.6f} rad; "
          f"cancellation {ratio_db:.2f} dB; CFAR detections {n_det}; "
          f"vs composed: slc {agree['slc1']:.1e}, dpca {agree['dpca']:.1e};"
          f" CPI (10 alternating pairs) kernel path {quartiles(kern_ms)}"
          f" vs composed {quartiles(comp_ms)}")
    return launches, raw, sc, t0


def with_fft_impl(sc, fft_impl: str):
    return sc.replace(processing=dataclasses.replace(sc.processing,
                                                     fft_impl=fft_impl))


def phase_formation(dev) -> dict:
    """The reference bench's formation-only stream (bench.py's
    csa_formation): config.videosar()'s radar at 4096 x 4096, seeded
    (ncpi 2, channels 2) planes, through apply_csa_pallas_planes against
    apply_csa_fused(..., 'xla') on the same complex data."""
    sc = config.videosar()
    g, r = sc.geometry, sc.radar
    t0 = window_start_time(g.slant_range_m, None, sc.collect.window_length_s,
                           "centered")
    f = csa.csa_factors(csa.CsaParams(
        wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
        prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m, t_start_fast=t0, num_pulses=N,
        num_samples=N), dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    xr, xi = (torch.randn((2, 2, N, N), generator=gen, device=dev)
              for _ in range(2))
    reset_launches()
    sr, si = csa_kernel.apply_csa_pallas_planes(xr, xi, f)
    torch.cuda.synchronize(dev)
    counts = launch_counts(CSA_WRAPPERS)
    assert counts == {"K1": 4, "K2 single": 4, "K3": 4, "balance": 0}, \
        counts
    assert sr.shape == (2, 2, N, N) and bool(torch.isfinite(sr).all())
    xc = torch.complex(xr, xi)
    err = rel_err(torch.complex(sr, si), csa.apply_csa_fused(xc, f, "xla"))
    assert err <= 2e-3, err
    del sr, si
    kern, xla = paired_ms(lambda: csa_kernel.apply_csa_pallas_planes(xr, xi,
                                                                     f),
                          lambda: csa.apply_csa_fused(xc, f, "xla"), pairs=5)
    per_plane = [[t / 4 for t in ts] for ts in (kern, xla)]
    print(f"[4b form] apply_csa_pallas_planes on (2, 2, {N}, {N}) planes "
          f"(config.videosar() radar): launches {counts}; vs "
          f"apply_csa_fused('xla') {err:.2e} of the peak (<= 2e-3); ms per "
          f"plane (5 alternating pairs) kernels {quartiles(per_plane[0])} vs"
          f" torch.fft {quartiles(per_plane[1])}")
    return counts


def phase_composed_pallas(dev, raw, sc, t0):
    """focus_and_products(path='composed') with fft_impl='pallas' (K1, K2
    single, K3 per channel) vs the torch.fft composed route."""
    sc_p = with_fft_impl(sc, "pallas")
    reset_launches()
    prod = gmti.focus_and_products(raw, sc_p, t0, path="composed")
    torch.cuda.synchronize(dev)
    counts = launch_counts(ALL_WRAPPERS)
    want = {k: 2 if k in ("K1", "K2 single", "K3") else 0 for k in counts}
    assert counts == want, counts
    comp = gmti.focus_and_products(raw, sc, t0, path="composed")
    s = float(comp.slc1.abs().max())
    agree = dict(
        slc1=float((prod.slc1 - comp.slc1).abs().max()) / s,
        dpca=float((prod.dpca_mag - comp.dpca_mag).abs().max()) / s,
        cal=abs(float(prod.cal_phase) - float(comp.cal_phase)))
    assert agree["slc1"] < 2e-3 and agree["dpca"] < 2e-3 \
        and agree["cal"] < 1e-3, agree
    bad = [k for k in ("slc1", "slc2", "ati_phase", "dpca_mag")
           if not bool(torch.isfinite(getattr(prod, k)).all())]
    assert not bad, bad
    del prod, comp
    kern, comp_ms = paired_ms(
        lambda: gmti.focus_and_products(raw, sc_p, t0, path="composed"),
        lambda: gmti.focus_and_products(raw, sc, t0, path="composed"),
        pairs=5)
    print(f"[4c pallas] focus_and_products(path='composed', fft_impl="
          f"'pallas'): launches K1 / K2 single / K3 {counts['K1']} / "
          f"{counts['K2 single']} / {counts['K3']}; vs torch.fft composed: "
          f"slc {agree['slc1']:.1e}, dpca {agree['dpca']:.1e}, cal "
          f"{agree['cal']:.1e} rad; CPI (5 alternating pairs) "
          f"{quartiles(kern)} vs {quartiles(comp_ms)}")


def phase_split(dev, raw, sc, t0) -> dict:
    """gmti_cpi(k1_impl='split') vs 'fused2ch' on phase 4's shifted raw
    pair, through one GmtiCpi holding the configuration's state."""
    g, r = sc.geometry, sc.radar
    raw1, raw2 = dpca.pulse_shift_coregister(raw[0], raw[1], 1)
    f = csa.csa_factors(csa.CsaParams(
        wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
        prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m, t_start_fast=t0, num_pulses=N,
        num_samples=N), dev)
    x = [v.contiguous() for v in (raw1.real, raw1.imag, raw2.real,
                                  raw2.imag)]
    cpi = fused.GmtiCpi(f).to(dev)
    reset_launches()
    a = cpi(*x, k1_impl="split")
    torch.cuda.synchronize(dev)
    counts = launch_counts(ALL_WRAPPERS)
    assert counts["balance"] == 1 and counts["K1"] == 2 \
        and counts["K2 single"] == 2 and counts["K3g"] == 1 \
        and counts["K4"] == 1 and counts["K1g"] == 0 \
        and counts["K2 pair"] == 0, counts
    b = cpi(*x)
    dcal = abs(float(a[4]) - float(b[4]))
    errs = {i: rel_err(a[i], b[i]) for i in (0, 1, 2, 3, 6)}
    assert dcal <= 1e-5 and max(errs.values()) <= 1e-5, (dcal, errs)
    # the SNR by K4's rule away from the threshold, on the pixels whose DPCA
    # power a rotation of s2 by the two routes' cal difference moves by less
    # than 1e-3 (|dp| <= 2 |s1| |s2| dcal); deeper in the clutter
    # cancellation the power follows cal itself, held above
    alpha = cpi.cfar_params.alpha
    snr_a, snr_b = a[7].snr, b[7].snr
    s1_s2 = torch.hypot(b[0], b[1]) * torch.hypot(b[2], b[3])
    firm = 2.0 * s1_s2 * max(dcal, 1e-12) < 1e-3 * b[6] * b[6]
    away = ((snr_b - alpha).abs() > 1e-2 * alpha) & firm
    snr_bad = int(((snr_a - snr_b).abs()
                   > 5e-3 * snr_b.abs() + 1e-6)[away].sum())
    assert snr_bad == 0, snr_bad
    n_soft = int((~firm).sum())
    del a, b, snr_a, snr_b, away, s1_s2, firm
    # without balance cal is 0 on both routes: every product bit for bit
    a = cpi(*x, balance=False, k1_impl="split")
    b = cpi(*x, balance=False)
    same = all(torch.equal(u, v) for u, v in zip(a[:7], b[:7])) \
        and torch.equal(a[7].snr, b[7].snr)
    assert same
    del a, b
    split_ms, fused_ms = paired_ms(lambda: cpi(*x, k1_impl="split"),
                                   lambda: cpi(*x), pairs=5)
    print(f"[4d split] gmti_cpi(k1_impl='split') launches "
          f"{ {k: v for k, v in counts.items() if v} }; vs 'fused2ch': cal "
          f"{dcal:.1e} rad (<= 1e-5), SLC / dmag {max(errs.values()):.1e} of"
          f" the peak (<= 1e-5), SNR by K4's rule off {n_soft} px whose "
          f"power moves with cal; balance=False bit-identical; CPI (5 "
          f"alternating pairs) "
          f"{quartiles(split_ms)} vs {quartiles(fused_ms)}")
    return counts


def phase_golden(raw, sc, t0):
    """The kernel path and the composed fft_impl='pallas' route, both with
    balance=False, against the f64 oracle's CSA of the shifted channels."""
    routes = {"kernel_fused": (sc, "kernel_fused"),
              "composed pallas": (with_fft_impl(sc, "pallas"), "composed")}
    slcs = {}
    for name, (sc_r, path) in routes.items():
        prod = gmti.focus_and_products(raw, sc_r, t0, path=path,
                                       balance=False)
        slcs[name] = (prod.slc1.cpu().numpy(), prod.slc2.cpu().numpy())
        del prod
    raw_np = raw.cpu().numpy().astype(np.complex128)
    g, r = sc.geometry, sc.radar
    args = (r.wavelength_m, r.chirp_rate, r.fs_hz, r.prf_hz,
            g.effective_velocity_mps, g.slant_range_m, t0)
    t = time.perf_counter()
    s1o = oracle.focus_csa(raw_np[0, 1:, :], *args)[0].T
    s2o = oracle.focus_csa(raw_np[1, :-1, :], *args)[0].T
    oracle_s = time.perf_counter() - t
    strong = np.abs(s1o) > 0.05 * np.abs(s1o).max()
    ati_o = np.angle(s1o * np.conj(s2o))
    bad = {}
    for name, (s1f, s2f) in slcs.items():
        db = float(np.abs(20 * np.log10(np.abs(s1f[strong])
                                        / np.abs(s1o[strong]))).max())
        ati_f = np.angle(s1f * np.conj(s2f))
        dphi = float(np.abs(np.angle(np.exp(1j * (ati_f[strong]
                                                  - ati_o[strong])))).max())
        print(f"[5 golden] {name} vs f64 oracle on {int(strong.sum())} px "
              f"above 5 % of peak: intensity {db:.2e} dB (< 0.1), ATI phase "
              f"{dphi:.2e} rad (< 1e-3)")
        if not (db < 0.1 and dphi < 1e-3):
            bad[name] = (db, dphi)
    print(f"[5 golden] oracle {oracle_s:.1f} s")
    assert not bad, bad


def bound(n_bytes: float, n_flops: float, n_sfu: float = 0.0,
          n_tc: float = 0.0) -> dict:
    """The least time of the work on the card and which side sets it, by
    the benchmark's peaks (bench_torch/peaks.py)."""
    work = dict(n_bytes=n_bytes, n_flops=n_flops, n_sfu=n_sfu, n_tc=n_tc)
    return dict(bound_ms=bound_ms(**work), bound_by=bound_by(**work))


def videosar_setup():
    """config.videosar() at full width: echo options, window start, BpParams,
    presum, the whole collect's trajectory and its factorized plan."""
    sc = config.videosar()
    g, r = sc.geometry, sc.radar
    swath = sc.processing.bp_scene_size_m
    opts = videosar.spotlight_echo_opts(
        sc, videosar.antenna_length_for_swath(sc, swath))
    t0 = window_start_time(g.slant_range_m, opts, sc.collect.window_length_s,
                           "centered")
    p = videosar.bp_params_for(sc, opts)
    d = bp.presum_factor(p, r.prf_hz, r.wavelength_m, g.slant_range_m,
                         g.effective_velocity_mps)
    v = sc.video
    traj = orbit.make_trajectory(g, np.linspace(
        -v.duration_s / 2.0, v.duration_s / 2.0, v.total_pulses(r.prf_hz)))
    plan = bp_fast.make_plan(p, traj.positions, traj.times, float(t0),
                             factorize=True)
    return sc, opts, t0, p, d, traj, plan


def phase_bp(dev) -> dict:
    """The three recentre kernels vs their plain versions at the reference
    shape: the first CPI of the collect, seeded raw pulses made on the
    card, the collect's presum and band rows."""
    sc, opts, t0, p, d, traj, plan = videosar_setup()
    cpi = sc.video.cpi_pulses(sc.radar.prf_hz)
    ns, nfft = opts.num_samples, plan.nfft
    rows = bp_fast.band_rows(plan)
    gen = torch.Generator(device=dev).manual_seed(1)
    rc = torch.complex(
        torch.randn((cpi, ns), generator=gen, device=dev),
        torch.randn((cpi, ns), generator=gen, device=dev))
    tr = [torch.as_tensor(a[:cpi], device=dev) for a in
          (traj.positions, traj.velocities, traj.times)]
    vf = torch.as_tensor([SHIP_SPEED * math.cos(math.radians(SHIP_HEADING)),
                          SHIP_SPEED * math.sin(math.radians(SHIP_HEADING)),
                          0.0], dtype=torch.float64, device=dev)
    args = (*tr, vf, p, d, plan.t_ref)
    n_out, band = -(-cpi // d), (rows[1] - rows[0]) * 128
    # the recentre wrappers' trajectory traffic: each pulse's float64
    # position and time read once, the velocity at each group's centre
    # pulse, the groups' position, velocity and time written
    traj_bytes = 32.0 * cpi + 80.0 * n_out
    rec = {}

    def record(name, got, want, kernel, plain, n_bytes, n_flops, lib=None):
        err = rel_err(got, want)
        assert err <= 1e-4, (name, err)
        rec[name] = dict(max_abs_err=float((got - want).abs().max()),
                         ms=median_ms(kernel), plain_ms=median_ms(plain),
                         library_ms=None if lib is None else median_ms(lib),
                         **bound(n_bytes, n_flops))
        r = rec[name]
        lib_s = ("" if lib is None
                 else f", cuFFT transform {r['library_ms']:.3f} ms")
        print(f"[6 bp] {name} rel err {err:.2e}; {r['ms']:.3f} ms vs plain "
              f"{r['plain_ms']:.3f} ms{lib_s}; bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']})")
        return err

    fft_flops = 5.0 * nfft * math.log2(nfft)
    spec = fft_kernel.forward_spectra(rc, p)
    record("forward_spectra", spec, fft_kernel.forward_spectra_plain(rc, p),
           lambda: fft_kernel.forward_spectra(rc, p),
           lambda: fft_kernel.forward_spectra_plain(rc, p),
           8.0 * cpi * (ns + nfft), cpi * (fft_flops + 6.0 * nfft),
           lib=lambda: torch.fft.fft(rc, n=nfft, dim=-1))
    r = rec["forward_spectra"]
    print(f"[6 bp] forward_spectra at {cpi} pulses: "
          f"{r['ms'] / r['library_ms']:.2f}x torch.fft.fft's time, "
          f"{r['bound_ms'] / r['ms']:.1%} of its byte bound")
    # the ring path's launches take one step of pulses each; a pulse's
    # spectrum depends on that pulse alone
    step = sc.video.step_pulses(sc.radar.prf_hz)
    seg = rc[:step].contiguous()
    seg_spec = fft_kernel.forward_spectra(seg, p)
    seg_err = rel_err(seg_spec, fft_kernel.forward_spectra_plain(seg, p))
    assert seg_err <= 1e-4, seg_err
    assert torch.equal(seg_spec, spec[:step])
    seg_ms = median_ms(lambda: fft_kernel.forward_spectra(seg, p))
    seg_lib = median_ms(lambda: torch.fft.fft(seg, n=nfft, dim=-1))
    seg_bound = bound(8.0 * step * (ns + nfft),
                      step * (fft_flops + 6.0 * nfft))["bound_ms"]
    print(f"[6 bp] forward_spectra at the ring path's {step}-pulse segment: "
          f"rel err {seg_err:.2e}; bit-identical to pulses [0, {step}) of "
          f"the {cpi}-pulse launch; {seg_ms:.3f} ms vs torch.fft.fft "
          f"{seg_lib:.3f} ms ({seg_ms / seg_lib:.2f}x); bound "
          f"{seg_bound:.3f} ms ({seg_bound / seg_ms:.1%})")
    del seg, seg_spec
    split = fft_kernel.recentre_from_spectra(spec, *args, out_rows=rows)[0]
    record("recentre_from_spectra", split,
           fft_kernel.recentre_from_spectra_plain(spec, *args,
                                                  out_rows=rows)[0],
           lambda: fft_kernel.recentre_from_spectra(spec, *args,
                                                    out_rows=rows),
           lambda: fft_kernel.recentre_from_spectra_plain(spec, *args,
                                                          out_rows=rows),
           8.0 * (cpi * nfft + n_out * band) + traj_bytes,
           cpi * 10.0 * nfft + n_out * fft_flops)
    fused = fft_kernel.recenter_presum(rc, *args, out_rows=rows)
    record("recenter_presum", fused[0],
           fft_kernel.recenter_presum_plain(rc, *args, out_rows=rows)[0],
           lambda: fft_kernel.recenter_presum(rc, *args, out_rows=rows),
           lambda: fft_kernel.recenter_presum_plain(rc, *args,
                                                    out_rows=rows),
           8.0 * (cpi * ns + n_out * band) + traj_bytes,
           cpi * (fft_flops + 16.0 * nfft) + n_out * fft_flops)
    split_err = rel_err(split, fused[0])
    assert split_err <= 1e-4, split_err
    offsets = (cpi // 5, 2 * cpi // 5, 4 * cpi // 5)    # 500 / 1000 / 2000
    for off in offsets:
        ring = fft_kernel.recentre_from_spectra(
            torch.roll(spec, off, 0), *args, out_rows=rows, ring_offset=off)
        assert torch.equal(ring[0], split), off
    # a group's rows depend on its own pulses alone: the pulses [a, b) of
    # whole groups give rows [a/d, b/d) of the whole CPI's launch bit for
    # bit (t_mean held to the CPI's, which the ramps depend on)
    a, b = 2 * cpi // 5, 3 * cpi // 5                   # 1000, 1500
    assert a % d == 0 and b % d == 0
    sub = (*(t[a:b] for t in tr), vf, p, d, plan.t_ref)
    t_mean = tr[2].mean()
    assert torch.equal(fft_kernel.recenter_presum(
        rc[a:b], *sub, t_mean=t_mean, out_rows=rows)[0],
        fused[0][a // d:b // d])
    assert torch.equal(fft_kernel.recentre_from_spectra(
        spec[a:b], *sub, t_mean=t_mean, out_rows=rows)[0],
        split[a // d:b // d])
    split_ms = rec["forward_spectra"]["ms"] + rec["recentre_from_spectra"][
        "ms"]
    print(f"[6 bp] P {cpi} x ns {ns}, nfft {nfft}, presum d {d}, band rows "
          f"p0 {rows[0]} p1 {rows[1]} ({band} of {nfft} samples); forward "
          f"spectra then recentre from spectra vs fused: {split_err:.2e}, "
          f"{split_ms:.3f} ms vs {rec['recenter_presum']['ms']:.3f} ms; "
          f"ring offsets {offsets} bit-identical; pulses [{a}, {b}) alone "
          f"give rows [{a // d}, {b // d}) of both kernels bit for bit")
    return rec


def acc_plans(p, traj, t0, cpi):
    """The pixel kernel's plan (the whole collect, 64-sample windows, as
    run builds it for 'fast_pallas') and the factor kernel's (the first
    CPI, factorized)."""
    return (bp_fast.make_plan(p, traj.positions, traj.times, float(t0),
                              w_win=64),
            bp_fast.make_plan(p, traj.positions[:cpi], traj.times[:cpi],
                              float(t0), factorize=True))


def acc_operands(rc, tr, vf, p, d, plan, fit_stride):
    """backproject_fast's accumulate operands (rc2, u0, pa, pb, pc, b_t,
    c_t, plan_acc): the fused recentre kernel's band rows, then the frame
    geometry and the coefficient fit."""
    rows = bp_fast.band_rows(plan)
    t_mean = tr[2].mean()
    rc2, pos2, vel2, t2 = fft_kernel.recenter_presum(
        rc, *tr, vf, p, d, plan.t_ref, t_mean=t_mean, out_rows=rows)
    rdir, cdir, dy = bp_fast._frame_geometry(pos2[pos2.shape[0] // 2], p,
                                             plan)
    co = bp_fast._fit_coeffs(pos2, vel2, t2, vf, p, plan, t_mean, rdir, cdir,
                             dy, fit_stride=fit_stride)
    plan_acc = dataclasses.replace(plan,
                                   band_start=plan.band_start - rows[0] * 128)
    return (rc2, *(c.contiguous() for c in co), plan_acc)


def acc_work(ops, ncols, sub_p=None, nx=None) -> dict:
    """bound()'s keywords for one accumulate call: n_bytes, each input
    read and the output written once; n_tc, the W-deep complex MAC of
    every pixel and pulse (8 W operations) on the tensor cores, three TF32
    passes; n_flops, the rest in f32: per pixel and pulse ~20 for taper,
    phase and sum; per row and pulse the split window DFT (8 W (W / 8 +
    9)); for the factorized one, the merge (a real matmul of each
    sub-aperture's real and imaginary planes, 4 nx_c per fine pixel, and
    ~16 for the carrier and sum)."""
    rc2, plan = ops[0], ops[-1]
    num_p, w, ny = rc2.shape[0], plan.w_win, plan.ny_i
    n_bytes = (rc2.numel() * 8 + 4 * num_p * ny * 4 + 2 * num_p * 4
               + ny * (nx or ncols) * 8)
    flops = num_p * ny * (ncols * 20 + 8 * w * (w // 8 + 9))
    if sub_p is not None:
        n_sub = -(-num_p // sub_p)
        flops += n_sub * ny * nx * (4 * ncols + 16)
    return dict(n_bytes=n_bytes, n_flops=flops,
                n_tc=3.0 * num_p * ny * ncols * 8 * w)


def acc_bounds(work: dict):
    """The tensor-core bound of acc_work's work (bound()'s dict), and the
    f32-FMA bound in ms: the same work with the contraction's one f32 pass
    on the FMA pipe."""
    f32 = bound(work["n_bytes"], work["n_flops"] + work["n_tc"] / 3.0)
    return bound(**work), f32["bound_ms"]


def phase_acc(dev) -> dict:
    """The two accumulate kernels vs their plain versions at full width,
    on the first CPI of seeded raw pulses."""
    sc, opts, t0, p, d, traj, _ = videosar_setup()
    cpi = sc.video.cpi_pulses(sc.radar.prf_hz)
    plan64, plan_cpi = acc_plans(p, traj, t0, cpi)
    gen = torch.Generator(device=dev).manual_seed(2)
    rc = torch.complex(
        torch.randn((cpi, opts.num_samples), generator=gen, device=dev),
        torch.randn((cpi, opts.num_samples), generator=gen, device=dev))
    tr = [torch.as_tensor(a[:cpi], device=dev) for a in
          (traj.positions, traj.velocities, traj.times)]
    vf = torch.as_tensor([SHIP_SPEED * math.cos(math.radians(SHIP_HEADING)),
                          SHIP_SPEED * math.sin(math.radians(SHIP_HEADING)),
                          0.0], dtype=torch.float64, device=dev)
    rec = {}
    sub_p = max(1, plan_cpi.sub_raw // d)
    cases = (
        ("accumulate_pallas", plan64, 0, bp_kernel.accumulate_pallas,
         bp_kernel.accumulate_pallas_plain, (), plan64.nx_i, {}),
        ("accumulate_factor_pallas", plan_cpi, 16,
         bp_factor_kernel.accumulate_factor_pallas,
         bp_factor_kernel.accumulate_factor_pallas_plain, (sub_p,),
         plan_cpi.nx_c, dict(sub_p=sub_p, nx=plan_cpi.nx_i)))
    for name, plan, fs, kernel, plain, extra, ncols, wkw in cases:
        ops = acc_operands(rc, tr, vf, p, d, plan, fs)
        got = kernel(*ops, *extra)
        want = plain(*ops, *extra)
        torch.cuda.synchronize(dev)
        err = rel_err(got, want)
        assert err <= 1e-4, (name, err)
        assert torch.equal(got, kernel(*ops, *extra)), name    # same bits
        tc, f32_ms = acc_bounds(acc_work(ops, ncols, **wkw))
        rec[name] = dict(max_abs_err=float((got - want).abs().max()),
                         ms=median_ms(lambda: kernel(*ops, *extra)),
                         plain_ms=median_ms(lambda: plain(*ops, *extra)),
                         library_ms=None, **tc)
        r = rec[name]
        if extra:              # the factor kernel's launch without the merge
            inner = median_ms(lambda: bp_factor_kernel.inner_sums(*ops,
                                                                  *extra))
            print(f"[7 acc] {name}: the kernel's inner sums alone "
                  f"{inner:.3f} ms, the rest is the merge")
        print(f"[7 acc] {name} rel err {err:.2e}, two launches bit for bit;"
              f" {r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms; bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']}; the contraction "
              f"as three TF32 passes on the tensor cores), {f32_ms:.3f} ms "
              f"with it on the f32 FMA pipe; P {ops[0].shape[0]}, grid "
              f"{plan.ny_i} x "
              f"{plan.nx_i}, w {plan.w_win}, columns {ncols}, band_start "
              f"{ops[-1].band_start}" + (f", sub-apertures of {sub_p}"
                                         if extra else ""))
        del got, want, ops
    return rec


def phase_videosar(dev):
    """videosar.run with 'fast_factor' and 'fast_pallas', each in mode A
    (per-frame fused recentre) and mode B (the spectra ring), on the
    destroyer scene; formation ms per frame of both backends on held
    inputs; the 'factor_kernel' accumulate on the first CPI's factor
    plan."""
    sc, opts, t0, p, d, traj, plan = videosar_setup()
    cpi = sc.video.cpi_pulses(sc.radar.prf_hz)
    plan64, plan_cpi = acc_plans(p, traj, t0, cpi)
    ship = targets.destroyer()
    sched = videosar._schedule(sc, VS_FRAMES, None)[0]
    step = sched.step_pulses
    n_seg = len({int(s0) // step + j for s0 in sched.starts
                 for j in range(sched.cpi_pulses // step)})
    launches, imgs, direct = {}, {}, {}
    for backend in ("fast_factor", "fast_pallas"):
        kw = dict(heading_deg=SHIP_HEADING, speed_mps=SHIP_SPEED,
                  algorithm="mbp", bp_backend=backend, num_frames=VS_FRAMES,
                  device=dev)
        for mode, extra in (("A", {}), ("B", dict(stream_spectra="ring",
                                                   noise_mode="per_segment"))):
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            t = time.perf_counter()
            out = videosar.run(sc, ship, **kw, **extra)
            torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t
            launches[backend, mode] = launch_counts(BP_ALL)
            direct[backend, mode] = echo_kernel.echo_direct.launches
            assert direct[backend, mode] == n_seg, (backend, mode, n_seg,
                                                    direct[backend, mode])
            imgs[backend, mode] = out.images
            assert out.images.shape == (VS_FRAMES, 512, 512), out.images.shape
            assert np.isfinite(out.images).all(), (backend, mode)
            peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            print(f"[8 videosar] {backend} mode {mode}: run {secs:.2f} s "
                  f"(echo included); launches {launches[backend, mode]}; "
                  f"direct-echo launches {direct[backend, mode]} (one a "
                  f"segment, {n_seg} segments); peak memory {peak_gib:.2f} "
                  f"GiB")
        for b, m, k in ((backend, "A", "recenter_presum"),
                        (backend, "B", "forward_spectra"),
                        (backend, "B", "recentre_from_spectra")):
            assert launches[b, m][k] > 0, (b, m, launches[b, m])
        agree = max(float(np.abs(imgs[backend, "A"][f]
                                 - imgs[backend, "B"][f]).max()
                          / np.abs(imgs[backend, "A"][f]).max())
                    for f in range(VS_FRAMES))
        assert agree <= 2e-3, (backend, agree)
        print(f"[8 videosar] {backend}: frames {imgs[backend, 'A'].shape}; "
              f"modes A and B agree to {agree:.2e} of the peak (<= 2e-3)")
    for mode in ("A", "B"):
        assert launches["fast_pallas", mode]["accumulate_pallas"] > 0, mode
        assert launches["fast_factor", mode]["accumulate_pallas"] == 0, mode

    # the echo of the run's pulses alone
    phi = math.radians(SHIP_HEADING)
    vel = np.array([SHIP_SPEED * math.cos(phi), SHIP_SPEED * math.sin(phi),
                    0.0])
    tgt = ship.rotate_z(SHIP_HEADING)
    n_pulses = cpi + (VS_FRAMES - 1) * step
    t = time.perf_counter()
    phase_history(traj.slice(0, n_pulses), tgt, opts, t_start=t0,
                  target_velocity=vel, device=dev)
    torch.cuda.synchronize(dev)
    echo_s = time.perf_counter() - t

    # formation per frame on held inputs: A from a held raw CPI, B one ring
    # step (the new segment's spectra written in place + the frame)
    raw0 = phase_history(traj.slice(0, cpi), tgt, opts, t_start=t0,
                         target_velocity=vel, device=dev)
    tr = [torch.as_tensor(a[:cpi], device=dev) for a in
          (traj.positions, traj.velocities, traj.times)]
    vf = torch.as_tensor(vel, device=dev)
    routes = {"fast_factor": dict(presum=d, plan=plan, fit_stride=16,
                                  accumulate="factor2_pallas"
                                  if plan.sub_raw1 > 0 else "factor_pallas"),
              "fast_pallas": dict(presum=d, plan=plan64, fit_stride=0,
                                  accumulate="pallas")}
    spec = bp_fast.forward_spectra(raw0, p)
    new_raw = raw0[:step].clone()
    state = {"wp": 0}

    def form_a(route):
        return lambda: bp_fast.focus_bp_fast(raw0, *tr, vf, float(t0), p,
                                             **routes[route])

    def form_b(route):
        def step_frame():
            wp = state["wp"]
            spec[wp:wp + step] = bp_fast.forward_spectra(new_raw, p)
            state["wp"] = (wp + step) % cpi
            return bp_fast.focus_bp_fast(None, *tr, vf, float(t0), p,
                                         raw_spectra=spec,
                                         ring_offset=state["wp"] or None,
                                         **routes[route])
        return step_frame

    ms = {}
    for mode, form in (("A", form_a), ("B", form_b)):
        ms["fast_pallas", mode], ms["fast_factor", mode] = paired_ms(
            form("fast_pallas"), form("fast_factor"), pairs=5)
    print(f"[8 videosar] echo of {n_pulses} pulses x 35 points {echo_s:.2f}"
          f" s; formation per frame (5 alternating pairs per mode): "
          + "; ".join(f"{b} {m} {quartiles(ms[b, m])}" for b, m in ms)
          + f"; presum d {d}")

    # the factor kernel at the ops layer, on the first CPI's factor plan
    fk = dict(presum=d, plan=plan_cpi, fit_stride=16)
    reset_launches()
    img_fk = bp_fast.focus_bp_fast(raw0, *tr, vf, float(t0), p,
                                   accumulate="factor_kernel", **fk)
    torch.cuda.synchronize(dev)
    launches["factor_kernel"] = launch_counts(BP_ALL)
    assert launches["factor_kernel"]["accumulate_factor_pallas"] == 1, \
        launches["factor_kernel"]
    assert launches["factor_kernel"]["recenter_presum"] == 1
    ref_fk = bp_fast.focus_bp_fast(raw0, *tr, vf, float(t0), p,
                                   accumulate="factor_pallas", **fk)
    fk_err = rel_err(img_fk, ref_fk)
    assert torch.isfinite(img_fk).all() and fk_err <= 1e-3, fk_err
    fk_ms, fp_ms = paired_ms(
        lambda: bp_fast.focus_bp_fast(raw0, *tr, vf, float(t0), p,
                                      accumulate="factor_kernel", **fk),
        lambda: bp_fast.focus_bp_fast(raw0, *tr, vf, float(t0), p,
                                      accumulate="factor_pallas", **fk),
        pairs=5)
    print(f"[8 videosar] focus_bp_fast(accumulate='factor_kernel') on the "
          f"first CPI's plan (ny_i {plan_cpi.ny_i} nx_i {plan_cpi.nx_i} "
          f"sub_raw {plan_cpi.sub_raw} nx_c {plan_cpi.nx_c}): launches "
          f"{launches['factor_kernel']}; vs 'factor_pallas' {fk_err:.2e} of "
          f"the peak (<= 1e-3); frame {quartiles(fk_ms)} vs "
          f"{quartiles(fp_ms)}")
    totals = {k: launches["fast_factor", "A"][k]
              + launches["fast_factor", "B"][k] for k in BP_WRAPPERS}
    totals["accumulate_pallas"] = (
        launches["fast_pallas", "A"]["accumulate_pallas"]
        + launches["fast_pallas", "B"]["accumulate_pallas"])
    totals["accumulate_factor_pallas"] = launches["factor_kernel"][
        "accumulate_factor_pallas"]
    totals["echo_direct"] = direct["fast_factor", "B"]      # the ring's
    frames0 = {"fast_factor mode A": imgs["fast_factor", "A"][0],
               "fast_pallas mode A": imgs["fast_pallas", "A"][0],
               "factor_kernel": img_fk.cpu().numpy()}
    return totals, frames0, raw0, tr, vf, t0, p


def phase_bp_golden(frames: dict, raw0, tr, vf, t0, p, u=8):
    """Each frame of ``frames`` (frame 0 of the collect) vs the exact
    float64 BP of u-times FFT-upsampled range data (tests/test_bp_fast.py's
    oracle recipe), computed once on the card."""
    t = time.perf_counter()
    rc = bp.bp_range_compress(raw0, p)
    n_p, ns = rc.shape
    h = ns // 2
    rc_u = torch.empty((n_p, ns * u), dtype=torch.complex64,
                       device=rc.device)
    for c0 in range(0, n_p, 250):                 # 250 pulses at a time
        spec = torch.fft.fft(rc[c0:c0 + 250].to(torch.complex128), dim=-1)
        spec_u = torch.zeros((spec.shape[0], ns * u), dtype=spec.dtype,
                             device=rc.device)
        spec_u[:, :h], spec_u[:, -h:] = spec[:, :h], spec[:, -h:]
        spec_u[:, h] *= 0.5
        spec_u[:, -h] *= 0.5
        rc_u[c0:c0 + 250] = (torch.fft.ifft(spec_u, dim=-1) * u).to(
            torch.complex64)
    del rc, spec, spec_u
    p_u = dataclasses.replace(p, fs_hz=p.fs_hz * u, num_samples=ns * u,
                              precision="f64", pulse_block=32)
    t0_u = t0 + 0.5 * (u - 1) / (u * p.fs_hz)
    want = bp.backproject(rc_u, *tr, vf, t0_u, p_u).cpu().numpy()
    oracle_s = time.perf_counter() - t
    del rc_u
    a_w = np.abs(want)
    pk = np.unravel_index(a_w.argmax(), a_w.shape)
    bad = {}
    for name, img0 in frames.items():
        a_f = np.abs(img0)
        db = abs(20 * math.log10(a_f[pk] / a_w[pk]))
        dphi = abs(float(np.angle(img0[pk] * np.conj(want[pk]))))
        field = float(np.abs(a_f - a_w).max() / a_w.max())
        print(f"[9 bp golden] {name} frame 0 vs f64 exact BP of "
              f"{u}x-upsampled data: peak {db:.2e} dB (< 0.15), peak phase "
              f"{dphi:.2e} rad (< 0.02), field {field:.2e} (< 1.5e-2)")
        if not (db < 0.15 and dphi < 0.02 and field < 0.015):
            bad[name] = (db, dphi, field)
    print(f"[9 bp golden] oracle {oracle_s:.1f} s")
    assert not bad, bad


# --------------------------------------------------------------------------
# the NUFFT echo and the full-scale two-channel chain
# --------------------------------------------------------------------------

def e2e_setup():
    """bench.py's e2e_fullscale: config.ati_dpca() at 7,200 x 13,200 per
    channel; the freq echo on a uniform grid with the centred window; the
    destroyer turned by 90 degrees plus 5,000 seeded clutter points."""
    sc = config.ati_dpca()
    r, g, c = sc.radar, sc.geometry, sc.collect
    opts = dataclasses.replace(echo_opts_for(sc), backend="freq",
                               endpoint_grid=False)
    t0 = window_start_time(g.slant_range_m, opts, c.window_length_s,
                           "centered")
    scene = targets.PointTargets.concatenate(
        [targets.destroyer().rotate_z(90.0),
         ocean_clutter_field(np.random.default_rng(0))])
    traj = orbit.make_trajectory(g, orbit.slow_time_grid(
        c.integration_time_s, c.num_pulses(r.prf_hz)))
    return sc, opts, t0, scene, traj, sc.channels.rx_offsets()


def e2e_sim(dev, setup, **opts_kw):
    """One channel-batched multi_channel_phase_history of the e2e scene."""
    sc, opts, t0, scene, traj, offs = setup
    return multi_channel_phase_history(
        traj, scene, dataclasses.replace(opts, **opts_kw), t_start=t0,
        rx_offsets=offs, device=dev)


def slice_echo_operands(dev):
    """The direct-echo kernel's operands on the main path, phase 12's
    simulate_two_channel(echo_backend='pallas') on phase 4's scene: the
    scalar fields (2 x 4,097 pulses) of the ship at its velocity (35
    targets) and of the static clutter (500), one launch each, and the
    kernel's fast-time grid and constants."""
    sc = slice_scenario(N + 1, N)
    sc = sc.replace(collect=dataclasses.replace(sc.collect,
                                                echo_backend="pallas"))
    r, g, c = sc.radar, sc.geometry, sc.collect
    opts = echo_opts_for(sc)
    traj = orbit.make_trajectory(g, orbit.slow_time_grid(
        c.integration_time_s, c.num_pulses(r.prf_hz)))
    kw = dict(t_start=window_start_time(g.slant_range_m, opts,
                                        c.window_length_s,
                                        c.window_start_mode),
              rx_offsets=sc.channels.rx_offsets(), device=dev)
    clutter = ocean_clutter_field(np.random.default_rng(0), num_points=500)
    return ({"ship": echo.scalar_fields(traj, targets.destroyer(), opts,
                                        target_velocity=SHIP_VELOCITY,
                                        **kw),
             "clutter": echo.scalar_fields(traj, clutter, opts, **kw)},
            echo.echo_kernel_args(opts, dev))


def plain_direct(t_slow, sat_pos, sat_vel, tgt_pos, tgt_rcs, tgt_vel, opts,
                 *, rx_offsets, t_start: float) -> torch.Tensor:
    """echo_kernel.echo_direct's function through the direct engine's plain
    chunked code (echo._direct, channel by channel) on the same tensors:
    what the fused kernel is held against on the card."""
    amp = echo._amplitudes(tgt_rcs, opts)
    return torch.cat([echo._direct(t_slow, sat_pos, sat_vel, tgt_pos, amp,
                                   tgt_vel, float(off), t_start, opts)
                      for off in rx_offsets])


@contextlib.contextmanager
def plain_direct_engine():
    """Inside, the 'jnp' engine on the card runs :func:`plain_direct` in
    place of the fused kernel (what echo._phase_history looks up at each
    call), so a model's raw can be held against the plain engine's."""
    fused = echo_kernel.echo_direct
    echo_kernel.echo_direct = plain_direct
    try:
        yield
    finally:
        echo_kernel.echo_direct = fused


def ring_segment_operands(dev):
    """The direct engine's operands of one VideoSAR ring segment as
    videosar.run holds them on the card: config.videosar()'s collect and
    the destroyer at SHIP_HEADING and SHIP_SPEED; segment 25, 500 pulses
    x 35 targets x 22,004 samples (row windows of the device-resident
    trajectory); its echo options and window start."""
    sc = config.videosar()
    sched = scheduler.make_schedule(sc.video, sc.radar.prf_hz)
    step = sched.step_pulses
    g = videosar._scene(sc, targets.destroyer(), sched, SHIP_HEADING,
                        SHIP_SPEED, None, None, dev)
    pos, vel, ts = videosar._window(g.on.traj, 25 * step, step)
    return ((ts, pos, vel, g.on.tgt_pos, g.on.tgt_rcs, g.on.tgt_vel),
            g.opts, float(g.t0))


def spread_work(c, v, win):
    """(bytes, operations) of one spread launch: cells and values read once,
    the windows written once; two adds per live target, tap and set."""
    out = c.shape[0] * c.shape[1] * 2 * v.shape[2] * win
    return (4.0 * (c.numel() + v.numel() + out),
            2.0 * int((c >= 0).sum()) * v.shape[2] * v.shape[3])


def spread_taps_work(c, o, win, taps):
    """(bytes, operations, sin / cos results) of one formed-taps spread
    launch: cells and operands read once, the windows written once; two
    adds per live target, tap and set, and forming each value pair (ES
    taps: 12 operations and an exp; flank taps: 22 operations and a cos of
    the weight, a cos and a sin of the phase)."""
    out = c.shape[0] * c.shape[1] * 2 * taps.n_sets * win
    pairs = c.shape[0] * o.shape[2] * taps.n_sets * taps.k_taps
    es = isinstance(taps, spread_kernel.EsTaps)
    return (4.0 * (c.numel() + o.numel() + out),
            2.0 * int((c >= 0).sum()) * taps.n_sets * taps.k_taps
            + (12.0 if es else 22.0) * pairs, (1.0 if es else 3.0) * pairs)


def place_work(wins, base, offsets, start, l_out, complex_out):
    """Bytes of one placement launch: the window cells that land in the
    cropped field read once (re and im), the bases, every field cell
    written once (8 bytes, planes or complex64)."""
    win, n = wins.shape[-1], 0
    for off in offsets:
        first = torch.clamp(start - base - off, 0, win)
        end = torch.clamp(l_out + start - base - off, 0, win)
        n += int((end - first).clamp(min=0).sum())
    return 8.0 * n + 4.0 * base.numel() + 8.0 * wins.shape[0] * l_out


def echo_work(tau, kw):
    """(bytes, f32 operations, sin / cos results) of one direct-echo launch,
    and the (pulse, target, sample) triples inside the gate. The scalars
    and the grid read once, the (P, Ns) complex64 written once; per (pulse,
    target) 2 operations for the ends of its gate (on the uniform grid a
    gate is one run of samples); per triple in the gate 5 operations for
    the phase, one sin, one cos and 4 operations to accumulate. Triples
    outside the gate need no work."""
    t_fast = kw["t_fast"]
    lo = tau.reshape(-1) + (kw["shift"] - kw["half"])
    hi = tau.reshape(-1) + (kw["shift"] + kw["half"])
    n_gate = int((torch.searchsorted(t_fast, hi, right=True)
                  - torch.searchsorted(t_fast, lo)).sum())
    num_p, num_b = tau.shape
    ns = t_fast.shape[0]
    return (4.0 * (3 * num_p * num_b + ns) + 8.0 * num_p * ns,
            2.0 * num_p * num_b + 9.0 * n_gate, 2.0 * n_gate), n_gate


def direct_work(args, opts, t0):
    """(bytes, f32 operations, sin / cos results) of one fused direct-echo
    launch of one channel, and the triples inside the gate: echo_work's
    count on the delays the launch forms (echo._scalar_fields at every
    pulse), with the float64 pulses and targets read once in place of the
    scalar fields. The float64 geometry of the (pulse, target) pairs, a
    few hundred operations each, is left out."""
    t, p, v, pos, rcs, tv = args
    tau = echo._scalar_fields(t, p, v, pos, echo._amplitudes(rcs, opts), tv,
                              [0.0], t0, opts, 0)[0]
    (n_bytes, flops, sfu), n_gate = echo_work(
        tau, echo.echo_kernel_args(opts, t.device))
    num_p, num_b = tau.shape
    n_bytes += 8.0 * (7 * num_p + 4 * num_b + 3) - 12.0 * num_p * num_b
    return (n_bytes, flops, sfu), n_gate


def place_operands(fields, opts):
    """The place_windows arguments of synthesize's first pulse chunk of
    ``fields``: the main pass's, then the exact-edge pass's."""
    kw = echo.synth_options(opts)
    n = echo_freq._plan(fields[0], opts, **kw).pulse_chunk
    calls, place = [], spread_kernel.place_windows

    def rec(*args):
        calls.append(args)
        return place(*args)

    rec.launches = 0          # the wrapper counts on what holds its name

    spread_kernel.place_windows = rec
    try:
        echo_freq.synthesize(*(f[:n] for f in fields), opts, **kw)
    finally:
        spread_kernel.place_windows = place
    assert len(calls) == 2, len(calls)
    return calls


def re_im(x):
    """(re, im) of a complex64 tensor; a pair of planes as it is."""
    if isinstance(x, tuple):
        return x
    return torch.view_as_real(x)[..., 0], torch.view_as_real(x)[..., 1]


def phase_echo_kernels(dev, setup) -> dict:
    """Each NUFFT kernel against its plain version on the operands of the
    e2e pass's first chunk, and the direct-echo kernel on the two launches
    of phase 12's pallas path; the times of each launch of a chunk or a
    pass, summed."""
    sc, opts, t0, scene, traj, offs = setup
    fields = echo.scalar_fields(traj, scene, opts, t_start=t0,
                                rx_offsets=offs, device=dev)
    ops = echo_freq.kernel_operands(*fields, opts,
                                    **echo.synth_options(opts))
    places = place_operands(fields, opts)
    del fields
    assert len(ops["spread edge"]) == 1, len(ops["spread edge"])
    torch.cuda.synchronize(dev)
    rec = {}
    for qr, name in ((False, "spread"), (True, "spread_qr")):
        parts, n_bytes, flops = {}, 0.0, 0.0
        for part, (c, v, win) in (("main", ops["spread main"]),
                                  ("edge", ops["spread edge"][0])):
            got = spread_kernel.spread_windows_pallas(c, v, win, qr=qr)
            again = spread_kernel.spread_windows_pallas(c, v, win, qr=qr)
            want = spread_kernel.spread_windows_plain(
                c[:PLAIN_CUT], v[:PLAIN_CUT], win, qr=qr)
            err = rel_err(got[:PLAIN_CUT], want)
            assert err <= 1e-5 and torch.equal(got, again), (name, part, err)
            b, f = spread_work(c, v, win)
            n_bytes, flops = n_bytes + b, flops + f
            parts[part] = dict(
                max_abs_err=float((got[:PLAIN_CUT] - want).abs().max()),
                ms=median_ms(lambda: spread_kernel.spread_windows_pallas(
                    c, v, win, qr=qr)),
                plain_ms=median_ms(lambda: spread_kernel.spread_windows_plain(
                    c, v, win, qr=qr)), **bound(b, f))
            r = parts[part]
            print(f"[10 echo] {name} {part}: cells {tuple(c.shape)}, values "
                  f"{tuple(v.shape)}, win {win}; vs plain on {PLAIN_CUT} "
                  f"pulses {err:.2e} of the peak (<= 1e-5), two launches "
                  f"bit-identical; {r['ms']:.3f} ms vs plain "
                  f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.3f} ms "
                  f"({r['bound_by']}, {b / 1e6:.0f} MB)")
            del got, again, want
        rec[name] = dict(
            max_abs_err=max(q["max_abs_err"] for q in parts.values()),
            ms=sum(q["ms"] for q in parts.values()),
            plain_ms=sum(q["plain_ms"] for q in parts.values()),
            library_ms=None, **bound(n_bytes, flops), per_chunk=parts)

    # the taps formed in the kernel from the chunk's operands, against the
    # values staging's windows of the values PyTorch forms from them
    sw = spread_kernel.spread_windows_pallas
    parts, work = {}, [0.0, 0.0, 0.0]
    for part, (c, o, win, taps), (_, v, _) in (
            ("main", ops["spread main taps"], ops["spread main"]),
            ("edge", ops["spread edge taps"][0], ops["spread edge"][0])):
        got = sw(c, o, win, taps=taps)
        again = sw(c, o, win, taps=taps)
        want = sw(c, v, win)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32)) \
            and torch.equal(got.view(torch.int32), again.view(torch.int32))
        assert same, part
        w = spread_taps_work(c, o, win, taps)
        work = [a + b for a, b in zip(work, w)]
        parts[part] = dict(
            max_abs_err=0.0, ms=median_ms(lambda: sw(c, o, win, taps=taps)),
            values_ms=median_ms(lambda: sw(c, v, win)),
            plain_ms=median_ms(lambda: spread_kernel.spread_windows_plain(
                c, o, win, taps=taps)), read_mb=4.0 * (c.numel() + o.numel())
            / 1e6, values_read_mb=4.0 * (c.numel() + v.numel()) / 1e6,
            **bound(*w))
        r = parts[part]
        print(f"[10 echo] spread_taps {part}: cells {tuple(c.shape)}, "
              f"operands {tuple(o.shape)}, win {win}; vs the values "
              f"staging bit for bit, two launches bit-identical; "
              f"{r['ms']:.3f} ms (values staging {r['values_ms']:.3f} ms) "
              f"vs plain {r['plain_ms']:.3f} ms; reads {r['read_mb']:.0f} "
              f"MB (values staging {r['values_read_mb']:.0f} MB); bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']}, {w[0] / 1e6:.0f} "
              f"MB)")
        del got, again, want
    rec["spread_taps"] = dict(
        max_abs_err=0.0, ms=sum(q["ms"] for q in parts.values()),
        plain_ms=sum(q["plain_ms"] for q in parts.values()),
        library_ms=None, **bound(*work), per_chunk=parts)

    fr, fi, filt, nfft, rows = ops["conv"]
    got = fft_kernel.fft_conv_pallas(fr, fi, filt, nfft, out_rows=rows)
    again = fft_kernel.fft_conv_pallas(fr, fi, filt, nfft, out_rows=rows)
    want = fft_kernel.fft_conv_plain(fr, fi, filt, nfft, out_rows=rows)
    err = rel_err(got, want)
    assert err <= 3e-5 and torch.equal(got, again), err
    field = torch.complex(fr, fi)
    num_p, pb = fr.shape[0], rows[1] - rows[0]
    rec["fft_conv"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=median_ms(lambda: fft_kernel.fft_conv_pallas(fr, fi, filt, nfft,
                                                        out_rows=rows)),
        plain_ms=median_ms(lambda: fft_kernel.fft_conv_plain(
            fr, fi, filt, nfft, out_rows=rows)),
        library_ms=median_ms(lambda: torch.fft.ifft(
            torch.fft.fft(field, n=nfft, dim=-1) * filt, dim=-1)),
        **bound(8.0 * fr.numel() + 8.0 * nfft + 8.0 * num_p * pb * 128,
                num_p * (10.0 * nfft * math.log2(nfft) + 6.0 * nfft)))
    r = rec["fft_conv"]
    print(f"[10 echo] fft_conv: field {tuple(fr.shape)}, nfft {nfft}, band "
          f"rows {rows}; vs plain {err:.2e} of the peak (<= 3e-5; two "
          f"launches bit-identical); "
          f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms, torch.fft "
          f"fft / multiply / ifft {r['library_ms']:.3f} ms; bound "
          f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
    del got, again, want, field, ops

    parts, n_bytes = {}, 0.0
    for part, args in zip(("main", "edge"), places):
        wins, base, offsets, start, l_out, complex_out = args
        got = spread_kernel.place_windows(*args)
        again = spread_kernel.place_windows(*args)
        want = spread_kernel.place_windows_plain(*args)
        same = all(torch.equal(a.view(torch.int32), w.view(torch.int32))
                   and torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b, w in zip(*map(re_im, (got, again, want))))
        assert same, part
        b = place_work(*args)
        n_bytes += b
        parts[part] = dict(
            max_abs_err=0.0,
            ms=median_ms(lambda: spread_kernel.place_windows(*args)),
            plain_ms=median_ms(lambda: spread_kernel.place_windows_plain(
                *args)), **bound(b, 0.0))
        r = parts[part]
        print(f"[10 echo] place {part}: windows {tuple(wins.shape)}, "
              f"offsets {offsets}, {l_out} cells a pulse, "
              f"{'complex64' if complex_out else 'planes'}; vs plain bit for "
              f"bit, two launches bit-identical; {r['ms']:.3f} ms vs plain "
              f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}, {b / 1e6:.0f} MB)")
        del got, again, want
    rec["place"] = dict(
        max_abs_err=0.0, ms=sum(q["ms"] for q in parts.values()),
        plain_ms=sum(q["plain_ms"] for q in parts.values()),
        library_ms=None, **bound(n_bytes, 0.0), per_chunk=parts)
    del places

    fields, kw = slice_echo_operands(dev)
    parts, work = {}, [0.0, 0.0, 0.0]
    for part, (tau, car, amp) in fields.items():
        got = echo_kernel.echo_accumulate(tau, car, amp, **kw)
        want = echo_kernel.echo_accumulate_plain(tau, car, amp, **kw)
        err = rel_err(got, want)
        assert err <= 2e-4, (part, err)
        w, n_gate = echo_work(tau, kw)
        work = [a + b for a, b in zip(work, w)]
        parts[part] = dict(
            max_abs_err=float((got - want).abs().max()),
            ms=median_ms(lambda: echo_kernel.echo_accumulate(tau, car, amp,
                                                             **kw)),
            plain_ms=median_ms(lambda: echo_kernel.echo_accumulate_plain(
                tau, car, amp, **kw)), **bound(*w))
        r = parts[part]
        print(f"[10 echo] echo_accumulate {part}: fields {tuple(tau.shape)}"
              f", {kw['t_fast'].shape[0]} samples, {n_gate:.3e} triples in "
              f"the gate; vs plain {err:.2e} of the peak (<= 2e-4); "
              f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms; bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
        del got, want
    rec["echo_accumulate"] = dict(
        max_abs_err=max(q["max_abs_err"] for q in parts.values()),
        ms=sum(q["ms"] for q in parts.values()),
        plain_ms=sum(q["plain_ms"] for q in parts.values()),
        library_ms=None, **bound(*work), per_launch=parts)
    del fields

    args, opts_r, t0_r = ring_segment_operands(dev)

    def fused():
        return echo_kernel.echo_direct(*args, opts_r, rx_offsets=[0.0],
                                       t_start=t0_r)

    def plain():
        return plain_direct(*args, opts_r, rx_offsets=[0.0], t_start=t0_r)

    got, again, want = fused(), fused(), plain()
    err = rel_err(got, want)
    assert err <= 2e-4 and torch.equal(got, again), err
    w, n_gate = direct_work(args, opts_r, t0_r)
    shape = (args[0].shape[0], args[3].shape[0], opts_r.num_samples)
    plain_ms = median_ms(plain)
    # the plain engine is itself the PyTorch composition of the function
    rec["echo_direct"] = dict(
        max_abs_err=float((got - want).abs().max()), ms=median_ms(fused),
        plain_ms=plain_ms, library_ms=plain_ms, shape=list(shape),
        n_gate=n_gate, **bound(*w))
    r = rec["echo_direct"]
    print(f"[10 echo] echo_direct ring segment: {shape} (pulses, targets, "
          f"samples), {n_gate:.4e} triples in the gate; vs the plain engine "
          f"{err:.2e} of the peak (<= 2e-4), two launches bit-identical; "
          f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.3f} ms; bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
          f"{r['bound_ms'] / r['ms']:.1%} of it)")
    del got, again, want
    return rec


def host_median_s(fn, reps: int = 3) -> float:
    """Median host seconds of ``fn`` closed by a synchronise (warm)."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return float(np.median(times))


def device_breakdown(fn, ours=("spread_windows", "fft_conv"),
                     top: int = 8):
    """One call of ``fn`` under torch.profiler: its wall seconds there, the
    device-busy seconds (the kernels' self times summed; one stream, so
    they do not overlap), the ``top`` PyTorch operators by the device time
    of the kernels they launch, ``aten::copy_`` if it is not among them,
    and the kernels named in ``ours`` (launched
    through ctypes, so under no operator), as (name, ms, calls); None where
    the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    if busy <= 0:
        return None
    ops = sorted((e for e in events if e not in kernels and dev_us(e) > 0),
                 key=dev_us, reverse=True)
    ops = ops[:top] + [e for e in ops[top:] if e.key == "aten::copy_"]
    mine = [e for e in kernels if any(n in e.key for n in ours)]

    def name(key):             # a kernel's signature -> its bare name
        key = key.replace("(anonymous namespace)::", "")
        return key.split("(")[0].removeprefix("void ")[:60]

    return wall, busy, [(name(e.key), dev_us(e) / 1e3, e.count)
                        for e in mine + ops]


def phase_e2e(dev, setup) -> dict:
    """The full-scale chain: the channel-batched freq echo, then
    focus_and_products (the composed torch.fft route at 7,200 x 13,200);
    the launches of one pass, finite products, warm seconds; then the same
    pass through the one-accumulator spread."""
    sc, opts, t0 = setup[:3]
    reset_launches()
    raw = e2e_sim(dev, setup)
    torch.cuda.synchronize(dev)
    counts = launch_counts(ECHO_WRAPPERS)
    want = {"spread": 0, "spread_qr": 0, "spread_taps": 2 * E2E_CHUNKS,
            "fft_conv": E2E_CHUNKS, "place": 2 * E2E_CHUNKS,
            "echo_accumulate": 0, "echo_direct": 0}
    assert counts == want, counts
    n_p, ns = setup[4].times.shape[0], opts.num_samples
    assert raw.shape == (2, n_p, ns), raw.shape
    assert bool(torch.isfinite(raw).all())
    prod = gmti.focus_and_products(raw, sc, t0)
    planes = dict(slc1=prod.slc1, slc2=prod.slc2, ati_phase=prod.ati_phase,
                  dpca_mag=prod.dpca_mag, velocity_map=prod.velocity_map,
                  snr=prod.detections.snr, noise=prod.detections.noise)
    bad = [k for k, v in planes.items() if not bool(torch.isfinite(v).all())]
    assert not bad, f"non-finite planes: {bad}"
    shape = tuple(prod.slc1.shape)
    n_det = int(prod.detections.detections.sum())
    del prod, planes
    sim_s = host_median_s(lambda: e2e_sim(dev, setup)) / 2.0
    e2e_s = host_median_s(lambda: gmti.focus_and_products(
        e2e_sim(dev, setup), sc, t0))
    prof = device_breakdown(lambda: e2e_sim(dev, setup))
    if prof is None:
        print("[11 e2e] torch.profiler saw no device time")
    else:
        wall, busy, top = prof
        print(f"[11 e2e] one two-channel pass under torch.profiler: wall "
              f"{wall:.4f} s, device busy {busy:.4f} s, idle share "
              f"{1 - busy / (2 * sim_s):.3f} of the unprofiled pass "
              f"({2 * sim_s:.4f} s); device time by kernel and operator: "
              + "; ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in top))
    reset_launches()
    raw_qr = e2e_sim(dev, setup, freq_spreader="dense_kernel_qr")
    torch.cuda.synchronize(dev)
    counts_qr = launch_counts(ECHO_WRAPPERS)
    assert counts_qr["spread_qr"] == 2 * E2E_CHUNKS \
        and counts_qr["spread"] == counts_qr["spread_taps"] == 0 \
        and counts_qr["place"] == 2 * E2E_CHUNKS, counts_qr
    qr_err = rel_err(raw_qr, raw)
    assert qr_err <= 1e-5, qr_err
    raw_shape = raw.shape
    del raw, raw_qr
    print(f"[11 e2e] multi_channel_phase_history(backend='freq') of "
          f"{setup[3].num} points -> {tuple(raw_shape)} raw, launches "
          f"{counts}; focus_and_products -> {shape} products, all finite, "
          f"{n_det} CFAR detections; warm (medians of 3) sim pass "
          f"{sim_s:.4f} s a channel (two-channel pass / 2), end to end "
          f"{e2e_s:.4f} s; one-accumulator spread: launches "
          f"{ {k: v for k, v in counts_qr.items() if v} }, raw "
          f"{qr_err:.2e} of the peak from the roll order (<= 1e-5)")
    return {"spread": counts["spread"], "fft_conv": counts["fft_conv"],
            "spread_qr": counts_qr["spread_qr"], "place": counts["place"],
            "spread_taps": counts["spread_taps"]}


def phase_echo_gold(dev, sc, raw4, sc4):
    """The freq echo against the port's plain direct engine (echo._direct
    on the card) on ``sc``'s collect (config.ati_dpca(): 7,200 x 13,200;
    the destroyer alone, moving), raw and focused, and the fused direct
    engine's raw against the plain one there; then echo_backend='pallas'
    on phase 4's scene, and phase 4's raw (the fused engine), against the
    plain engine's raw of that scene."""
    ship, vel = targets.destroyer().rotate_z(90.0), (0.0, 4.0, 0.0)
    raws, prods = {}, {}
    for backend in ("freq", "jnp"):
        sc_b = sc.replace(collect=dataclasses.replace(
            sc.collect, echo_backend=backend, window_start_mode="centered"))
        with (plain_direct_engine() if backend == "jnp"
              else contextlib.nullcontext()):
            raws[backend], _, t0 = gmti.simulate_two_channel(sc_b, ship, vel,
                                                             device=dev)
        if backend == "jnp":       # the fused engine against the plain one
            fused_err = rel_err(gmti.simulate_two_channel(
                sc_b, ship, vel, device=dev)[0], raws["jnp"])
            assert fused_err <= 2e-4, fused_err
        prod = gmti.focus_and_products(raws[backend], sc_b, t0,
                                       balance=False)
        prods[backend] = (prod.slc1, prod.slc2)
        del prod
    a, b = raws["jnp"], raws["freq"]
    shape = tuple(a.shape)
    assert b.shape == a.shape and a.shape[1:] == (
        sc.collect.num_pulses(sc.radar.prf_hz),
        sc.collect.num_samples(sc.radar.fs_hz)), (a.shape, b.shape)
    err_db = 10 * math.log10(float(((b - a).abs() ** 2).mean())
                             / float((a.abs() ** 2).mean()))
    del raws, a, b
    (s1d, s2d), (s1f, s2f) = prods["jnp"], prods["freq"]
    strong = s1d.abs() > 0.05 * s1d.abs().max()
    db = float((20 * torch.log10(s1f.abs()[strong] / s1d.abs()[strong])
                ).abs().max())
    dphi = float(torch.angle((s1f * s2f.conj())[strong]
                             * (s1d * s2d.conj())[strong].conj()).abs().max())
    n_strong = int(strong.sum())
    del prods, s1d, s2d, s1f, s2f, strong
    print(f"[12 gold] freq vs the plain direct echo at {shape}, destroyer "
          f"at (0, 4, 0) m/s: field RMS error {err_db:.2f} dB (< -55); after"
          f" focus_and_products(balance=False), on {n_strong} px above 5 % "
          f"of the peak: intensity {db:.2e} dB (< 0.1), ATI phase "
          f"{dphi:.2e} rad (< 1e-3); the fused direct engine's raw "
          f"{fused_err:.2e} of the peak from the plain one (<= 2e-4)")
    assert err_db < -55 and db < 0.1 and dphi < 1e-3, (err_db, db, dphi)

    sc_p = sc4.replace(collect=dataclasses.replace(sc4.collect,
                                                   echo_backend="pallas"))
    clut = ocean_clutter_field(np.random.default_rng(0), num_points=500)
    reset_launches()
    raw_p = gmti.simulate_two_channel(sc_p, targets.destroyer(),
                                      SHIP_VELOCITY, clut, device=dev)[0]
    torch.cuda.synchronize(dev)
    n = echo_kernel.echo_accumulate.launches
    assert n == 2, n                       # the ship and the clutter
    with plain_direct_engine():
        raw_plain = gmti.simulate_two_channel(sc4, targets.destroyer(),
                                              SHIP_VELOCITY, clut,
                                              device=dev)[0]
    err, err4 = rel_err(raw_p, raw_plain), rel_err(raw4, raw_plain)
    assert err <= 2e-4 and err4 <= 2e-4, (err, err4)
    print(f"[12 gold] simulate_two_channel(echo_backend='pallas') on phase "
          f"4's scene: {n} kernel launches (ship, clutter); raw {err:.2e} of"
          f" the peak from the plain direct engine's raw (<= 2e-4); phase "
          f"4's raw (the fused direct engine) {err4:.2e} from it (<= 2e-4)")
    return n


def timed_phase(name, fn, *args):
    t = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name} {time.perf_counter() - t:.1f} s")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # full float32 everywhere: the plain versions are the kernels' reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device(dev)
    timed_phase("build", phase_build)
    rec = timed_phase("kernels", phase_kernels, dev)
    for k, planes in GMTI_PLANES.items():
        rec[k].setdefault("library_ms", None)
        rec[k].update(**bound(planes * 4.0 * N * N, 0.0))
    torch.cuda.empty_cache()
    upstream = timed_phase("upstream", phase_upstream, dev)
    rec.update(timed_phase("csa kernels", phase_csa_kernels, dev))
    for k, at in upstream.items():
        rec[k]["upstream"] = at
    torch.cuda.empty_cache()
    launches, raw, sc, t0 = timed_phase("main", phase_main, dev)
    # the single-channel kernels' launches: the formation stream's (K1, K2
    # single, K3) and the split CPI's (balance)
    form = timed_phase("formation", phase_formation, dev)
    torch.cuda.empty_cache()
    timed_phase("composed pallas", phase_composed_pallas, dev, raw, sc, t0)
    split = timed_phase("split", phase_split, dev, raw, sc, t0)
    launches.update({k: form[k] for k in ("K1", "K2 single", "K3")},
                    balance=split["balance"])
    timed_phase("golden", phase_golden, raw, sc, t0)
    torch.cuda.empty_cache()
    rec.update(timed_phase("bp", phase_bp, dev))
    torch.cuda.empty_cache()
    rec.update(timed_phase("acc", phase_acc, dev))
    torch.cuda.empty_cache()
    bp_launches, frames0, raw0, tr, vf, t0v, p = timed_phase(
        "videosar", phase_videosar, dev)
    launches.update(bp_launches)
    torch.cuda.empty_cache()
    timed_phase("bp golden", phase_bp_golden, frames0, raw0, tr, vf, t0v, p)
    del frames0, raw0, tr
    torch.cuda.empty_cache()
    setup = e2e_setup()
    rec.update(timed_phase("echo kernels", phase_echo_kernels, dev, setup))
    torch.cuda.empty_cache()
    launches.update(timed_phase("e2e", phase_e2e, dev, setup))
    torch.cuda.empty_cache()
    launches["echo_accumulate"] = timed_phase(
        "echo gold", phase_echo_gold, dev, config.ati_dpca(), raw, sc)
    del raw
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches[k], **rec[k])
               for k, (_, src, rep) in ALL_WRAPPERS.items()]
    print(f"[time] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
