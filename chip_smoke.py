#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Drives the two-channel ATI/DPCA GMTI CPI of the port package
``nis_sar_amtigmti_video_tpu_torch`` (scene -> two-channel echo -> DPCA
shift -> CSA x2 -> balance / ATI / DPCA / CA-CFAR) at the 4096 x 4096 CPI
shape, through the four hand-written CUDA kernels (K1g, K2 pair, K3g, K4).
Phases, one line each; any failure raises and the exit code is non-zero:

  1. device   the card's name and power limit (nvidia-smi); no CUDA: fail
  2. build    nvcc builds csrc/*.cu (timed)
  3. kernels  each kernel vs its plain PyTorch version on the card, on seeded
              4096^2 planes with the slice scenario's factors: error and
              time (CUDA events, median of 5 after a warm-up) of both
  4. main     models.gmti.run(path='kernel_fused') on the card: every launch
              counter must rise, every product plane be finite, and the
              products agree with path='composed' on the same raw; the CPI
              time of both paths, timed in 10 alternating pairs
  5. golden   the kernel path (balance=False) against the float64 NumPy
              oracle's CSA of both shifted channels: < 0.1 dB intensity and
              < 1e-3 rad ATI phase on pixels above 5 % of the peak

The line before the last is a JSON record of each kernel; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import time

import numpy as np
import torch

import oracle
from nis_sar_amtigmti_video_tpu_torch import config
from nis_sar_amtigmti_video_tpu_torch.gmti.cfar import CfarParams
from nis_sar_amtigmti_video_tpu_torch.models import gmti
from nis_sar_amtigmti_video_tpu_torch.ops import csa
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (_build, csa_kernel,
                                                       gmti_kernel)
from nis_sar_amtigmti_video_tpu_torch.scene import targets
from nis_sar_amtigmti_video_tpu_torch.scene.clutter import ocean_clutter_field
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import (cuda_times_ms,
                                                               median_ms)

N = 4096                      # the headline CPI: 4096 x 4096 after the shift
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


def phase_kernels(dev) -> dict:
    """Each kernel vs its plain version on the same seeded 4096^2 inputs
    (each stage fed the plain result of the stage before)."""
    sc = slice_scenario(N + 1, N)
    g, r = sc.geometry, sc.radar
    t0 = 2.0 * g.slant_range_m / 299792458.0 - r.pulse_width_s / 2 - 1e-6
    f = csa.csa_factors(csa.CsaParams(
        wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
        prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m, t_start_fast=t0, num_pulses=N,
        num_samples=N), dev)
    rng = np.random.default_rng(0)
    x1r, x1i, n2r, n2i = (rng.standard_normal((N, N), dtype=np.float32)
                          for _ in range(4))
    c, s = np.float32(math.cos(0.31)), np.float32(math.sin(0.31))
    # channel 2 = channel 1 rotated by 0.31 rad plus 5 % independent noise
    x = [torch.from_numpy(v).to(dev) for v in
         (x1r, x1i, c * x1r - s * x1i + 0.05 * n2r,
          s * x1r + c * x1i + 0.05 * n2i)]
    cp = CfarParams()
    h_out, h_in = cp.guard + cp.train, cp.guard
    # the per-configuration tables, built once as the main path's GmtiCpi
    # holds them (the wrappers would otherwise rebuild them per call)
    tw = csa_kernel.twiddle_table(N, dev)
    counts = gmti_kernel.cfar_counts(N, N, h_out, h_in, dev)
    rec = {}

    def timed(name, kernel, plain):
        ms = median_ms(kernel)
        plain_ms = median_ms(plain)
        rec[name].update(ms=ms, plain_ms=plain_ms)

    # K1g
    got = gmti_kernel.k1_gmti_planes(*x, f, twiddles=tw)
    ref = gmti_kernel.k1_gmti_plain(*x, f)
    err = max(rel_err(a, b) for a, b in zip(got[:4], ref[:4]))
    bal = rel_err(torch.stack(got[4:]), torch.stack(ref[4:]))
    assert err <= 1e-4 and bal <= 1e-4, (err, bal)
    rec["K1g"] = dict(max_abs_err=max(float((a - b).abs().max())
                                      for a, b in zip(got[:4], ref[:4])))
    timed("K1g", lambda: gmti_kernel.k1_gmti_planes(*x, f, twiddles=tw),
          lambda: gmti_kernel.k1_gmti_plain(*x, f))
    print(f"[3 kernels] K1g  rel err {err:.2e} (balance sums {bal:.2e}); "
          f"{rec['K1g']['ms']:.3f} ms vs plain {rec['K1g']['plain_ms']:.3f}"
          " ms")
    z, xs = ref[:4], ref[4:]
    del got, ref

    # K2 pair
    got = csa_kernel.k2_pair_call(*z, f, twiddles=tw)
    ref = csa_kernel.k2_pair_plain(*z, f)
    err = max(rel_err(a, b) for a, b in zip(got, ref))
    assert err <= 1e-4, err
    rec["K2 pair"] = dict(max_abs_err=max(float((a - b).abs().max())
                                          for a, b in zip(got, ref)))
    timed("K2 pair", lambda: csa_kernel.k2_pair_call(*z, f, twiddles=tw),
          lambda: csa_kernel.k2_pair_plain(*z, f))
    print(f"[3 kernels] K2 pair rel err {err:.2e}; "
          f"{rec['K2 pair']['ms']:.3f} ms vs plain "
          f"{rec['K2 pair']['plain_ms']:.3f} ms")
    z = ref
    del got

    # K3g
    cal = torch.atan2(xs[1], xs[0])
    cal_cs = torch.stack([torch.cos(cal), torch.sin(cal)])
    got = gmti_kernel.k3_gmti_planes(*z, cal_cs, h_out=h_out, h_in=h_in,
                                     twiddles=tw)
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
        *z, cal_cs, h_out=h_out, h_in=h_in, twiddles=tw),
        lambda: gmti_kernel.k3_gmti_plain(*z, cal_cs, h_out=h_out,
                                          h_in=h_in))
    print(f"[3 kernels] K3g  rel err {max(errs.values()):.2e}; median ATI "
          f"phase err {med:.2e} rad over {int(clear.sum())} px; "
          f"{rec['K3g']['ms']:.3f} ms vs plain {rec['K3g']['plain_ms']:.3f}"
          " ms")
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
    for wrapper, _, _ in WRAPPERS.values():
        wrapper.launches = 0


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


def phase_golden(raw, sc, t0):
    prod = gmti.focus_and_products(raw, sc, t0, path="kernel_fused",
                                   balance=False)
    s1f = prod.slc1.cpu().numpy()
    s2f = prod.slc2.cpu().numpy()
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
    db = float(np.abs(20 * np.log10(np.abs(s1f[strong])
                                    / np.abs(s1o[strong]))).max())
    ati_f = np.angle(s1f * np.conj(s2f))
    ati_o = np.angle(s1o * np.conj(s2o))
    dphi = float(np.abs(np.angle(np.exp(1j * (ati_f[strong]
                                              - ati_o[strong])))).max())
    print(f"[5 golden] vs f64 oracle on {int(strong.sum())} px above 5 % of "
          f"peak: intensity {db:.2e} dB (< 0.1), ATI phase {dphi:.2e} rad "
          f"(< 1e-3); oracle {oracle_s:.1f} s")
    assert db < 0.1 and dphi < 1e-3, (db, dphi)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    dev = torch.device("cuda", 0)
    # full float32 everywhere: the plain versions are the kernels' reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device(dev)
    phase_build()
    rec = phase_kernels(dev)
    torch.cuda.empty_cache()
    launches, raw, sc, t0 = phase_main(dev)
    phase_golden(raw, sc, t0)
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches[k], **rec[k])
               for k, (_, src, rep) in WRAPPERS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
