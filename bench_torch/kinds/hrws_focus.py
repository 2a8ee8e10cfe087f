"""One held K-channel HRWS collect after another: the port's
models/hrws.py::reconstruct_focus, the per-Doppler-bin unfold of the K
sub-Nyquist channels to M x the system PRF, then the CSA of the result on
the configuration's route (``processing.fft_impl``; 'pallas': K1, K2 single
and K3).

Set-up (not timed): the configuration's HRWS layout (``hrws``: K channels,
M bands, the spacing of uniform effective sampling at the system PRF for
V_eff, and V_eff as the phase centres' speed); where the route is the
kernels', a check that they take the unfolded shape, before any echo; then
``inputs`` scenes, the configuration's ship turned as stated plus an
ocean-clutter field drawn from the seed for each, each echoed once by the
port's echo (the configuration's backend) at the K offsets into a (K, P,
Ns) complex64 raw held on the card. The echo runs under the port's stage
record, and set-up raises where its spread dropped any (pulse, target)
pair (``echo.dropped``). The warm product checks that the kernel route ran.
A product reconstructs and focuses the next held raw, cycled; the served
result is the SLC's peak magnitude, copied to the host. Traced runs call
the entry's two halves (``hrws.reconstruct``, then ``hrws.focus``) with a
synchronise between, and time the reconstruction on the host clock (span
'reconstruct').

Check: ``sample`` products drawn from the seed keep their SLC and a block
of ``rec_cols`` range columns of their reconstruction (its first column
drawn from the seed). Against the plain reference of the same raw
(bench_torch/reference/hrws.py, then gmti_products.focus_csa; float64):
``rec_err`` (the block's RMS error over the reference's RMS there),
``slc_err`` (the whole SLC's), and at the reference SLC's brightest pixel
(``spotlight.compare``) ``peak_db`` (the larger of |dB| of the magnitude
there and |dB| of the served peak against the reference's) and
``peak_phase`` (rad)."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench_torch import core, scenario
from bench_torch.kinds.sim_focus import radar_params
from bench_torch.reference import gmti_products
from bench_torch.reference import hrws as ref_hrws
from bench_torch.sampling import Reservoir, rel_rms
from bench_torch.spotlight import compare

# the kernels of the route, by the work names of their roofline readers
KERNELS = ("k1", "k2", "k3")


class Products:
    def __init__(self, cfg, traffic, seed, device, trace=False):
        from nis_sar_amtigmti_video_tpu_torch.geometry import orbit
        from nis_sar_amtigmti_video_tpu_torch.models import hrws
        from nis_sar_amtigmti_video_tpu_torch.models.stripmap import (
            echo_opts_for)
        from nis_sar_amtigmti_video_tpu_torch.ops import csa, echo
        from nis_sar_amtigmti_video_tpu_torch.ops.cuda import csa_kernel
        from nis_sar_amtigmti_video_tpu_torch.scene import clutter, targets
        from nis_sar_amtigmti_video_tpu_torch.utils import profiling
        self.hrws = hrws
        sc = self.sc = scenario.build(cfg)
        r, g, c = sc.radar, sc.geometry, sc.collect
        opts = echo_opts_for(sc)
        t0 = float(echo.window_start_time(
            g.slant_range_m, opts, c.window_length_s, c.window_start_mode))
        n_p = c.num_pulses(r.prf_hz)
        traj = orbit.make_trajectory(g, orbit.slow_time_grid(
            c.integration_time_s, n_p))
        h = cfg["hrws"]
        v = g.effective_velocity_mps
        self.p = hrws.HrwsParams(
            num_channels=h["channels"],
            spacing_m=hrws.uniform_sampling_spacing(v, r.prf_hz,
                                                    h["channels"]),
            prf_hz=r.prf_hz, velocity_mps=v, num_bands=h["bands"])
        self.shape = (self.p.bands * n_p, opts.num_samples)
        self.csa = csa.CsaParams(
            wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate,
            fs_hz=r.fs_hz, prf_hz=self.p.effective_prf, velocity_mps=v,
            range_ref_m=g.slant_range_m, t_start_fast=t0,
            num_pulses=self.shape[0], num_samples=self.shape[1])
        self.fft_impl = sc.processing.fft_impl
        self.kernels = self.fft_impl == "pallas"
        if self.kernels and not csa_kernel.supported(*self.shape):
            raise ValueError(f"the CSA kernels do not take {self.shape}")
        self.limits = traffic["limits"]
        self.dev, self.trace = device, trace
        s = cfg["scene"]
        ship = getattr(targets, s["ship"])().rotate_z(s["ship_rotate_deg"])
        rng = np.random.default_rng([seed, 0x4C45])
        ncols = min(int(traffic["rec_cols"]), self.shape[1])
        c0 = int(rng.integers(0, self.shape[1] - ncols + 1))
        self.cols = slice(c0, c0 + ncols)
        self.raws = []
        with profiling.recording() as rec:
            for _ in range(traffic["inputs"]):
                scene = targets.PointTargets.concatenate(
                    [ship, clutter.ocean_clutter_field(
                        np.random.default_rng(int(rng.integers(1 << 63))),
                        num_points=s["clutter_points"])])
                self.raws.append(echo.multi_channel_phase_history(
                    traj, scene, opts, t_start=t0,
                    rx_offsets=self.p.rx_offsets(), device=device))
        self.dropped = rec.counters.get("echo.dropped", 0)
        core.log(f"echo.dropped {self.dropped}")
        if self.dropped:
            raise RuntimeError(f"the echo's spread dropped {self.dropped} "
                               "(pulse, target) pairs")
        self.r = dict(radar_params(sc, t0), prf_hz=self.p.effective_prf)
        self.h = dict(rx_offsets=self.p.rx_offsets().tolist(),
                      velocity_mps=v, prf_hz=r.prf_hz, bands=self.p.bands)
        n_az, n_rg = self.shape
        self.shapes = {k: {"n_az": n_az, "n_rg": n_rg} for k in KERNELS} \
            if trace and device.type == "cuda" else {}
        self.spans = {"reconstruct": []} if trace else {}
        self.sample = Reservoir(traffic["sample"], seed)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _one(self, k: int):
        raw = self.raws[k]
        if not self.trace:
            return self.hrws.reconstruct_focus(raw, self.p, self.csa,
                                               self.fft_impl)
        t = time.perf_counter()
        rec = self.hrws.reconstruct(raw, self.p)
        self._sync()
        self.spans["reconstruct"].append(time.perf_counter() - t)
        return rec, self.hrws.focus(rec, self.csa, self.fft_impl)

    def warm(self):
        from nis_sar_amtigmti_video_tpu_torch.ops.cuda import csa_kernel
        before = csa_kernel.k3_call.launches
        self._one(0)
        if self.kernels and self.dev.type == "cuda" \
                and csa_kernel.k3_call.launches == before:
            raise RuntimeError("the product did not take the kernel route")
        for v in self.spans.values():
            v.clear()

    def product(self, i: int):
        k = i % len(self.raws)
        rec, slc = self._one(k)
        served = slc.abs().amax().reshape(1).cpu()
        self.sample.offer(i, lambda: (k, served, dict(
            rec=rec[:, self.cols].clone(), slc=slc)))
        return served

    @staticmethod
    def served_ok(served) -> bool:
        return bool(torch.isfinite(served).all())

    def release(self):
        """Frees the held raws that no kept product needs."""
        keep = {k for _, (k, _, _) in self.sample.kept()}
        self.raws = [r if k in keep else None
                     for k, r in enumerate(self.raws)]

    def numbers(self, mode: str | None = None) -> dict:
        """The numbers compared over the kept products: of the program's,
        or with ``mode`` of the reference in that mode in its place."""
        out = {}
        for _, (k, served, kept) in self.sample.kept():
            raw = self.raws[k]
            want_rec = ref_hrws.reconstruct(raw, self.h)
            if mode is None:
                rec, slc = kept["rec"], kept["slc"]
            else:
                c_rec = ref_hrws.reconstruct(raw, self.h, mode)
                rec = c_rec[:, self.cols].clone()
                slc = gmti_products.focus_csa(c_rec, self.r, mode)
                del c_rec
                served = slc.abs().amax().reshape(1).cpu()
            e = {"rec_err": rel_rms(rec, want_rec[:, self.cols])}
            want = gmti_products.focus_csa(want_rec, self.r)
            del want_rec
            at_peak = compare(slc, want)
            served_db = abs(20.0 * math.log10(
                max(float(served[0]), 1e-300) / float(want.abs().max())))
            e.update(slc_err=rel_rms(slc, want),
                     peak_db=max(at_peak["peak_db"], served_db),
                     peak_phase=at_peak["peak_phase"])
            del want, slc
            for n, v in e.items():
                out[n] = max(out.get(n, 0.0), v)
        return out

    def check(self):
        nums = self.numbers()
        return [(n, nums[n], self.limits[n]) for n in self.limits]


def setup(cfg, traffic, seed, device, trace=False):
    return Products(cfg, traffic, seed, device, trace)
