"""One held single-channel stripmap collect after another: the port's
models/stripmap.py::focus, the Range-Doppler Algorithm with the exact RCMC
(range compression, the azimuth window and FFT, the RCMC kernel resampling
every Doppler row and applying the azimuth filter, the azimuth IFFT).

Set-up (not timed): ``inputs`` scenes, the configuration's ship turned as
stated plus an ocean-clutter field drawn from the seed for each, each
simulated once by the port's ``stripmap.simulate_raw`` (the
configuration's echo backend, then thermal noise and K-distributed sea
clutter at the radar equation's SNR for ``noise.avg_rcs``, drawn from a
seed of its own) into a (P, Ns) complex64 raw held on the card. The echo
runs under the port's stage record, and set-up raises where its spread
dropped any (pulse, target) pair (``echo.dropped``). The warm product runs
under the record too: it checks that the RCMC kernel ran (on the card) and
that it zero-filled exactly the cells whose source lies past the far end
of their row's source grid (``rda.rcmc_zeroed``, against the count the
geometry gives). A product focuses the next held raw, cycled, with no
viewer planes; the served result is the SLC's peak magnitude, copied to
the host. The cell times no span of its own.

Check: ``sample`` products drawn from the seed keep their SLC. Against the
plain float64 reference of the same raw (bench_torch/reference/rda.py):
``slc_err`` (the SLC's RMS error over the reference's RMS), and at the
reference's brightest pixel (``spotlight.compare``) ``peak_db`` (the larger
of |dB| of the magnitude there and |dB| of the served peak against the
reference's) and ``peak_phase`` (rad)."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench_torch import core, scenario
from bench_torch.reference import rda as ref_rda
from bench_torch.sampling import Reservoir, rel_rms
from bench_torch.spotlight import compare


def zero_filled(n_az: int, n_rg: int, r: dict) -> int:
    """The cells the exact RCMC zero-fills: in each Doppler row, those of
    the range axis outside [s(0), s(n_rg - 1)] of its source grid s = r -
    delta_R(r), from the reference's axes."""
    rg, fd = ref_rda.axes(n_az, n_rg, r, torch.device("cpu"))
    g = fd * fd * r["wavelength_m"] ** 2 / (8.0 * r["velocity_mps"] ** 2)
    first, last = rg[0] - rg[0] * g, rg[-1] - rg[-1] * g
    below = torch.searchsorted(rg, first.contiguous())
    above = n_rg - torch.searchsorted(rg, last.contiguous(), right=True)
    return int((below + above).sum())


class Products:
    def __init__(self, cfg, traffic, seed, device, trace=False):
        from nis_sar_amtigmti_video_tpu_torch.models import stripmap
        from nis_sar_amtigmti_video_tpu_torch.scene import clutter, targets
        from nis_sar_amtigmti_video_tpu_torch.utils import profiling
        self.stripmap = stripmap
        sc = self.sc = scenario.build(cfg)
        pr = sc.processing
        if pr.algorithm != "rda" or pr.rcmc_mode != "exact":
            raise ValueError("the cell runs the RDA with the exact RCMC, "
                             f"got {pr.algorithm!r} / {pr.rcmc_mode!r}")
        self.limits = traffic["limits"]
        self.dev = device
        s = cfg["scene"]
        ship = getattr(targets, s["ship"])().rotate_z(s["ship_rotate_deg"])
        rng = np.random.default_rng([seed, 0x5D7A])
        self.raws = []
        t = time.perf_counter()
        with profiling.recording() as rec:
            for _ in range(traffic["inputs"]):
                scene = targets.PointTargets.concatenate(
                    [ship, clutter.ocean_clutter_field(
                        np.random.default_rng(int(rng.integers(1 << 63))),
                        num_points=s["clutter_points"])])
                raw, _, self.t0, _ = stripmap.simulate_raw(
                    sc, scene, seed=int(rng.integers(1 << 63)),
                    avg_rcs=cfg["noise"]["avg_rcs"], device=device)
                self.raws.append(raw)
        dropped = rec.counters.get("echo.dropped", 0)
        core.log(f"set-up: {len(self.raws)} raws echoed and noised in "
                 f"{time.perf_counter() - t:.3f} s; echo.dropped {dropped}")
        if dropped:
            raise RuntimeError(f"the echo's spread dropped {dropped} "
                               "(pulse, target) pairs")
        r, g = sc.radar, sc.geometry
        self.r = dict(wavelength_m=r.wavelength_m,
                      pulse_width_s=r.pulse_width_s,
                      chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
                      prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
                      range_ref_m=g.slant_range_m)
        n_az, n_rg = self.raws[0].shape
        self.shapes = {"rcmc": {"n_az": n_az, "n_rg": n_rg}} \
            if trace and device.type == "cuda" else {}
        self.spans = {}
        self.sample = Reservoir(traffic["sample"], seed)

    def _one(self, k: int):
        slc, _ = self.stripmap.focus(self.raws[k], self.sc, self.t0,
                                     intermediates=False)
        return slc

    def warm(self):
        from nis_sar_amtigmti_video_tpu_torch.ops.cuda import rcmc_kernel
        from nis_sar_amtigmti_video_tpu_torch.utils import profiling
        before = rcmc_kernel.rcmc_filter.launches
        t = time.perf_counter()
        with profiling.recording() as rec:
            self._one(0)
        if self.dev.type == "cuda" \
                and rcmc_kernel.rcmc_filter.launches == before:
            raise RuntimeError("the product did not take the kernel route")
        got = rec.counters.get("rda.rcmc_zeroed")
        want = zero_filled(*self.raws[0].shape, self.r)
        core.log(f"set-up: warm product {time.perf_counter() - t:.3f} s; "
                 f"rda.rcmc_zeroed {got} (the geometry's {want})")
        if got != want:
            raise RuntimeError(f"the RCMC zero-filled {got} cells, the "
                               f"geometry {want}")

    def product(self, i: int):
        k = i % len(self.raws)
        slc = self._one(k)
        served = slc.abs().amax().reshape(1).cpu()
        self.sample.offer(i, lambda: (k, served, slc))
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
        for _, (k, served, slc) in self.sample.kept():
            raw = self.raws[k]
            if mode is not None:
                slc = ref_rda.focus(raw, self.r, mode)
                served = slc.abs().amax().reshape(1).cpu()
            want = ref_rda.focus(raw, self.r)
            at_peak = compare(slc, want)
            served_db = abs(20.0 * math.log10(
                max(float(served[0]), 1e-300) / float(want.abs().max())))
            e = dict(slc_err=rel_rms(slc, want),
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
