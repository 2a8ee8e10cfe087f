"""One two-channel CPI after another from raw held on the card: the port's
models/gmti.py::focus_and_products (DPCA shift, both channels' CSA, ATI,
DPCA, velocity, CFAR) on the route the configuration selects.

Set-up (not timed): ``inputs`` scenes, the configuration's ship turned as
stated plus an ocean-clutter field drawn from the seed for each (the same
sizes for every seed), each simulated once by the port's echo (the
configuration's backend) into a (2, pulses, samples) complex64 raw held
on the card. Where the configuration asks for the kernel route
(``processing.fft_impl`` 'pallas'), set-up checks that the kernels take the
CPI's shape, and the warm product that the route ran them. A product
focuses the next held raw, cycled; the served result is its calibration
phase, cancellation ratio and CFAR detection count, copied to the host.
The cell times no span of its own (its traced runs read the device
trace).

Check: ``sample`` products drawn from the seed are kept whole; their
products against the plain reference's (bench_torch/reference/
gmti_products.py, float64) of the same raw, their served results against
the reference's, by the numbers of ``sim_focus.compare_products``."""

from __future__ import annotations

import numpy as np
import torch

from bench_torch import scenario
from bench_torch.kinds.sim_focus import compare_products, radar_params
from bench_torch.reference import gmti_products as ref
from bench_torch.sampling import Reservoir

# the kernels of the route, by the work names of their roofline readers
KERNELS = ("k1g", "k2_pair", "k3g", "k4")


class Products:
    def __init__(self, cfg, traffic, seed, device, trace=False):
        from nis_sar_amtigmti_video_tpu_torch.geometry import orbit
        from nis_sar_amtigmti_video_tpu_torch.models import gmti
        from nis_sar_amtigmti_video_tpu_torch.models.stripmap import (
            echo_opts_for)
        from nis_sar_amtigmti_video_tpu_torch.ops import echo
        from nis_sar_amtigmti_video_tpu_torch.ops.cuda import csa_kernel
        from nis_sar_amtigmti_video_tpu_torch.scene import clutter, targets
        self.gmti = gmti
        sc = self.sc = scenario.build(cfg)
        r, g, c = sc.radar, sc.geometry, sc.collect
        opts = echo_opts_for(sc)
        self.t0 = float(echo.window_start_time(
            g.slant_range_m, opts, c.window_length_s, c.window_start_mode))
        n_p = c.num_pulses(r.prf_hz)
        traj = orbit.make_trajectory(g, orbit.slow_time_grid(
            c.integration_time_s, n_p))
        self.g = cfg["products"]
        self.path = traffic["path"]
        self.limits = traffic["limits"]
        self.dev = device
        shift = self.g["shift_pulses"]
        self.cpi = (n_p - shift, opts.num_samples)
        self.kernels = sc.processing.fft_impl == "pallas"
        if self.kernels and not csa_kernel.supported(*self.cpi):
            raise ValueError(f"the CPI kernels do not take {self.cpi}")
        s = cfg["scene"]
        ship = getattr(targets, s["ship"])().rotate_z(s["ship_rotate_deg"])
        rng = np.random.default_rng([seed, 0xC91])
        self.raws = []
        for _ in range(traffic["inputs"]):
            scene = targets.PointTargets.concatenate(
                [ship, clutter.ocean_clutter_field(
                    np.random.default_rng(int(rng.integers(1 << 63))),
                    num_points=s["clutter_points"])])
            self.raws.append(echo.multi_channel_phase_history(
                traj, scene, opts, t_start=self.t0,
                rx_offsets=sc.channels.rx_offsets(), device=device))
        n_az, n_rg = self.cpi
        self.shapes = {k: {"n_az": n_az, "n_rg": n_rg} for k in KERNELS} \
            if trace and device.type == "cuda" else {}
        self.spans = {}
        self.sample = Reservoir(traffic["sample"], seed)

    def _one(self, k: int):
        return self.gmti.focus_and_products(
            self.raws[k], self.sc, self.t0,
            shift_pulses=self.g["shift_pulses"],
            mask_threshold=self.g["mask_threshold"], path=self.path)

    def warm(self):
        from nis_sar_amtigmti_video_tpu_torch.ops.cuda import gmti_kernel
        before = gmti_kernel.k3_gmti_planes.launches
        self._one(0)
        if self.kernels and self.dev.type == "cuda" \
                and gmti_kernel.k3_gmti_planes.launches == before:
            raise RuntimeError("the product did not take the kernel route")

    def product(self, i: int):
        k = i % len(self.raws)
        p = self._one(k)
        served = torch.stack([p.cal_phase.reshape(()).float(),
                              p.cancellation_ratio.reshape(()).float(),
                              p.detections.detections.sum().float()]).cpu()
        self.sample.offer(i, lambda: (k, served, dict(
            slc1=p.slc1, slc2=p.slc2, ati_phase=p.ati_phase,
            dpca_mag=p.dpca_mag, snr=p.detections.snr)))
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
        r = radar_params(self.sc, self.t0)
        for _, (k, served, prod) in self.sample.kept():
            raw = self.raws[k]
            rk = ref.products(raw, r, self.g)
            if mode is None:
                s_, p_ = [(0, served)], [(0, (0, prod))]
            else:
                c = ref.products(raw, r, self.g, mode)
                s_ = [(0, torch.stack([c["cal"].float(), c["ratio"].float(),
                                       c["detections"].float()]))]
                p_ = [(0, (0, c))]
            e = compare_products(s_, p_, [rk])
            del rk
            for n, v in e.items():
                out[n] = max(out.get(n, 0.0), v)
        return out

    def check(self):
        nums = self.numbers()
        return [(n, nums[n], self.limits[n]) for n in self.limits]


def setup(cfg, traffic, seed, device, trace=False):
    return Products(cfg, traffic, seed, device, trace)
