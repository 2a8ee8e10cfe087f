"""Recorded 5 s spotlight collects formed into VideoSAR frames through
models/videosar.py::run(raw=...): frame f's CPI is a row window of a
collect held on the card, formed through recentre + presum (the fast
backprojection's raw route), the accumulate, finalize and droop, with the
pipelined fetch of every frame. Nothing is simulated in a call. A call
serves all its frames, and each frame counts as a product (``units``).

Set-up: the configuration's ship at a heading and speed drawn from the
seed; ``collects`` recordings held on the card (a recorder's double
buffer), each the port's per-segment echo plus its per-segment thermal + K
noise (``videosar.record``, the ring cell's noise), each from a noise seed
of its own taken from the run's seed; then one whole call warms every
shape. Call i forms collect i mod ``collects``.

Check: ``sample`` calls drawn from the seed keep their frames (on the host)
and which collect they formed; ``frames`` frames of each, drawn from the
seed, are held against the plain reference's exact float64 backprojection
(bench_torch/reference/bp_frames.py) of the same held CPI in complex128."""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.reference import bp_frames
from bench_torch.sampling import Reservoir
from bench_torch.spotlight import Collect, compare


class Products:
    def __init__(self, cfg, traffic, seed, device, trace=False):
        from nis_sar_amtigmti_video_tpu_torch.models import videosar
        from nis_sar_amtigmti_video_tpu_torch.scene import targets
        self.videosar = videosar
        self.traffic, self.dev = traffic, device
        # the collect's geometry, plan and shapes, without its raw pulses
        self.col = Collect(cfg, seed, device, traffic["backend"])
        self.ship = getattr(targets, cfg["scene"]["ship"])()
        self.units = len(self.col.sched.starts)
        self.limits = traffic["limits"]
        rng = np.random.default_rng([seed, 0xF4A3])
        self.check_frames = np.sort(rng.choice(self.units,
                                               traffic["frames"],
                                               replace=False))
        s = self.col.shapes()
        # the raw route's recentre + presum takes the CPI that recentre
        # from spectra takes as spectra
        self.shapes = {"accumulate": s["accumulate"],
                       "recenter_presum": s["recentre_from_spectra"]}
        self.spans = {}
        self.sample = Reservoir(traffic["sample"], seed)
        self.held = [videosar.record(
            self.col.sc, self.ship, heading_deg=self.col.heading,
            speed_mps=self.col.speed, seed=(seed + j) % (1 << 62),
            avg_rcs=cfg["noise"]["avg_rcs"], device=device)
            for j in range(traffic["collects"])]

    def _run(self, raw):
        return self.videosar.run(
            self.col.sc, self.ship, heading_deg=self.col.heading,
            speed_mps=self.col.speed, algorithm="mbp",
            bp_backend=self.traffic["backend"], raw=raw,
            device=self.dev).images

    def warm(self):
        self._run(self.held[0])

    def product(self, i: int):
        j = i % len(self.held)
        imgs = self._run(self.held[j])
        self.sample.offer(i, lambda: (j, imgs))
        return imgs

    @staticmethod
    def served_ok(served) -> bool:
        return bool(np.isfinite(served).all())

    def release(self):
        """Free the held collects that no kept call formed."""
        kept = {j for _, (j, _) in self.sample.kept()}
        self.held = [h if j in kept else None
                     for j, h in enumerate(self.held)]

    def numbers(self, mode: str | None = None) -> dict:
        out = dict(peak_db=0.0, peak_phase=0.0, field_err=0.0)
        c = self.col
        for _, (j, imgs) in self.sample.kept():
            for f in (int(f) for f in self.check_frames):
                s0 = int(c.sched.starts[f])
                raw = self.held[j][s0:s0 + c.sched.cpi_pulses].to(
                    torch.complex128)
                pos, vel, ts = c.frame_traj(f, self.dev)
                want = bp_frames.frame(raw, pos, vel, ts, c.vf, c.t0,
                                       c.ref_params, "f64")
                got = (torch.as_tensor(imgs[f], device=self.dev)
                       if mode is None else bp_frames.frame(
                           raw, pos, vel, ts, c.vf, c.t0, c.ref_params,
                           mode))
                for k, v in compare(got, want).items():
                    out[k] = max(out[k], v)
        return out

    def check(self):
        nums = self.numbers()
        return [(n, nums[n], self.limits[n]) for n in self.limits]


def setup(cfg, traffic, seed, device, trace=False):
    return Products(cfg, traffic, seed, device, trace)
