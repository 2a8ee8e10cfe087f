"""Whole VideoSAR collects one after another through
models/videosar.py::run: the schedule, the per-segment echo, the forward
spectra into the ring, recentre from spectra, the accumulate and the
pipelined fetch of every frame. A call serves all its frames, and each
frame counts as a product (``units``).

Set-up: the configuration's ship at a heading and speed drawn from the
seed; a first call warms every shape. Every call adds the configuration's
thermal noise and sea clutter per step-sized segment (``noise_mode=
"per_segment"``), drawn from a noise seed taken from the run's seed.

Check: ``sample`` calls drawn from the seed keep their frames (on the
host); ``frames`` frames of each, drawn from the seed, are held against
the plain reference: the spotlight echo of the frame's CPI
(bench_torch/reference/echo_spotlight.py, float64), each segment's noise
added from the same unit draws (bench_torch/reference/noise.py), then its
exact float64 backprojection (bench_torch/reference/bp_frames.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench_torch.reference import bp_frames, echo_spotlight, noise
from bench_torch.sampling import Reservoir
from bench_torch.spotlight import Collect, compare

# the noise stream of segment s is SEGMENT_STREAM + s, as the collect
# draws it
SEGMENT_STREAM = 1_000_000


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
        self.shapes = self.col.shapes()
        self.noise_seed = seed % (1 << 62)
        self.avg_rcs = cfg["noise"]["avg_rcs"]
        self.spans = {}
        self.sample = Reservoir(traffic["sample"], seed)

    def _run(self):
        return self.videosar.run(
            self.col.sc, self.ship, heading_deg=self.col.heading,
            speed_mps=self.col.speed, algorithm="mbp",
            bp_backend=self.traffic["backend"],
            stream_spectra=self.traffic["stream_spectra"],
            noise_mode="per_segment", seed=self.noise_seed,
            avg_rcs=self.avg_rcs, device=self.dev).images

    def warm(self):
        self._run()

    def product(self, i: int):
        imgs = self._run()
        self.sample.offer(i, lambda: imgs)
        return imgs

    @staticmethod
    def served_ok(served) -> bool:
        return bool(np.isfinite(served).all())

    def release(self):
        """Nothing on the card is kept between calls."""

    def reference_raw(self, f: int) -> torch.Tensor:
        """Frame f's CPI: the plain echo plus each segment's noise."""
        c, dev, f64 = self.col, self.dev, torch.float64
        pos, vel, ts = c.frame_traj(f, dev)
        r, g = c.sc.radar, c.sc.geometry
        tgt = self.ship.rotate_z(c.heading)
        t_fast = c.t0 + torch.arange(c.p.num_samples, dtype=f64,
                                     device=dev) / r.fs_hz
        raw = echo_spotlight.cpi(
            pos, vel, ts, torch.as_tensor(np.asarray(tgt.positions), dtype=f64,
                                          device=dev),
            torch.as_tensor(np.asarray(tgt.rcs), dtype=f64, device=dev),
            c.vf, t_fast, r.fc_hz, r.chirp_rate, r.pulse_width_s,
            r.wavelength_m,
            r.wavelength_m * g.slant_range_m / c.sc.processing.bp_scene_size_m)
        snr = noise.snr_db(g.slant_range_m, self.avg_rcs, r.wavelength_m,
                           r.bandwidth_hz, dataclasses.asdict(c.sc.noise))
        step = c.sched.step_pulses
        s0 = int(c.sched.starts[f]) // step
        for j in range(raw.shape[0] // step):
            sl = slice(j * step, (j + 1) * step)
            raw[sl] = noise.add(raw[sl], self.noise_seed,
                                SEGMENT_STREAM + s0 + j, snr,
                                c.sc.noise.scr_db, c.sc.noise.k_shape)
        return raw

    def numbers(self, mode: str | None = None) -> dict:
        out = dict(peak_db=0.0, peak_phase=0.0, field_err=0.0)
        c = self.col
        for _, imgs in self.sample.kept():
            for f in self.check_frames:
                raw = self.reference_raw(int(f))
                pos, vel, ts = c.frame_traj(int(f), self.dev)
                want = bp_frames.frame(raw, pos, vel, ts, c.vf, c.t0,
                                       c.ref_params, "f64")
                got = (torch.as_tensor(imgs[int(f)], device=self.dev)
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
