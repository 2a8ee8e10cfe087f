"""One simulated two-channel collect after another: the port's echo
(ops/echo.py::multi_channel_phase_history, the configuration's backend)
of a whole scene, then models/gmti.py::focus_and_products.

Set-up: ``inputs`` scenes, the configuration's ship turned as stated plus
an ocean-clutter field drawn from the seed for each (the same sizes for
every seed); the trajectory and the echo options. A product simulates the
next scene's two channels and focuses them; the served result is its
calibration phase, cancellation ratio and CFAR detection count, copied to
the host. Traced runs time the two stages on the host clock, each closed
by a synchronise (spans 'echo' and 'focus').

Check: ``sample`` collects drawn from the seed are kept whole (raw and
products). Their raw on ``pulses`` pulses a channel drawn from the seed
against the plain reference echo (bench_torch/reference/
echo_bistatic.py, float64); their products against the plain reference's
(bench_torch/reference/gmti_products.py, float64) of the same raw; their
served results against the reference's."""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_torch import scenario
from bench_torch.reference import echo_bistatic
from bench_torch.reference import gmti_products as ref
from bench_torch.sampling import Reservoir, rel_rms


def radar_params(sc, t0: float) -> dict:
    r, g = sc.radar, sc.geometry
    return dict(wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate,
                fs_hz=r.fs_hz, prf_hz=r.prf_hz,
                velocity_mps=g.effective_velocity_mps,
                range_ref_m=g.slant_range_m, t_start_fast=float(t0))


class Products:
    def __init__(self, cfg, traffic, seed, device, trace=False):
        from nis_sar_amtigmti_video_tpu_torch.geometry import orbit
        from nis_sar_amtigmti_video_tpu_torch.models import gmti
        from nis_sar_amtigmti_video_tpu_torch.models.stripmap import (
            echo_opts_for)
        from nis_sar_amtigmti_video_tpu_torch.ops import echo
        from nis_sar_amtigmti_video_tpu_torch.scene import clutter, targets
        self.gmti, self.echo = gmti, echo
        sc = self.sc = scenario.build(cfg)
        r, g, c = sc.radar, sc.geometry, sc.collect
        self.opts = echo_opts_for(sc)
        self.t0 = float(echo.window_start_time(
            g.slant_range_m, self.opts, c.window_length_s,
            c.window_start_mode))
        self.traj = orbit.make_trajectory(g, orbit.slow_time_grid(
            c.integration_time_s, c.num_pulses(r.prf_hz)))
        self.offs = sc.channels.rx_offsets()
        self.g = cfg["products"]
        self.path = traffic["path"]
        self.limits = traffic["limits"]
        self.dev, self.trace = device, trace
        s = cfg["scene"]
        ship = getattr(targets, s["ship"])().rotate_z(s["ship_rotate_deg"])
        rng = np.random.default_rng([seed, 0x51F0])
        self.scenes = [targets.PointTargets.concatenate(
            [ship, clutter.ocean_clutter_field(
                np.random.default_rng(int(rng.integers(1 << 63))),
                num_points=s["clutter_points"])])
            for _ in range(traffic["inputs"])]
        n_p, ns = self.traj.times.shape[0], self.opts.num_samples
        self.pulse_idx = np.sort(rng.choice(n_p, traffic["pulses"],
                                            replace=False))
        self.shapes = self._echo_shapes() if trace and \
            device.type == "cuda" else {}
        self.spans = {"echo": [], "focus": []} if trace else {}
        self.sample = Reservoir(traffic["sample"], seed)
        self.ns = ns

    def _echo_shapes(self) -> dict:
        """The spread and conv launches' shapes of a pass, from the
        operands the echo hands its kernels for the first pulse chunk of
        scene 0 (echo_freq.kernel_operands), for the roofline readers."""
        from nis_sar_amtigmti_video_tpu_torch.ops import echo_freq
        fields = self.echo.scalar_fields(
            self.traj, self.scenes[0], self.opts, t_start=self.t0,
            rx_offsets=self.offs, device=self.dev)
        ops = echo_freq.kernel_operands(*fields,
                                        self.opts,
                                        **self.echo.synth_options(self.opts))
        total = fields[0].shape[0]

        def launch(c, v, win):
            return [c.shape[0], c.shape[1], c.numel(), v.numel(), v.shape[2],
                    v.shape[3], win, int((c >= 0).sum())]

        main = ops["spread main"]
        fr, _, _, nfft, rows = ops["conv"]
        return {"spread": {"launches": [launch(*main)]
                           + [launch(*e) for e in ops["spread edge"]],
                           "chunks": total / main[0].shape[0]},
                "fft_conv": {"total_rows": total,
                             "launches": -(-total // fr.shape[0]),
                             "l_imp": fr.shape[1], "nfft": nfft,
                             "band": rows[1] - rows[0]}}

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _one(self, k: int):
        t = time.perf_counter()
        raw = self.echo.multi_channel_phase_history(
            self.traj, self.scenes[k], self.opts, t_start=self.t0,
            rx_offsets=self.offs, device=self.dev)
        if self.trace:
            self._sync()
            t1 = time.perf_counter()
            self.spans["echo"].append(t1 - t)
        p = self.gmti.focus_and_products(
            raw, self.sc, self.t0, shift_pulses=self.g["shift_pulses"],
            mask_threshold=self.g["mask_threshold"], path=self.path)
        if self.trace:
            self._sync()
            self.spans["focus"].append(time.perf_counter() - t1)
        return raw, p

    def warm(self):
        self._one(0)
        if self.trace:
            self.spans = {"echo": [], "focus": []}

    def product(self, i: int):
        k = i % len(self.scenes)
        raw, p = self._one(k)
        served = torch.stack([p.cal_phase.reshape(()).float(),
                              p.cancellation_ratio.reshape(()).float(),
                              p.detections.detections.sum().float()]).cpu()
        self.sample.offer(i, lambda: (k, raw, served, dict(
            slc1=p.slc1, slc2=p.slc2, ati_phase=p.ati_phase,
            dpca_mag=p.dpca_mag, snr=p.detections.snr)))
        return served

    @staticmethod
    def served_ok(served) -> bool:
        return bool(torch.isfinite(served).all())

    def release(self):
        """Nothing to free: the kept collects are all the check needs."""

    def echo_reference(self, k: int, mode: str = "f64"):
        """(2, pulses, Ns) reference raw of scene k on the drawn pulses."""
        dev, f64 = self.dev, torch.float64
        tr = self.traj
        sat_pos = torch.as_tensor(np.asarray(tr.positions), dtype=f64,
                                  device=dev)
        sat_vel = torch.as_tensor(np.asarray(tr.velocities), dtype=f64,
                                  device=dev)
        sc = self.scenes[k]
        tgt = torch.as_tensor(np.asarray(sc.positions), dtype=f64,
                              device=dev)
        rcs = torch.as_tensor(np.asarray(sc.rcs), dtype=f64, device=dev)
        t_fast = self.t0 + torch.arange(self.ns, dtype=f64,
                                        device=dev) / self.opts.fs_hz
        o = self.opts
        return torch.stack([echo_bistatic.pulses(
            self.pulse_idx, sat_pos, sat_vel, tgt, rcs, t_fast, off,
            o.fc_hz, o.chirp_rate, o.pulse_width_s, mode)
            for off in self.offs])

    def numbers(self, mode: str | None = None) -> dict:
        """The numbers compared over the kept collects: of the program's,
        or with ``mode`` of the reference in that mode in its place (the
        raw on the drawn pulses; the products of the kept raw)."""
        out = {}
        r = radar_params(self.sc, self.t0)
        for _, (k, raw, served, prod) in self.sample.kept():
            want = self.echo_reference(k)
            got = (raw[:, self.pulse_idx] if mode is None
                   else self.echo_reference(k, mode))
            e = {"raw_err": rel_rms(got, want)}
            del want, got
            rk = ref.products(raw, r, self.g)
            if mode is None:
                s_, p_ = [(0, served)], [(0, (0, prod))]
            else:
                c = ref.products(raw, r, self.g, mode)
                s_ = [(0, torch.stack([c["cal"].float(), c["ratio"].float(),
                                       c["detections"].float()]))]
                p_ = [(0, (0, c))]
            e.update(compare_products(s_, p_, [rk]))
            del rk
            for n, v in e.items():
                out[n] = max(out.get(n, 0.0), v)
        return out

    def check(self):
        nums = self.numbers()
        return [(n, nums[n], self.limits[n]) for n in self.limits]


def compare_products(served: list, kept: list, refs: list) -> dict:
    """The numbers compared: over every served result, the largest |cal -
    cal_ref| (rad) and |ratio / ratio_ref - 1|, and the largest
    difference in the detection count; over the kept products, the
    largest relative RMS error of the SLCs and of the CFAR SNR, the RMS
    error of |dpca| relative to the reference channel-1 SLC's RMS
    (|dpca| itself is what cancellation leaves, whose size varies
    tenfold from scene to scene), and the largest ATI phase error (rad,
    wrapped) on pixels above 10 % of the reference |s1| peak (twice the
    mask threshold, so both sides keep them)."""
    cal = max(abs(float(s[0]) - float(refs[k]["cal"])) for k, s in served)
    ratio = max(abs(float(s[1]) / float(refs[k]["ratio"]) - 1.0)
                for k, s in served)
    det = max(abs(float(s[2]) - float(refs[k]["detections"]))
              for k, s in served)
    slc = dpca = snr = ati = 0.0
    for _, (k, p) in kept:
        rk = refs[k]
        slc = max(slc, rel_rms(p["slc1"], rk["slc1"]),
                  rel_rms(p["slc2"], rk["slc2"]))
        dpca = max(dpca, rel_rms(p["dpca_mag"], rk["dpca_mag"])
                   * float(torch.linalg.vector_norm(rk["dpca_mag"])
                           / torch.linalg.vector_norm(rk["slc1"])))
        snr = max(snr, rel_rms(p["snr"], rk["snr"]))
        a1 = rk["slc1"].abs()
        strong = a1 > 0.1 * a1.max()
        d = torch.angle(torch.polar(torch.ones_like(rk["ati_phase"]),
                                    p["ati_phase"].to(torch.float64)
                                    - rk["ati_phase"].to(torch.float64)))
        ati = max(ati, float(d[strong].abs().max()))
    return dict(cal_err=cal, ratio_err=ratio, det_diff=det, slc_err=slc,
                dpca_err=dpca, snr_err=snr, ati_err=ati)


def setup(cfg, traffic, seed, device, trace=False):
    return Products(cfg, traffic, seed, device, trace)
