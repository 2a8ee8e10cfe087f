"""A spotlight VideoSAR collect as models/videosar.py::run lays it out,
for the harness and the plain reference: geometry, schedule, receive
window and fast-BP plan (no raw pulses), and the comparison of a frame
with the reference's."""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_torch import scenario


class Collect:
    """The configuration's collect: the ship's heading and speed drawn
    from the seed, the trajectory, the frame schedule, the receive window,
    the fast-BP parameters and plan, and the plain reference's
    parameters."""

    def __init__(self, cfg, seed, device, backend):
        from nis_sar_amtigmti_video_tpu_torch.geometry import orbit
        from nis_sar_amtigmti_video_tpu_torch.models import videosar
        from nis_sar_amtigmti_video_tpu_torch.ops import bp, bp_fast
        from nis_sar_amtigmti_video_tpu_torch.ops.echo import (
            window_start_time)
        from nis_sar_amtigmti_video_tpu_torch.video import scheduler
        sc = self.sc = scenario.build(cfg)
        r, g, v = sc.radar, sc.geometry, sc.video
        s = cfg["scene"]
        rng = np.random.default_rng([seed, 0x7153])
        self.heading = float(rng.uniform(*s["heading_deg"]))
        self.speed = float(rng.uniform(*s["speed_mps"]))
        phi = math.radians(self.heading)
        self.vel = np.array([self.speed * math.cos(phi),
                             self.speed * math.sin(phi), 0.0])
        self.sched = scheduler.make_schedule(v, r.prf_hz)
        times = np.linspace(-v.duration_s / 2.0, v.duration_s / 2.0,
                            self.sched.total_pulses)
        self.traj = orbit.make_trajectory(g, times)
        swath = sc.processing.bp_scene_size_m
        opts = videosar.spotlight_echo_opts(
            sc, videosar.antenna_length_for_swath(sc, swath))
        self.t0 = float(window_start_time(g.slant_range_m, opts,
                                          sc.collect.window_length_s,
                                          "centered"))
        self.p = videosar.bp_params_for(sc, opts)
        self.presum = sc.processing.bp_presum or bp.presum_factor(
            self.p, r.prf_hz, r.wavelength_m, g.slant_range_m,
            g.effective_velocity_mps)
        self.plan = bp_fast.make_plan(
            self.p, self.traj.positions, self.traj.times, self.t0,
            w_win=64 if backend == "fast_pallas" else 32,
            factorize=backend.startswith("fast_factor"))
        self.vf = torch.as_tensor(self.vel, dtype=torch.float64,
                                  device=device)
        self.ref_params = dict(fc_hz=r.fc_hz, chirp_rate=r.chirp_rate,
                               fs_hz=r.fs_hz, pulse_width_s=r.pulse_width_s,
                               nx=self.p.nx, ny=self.p.ny,
                               scene_size_m=self.p.scene_size_m)

    def frame_traj(self, f: int, device):
        i0 = int(self.sched.starts[f])
        sl = self.traj.slice(i0, i0 + self.sched.cpi_pulses)
        return tuple(torch.as_tensor(np.asarray(a, np.float64), device=device)
                     for a in (sl.positions, sl.velocities, sl.times))

    def shapes(self) -> dict:
        """One launch's shapes per kernel work name on the ring path:
        recentre from spectra, the forward spectra of one step's segment
        and the accumulate."""
        from nis_sar_amtigmti_video_tpu_torch.ops import bp_fast
        cpi, d, pl = self.sched.cpi_pulses, self.presum, self.plan
        rows = bp_fast.band_rows(pl)
        n_out = -(-cpi // d)
        return {
            "accumulate": dict(num_p=n_out, w=pl.w_win, ny=pl.ny_i,
                               ncols=pl.nx_i, rows=rows[1] - rows[0]),
            "recentre_from_spectra": dict(
                cpi=cpi, ns=self.p.num_samples, nfft=pl.nfft, n_out=n_out,
                band=(rows[1] - rows[0]) * 128),
            "forward_spectra": dict(pulses=self.sched.step_pulses,
                                    ns=self.p.num_samples, nfft=pl.nfft)}


def compare(got, want) -> dict:
    """peak_db, peak_phase (rad) at the reference's peak pixel; field_err:
    max ||got| - |want|| over the frame / max |want|."""
    g = got.to(torch.complex128)
    a_w, a_g = want.abs(), g.abs()
    pk = int(a_w.argmax())
    gw, ww = g.reshape(-1)[pk], want.reshape(-1)[pk]
    return dict(
        peak_db=abs(20.0 * math.log10(float(gw.abs()) / float(ww.abs()))),
        peak_phase=abs(float(torch.angle(gw * ww.conj()))),
        field_err=float((a_g - a_w).abs().max() / a_w.max()))
