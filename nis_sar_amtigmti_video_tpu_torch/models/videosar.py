"""VideoSAR pipeline: overlapped-CPI frame formation over a spotlight collect.

Counterpart of ``nis_sar_amtigmti_video_tpu/models/videosar.py``: a collect
at PRF 5 kHz becomes half-second CPIs at 10 fps (80% overlap), each focused
by moving-grid backprojection (mBP), standard BP, or CSA. Each pulse of the
collect is simulated once, in step-sized segments that assemble the
overlapped CPIs. The reference's ``vmap`` over a frame batch is a loop over
the batch here; batches are dispatched two deep (parallel/pipeline.py), each
with its copy to pinned host memory enqueued behind it, so the card forms
batch k+1 while the host fetches batch k. A recorded collect
held on the device (``run(raw=...)``; :func:`record` makes one as the
per-segment path simulates it) is formed the same way from views of it,
with nothing simulated.

Noise: ``seed`` replaces the reference's key. Frame f draws from the
generator of (seed, schedule index of f), segment s from (seed,
1,000,000 + s), so a re-formed subset of frames draws the same noise.
``resume`` (which needs ``io/products.py``) is not ported yet.

The fast backends run the hand-written CUDA kernels of ``ops/cuda/`` on the
card: the recentre kernels (``fft_kernel.py``) for the ``*_pallas``
backends and the streaming modes, and the pixel-tile accumulate
(``bp_kernel.py``) for ``'fast_pallas'``, and the CSA kernels
(``csa_kernel.py``) for ``algorithm='csa'`` with ``fft_impl='pallas'``; on
CPU tensors each runs its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nis_sar_amtigmti_video_tpu_torch.config import ScenarioConfig
from nis_sar_amtigmti_video_tpu_torch.geometry import orbit
from nis_sar_amtigmti_video_tpu_torch.ops import bp as bp_ops
from nis_sar_amtigmti_video_tpu_torch.ops import bp_fast
from nis_sar_amtigmti_video_tpu_torch.ops import csa as csa_ops
from nis_sar_amtigmti_video_tpu_torch.ops import noise as noise_ops
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import bp_kernel, fft_kernel
from nis_sar_amtigmti_video_tpu_torch.ops.echo import (EchoOpts, _phase_history,
                                                       phase_history,
                                                       window_start_time)
from nis_sar_amtigmti_video_tpu_torch.parallel import pipeline
from nis_sar_amtigmti_video_tpu_torch.scene.targets import PointTargets
from nis_sar_amtigmti_video_tpu_torch.utils.device import entry_device
from nis_sar_amtigmti_video_tpu_torch.utils.profiling import count, span
from nis_sar_amtigmti_video_tpu_torch.video import scheduler

# bp_backend -> bp_fast accumulate ('*_pallas': the hand-written CUDA
# recentre kernel of ops/cuda/fft_kernel.py; 'fast_pallas' adds the
# pixel-tile accumulate kernel of ops/cuda/bp_kernel.py)
ACC_MAP = {"fast": "xla", "fast_pallas": "pallas", "fast_factor": "factor",
           "fast_factor_pallas": "factor_pallas", "fast_factor2": "factor2",
           "fast_factor2_pallas": "factor2_pallas"}
SEGMENT_STREAM = 1_000_000


class VideoFrames(NamedTuple):
    images: np.ndarray        # (F, ny, nx) complex64 on the host
    schedule: scheduler.FrameSchedule
    scene_size_m: float


def spotlight_echo_opts(sc: ScenarioConfig, l_ant_m: float) -> EchoOpts:
    r, c = sc.radar, sc.collect
    return EchoOpts(
        fc_hz=r.fc_hz, chirp_rate=r.chirp_rate, pulse_width_s=r.pulse_width_s,
        fs_hz=r.fs_hz, num_samples=c.num_samples(r.fs_hz, even=True),
        endpoint_grid=False, chirp_centering="centered", amplitude="rcs",
        stop_and_go=True, antenna_length_m=l_ant_m,
        backend=c.echo_backend, freq_oversample=c.echo_oversample)


def antenna_length_for_swath(sc: ScenarioConfig, swath_m: float) -> float:
    """L_ant = lambda * R0 / swath."""
    return sc.radar.wavelength_m * sc.geometry.slant_range_m / swath_m


def bp_params_for(sc: ScenarioConfig, opts: EchoOpts,
                  precision: str = "f32") -> bp_ops.BpParams:
    pr = sc.processing
    return bp_ops.BpParams(
        fc_hz=sc.radar.fc_hz, chirp_rate=sc.radar.chirp_rate,
        fs_hz=sc.radar.fs_hz, pulse_width_s=sc.radar.pulse_width_s,
        num_samples=opts.num_samples, nx=pr.bp_grid, ny=pr.bp_grid,
        scene_size_m=pr.bp_scene_size_m, precision=precision)


def _check_backend(backend: str) -> None:
    if backend != "exact" and backend not in ACC_MAP:
        raise ValueError(f"unknown BP backend {backend!r}: pick 'exact' or "
                         f"one of {sorted(ACC_MAP)}")


def form_frames_bp(raw_frames, pos_frames, vel_frames, t_frames, vel_focus,
                   t_start, p: bp_ops.BpParams, presum: int = 1,
                   backend: str = "exact", plan=None, spectra_frames=None):
    """mBP/StdBP formation frame by frame: (F, cpi, Ns) raw -> (F, ny, nx)
    complex64 on the data's device. backend: 'exact' (ops/bp.py) or a fast
    backend of ``ACC_MAP`` (one shared ``plan`` from bp_fast.make_plan over
    the whole collect; raw pulses go in, the matched filter fuses into the
    recentre). ``spectra_frames`` (F, cpi, nfft/128, 128): cached forward
    spectra (bp_fast.forward_spectra); ``raw_frames`` is then None."""
    _check_backend(backend)
    if spectra_frames is not None and backend not in ACC_MAP:
        raise ValueError("spectra_frames needs a fast-BP backend")
    frames = spectra_frames if spectra_frames is not None else raw_frames
    return torch.stack([
        form_frame_bp(
            None if spectra_frames is not None else raw_frames[f],
            pos_frames[f], vel_frames[f], t_frames[f], vel_focus, t_start, p,
            presum, backend, plan,
            None if spectra_frames is None else spectra_frames[f])
        for f in range(frames.shape[0])])


def form_frame_bp(raw, pos, vel, t_slow, vel_focus, t_start,
                  p: bp_ops.BpParams, presum: int, backend: str, plan,
                  spectra=None):
    """One frame of :func:`form_frames_bp`: (cpi, Ns) raw pulses (or
    ``spectra``, then ``raw`` None) -> (ny, nx) complex64."""
    acc = ACC_MAP.get(backend)
    if acc is None:
        return bp_ops.focus_bp(raw, pos, vel, t_slow, vel_focus, t_start, p,
                               presum=presum)
    return bp_fast.focus_bp_fast(
        raw, pos, vel, t_slow, vel_focus, t_start, p, presum=presum,
        plan=plan, accumulate=acc,
        fit_stride=16 if acc.startswith("factor") else 0,
        raw_spectra=spectra)


def form_frames_csa(raw_frames, p: csa_ops.CsaParams, fused: bool = True,
                    fft_impl: str = "xla"):
    """CSA formation: (F, cpi, Ns) -> (F, cpi, Ns) SLC frames. ``fused``:
    the grid-free ``apply_csa_fused`` with ``fft_impl`` (torch.fft, or
    'pallas': the K1 / K2 / K3 kernels where they take (cpi, Ns), torch.fft
    on the CPU elsewhere, a ValueError on the card elsewhere, e.g. at
    config.videosar()'s 2,500 x 22,004); else the grid-phase ``apply_csa``,
    which has no kernel route and raises for 'pallas' as the reference
    does."""
    dev = raw_frames.device
    if fused:
        return csa_ops.apply_csa_fused(raw_frames,
                                       csa_ops.csa_factors(p, dev), fft_impl)
    return csa_ops.apply_csa(raw_frames, csa_ops.csa_phases(p, dev),
                             fft_impl)


def simulate_cpi(sc: ScenarioConfig, targets: PointTargets, traj_slice,
                 opts: EchoOpts, t0: float, target_velocity, gen=None,
                 snr_db_raw: float | None = None, device=None):
    """One CPI of spotlight echo (+K-noise at peak-referenced SNR, drawn
    from ``gen``)."""
    raw = phase_history(traj_slice, targets, opts, t_start=t0,
                        target_velocity=target_velocity, device=device)
    if gen is not None and snr_db_raw is not None:
        raw = noise_ops.add_ocean_noise(gen, raw, snr_db_raw,
                                        sc.noise.scr_db, sc.noise.k_shape,
                                        ref_power_mode="peak")
    return raw


def _f64(a, dev):
    return torch.as_tensor(np.asarray(a, np.float64), device=dev)


def _trajectory_on(traj: orbit.Trajectory, dev):
    """The collect's float64 (positions, velocities, times) on ``dev``, in
    one copy each: a frame's trajectory is a row window of them
    (:func:`_window`), so forming a frame copies nothing from the host."""
    return tuple(_f64(a, dev) for a in (traj.positions, traj.velocities,
                                         traj.times))


def _window(tensors, i0: int, n: int):
    """Rows [i0, i0 + n) of each tensor (views)."""
    return tuple(a[i0:i0 + n] for a in tensors)


class _ToHost(NamedTuple):
    """Formed frames on their way to the host: ``host`` their copy there,
    ``done`` the event recorded behind the copy (None for a CPU tensor,
    which is its own copy)."""
    host: torch.Tensor
    done: torch.cuda.Event | None


def _to_host(img: torch.Tensor) -> _ToHost:
    """Enqueue the copy of ``img`` to the host behind the work that forms
    it, into pinned memory, without waiting: the fetch then waits for this
    copy alone, where a pageable ``.cpu()`` waits for every frame enqueued
    after it and leaves the card idle until the next is enqueued."""
    if img.device.type != "cuda":
        return _ToHost(img, None)
    host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
    host.copy_(img, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(img.device))
    return _ToHost(host, done)


def _gather(batches, n: int) -> np.ndarray:
    """The fetched (B, ...) frame batches, in order, in one (n, ...) array,
    each copied in as it arrives (while the card forms the later ones)."""
    out, f = None, 0
    for b in batches:
        if out is None:
            out = np.empty((n,) + b.shape[1:], b.dtype)
        out[f:f + len(b)] = b
        f += len(b)
    return out


def run(sc: ScenarioConfig, targets: PointTargets, *, heading_deg: float = 0.0,
        speed_mps: float = 0.0, algorithm: str = "mbp",
        frames_per_batch: int = 4, seed: int | None = None,
        avg_rcs: float | None = None, num_frames: int | None = None,
        frame_indices=None, precision: str = "f32",
        bp_backend: str = "fast", noise_mode: str = "per_frame",
        stream_spectra: bool | str = False, raw: torch.Tensor | None = None,
        device=None) -> VideoFrames:
    """Full VideoSAR product: schedule -> per-frame sim -> formation, on
    ``device`` (None: the card; a RuntimeError where there is none).

    algorithm: 'mbp' (focus on the target velocity), 'stdbp' (zero focus
    velocity) or 'csa' (:func:`form_frames_csa` with
    ``sc.processing.csa_fused`` and ``fft_impl``; with 'pallas' at the full
    VideoSAR width, 2,500 x 22,004 per CPI, not a power of two, it raises
    ValueError on the card and runs torch.fft on the CPU).
    ``frame_indices`` selects a subset of schedule frames. ``seed`` turns
    noise on (None: noise-free).

    bp_backend: 'fast' (gather-free iso-range BP), 'fast_factor' (the
    factorized accumulate; resolves to 'fast_factor2_pallas' where the plan
    has a second level, else 'fast_factor_pallas', when the plan's nfft is
    one the recentre kernels take — on every device, the CPU running the
    kernels' plain versions; elsewhere to 'fast_factor2', 'fast_factor'
    or, where the plan's bounds refuse a sub-aperture, 'fast'),
    the explicit 'fast_factor*' names, 'fast_pallas' (a plan with 64-sample
    windows, the recentre kernel and the pixel-tile accumulate kernel;
    where that kernel does not take the plan it falls back to 'fast' with
    32-sample windows on the CPU, as the reference does, and raises a
    ValueError on the card), or 'exact' (ops/bp.py).

    noise_mode: 'per_frame' (fresh noise on each assembled CPI) or
    'per_segment' (once per step-sized pulse segment; needed by
    ``stream_spectra``).

    stream_spectra: cache each pulse's matched-filtered forward spectrum
    across the overlapped frames (True / 'concat': each frame concatenates
    its segments' spectra), or keep one device-resident window of spectra
    as a ring, written in place one segment per frame ('ring'; frames form
    one at a time). Needs a fast backend, a kernel-supported nfft, a
    segment-aligned schedule and noise_mode='per_segment'; 'ring' also
    contiguous frames and step % presum == 0.

    raw: a held collect, (total_pulses, Ns) complex64 on ``device`` (a
    recording, e.g. from :func:`record`): nothing is simulated, and frame
    f's CPI is the row window ``raw[starts[f]:starts[f] + cpi]``, a view
    (no CPI is copied), formed by backprojection ('mbp' / 'stdbp') through
    the same plan, presum, backend routing and pipelined fetch.
    ``targets``, ``heading_deg`` and ``speed_mps`` still fix the focus
    velocity; ``seed`` and ``stream_spectra`` are refused (ValueError).
    """
    dev = entry_device(device)
    sched, orig_idx = _schedule(sc, num_frames, frame_indices)
    if raw is not None:
        _check_held(raw, sc, sched, dev, algorithm, seed, stream_spectra)
    with span("videosar.run", frames=len(sched.starts)):
        return _run(sc, targets, sched, orig_idx, dev, heading_deg,
                    speed_mps, algorithm, frames_per_batch, seed, avg_rcs,
                    precision, bp_backend, noise_mode, stream_spectra, raw)


def record(sc: ScenarioConfig, targets: PointTargets, *,
           heading_deg: float = 0.0, speed_mps: float = 0.0,
           seed: int | None = None, avg_rcs: float | None = None,
           device=None) -> torch.Tensor:
    """A whole collect as :func:`run` simulates it per segment: each
    step-sized segment's echo plus, with ``seed``, its noise (as
    ``noise_mode='per_segment'`` draws it), in one (total_pulses, Ns)
    complex64 tensor on ``device``: what ``run(raw=...)`` takes."""
    dev = entry_device(device)
    sched = scheduler.make_schedule(sc.video, sc.radar.prf_hz)
    g = _scene(sc, targets, sched, heading_deg, speed_mps, seed, avg_rcs,
               dev)
    step = sched.step_pulses
    out = torch.empty((sched.total_pulses, g.opts.num_samples),
                      dtype=torch.complex64, device=dev)
    for s in range(-(-sched.total_pulses // step)):
        out[s * step:(s + 1) * step] = _segment_raw(sc, g, s, step, seed, dev)
    return out


def _check_held(raw, sc: ScenarioConfig, sched, dev, algorithm, seed,
                stream_spectra) -> None:
    """ValueError unless ``raw`` is a collect :func:`run` can hold."""
    ns = spotlight_echo_opts(sc, 1.0).num_samples
    want = (sched.total_pulses, ns)
    if not isinstance(raw, torch.Tensor) or raw.dtype != torch.complex64:
        raise ValueError("raw: a held collect is a complex64 tensor, not "
                         f"{getattr(raw, 'dtype', type(raw).__name__)}")
    if tuple(raw.shape) != want:
        raise ValueError(f"raw: the collect is (pulses, samples) = {want}, "
                         f"not {tuple(raw.shape)}")
    if raw.device != dev:
        raise ValueError(f"raw is on {raw.device}, the run on {dev}")
    if not raw.is_contiguous():
        raise ValueError("raw: a held collect's rows are contiguous (each "
                         "CPI a row window of it)")
    if seed is not None:
        raise ValueError("raw: a held collect carries its own noise; pass "
                         "no seed")
    if stream_spectra is not False:
        raise ValueError("raw: a held collect is formed from its pulses; "
                         "stream_spectra must be False")
    if algorithm not in ("mbp", "stdbp"):
        raise ValueError("raw: a held collect is formed by backprojection "
                         f"('mbp' or 'stdbp'), not {algorithm!r}")


class _Scene(NamedTuple):
    """A collect's geometry and echo: trajectory, rotated targets and
    their velocity, echo options, receive window start, noise SNR (None:
    noise-free), and the trajectory and targets on the run's device
    (:class:`_OnDevice`)."""
    traj: orbit.Trajectory
    tgt: PointTargets
    vel_tgt: np.ndarray
    opts: EchoOpts
    t0: float
    snr_raw: float | None
    on: "_OnDevice"


class _OnDevice(NamedTuple):
    """A collect's float64 trajectory (``traj``: positions, velocities,
    times, a row each pulse) and targets (positions (B, 3), RCS, their
    velocity (3,)) on the run's device, copied there once a call: a
    segment's echo and a frame's trajectory are row windows of them
    (:func:`_window`), so neither copies anything from the host."""
    traj: tuple
    tgt_pos: torch.Tensor
    tgt_rcs: torch.Tensor
    tgt_vel: torch.Tensor


def _scene(sc: ScenarioConfig, targets: PointTargets, sched, heading_deg,
           speed_mps, seed, avg_rcs, dev) -> _Scene:
    r, g, v = sc.radar, sc.geometry, sc.video
    times = np.linspace(-v.duration_s / 2.0, v.duration_s / 2.0,
                        sched.total_pulses)
    traj = orbit.make_trajectory(g, times)

    phi = np.radians(heading_deg)
    tgt = targets.rotate_z(heading_deg)
    vel_tgt = np.array([speed_mps * np.cos(phi), speed_mps * np.sin(phi), 0.0])

    opts = spotlight_echo_opts(
        sc, antenna_length_for_swath(sc, sc.processing.bp_scene_size_m))
    t0 = window_start_time(g.slant_range_m, opts, sc.collect.window_length_s,
                           "centered")

    snr_raw = None
    if seed is not None:
        rcs = avg_rcs if avg_rcs is not None else 5000.0
        snr_raw, _ = noise_ops.snr_db(sc.noise, g.slant_range_m, rcs,
                                      r.wavelength_m, r.bandwidth_hz, None)
    on = _OnDevice(_trajectory_on(traj, dev),
                   _f64(tgt.positions, dev).reshape(-1, 3),
                   _f64(tgt.rcs, dev), _f64(vel_tgt, dev))
    return _Scene(traj, tgt, vel_tgt, opts, t0, snr_raw, on)


def _segment_raw(sc: ScenarioConfig, g: _Scene, s: int, step: int, seed,
                 dev) -> torch.Tensor:
    """Segment s (pulses [s step, (s + 1) step)): its echo, from row
    windows of the trajectory and the targets on the device (no copy from
    the host), plus its noise from stream SEGMENT_STREAM + s where ``g``
    has an SNR."""
    pos, vel, ts = _window(g.on.traj, s * step, step)
    with span("segment.echo", s=s):
        raw_s = _phase_history(ts, pos, vel, g.on.tgt_pos, g.on.tgt_rcs,
                               g.on.tgt_vel, [0.0], float(g.t0), g.opts)
    if g.snr_raw is not None:
        with span("segment.noise", s=s):
            raw_s = noise_ops.add_ocean_noise(
                noise_ops.generator(seed, SEGMENT_STREAM + s, dev),
                raw_s, g.snr_raw, sc.noise.scr_db, sc.noise.k_shape,
                ref_power_mode="peak")
    return raw_s


def _schedule(sc: ScenarioConfig, num_frames, frame_indices):
    """:func:`run`'s frame schedule and each frame's index in the whole
    collect's schedule."""
    sched = scheduler.make_schedule(sc.video, sc.radar.prf_hz)
    orig_idx = np.arange(sched.num_frames)
    if num_frames is not None:
        sched = sched._replace(starts=sched.starts[:num_frames])
        orig_idx = orig_idx[:num_frames]
    if frame_indices is not None:
        frame_indices = sorted(int(i) for i in frame_indices)
        sched = sched._replace(starts=sched.starts[frame_indices])
        orig_idx = np.asarray(frame_indices)
    return sched, orig_idx


def _run(sc, targets, sched, orig_idx, dev, heading_deg, speed_mps,
         algorithm, frames_per_batch, seed, avg_rcs, precision, bp_backend,
         noise_mode, stream_spectra, raw) -> VideoFrames:
    """:func:`run` on its schedule and device."""
    r, g = sc.radar, sc.geometry
    scene = _scene(sc, targets, sched, heading_deg, speed_mps, seed, avg_rcs,
                   dev)
    traj, tgt, vel_tgt, opts, t0, snr_raw, on = scene
    swath = sc.processing.bp_scene_size_m

    vel_focus = vel_tgt if algorithm == "mbp" else np.zeros(3)
    p_bp = bp_params_for(sc, opts, precision)
    presum = sc.processing.bp_presum or bp_ops.presum_factor(
        p_bp, r.prf_hz, r.wavelength_m, g.slant_range_m,
        g.effective_velocity_mps)
    bp_plan = None
    if algorithm in ("mbp", "stdbp"):
        _check_backend(bp_backend)
    if algorithm in ("mbp", "stdbp") and bp_backend.startswith("fast"):
        factor = bp_backend.startswith("fast_factor")
        with span("bp.plan"):
            bp_plan = bp_fast.make_plan(
                p_bp, traj.positions, traj.times, float(t0),
                w_win=64 if bp_backend == "fast_pallas" else 32,
                factorize=factor)
        if bp_backend == "fast_pallas" and not bp_kernel.supported(bp_plan):
            if dev.type != "cpu":
                raise ValueError(
                    "bp_backend='fast_pallas': the pixel-tile kernel takes a "
                    "128-multiple grid, not the plan's "
                    f"{bp_plan.ny_i} x {bp_plan.nx_i}: pick 'fast'")
            bp_backend = "fast"        # the reference's routing, on the CPU
            with span("bp.plan"):
                bp_plan = bp_fast.make_plan(p_bp, traj.positions, traj.times,
                                            float(t0))
        elif bp_backend == "fast_factor" and fft_kernel.supported(
                bp_plan.nfft):
            # the recentre kernel serves every plan; where the bounds
            # refuse a sub-aperture (sub_raw == 0, as over a whole 5 s
            # reference collect) the accumulate is the plain iso-range one
            bp_backend = ("fast_factor2_pallas" if bp_plan.sub_raw1 > 0
                          else "fast_factor_pallas")
        elif factor and bp_plan.sub_raw == 0:
            bp_backend = "fast"        # bounds refused: plain fast path
        elif bp_backend == "fast_factor" and bp_plan.sub_raw1 > 0:
            bp_backend = "fast_factor2"

    step = sched.step_pulses
    use_segments = (sched.num_frames > 1 and sched.cpi_pulses % step == 0
                    and all(int(s) % step == 0 for s in sched.starts))
    segs_per_cpi = sched.cpi_pulses // step if use_segments else 0
    seg_cache, spec_cache = {}, {}

    if noise_mode not in ("per_frame", "per_segment"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if stream_spectra:
        if algorithm not in ("mbp", "stdbp") \
                or not bp_backend.startswith("fast"):
            raise ValueError("stream_spectra needs a fast-BP backend "
                             f"(algorithm={algorithm!r}, "
                             f"bp_backend={bp_backend!r})")
        if seed is not None and noise_mode != "per_segment":
            raise ValueError(
                "stream_spectra caches per-pulse forward spectra across "
                "overlapped frames, so noise must be drawn per pulse: pass "
                "noise_mode='per_segment'")
        if not fft_kernel.supported(bp_plan.nfft):
            raise ValueError(
                f"stream_spectra: plan nfft={bp_plan.nfft} outside the FFT "
                "kernel's supported range")
        if not use_segments:
            raise ValueError("stream_spectra needs a segment-aligned "
                             "schedule (cpi/starts multiples of the step)")
        if stream_spectra not in (True, "concat", "ring"):
            raise ValueError(f"unknown stream_spectra {stream_spectra!r} "
                             "(True | 'concat' | 'ring')")
        if stream_spectra == "ring":
            starts_i = np.asarray(sched.starts, np.int64)
            if len(starts_i) > 1 and not np.all(np.diff(starts_i) == step):
                raise ValueError("stream_spectra='ring' advances one step "
                                 "per frame: schedule frames must be "
                                 "contiguous (no frame_indices gaps)")
            if step % max(1, presum) != 0:
                raise ValueError(
                    f"stream_spectra='ring' needs step % presum == 0 "
                    f"(ring_offset must not straddle a presum group): "
                    f"step={step}, presum={presum}")

    def segment(s):
        if s in seg_cache:
            count("segment.reused")
            return seg_cache[s]
        count("segment.echoed")
        raw_s = _segment_raw(sc, scene if noise_mode == "per_segment"
                             else scene._replace(snr_raw=None), s, step,
                             seed, dev)
        seg_cache[s] = raw_s
        return raw_s

    def segment_spectra(s):
        if s not in spec_cache:
            raw_s = segment(s)
            with span("segment.spectra", s=s):
                spec_cache[s] = bp_fast.forward_spectra(raw_s, p_bp)
        return spec_cache[s]

    def _drop_stale(s0):
        for cache in (seg_cache, spec_cache):
            for s in [k for k in cache if k < s0]:
                del cache[s]

    def frame_gen(f):
        if snr_raw is None:
            return None
        return noise_ops.generator(seed, int(orig_idx[f]), dev)

    def frame_raw(f):
        if use_segments:
            s0 = int(sched.starts[f]) // step
            raw = torch.cat([segment(s0 + j) for j in range(segs_per_cpi)])
            _drop_stale(s0)
            if snr_raw is not None and noise_mode == "per_frame":
                raw = noise_ops.add_ocean_noise(frame_gen(f), raw, snr_raw,
                                                sc.noise.scr_db,
                                                sc.noise.k_shape,
                                                ref_power_mode="peak")
            return raw
        if noise_mode == "per_segment":
            raise ValueError("noise_mode='per_segment' needs a segment-"
                             "aligned schedule (cpi/starts multiples of "
                             "the step)")
        sl = traj.slice(int(sched.starts[f]),
                        int(sched.starts[f]) + sched.cpi_pulses)
        return simulate_cpi(sc, tgt, sl, opts, t0, vel_tgt, frame_gen(f),
                            snr_raw, device=dev)

    def frame_spectra(f):
        s0 = int(sched.starts[f]) // step
        sp = torch.cat([segment_spectra(s0 + j) for j in range(segs_per_cpi)])
        _drop_stale(s0)
        return sp

    def frame_traj(f):
        return _window(on.traj, int(sched.starts[f]), sched.cpi_pulses)

    f_total = sched.num_frames
    vf = _f64(vel_focus, dev)

    def fetch(h: _ToHost):
        with span("frame.fetch"):
            if h.done is not None:
                h.done.synchronize()
            return h.host.numpy()

    if stream_spectra == "ring":
        # one device-resident spectra window, written in place one segment
        # per frame; slot j holds chronological pulse (j - wp) % cpi
        acc = ACC_MAP[bp_backend]
        fs = 16 if acc.startswith("factor") else 0

        def ring_frames():
            spec_buf, wp = None, 0
            for f in range(f_total):
                # the span closes before the yield: the fetch is not the
                # frame's
                with span("frame", f=f):
                    with span("frame.traj"):
                        po, ve, ts = frame_traj(f)
                    if spec_buf is None:
                        spec_buf = frame_spectra(f)
                    else:
                        s0 = int(sched.starts[f]) // step
                        spec_buf[wp:wp + step] = segment_spectra(
                            s0 + segs_per_cpi - 1)
                        _drop_stale(s0)
                        wp = (wp + step) % sched.cpi_pulses
                    with span("frame.bp"):
                        img = bp_fast.focus_bp_fast(
                            None, po, ve, ts, vf, float(t0), p_bp,
                            presum=presum, plan=bp_plan, accumulate=acc,
                            fit_stride=fs, raw_spectra=spec_buf,
                            ring_offset=wp if wp else None)
                yield img

        frames = pipeline.pipelined(_to_host, ring_frames(), depth=2,
                                    fetch=fetch)
        return VideoFrames(images=_gather((a[None] for a in frames),
                                          f_total),
                           schedule=sched, scene_size_m=swath)

    def dispatch_batch(b0):
        """Enqueue one frame batch; the pipeline fetches batch k while the
        card forms batch k+1."""
        b1 = min(b0 + frames_per_batch, f_total)
        fr = range(b0, b1)
        trajs = [frame_traj(f) for f in fr]
        pos_b, vel_b, t_b = (torch.stack([t[i] for t in trajs])
                             for i in range(3))
        if algorithm in ("mbp", "stdbp"):
            if stream_spectra:
                spec_b = torch.stack([frame_spectra(f) for f in fr])
                with span("frame.bp"):
                    return form_frames_bp(None, pos_b, vel_b, t_b, vf,
                                          float(t0), p_bp, presum,
                                          backend=bp_backend, plan=bp_plan,
                                          spectra_frames=spec_b)
            raw_b = torch.stack([frame_raw(f) for f in fr])
            with span("frame.bp"):
                return form_frames_bp(raw_b, pos_b, vel_b, t_b, vf,
                                      float(t0), p_bp, presum,
                                      backend=bp_backend, plan=bp_plan)
        if algorithm == "csa":
            p_csa = csa_ops.CsaParams(
                wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate,
                fs_hz=r.fs_hz, prf_hz=r.prf_hz,
                velocity_mps=g.effective_velocity_mps,
                range_ref_m=g.slant_range_m, t_start_fast=t0,
                num_pulses=sched.cpi_pulses, num_samples=opts.num_samples)
            raw_b = torch.stack([frame_raw(f) for f in fr])
            with span("frame.bp"):
                return form_frames_csa(raw_b, p_csa,
                                       fused=sc.processing.csa_fused,
                                       fft_impl=sc.processing.fft_impl)
        raise ValueError(f"unknown algorithm {algorithm!r}")

    def held_batch(b0):
        """Enqueue one frame batch of the held collect: frame f's CPI is a
        row window of it (a view, not a copy), formed under f's own
        span."""
        imgs = []
        for f in range(b0, min(b0 + frames_per_batch, f_total)):
            count("frame.held")
            i0 = int(sched.starts[f])
            with span("frame", f=f):
                with span("frame.traj"):
                    po, ve, ts = frame_traj(f)
                with span("frame.bp"):
                    imgs.append(form_frame_bp(
                        raw[i0:i0 + sched.cpi_pulses], po, ve, ts, vf,
                        float(t0), p_bp, presum, bp_backend, bp_plan))
        return torch.stack(imgs)

    form_batch = held_batch if raw is not None else dispatch_batch
    batches = pipeline.pipelined(lambda b0: _to_host(form_batch(b0)),
                                 range(0, f_total, frames_per_batch),
                                 depth=2, fetch=fetch)
    return VideoFrames(images=_gather(batches, f_total), schedule=sched,
                       scene_size_m=swath)
