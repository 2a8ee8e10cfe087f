"""The port's direct-echo kernel route (``ops/cuda/echo_kernel.py``, the
``'pallas'`` backend of ``ops/echo.py``): its plain version against the JAX
package's Pallas echo kernel in interpret mode on the same inputs, at
tests/test_pallas.py's scenes and its 2e-4-of-the-peak bound, plus the
channel-batched form and the refusals. On the CPU no kernel launches."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nis_sar_amtigmti_video_tpu import config as jcfg  # noqa: E402
from nis_sar_amtigmti_video_tpu.geometry import orbit as jorbit  # noqa
from nis_sar_amtigmti_video_tpu.ops import echo as jecho  # noqa: E402
from nis_sar_amtigmti_video_tpu.ops.pallas import (  # noqa: E402
    echo_kernel as jecho_kernel)
from nis_sar_amtigmti_video_tpu.scene import targets as jtargets  # noqa
from nis_sar_amtigmti_video_tpu_torch.ops import echo  # noqa: E402
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import (  # noqa: E402
    echo_kernel)

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


def _kw(**kw):
    base = dict(fc_hz=9.65e9, chirp_rate=150e6 / 2e-6, pulse_width_s=2e-6,
                fs_hz=60e6, num_samples=384)
    base.update(kw)
    return base


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _rel(got, want):
    return float(np.abs(_np(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


SPOTLIGHT = dict(endpoint_grid=False, chirp_centering="centered",
                 amplitude="rcs", stop_and_go=True, antenna_length_m=30.0)


@pytest.mark.parametrize("variant", ["plain", "spotlight"])
def test_pallas_backend_matches_reference_kernel(variant):
    """backend='pallas' on the CPU (the kernel's plain version) vs the
    reference's Pallas echo kernel in interpret mode, and vs the port's
    direct engine."""
    g = jcfg.satellite_stripmap().geometry
    traj = jorbit.make_trajectory(g, jorbit.slow_time_grid(24 / 6000.0, 24))
    tgts = jtargets.destroyer()
    kw = SPOTLIGHT if variant == "spotlight" else {}
    t0 = jecho.window_start_time(
        g.slant_range_m, jecho.EchoOpts(**_kw(**kw)), 384 / 60e6,
        "reference" if variant == "plain" else "centered")
    vel = (5.0, 2.0, 0.0)
    want = np.asarray(jecho.phase_history(
        traj, tgts, jecho.EchoOpts(**_kw(backend="pallas_interpret", **kw)),
        t_start=t0, target_velocity=vel))
    before = echo_kernel.echo_accumulate.launches
    got = echo.phase_history(traj, tgts,
                             echo.EchoOpts(**_kw(backend="pallas", **kw)),
                             t_start=t0, target_velocity=vel, device="cpu")
    assert echo_kernel.echo_accumulate.launches == before
    assert np.abs(want).max() > 0
    assert _rel(got, want) < 2e-4
    direct = echo.phase_history(traj, tgts, echo.EchoOpts(**_kw(**kw)),
                                t_start=t0, target_velocity=vel,
                                device="cpu")
    assert _rel(got, _np(direct)) < 2e-4


def test_pallas_backend_small_target_chunks():
    """target_chunk=7 (the geometry pass in chunks of 7 targets) vs the
    reference's kernel route at the same chunk."""
    g = jcfg.satellite_stripmap().geometry
    traj = jorbit.make_trajectory(g, jorbit.slow_time_grid(8 / 6000.0, 8))
    tgts = jtargets.destroyer()
    kw = _kw(target_chunk=7)
    t0 = jecho.window_start_time(g.slant_range_m, jecho.EchoOpts(**kw),
                                 384 / 60e6, "reference")
    want = np.asarray(jecho.phase_history(
        traj, tgts, jecho.EchoOpts(**kw, backend="pallas_interpret"),
        t_start=t0))
    got = echo.phase_history(traj, tgts,
                             echo.EchoOpts(**kw, backend="pallas"),
                             t_start=t0, device="cpu")
    assert _rel(got, want) < 2e-4


def test_echo_accumulate_plain_unit():
    """The plain version vs the reference kernel in interpret mode on
    seeded scalars: gates cut inside the window, targets out of it."""
    rng = np.random.default_rng(4)
    p, b, ns = 6, 40, 300
    t_fast = (np.arange(ns) / 60e6).astype(np.float32)
    tau = rng.uniform(-3e-6, 6e-6, (p, b)).astype(np.float32)
    car = rng.uniform(-np.pi, np.pi, (p, b)).astype(np.float32)
    amp = rng.uniform(0.2, 1.5, (p, b)).astype(np.float32)
    kw = dict(k_pi=float(np.pi * 75e12), shift=1e-6, half=1e-6)
    want = np.asarray(jecho_kernel.echo_accumulate(
        jnp.asarray(tau), jnp.asarray(car), jnp.asarray(amp),
        jnp.asarray(t_fast), interpret=True, **kw))
    got = echo_kernel.echo_accumulate(*map(torch.from_numpy,
                                           (tau, car, amp, t_fast)), **kw)
    assert got.shape == want.shape == (p, ns)
    assert _rel(got, want) < 2e-4


def test_pallas_backend_channel_batched():
    """A (C,) rx_offset runs both channels in one scalar-field pass and
    equals per-channel calls."""
    g = jcfg.satellite_stripmap().geometry
    traj = jorbit.make_trajectory(g, jorbit.slow_time_grid(8 / 6000.0, 8))
    tgts = jtargets.destroyer()
    opts = echo.EchoOpts(**_kw(backend="pallas"))
    t0 = jecho.window_start_time(g.slant_range_m, jecho.EchoOpts(**_kw()),
                                 384 / 60e6, "reference")
    offs = (-1.3, 1.3)
    both = echo.multi_channel_phase_history(traj, tgts, opts, t_start=t0,
                                            rx_offsets=offs, device="cpu")
    assert both.shape == (2, 8, 384)
    for c, off in enumerate(offs):
        one = echo.phase_history(traj, tgts, opts, t_start=t0,
                                 rx_offset=off, device="cpu")
        assert torch.equal(both[c], one)


def test_scalar_fields_feed_echo_accumulate():
    """echo.scalar_fields and echo_kernel_args give the pallas backend's
    two passes: the kernel's plain version on them is the channel-batched
    phase history."""
    g = jcfg.satellite_stripmap().geometry
    traj = jorbit.make_trajectory(g, jorbit.slow_time_grid(8 / 6000.0, 8))
    tgts = jtargets.destroyer()
    opts = echo.EchoOpts(**_kw(backend="pallas"))
    t0 = jecho.window_start_time(g.slant_range_m, jecho.EchoOpts(**_kw()),
                                 384 / 60e6, "reference")
    kw = dict(t_start=t0, rx_offsets=(-1.3, 1.3),
              target_velocity=(5.0, 2.0, 0.0), device="cpu")
    fields = echo.scalar_fields(traj, tgts, opts, **kw)
    assert fields[0].shape == (16, tgts.num)
    got = echo_kernel.echo_accumulate(*fields,
                                      **echo.echo_kernel_args(opts, "cpu"))
    want = echo.multi_channel_phase_history(traj, tgts, opts, **kw)
    assert torch.equal(got.reshape(want.shape), want)


def test_echo_accumulate_refusals():
    x = torch.zeros((2, 3))
    with pytest.raises(NotImplementedError, match="interpret"):
        echo_kernel.echo_accumulate(x, x, x, torch.zeros(4), k_pi=1.0,
                                    shift=0.0, half=1.0, interpret=True)
    with pytest.raises(ValueError, match="unknown echo backend"):
        echo.phase_history(
            jorbit.make_trajectory(jcfg.satellite_stripmap().geometry,
                                   jorbit.slow_time_grid(0.001, 2)),
            jtargets.destroyer(), echo.EchoOpts(**_kw(backend="mxu")),
            t_start=0.0, device="cpu")


# the scalar-field route (the 'pallas' backend: the float64 geometry of
# every (pulse, target) into echo_accumulate_plain, the form the kernel's
# two instantiations sum) against the direct engine's chunked plain code:
# the option grid the card tests run at the spotlight waveform, here at
# _kw's small one
_C = 299792458.0
DIRECT_CASES = {
    "leading": dict(opts={}),
    "centered": dict(opts=dict(chirp_centering="centered")),
    "uniform grid": dict(opts=dict(endpoint_grid=False)),
    "spotlight": dict(opts=SPOTLIGHT),
    "two channels": dict(opts=SPOTLIGHT, offsets=(-1.3, 1.3)),
    "gate over the start": dict(opts=SPOTLIGHT, edge="start"),
    "gate over the end": dict(opts=dict(endpoint_grid=False), edge="end"),
    "empty scene": dict(opts=SPOTLIGHT, empty=True),
}


def _direct_operands(case, n_p=12):
    """A moving destroyer seen by the stripmap geometry for ``n_p`` pulses:
    the direct engine's float64 operands on the CPU, its options, Rx
    offsets and window start (centred on the scene, or a start that puts
    the scene's gates over the window's first or last sample)."""
    from nis_sar_amtigmti_video_tpu_torch import config as tcfg
    from nis_sar_amtigmti_video_tpu_torch.geometry import orbit as torbit
    from nis_sar_amtigmti_video_tpu_torch.scene import targets as ttargets
    c = DIRECT_CASES[case]
    opts = echo.EchoOpts(**_kw(**c["opts"]))
    g = tcfg.satellite_stripmap().geometry
    traj = torbit.make_trajectory(g, torbit.slow_time_grid(n_p / 6000.0,
                                                           n_p))
    tgts = ttargets.destroyer()
    if c.get("empty"):
        tgts = ttargets.PointTargets(np.zeros((0, 3)), np.zeros(0), ())
    win, tau_c = opts.num_samples / opts.fs_hz, 2.0 * g.slant_range_m / _C
    lo = tau_c + opts.chirp_shift - opts.half_width
    t0 = {None: tau_c - win / 2,
          "start": lo + 0.3 * opts.pulse_width_s,
          "end": lo + opts.pulse_width_s - win - 0.3 * opts.pulse_width_s,
          }[c.get("edge")]
    args = echo._inputs(traj, tgts, (5.0, 2.0, 0.0), "cpu")
    return args, opts, c.get("offsets", (0.0,)), t0


@pytest.mark.parametrize("case", sorted(DIRECT_CASES))
def test_scalar_field_route_matches_direct_engine(case):
    """backend='pallas' on the CPU (_fields at every pulse into
    echo_accumulate_plain, the channels in one pass) against backend='jnp'
    (_direct, channel by channel) on the same float64 operands: equal
    within float32 rounding (the same geometry and phases, the target sum
    associated per chunk). The gate cases reach the window's first or last
    sample; the empty scene gives zeros."""
    import dataclasses
    args, opts, offs, t0 = _direct_operands(case)
    got = echo._phase_history(*args, offs, t0,
                              dataclasses.replace(opts, backend="pallas"))
    want = echo._phase_history(*args, offs, t0, opts)
    assert got.shape == want.shape == (len(offs) * args[0].shape[0],
                                       opts.num_samples)
    if args[3].shape[0] == 0:
        assert not bool(got.abs().any()) and not bool(want.abs().any())
        return
    assert float(want.abs().max()) > 0
    assert _rel(got, want.numpy()) <= 1e-6
    edge = DIRECT_CASES[case].get("edge")
    if edge is not None:
        col = got[:, 0 if edge == "start" else -1]
        assert float(col.abs().max()) > 0


def test_echo_direct_refuses_cpu_tensors():
    """echo_direct is the card's direct engine: CPU tensors raise (and
    launch nothing), as _phase_history sends them to _direct."""
    args, opts, offs, t0 = _direct_operands("spotlight")
    before = echo_kernel.echo_direct.launches
    with pytest.raises(ValueError, match="_direct"):
        echo_kernel.echo_direct(*args, opts, rx_offsets=offs, t_start=t0)
    assert echo_kernel.echo_direct.launches == before


def _segment_scene(seed):
    """A tiny VideoSAR collect (1,000 pulses at PRF 1 kHz, 2,000 samples,
    500-pulse steps) of the moving destroyer, as run and record set it up
    on the CPU."""
    import dataclasses
    from nis_sar_amtigmti_video_tpu_torch import config as tcfg
    from nis_sar_amtigmti_video_tpu_torch.models import videosar
    from nis_sar_amtigmti_video_tpu_torch.scene import targets as ttargets
    from nis_sar_amtigmti_video_tpu_torch.video import scheduler
    sc = tcfg.videosar()
    sc = sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                  pulse_width_s=2e-6, fs_hz=150e6,
                                  prf_hz=1000.0),
        collect=dataclasses.replace(sc.collect,
                                    window_length_s=2000 / 150e6),
        video=tcfg.VideoConfig(duration_s=1.0, fps=2.0, cpi_s=0.5))
    sched = scheduler.make_schedule(sc.video, sc.radar.prf_hz)
    g = videosar._scene(sc, ttargets.destroyer(), sched, 60.0, 12.0, seed,
                        None, torch.device("cpu"))
    return videosar, sc, g, sched.step_pulses


@pytest.mark.parametrize("seed", [None, 2 ** 31 + 9], ids=["clean", "noisy"])
def test_segment_raw_from_device_windows(seed):
    """_segment_raw echoes a segment from row windows of the trajectory
    and the targets held on the run's device: the same segment, bit for
    bit, as the echo of the host trajectory's slice (the public
    phase_history) plus the segment's noise."""
    from nis_sar_amtigmti_video_tpu_torch.ops import noise
    videosar, sc, g, step = _segment_scene(seed)
    cpu = torch.device("cpu")
    for s in (0, 1):
        got = videosar._segment_raw(sc, g, s, step, seed, cpu)
        want = echo.phase_history(g.traj.slice(s * step, (s + 1) * step),
                                  g.tgt, g.opts, t_start=g.t0,
                                  target_velocity=g.vel_tgt, device=cpu)
        assert float(want.abs().max()) > 0
        if seed is not None:
            want = noise.add_ocean_noise(
                noise.generator(seed, videosar.SEGMENT_STREAM + s, cpu),
                want, g.snr_raw, sc.noise.scr_db, sc.noise.k_shape,
                ref_power_mode="peak")
        assert got.shape == (step, g.opts.num_samples)
        assert torch.equal(got, want)
