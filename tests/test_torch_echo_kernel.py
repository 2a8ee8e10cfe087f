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
