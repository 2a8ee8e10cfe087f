"""The fast backprojection's frame graph (``ops/bp_fast.py``): the host
constants of a frame's formation, built once and kept on the device, equal
the ones built per frame bit for bit; the recentres' ``out=``; the
collect's trajectory uploaded once per ``videosar.run`` and sliced per
frame; CPU tensors never capture; and the graph route's plumbing (static
inputs, the recentre writing the static rc2, one capture per key, frames
cloned out of the static output) with a stand-in graph that replays by
running the formation again on its static inputs.

The tests marked ``cuda`` hold real CUDA graph replays to the eager
formation bit for bit on the card (the held route's recentre + presum and
the ring's recentre from spectra with a ring offset, at a small size and
at the cells' full width), frames formed back to back and held together,
and the capture and replay counts of a second ``run``; they skip where no
CUDA device is present. On a GPU machine: ``python -m pytest --noconftest
tests/test_torch_bp_graph.py -q``."""

import collections
import copy
import dataclasses
import gc
import json
import pathlib
import weakref

import numpy as np
import pytest
import torch

from bench_torch.spotlight import Collect
from bench_torch.tests.tiny import VIDEO_TINY
from nis_sar_amtigmti_video_tpu_torch import config
from nis_sar_amtigmti_video_tpu_torch.geometry import orbit
from nis_sar_amtigmti_video_tpu_torch.models import videosar
from nis_sar_amtigmti_video_tpu_torch.ops import bp, bp_fast
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import bp_kernel, fft_kernel
from nis_sar_amtigmti_video_tpu_torch.scene import targets as T
from nis_sar_amtigmti_video_tpu_torch.utils import profiling
from nis_sar_amtigmti_video_tpu_torch.utils.anchors import anchor_plan

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 4321
F64 = torch.float64


# --------------------------------------------------------------------------
# the constants, built once
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num_p,h", [(512, 8), (625, 16), (100, 7)])
def test_anchor_tables_equal_the_per_frame_copies(num_p, h):
    got = bp_fast._anchor_tables(num_p, h, CPU)
    assert bp_fast._anchor_tables(num_p, h, CPU) is got       # built once
    for t, a in zip(got, anchor_plan(num_p, h)):
        want = torch.as_tensor(a, device=CPU)
        assert t.dtype == want.dtype and torch.equal(t, want)
    # the fit's per-column views gather what the per-column copies did
    v = torch.arange(got[0].shape[0] * 5, dtype=F64).reshape(-1, 5)
    for k, col in enumerate(got[1].unbind(1)):
        want = torch.as_tensor(anchor_plan(num_p, h)[1][:, k], device=CPU)
        assert torch.equal(v[col], v[want])


@pytest.mark.parametrize("nx_i,dx_m", [(640, 0.9784735812133072),
                                       (256, 3.1496062992125986)])
def test_internal_cols_equal_the_per_frame_copy(nx_i, dx_m):
    got = bp_fast._internal_cols(nx_i, dx_m, CPU)
    want = torch.as_tensor((np.arange(nx_i) - (nx_i - 1) / 2.0) * dx_m)
    assert got.dtype == F64 and torch.equal(got, want)


@pytest.mark.parametrize("size,ny", [(500.0, 512), (400.0, 128)])
def test_output_rows_equal_the_per_frame_copy(size, ny):
    got = bp_fast._output_rows(size, ny, CPU)
    want = torch.as_tensor(np.linspace(-size / 2.0, size / 2.0, ny))
    assert got.dtype == F64 and torch.equal(got, want)


@pytest.mark.parametrize("a_max", [312.5, 0.0, 1e-3])
def test_fit_offsets_and_y_axis_equal_the_per_frame_copies(a_max):
    assert torch.equal(bp_fast._fit_offsets(a_max, CPU),
                       torch.tensor([-a_max, 0.0, a_max], dtype=F64))
    assert bp_fast._fit_offsets(a_max, CPU) is bp_fast._fit_offsets(a_max,
                                                                     CPU)
    assert torch.equal(bp_fast._y_axis(CPU),
                       torch.tensor([0.0, 1.0], dtype=F64))


def _droop_per_frame(sat_pos, sat_vel, t_slow, vel_focus, p, d):
    """``presum_droop_correction`` as it was, with the pixel grid built
    and copied on each call."""
    import math
    pos, vel = bp._f64(sat_pos), bp._f64(sat_vel)
    ts, vf = bp._f64(t_slow), bp._f64(vel_focus)
    c = ts.shape[0] // 2
    lam = 299792458.0 / p.fc_hz
    prf = (ts.shape[0] - 1) / (ts[-1] - ts[0])
    org = vf * (ts[c] - ts.mean())
    g = torch.from_numpy(bp.pixel_grid(p)) + org[None, :]
    ug = pos[c][None, :] - g
    ug = ug / torch.linalg.norm(ug, dim=-1, keepdim=True)
    u0 = pos[c] - org
    u0 = u0 / torch.linalg.norm(u0)
    v_rel = vel[c] - vf
    x = math.pi * (2.0 / lam) * (ug @ v_rel - torch.dot(u0, v_rel)) * d / prf
    safe = torch.where(torch.abs(x) < 1e-6, torch.ones_like(x), x)
    corr = torch.where(torch.abs(x) < 1e-6, torch.ones_like(x),
                       safe / torch.sin(safe))
    return torch.clamp(corr, -3.0, 3.0).reshape(p.ny, p.nx).to(torch.float32)


@pytest.mark.parametrize("grid,size,d", [(64, 500.0, 4), (48, 400.0, 2)])
def test_droop_with_the_kept_pixel_grid_equals_the_per_frame_grid(grid, size,
                                                                   d):
    sc = config.videosar()
    r = sc.radar
    traj = orbit.make_trajectory(sc.geometry,
                                 orbit.slow_time_grid(400 / r.prf_hz, 400))
    p = bp.BpParams(fc_hz=r.fc_hz, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
                    pulse_width_s=r.pulse_width_s, num_samples=1000,
                    nx=grid, ny=grid, scene_size_m=size)
    vf = np.array([9.0, -4.0, 0.0])
    assert torch.equal(bp.pixel_grid_on(p, CPU),
                       torch.from_numpy(bp.pixel_grid(p)))
    assert bp.pixel_grid_on(p, CPU) is bp.pixel_grid_on(p, CPU)
    want = _droop_per_frame(traj.positions, traj.velocities, traj.times, vf,
                            p, d)
    for _ in range(2):
        got = bp.presum_droop_correction(traj.positions, traj.velocities,
                                         traj.times, vf, p, d)
        assert torch.equal(got, want)


# --------------------------------------------------------------------------
# the recentres' out=
# --------------------------------------------------------------------------

def _recentre_case():
    """Seeded raw pulses of the 9,000-sample window (nfft 16,384), the
    videosar geometry's float64 trajectory, BpParams, t_ref, presum 4 and
    band rows."""
    sc = config.videosar()
    r = sc.radar
    n_p, ns, d = 16, 9000, 4
    traj = orbit.make_trajectory(sc.geometry,
                                 orbit.slow_time_grid(n_p / r.prf_hz, n_p))
    p = bp.BpParams(fc_hz=r.fc_hz, chirp_rate=r.chirp_rate, fs_hz=150e6,
                    pulse_width_s=2e-6, num_samples=ns)
    rng = np.random.default_rng(8)
    rc = torch.from_numpy((rng.standard_normal((n_p, ns))
                           + 1j * rng.standard_normal((n_p, ns))
                           ).astype(np.complex64))
    tr = [torch.as_tensor(a) for a in (traj.positions, traj.velocities,
                                       traj.times)]
    vf = torch.tensor([3.0, -2.0, 0.0], dtype=F64)
    t_ref = float(2.0 * np.linalg.norm(traj.positions, axis=1).mean()
                  / 299792458.0)
    return rc, tr, vf, p, t_ref, d, (40, 90)


@pytest.mark.parametrize("ring_offset", [None, 0, 4, 12])
def test_recentres_write_out(ring_offset):
    """With ``out=`` both recentres return ``out`` itself holding what they
    return without it (ring offsets rolled into it)."""
    rc, tr, vf, p, t_ref, d, rows = _recentre_case()
    spec = fft_kernel.forward_spectra(rc, p)
    if ring_offset:
        spec = torch.roll(spec, ring_offset, 0)
    kw = dict(out_rows=rows, ring_offset=ring_offset)
    want = fft_kernel.recentre_from_spectra(spec, *tr, vf, p, d, t_ref, **kw)
    out = torch.full_like(want[0], complex(7.0, 7.0))
    got = fft_kernel.recentre_from_spectra(spec, *tr, vf, p, d, t_ref,
                                           out=out, **kw)
    assert got[0] is out
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if ring_offset is None:
        want = fft_kernel.recenter_presum(rc, *tr, vf, p, d, t_ref,
                                          out_rows=rows)
        out = torch.zeros_like(want[0])
        got = fft_kernel.recenter_presum(rc, *tr, vf, p, d, t_ref,
                                         out_rows=rows, out=out)
        assert got[0] is out
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the trajectory, uploaded once a run
# --------------------------------------------------------------------------

def _tiny(presum=4, duration=1.2):
    """VIDEO_TINY (the harness's CPU size: 128^2 frames over 400 m, nfft
    16,384, PRF 500 Hz, 0.4 s CPIs stepping 100 pulses) for ``duration``
    seconds, presum 4: the pixel-tile kernel takes its 64-sample plan."""
    cfg = json.loads((REPO / "bench_torch" / "configs"
                      / "videosar_spotlight_held.json").read_text())
    cfg["scenario"] = copy.deepcopy(VIDEO_TINY)
    cfg["scenario"]["processing"]["bp_presum"] = presum
    cfg["scenario"]["video"]["duration_s"] = duration
    return cfg


def test_frame_windows_equal_the_per_frame_copies():
    """Each frame's trajectory, a row window of the collect's uploaded
    once, equals the per-frame copy of its slice bit for bit."""
    c = Collect(_tiny(), SEED, CPU, "fast_pallas")
    on = videosar._trajectory_on(c.traj, CPU)
    assert len(c.sched.starts) == 5
    for s in c.sched.starts:
        i0 = int(s)
        got = videosar._window(on, i0, c.sched.cpi_pulses)
        sl = c.traj.slice(i0, i0 + c.sched.cpi_pulses)
        for g, a, whole in zip(got, (sl.positions, sl.velocities, sl.times),
                               on):
            want = torch.as_tensor(np.asarray(a, np.float64))
            assert g.dtype == F64 and torch.equal(g, want)
            assert g.untyped_storage().data_ptr() \
                == whole.untyped_storage().data_ptr()


@pytest.mark.parametrize("mode", ["held", "ring"])
def test_run_uploads_the_trajectory_once(monkeypatch, mode):
    """Every frame's trajectory handed to the formation is a view of one
    upload a run."""
    c = Collect(_tiny(), SEED, CPU, "fast_pallas")
    ship = T.point_target((0.0, 0.0, 0.0), 50.0)
    seen = []
    orig = bp_fast.focus_bp_fast

    def spy(raw, pos, vel, ts, *a, **kw):
        seen.append((pos, vel, ts))
        return orig(raw, pos, vel, ts, *a, **kw)
    monkeypatch.setattr(bp_fast, "focus_bp_fast", spy)
    kw = dict(heading_deg=c.heading, speed_mps=c.speed, device=CPU)
    if mode == "held":
        raw = videosar.record(c.sc, ship, **kw)
        videosar.run(c.sc, ship, raw=raw, bp_backend="fast_pallas", **kw)
    else:
        videosar.run(c.sc, ship, stream_spectra="ring",
                     bp_backend="fast_pallas", noise_mode="per_segment",
                     **kw)
    assert len(seen) == 5
    for k in range(3):
        ptrs = {t[k].untyped_storage().data_ptr() for t in seen}
        assert len(ptrs) == 1, k



@pytest.mark.parametrize("sizes", [(4, 4, 3), (1,), (2, 2, 2, 1)])
def test_gather_is_a_concatenation(sizes):
    rng = np.random.default_rng(4)
    batches = [(rng.standard_normal((b, 3, 2))
                + 1j * rng.standard_normal((b, 3, 2))).astype(np.complex64)
               for b in sizes]
    got = videosar._gather(iter(batches), sum(sizes))
    want = np.concatenate(batches, axis=0)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_a_cpu_frame_is_its_own_host_copy():
    img = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    h = videosar._to_host(img)
    assert h.host is img and h.done is None


# --------------------------------------------------------------------------
# the graph route
# --------------------------------------------------------------------------

def test_cpu_tensors_never_capture():
    c = Collect(_tiny(), SEED, CPU, "fast_pallas")
    ship = T.point_target((0.0, 0.0, 0.0), 50.0)
    assert not bp_fast._graphed(CPU, "pallas")
    with profiling.recording() as rec:
        raw = videosar.record(c.sc, ship, heading_deg=c.heading,
                              speed_mps=c.speed, device=CPU)
        videosar.run(c.sc, ship, heading_deg=c.heading, speed_mps=c.speed,
                     bp_backend="fast_pallas", raw=raw, device=CPU)
    assert "bp.graph_capture" not in rec.counters
    assert "bp.graph_replay" not in rec.counters
    assert not any("bp.capture" in k or "bp.replay" in k
                   for k in rec.tree())


def test_graph_routes():
    assert bp_fast.GRAPH_ACCUMULATE == ("pallas",)
    cuda = torch.device("cuda", 0)
    assert bp_fast._graphed(cuda, "pallas")
    for acc in ("xla", "factor", "factor_pallas", "factor2_pallas",
                "factor_kernel"):
        assert not bp_fast._graphed(cuda, acc), acc


class _Replayed:
    """A stand-in for a captured graph on CPU tensors: a replay runs the
    formation again on the same static inputs into the same output."""

    def __init__(self, form, ins):
        self.form, self.ins = form, ins
        self.out = form(*ins)

    def replay(self):
        self.out.copy_(self.form(*self.ins))


def _stand_in(monkeypatch):
    """The graph route on CPU tensors with :class:`_Replayed` graphs."""
    monkeypatch.setattr(bp_fast, "_graphed",
                        lambda dev, acc: acc in bp_fast.GRAPH_ACCUMULATE)

    def capture(form, ins):
        g = _Replayed(form, ins)
        return g, g.out
    monkeypatch.setattr(bp_fast, "_capture", capture)
    monkeypatch.setattr(bp_fast, "_GRAPHS", collections.OrderedDict())


def _runs(c, ship, mode, raw=None):
    kw = dict(heading_deg=c.heading, speed_mps=c.speed,
              bp_backend="fast_pallas", frames_per_batch=2, device=CPU)
    if mode == "held":
        return videosar.run(c.sc, ship, raw=raw, **kw).images
    return videosar.run(c.sc, ship, stream_spectra="ring", seed=SEED,
                        noise_mode="per_segment", avg_rcs=5000.0,
                        **kw).images


@pytest.mark.parametrize("mode", ["held", "ring"])
def test_graph_route_plumbing_with_a_stand_in_graph(monkeypatch, mode):
    """With a stand-in graph the route gives the eager frames bit for bit:
    each frame's inputs reach the static tensors (the recentre writing the
    static rc2, ring offsets included), each frame is its own tensor, one
    capture for the first ``run`` and none for the second, one replay for
    every other frame, under ``bp.capture`` / ``bp.replay`` in
    ``frame.bp``."""
    c = Collect(_tiny(), SEED, CPU, "fast_pallas")
    ship = T.destroyer()
    raw = (videosar.record(c.sc, ship, heading_deg=c.heading,
                           speed_mps=c.speed, seed=SEED, avg_rcs=5000.0,
                           device=CPU) if mode == "held" else None)
    want = _runs(c, ship, mode, raw)
    _stand_in(monkeypatch)
    n = want.shape[0]
    assert n == 5
    for call in range(2):
        with profiling.recording() as rec:
            got = _runs(c, ship, mode, raw)
        np.testing.assert_array_equal(got, want)
        assert rec.counters.get("bp.graph_capture", 0) == (1 - call)
        assert rec.counters["bp.graph_replay"] == n - 1 + call
        tree = rec.tree()
        fr = "videosar.run/frame/frame.bp"
        assert tree[f"{fr}/bp.replay"][0] == n - 1 + call
        assert tree[f"{fr}/bp.recentre"][0] == n
        if call == 0:
            assert tree[f"{fr}/bp.capture"][0] == 1
            assert tree[f"{fr}/bp.capture/bp.droop"][0] == 2
    assert len(bp_fast._GRAPHS) == 1


def test_frames_held_together_do_not_alias(monkeypatch):
    """Frames replayed back to back and held are each their own tensor,
    equal to their eager frames."""
    c = Collect(_tiny(), SEED, CPU, "fast_pallas")
    rng = np.random.default_rng(3)
    cpi, ns = c.sched.cpi_pulses, c.p.num_samples
    raws = [torch.from_numpy((rng.standard_normal((cpi, ns))
                              + 1j * rng.standard_normal((cpi, ns))
                              ).astype(np.complex64)) for _ in range(3)]
    on = videosar._trajectory_on(c.traj, CPU)
    trajs = [videosar._window(on, int(s), cpi) for s in c.sched.starts[:3]]

    def form(i):
        return bp_fast.focus_bp_fast(raws[i], *trajs[i], c.vf, c.t0, c.p,
                                     presum=c.presum, plan=c.plan,
                                     accumulate="pallas")
    want = [form(i) for i in range(3)]
    _stand_in(monkeypatch)
    form(2)                                            # the capture
    got = [form(0), form(1)]
    assert got[0].data_ptr() != got[1].data_ptr()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_graphs_keep_two_live(monkeypatch):
    monkeypatch.setattr(bp_fast, "_GRAPHS", collections.OrderedDict())
    made = []

    def graph(key):
        return bp_fast._live_graph(key, lambda: made.append(key) or
                                   key.upper())
    for k in "abc":
        assert graph(k) == k.upper()
    assert list(bp_fast._GRAPHS) == ["b", "c"]
    assert graph("b") == "B" and list(bp_fast._GRAPHS) == ["c", "b"]
    graph("d")
    assert list(bp_fast._GRAPHS) == ["b", "d"]
    assert graph("c") == "C" and made == ["a", "b", "c", "d", "c"]


class _Uncounted(_Replayed):
    """:class:`_Replayed` whose replays, like a graph's, leave the kernels'
    launch counters where they were: a replay runs no wrapper."""

    def replay(self):
        n = bp_kernel.accumulate_pallas.launches
        super().replay()
        bp_kernel.accumulate_pallas.launches = n


@pytest.mark.parametrize("mode", ["held", "ring"])
def test_replays_count_the_kernels_they_launch(monkeypatch, mode):
    """The accumulate's launch counter counts one launch a frame: the
    eager first frame's, none for the capture (which records the launch
    and makes none), one for each replay."""
    c = Collect(_tiny(), SEED, CPU, "fast_pallas")
    ship = T.point_target((0.0, 0.0, 0.0), 50.0)
    raw = (videosar.record(c.sc, ship, heading_deg=c.heading,
                           speed_mps=c.speed, device=CPU)
           if mode == "held" else None)
    plain = bp_kernel.accumulate_pallas

    def counted(*a):                   # the wrapper, counting on the CPU
        counted.launches += 1
        return plain(*a)
    counted.launches = 0
    monkeypatch.setattr(bp_kernel, "accumulate_pallas", counted)
    _stand_in(monkeypatch)

    def capture(form, ins):
        g = _Uncounted(form, ins)
        return g, g.out
    monkeypatch.setattr(bp_fast, "_capture", capture)
    for call in range(2):
        with profiling.recording() as rec:
            _runs(c, ship, mode, raw)
        assert rec.counters["bp.graph_replay"] == 4 + call
        assert counted.launches == 5 * (call + 1), call


_CACHED = ("_anchor_tables", "_internal_cols", "_output_rows",
           "_fit_offsets", "_y_axis")


@pytest.mark.parametrize("mode", ["held", "ring"])
def test_a_graph_keeps_the_constants_it_captured(monkeypatch, mode):
    """A graph reads the cached constants by address: after the capture,
    many more keys of every cache free none of the ones it read, and the
    replays still give the eager frames."""
    c = Collect(_tiny(), SEED, CPU, "fast_pallas")
    ship = T.destroyer()
    raw = (videosar.record(c.sc, ship, heading_deg=c.heading,
                           speed_mps=c.speed, seed=SEED, avg_rcs=5000.0,
                           device=CPU) if mode == "held" else None)
    want = _runs(c, ship, mode, raw)
    _stand_in(monkeypatch)
    read = []

    def spy(mod, name):
        fn = getattr(mod, name)

        def get(*a):
            t = fn(*a)
            read.extend(t if isinstance(t, tuple) else (t,))
            return t
        return get
    with monkeypatch.context() as m:
        for name in _CACHED:
            m.setattr(bp_fast, name, spy(bp_fast, name))
        m.setattr(bp, "pixel_grid_on", spy(bp, "pixel_grid_on"))
        _runs(c, ship, mode, raw)                      # the capture
    assert len(bp_fast._GRAPHS) == 1 and len(read) >= 10
    alive = [weakref.ref(t) for t in read]
    del read
    for k in range(40):                     # past every former cache size
        bp_fast._anchor_tables(1000 + k, 8, CPU)
        bp_fast._internal_cols(8 + k, 1.5, CPU)
        bp_fast._output_rows(100.0 + k, 8, CPU)
        bp_fast._fit_offsets(10.0 + k, CPU)
        bp.pixel_grid_on(dataclasses.replace(c.p, nx=8 + k, ny=8), CPU)
    gc.collect()
    assert all(r() is not None for r in alive)
    np.testing.assert_array_equal(_runs(c, ship, mode, raw), want)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


def _eager(monkeypatch):
    monkeypatch.setattr(bp_fast, "_graphed", lambda dev, acc: False)


def _card_runs(c, ship, mode, dev, raw=None):
    kw = dict(heading_deg=c.heading, speed_mps=c.speed,
              bp_backend="fast_pallas", device=dev)
    if mode == "held":
        return videosar.run(c.sc, ship, raw=raw, **kw).images
    return videosar.run(c.sc, ship, stream_spectra="ring", seed=SEED,
                        noise_mode="per_segment", avg_rcs=5000.0,
                        **kw).images


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["held", "ring"])
def test_replayed_frames_equal_eager_frames_on_card(monkeypatch, dev, mode):
    """``videosar.run`` on the card: the held route (recentre + presum)
    and the ring (recentre from spectra, ring offsets) give the eager
    formation's frames bit for bit; a second run captures nothing and
    replays every frame."""
    bp_fast._GRAPHS.clear()
    c = Collect(_tiny(duration=2.0), SEED, dev, "fast_pallas")
    ship = T.destroyer()
    raw = (videosar.record(c.sc, ship, heading_deg=c.heading,
                           speed_mps=c.speed, seed=SEED, avg_rcs=5000.0,
                           device=dev) if mode == "held" else None)
    n = len(c.sched.starts)
    for call in range(2):
        launches = bp_kernel.accumulate_pallas.launches
        with profiling.recording() as rec:
            got = _card_runs(c, ship, mode, dev, raw)
        assert rec.counters.get("bp.graph_capture", 0) == (1 - call)
        assert rec.counters["bp.graph_replay"] == n - 1 + call
        assert bp_kernel.accumulate_pallas.launches - launches == n
    with monkeypatch.context() as m:
        _eager(m)
        with profiling.recording() as rec:
            want = _card_runs(c, ship, mode, dev, raw)
        assert "bp.graph_replay" not in rec.counters
    assert got.shape == (n, 128, 128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_frames_back_to_back_on_card_do_not_alias(monkeypatch, dev):
    """At the held cell's full width (2,500 x 22,004 pulses, presum 4, the
    collect's 64-sample plan): three frames replayed back to back with no
    synchronise and held together equal their eager frames bit for bit."""
    bp_fast._GRAPHS.clear()
    cfg = json.loads((REPO / "bench_torch" / "configs"
                      / "videosar_spotlight_held.json").read_text())
    c = Collect(cfg, SEED, dev, "fast_pallas")
    cpi, ns = c.sched.cpi_pulses, c.p.num_samples
    assert (cpi, ns, c.presum) == (2500, 22004, 4)
    gen = torch.Generator(device=dev).manual_seed(5)
    raw = torch.empty((cpi + 4 * c.sched.step_pulses, ns),
                      dtype=torch.complex64, device=dev)
    torch.view_as_real(raw).normal_(generator=gen)
    on = videosar._trajectory_on(c.traj, dev)
    starts = [int(s) for s in c.sched.starts[:5]]

    def form(i):
        s = starts[i]
        return bp_fast.focus_bp_fast(raw[s - starts[0]:s - starts[0] + cpi],
                                     *videosar._window(on, s, cpi), c.vf,
                                     c.t0, c.p, presum=c.presum, plan=c.plan,
                                     accumulate="pallas")
    with profiling.recording() as rec:
        form(4)                                        # the capture
        got = [form(i) for i in range(4)]
    assert rec.counters == {"bp.graph_capture": 1, "bp.graph_replay": 4}
    assert len({g.data_ptr() for g in got}) == 4
    with monkeypatch.context() as m:
        _eager(m)
        want = [form(i) for i in range(4)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i


@pytest.mark.cuda
def test_frames_reach_the_host_through_pinned_copies(dev):
    """``_to_host`` enqueues the copy into pinned memory behind the work
    and records an event after it: once the event is done the host holds
    the frames bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(9)
    img = torch.empty((4, 512, 512), dtype=torch.complex64, device=dev)
    torch.view_as_real(img).normal_(generator=gen)
    h = videosar._to_host(img * 2)
    assert h.host.is_pinned() and h.host.device.type == "cpu"
    h.done.synchronize()
    np.testing.assert_array_equal(h.host.numpy(), (img * 2).cpu().numpy())
