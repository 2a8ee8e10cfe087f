"""A configuration file's scenario as the port's ScenarioConfig: the named
preset of ``nis_sar_amtigmti_video_tpu_torch.config`` with the file's
overrides, and the (pulses, samples) of a CPI cut to size."""

from __future__ import annotations

import dataclasses


def build(cfg: dict):
    """The ScenarioConfig of ``cfg['scenario']``: ``preset`` (a function of
    the port's config module), then its ``radar``, ``collect``,
    ``processing`` and ``video`` overrides, then ``pulses`` / ``samples``,
    reached by nudging the integration time and the window length until
    float rounding gives exactly that raw shape."""
    from nis_sar_amtigmti_video_tpu_torch import config
    s = cfg["scenario"]
    sc = getattr(config, s["preset"])()
    for part in ("radar", "collect", "processing", "video"):
        if s.get(part):
            sc = sc.replace(**{part: dataclasses.replace(getattr(sc, part),
                                                         **s[part])})
    if "pulses" in s:
        sc = _cut(sc, s["pulses"], s["samples"])
    return sc


def _cut(sc, n_pulses: int, n_samples: int):
    prf, fs = sc.radar.prf_hz, sc.radar.fs_hz
    t_int, win = n_pulses / prf, n_samples / fs
    for _ in range(8):
        collect = dataclasses.replace(sc.collect, integration_time_s=t_int,
                                      window_length_s=win)
        got = (collect.num_pulses(prf), collect.num_samples(fs))
        if got == (n_pulses, n_samples):
            return sc.replace(collect=collect)
        t_int *= 1 - 1e-12 if got[0] > n_pulses else 1 + 1e-12
        win *= 1 + 1e-12 if got[1] < n_samples else 1 - 1e-12
    raise RuntimeError(f"cannot reach {(n_pulses, n_samples)}: got {got}")
