"""Single-channel stripmap pipeline.

Counterpart of ``nis_sar_amtigmti_video_tpu/models/stripmap.py``. Only the
scenario -> echo-options rule is ported so far (the GMTI pipeline and the
HRWS benchmark's collects need it; the multichannel stripmap chain itself,
reconstruction then CSA, is ``models/hrws.py``). Still to come:
``StripmapProducts``, ``simulate_raw`` and the CSA branch of ``run``, whose
parts are ported (``ops/echo.py``, ``ops/noise.py``,
``ops/csa.py::focus_csa``); then the RDA branch, which waits for
``ops/rda.py``, ``ops/windows.py`` and the non-uniform interpolation.
"""

from __future__ import annotations

from nis_sar_amtigmti_video_tpu_torch.config import ScenarioConfig
from nis_sar_amtigmti_video_tpu_torch.ops.echo import EchoOpts


def echo_opts_for(sc: ScenarioConfig) -> EchoOpts:
    r, c = sc.radar, sc.collect
    return EchoOpts(
        fc_hz=r.fc_hz, chirp_rate=r.chirp_rate, pulse_width_s=r.pulse_width_s,
        fs_hz=r.fs_hz, num_samples=c.num_samples(r.fs_hz),
        endpoint_grid=(c.window_start_mode == "reference"),
        chirp_centering="leading", amplitude="sqrt_rcs",
        backend=c.echo_backend, freq_oversample=c.echo_oversample)
