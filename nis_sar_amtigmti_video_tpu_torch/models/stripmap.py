"""Single-channel stripmap pipeline.

Counterpart of ``nis_sar_amtigmti_video_tpu/models/stripmap.py``. Only the
scenario -> echo-options rule is ported so far (the GMTI pipeline needs it);
``simulate_raw`` and ``run`` wait for the noise and RDA ports.
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
        backend=c.echo_backend)
