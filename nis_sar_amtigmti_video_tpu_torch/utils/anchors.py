"""Slow-time anchor interpolation layout (fast-BP fits and output
remodulation).

Counterpart of ``nis_sar_amtigmti_video_tpu/utils/anchors.py``, copied: the
geometry fields (delay, phase, sample index) are smooth in slow time, so
exact float64 evaluation at anchor rows every ``h`` pulses plus quadratic
Lagrange interpolation on the uniform {0, h, 2h} nodes reproduces them to
~1e-5 rad / ~1e-6 samples at the reference geometries.
"""

from __future__ import annotations

import numpy as np


def anchor_plan(num_p: int, h: int):
    """Static (host) anchor layout: per-pulse window starts, needed anchor
    indices, per-pulse anchor row triples into the needed list, and the
    per-pulse quadratic Lagrange weights on the uniform {0, h, 2h} nodes.
    Windows near the tail shift back so all three nodes stay in range.

    Returns (needed (Na,), trip (num_p, 3), w (num_p, 3) f64).
    """
    n_grp = -(-num_p // h)
    starts = [min(j * h, max(0, num_p - 1 - 2 * h)) for j in range(n_grp)]
    needed = sorted({s + k * h for s in starts for k in (0, 1, 2)})
    row = {ix: i for i, ix in enumerate(needed)}
    trip = np.asarray([[row[s], row[s + h], row[s + 2 * h]] for s in starts])
    t_idx = np.arange(num_p)
    r = (t_idx - np.asarray(starts)[t_idx // h]).astype(np.float64)
    w = np.stack([(r - h) * (r - 2 * h) / (2.0 * h * h),
                  r * (2 * h - r) / (h * h),
                  r * (r - h) / (2.0 * h * h)], axis=1)       # (P, 3)
    return (np.asarray(needed), trip[t_idx // h], w)
