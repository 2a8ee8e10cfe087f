"""Point-scatterer target models, vectorized to arrays.

Re-designs the reference's dict-list factories (``vehicle_targets.py:3-141``)
as a single :class:`PointTargets` array container — (N,3) float64 positions +
(N,) float64 RCS — which is what the vmapped echo engine consumes directly.
The point layouts and RCS values reproduce the reference models exactly so
golden tests see identical scenes.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class PointTargets(NamedTuple):
    """A rigid cluster of point scatterers (host-side, float64)."""

    positions: np.ndarray   # (N, 3) [m]
    rcs: np.ndarray         # (N,)   [m^2]
    names: tuple            # (N,) labels

    @property
    def num(self) -> int:
        return self.positions.shape[0]

    def translate(self, offset: Sequence[float]) -> "PointTargets":
        return self._replace(positions=self.positions + np.asarray(offset, np.float64))

    def rotate_z(self, angle_deg: float) -> "PointTargets":
        """Rotate the cluster about +Z (heading), as the reference's
        ``rotate_points`` (sar_satellite_sim.py:186-192)."""
        th = np.radians(angle_deg)
        c, s = np.cos(th), np.sin(th)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        return self._replace(positions=self.positions @ rot.T)

    def scale_rcs(self, factor: float) -> "PointTargets":
        return self._replace(rcs=self.rcs * factor)

    @property
    def total_rcs(self) -> float:
        return float(self.rcs.sum())

    @staticmethod
    def concatenate(parts: Sequence["PointTargets"]) -> "PointTargets":
        return PointTargets(
            positions=np.concatenate([p.positions for p in parts], axis=0),
            rcs=np.concatenate([p.rcs for p in parts], axis=0),
            names=tuple(n for p in parts for n in p.names),
        )


def _make(points, rcs, names, center) -> PointTargets:
    pos = np.asarray(points, np.float64) + np.asarray(center, np.float64)
    rcs = np.broadcast_to(np.asarray(rcs, np.float64), (pos.shape[0],)).copy()
    return PointTargets(pos, rcs, tuple(names))


def car(center=(0.0, 0.0, 0.0)) -> PointTargets:
    """12-point sedan, ~1 m^2 per point (vehicle_targets.py:6-41)."""
    l, w = 4.5, 1.8
    lr, wr = 2.0, 1.4
    pts = (
        # chassis corners at z=0.5
        [(l / 2, w / 2, 0.5), (l / 2, -w / 2, 0.5),
         (-l / 2, w / 2, 0.5), (-l / 2, -w / 2, 0.5)]
        # roof corners at z=1.4
        + [(lr / 2, wr / 2, 1.4), (lr / 2, -wr / 2, 1.4),
           (-lr / 2, wr / 2, 1.4), (-lr / 2, -wr / 2, 1.4)]
        # bumpers
        + [(l / 2, 0.0, 0.4), (-l / 2, 0.0, 0.4)]
        # door mid-points
        + [(0.0, w / 2, 0.9), (0.0, -w / 2, 0.9)]
    )
    return _make(pts, 1.0, [f"car_pt{i}" for i in range(len(pts))], center)


def tank(center=(0.0, 0.0, 0.0)) -> PointTargets:
    """18-point MBT, 5 m^2 per point (vehicle_targets.py:43-73)."""
    l, w, h = 8.0, 3.6, 1.5
    tr, zt = 1.5, 2.3
    pts = (
        [(l / 2, w / 2, h), (l / 2, -w / 2, h), (-l / 2, w / 2, h), (-l / 2, -w / 2, h),
         (l / 2, w / 2, 0.5), (l / 2, -w / 2, 0.5), (-l / 2, w / 2, 0.5), (-l / 2, -w / 2, 0.5)]
        + [(0.0, 0.0, zt),
           (tr, 0.0, zt - 0.3), (-tr, 0.0, zt - 0.3),
           (0.0, tr, zt - 0.3), (0.0, -tr, zt - 0.3)]
        + [(l / 2 + 1.0, 0.0, zt - 0.5), (l / 2 + 3.0, 0.0, zt - 0.5), (l / 2 + 5.0, 0.0, zt - 0.5)]
        + [(0.0, w / 2, 1.0), (0.0, -w / 2, 1.0)]
    )
    return _make(pts, 5.0, [f"tank_pt{i}" for i in range(len(pts))], center)


def fighter_jet(center=(0.0, 0.0, 0.0), rcs_scale: float = 1.0) -> PointTargets:
    """13-point 4th-gen fighter, 10*scale m^2 per point (vehicle_targets.py:75-97)."""
    pts = (
        [(7.5, 0.0, 0.0), (5.0, 0.0, 1.0), (-6.0, 0.0, 1.0),
         (-7.0, 0.0, 0.5), (-6.0, 0.0, 2.5)]
        + [(0.0, 2.0, 0.0), (0.0, -2.0, 0.0), (-3.0, 5.0, 0.0), (-3.0, -5.0, 0.0),
           (-4.0, 2.5, 0.0), (-4.0, -2.5, 0.0)]
        + [(-6.5, 2.0, 0.0), (-6.5, -2.0, 0.0)]
    )
    return _make(pts, 10.0 * rcs_scale, [f"jet_pt{i}" for i in range(len(pts))], center)


def f35(center=(0.0, 0.0, 0.0)) -> PointTargets:
    """Stealth variant: fighter geometry at 1% RCS (vehicle_targets.py:99-100)."""
    return fighter_jet(center, rcs_scale=0.01)


def airliner(center=(0.0, 0.0, 0.0)) -> PointTargets:
    """15-point wide-body airliner (Boeing 787-8 class: 57 m fuselage,
    60 m span, 17 m tail).

    The reference places a 787-8 FBX visually (sar_scene_data.py:82-90)
    but has no airliner entry in vehicle_targets.py; this layout gives the
    placement a dedicated scatterer model: a fuselage tube line, swept
    wing line with engine nacelles, and the empennage. RCS is
    airliner-class — 40 m^2 per airframe point with 120 m^2 engine
    nacelles (inlet cavities dominate a civil airliner's return), ~760
    m^2 total, sitting between the fighter (130 m^2) and the ships."""
    pts = (
        # fuselage tube: nose, cockpit, three barrel sections, tailcone
        [(28.0, 0.0, 2.5), (24.0, 0.0, 3.5), (14.0, 0.0, 3.0),
         (0.0, 0.0, 3.0), (-14.0, 0.0, 3.0), (-27.0, 0.0, 4.0)]
        # empennage: vertical stabilizer top + horizontal stabilizer tips
        + [(-26.0, 0.0, 16.0), (-26.0, 11.0, 5.0), (-26.0, -11.0, 5.0)]
        # swept wing line: root, engine station, tip (both sides)
        + [(2.0, 3.0, 2.5), (2.0, -3.0, 2.5),
           (4.0, 9.0, 1.0), (4.0, -9.0, 1.0),
           (-8.0, 30.0, 4.0), (-8.0, -30.0, 4.0)]
    )
    rcs = [40.0] * 11 + [120.0, 120.0] + [40.0, 40.0]
    names = ([f"airliner_fus{i}" for i in range(6)]
             + ["airliner_vstab", "airliner_hstab_r", "airliner_hstab_l"]
             + ["airliner_wingroot_r", "airliner_wingroot_l",
                "airliner_engine_r", "airliner_engine_l",
                "airliner_wingtip_r", "airliner_wingtip_l"])
    out = _make(pts, 1.0, names, center)
    return out._replace(rcs=np.asarray(rcs, np.float64))


def destroyer(center=(0.0, 0.0, 0.0)) -> PointTargets:
    """35-point Arleigh-Burke-class destroyer, ~50k m^2 total
    (vehicle_targets.py:102-141): 5x3 hull grid at two heights (1000 m^2 each)
    plus bridge/mast/stack/bow/stern corner reflectors."""
    length, width = 154.0, 20.0
    xs = np.linspace(-length / 2, length / 2, 5)
    ys = np.linspace(-width / 2, width / 2, 3)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    hull = np.stack([gx.ravel(), gy.ravel()], axis=1)  # (15, 2), x-major like the loop

    pts, rcs, names = [], [], []
    for x, y in hull:
        pts.append((x, y, 1.0)); rcs.append(1000.0); names.append("destroyer_hull")
        pts.append((x, y, 6.0)); rcs.append(1000.0); names.append("destroyer_deck")
    specials = [
        ((length * 0.2, 0.0, 15.0), 5000.0, "destroyer_bridge"),
        ((length * 0.1, 0.0, 25.0), 3000.0, "destroyer_mast"),
        ((-length * 0.1, 0.0, 12.0), 3000.0, "destroyer_stack"),
        ((length / 2 + 10.0, 0.0, 6.0), 1000.0, "destroyer_bow"),
        ((-length / 2 - 5.0, 0.0, 6.0), 1000.0, "destroyer_stern"),
    ]
    for p, r, n in specials:
        pts.append(p); rcs.append(r); names.append(n)
    out = _make(pts, 1.0, names, center)
    return out._replace(rcs=np.asarray(rcs, np.float64))


def point_target(position=(0.0, 0.0, 0.0), rcs: float = 1.0,
                 name: str = "pt") -> PointTargets:
    """A single ideal scatterer — the impulse-response test target."""
    return _make([tuple(0.0 for _ in range(3))], rcs, [name], position)


VEHICLES = {
    "car": car,
    "tank": tank,
    "fighter_jet": fighter_jet,
    "f35": f35,
    "airliner": airliner,
    "destroyer": destroyer,
}
