"""The two-channel CPI stream of kinds/gmti_cpi.py with two CPIs in flight:
the same set-up, held raws, route and check, but product i first issues
CPI i + 1's models/gmti.py::focus_and_products and only then waits for
CPI i's served result (its calibration phase, cancellation ratio and CFAR
detection count, copied to pinned host memory behind an event when CPI i
was issued). The host's work on CPI i + 1 so runs while the card finishes
CPI i, as a server that queues the next CPI while the last one's products
are read out.

When the window closes, one CPI issued past its end is still in flight;
a traced window waits for it, so its launches count in
``launches_per_product`` (one CPI more over the products served)."""

from __future__ import annotations

import time

import torch

from bench_torch import core
from bench_torch.kinds import gmti_cpi


class Products(gmti_cpi.Products):
    def __init__(self, cfg, traffic, seed, device, trace=False):
        t = time.perf_counter()
        super().__init__(cfg, traffic, seed, device, trace)
        core.log(f"set-up: the CPI stream's inputs "
                 f"{time.perf_counter() - t:.3f} s")
        self._next = None       # the CPI in flight: (i, k, host, event, p)

    def _issue(self, i: int):
        """Issue CPI i; its served numbers reach the host behind an
        event."""
        k = i % len(self.raws)
        p = self._one(k)
        vals = torch.stack([p.cal_phase.reshape(()).float(),
                            p.cancellation_ratio.reshape(()).float(),
                            p.detections.detections.sum().float()])
        if self.dev.type != "cuda":
            return i, k, vals, None, p
        host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
        host.copy_(vals, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return i, k, host, ev, p

    @staticmethod
    def _served(cpi):
        _, _, host, ev, _ = cpi
        if ev is not None:
            ev.synchronize()
        return host.clone()

    def warm(self):
        t = time.perf_counter()
        super().warm()
        self._served(self._issue(0))     # the pinned route's first use
        core.log(f"set-up: warm products {time.perf_counter() - t:.3f} s")

    def product(self, i: int):
        cur = self._next
        if cur is None or cur[0] != i:
            cur = self._issue(i)
        self._next = self._issue(i + 1)
        served = self._served(cur)
        _, k, _, _, p = cur
        self.sample.offer(i, lambda: (k, served, dict(
            slc1=p.slc1, slc2=p.slc2, ati_phase=p.ati_phase,
            dpca_mag=p.dpca_mag, snr=p.detections.snr)))
        return served

    def release(self):
        self._next = None
        super().release()


def setup(cfg, traffic, seed, device, trace=False):
    return Products(cfg, traffic, seed, device, trace)
