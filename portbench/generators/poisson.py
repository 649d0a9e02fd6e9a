"""An open loop: a Poisson process of ``rate_per_s`` entries a second
over the whole store, each arrival on a group drawn uniformly. The
schedule of due times is made from the seed before the window ([G, K]
on the device, one row a group, +inf past the window), and before each
round every leader is offered the arrivals due by the host's clock that
it has not accepted yet."""

from __future__ import annotations

import math

import torch

PARAMS = ("rate_per_s",)


class Generator:
    loaded_warm_up = False  # warm-up rounds run unloaded
    clients = 0

    def __init__(self, params: dict, groups: int, seconds: float, gen,
                 device, chunk: int = 8192) -> None:
        rate = float(params["rate_per_s"])
        if not rate > 0:
            raise ValueError("rate_per_s must be > 0")
        lam = rate / groups
        mean = lam * seconds
        k = int(math.ceil(mean + 10 * math.sqrt(mean) + 16))
        self.due = torch.empty((groups, k), dtype=torch.float32,
                               device=device)
        for lo in range(0, groups, chunk):
            gaps = torch.empty((min(chunk, groups - lo), k),
                               dtype=torch.float64, device=device)
            gaps.exponential_(lam, generator=gen)
            due = gaps.cumsum_(1)
            if bool((due[:, -1] < seconds).any()):
                raise RuntimeError("the arrival schedule is too short")
            due.masked_fill_(due >= seconds, math.inf)
            self.due[lo:lo + chunk].copy_(due)
        self.arrived = torch.zeros((groups, 1), dtype=torch.int64,
                                   device=device)
        self._now = torch.zeros((groups, 1), dtype=torch.float32,
                                device=device)

    def offer(self, drv, i: int, now: float) -> None:
        """Hand over the arrivals due by `now` (seconds from the
        window's start, in the round's slot of drv.now_dev)."""
        self._now.fill_(drv.now_dev.row(i))
        torch.searchsorted(self.due, self._now, right=True,
                           out=self.arrived)
        accepted = drv.lead_last - drv.base
        drv.props_lead.copy_((self.arrived.view(-1) - accepted).clamp_(min=0))
