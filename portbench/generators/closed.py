"""A closed loop: ``clients_per_group`` clients a group, each with one
write outstanding, resubmitting as soon as it commits (etcd's benchmark
tool with ``--clients``). It runs on the device: before each round every
leader is offered ``clients - (last - commit)``, the writes that are
neither in its log nor committed."""

from __future__ import annotations

import torch

PARAMS = ("clients_per_group",)


class Generator:
    loaded_warm_up = True  # warm-up rounds run under this load
    due = None  # no schedule: a write is submitted when the one before commits

    def __init__(self, params: dict, groups: int, seconds: float, gen,
                 device) -> None:
        self.clients = int(params["clients_per_group"])
        if self.clients < 1:
            raise ValueError("clients_per_group must be >= 1")

    def offer(self, drv, i: int, now: float) -> None:
        out = drv.props_lead
        torch.sub(drv.lead_last, drv.lead_commit, out=out)
        torch.sub(self.clients, out, out=out)
        out.clamp_(min=0)
