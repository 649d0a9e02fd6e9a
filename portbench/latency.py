"""Propose-to-commit latency of every proposal of the window, resolved
after it from what the loop recorded: each leader's commit watermark
after every round (``hist``, [T, G]) and each round's end on the host's
clock (``ends``, seconds from the window's start).

A group's proposals are appended in the order they were offered, so
proposal n of group g (n = 1, 2, ...) is log index base[g] + n, and it
is committed at the end of the first round whose commit covers that
index. It was

* closed loop, with C clients a group: submitted when the write of the
  client before it committed, that is at the commit of proposal n - C
  (the first C at the loop's start);
* open loop: due at its arrival time in the schedule.

The window's proposals are those submitted (or due) in [0, seconds);
one not committed by the end of the drain has failed. The percentiles
come from a histogram over all of them with bins 0.1% wide (a value is
read at its bin's geometric middle, within 0.05%).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

RATIO = 1.001
LOW_MS = 1e-3
BINS = int(math.ceil(math.log(1e7 / LOW_MS) / math.log(RATIO)))


class Histogram:
    def __init__(self, device) -> None:
        self.counts = torch.zeros((BINS,), dtype=torch.int64, device=device)

    def add(self, seconds: torch.Tensor) -> None:
        ms = seconds.to(torch.float64) * 1e3
        idx = torch.floor(torch.log(ms.clamp(min=LOW_MS) / LOW_MS)
                          / math.log(RATIO)).long().clamp_(0, BINS - 1)
        self.counts += torch.bincount(idx, minlength=BINS)

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def quantile_ms(self, q: float) -> Optional[float]:
        """The q-quantile in ms: the value of rank ceil(q * total)."""
        total = self.total
        if total == 0:
            return None
        rank = max(1, math.ceil(q * total))
        cum = torch.cumsum(self.counts, 0)
        j = int(torch.searchsorted(cum, torch.tensor(
            [rank], dtype=torch.int64, device=cum.device))[0])
        return LOW_MS * RATIO ** (j + 0.5)


def _group_rows(hist_blocks: List[torch.Tensor], rounds: int, lo: int,
                hi: int) -> torch.Tensor:
    """Groups lo..hi's commit watermarks, [hi - lo, rounds], contiguous."""
    h = torch.cat([b[:, lo:hi] for b in hist_blocks])[:rounds]
    return h.t().contiguous()


class Result:
    def __init__(self, device) -> None:
        self.hist = Histogram(device)
        self.attempted = 0
        self.failed = 0
        self.lag = Histogram(device)


def resolve(hist_blocks, rounds: int, base: torch.Tensor, ends: torch.Tensor,
            seconds: float, *, clients: int = 0, loop_start: float = 0.0,
            due: Optional[torch.Tensor] = None,
            handed: Optional[torch.Tensor] = None,
            lag_skip: Optional[List[tuple]] = None,
            chunk: int = 4096) -> Result:
    """Latencies of the window's proposals (module docstring): a closed
    loop with `clients` a group that started at `loop_start`, or an
    open loop with the schedule `due` [G, K] (+inf pads), whose
    arrivals were handed over at the round offers `handed` [T] (float32
    seconds, as the device compared them); the hand-over lag leaves out
    arrivals due inside any (start, end) of `lag_skip`."""
    dev = base.device
    out = Result(dev)
    g = base.numel()
    ends_x = torch.cat([ends.to(dev, torch.float64),
                        torch.tensor([math.inf], dtype=torch.float64,
                                     device=dev)])
    for lo in range(0, g, chunk):
        hi = min(g, lo + chunk)
        h = _group_rows(hist_blocks, rounds, lo, hi)
        b = base[lo:hi].view(-1, 1)
        if due is None:
            n_max = int((h[:, -1:] - b).max()) + clients
            n = torch.arange(1, n_max + 1, dtype=torch.int32, device=dev)
            c = torch.searchsorted(h, b + n)
            done = ends_x[c]
            sub = torch.full(c.shape, loop_start, dtype=torch.float64,
                             device=dev)
            sub[:, clients:] = done[:, :n_max - clients]
        else:
            d = due[lo:hi]
            n = torch.arange(1, d.shape[1] + 1, dtype=torch.int32,
                             device=dev)
            c = torch.searchsorted(h, b + n)
            done = ends_x[c]
            sub = d.to(torch.float64)
            arrived = d[torch.isfinite(d)]
            for lo_t, hi_t in lag_skip or ():
                arrived = arrived[(arrived < lo_t) | (arrived > hi_t)]
            late = torch.searchsorted(handed, arrived)
            out.lag.add(handed.to(torch.float64)[late]
                        - arrived.to(torch.float64))
        window = (sub >= 0) & (sub < seconds)
        ok = window & (c < rounds)
        out.attempted += int(window.sum())
        out.failed += int((window & (c >= rounds)).sum())
        out.hist.add((done - sub)[ok])
    return out


def committed_in_window(hist_blocks, rounds: int, ends: torch.Tensor,
                        seconds: float, start: torch.Tensor) -> int:
    """Entries committed on their leaders between the window's start
    and its end: the commit watermarks of the last round to end before
    each, summed over the groups (`start`: the watermarks before the
    first recorded round)."""
    ends = ends.cpu()

    def at(t: float) -> torch.Tensor:
        i = int(torch.searchsorted(ends, torch.tensor([t], dtype=ends.dtype))) - 1
        if i < 0:
            return start.to(torch.int64)
        return hist_blocks[i // hist_blocks[0].shape[0]][
            i % hist_blocks[0].shape[0]].to(torch.int64)
    return int((at(seconds) - at(0.0)).sum())
