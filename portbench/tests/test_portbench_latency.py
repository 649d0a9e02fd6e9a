"""The latency resolution matches a loop over every proposal on a small
recorded history."""

import math

import pytest
import torch

from portbench import latency
from portbench.loop import CHUNK


def _history(g, t, seed):
    gen = torch.Generator().manual_seed(seed)
    steps = torch.randint(0, 4, (t, g), generator=gen, dtype=torch.int32)
    steps[torch.rand((t, g), generator=gen) < 0.2] = 0
    base = torch.randint(5, 50, (g,), generator=gen, dtype=torch.int32)
    hist = base + steps.cumsum(0, dtype=torch.int32)
    ends = torch.cumsum(0.004 + 0.01 * torch.rand(t, generator=gen,
                                                  dtype=torch.float64), 0)
    return hist, base, ends - 0.2


def _blocks(hist):
    t, g = hist.shape
    pad = torch.zeros((CHUNK * math.ceil(t / CHUNK), g), dtype=hist.dtype)
    pad[:t] = hist
    return list(pad.split(CHUNK))


def _first(hist, g, index):
    for i in range(hist.shape[0]):
        if hist[i, g] >= index:
            return i
    return None


def _quantile(values, q):
    s = sorted(values)
    return s[max(1, math.ceil(q * len(s))) - 1]


def _compare(res, lats, attempted, failed):
    assert res.attempted == attempted and res.failed == failed
    for q in (0.5, 0.9, 0.99):
        want = _quantile(lats, q) * 1e3
        assert res.hist.quantile_ms(q) == pytest.approx(want, rel=1e-3)


@pytest.mark.parametrize("seed", [1, 2])
def test_closed_loop_matches_a_loop_over_proposals(seed):
    hist, base, ends = _history(5, 300, seed)
    clients, seconds, start = 3, 1.5, -0.25
    res = latency.resolve(_blocks(hist), 300, base, ends, seconds,
                          clients=clients, loop_start=start, chunk=2)
    lats, attempted, failed = [], 0, 0
    for g in range(5):
        done = {}
        top = int(hist[-1, g] - base[g]) + clients
        for n in range(1, top + 1):
            c = _first(hist, g, int(base[g]) + n)
            done[n] = None if c is None else float(ends[c])
            sub = start if n <= clients else done[n - clients]
            if sub is None or not 0 <= sub < seconds:
                continue
            attempted += 1
            if done[n] is None:
                failed += 1
            else:
                lats.append(done[n] - sub)
    _compare(res, lats, attempted, failed)


@pytest.mark.parametrize("seed", [3, 4])
def test_open_loop_matches_a_loop_over_arrivals(seed):
    _, base, ends = _history(4, 300, seed)
    gen = torch.Generator().manual_seed(seed)
    seconds = 1.2
    due = torch.sort(torch.rand((4, 400), generator=gen) * 2.0).values
    due[due >= seconds] = math.inf
    # Each round commits what arrived by the end of a round 1-3 back,
    # all but a few of the last.
    lag = torch.randint(1, 4, (300,), generator=gen)
    back = (torch.arange(300) - lag).clamp(min=0)
    seen = (due.unsqueeze(0) <= ends[back].view(-1, 1, 1)).sum(-1)
    seen = seen.clamp(max=int(torch.isfinite(due).sum(1).min()) - 2)
    hist = (base + seen.cummax(0).values).to(torch.int32)
    handed = (ends - 0.003).to(torch.float32)
    res = latency.resolve(_blocks(hist), 300, base, ends, seconds, due=due,
                          handed=handed, chunk=3)
    lats, lags, attempted, failed = [], [], 0, 0
    for g in range(4):
        for k in range(due.shape[1]):
            d = float(due[g, k])
            if not math.isfinite(d):
                continue
            attempted += 1
            lags.append(min(float(h) for h in handed if h >= due[g, k]) - d)
            c = _first(hist, g, int(base[g]) + k + 1)
            if c is None:
                failed += 1
            else:
                lats.append(float(ends[c]) - d)
    _compare(res, lats, attempted, failed)
    assert res.lag.quantile_ms(0.99) == pytest.approx(
        _quantile(lags, 0.99) * 1e3, rel=1e-3)


def test_committed_in_window_counts_watermarks_between_the_ends():
    hist, base, ends = _history(3, 100, 5)
    got = latency.committed_in_window(_blocks(hist), 100, ends, 0.5, base)
    before = int((ends < 0).sum()) - 1
    last = int((ends < 0.5).sum()) - 1
    want = int((hist[last].long() - hist[before].long()).sum())
    assert got == want
