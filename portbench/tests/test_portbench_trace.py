"""The traced stretch's reduction on a made-up trace: rounds are graph
launches, the first after the opening sync left out, busy time is the
union of device operations inside the window, and a session with a
graph launch but none of its kernels fails the run."""

import pytest

from portbench.trace import Stretch


def _runtime(name, ts, corr, dur=2.0):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": dur, "args": {"correlation": corr}}


def _op(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _trace(rounds=3, drop=None):
    events, t = [], 0.0
    for r in range(rounds):
        corr = 100 + r
        events.append(_runtime("cudaGraphLaunch", t, corr))
        events.append(_runtime("cudaLaunchKernel", t + 3, 900 + r))
        events.append(_op("driver_op", t + 5, 1.0, 900 + r))
        k0 = t + 10
        if r != drop:
            events.append(_op("deliver_kernel", k0, 40.0, corr))
            events.append(_op("term_at_batch_kernel<1,32>", k0 + 42, 4.0,
                              corr))
            events.append(_op("quorum_commit_vote_kernel<3>", k0 + 48, 2.0,
                              corr))
        t += 100.0
    return events


def test_rounds_busy_and_idle():
    s = Stretch(_trace())
    assert s.rounds == 2
    assert s.kernels_per_round() == 3
    assert s.round_device_ms() == pytest.approx(46e-3)
    assert s.hopper_us() == pytest.approx(12.0)
    # Window: round 1's first kernel (t=110) to round 2's last (t=260);
    # busy: 2 x 46 us of kernels and round 2's own op of the loop.
    assert s.window_us == pytest.approx(150.0)
    assert s.busy_us == pytest.approx(93.0)
    assert s.idle_pct() == pytest.approx(100 * (1 - 93 / 150))
    b = s.breakdown()
    assert b["device_ops"][0][0] == "deliver_kernel"
    assert len(b["idle_gaps"]) <= 10 and b["idle_gaps"][0][1] > 0


@pytest.mark.parametrize("drop", [0, 2])
def test_a_short_session_fails(drop):
    with pytest.raises(RuntimeError, match="short"):
        Stretch(_trace(drop=drop))


def test_an_empty_session_fails():
    with pytest.raises(RuntimeError):
        Stretch([])


def test_launches_of_one_graph_with_fewer_kernels_fail():
    events = _trace(rounds=4)
    # Round 2 loses one of its kernels' records.
    events = [e for e in events if not (
        e.get("cat") == "kernel" and e["args"]["correlation"] == 102
        and e["name"].startswith("quorum"))]
    with pytest.raises(RuntimeError, match="short"):
        Stretch(events, ticks=[True, False, False, True])
    # The round's graphs with and without a tick launch the same
    # kernels: a lost record fails the stretch whatever the ticks.
    with pytest.raises(RuntimeError, match="short"):
        Stretch(events, ticks=[True, True, False, True])


def test_a_session_with_no_timestamps_fails():
    events = _trace()
    for e in events:
        if e["cat"] == "kernel":
            e["ts"], e["dur"] = 0.0, 0.0
    with pytest.raises(RuntimeError, match="missing"):
        Stretch(events)
