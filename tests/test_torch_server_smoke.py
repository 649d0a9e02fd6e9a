"""chip_smoke's server phases, rehearsed on the CPU.

``run_server`` at 40 puts through 8 connections (the card's checks: every
acked put read back on every member, the oracle's KV on each, hash_check,
the watch against the acked puts, the lease kept alive and the one left
to expire, ErrCompacted through the client, the contended lock, a
follower restarted on its WAL, a MsgSnap catch-up on the small cluster,
and each kernel form held against its plain version), with the CPU
wrappers counting their plain calls as launches; and ``run_server_parity``
with both clusters on the CPU. ``nvidia-smi`` is stubbed.
"""

import torch

import chip_smoke
from etcd_tpu_torch.batched import hopper_kernels as hk


def _counting(monkeypatch):
    monkeypatch.setattr(chip_smoke, "smi", lambda _q: "cpu")
    for fn, name in (("quorum_commit", "quorum_commit_vote"),
                     ("quorum_vote", "quorum_commit_vote"),
                     ("term_at_batch", "term_at_batch")):
        def counted(*a, _f=getattr(hk, fn), _n=name, **kw):
            hk.LAUNCHES[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(hk, fn, counted)


def test_server_phase_on_the_cpu(monkeypatch):
    _counting(monkeypatch)
    # Snapshots every 20 entries from the 80th, each keeping 60 below
    # the applied index: the follower restarts from one, as at full size.
    out = chip_smoke.run_server(torch.device("cpu"), puts=40, clients=8,
                                ranges=24, snap_puts=40, snapshots=(80, 60))
    assert out["rounds"] > 0
    assert all(v > 0 for v in out["launches"].values()), out["launches"]
    # The spies are gone: the wrappers are the counting ones again.
    assert hk.term_at_batch.__name__ == "counted"


def test_server_parity_phase_on_the_cpu(monkeypatch):
    _counting(monkeypatch)
    chip_smoke.run_server_parity(torch.device("cpu"), ops=30)
