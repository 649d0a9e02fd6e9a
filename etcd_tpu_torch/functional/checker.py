"""Checkers: post-fault invariants
(ref: tests/functional/tester/checker_kv_hash.go, checker_lease_expire.go,
checker_no_check.go; cluster consistency = same KV hash at the same
revision across members).

Two families share the converge-then-assert skeleton (`_converge`):

* the single-group server checkers (`hash_check`, `lease_expire_check`,
  `linearizable_check`) over ``EtcdServer`` members, and
* the batched multi-raft checkers (`multiraft_hash_check`,
  `committed_never_lost`, `check_leader_claims`,
  `check_sequential_history`) over ``MultiRaftMember``-shaped hosts —
  duck-typed on ``.kvs`` / ``.applied_index`` so this module never
  imports the batched engine.

Ports ``etcd_tpu/functional/checker.py``; tests/test_torch_server_pins.py
pins each function to the reference's.
"""

from __future__ import annotations

import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..server import EtcdServer
from ..server.api import RangeRequest


def _converge(poll: Callable[[], Tuple[bool, object]], timeout: float,
              desc: str, interval: float = 0.1):
    """Deadline-poll a convergence predicate. ``poll`` returns
    (ok, info); exceptions count as not-yet (members mid-recovery
    mutate state under the poller). On success returns the final info;
    on deadline raises AssertionError carrying the last observation."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            ok, last = poll()
            if ok:
                return last
        except Exception as e:  # noqa: BLE001 — members mid-recovery
            last = e
        time.sleep(interval)
    raise AssertionError(f"{desc} after {timeout}s: {last}")


def hash_check(servers: List[EtcdServer], timeout: float = 20.0) -> int:
    """All members converge to the same hash_kv at the same revision
    (checker_kv_hash.go waits up to 7 rounds). Returns the agreed rev."""

    def poll():
        # Pin the comparison at the smallest current revision.
        rev = min(s.kv.rev() for s in servers)
        hashes = {s.hash_kv(rev)[0] for s in servers}
        return len(hashes) == 1, rev if len(hashes) == 1 else hashes

    return _converge(poll, timeout, "kv hash mismatch")


def lease_expire_check(server: EtcdServer, lease_ids: List[int],
                       keys: List[bytes], timeout: float = 30.0) -> None:
    """Expired leases are gone and their keys deleted
    (checker_lease_expire.go)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        alive = set(server.lease_leases())
        if not (alive & set(lease_ids)):
            break
        time.sleep(0.1)
    else:
        raise AssertionError("leases did not expire")
    for key in keys:
        rr = server.range(RangeRequest(key=key, serializable=True))
        assert not rr.kvs, f"leased key {key!r} survived expiry"


def linearizable_check(server: EtcdServer, key: bytes,
                       expect_value: bytes) -> None:
    """A linearizable read observes the latest committed write."""
    rr = server.range(RangeRequest(key=key))
    assert rr.kvs and rr.kvs[0].value == expect_value, (
        f"linearizable read saw {rr.kvs[0].value if rr.kvs else None!r}, "
        f"want {expect_value!r}"
    )


# -- batched multi-raft checkers -----------------------------------------------


def kv_map_hash(data: Dict[bytes, bytes]) -> int:
    """Order-independent-input, order-pinned hash of one group's KV map
    (crc32c chain over sorted items — the per-group analog of the
    server's hash_kv)."""
    h = 0
    for k in sorted(data):
        h = zlib.crc32(k, h)
        h = zlib.crc32(b"\x00", h)
        h = zlib.crc32(data[k], h)
        h = zlib.crc32(b"\x01", h)
    return h


def multiraft_hash_check(members: Sequence, timeout: float = 30.0,
                         allow_lag: int = 0) -> List[int]:
    """Per-group KV-hash parity across the surviving members — the
    hash_check invariant batched over every group at once. Members are
    MultiRaftMember-shaped: ``.kvs`` (list of GroupKV) and
    ``.applied_index`` (numpy [G]). Waits for the apply watermarks to
    agree first (cheap vector compare) before hashing. Returns the
    per-group hash list of the agreeing majority.

    ``allow_lag=k`` relaxes parity to the quorum theorem raft actually
    proves: per group, at least ``len(members) - k`` members must agree
    on (applied, hash); up to k members may lag behind (a follower
    being behind is a liveness condition every live cluster passes
    through, not a safety violation). Strict parity (k=0) is the
    default and — since the durability fence — what every
    chaos episode class asserts; the relaxation remains for
    fence-disabled runs that deliberately re-open the torn-tail
    divergence (tools/repro_progress_wedge.py --torn-acked)."""
    import numpy as np

    members = list(members)
    assert members, "no members to check"
    need = len(members) - allow_lag

    def poll():
        applied = np.stack(
            [np.asarray(m.applied_index) for m in members])
        hashes = None
        if (applied == applied[0]).all():
            hashes = [[kv_map_hash(kv.data) for kv in m.kvs]
                      for m in members]
            for mi, hs in enumerate(hashes[1:], 1):
                if hs != hashes[0]:
                    bad = [g for g, (a, b)
                           in enumerate(zip(hashes[0], hs)) if a != b]
                    return False, (
                        f"kv hash mismatch member {members[mi].id} "
                        f"groups {bad[:8]}")
            return True, hashes[0]
        lag = np.nonzero((applied != applied[0]).any(axis=0))[0]
        if not allow_lag:
            return False, (
                f"applied divergence on groups {lag[:8].tolist()}: "
                f"{applied[:, lag[:4]].tolist()}")
        # Quorum mode: per group the modal (applied, hash) pair must be
        # held by >= need members.
        hashes = [[kv_map_hash(kv.data) for kv in m.kvs]
                  for m in members]
        agreed: List[int] = []
        for g in range(applied.shape[1]):
            pairs = [(int(applied[mi, g]), hashes[mi][g])
                     for mi in range(len(members))]
            top, count = max(
                ((p, pairs.count(p)) for p in pairs),
                key=lambda t: t[1])
            if count < need:
                return False, (
                    f"group {g}: no {need}-member agreement, "
                    f"states {pairs}")
            agreed.append(top[1])
        return True, agreed

    return _converge(poll, timeout, "multi-raft kv hash parity")


def committed_never_lost(members: Sequence,
                         acked: Dict[Tuple[int, bytes], bytes],
                         timeout: float = 30.0,
                         allow_lag: int = 0,
                         history: Optional[
                             Dict[Tuple[int, bytes], List[bytes]]
                         ] = None) -> None:
    """Every acked write — applied at its proposer, hence committed —
    is present with the acked value on EVERY surviving member after
    recovery (the tester's 'no lost writes' core; Jepsen's
    acknowledged-writes-survive).

    ``allow_lag=k``: each acked write must be present on at least
    ``len(members) - k`` members (quorum durability — the theorem raft
    proves). A member holding a value NEVER acked for the key is
    DIVERGENT (immediate failure); a member holding an OLDER acked
    version from ``history`` (key -> acked values in order) is merely
    lagging — missing a suffix, never diverging."""
    members = list(members)
    need = len(members) - allow_lag
    history = history or {}

    def poll():
        missing = []
        for (g, k), v in acked.items():
            have = 0
            for m in members:
                got = m.kvs[g].data.get(k)
                if got == v:
                    have += 1
                elif got is not None and \
                        got not in history.get((g, k), ()):
                    return False, (
                        f"DIVERGENT acked write g{g} {k!r} on "
                        f"member {m.id}: {got!r} never acked "
                        f"(latest {v!r})")
            if have < need:
                missing.append((g, k, have))
                if len(missing) >= 8:
                    break
        return not missing, (
            f"acked writes below {need}-member durability: "
            f"{missing[:8]}" if missing
            else f"{len(acked)} acked writes intact")

    _converge(poll, timeout, "committed-never-lost")


def check_leader_claims(
        conflicts: List[Tuple[int, int, int, int]]) -> None:
    """Assert the LeaderObserver saw at most one leader per (group,
    term) — raft election safety across the whole batch."""
    assert not conflicts, (
        "two leaders claimed the same (group, term): "
        f"{[(g, t, a, b) for g, t, a, b in conflicts[:8]]}")


def _quorums_can_be_disjoint(a, b) -> bool:
    """Whether two majority configs admit DISJOINT quorums — i.e. a
    quorum of `a` and a quorum of `b` with no member in common, the
    precondition for two leaders committing divergent entries in one
    term. Feasible exactly when |q_a| + |q_b| <= |a ∪ b| (fill each
    quorum from its private members first, then the shared pool)."""
    a, b = set(a), set(b)
    if not a or not b:
        return False  # empty config commits nothing on its own
    qa = len(a) // 2 + 1
    qb = len(b) // 2 + 1
    return qa + qb <= len(a | b)


def check_config_safety(members: Sequence,
                        timeout: float = 30.0) -> None:
    """Membership-change safety over the batched hosting path (the
    conf-change analog of the KV checkers; members are
    MultiRaftMember-shaped, duck-typed on ``conf_snapshot()`` /
    ``conf_history(g)``):

    1. **no committed config lost** — after convergence every member
       holds the SAME final per-group config (voters/learners/joint),
       and histories never disagree about the config applied at a
       given log index;
    2. **no two disjoint quorums for one group** — every adjacent pair
       of configs in the applied sequence overlaps: a joint entry's
       outgoing half must equal the previous incoming voters (the
       §4.3 discipline), a simple change moves at most one voter, and
       the quorum-disjointness formula is checked explicitly on every
       transition (old config vs new, both joint halves);
    3. **joint state always exited** — no group ends the episode
       inside a joint config.
    """
    members = list(members)
    assert members, "no members to check"

    def poll():
        snaps = [m.conf_snapshot() for m in members]
        s0 = snaps[0]
        g = len(s0["voters"])
        for mi, s in enumerate(snaps[1:], 1):
            for gi in range(g):
                if (s["voters"][gi] != s0["voters"][gi]
                        or s["learners"][gi] != s0["learners"][gi]
                        or bool(s["in_joint"][gi])
                        != bool(s0["in_joint"][gi])):
                    return False, (
                        f"conf divergence g{gi}: member "
                        f"{members[mi].id} {s['voters'][gi]}/"
                        f"{s['learners'][gi]} vs member "
                        f"{members[0].id} {s0['voters'][gi]}/"
                        f"{s0['learners'][gi]}")
        joint = [gi for gi in range(g) if bool(s0["in_joint"][gi])]
        if joint:
            return False, f"groups still in joint config: {joint[:8]}"
        return True, g

    g = _converge(poll, timeout, "config parity / joint exit")

    # History audit (post-convergence; histories are bounded rings, so
    # compare only the indexes both members still hold).
    for gi in range(g):
        hists = [m.conf_history(gi) for m in members]
        by_index: Dict[int, Tuple] = {}
        for m, h in zip(members, hists):
            for ent in h:
                key = (ent["voters"], ent["voters_out"],
                       ent["learners"], ent["joint"])
                prev = by_index.setdefault(ent["index"], key)
                assert prev == key, (
                    f"committed config lost/diverged g{gi} "
                    f"i{ent['index']}: member {m.id} applied {key}, "
                    f"another member applied {prev}")
        for h in hists:
            prev = None  # boot config = all voters, checked via first
            for ent in h:
                cur_voters = set(ent["voters"])
                if ent.get("restored"):
                    # A snapshot-carried config: the entries between
                    # prev and here were compacted away, so adjacency
                    # re-anchors at the restored state (its own
                    # legality was audited by the members that applied
                    # the original entries).
                    prev = ent
                    continue
                if ent["joint"]:
                    # Enter-joint: commits now need BOTH halves, and
                    # the outgoing half must be exactly the previous
                    # incoming voters — any joint quorum then contains
                    # a majority of the old config, so no quorum of
                    # the old and new systems can ever be disjoint
                    # (§4.3; quorum/joint.go).
                    out = set(ent["voters_out"])
                    if prev is not None:
                        assert out == set(prev["voters"]), (
                            f"g{gi} i{ent['index']}: joint outgoing "
                            f"{sorted(out)} != previous incoming "
                            f"{sorted(prev['voters'])}")
                elif prev is not None:
                    if prev["joint"]:
                        # Leave-joint: the incoming half carries over
                        # unchanged — quorums before (joint: needs an
                        # incoming majority) and after (incoming
                        # majority) share a set, so they intersect.
                        assert cur_voters == set(prev["voters"]), (
                            f"g{gi} i{ent['index']}: leave-joint "
                            f"changed voters {sorted(prev['voters'])} "
                            f"-> {sorted(cur_voters)}")
                    else:
                        delta = cur_voters ^ set(prev["voters"])
                        assert len(delta) <= 1, (
                            f"g{gi} i{ent['index']}: simple change "
                            f"moved {len(delta)} voters "
                            f"({sorted(delta)}) without joint")
                        assert not _quorums_can_be_disjoint(
                            set(prev["voters"]), cur_voters), (
                            f"g{gi} i{ent['index']}: adjacent simple "
                            f"configs {sorted(prev['voters'])} -> "
                            f"{sorted(cur_voters)} admit disjoint "
                            "quorums")
                prev = ent


def check_durability_envelope(applied: Dict[int, int],
                              durable: Dict[int, int]) -> None:
    """Release-barrier audit for a fail-stopped member (the
    IO-error contract): ``applied`` is the dead member's per-group
    apply watermark at death, ``durable`` what its WAL can actually
    replay (max entry/snapshot index per group). Every apply a member
    ever RELEASES must ride a successful covering fsync — so an
    ``applied[g] > durable[g]`` group means an ack/apply escaped the
    failed window: exactly the ATC'19 failure (state served to clients
    that recovery cannot reproduce). Pure function — the chaos harness
    (faults.failstop_envelope) assembles both maps."""
    bad = {g: (a, durable.get(g, 0)) for g, a in applied.items()
           if a > durable.get(g, 0)}
    assert not bad, (
        "applies escaped the failed window (applied > durable log): "
        f"{dict(list(bad.items())[:8])}")


def check_sequential_history(
        history: List[Tuple],
) -> None:
    """Replay a SEQUENTIAL client's observed history: with no client
    concurrency, linearizability degenerates to 'every successful read
    returns the latest acked write to that key'. Events:
    ``('w', key, value)`` — an acked write; ``('r', key, got, ok)`` —
    a read that returned `got` (ok=True) or failed cleanly (ok=False,
    e.g. NotLeaderError/TimeoutError during failover — always legal).
    A successful STALE read is the bug this catches."""
    latest: Dict[bytes, Optional[bytes]] = {}
    for i, ev in enumerate(history):
        if ev[0] == "w":
            _op, key, value = ev
            latest[key] = value
        elif ev[0] == "r":
            _op, key, got, ok = ev
            if ok:
                want = latest.get(key)
                assert got == want, (
                    f"stale read at history[{i}]: key {key!r} returned "
                    f"{got!r}, latest acked write was {want!r}")
        else:
            raise ValueError(f"unknown history event {ev!r}")
