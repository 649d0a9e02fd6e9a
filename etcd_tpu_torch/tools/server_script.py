"""A seeded request stream for an EtcdServer cluster, and the plain form
of what it answers, so that two clusters can be held equal response for
response: a port cluster against an ``etcd_tpu`` one (both have the same
request types, so the stream is built from whichever ``server.api``
module is passed in), or a cluster on the GPU against one on the CPU.

    from etcd_tpu_torch.functional import Cluster
    from etcd_tpu_torch.server import api
    from etcd_tpu_torch.tools import server_script as ss

    c = Cluster(data_dir, n=3, device="cpu")
    bodies = ss.run(c, ss.script(api, seed=7, n=60), watch=True)
    ss.final_hash(c)   # (revision, hash_kv) agreed by every member

Each request goes to the current leader, one at a time. A response
becomes plain values (``plain``): dataclasses as their type name and
fields, enums as ints, with the header's ``raft_term`` and
``member_id`` left out (they depend on which member led); an error
becomes its class name. Lease IDs are given explicitly, since generated
IDs depend on the clock.
"""

from __future__ import annotations

import dataclasses
import enum
import time

import numpy as np

# Left out of every response header: who answered and in which term.
HEADER_LEFT_OUT = ("raft_term", "member_id")
KEYS = 12  # the key space: b"k00" .. b"k11"
LEASE_TTL = 600  # seconds: no lease of the script expires while it runs
FIRST_LEASE = 0x7E57


def plain(x):
    """A response (or any dataclass tree) as plain values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        fields = {f.name: plain(getattr(x, f.name))
                  for f in dataclasses.fields(x)}
        if type(x).__name__ == "ResponseHeader":
            for name in HEADER_LEFT_OUT:
                fields.pop(name, None)
        return (type(x).__name__, fields)
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def _key(rng) -> bytes:
    return b"k%02d" % int(rng.randint(KEYS))


def script(api, seed: int, n: int = 60) -> list:
    """`n` seeded operations, as (method, argument) pairs for the
    leader: puts with prev_kv (some on a lease), ranges (linearizable
    and serializable, with limits, sorted, at a past revision), txns
    comparing every target, deletes of a key and of a range, lease
    grants with explicit IDs and revokes, and, two thirds of the way in,
    a compaction followed by a range at a compacted revision (which
    answers ErrCompacted). A ("rev", k) argument is the revision k after
    the script's first, and ("now", d) the leader's revision plus d when
    the op is sent (`run` resolves both)."""
    rng = np.random.RandomState(seed)
    ops, leases, writes = [], [], 0  # writes: the puts so far
    compact_at = (2 * n) // 3
    for i in range(n):
        if i == compact_at:
            ops.append(("compact", api.CompactionRequest(revision=("now", -2))))
            ops.append(("range", api.RangeRequest(key=b"k", range_end=b"l",
                                                  revision=("rev", 1))))
            continue
        kind = rng.choice(["put", "put", "put", "range", "txn", "delete",
                           "lease"])
        if kind == "put":
            lease = leases[int(rng.randint(len(leases)))] if (
                leases and rng.rand() < 0.3) else 0
            ops.append(("put", api.PutRequest(
                key=_key(rng), value=rng.bytes(int(rng.randint(1, 24))),
                lease=lease, prev_kv=bool(rng.rand() < 0.7))))
            writes += 1
        elif kind == "range":
            shape = int(rng.randint(4))
            if shape == 0:
                req = api.RangeRequest(key=_key(rng),
                                       serializable=bool(rng.rand() < 0.5))
            elif shape == 1:
                req = api.RangeRequest(key=b"k", range_end=b"l",
                                       limit=int(rng.randint(0, 5)))
            elif shape == 2:
                req = api.RangeRequest(
                    key=b"k", range_end=b"l",
                    sort_order=api.SortOrder.DESCEND,
                    sort_target=api.SortTarget(int(rng.randint(5))),
                    serializable=True)
            else:
                req = api.RangeRequest(key=b"k", range_end=b"l",
                                       revision=("rev", max(writes - 1, 1)))
            ops.append(("range", req))
        elif kind == "txn":
            key = _key(rng)
            target = api.CompareTarget(int(rng.randint(5)))
            cmp = api.Compare(
                result=api.CompareResult(int(rng.randint(4))), target=target,
                key=key, version=int(rng.randint(3)),
                create_revision=("rev", int(rng.randint(1, writes + 2))),
                mod_revision=("rev", int(rng.randint(1, writes + 2))),
                value=rng.bytes(2), lease=0)
            ops.append(("txn", api.TxnRequest(
                compare=[cmp],
                success=[api.RequestOp(request_put=api.PutRequest(
                    key=key, value=b"txn-ok", prev_kv=True))],
                failure=[api.RequestOp(request_range=api.RangeRequest(
                    key=key))])))
        elif kind == "delete":
            if rng.rand() < 0.5:
                req = api.DeleteRangeRequest(key=_key(rng), prev_kv=True)
            else:
                a = int(rng.randint(KEYS - 2))
                req = api.DeleteRangeRequest(key=b"k%02d" % a,
                                             range_end=b"k%02d" % (a + 2))
            ops.append(("delete_range", req))
        else:
            if leases and rng.rand() < 0.4:
                ops.append(("lease_revoke",
                            leases.pop(int(rng.randint(len(leases))))))
            else:
                lid = FIRST_LEASE + i
                leases.append(lid)
                ops.append(("lease_grant", lid))
    return ops


def _resolve(x, base: int, now: int):
    """Replaces each ("rev", k) in a request by the revision base + k and
    each ("now", d) by now + d."""
    if isinstance(x, tuple) and len(x) == 2 and x[0] in ("rev", "now"):
        return (base if x[0] == "rev" else now) + x[1]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _resolve(getattr(x, f.name), base, now)
            for f in dataclasses.fields(x)})
    if isinstance(x, list):
        return [_resolve(v, base, now) for v in x]
    return x


def leader_of(cluster, timeout: float = 60.0):
    lead = cluster.leader()
    return lead if lead is not None else cluster.wait_leader(timeout)


def call(server, method: str, arg):
    """One request; returns its response, or the class name of the error
    it raised."""
    try:
        if method == "lease_grant":
            return server.lease_grant(LEASE_TTL, lease_id=arg)
        if method == "lease_revoke":
            return server.lease_revoke(arg)
        return getattr(server, method)(arg)
    except Exception as e:  # noqa: BLE001 — the error is the response
        return ("error", type(e).__name__)


def run(cluster, ops: list, watch: bool = False) -> list:
    """Sends `ops` to the leader, one at a time, and returns each
    response's plain form. With `watch`, a watch on the whole key space
    from the script's first revision, opened on the leader before the
    first op, adds one last body: every event it delivered, in order."""
    lead = leader_of(cluster)
    base = lead.kv.rev()
    stream = None
    if watch:
        stream = lead.kv.new_watch_stream()
        stream.watch(b"k", b"l", base + 1)
    out = []
    for method, arg in ops:
        lead = leader_of(cluster)
        arg = _resolve(arg, base, lead.kv.rev())
        out.append(plain(call(lead, method, arg)))
    if stream is not None:
        out.append(plain(drain_watch(stream, lead.kv.rev())))
        stream.close()
    return out


def drain_watch(stream, upto: int, timeout: float = 30.0) -> list:
    """Every event a watch stream delivers up to revision `upto`."""
    events = []
    deadline = time.monotonic() + timeout
    while (not events or events[-1].kv.mod_revision < upto) and (
            time.monotonic() < deadline):
        resp = stream.poll(timeout=0.2)
        if resp is not None:
            events.extend(resp.events)
    return events


def final_hash(cluster, timeout: float = 30.0) -> tuple:
    """(revision, hash) once every member holds the same hash_kv at the
    leader's revision."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        rev = leader_of(cluster).kv.rev()
        try:
            got = {s.hash_kv(rev)[0] for s in cluster.alive()}
        except Exception as e:  # noqa: BLE001 — a member still applying
            got = {repr(e)}
        if len(got) == 1 and rev == min(s.kv.rev() for s in cluster.alive()):
            return rev, got.pop()
        last = got
        time.sleep(0.05)
    raise AssertionError(f"hash_kv differs: {last}")
