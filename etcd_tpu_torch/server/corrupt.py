"""Cross-member corruption detection
(ref: server/etcdserver/corrupt.go:39 CheckInitialHashKV,
:123 monitorKVHash, :151 checkHashKV).

The checker compares this member's hash-KV against every peer's at the
same (revision, compact_revision) coordinates. A mismatch at boot
refuses to serve; a mismatch while running raises the CORRUPT alarm
through raft against the deviant member (or this one, if the leader
itself diverges), which fences all writes cluster-wide
(apply.py AlarmApplier).

Peer hashes arrive through a pluggable fetcher (corrupt.go's Hasher /
peerHashKVHTTP seam): the embed layer wires it to the peer transport's
control channel (the hash-KV analog of the reference's extra handlers
on the peer listener); in-proc harnesses wire it straight to sibling
server objects.

Ports ``etcd_tpu/server/corrupt.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, List, Optional

from .api import AlarmAction, AlarmRequest, AlarmType


class CorruptCheckError(Exception):
    """ref: etcdserver.ErrCorrupt — boot-time divergence."""


@dataclass
class PeerHashKV:
    """One peer's answer (ref: corrupt.go peerHashKVResp)."""

    member_id: int
    hash: int
    compact_revision: int
    revision: int


# fetcher(peer_id) -> PeerHashKV | None (unreachable peers return None,
# matching corrupt.go's skip-on-error behavior)
PeerHashFetcher = Callable[[int], Optional[PeerHashKV]]


class CorruptionChecker:
    """ref: corrupt.go corruptionChecker."""

    def __init__(self, server, fetcher: PeerHashFetcher) -> None:
        self.s = server
        self.fetch = fetcher
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- boot (corrupt.go:39 CheckInitialHashKV) -------------------------------

    def initial_check(self) -> None:
        """Compare against every reachable peer; same coordinates with
        a different hash is fatal at boot (we cannot know which side is
        corrupt, so refuse to serve)."""
        h, rev, crev = self.s.hash_kv(0)
        for pid in self._peer_ids():
            p = self.fetch(pid)
            if p is None:
                continue  # mirrors corrupt.go: unreachable peers skipped
            if p.revision == rev and p.compact_revision == crev \
                    and p.hash != h:
                raise CorruptCheckError(
                    f"found data inconsistency with peer {pid:x} "
                    f"(revision {rev}, compact_revision {crev}, "
                    f"hash {h} != peer hash {p.hash})")

    # -- runtime (corrupt.go:123 monitorKVHash) --------------------------------

    def start_periodic(self, interval: float) -> None:
        def loop() -> None:
            while not self._stop.wait(interval):
                if not self.s.is_leader():
                    continue  # leader-only, corrupt.go:131
                try:
                    self.periodic_check()
                except Exception:  # noqa: BLE001 — keep monitoring
                    pass

        self._thread = threading.Thread(
            target=loop, daemon=True, name="corruption-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def periodic_check(self) -> None:
        """One comparison pass (corrupt.go:151 checkHashKV). Raises the
        CORRUPT alarm through raft against whichever member diverged."""
        h, rev, crev = self.s.hash_kv(0)
        bad: List[int] = []
        for pid in self._peer_ids():
            p = self.fetch(pid)
            if p is None:
                continue
            # Only same-coordinate comparisons are meaningful: a peer
            # at another revision/compaction window legitimately hashes
            # differently (corrupt.go:200-231).
            if p.revision == rev and p.compact_revision == crev \
                    and p.hash != h:
                bad.append(pid)
        if not bad:
            return
        peers = len(self._peer_ids())
        if len(bad) >= 2 and len(bad) > peers // 2:
            # Two or more peers agree against us → we are the deviant.
            # A single divergent peer is always blamed directly (in a
            # 2-member cluster there is no majority to invert on).
            targets = [self.s.id]
        else:
            targets = bad
        for mid in targets:
            self._alarm_corrupt(mid)

    def _alarm_corrupt(self, member_id: int) -> None:
        try:
            self.s.alarm(AlarmRequest(
                action=AlarmAction.ACTIVATE,
                member_id=member_id,
                alarm=AlarmType.CORRUPT,
            ))
        except Exception:  # noqa: BLE001 — alarm is best-effort;
            pass           # the next pass retries

    def _peer_ids(self) -> List[int]:
        return [m.id for m in self.s.cluster.member_list()
                if m.id != self.s.id]


def transport_peer_fetcher(transport) -> PeerHashFetcher:
    """Fetcher over the peer transport's control channel (the embed
    wiring — the hash-KV analog of the reference's extra handlers on
    the peer listener, corrupt.go:261 hashKVHandler)."""

    def fetch(pid: int) -> Optional[PeerHashKV]:
        out = transport.peer_hash_kv(pid)
        if out is None:
            return None
        return PeerHashKV(
            member_id=out.get("member_id", pid), hash=out["hash"],
            compact_revision=out["compact_revision"],
            revision=out["revision"])

    return fetch


def inproc_peer_fetcher(servers_by_id) -> PeerHashFetcher:
    """Fetcher over sibling in-proc server objects (test harnesses)."""

    def fetch(pid: int) -> Optional[PeerHashKV]:
        peer = servers_by_id().get(pid) if callable(servers_by_id) \
            else servers_by_id.get(pid)
        if peer is None:
            return None
        try:
            h, rev, crev = peer.hash_kv(0)
        except Exception:  # noqa: BLE001
            return None
        return PeerHashKV(member_id=pid, hash=h,
                          compact_revision=crev, revision=rev)

    return fetch
