"""Supervised in-proc cluster: the agent half of the functional
harness (ref: tests/functional/agent/ — the per-member supervisor that
can stop/restart/blackhole its member on tester command).

Ports ``etcd_tpu/functional/cluster.py``."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..raft.raft import NONE
from ..raftexample.transport import InProcNetwork
from ..server import EtcdServer, ServerConfig


class Cluster:
    def __init__(self, data_dir: str, n: int = 3,
                 tick_interval: float = 0.01, **cfg_kw) -> None:
        self.data_dir = data_dir
        self.peers = list(range(1, n + 1))
        self.tick_interval = tick_interval
        self.cfg_kw = cfg_kw
        self.net = InProcNetwork()
        self.servers: Dict[int, Optional[EtcdServer]] = {}
        for nid in self.peers:
            self.servers[nid] = self._spawn(nid)

    def _spawn(self, nid: int) -> EtcdServer:
        kw = {"request_timeout": 10.0, **self.cfg_kw}
        return EtcdServer(
            ServerConfig(
                member_id=nid,
                peers=self.peers,
                data_dir=self.data_dir,
                network=self.net,
                tick_interval=self.tick_interval,
                **kw,
            )
        )

    # -- membership of the living ----------------------------------------------

    def alive(self) -> List[EtcdServer]:
        return [s for s in self.servers.values() if s is not None]

    def leader(self) -> Optional[EtcdServer]:
        for s in self.alive():
            if s.is_leader():
                return s
        return None

    def followers(self) -> List[EtcdServer]:
        return [s for s in self.alive() if not s.is_leader()]

    def wait_leader(self, timeout: float = 20.0) -> EtcdServer:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            lead = self.leader()
            # Settled: a leader exists and every live member agrees.
            if lead is not None and all(
                s.leader() == lead.id for s in self.alive()
            ):
                return lead
            time.sleep(0.02)
        raise AssertionError("no leader within timeout")

    def wait_no_leader(self, timeout: float = 20.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(s.leader() == NONE for s in self.alive()):
                return
            time.sleep(0.02)
        raise AssertionError("leader still present")

    # -- failures (tester/case_*.go) -------------------------------------------

    def kill(self, nid: int) -> None:
        """SIGKILL equivalent: stop the member (WAL/backend stay)."""
        s = self.servers[nid]
        if s is not None:
            s.stop()
            self.net.unregister(nid)
            self.servers[nid] = None

    def restart(self, nid: int) -> EtcdServer:
        """Agent restart: same data dir → WAL replay recovery path."""
        assert self.servers[nid] is None, f"member {nid} still running"
        self.net.heal(nid)
        s = self._spawn(nid)
        self.servers[nid] = s
        return s

    def blackhole(self, nid: int) -> None:
        """Drop all peer traffic to/from nid (BLACKHOLE_PEER cases)."""
        self.net.isolate(nid)

    def unblackhole(self, nid: int) -> None:
        self.net.heal(nid)

    def drop(self, a: int, b: int, prob: float) -> None:
        self.net.drop(a, b, prob)
        self.net.drop(b, a, prob)

    def delay_peer(self, nid: int, base_s: float,
                   jitter_s: float = 0.0) -> None:
        """Add latency to ALL of nid's links, both directions
        (DELAY_PEER_PORT_TX_RX_{ONE_FOLLOWER,LEADER} cases)."""
        for other in self.peers:
            if other != nid:
                self.net.delay(nid, other, base_s, jitter_s)
                self.net.delay(other, nid, base_s, jitter_s)

    def undelay_all(self) -> None:
        self.net.undelay()

    def close(self) -> None:
        for nid, s in self.servers.items():
            if s is not None:
                s.stop()
        self.net.stop()
