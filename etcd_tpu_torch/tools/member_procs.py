"""Booted etcd members as processes: ``python -m etcd_tpu_torch`` (or
another package's member, for a mixed cluster), the port's twin of
tests/framework/e2e.py's ``EtcdProcess``/``E2ECluster``, as
``proc_cluster.py`` is for the hosting workers.

``MemberProc`` spawns one member with ``subprocess.Popen`` (fork + exec),
its output in a log file of its own in the data root (an undrained pipe
would wedge a member once its buffer fills), one file a generation, so
that a restart keeps the crashed process's log. A port member gets
``--device`` when the cluster names one (``cpu`` here without a card)
and none on the card, where it takes its default, the GPU. ``kill9``
leaves the data dir as the crash left it; ``start`` boots the member on
it again; ``stop`` is an orderly stop (SIGTERM), after which a port
member's log holds its ``kernel launches:`` line (``launch_lines``);
``launches_now`` asks a running port member for the line so far (SIGHUP).

``MemberCluster`` is three such members (``n`` of them) on free local
ports, at etcd's default heartbeat and election timeouts (100 ms,
1,000 ms); ``modules`` makes member i another package's (``{0:
"etcd_tpu"}`` boots the reference's member first), ``flags`` adds
member flags (``--raft-backend host``). ``leader()`` asks each member's
Status over its client URL.

``etcdctl`` runs one command of the port's etcdctl (``python -m
etcd_tpu_torch.etcdctl``) as a process of its own, as etcd's e2e tests
run theirs, and ``etcdctl_popen`` starts one that blocks (watch, lock,
elect).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from ..batched.hosting_proc import LAUNCHES_PREFIX
from ..client import Client
from ..embed.config import member_id_from_urls
from .proc_cluster import free_ports

PORT_MEMBER = "etcd_tpu_torch"
PORT_CTL = "etcd_tpu_torch.etcdctl"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOKEN = "etcd-cluster"  # etcd's default --initial-cluster-token


def member_env(device: Optional[str]) -> Dict[str, str]:
    """The environment of a member or tool process: the checkout on the
    path, JAX on the CPU for a reference member, and on the CPU one
    intra-op thread a process (three members and their clients share
    the host's cores)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    return env


def etcdctl(endpoints: str, *args: str, stdin: Optional[str] = None,
            timeout: float = 60.0,
            module: str = PORT_CTL) -> Tuple[int, str, str]:
    """One etcdctl command in a process of its own: its exit code,
    stdout and stderr."""
    r = subprocess.run(
        [sys.executable, "-m", module, "--endpoints", endpoints, *args],
        env=member_env(None), capture_output=True, text=True, input=stdin,
        timeout=timeout)
    return r.returncode, r.stdout, r.stderr


def etcdctl_popen(endpoints: str, *args: str,
                  module: str = PORT_CTL) -> subprocess.Popen:
    """An etcdctl command that blocks, its output on pipes (text)."""
    return subprocess.Popen(
        [sys.executable, "-m", module, "--endpoints", endpoints, *args],
        env=member_env(None), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


class MemberProc:
    """One member as an OS process."""

    def __init__(self, name: str, data_dir: str, peer_port: int,
                 client_port: int, metrics_port: int, initial_cluster: str,
                 module: str = PORT_MEMBER, device: Optional[str] = None,
                 flags: Sequence[str] = (),
                 log_dir: Optional[str] = None) -> None:
        self.name = name
        self.data_dir = data_dir
        self.peer_port, self.client_port = peer_port, client_port
        self.metrics_port = metrics_port
        self.initial_cluster = initial_cluster
        self.module, self.device = module, device
        self.flags = list(flags)
        self.log_dir = log_dir or os.path.dirname(data_dir)
        self.proc: Optional[subprocess.Popen] = None
        self.gen = -1

    @property
    def endpoint(self) -> str:
        return f"127.0.0.1:{self.client_port}"

    @property
    def peer_url(self) -> str:
        return f"http://127.0.0.1:{self.peer_port}"

    @property
    def member_id(self) -> int:
        return member_id_from_urls(self.peer_url, TOKEN)

    def log_path(self, gen: Optional[int] = None) -> str:
        gen = self.gen if gen is None else gen
        return os.path.join(self.log_dir, f"member-{self.name}-gen{gen}.log")

    def start(self) -> None:
        """Boot (or boot again, on its data dir)."""
        self.gen += 1
        device = (["--device", self.device]
                  if self.device and self.module == PORT_MEMBER else [])
        os.makedirs(self.log_dir, exist_ok=True)
        log = open(self.log_path(), "wb")
        try:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", self.module, "--name", self.name,
                 "--data-dir", self.data_dir,
                 "--listen-peer-urls", self.peer_url,
                 "--listen-client-urls",
                 f"http://127.0.0.1:{self.client_port}",
                 "--listen-metrics-urls",
                 f"http://127.0.0.1:{self.metrics_port}",
                 "--initial-cluster", self.initial_cluster,
                 *device, *self.flags],
                env=member_env(self.device), stdout=log,
                stderr=subprocess.STDOUT)
        finally:
            log.close()

    def log_tail(self, n: int = 3000) -> str:
        if not os.path.exists(self.log_path()):
            return ""
        with open(self.log_path(), "rb") as f:
            return f.read()[-n:].decode(errors="replace")

    def wait_ready(self, timeout: float = 300.0) -> float:
        """Until the member serves /health (etcd_process.go waitReady);
        returns the seconds waited."""
        t0 = time.monotonic()
        url = (f"http://127.0.0.1:{self.metrics_port}"
               "/health?serializable=true")
        while time.monotonic() - t0 < timeout:
            if self.proc is None or self.proc.poll() is not None:
                raise AssertionError(
                    f"member {self.name} exited (rc "
                    f"{None if self.proc is None else self.proc.returncode})"
                    f":\n{self.log_tail()}")
            try:
                with urllib.request.urlopen(url, timeout=2) as r:
                    if json.loads(r.read())["health"] == "true":
                        return time.monotonic() - t0
            except Exception:  # noqa: BLE001 — not serving yet
                pass
            time.sleep(0.2)
        raise AssertionError(f"member {self.name} never became healthy:\n"
                             + self.log_tail())

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def stop(self, sig: int = signal.SIGTERM, timeout: float = 60.0) -> int:
        if self.proc is None:
            return 0
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait(timeout=timeout)
        self.proc = None
        return rc

    def kill9(self) -> int:
        """kill -9: no orderly stop, no launch line, the WAL as it lies."""
        return self.stop(sig=signal.SIGKILL)

    def client(self, timeout: float = 30.0) -> Client:
        host, port = self.endpoint.rsplit(":", 1)
        return Client([(host, int(port))], request_timeout=timeout)

    def launch_lines(self, at: str = "stop") -> List[dict]:
        """The `kernel launches:` lines of each generation's log written
        at `at`: "stop" (one per orderly stop) or "signal" (one per
        SIGHUP, `launches_now`)."""
        out = []
        for gen in range(self.gen + 1):
            path = self.log_path(gen)
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                for line in f.read().decode(errors="replace").splitlines():
                    if line.startswith(LAUNCHES_PREFIX):
                        ln = json.loads(line[len(LAUNCHES_PREFIX):])
                        if ln.get("at", "stop") == at:
                            out.append({"log": os.path.basename(path),
                                        "gen": gen, **ln})
        return out

    def launches_now(self, timeout: float = 30.0) -> dict:
        """The running member's launch line as of now (its node rounds
        and launches since this generation booted): SIGHUP, then the new
        line from its log."""
        seen = len(self.launch_lines("signal"))
        self.proc.send_signal(signal.SIGHUP)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            lines = self.launch_lines("signal")
            if len(lines) > seen:
                return lines[-1]
            time.sleep(0.05)
        raise AssertionError(f"member {self.name} wrote no launch line")


class MemberCluster:
    """`n` members on free local ports, named m0.., one data dir each
    under `root`."""

    def __init__(self, root: str, n: int = 3, device: Optional[str] = None,
                 modules: Optional[Dict[int, str]] = None,
                 flags: Sequence[str] = ()) -> None:
        ports = free_ports(3 * n)
        names = [f"m{i}" for i in range(n)]
        initial = ",".join(f"{nm}=http://127.0.0.1:{ports[3 * i]}"
                           for i, nm in enumerate(names))
        modules = modules or {}
        self.root = root
        self.procs = [
            MemberProc(nm, os.path.join(root, nm), ports[3 * i],
                       ports[3 * i + 1], ports[3 * i + 2], initial,
                       module=modules.get(i, PORT_MEMBER), device=device,
                       flags=flags, log_dir=root)
            for i, nm in enumerate(names)]

    def start(self, timeout: float = 300.0) -> float:
        """Boot every member; returns the seconds until all serve."""
        t0 = time.monotonic()
        for p in self.procs:
            p.start()
        for p in self.procs:
            p.wait_ready(max(1.0, timeout - (time.monotonic() - t0)))
        return time.monotonic() - t0

    def endpoints(self, procs=None) -> str:
        return ",".join(p.endpoint for p in (procs or self.procs))

    def leader(self, timeout: float = 60.0) -> MemberProc:
        """The member that leads, as its own Status says, once one does."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for p in self.procs:
                if not p.alive():
                    continue
                c = p.client(timeout=5.0)
                try:
                    if c.status()["is_leader"]:
                        return p
                except Exception:  # noqa: BLE001 — electing or restarting
                    pass
                finally:
                    c.close()
            time.sleep(0.2)
        raise AssertionError("no member leads")

    def launch_lines(self) -> List[dict]:
        return [ln for p in self.procs for ln in p.launch_lines()]

    def close(self) -> List[dict]:
        """Orderly stop of every live member; returns the launch lines."""
        for p in self.procs:
            if p.alive():
                p.proc.send_signal(signal.SIGTERM)
        for p in self.procs:
            p.stop()
        return self.launch_lines()
