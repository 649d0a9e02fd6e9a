"""PyTorch port ↔ JAX reference: etcdctl, command by command.

Each command of tests/etcdctl/test_etcdctl.py runs through the
reference's ``etcdctl.main(argv)`` and the port's, each against its own
package's in-process single-member server behind its ``V3RPCServer``
(each on its scalar core, as the reference's member runs: the commands
are under test here, and tests/test_torch_ctl_e2e.py drives the port's
etcdctl against members on ``"tpu"``), one script in one order. The
exit codes are equal, and so is stdout once only these are replaced on
each side: the member's and the cluster's ids, the endpoint's port, the
ids of the leases the script, a lock or an election grants (lease ids
follow the clock), and, in the commands that print timings (``check
perf``, ``check datascale``, ``endpoint health``), every decimal number.
The one difference that remains is listed in ``DIFFERENT``: the backend
file's size.

``parse_txn`` gives equal requests for the same lines, or refuses them
alike.
"""

import contextlib
import io
import re
import sys
import threading
import time

import pytest

from etcd_tpu.client.client import Client as RClient
from etcd_tpu.etcdctl import main as rctl, parse_txn as rparse_txn
from etcd_tpu.raftexample.transport import InProcNetwork as RNet
from etcd_tpu.server import EtcdServer as RServer, ServerConfig as RConfig
from etcd_tpu.v3rpc.service import V3RPCServer as RRPC
from etcd_tpu_torch.client.client import Client as TClient
from etcd_tpu_torch.etcdctl import main as tctl, parse_txn as tparse_txn
from etcd_tpu_torch.raftexample.transport import InProcNetwork as TNet
from etcd_tpu_torch.server import EtcdServer as TServer
from etcd_tpu_torch.server import ServerConfig as TConfig
from etcd_tpu_torch.tools.server_script import plain
from etcd_tpu_torch.v3rpc.service import V3RPCServer as TRPC

SIDES = ("ref", "port")
MEMBER, CLUSTER = 0x5EED5EED5EED, 0xC1A55C1A55

# The commands whose stdout holds timings.
TIMED = ("check", "endpoint health")


def _no_db_size(outs):
    """The DB SIZE column of ``endpoint status``: the size of the sqlite
    file follows when the backend's batches committed (a timer), not the
    commands."""
    return [(rc, re.sub(r"\|\s*\d+\s*\|\n", "| <size> |\n", text))
            for rc, text in outs]


# Steps whose stdout still differs once normalized, and what is taken
# out of both sides' before they are compared.
DIFFERENT = {"endpoint": _no_db_size}


def _wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"never {what}")


class Side:
    """One package's member, its etcdctl and its client."""

    def __init__(self, name, tmp):
        self.name = name
        cfg = dict(member_id=MEMBER, cluster_id=CLUSTER, peers=[MEMBER],
                   data_dir=str(tmp), tick_interval=0.01, raft_backend="host")
        if name == "ref":
            self.srv = RServer(RConfig(network=RNet(), **cfg))
            self.rpc, self.ctl, self.client = RRPC(
                self.srv, bind=("127.0.0.1", 0)), rctl, RClient
        else:
            self.srv = TServer(TConfig(network=TNet(), **cfg))
            self.rpc, self.ctl, self.client = TRPC(
                self.srv, bind=("127.0.0.1", 0)), tctl, TClient
        _wait(self.srv.is_leader, f"{name} led")
        self.ep = f"{self.rpc.addr[0]}:{self.rpc.addr[1]}"
        self.leases = []

    def run(self, *argv, stdin=None):
        out, err = io.StringIO(), io.StringIO()
        old = sys.stdin
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = self.ctl(["--endpoints", self.ep, *argv])
        finally:
            sys.stdin = old
        return rc, out.getvalue()

    def norm(self, text, timed=False):
        for lid in self.leases:
            text = text.replace(f"{lid:x}", "<lease>").replace(
                str(lid), "<lease>")
        ids = {"<member>": self.srv.id,
               "<cluster>": self.srv.cluster_id}
        for tag, v in ids.items():
            text = re.sub(rf"\b({v:x}|{v})\b", tag, text)
        text = text.replace(str(self.rpc.addr[1]), "<port>")
        # A lock's or an election's key ends in its session's lease id.
        text = re.sub(r"\b(mylock|myelec)/[0-9a-f]+", r"\1/<lease>", text)
        if timed:
            text = re.sub(r"\d+\.\d+", "<n>", text)
        return text

    def close(self):
        self.rpc.stop()
        self.srv.stop()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    out = {}
    try:
        for name in SIDES:
            out[name] = Side(name, tmp_path_factory.mktemp(f"ctl-{name}"))
        yield out
    finally:
        for s in out.values():
            s.close()


def _watch(side):
    res = {}
    t = threading.Thread(target=lambda: res.update(
        r=side.run("watch", "wkey", "--max-events", "1")))
    t.start()
    time.sleep(0.5)
    c = side.client([side.rpc.addr])
    try:
        c.put(b"wkey", b"wval")
    finally:
        c.close()
    t.join(timeout=30)
    return [res["r"]]


def _lease(side):
    rc, out = side.run("lease", "grant", "60")
    lid = int(out.split()[1], 16)
    side.leases.append(lid)
    h = f"{lid:x}"
    return [(rc, out)] + [side.run(*a) for a in (
        ("lease", "timetolive", h), ("lease", "keep-alive", h, "--once"),
        ("lease", "list"), ("put", "leased", "x", "--lease", h),
        ("lease", "timetolive", h, "--keys"), ("lease", "revoke", h),
        ("get", "leased"), ("lease", "timetolive", h))]


TXN = 'value("txnk") = "old"\n\nput txnk new\n\nget txnk\n'

# (name, steps): a step is argv, (argv, stdin) or a function of the side
# that returns [(rc, stdout)].
STEPS = [
    ("put_get_del", [("put", "ctlk", "ctlv"), ("get", "ctlk"),
                     ("get", "ctlk", "--print-value-only"), ("del", "ctlk"),
                     ("get", "ctlk")]),
    ("get_prefix_sorted_json", [
        ("put", "pfx3", "v3"), ("put", "pfx1", "v1"), ("put", "pfx2", "v2"),
        ("get", "pfx", "--prefix", "--order", "DESCEND"),
        ("get", "pfx", "--prefix", "--sort-by", "VALUE", "--limit", "2"),
        ("-w", "json", "get", "pfx1"), ("-w", "fields", "get", "pfx2")]),
    ("get_count_keys_only", [
        ("put", "cnt1", "x"), ("put", "cnt2", "x"),
        ("get", "cnt", "--prefix", "--count-only"),
        ("get", "cnt", "--prefix", "--keys-only"),
        ("get", "cnt1", "cnt3"), ("get", "cnt", "--prefix", "--limit", "1")]),
    ("txn", [("put", "txnk", "old"), (("txn",), TXN),
             ("get", "txnk", "--print-value-only"), (("txn",), TXN),
             ("-w", "json", "get", "txnk")]),
    ("compaction", [lambda s: [s.run("compaction", str(s.srv.kv.rev())),
                               s.run("get", "pfx1", "--rev", "2")]]),
    ("watch", [_watch]),
    # Before any lease: a key's lease id is part of hashkv's hash.
    ("endpoint", [("endpoint", "health"), ("endpoint", "status"),
                  ("-w", "table", "endpoint", "status"),
                  ("endpoint", "hashkv")]),
    ("lease", [_lease]),
    ("member_list", [("member", "list"), ("-w", "table", "member", "list"),
                     ("-w", "json", "member", "list")]),
    ("alarm_defrag", [("alarm", "list"), ("defrag",)]),
    ("move_leader", [lambda s: [s.run("move-leader", f"{s.srv.id:x}")]]),
    ("version", [("version",)]),
    ("check_perf", [("check", "perf", "--load", "s")]),
    ("check_datascale", [
        ("check", "datascale", "--load", "s", "--auto-compact"),
        ("get", "/etcdctl-check-datascale/", "--prefix", "--count-only")]),
    ("lock_elect", [("lock", "mylock"), ("elect", "myelec", "leader-a")]),
]


def _outputs(side, steps):
    out = []
    for step in steps:
        if callable(step):
            got = step(side)
        elif isinstance(step[0], tuple):
            got = [side.run(*step[0], stdin=step[1])]
        else:
            got = [side.run(*step)]
        label = " ".join(step[0] if isinstance(step, tuple) and isinstance(
            step[0], tuple) else step if isinstance(step, tuple) else ())
        timed = any(t in label for t in TIMED)
        out += [(rc, side.norm(text, timed)) for rc, text in got]
    return out


@pytest.mark.parametrize("name,steps", STEPS, ids=[n for n, _ in STEPS])
def test_etcdctl_command_matches_the_reference(sides, name, steps):
    ref = _outputs(sides["ref"], steps)
    port = _outputs(sides["port"], steps)
    if name in DIFFERENT:
        ref, port = DIFFERENT[name](ref), DIFFERENT[name](port)
    assert port == ref
    assert all(rc == 0 for rc, _ in ref[:1]), ref


TXN_LINES = [
    ['mod("a") > "5"', 'create("b") = "0"', "", "put k v with spaces",
     "del x", "", "get y"],
    ['value("k") != "v"', 'version("k") < "3"', "", "get k --prefix", "",
     "put k2 v2"],
    ["", "del a --prefix", "put b c", "", ""],
    ['lease("k") = "1234"', "", "", "get k"],
    ['bad("k") = "1"', "", "put k v"],
]


def _parsed(parse, lines):
    try:
        return plain(parse(lines))
    except Exception as e:  # noqa: BLE001 — the refusal is compared too
        return type(e).__name__, str(e)


@pytest.mark.parametrize("lines", TXN_LINES)
def test_parse_txn_gives_equal_requests(lines):
    """Equal requests, or the same refusal."""
    assert _parsed(tparse_txn, lines) == _parsed(rparse_txn, lines)
