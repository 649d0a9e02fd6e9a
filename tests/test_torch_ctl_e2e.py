"""tests/e2e/test_ctl_more.py's flows with the port's etcdctl: each
command a ``python -m etcd_tpu_torch.etcdctl`` process of its own,
against three port member processes on ``"tpu"`` (``--device cpu``
here) from ``tools/member_procs.MemberCluster``, one cluster for the
file: a watch that sees another process's put; a lease granted,
attached, read with its keys and revoked; ``member list`` with etcd's
member ids; ``move-leader``; an election and its listener; a contended
lock, a lock whose command cannot start (kept to its lease's TTL) and
one whose command's exit code comes back; compaction and defrag at
every member.
"""

import json
import re
import sys
import time

import pytest

from etcd_tpu_torch.tools.member_procs import MemberCluster, etcdctl
from etcd_tpu_torch.tools.member_procs import etcdctl_popen as ctl_popen


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = MemberCluster(str(tmp_path_factory.mktemp("ctl-e2e")), device="cpu")
    c.start()
    yield c
    c.close()


def test_watch_streams_put_event(cluster):
    """ref: ctl_v3_watch_test.go — a watching CLI process receives the
    PUT made by another CLI process."""
    eps = cluster.endpoints()
    w = ctl_popen(eps, "watch", "wkey", "--max-events", "1")
    try:
        time.sleep(1.0)  # let the watch establish
        rc, _out, err = etcdctl(eps, "put", "wkey", "wval")
        assert rc == 0, err
        out, _ = w.communicate(timeout=30)
        assert "PUT" in out and "wkey" in out and "wval" in out
    finally:
        if w.poll() is None:
            w.kill()


def test_lease_grant_ttl_revoke(cluster):
    """ref: ctl_v3_lease_test.go — grant, attach via put --lease,
    timetolive --keys, revoke deletes the key."""
    eps = cluster.endpoints()
    rc, out, err = etcdctl(eps, "lease", "grant", "300")
    assert rc == 0, err
    m = re.search(r"lease ([0-9a-f]+) granted with TTL\(300s\)", out)
    assert m, out
    lid = m.group(1)

    rc, _out, err = etcdctl(eps, "put", "lk", "lv", "--lease", lid)
    assert rc == 0, err
    rc, out, _ = etcdctl(eps, "lease", "timetolive", lid, "--keys")
    assert rc == 0 and "attached keys" in out and "lk" in out

    rc, out, _ = etcdctl(eps, "lease", "revoke", lid)
    assert rc == 0 and "revoked" in out
    rc, out, _ = etcdctl(eps, "get", "lk")
    assert rc == 0 and out.strip() == ""
    rc, out, _ = etcdctl(eps, "lease", "timetolive", lid)
    assert rc == 0 and "already expired" in out


def test_member_list(cluster):
    """ref: ctl_v3_member_test.go memberListTest."""
    rc, out, err = etcdctl(cluster.endpoints(), "-w", "json",
                           "member", "list")
    assert rc == 0, err
    data = json.loads(out)
    members = data.get("members", data)
    assert len(members) == 3
    # etcd's 64-bit ids, hashed from the peer URLs.
    assert {m["ID"] if "ID" in m else m["id"] for m in members} == {
        p.member_id for p in cluster.procs}


def _leader_and_follower(cluster):
    leader = follower = None
    for p in cluster.procs:
        rc, out, _ = etcdctl(p.endpoint, "-w", "json",
                             "endpoint", "status")
        if rc != 0:
            continue
        st = json.loads(out)[0]["Status"]
        if st["is_leader"]:
            leader = (p, st["member_id"])
        else:
            follower = (p, st["member_id"])
    return leader, follower


def test_move_leader(cluster):
    """ref: ctl_v3_move_leader_test.go — leadership transfers to the
    requested member."""
    leader, follower = _leader_and_follower(cluster)
    assert leader and follower
    rc, out, err = etcdctl(
        leader[0].endpoint,
        "move-leader", f"{follower[1]:x}",
    )
    assert rc == 0, err + out
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        new_leader, _ = _leader_and_follower(cluster)
        if new_leader and new_leader[1] == follower[1]:
            return
        time.sleep(0.5)
    pytest.fail("leadership did not move")


def test_elect_campaign_and_observe(cluster):
    """ref: ctl_v3_elect_test.go — a campaigner wins and an observer
    sees its proposal."""
    eps = cluster.endpoints()
    camp = ctl_popen(eps, "elect", "e2e-elect", "proposal-1",
                     "--hold-seconds", "30")
    try:
        deadline = time.monotonic() + 30
        ok = False
        while time.monotonic() < deadline and not ok:
            rc, out, _ = etcdctl(eps, "elect", "--listen", "e2e-elect",
                                 timeout=10)
            ok = rc == 0 and "proposal-1" in out
            if not ok:
                time.sleep(0.5)
        assert ok, "observer never saw the campaigned proposal"
    finally:
        camp.kill()


def test_lock_mutual_exclusion(cluster):
    """ref: ctl_v3_lock_test.go — a held lock blocks a second locker
    until released."""
    eps = cluster.endpoints()
    holder = ctl_popen(eps, "lock", "e2e-lock", "--hold-seconds", "20")
    try:
        # Wait until the holder prints its key (lock acquired).
        deadline = time.monotonic() + 30
        line = holder.stdout.readline()
        assert line.startswith("e2e-lock"), line
        # A second locker with a short timeout cannot acquire it.
        rc, out, err = etcdctl(eps, "--command-timeout", "3",
                               "lock", "e2e-lock", timeout=30)
        assert rc != 0, f"second locker acquired a held lock: {out}"
    finally:
        holder.kill()
    # After the holder dies (session lease revoked), locking succeeds.
    rc, out, err = etcdctl(eps, "--command-timeout", "30",
                           "lock", "e2e-lock", timeout=60)
    assert rc == 0, err


def test_lock_exec_crash_keeps_lease(cluster):
    """ref: lock_command.go — a holder whose exec'd command cannot even
    be spawned is a crash, not a release: the key stays locked until the
    session lease TTL expires (etcd releases crashed holders via lease
    expiry, not cleanup)."""
    eps = cluster.endpoints()
    t0 = time.monotonic()
    rc, _out, err = etcdctl(eps, "lock", "e2e-crashlock", "--ttl", "5",
                            "/nonexistent-binary-xyzzy", timeout=30)
    assert rc != 0, "spawn failure must exit nonzero"
    # Immediately after, the lock must still be held (lease alive).
    rc, out, _ = etcdctl(eps, "--command-timeout", "2",
                         "lock", "e2e-crashlock", timeout=20)
    waited = time.monotonic() - t0
    if waited < 4.5:
        assert rc != 0, (
            f"lock acquired {waited:.1f}s after crash — lease was revoked "
            f"instead of surviving to TTL: {out}")
    # Once the 5s TTL lapses the lock becomes acquirable.
    rc, out, err = etcdctl(eps, "--command-timeout", "30",
                           "lock", "e2e-crashlock", timeout=60)
    assert rc == 0, err


def test_lock_exec_runs_and_propagates_exit_code(cluster):
    """ref: lock_command.go:94-104 — a command that runs gets
    ETCD_LOCK_KEY in its env; its exit code is propagated and the lock
    is released immediately (unlock-before-return)."""
    eps = cluster.endpoints()
    rc, out, err = etcdctl(
        eps, "lock", "e2e-execlock", "--ttl", "30", "--", sys.executable,
        "-c", "import os,sys; sys.exit(7 if os.environ.get"
        "('ETCD_LOCK_KEY','').startswith('e2e-execlock') else 3)",
        timeout=60)
    assert rc == 7, (rc, out, err)
    # Unlocked immediately (no TTL wait): a fresh locker succeeds fast.
    rc, out, err = etcdctl(eps, "--command-timeout", "5",
                           "lock", "e2e-execlock", timeout=30)
    assert rc == 0, err


def test_compact_and_defrag(cluster):
    """ref: ctl_v3 compaction/defrag shapes — old revisions become
    unreadable with the canonical compacted error; defrag succeeds."""
    eps = cluster.endpoints()
    revs = []
    for i in range(3):
        rc, _o, _e = etcdctl(eps, "put", "ck", f"v{i}")
        assert rc == 0
    rc, out, _ = etcdctl(eps, "-w", "json", "get", "ck")
    assert rc == 0
    rev = json.loads(out)["header"]["revision"]
    rc, out, _ = etcdctl(eps, "compaction", str(rev))
    assert rc == 0 and f"compacted revision {rev}" in out
    rc, out, err = etcdctl(eps, "get", "ck", "--rev", str(rev - 2))
    assert rc != 0 and "compacted" in (out + err).lower()
    rc, out, _ = etcdctl(eps, "defrag")
    assert rc == 0 and out.count("Finished defragmenting") == 3
