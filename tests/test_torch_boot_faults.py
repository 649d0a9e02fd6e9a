"""Booted port members where a member's configuration lags its cluster
(ROADMAP C20): a leader or a vote that the configuration does not name.

- A three-member follower behind a remove and an add (embedded members,
  as ``python -m etcd_tpu_torch`` runs them): the follower is stopped
  while a fourth member joins, a third leaves and the lead moves to the
  newcomer; booted again on its data dir, it takes the new leader, whom
  its configuration does not name, and applies its log.
- A restarted member whose WAL vote names a member outside its
  configuration boots, and serves what it held.

Both need a device slot for a member the configuration does not hold
while every boot peer holds one; embed provisions one spare slot
(``replica_capacity`` = peers + 1).
"""

import time

from etcd_tpu_torch.embed.config import member_id_from_urls
from etcd_tpu_torch.raft.types import HardState
from etcd_tpu_torch.storage.wal import WAL
from etcd_tpu_torch.tools.member_procs import TOKEN, MemberCluster, free_ports


def _wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if pred():
                return
        except Exception:  # noqa: BLE001 — electing or catching up
            pass
        time.sleep(0.2)
    raise AssertionError(f"never {what}")


def _call(p, fn):
    cl = p.client(timeout=10.0)
    try:
        return fn(cl)
    finally:
        cl.close()


def _serial_get(p, key):
    rr = _call(p, lambda cl: cl.get(key, serializable=True))
    return [kv.value for kv in rr.kvs]


def test_a_follower_behind_a_remove_and_an_add_takes_the_new_leader(
        tmp_path):
    from etcd_tpu_torch.client import Client
    from etcd_tpu_torch.embed import Config, start_etcd

    ports = free_ports(8)
    names = ("a", "b", "c", "d")
    urls = {nm: f"http://127.0.0.1:{ports[2 * i]}"
            for i, nm in enumerate(names)}
    ids = {nm: member_id_from_urls(urls[nm], TOKEN) for nm in names}
    initial = ",".join(f"{nm}={urls[nm]}" for nm in names[:3])

    def config(nm, **kw):
        i = names.index(nm)
        return Config(name=nm, data_dir=str(tmp_path / nm),
                      initial_cluster=initial, listen_peer_urls=urls[nm],
                      listen_client_urls=f"http://127.0.0.1:{ports[2 * i + 1]}",
                      device="cpu", **kw)

    def call(nm, fn):
        cl = Client([("127.0.0.1", ports[2 * names.index(nm) + 1])],
                    request_timeout=10.0)
        try:
            return fn(cl)
        finally:
            cl.close()

    def get(nm, key):
        rr = call(nm, lambda cl: cl.get(key, serializable=True))
        return [kv.value for kv in rr.kvs]

    def leader():
        return next(nm for nm, e in members.items() if e.server.is_leader())

    members = {nm: start_etcd(config(nm)) for nm in names[:3]}
    try:
        _wait(lambda: any(e.server.is_leader() for e in members.values()),
              "led")
        lead = leader()
        follower, leaver = [nm for nm in names[:3] if nm != lead]
        call(lead, lambda cl: cl.put(b"before", b"b"))
        _wait(lambda: get(follower, b"before") == [b"b"], "replicated")
        members.pop(follower).close()
        # A member joins, as etcd's runtime reconfiguration adds one: the
        # add, then the new member on the existing cluster. Neither
        # package's server adds a peer to its transport on an add, nor
        # does a joiner fetch the cluster's id from its peers (embed
        # hashes its own initial cluster), so the test does both.
        call(lead, lambda cl: cl.member_add(ids["d"], "d", [urls["d"]]))
        for e in members.values():
            e.transport.add_peer(ids["d"], ("127.0.0.1", ports[6]))
        initial += f",d={urls['d']}"
        members["d"] = start_etcd(config(
            "d", initial_cluster_state="existing"))
        members["d"].transport.cluster_id = members[lead].transport.cluster_id
        _wait(lambda: get("d", b"before") == [b"b"], "caught up at d")
        call(lead, lambda cl: cl.member_remove(ids[leaver]))
        members.pop(leaver).close()
        _wait(lambda: call(lead, lambda cl: cl.move_leader(ids["d"]))
              is None and members["d"].server.is_leader(), "led by d")
        for i in range(12):
            call("d", lambda cl: cl.put(b"after/%02d" % i, b"%d" % i))
        # The follower boots again from its data dir: its configuration
        # names the leaver and not d, and the boot peers hold every one
        # of its boot slots. d's messages reach its node through the
        # spare slot.
        initial = ",".join(f"{nm}={urls[nm]}" for nm in names[:3])
        members[follower] = start_etcd(config(follower))
        members[follower].transport.add_peer(ids["d"], ("127.0.0.1", ports[6]))
        _wait(lambda: get(follower, b"after/11") == [b"11"],
              "applied d's log at the follower")
        node = members[follower].server.node
        assert node.slot_map.slot(ids["d"]) == 3
        got = {m["id"] for m in call(follower, lambda cl: cl.member_list())}
        assert got == {ids[lead], ids[follower], ids["d"]}
        # A linearizable read at the follower asks its new leader.
        rr = call(follower, lambda cl: cl.get(b"after/", b"after0"))
        assert len(rr.kvs) == 12
    finally:
        for e in members.values():
            e.close()


def test_a_restarted_vote_outside_the_configuration_boots(tmp_path):
    c = MemberCluster(str(tmp_path), n=1, device="cpu")
    c.start()
    try:
        (p,) = c.procs
        _wait(lambda: _call(p, lambda cl: cl.status()["is_leader"]), "led")
        _call(p, lambda cl: cl.put(b"kept", b"k"))
        p.stop()
        # The WAL's last HardState: a vote, in a later term, for a member
        # that its configuration does not name (a candidate whose add
        # this member had not applied).
        wal_dir = tmp_path / "m0" / f"member-{p.member_id}" / "wal"
        w = WAL.open(str(wal_dir))
        try:
            _meta, hs, _ents = w.read_all()
            w.save(HardState(term=hs.term + 1, vote=0x1C0FFEE5EED5,
                             commit=hs.commit), [], True)
        finally:
            w.close()
        p.start()
        p.wait_ready()
        _wait(lambda: _call(p, lambda cl: cl.status()["is_leader"]),
              "led after the restart")
        assert _serial_get(p, b"kept") == [b"k"]
        _call(p, lambda cl: cl.put(b"again", b"a"))
        assert _serial_get(p, b"again") == [b"a"]
    finally:
        c.close()
