"""PyTorch port ↔ JAX reference: the lessor, auth and the v2 store.

Each test feeds one seeded numpy op stream into ``etcd_tpu``'s object
and the port's, each over its own backend in a temporary directory, on
one injected clock (each module's ``time`` is replaced by a clock the
test advances), and compares after every op the result or the class of
the error raised, then the object's whole visible state. Exact equality:
everything compared is ints, strings, bytes or structures of them.

- Lessor: grant (below the minimum TTL too), attach, detach, renew,
  checkpoint, revoke (the keys it deletes), promote, demote, the clock
  advanced past expiries, the expired leases surfaced, and a restart
  that recovers the leases from the backend.
- Auth: users (with and without passwords), roles, permissions on keys
  and ranges, grants and revokes, enable and disable, authenticate with
  HMAC and JWT tokens on fixed keys (the tokens themselves are equal),
  token checks across expiry, put/range/delete/admin permission checks,
  and a restart that recovers the store.
- v2 store: set, create (unique too), update, compare-and-swap,
  compare-and-delete, delete (recursive), get (recursive, sorted), TTLs
  expiring on the clock, and save/recovery into a fresh store.
"""

import numpy as np
import pytest

from etcd_tpu.auth import hmac_token as jhmac
from etcd_tpu.auth import jwt_token as jjwt
from etcd_tpu.auth import store as jauth
from etcd_tpu.lease import lessor as jlessor
from etcd_tpu.storage import backend as jbk
from etcd_tpu.v2store import store as jv2
from etcd_tpu_torch.auth import hmac_token as thmac
from etcd_tpu_torch.auth import jwt_token as tjwt
from etcd_tpu_torch.auth import store as tauth
from etcd_tpu_torch.lease import lessor as tlessor
from etcd_tpu_torch.storage import backend as tbk
from etcd_tpu_torch.v2store import store as tv2
from etcd_tpu_torch.tools.server_script import plain

from .test_torch_mvcc import _outcome

SEED = 20261017


class Clock:
    """Stands in for the `time` module of the modules under test."""

    def __init__(self, t0: float = 1_800_000_000.0):
        self.now = t0

    def monotonic(self) -> float:
        return self.now

    def time(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for mod in (jlessor, tlessor, jhmac, thmac, jjwt, tjwt, jv2, tv2):
        monkeypatch.setattr(mod, "time", c)
    return c


# -- lessor -----------------------------------------------------------------------


class Deleter:
    def __init__(self, log):
        self.log = log

    def delete_range(self, key, end):
        self.log.append((key, end))

    def end(self):
        self.log.append("end")


class LessorSide:
    def __init__(self, pkg_bk, pkg_lessor, path):
        self.bk, self.mod, self.path = pkg_bk, pkg_lessor, path
        self.deleted = []
        self.checkpoints = []
        self.open()

    def open(self):
        self.be = self.bk.Backend(self.path, batch_interval=10.0)
        # The loop never runs: expiry is driven by the test.
        self.le = self.mod.Lessor(self.be, min_lease_ttl=3,
                                  checkpoint_interval=5.0,
                                  loop_interval=3600.0)
        self.le.range_deleter = lambda: Deleter(self.deleted)
        self.le.checkpointer = lambda lid, rem: self.checkpoints.append(
            (lid, rem))

    def restart(self):
        self.le.stop()
        self.be.force_commit()
        self.be.close()
        self.open()

    def state(self):
        self.le._revoke_expired()
        expired = sorted(l.id for l in self.le.expired_leases(timeout=0))
        return {
            "leases": [(l.id, l.ttl, l.remaining_ttl, sorted(l.keys()),
                        round(l.remaining(), 6)) for l in self.le.leases()],
            "primary": self.le.is_primary(), "expired": expired,
            "deleted": list(self.deleted), "checkpoints": self.checkpoints}

    def close(self):
        self.le.stop()
        self.be.close()


def lessor_ops(seed, n):
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n):
        r = rng.rand()
        lid = 100 + int(rng.randint(12))
        if r < 0.22:
            ops.append(("grant", lid, int(rng.randint(1, 20))))
        elif r < 0.37:
            ops.append(("attach", lid, [b"k%d" % int(rng.randint(10))
                                         for _ in range(int(rng.randint(1, 3)))]))
        elif r < 0.42:
            ops.append(("detach", lid, [b"k%d" % int(rng.randint(10))]))
        elif r < 0.52:
            ops.append(("renew", lid, None))
        elif r < 0.57:
            ops.append(("checkpoint", lid, int(rng.randint(0, 15))))
        elif r < 0.65:
            ops.append(("revoke", lid, None))
        elif r < 0.70:
            ops.append(("promote", float(rng.randint(0, 4)), None))
        elif r < 0.73:
            ops.append(("demote", None, None))
        elif r < 0.96:
            ops.append(("advance", float(rng.randint(1, 6)), None))
        else:
            ops.append(("restart", None, None))
    return ops


def lessor_apply(side, op):
    kind, a, b = op
    le = side.le
    if kind == "grant":
        return _outcome(lambda: (lambda l: (l.id, l.ttl))(le.grant(a, b)))
    if kind == "attach":
        return _outcome(lambda: le.attach(a, b))
    if kind == "detach":
        return _outcome(lambda: le.detach(a, b))
    if kind == "renew":
        return _outcome(lambda: le.renew(a))
    if kind == "checkpoint":
        return _outcome(lambda: le.checkpoint(a, b))
    if kind == "revoke":
        return _outcome(lambda: le.revoke(a))
    if kind == "promote":
        return _outcome(lambda: le.promote(extend=a))
    if kind == "demote":
        return _outcome(le.demote)
    if kind == "advance":
        return None  # the clock is shared: the test advances it once
    side.restart()
    return None


def test_lessor_op_stream_equal(tmp_path, clock):
    j = LessorSide(jbk, jlessor, str(tmp_path / "j.db"))
    t = LessorSide(tbk, tlessor, str(tmp_path / "t.db"))
    seen = set()
    try:
        for i, op in enumerate(lessor_ops(SEED, 500)):
            a, b = lessor_apply(j, op), lessor_apply(t, op)
            if op[0] == "advance":
                clock.advance(op[1])
            assert a == b, (i, op, a, b)
            sj, st = j.state(), t.state()
            assert sj == st, (i, op, sj, st)
            seen.add(op[0] if not (isinstance(b, tuple) and b[0] == "error")
                     else b[1])
            if st["expired"]:
                seen.add("expired")
    finally:
        j.close()
        t.close()
    for k in ("grant", "attach", "renew", "revoke", "checkpoint", "promote",
              "restart", "expired", "LeaseNotFoundError", "NotPrimaryError"):
        assert k in seen, (k, seen)


# -- auth -------------------------------------------------------------------------

USERS = ("root", "alice", "bob", "carol")
ROLES = ("root", "reader", "writer")


def auth_ops(seed, n):
    rng = np.random.RandomState(seed)
    ops = [("user_add", "root", "rootpw"), ("role_add", "root", None),
           ("user_grant_role", "root", "root")]
    for _ in range(n):
        r = rng.rand()
        user = USERS[int(rng.randint(len(USERS)))]
        role = ROLES[int(rng.randint(len(ROLES)))]
        if r < 0.10:
            ops.append(("user_add", user, "" if rng.rand() < 0.2 else
                        user + "pw"))
        elif r < 0.13:
            ops.append(("user_delete", USERS[1 + int(rng.randint(3))], None))
        elif r < 0.16:
            ops.append(("user_change_password", user, user + "pw2"))
        elif r < 0.25:
            ops.append(("user_grant_role", user, role))
        elif r < 0.28:
            ops.append(("user_revoke_role", user, role))
        elif r < 0.33:
            ops.append(("role_add", role, None))
        elif r < 0.35:
            ops.append(("role_delete", ROLES[1 + int(rng.randint(2))], None))
        elif r < 0.45:
            a = int(rng.randint(8))
            end = b"" if rng.rand() < 0.5 else b"k%d" % (a + int(
                rng.randint(1, 4)))
            ops.append(("role_grant_permission", role,
                        (int(rng.randint(3)), b"k%d" % a, end)))
        elif r < 0.48:
            ops.append(("role_revoke_permission", role,
                        (b"k%d" % int(rng.randint(8)), b"")))
        elif r < 0.54:
            ops.append(("auth_enable", None, None))
        elif r < 0.55:
            ops.append(("auth_disable", None, None))
        elif r < 0.66:
            ops.append(("authenticate", user,
                        user + ("pw" if rng.rand() < 0.8 else "bad")))
        elif r < 0.74:
            ops.append(("check_token", int(rng.randint(4)), None))
        elif r < 0.92:
            a = int(rng.randint(8))
            ops.append(("permitted", user,
                        (("put", "range", "delete", "admin")[int(
                            rng.randint(4))], b"k%d" % a,
                         b"" if rng.rand() < 0.6 else b"k%d" % (a + 2))))
        elif r < 0.97:
            ops.append(("advance", float(rng.randint(10, 200)), None))
        else:
            ops.append(("restart", None, None))
    return ops


class AuthSide:
    def __init__(self, bk, auth, hmac_mod, jwt_mod, path, provider):
        self.bk, self.auth, self.path = bk, auth, path
        self.make_tp = (lambda: hmac_mod.HMACTokenProvider(
            b"fixed-key", ttl=120.0)) if provider == "hmac" else (
            lambda: jwt_mod.JWTTokenProvider(b"fixed-key", ttl=120.0))
        self.tokens = []
        self.open()

    def open(self):
        self.be = self.bk.Backend(self.path, batch_interval=10.0)
        self.st = self.auth.AuthStore(self.be, token_provider=self.make_tp(),
                                      pbkdf2_iters=1000)

    def restart(self):
        self.be.force_commit()
        self.be.close()
        self.open()

    def apply(self, op):
        kind, a, b = op
        st = self.st
        if kind in ("user_add", "user_change_password", "user_grant_role",
                    "user_revoke_role"):
            if kind == "user_add":
                return _outcome(lambda: st.user_add(a, b, no_password=not b))
            return _outcome(lambda: getattr(st, kind)(a, b))
        if kind in ("user_delete", "role_add", "role_delete"):
            return _outcome(lambda: getattr(st, kind)(a))
        if kind == "role_grant_permission":
            perm = self.auth.Permission(
                perm_type=self.auth.PermissionType(b[0]), key=b[1],
                range_end=b[2])
            return _outcome(lambda: st.role_grant_permission(a, perm))
        if kind == "role_revoke_permission":
            return _outcome(lambda: st.role_revoke_permission(a, *b))
        if kind in ("auth_enable", "auth_disable"):
            return _outcome(getattr(st, kind))
        if kind == "authenticate":
            def auth():
                tok = st.authenticate(a, b)
                self.tokens.append(tok)
                return tok
            return _outcome(auth)
        if kind == "check_token":
            if not self.tokens:
                return None
            tok = self.tokens[-1 - a % len(self.tokens)]
            return _outcome(lambda: st.auth_info_from_token(tok))
        if kind == "permitted":
            check, key, end = b
            info = self.auth.AuthInfo(username=a, revision=st.revision())
            if check == "put":
                return _outcome(lambda: st.is_put_permitted(info, key))
            if check == "admin":
                return _outcome(lambda: st.is_admin_permitted(info))
            fn = (st.is_range_permitted if check == "range"
                  else st.is_delete_range_permitted)
            return _outcome(lambda: fn(info, key, end))
        if kind == "restart":
            self.restart()
        return None

    def state(self):
        st = self.st
        users = {}
        for name in st.user_list():
            u = st.user_get(name)
            users[name] = (sorted(u.roles), u.no_password)
        roles = {name: plain(st.role_get(name)) for name in st.role_list()}
        return {"enabled": st.is_auth_enabled(), "revision": st.revision(),
                "users": users, "roles": roles}

    def close(self):
        self.be.close()


@pytest.mark.parametrize("provider", ["hmac", "jwt"])
def test_auth_op_stream_equal(tmp_path, clock, provider):
    j = AuthSide(jbk, jauth, jhmac, jjwt, str(tmp_path / "j.db"), provider)
    t = AuthSide(tbk, tauth, thmac, tjwt, str(tmp_path / "t.db"), provider)
    seen = set()
    try:
        for i, op in enumerate(auth_ops(SEED, 400)):
            if op[0] == "advance":
                clock.advance(op[1])
                continue
            a, b = j.apply(op), t.apply(op)
            assert a == b, (i, op, a, b)
            assert j.state() == t.state(), (i, op)
            seen.add(op[0] if not (isinstance(b, tuple) and b[0] == "error")
                     else b[1])
    finally:
        j.close()
        t.close()
    assert j.tokens == t.tokens and len(t.tokens) > 5
    for k in ("authenticate", "check_token", "permitted", "restart",
              "auth_enable", "PermissionDeniedError", "InvalidAuthTokenError",
              "AuthFailedError"):
        assert k in seen, (k, seen)


# -- v2 store ---------------------------------------------------------------------


def v2_ops(seed, n):
    rng = np.random.RandomState(seed)
    paths = ["/a", "/a/b", "/a/c", "/d", "/d/e/f", "/g"]
    ops = []
    for _ in range(n):
        r = rng.rand()
        p = paths[int(rng.randint(len(paths)))]
        ttl = float(rng.randint(1, 30)) if rng.rand() < 0.3 else None
        v = "v%d" % int(rng.randint(3))
        leaf = ("/a/b", "/a/c", "/d/e/f", "/g")[int(rng.randint(4))]
        if r < 0.22:
            ops.append(("set", p, (v, ttl, bool(rng.rand() < 0.1))))
        elif r < 0.30:
            ops.append(("create", p, (v, ttl, bool(rng.rand() < 0.3))))
        elif r < 0.37:
            ops.append(("update", p, (v, ttl)))
        elif r < 0.50:
            ops.append(("cas", leaf, (v, 0, "v%d" % int(rng.randint(3)), ttl)
                        if rng.rand() < 0.7 else
                        (None, int(rng.randint(0, 20)), "n" + v, ttl)))
        elif r < 0.56:
            ops.append(("cad", leaf, (v, 0) if rng.rand() < 0.7 else
                        (None, int(rng.randint(0, 20)))))
        elif r < 0.64:
            ops.append(("delete", p, bool(rng.rand() < 0.5)))
        elif r < 0.82:
            ops.append(("get", p, bool(rng.rand() < 0.5)))
        elif r < 0.97:
            ops.append(("advance", float(rng.randint(1, 10)), None))
        else:
            ops.append(("recover", None, None))
    return ops


def v2_apply(mod, holder, op):
    kind, p, a = op
    st = holder[0]
    if kind == "set":
        return _outcome(lambda: st.set(p, dir_=a[2], value=a[0], ttl=a[1]))
    if kind == "create":
        return _outcome(lambda: st.create(p, value=a[0], ttl=a[1],
                                          unique=a[2]))
    if kind == "update":
        return _outcome(lambda: st.update(p, value=a[0], ttl=a[1]))
    if kind == "cas":
        return _outcome(lambda: st.compare_and_swap(p, a[0], a[1], a[2],
                                                    ttl=a[3]))
    if kind == "cad":
        return _outcome(lambda: st.compare_and_delete(p, a[0], a[1]))
    if kind == "delete":
        return _outcome(lambda: st.delete(p, recursive=a, dir_=a))
    if kind == "get":
        return _outcome(lambda: st.get(p, recursive=a, sorted_=True))
    if kind == "recover":
        blob = st.save()
        fresh = mod.V2Store()
        fresh.recovery(blob)
        holder[0] = fresh
        return blob
    return None


def test_v2store_op_stream_equal(clock):
    j, t = [jv2.V2Store()], [tv2.V2Store()]
    seen = set()
    before = t[0].save()
    for i, op in enumerate(v2_ops(SEED, 500)):
        if op[0] == "advance":
            clock.advance(op[1])
            a = plain(j[0].delete_expired_keys())
            b = plain(t[0].delete_expired_keys())
        else:
            a, b = v2_apply(jv2, j, op), v2_apply(tv2, t, op)
        assert a == b, (i, op, a, b)
        # The whole tree, with each node's indexes and expiry.
        after = t[0].save()
        assert j[0].save() == after, i
        seen.add(op[0] if not (isinstance(b, tuple) and b[0] == "error")
                 else b[1])
        if op[0] == "advance" and after != before:
            seen.add("expired")
        before = after
    for k in ("set", "create", "cas", "cad", "delete", "get", "recover",
              "expired", "V2Error"):
        assert k in seen, (k, seen)
