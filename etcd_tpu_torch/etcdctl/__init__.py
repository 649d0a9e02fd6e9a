"""etcdctl: the command-line client (ref: etcdctl/ctlv3/ctl.go and
etcdctl/ctlv3/command/*.go — put/get/del/txn/watch/compaction, lease,
member, endpoint, snapshot, lock/elect, move-leader, defrag, alarm,
auth/user/role, check perf, make-mirror, version; output printers
simple/json/table per command/printer.go).

`python -m etcd_tpu_torch.etcdctl <cmd> ...`; `main(argv)` for in-proc use.

Ports ``etcd_tpu/etcdctl/__init__.py``. Its one difference: the
deprecation note of ``snapshot restore|status`` names the port's etcdutl.
Importing it loads no torch (nor does any client module it imports), so
a command's process starts without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import version as ver
from ..client.client import Client, ClientError
from ..client.util import prefix_end as _prefix_end
from ..server import api as sapi


class CtlError(Exception):
    pass


def _parse_endpoints(s: str) -> List[Tuple[str, int]]:
    out = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        if "://" in part:
            part = part.split("://", 1)[1]
        host, port = part.rsplit(":", 1)
        out.append((host, int(port)))
    if not out:
        raise CtlError("no endpoints")
    return out




# -- printers (etcdctl/ctlv3/command/printer*.go) ------------------------------


class Printer:
    def __init__(self, fmt: str, hex_: bool = False) -> None:
        self.fmt = fmt
        self.hex = hex_

    def _b(self, b: bytes) -> str:
        return b.hex() if self.hex else b.decode("utf-8", "replace")

    def _json(self, obj: Any) -> None:
        from ..v3rpc.wire import enc

        print(json.dumps(enc(obj) if not isinstance(obj, (dict, list)) else obj))

    def kv(self, kv: sapi.KeyValue, value_only: bool = False) -> None:
        if value_only:
            print(self._b(kv.value))
        else:
            print(self._b(kv.key))
            print(self._b(kv.value))

    def get(self, resp: sapi.RangeResponse, opts) -> None:
        if self.fmt == "json":
            self._json(resp)
            return
        if opts.count_only:
            print(resp.count)
            return
        if self.fmt == "fields":
            for kv in resp.kvs:
                print(f'"Key" : "{self._b(kv.key)}"')
                print(f'"CreateRevision" : {kv.create_revision}')
                print(f'"ModRevision" : {kv.mod_revision}')
                print(f'"Version" : {kv.version}')
                print(f'"Value" : "{self._b(kv.value)}"')
                print(f'"Lease" : {kv.lease}')
            return
        for kv in resp.kvs:
            if opts.keys_only:
                print(self._b(kv.key))
            else:
                self.kv(kv, value_only=opts.print_value_only)

    def put(self, resp: sapi.PutResponse) -> None:
        if self.fmt == "json":
            self._json(resp)
            return
        print("OK")
        if resp.prev_kv is not None:
            self.kv(resp.prev_kv)

    def delete(self, resp: sapi.DeleteRangeResponse) -> None:
        if self.fmt == "json":
            self._json(resp)
            return
        print(resp.deleted)
        for kv in resp.prev_kvs:
            self.kv(kv)

    def txn(self, resp: sapi.TxnResponse) -> None:
        if self.fmt == "json":
            self._json(resp)
            return
        print("SUCCEEDED" if resp.succeeded else "FAILURE")
        for op in resp.responses:
            if op.response_range is not None:
                self.get(op.response_range, argparse.Namespace(
                    count_only=False, keys_only=False, print_value_only=False
                ))
            elif op.response_put is not None:
                self.put(op.response_put)
            elif op.response_delete_range is not None:
                self.delete(op.response_delete_range)

    def members(self, members: List[Dict]) -> None:
        if self.fmt == "json":
            self._json({"members": members})
            return
        if self.fmt == "table":
            hdr = ["ID", "NAME", "PEER ADDRS", "IS LEARNER"]
            rows = [
                [f"{m.get('id', 0):x}", m.get("name", ""),
                 ",".join(m.get("peer_urls", [])),
                 str(bool(m.get("is_learner", False))).lower()]
                for m in members
            ]
            _table(hdr, rows)
            return
        for m in members:
            print(
                f"{m.get('id', 0):x}, started, {m.get('name', '')}, "
                f"{','.join(m.get('peer_urls', []))}, "
                f"{str(bool(m.get('is_learner', False))).lower()}"
            )

    def status(self, ep: str, st: Dict) -> None:
        if self.fmt == "json":
            self._json([{"Endpoint": ep, "Status": st}])
            return
        hdr = ["ENDPOINT", "ID", "IS LEADER", "RAFT TERM",
               "RAFT INDEX", "RAFT APPLIED INDEX", "DB SIZE"]
        rows = [[
            ep, f"{st.get('member_id', 0):x}",
            str(bool(st.get("is_leader", False))).lower(),
            str(st.get("raft_term", 0)), str(st.get("committed_index", 0)),
            str(st.get("applied_index", 0)), str(st.get("db_size", 0)),
        ]]
        _table(hdr, rows)


def _table(hdr: List[str], rows: List[List[str]]) -> None:
    widths = [
        max(len(hdr[i]), *(len(r[i]) for r in rows)) if rows else len(hdr[i])
        for i in range(len(hdr))
    ]

    def line(ch: str = "-", junction: str = "+") -> str:
        return junction + junction.join(ch * (w + 2) for w in widths) + junction

    def fmt_row(cells: List[str]) -> str:
        return "| " + " | ".join(
            c.ljust(w) for c, w in zip(cells, widths)
        ) + " |"

    print(line())
    print(fmt_row(hdr))
    print(line())
    for r in rows:
        print(fmt_row(r))
    print(line())


# -- txn grammar (etcdctl/ctlv3/command/txn_command.go) ------------------------


def parse_txn(lines: List[str]) -> sapi.TxnRequest:
    """Three blank-line-separated stanzas: compares, success ops,
    failure ops."""
    stanzas: List[List[str]] = [[]]
    for ln in lines:
        ln = ln.strip()
        if not ln:
            if stanzas[-1]:
                stanzas.append([])
            continue
        if ln.startswith(("compares:", "success requests", "failure requests")):
            continue
        stanzas[-1].append(ln)
    while stanzas and not stanzas[-1]:
        stanzas.pop()
    while len(stanzas) < 3:
        stanzas.append([])
    cmps, succ, fail = stanzas[0], stanzas[1], stanzas[2]
    return sapi.TxnRequest(
        compare=[_parse_compare(c) for c in cmps],
        success=[_parse_op(o) for o in succ],
        failure=[_parse_op(o) for o in fail],
    )


def _parse_compare(line: str) -> sapi.Compare:
    import re

    m = re.match(
        r'(value|version|mod|create|c_rev|m_rev|lease)\("([^"]*)"\)\s*'
        r"(=|!=|<|>)\s*\"?([^\"]*)\"?$",
        line,
    )
    if m is None:
        raise CtlError(f"bad compare: {line!r}")
    target_s, key, op_s, val = m.groups()
    target = {
        "value": sapi.CompareTarget.VALUE,
        "version": sapi.CompareTarget.VERSION,
        "create": sapi.CompareTarget.CREATE,
        "c_rev": sapi.CompareTarget.CREATE,
        "mod": sapi.CompareTarget.MOD,
        "m_rev": sapi.CompareTarget.MOD,
        "lease": sapi.CompareTarget.LEASE,
    }[target_s]
    result = {
        "=": sapi.CompareResult.EQUAL,
        "!=": sapi.CompareResult.NOT_EQUAL,
        "<": sapi.CompareResult.LESS,
        ">": sapi.CompareResult.GREATER,
    }[op_s]
    cmp = sapi.Compare(target=target, result=result, key=key.encode())
    if target == sapi.CompareTarget.VALUE:
        cmp.value = val.encode()
    elif target == sapi.CompareTarget.VERSION:
        cmp.version = int(val)
    elif target == sapi.CompareTarget.CREATE:
        cmp.create_revision = int(val)
    elif target == sapi.CompareTarget.MOD:
        cmp.mod_revision = int(val)
    elif target == sapi.CompareTarget.LEASE:
        cmp.lease = int(val)
    return cmp


def _parse_op(line: str) -> sapi.RequestOp:
    parts = line.split()
    if not parts:
        raise CtlError("empty op")
    cmd, args = parts[0], parts[1:]
    if cmd == "put" and len(args) >= 2:
        return sapi.RequestOp(
            request_put=sapi.PutRequest(
                key=args[0].encode(), value=" ".join(args[1:]).encode()
            )
        )
    if cmd == "get" and len(args) >= 1:
        end = args[1].encode() if len(args) > 1 else b""
        return sapi.RequestOp(
            request_range=sapi.RangeRequest(key=args[0].encode(), range_end=end)
        )
    if cmd == "del" and len(args) >= 1:
        end = args[1].encode() if len(args) > 1 else b""
        return sapi.RequestOp(
            request_delete_range=sapi.DeleteRangeRequest(
                key=args[0].encode(), range_end=end
            )
        )
    raise CtlError(f"bad op: {line!r}")


# -- command implementations ---------------------------------------------------


def _client(args) -> Client:
    tls_info = None
    if getattr(args, "cacert", "") or getattr(args, "cert", "") or \
            getattr(args, "insecure_skip_tls_verify", False):
        from ..pkg.tlsutil import TLSInfo

        tls_info = TLSInfo(
            trusted_ca_file=args.cacert,
            client_cert_file=args.cert,
            client_key_file=args.key,
            insecure_skip_verify=args.insecure_skip_tls_verify,
        )
    c = Client(
        _parse_endpoints(args.endpoints),
        request_timeout=args.command_timeout,
        tls_info=tls_info,
    )
    if args.user:
        if ":" in args.user:
            user, pw = args.user.split(":", 1)
        else:
            user, pw = args.user, args.password or ""
        c.authenticate(user, pw)
    return c


def _range_args(args) -> Tuple[bytes, Optional[bytes]]:
    key = args.key.encode()
    if getattr(args, "prefix", False):
        return key, _prefix_end(key)
    end = getattr(args, "range_end", None)
    return key, end.encode() if end else None


def cmd_put(args, pr: Printer) -> int:
    c = _client(args)
    try:
        resp = c.put(
            args.key.encode(), args.value.encode(),
            lease=int(args.lease, 16) if args.lease else 0,
            prev_kv=args.prev_kv,
        )
        pr.put(resp)
        return 0
    finally:
        c.close()


def cmd_get(args, pr: Printer) -> int:
    c = _client(args)
    try:
        key, end = _range_args(args)
        order = {
            "ASCEND": sapi.SortOrder.ASCEND, "DESCEND": sapi.SortOrder.DESCEND,
            "": sapi.SortOrder.NONE,
        }[args.order.upper() if args.order else ""]
        target = {
            "KEY": sapi.SortTarget.KEY, "VERSION": sapi.SortTarget.VERSION,
            "CREATE": sapi.SortTarget.CREATE, "MOD": sapi.SortTarget.MOD,
            "VALUE": sapi.SortTarget.VALUE,
        }[(args.sort_by or "KEY").upper()]
        resp = c.get(
            key, end, revision=args.rev, limit=args.limit,
            serializable=args.consistency == "s",
            count_only=args.count_only, keys_only=args.keys_only,
            sort_order=order, sort_target=target,
        )
        pr.get(resp, args)
        return 0
    finally:
        c.close()


def cmd_del(args, pr: Printer) -> int:
    c = _client(args)
    try:
        key, end = _range_args(args)
        resp = c.delete(key, end, prev_kv=args.prev_kv)
        pr.delete(resp)
        return 0
    finally:
        c.close()


def cmd_txn(args, pr: Printer, stdin=None) -> int:
    lines = (stdin or sys.stdin).read().splitlines()
    req = parse_txn(lines)
    c = _client(args)
    try:
        pr.txn(c.txn(req))
        return 0
    finally:
        c.close()


def cmd_compaction(args, pr: Printer) -> int:
    c = _client(args)
    try:
        c.compact(args.revision, physical=args.physical)
        print(f"compacted revision {args.revision}")
        return 0
    finally:
        c.close()


def cmd_watch(args, pr: Printer) -> int:
    c = _client(args)
    try:
        key, end = _range_args(args)
        h = c.watch(key, end, start_rev=args.rev)
        seen = 0
        while args.max_events <= 0 or seen < args.max_events:
            got = h.get(timeout=0.5)
            if got is None:
                continue
            _, events = got
            from ..storage.mvcc.kv import EventType

            for ev in events:
                name = "PUT" if ev.type == EventType.PUT else "DELETE"
                print(name)
                print(ev.kv.key.decode("utf-8", "replace"))
                if ev.type == EventType.PUT:
                    print(ev.kv.value.decode("utf-8", "replace"))
                seen += 1
                if 0 < args.max_events <= seen:
                    break
        h.cancel()
        return 0
    except KeyboardInterrupt:
        return 0
    finally:
        c.close()


def cmd_lease(args, pr: Printer) -> int:
    c = _client(args)
    try:
        if args.lease_cmd == "grant":
            r = c.lease_grant(args.ttl)
            print(f"lease {r.id:016x} granted with TTL({r.ttl}s)")
        elif args.lease_cmd == "revoke":
            c.lease_revoke(int(args.id, 16))
            print(f"lease {int(args.id, 16):016x} revoked")
        elif args.lease_cmd == "keep-alive":
            lid = int(args.id, 16)
            if args.once:
                ttl = c.lease_keep_alive_once(lid)
                print(f"lease {lid:016x} keepalived with TTL({ttl})")
            else:
                stop = c.lease_keep_alive(lid)
                try:
                    for _ in range(args.max_keepalives or 1 << 62):
                        time.sleep(0.5)
                except KeyboardInterrupt:
                    pass
                finally:
                    stop()
        elif args.lease_cmd == "timetolive":
            d = c.lease_time_to_live(int(args.id, 16), keys=args.keys)
            lid = int(args.id, 16)
            if d.get("ttl", -1) < 0:
                print(f"lease {lid:016x} already expired")
            else:
                msg = (
                    f"lease {lid:016x} granted with TTL({d['granted_ttl']}s), "
                    f"remaining({d['ttl']}s)"
                )
                if args.keys:
                    # The server reports attached keys as plain strings
                    # (LeaseItem.key).
                    ks = [k.decode("utf-8", "replace")
                          if isinstance(k, bytes) else k
                          for k in d.get("keys", [])]
                    msg += f", attached keys({ks})"
                print(msg)
        elif args.lease_cmd == "list":
            ids = c._request("LeaseLeases", {}).get("leases", [])
            print(f"found {len(ids)} leases")
            for lid in ids:
                print(f"{lid:016x}")
        return 0
    finally:
        c.close()


def cmd_member(args, pr: Printer) -> int:
    c = _client(args)
    try:
        if args.member_cmd == "list":
            pr.members(c.member_list())
        elif args.member_cmd == "add":
            peer_urls = args.peer_urls.split(",")
            from ..embed.config import member_id_from_urls

            # Token must match the cluster's --initial-cluster-token or
            # the booting member derives a different self-ID.
            mid = member_id_from_urls(args.peer_urls, args.cluster_token)
            members = c.member_add(
                mid, name=args.member_name, peer_urls=peer_urls,
                is_learner=args.learner,
            )
            print(f"Member {mid:x} added to cluster")
            pr.members(members)
        elif args.member_cmd == "remove":
            members = c.member_remove(int(args.id, 16))
            print(f"Member {int(args.id, 16):x} removed from cluster")
        elif args.member_cmd == "promote":
            c.member_promote(int(args.id, 16))
            print(f"Member {int(args.id, 16):x} promoted in cluster")
        return 0
    finally:
        c.close()


def cmd_endpoint(args, pr: Printer) -> int:
    eps = _parse_endpoints(args.endpoints)
    rc = 0
    for ep in eps:
        c = Client([ep], request_timeout=args.command_timeout)
        epname = f"{ep[0]}:{ep[1]}"
        try:
            if args.ep_cmd == "health":
                t0 = time.monotonic()
                c.get(b"health")
                dt = time.monotonic() - t0
                print(f"{epname} is healthy: successfully committed proposal: took = {dt * 1000:.6f}ms")
            elif args.ep_cmd == "status":
                pr.status(epname, c.status())
            elif args.ep_cmd == "hashkv":
                d = c.hash_kv(args.rev)
                print(f"{epname}, {d['hash']}, {d.get('compact_revision', 0)}")
        except Exception as e:  # noqa: BLE001
            print(f"{epname} is unhealthy: failed to commit proposal: {e}")
            rc = 1
        finally:
            c.close()
    return rc


def cmd_snapshot(args, pr: Printer) -> int:
    if args.snap_cmd == "save":
        c = _client(args)
        try:
            blob = c.snapshot()
            with open(args.file, "wb") as f:
                f.write(blob)
            print(f"Snapshot saved at {args.file}")
            return 0
        finally:
            c.close()
    print(
        "etcdctl snapshot restore/status are deprecated; "
        "use `python -m etcd_tpu_torch.etcdutl snapshot " + args.snap_cmd + "`",
        file=sys.stderr,
    )
    from ..etcdutl import main as utl_main

    rest = ["snapshot", args.snap_cmd, *args.rest]
    return utl_main(rest)


def cmd_alarm(args, pr: Printer) -> int:
    c = _client(args)
    try:
        if args.alarm_cmd == "list":
            resp = c.alarm(sapi.AlarmRequest(action=sapi.AlarmAction.GET))
        else:  # disarm
            resp = c.alarm(
                sapi.AlarmRequest(
                    action=sapi.AlarmAction.DEACTIVATE,
                    alarm=sapi.AlarmType.NONE, member_id=0,
                )
            )
        for am in resp.alarms:
            print(f"memberID:{am.member_id} alarm:{am.alarm.name}")
        return 0
    finally:
        c.close()


def cmd_auth(args, pr: Printer) -> int:
    c = _client(args)
    try:
        if args.auth_cmd == "enable":
            c.auth_enable()
            print("Authentication Enabled")
        elif args.auth_cmd == "disable":
            c.auth_disable()
            print("Authentication Disabled")
        elif args.auth_cmd == "status":
            d = c._request("AuthStatus", {})
            print(f"Authentication Status: {d.get('enabled', False)}")
            print(f"AuthRevision: {d.get('auth_revision', 0)}")
        return 0
    finally:
        c.close()


def cmd_user(args, pr: Printer) -> int:
    c = _client(args)
    try:
        if args.user_cmd == "add":
            name = args.name
            pw = args.new_user_password
            if pw is None and ":" in name:
                name, pw = name.split(":", 1)
            c.auth_op(sapi.AuthRequest(op="user_add", name=name, password=pw or ""))
            print(f"User {name} created")
        elif args.user_cmd == "delete":
            c.auth_op(sapi.AuthRequest(op="user_delete", name=args.name))
            print(f"User {args.name} deleted")
        elif args.user_cmd == "get":
            d = c._request("UserGet", {"name": args.name})
            print(f"User: {args.name}")
            print(f"Roles: {' '.join(d.get('roles', []))}")
        elif args.user_cmd == "list":
            for u in c._request("UserList", {}).get("users", []):
                print(u)
        elif args.user_cmd == "passwd":
            c.auth_op(
                sapi.AuthRequest(
                    op="user_change_password", name=args.name,
                    password=args.new_user_password or "",
                )
            )
            print("Password updated")
        elif args.user_cmd == "grant-role":
            c.auth_op(
                sapi.AuthRequest(op="user_grant_role", name=args.name, role=args.role)
            )
            print(f"Role {args.role} is granted to user {args.name}")
        elif args.user_cmd == "revoke-role":
            c.auth_op(
                sapi.AuthRequest(op="user_revoke_role", name=args.name, role=args.role)
            )
            print(f"Role {args.role} is revoked from user {args.name}")
        return 0
    finally:
        c.close()


def cmd_role(args, pr: Printer) -> int:
    c = _client(args)
    try:
        if args.role_cmd == "add":
            c.auth_op(sapi.AuthRequest(op="role_add", role=args.role))
            print(f"Role {args.role} created")
        elif args.role_cmd == "delete":
            c.auth_op(sapi.AuthRequest(op="role_delete", role=args.role))
            print(f"Role {args.role} deleted")
        elif args.role_cmd == "get":
            d = c._request("RoleGet", {"role": args.role})
            print(f"Role {args.role}")
            print("KV Read:")
            perms = d.get("perms", [])
            for p in perms:
                if p["type"] in (0, 2):
                    print(f"\t{bytes.fromhex(p['key']).decode('utf-8', 'replace')}")
            print("KV Write:")
            for p in perms:
                if p["type"] in (1, 2):
                    print(f"\t{bytes.fromhex(p['key']).decode('utf-8', 'replace')}")
        elif args.role_cmd == "list":
            for r in c._request("RoleList", {}).get("roles", []):
                print(r)
        elif args.role_cmd == "grant-permission":
            key = args.key.encode()
            end = b""
            if args.prefix:
                end = _prefix_end(key)
            elif args.range_end:
                end = args.range_end.encode()
            ptype = {"read": 0, "write": 1, "readwrite": 2}[args.perm_type]
            c.auth_op(
                sapi.AuthRequest(
                    op="role_grant_permission", role=args.role,
                    perm_type=ptype, key=key, range_end=end,
                )
            )
            print(f"Role {args.role} updated")
        elif args.role_cmd == "revoke-permission":
            c.auth_op(
                sapi.AuthRequest(
                    op="role_revoke_permission", role=args.role,
                    key=args.key.encode(),
                    range_end=args.range_end.encode() if args.range_end else b"",
                )
            )
            print(f"Permission of key {args.key} is revoked from role {args.role}")
        return 0
    finally:
        c.close()


def _lock_pull_flags(args, raw_argv: Optional[List[str]] = None) -> None:
    """argparse.REMAINDER swallows everything after the lockname, so
    `lock name --ttl 5 cmd ...` lands the flags in exec_command.  Pull
    the lock command's own flags back out of the head of the remainder
    (the reference registers them on the command so position doesn't
    matter: etcdctl/ctlv3/command/lock_command.go).  Extraction stops at
    the first non-flag token — that token starts the exec command, whose
    own flags are passed through verbatim — or at a literal `--`.
    argparse strips a leading `--` out of the REMAINDER itself, so the
    raw argv is consulted to honor a `--` placed right before it."""
    spec = {"--ttl": ("ttl", int), "--hold-seconds": ("hold_seconds", float)}
    rest = list(args.exec_command or [])
    if (raw_argv and rest
            and raw_argv[-len(rest) - 1:] == ["--", *rest]):
        return  # user wrote `lock name -- cmd...`: all verbatim
    out: list = []
    i = 0
    while i < len(rest):
        tok = rest[i]
        if tok == "--":
            out.extend(rest[i + 1:])
            break
        hit = None
        for flag, (attr, conv) in spec.items():
            val = None
            if tok == flag:
                if i + 1 >= len(rest):
                    raise SystemExit(f"flag needs an argument: {flag}")
                val, step = rest[i + 1], 2
            elif tok.startswith(flag + "="):
                val, step = tok.split("=", 1)[1], 1
            if val is not None:
                try:
                    hit = (attr, conv(val), step)
                except ValueError:
                    raise SystemExit(
                        f"invalid argument {val!r} for {flag} flag")
                break
        if hit is None:
            out.extend(rest[i:])
            break
        setattr(args, hit[0], hit[1])
        i += hit[2]
    args.exec_command = out


def cmd_lock(args, pr: Printer) -> int:
    """Drives the server-side Lock/Unlock RPCs (v3lock.go) — the lock
    logic runs in the server, the CLI only owns the session lease."""
    from ..client.concurrency import Session

    _lock_pull_flags(args, getattr(args, "_raw_argv", None))
    c = _client(args)
    s = None
    try:
        s = Session(c, ttl=args.ttl)
        key = c.lock(args.lockname.encode(), s.lease_id,
                     timeout=args.command_timeout)
        print(key.decode("utf-8", "replace"), flush=True)
        if args.exec_command:
            import subprocess

            env = dict(os.environ)
            env["ETCD_LOCK_KEY"] = key.decode("utf-8", "replace")
            kvs = c.get(key).kvs
            env["ETCD_LOCK_REV"] = str(kvs[0].mod_revision if kvs else 0)
            try:
                rc = subprocess.call(args.exec_command, env=env)
            except KeyboardInterrupt:
                # Ordinary shutdown: release like the reference's
                # SIGINT path (lock_command.go:80-88,117).
                c.unlock(key)
                s.close()
                return 0
            except OSError as e:
                # Spawn failure is the crash analog: do NOT
                # unlock/revoke — the lock survives until the session
                # lease TTL expires (the reference releases a crashed
                # holder via lease expiry; deliberate divergence from
                # lock_command.go:99, which unlocks even on spawn
                # error, so a typo'd command cannot silently release a
                # lock another process may still believe it fenced).
                print(f"etcdctl lock: exec failed: {e}", file=sys.stderr)
                return 1
            # The command ran: unlock and propagate its exit code
            # (lock_command.go:94-104 unlocks before returning the
            # command's error; getExitCodeFromError keeps the code).
            c.unlock(key)
            s.close()
            return rc
        # Hold until interrupted (the reference blocks).
        try:
            time.sleep(args.hold_seconds)
        except KeyboardInterrupt:
            pass  # fall through to the ordinary-shutdown unlock
        c.unlock(key)
        s.close()
        return 0
    except KeyboardInterrupt:
        # Ctrl-C while still waiting to acquire: withdraw the claim by
        # revoking the session lease (its queued ownership key dies with
        # it), mirroring the reference's SIGINT context-cancel path.
        if s is not None:
            s.close()
        return 0
    finally:
        c.close()


def cmd_elect(args, pr: Printer) -> int:
    """Drives the server-side Campaign/Leader/Resign RPCs
    (v3election.go)."""
    from ..client.concurrency import Session

    c = _client(args)
    try:
        if args.listen:
            kv = c.election_leader(args.election.encode())
            print(kv.value.decode("utf-8", "replace"))
            return 0
        s = Session(c, ttl=args.ttl)
        leader = c.campaign(args.election.encode(), s.lease_id,
                            (args.proposal or "default").encode(),
                            timeout=args.command_timeout)
        print(bytes.fromhex(leader["key"]).decode("utf-8", "replace"))
        time.sleep(args.hold_seconds)
        c.resign(leader)
        s.close()
        return 0
    except KeyboardInterrupt:
        return 0
    finally:
        c.close()


def cmd_move_leader(args, pr: Printer) -> int:
    c = _client(args)
    try:
        target = int(args.target_id, 16)
        c.move_leader(target)
        print(f"Leadership transferred to {target:x}")
        return 0
    finally:
        c.close()


def cmd_defrag(args, pr: Printer) -> int:
    rc = 0
    for ep in _parse_endpoints(args.endpoints):
        c = Client([ep], request_timeout=args.command_timeout)
        try:
            c.defragment()
            print(f"Finished defragmenting etcd member[{ep[0]}:{ep[1]}]")
        except Exception as e:  # noqa: BLE001
            print(f"Failed to defragment etcd member[{ep[0]}:{ep[1]}] ({e})")
            rc = 1
        finally:
            c.close()
    return rc


def cmd_check_datascale(args, pr: Printer) -> int:
    """ref: etcdctl/ctlv3/command/check.go:297-440 check datascale —
    storage cost of holding a workload's keys (the reference reads RSS
    from /metrics; the backend db size is the in-repo analog)."""
    loads = {
        "s": 2000, "small": 2000,
        "m": 20000, "medium": 20000,
        "l": 200000, "large": 200000,
        "xl": 600000, "xLarge": 600000,
    }
    limit = loads.get(args.load)
    if limit is None:
        print(f"unknown load option {args.load!r}")
        return 2
    prefix = args.prefix.encode()
    c = _client(args)
    try:
        rr = c.get(prefix, range_end=_prefix_end(prefix), limit=1)
        if rr.kvs:
            print(f"prefix {args.prefix!r} has keys; delete them first")
            return 1
        size_before = c.status().get("db_size", 0)
        import random as _rand

        from ..pkg.report import Report

        rep = Report()
        val = b"x" * 512
        print(f"Start data scale check for work load "
              f"[{limit} key-value pairs, 1024 bytes per key-value].")
        t0 = time.monotonic()
        for _ in range(limit):
            k = prefix + _rand.getrandbits(63).to_bytes(8, "big").hex().encode()
            s = time.monotonic()
            try:
                c.put(k.ljust(len(prefix) + 512, b"0"), val)
                rep.results(time.monotonic() - s)
            except Exception as e:  # noqa: BLE001
                rep.results(time.monotonic() - s, e)
        dt = time.monotonic() - t0
        size_after = c.status().get("db_size", 0)
        dresp = c.delete(prefix, _prefix_end(prefix))
        if args.auto_compact and dresp.header.revision > 1:
            c.compact(dresp.header.revision, physical=True)
        if args.auto_defrag:
            c.defragment()
        st = rep.stats()
        used = max(0, size_after - size_before)
        pct = st.percentiles_ms
        verdict = "PASS:" if st.errors == 0 else f"FAIL: {st.errors} errors;"
        print(f"{verdict} Put {limit} kvs in {dt:.2f}s ({st.qps:.1f}/s), "
              f"p50 {pct.get('50', 0):.1f}ms, p99 {pct.get('99', 0):.1f}ms")
        print(f"Approximate backend bytes used : {used / 1024 / 1024:.2f} MB")
        return 0 if st.errors == 0 else 1
    finally:
        c.close()


def cmd_check_perf(args, pr: Printer) -> int:
    """ref: etcdctl/ctlv3/command/check.go checkPerf."""
    loads = {"s": (50, 1), "m": (200, 10), "l": (500, 50)}
    writes, clients = loads.get(args.load, loads["s"])
    if args.duration:
        # scale writes to the requested window at the same rate
        writes = max(writes, int(writes * args.duration / 10))
    c = _client(args)
    from ..pkg.report import Report

    rep = Report()
    t0 = time.monotonic()
    slow = 0
    for i in range(writes):
        s = time.monotonic()
        try:
            c.put(f"__check_perf__{i % 128}".encode(), b"x" * 100)
            dt_one = time.monotonic() - s
            rep.results(dt_one)
            if dt_one > 0.5:
                slow += 1
        except Exception as e:  # noqa: BLE001
            rep.results(time.monotonic() - s, e)
    dt = time.monotonic() - t0
    c.delete(b"__check_perf__", _prefix_end(b"__check_perf__"))
    c.close()
    st = rep.stats()
    print(f"{writes} writes in {dt:.2f}s ({st.qps:.1f}/s), "
          f"p50 {st.percentiles_ms['50']:.2f}ms, "
          f"p99 {st.percentiles_ms['99']:.2f}ms")
    ok = True
    if st.errors:
        print(f"FAIL: {st.errors} errors")
        ok = False
    if slow > writes * 0.05:
        print(f"FAIL: {slow} writes slower than 500ms")
        ok = False
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


def cmd_make_mirror(args, pr: Printer) -> int:
    from ..client.mirror import Syncer

    src = _client(args)
    dst = Client(_parse_endpoints(args.destination),
                 request_timeout=args.command_timeout)
    try:
        sy = Syncer(src, prefix=args.prefix.encode() if args.prefix else b"")
        count = sy.mirror_to(
            dst,
            dest_prefix=args.dest_prefix.encode() if args.dest_prefix else None,
            max_txns=args.max_txns,
        )
        print(count)
        return 0
    except KeyboardInterrupt:
        return 0
    finally:
        src.close()
        dst.close()


# -- argparse wiring -----------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="etcdctl")
    p.add_argument("--endpoints", default="127.0.0.1:2379")
    p.add_argument("-w", "--write-out", default="simple",
                   choices=["simple", "json", "table", "fields"])
    p.add_argument("--hex", action="store_true")
    p.add_argument("--user", default="")
    p.add_argument("--password", default="")
    p.add_argument("--dial-timeout", type=float, default=2.0)
    p.add_argument("--command-timeout", type=float, default=5.0)
    p.add_argument("--cacert", default="")
    p.add_argument("--cert", default="")
    p.add_argument("--key", default="")
    p.add_argument("--insecure-skip-tls-verify", action="store_true")
    sub = p.add_subparsers(dest="cmd")

    sp = sub.add_parser("put")
    sp.add_argument("key")
    sp.add_argument("value")
    sp.add_argument("--lease", default="")
    sp.add_argument("--prev-kv", action="store_true")

    sp = sub.add_parser("get")
    sp.add_argument("key")
    sp.add_argument("range_end", nargs="?", default=None)
    sp.add_argument("--prefix", action="store_true")
    sp.add_argument("--rev", type=int, default=0)
    sp.add_argument("--limit", type=int, default=0)
    sp.add_argument("--sort-by", dest="sort_by", default="")
    sp.add_argument("--order", default="")
    sp.add_argument("--consistency", default="l", choices=["l", "s"])
    sp.add_argument("--count-only", action="store_true")
    sp.add_argument("--keys-only", action="store_true")
    sp.add_argument("--print-value-only", action="store_true")

    sp = sub.add_parser("del")
    sp.add_argument("key")
    sp.add_argument("range_end", nargs="?", default=None)
    sp.add_argument("--prefix", action="store_true")
    sp.add_argument("--prev-kv", action="store_true")

    sub.add_parser("txn")

    sp = sub.add_parser("compaction")
    sp.add_argument("revision", type=int)
    sp.add_argument("--physical", action="store_true")

    sp = sub.add_parser("watch")
    sp.add_argument("key")
    sp.add_argument("range_end", nargs="?", default=None)
    sp.add_argument("--prefix", action="store_true")
    sp.add_argument("--rev", type=int, default=0)
    sp.add_argument("--max-events", type=int, default=0)  # 0 = forever

    sp = sub.add_parser("lease")
    lsub = sp.add_subparsers(dest="lease_cmd")
    x = lsub.add_parser("grant")
    x.add_argument("ttl", type=int)
    x = lsub.add_parser("revoke")
    x.add_argument("id")
    x = lsub.add_parser("keep-alive")
    x.add_argument("id")
    x.add_argument("--once", action="store_true")
    x.add_argument("--max-keepalives", type=int, default=0)
    x = lsub.add_parser("timetolive")
    x.add_argument("id")
    x.add_argument("--keys", action="store_true")
    lsub.add_parser("list")

    sp = sub.add_parser("member")
    msub = sp.add_subparsers(dest="member_cmd")
    msub.add_parser("list")
    x = msub.add_parser("add")
    x.add_argument("member_name")
    x.add_argument("--peer-urls", required=True)
    x.add_argument("--learner", action="store_true")
    x.add_argument("--cluster-token", default="etcd-cluster")
    x = msub.add_parser("remove")
    x.add_argument("id")
    x = msub.add_parser("promote")
    x.add_argument("id")

    sp = sub.add_parser("endpoint")
    esub = sp.add_subparsers(dest="ep_cmd")
    esub.add_parser("health")
    esub.add_parser("status")
    x = esub.add_parser("hashkv")
    x.add_argument("--rev", type=int, default=0)

    sp = sub.add_parser("snapshot")
    ssub = sp.add_subparsers(dest="snap_cmd")
    x = ssub.add_parser("save")
    x.add_argument("file")
    x = ssub.add_parser("restore")
    x.add_argument("rest", nargs=argparse.REMAINDER)
    x = ssub.add_parser("status")
    x.add_argument("rest", nargs=argparse.REMAINDER)

    sp = sub.add_parser("alarm")
    asub = sp.add_subparsers(dest="alarm_cmd")
    asub.add_parser("list")
    asub.add_parser("disarm")

    sp = sub.add_parser("auth")
    ausub = sp.add_subparsers(dest="auth_cmd")
    ausub.add_parser("enable")
    ausub.add_parser("disable")
    ausub.add_parser("status")

    sp = sub.add_parser("user")
    usub = sp.add_subparsers(dest="user_cmd")
    x = usub.add_parser("add")
    x.add_argument("name")
    x.add_argument("--new-user-password", default=None)
    x = usub.add_parser("delete")
    x.add_argument("name")
    x = usub.add_parser("get")
    x.add_argument("name")
    usub.add_parser("list")
    x = usub.add_parser("passwd")
    x.add_argument("name")
    x.add_argument("--new-user-password", default=None)
    x = usub.add_parser("grant-role")
    x.add_argument("name")
    x.add_argument("role")
    x = usub.add_parser("revoke-role")
    x.add_argument("name")
    x.add_argument("role")

    sp = sub.add_parser("role")
    rsub = sp.add_subparsers(dest="role_cmd")
    for c_ in ("add", "delete", "get"):
        x = rsub.add_parser(c_)
        x.add_argument("role")
    rsub.add_parser("list")
    x = rsub.add_parser("grant-permission")
    x.add_argument("role")
    x.add_argument("perm_type", choices=["read", "write", "readwrite"])
    x.add_argument("key")
    x.add_argument("range_end", nargs="?", default=None)
    x.add_argument("--prefix", action="store_true")
    x = rsub.add_parser("revoke-permission")
    x.add_argument("role")
    x.add_argument("key")
    x.add_argument("range_end", nargs="?", default=None)

    sp = sub.add_parser("lock")
    sp.add_argument("lockname")
    sp.add_argument("exec_command", nargs=argparse.REMAINDER)
    sp.add_argument("--ttl", type=int, default=10)
    sp.add_argument("--hold-seconds", type=float, default=0.0)

    sp = sub.add_parser("elect")
    sp.add_argument("election")
    sp.add_argument("proposal", nargs="?", default=None)
    sp.add_argument("--listen", "-l", action="store_true")
    sp.add_argument("--ttl", type=int, default=10)
    sp.add_argument("--hold-seconds", type=float, default=0.0)

    sp = sub.add_parser("move-leader")
    sp.add_argument("target_id")

    sub.add_parser("defrag")

    sp = sub.add_parser("check")
    csub = sp.add_subparsers(dest="check_cmd")
    x = csub.add_parser("perf")
    x.add_argument("--load", default="s", choices=["s", "m", "l"])
    x.add_argument("--duration", type=int, default=0)
    x = csub.add_parser("datascale")
    x.add_argument("--load", default="s")
    x.add_argument("--prefix", default="/etcdctl-check-datascale/")
    x.add_argument("--auto-compact", dest="auto_compact",
                   action="store_true")
    x.add_argument("--auto-defrag", dest="auto_defrag",
                   action="store_true")

    sp = sub.add_parser("make-mirror")
    sp.add_argument("destination")
    sp.add_argument("--prefix", default="")
    sp.add_argument("--dest-prefix", default="")
    sp.add_argument("--max-txns", type=int, default=0)  # 0 = run forever

    sub.add_parser("version")
    return p


_DISPATCH = {
    "put": cmd_put, "get": cmd_get, "del": cmd_del, "txn": cmd_txn,
    "compaction": cmd_compaction, "watch": cmd_watch, "lease": cmd_lease,
    "member": cmd_member, "endpoint": cmd_endpoint, "snapshot": cmd_snapshot,
    "alarm": cmd_alarm, "auth": cmd_auth, "user": cmd_user, "role": cmd_role,
    "lock": cmd_lock, "elect": cmd_elect, "move-leader": cmd_move_leader,
    "defrag": cmd_defrag, "make-mirror": cmd_make_mirror,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    args._raw_argv = argv  # lock needs it: REMAINDER eats a leading `--`
    if args.cmd is None:
        parser.print_help()
        return 2
    if args.cmd == "version":
        print(f"etcdctl version: {ver.SERVER_VERSION}")
        print(f"API version: {ver.API_VERSION}")
        return 0
    if args.cmd == "check":
        ccmd = getattr(args, "check_cmd", None)
        if ccmd == "perf":
            return cmd_check_perf(args, Printer(args.write_out, args.hex))
        if ccmd == "datascale":
            return cmd_check_datascale(
                args, Printer(args.write_out, args.hex))
        parser.parse_args(["check", "--help"])
        return 2
    pr = Printer(args.write_out, args.hex)
    try:
        return _DISPATCH[args.cmd](args, pr)
    except CtlError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except ClientError as e:
        print(f"Error: {e.etype}: {e.msg}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
