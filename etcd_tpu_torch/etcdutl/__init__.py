"""etcdutl: offline operations on data dirs and snapshot files
(ref: etcdutl/etcdutl/*.go — snapshot restore/status, defrag, backup,
migrate, version; plus server/verify/verify.go:49-141 as the `verify`
subcommand).

All commands work on files only — no running member required.
`python -m etcd_tpu_torch.etcdutl <cmd> ...`.

Ports ``etcd_tpu/etcdutl/__init__.py``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import struct
import sys
from typing import List, Optional

from .. import version as ver


def _open_backend(path: str):
    from ..storage import backend as bk

    return bk.open_backend(path)


# -- snapshot restore (etcdutl/snapshot/v3_snapshot.go) ------------------------


def snapshot_restore(
    snap_file: str,
    data_dir: str,
    name: str = "default",
    initial_cluster: str = "",
    initial_cluster_token: str = "etcd-cluster",
    skip_hash_check: bool = False,
) -> int:
    """Rebuild a member data dir from a snapshot db: place the db,
    reset membership buckets to the new cluster, zero the consistent
    index so the fresh cluster's log applies from entry 1
    (ref: v3_snapshot.go Restore — saveDB + saveWALAndSnap)."""
    from ..embed.config import member_id_from_urls
    from ..server.cindex import ConsistentIndex
    from ..server.membership import (
        CLUSTER_BUCKET, MEMBERS_BUCKET, REMOVED_BUCKET, Member, RaftCluster,
    )
    from ..storage import backend as bk

    if not os.path.exists(snap_file):
        raise FileNotFoundError(snap_file)
    if not skip_hash_check:
        # Integrity check before touching anything (the reference
        # verifies the snapshot's trailing hash; our snapshot is the
        # backend db, so ask the storage engine directly).
        _check_snapshot_integrity(snap_file)
    cluster_map = {}
    if initial_cluster:
        for part in initial_cluster.split(","):
            nm, url = part.strip().split("=", 1)
            cluster_map.setdefault(nm, []).append(url)
    else:
        cluster_map = {name: ["http://localhost:2380"]}
    if name not in cluster_map:
        raise ValueError(f"member {name!r} not in initial cluster")

    my_id = member_id_from_urls(
        ",".join(cluster_map[name]), initial_cluster_token
    )
    member_dir = os.path.join(data_dir, f"member-{my_id}")
    if os.path.exists(member_dir):
        raise FileExistsError(f"member dir {member_dir} already exists")
    os.makedirs(member_dir)
    db_path = os.path.join(member_dir, "db")
    shutil.copyfile(snap_file, db_path)

    be = _open_backend(db_path)
    try:
        with be.batch_tx.lock:
            for bucket in (MEMBERS_BUCKET, REMOVED_BUCKET):
                for k, _ in be.read_tx().range(bucket, b"", b"\xff" * 16):
                    be.batch_tx.delete(bucket, k)
        for nm, urls in sorted(cluster_map.items()):
            mid = member_id_from_urls(",".join(urls), initial_cluster_token)
            with be.batch_tx.lock:
                be.batch_tx.put(
                    MEMBERS_BUCKET, mid.to_bytes(8, "big"),
                    Member(id=mid, name=nm, peer_urls=urls).marshal(),
                )
        # Fresh raft log ⇒ the consistent-index guard must not skip it.
        ci = ConsistentIndex(be)
        ci.set_consistent_index(0, 0)
        be.force_commit()
    finally:
        be.close()
    print(f"restored snapshot to {member_dir} (member {my_id:x})")
    return 0


def _check_snapshot_integrity(snap_file: str) -> None:
    import sqlite3

    # Read-only immutable open: no copy, no wal/journal side files.
    conn = sqlite3.connect(
        f"file:{snap_file}?mode=ro&immutable=1", uri=True
    )
    try:
        rows = conn.execute("PRAGMA integrity_check").fetchall()
    except sqlite3.DatabaseError as e:
        raise ValueError(
            f"snapshot integrity check failed: {e} "
            f"(use --skip-hash-check to override)"
        )
    finally:
        conn.close()
    if rows != [("ok",)]:
        raise ValueError(
            f"snapshot integrity check failed: {rows!r} "
            f"(use --skip-hash-check to override)"
        )


def snapshot_status(snap_file: str, write_out: str = "simple") -> int:
    """ref: v3_snapshot.go Status — hash, revision, total keys, size."""
    from ..storage import backend as bk
    from ..storage.mvcc.kvstore import KVStore

    size = os.path.getsize(snap_file)
    h = hashlib.sha256()
    with open(snap_file, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    digest = int.from_bytes(h.digest()[:4], "big")
    # Open a COPY read-only to count keys/revision (opening mutates wal
    # files for sqlite; keep the snapshot pristine).
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        tmp = os.path.join(td, "db")
        shutil.copyfile(snap_file, tmp)
        be = _open_backend(tmp)
        try:
            kv = KVStore(be)
            rev = kv.rev()
            total = kv.index.count_all(rev)
        finally:
            be.close()
    if write_out == "json":
        print(json.dumps(
            {"hash": digest, "revision": rev, "totalKey": total,
             "totalSize": size}
        ))
    else:
        hdr = ["HASH", "REVISION", "TOTAL KEYS", "TOTAL SIZE"]
        row = [f"{digest:x}", str(rev), str(total), str(size)]
        w = [max(len(a), len(b)) for a, b in zip(hdr, row)]
        line = "+" + "+".join("-" * (x + 2) for x in w) + "+"
        print(line)
        print("| " + " | ".join(h_.ljust(x) for h_, x in zip(hdr, w)) + " |")
        print(line)
        print("| " + " | ".join(c.ljust(x) for c, x in zip(row, w)) + " |")
        print(line)
    return 0


def defrag(data_dir: str) -> int:
    """Offline defragment every member db under data_dir
    (ref: etcdutl defrag --data-dir)."""
    found = False
    for entry in sorted(os.listdir(data_dir)):
        db = os.path.join(data_dir, entry, "db")
        if not (entry.startswith("member-") and os.path.exists(db)):
            continue
        found = True
        be = _open_backend(db)
        try:
            be.defrag()
        finally:
            be.close()
        print(f"Finished defragmenting etcd data[{db}]")
    if not found:
        print(f"no member db found under {data_dir}", file=sys.stderr)
        return 1
    return 0


def backup(data_dir: str, backup_dir: str) -> int:
    """Consistent copy of a (stopped) member's data dir
    (ref: etcdctl backup / etcdutl migrate tooling)."""
    if os.path.exists(backup_dir) and os.listdir(backup_dir):
        print(f"backup dir {backup_dir} not empty", file=sys.stderr)
        return 1
    shutil.copytree(data_dir, backup_dir, dirs_exist_ok=True)
    print(f"backed up {data_dir} to {backup_dir}")
    return 0


SCHEMA_VERSION_KEY = b"storageVersion"


def migrate(data_dir: str, target_version: str, force: bool = False) -> int:
    """Storage schema up/down-migration marker
    (ref: etcdutl/etcdutl/migrate_command.go; schema/migration.go).
    The current schema is version-compatible across this framework's
    releases, so migration just validates + stamps the version."""
    from ..server.cindex import META_BUCKET
    from ..storage import backend as bk

    found = False
    for entry in sorted(os.listdir(data_dir)):
        db = os.path.join(data_dir, entry, "db")
        if not (entry.startswith("member-") and os.path.exists(db)):
            continue
        found = True
        be = _open_backend(db)
        try:
            cur = be.read_tx().get(META_BUCKET, SCHEMA_VERSION_KEY)
            cur_s = cur.decode() if cur else "3.6"
            if cur_s != target_version and not force:
                major_minor = lambda v: tuple(int(x) for x in v.split(".")[:2])
                if abs(major_minor(cur_s)[1] - major_minor(target_version)[1]) > 1:
                    print(
                        f"cannot migrate {cur_s} -> {target_version} "
                        f"(one minor version at a time; use --force)",
                        file=sys.stderr,
                    )
                    return 1
            with be.batch_tx.lock:
                be.batch_tx.put(
                    META_BUCKET, SCHEMA_VERSION_KEY, target_version.encode()
                )
            be.force_commit()
        finally:
            be.close()
        print(f"migrated {db} to storage version {target_version}")
    if not found:
        print(f"no member db found under {data_dir}", file=sys.stderr)
        return 1
    return 0


def verify(data_dir: str) -> bool:
    """Offline consistency check: WAL chain valid, and the backend's
    consistent index within the WAL's entry range
    (ref: server/verify/verify.go:49-141 VerifyIfEnabled)."""
    from ..native import walog as nwalog
    from ..server.cindex import ConsistentIndex
    from ..storage import wal as walmod

    ok = True
    for entry in sorted(os.listdir(data_dir)):
        mdir = os.path.join(data_dir, entry)
        if not entry.startswith("member-"):
            continue
        wal_dir = os.path.join(mdir, "wal")
        db = os.path.join(mdir, "db")
        if os.path.isdir(wal_dir):
            if not walmod.verify(wal_dir):
                print(f"{entry}: WAL chain INVALID")
                ok = False
                continue
            # Read-only scan (repair=False): never mutate under verify.
            last_index = 0
            for rtype, data, _seq, _meta in nwalog.read_all(
                wal_dir, repair=False
            ):
                if rtype == walmod.REC_ENTRY:
                    term, index, _t = walmod._ENTRY_HDR.unpack(
                        data[: walmod._ENTRY_HDR.size]
                    )
                    last_index = max(last_index, index)
            if os.path.exists(db):
                be = _open_backend(db)
                try:
                    ci = ConsistentIndex(be).consistent_index()
                finally:
                    be.close()
                # cindex may legitimately trail the WAL tail, but must
                # never exceed it (verify.go consistent-index invariant,
                # modulo snapshot-ahead state which drops WAL prefixes).
                if last_index and ci > last_index:
                    print(
                        f"{entry}: consistent index {ci} beyond WAL last "
                        f"index {last_index}"
                    )
                    ok = False
                    continue
            print(f"{entry}: OK (wal last={last_index})")
        elif os.path.exists(db):
            print(f"{entry}: OK (backend only)")
    return ok


# -- CLI -----------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(prog="etcdutl")
    p.add_argument("-w", "--write-out", default="simple",
                   choices=["simple", "json"])
    sub = p.add_subparsers(dest="cmd")

    sp = sub.add_parser("snapshot")
    ssub = sp.add_subparsers(dest="snap_cmd")
    x = ssub.add_parser("restore")
    x.add_argument("file")
    x.add_argument("--data-dir", required=True)
    x.add_argument("--name", default="default")
    x.add_argument("--initial-cluster", default="")
    x.add_argument("--initial-cluster-token", default="etcd-cluster")
    x.add_argument("--skip-hash-check", action="store_true")
    x = ssub.add_parser("status")
    x.add_argument("file")

    x = sub.add_parser("defrag")
    x.add_argument("--data-dir", required=True)

    x = sub.add_parser("backup")
    x.add_argument("--data-dir", required=True)
    x.add_argument("--backup-dir", required=True)

    x = sub.add_parser("migrate")
    x.add_argument("--data-dir", required=True)
    x.add_argument("--target-version", required=True)
    x.add_argument("--force", action="store_true")

    x = sub.add_parser("verify")
    x.add_argument("--data-dir", required=True)

    sub.add_parser("version")

    args = p.parse_args(argv)
    try:
        if args.cmd == "snapshot":
            if args.snap_cmd == "restore":
                return snapshot_restore(
                    args.file, args.data_dir, name=args.name,
                    initial_cluster=args.initial_cluster,
                    initial_cluster_token=args.initial_cluster_token,
                    skip_hash_check=args.skip_hash_check,
                )
            if args.snap_cmd == "status":
                return snapshot_status(args.file, args.write_out)
            p.parse_args(["snapshot", "--help"])
            return 2
        if args.cmd == "defrag":
            return defrag(args.data_dir)
        if args.cmd == "backup":
            return backup(args.data_dir, args.backup_dir)
        if args.cmd == "migrate":
            return migrate(args.data_dir, args.target_version, args.force)
        if args.cmd == "verify":
            return 0 if verify(args.data_dir) else 1
        if args.cmd == "version":
            print(f"etcdutl version: {ver.SERVER_VERSION}")
            print(f"API version: {ver.API_VERSION}")
            return 0
    except (OSError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    p.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
