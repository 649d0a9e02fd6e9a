"""PyTorch port ↔ JAX reference: the sqlite backend and the MVCC store.

One seeded numpy op stream goes into ``etcd_tpu``'s and the port's
``WatchableStore``, each over its own backend in a temporary directory:
puts, single-key and range deletes, multi-op write txns, ranges at past,
compacted and future revisions (with limits and count-only),
compactions, watches opened at a start revision and cancelled, hash_kv
at past revisions, and restarts that reopen both backends. After every
op each result, or the class of the error it raised, every event each
watch stream delivered (synced watchers inline, unsynced ones by
``sync_watchers``) and ``hash_kv`` must be equal. Exact equality: every
value compared is an int, bytes or a structure of them.

The stream runs once with ``sortedcontainers.SortedDict`` under the
index (where it is installed) and once with ``pkg/sorteddict``'s
fallback forced in both packages, since a machine without
sortedcontainers runs the index on the fallback.
"""

import numpy as np
import pytest

from etcd_tpu.pkg import sorteddict as jsorted
from etcd_tpu.storage import backend as jbk
from etcd_tpu.storage.mvcc import index as jindex
from etcd_tpu.storage.mvcc import watchable as jwatch
from etcd_tpu_torch.pkg import sorteddict as tsorted
from etcd_tpu_torch.storage import backend as tbk
from etcd_tpu_torch.storage.mvcc import index as tindex
from etcd_tpu_torch.storage.mvcc import watchable as twatch
from etcd_tpu_torch.tools.server_script import plain

SEED = 20261017
KEYS = 16


def _outcome(fn):
    try:
        return plain(fn())
    except Exception as e:  # noqa: BLE001 — the error class is the result
        return ("error", type(e).__name__)


class Side:
    """One package's backend and watchable store, with its watch streams."""

    def __init__(self, bk, watch, path):
        self.bk, self.watch_mod, self.path = bk, watch, path
        self.open()

    def open(self):
        self.be = self.bk.Backend(self.path, batch_interval=10.0)
        self.kv = self.watch_mod.WatchableStore(self.be)
        self.stream = self.kv.new_watch_stream()

    def restart(self):
        self.stream.close()
        self.be.close()
        self.open()

    def events(self):
        """The responses delivered since the last call, each watcher's in
        order (the store notifies the watchers of one write from a set,
        so their interleaving is not part of the contract)."""
        self.kv.sync_watchers()
        out = []
        while True:
            resp = self.stream.poll(timeout=0)
            if resp is None:
                return plain(sorted(out, key=lambda r: r.watch_id))
            out.append(resp)

    def close(self):
        self.stream.close()
        self.be.close()


def _txn(side, subops):
    out = []
    with side.kv.write() as tx:
        for kind, a, b in subops:
            if kind == "put":
                tx.put(a, b)
                out.append(None)
            elif kind == "del":
                out.append(tx.delete_range(a, b))
            else:
                out.append(tx.range(a, b))
    return out, tx.rev


def _key(rng):
    return b"key%02d" % int(rng.randint(KEYS))


def op_stream(seed, n):
    """n seeded ops; revision choices are resolved against the store's
    current and compacted revisions when each op runs."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n):
        r = rng.rand()
        if r < 0.35:
            ops.append(("put", _key(rng), rng.bytes(int(rng.randint(17)))))
        elif r < 0.45:
            ops.append(("delete", _key(rng), None))
        elif r < 0.52:
            a = int(rng.randint(KEYS - 3))
            ops.append(("delete", b"key%02d" % a,
                        b"key%02d" % (a + int(rng.randint(1, 4)))))
        elif r < 0.62:
            subs = []
            for _ in range(int(rng.randint(1, 4))):
                kind = ("put", "del", "range")[int(rng.randint(3))]
                k = _key(rng)
                subs.append((kind, k, rng.bytes(4) if kind == "put" else (
                    None if rng.rand() < 0.5 else k + b"\xff")))
            ops.append(("txn", subs, None))
        elif r < 0.78:
            ops.append(("range", float(rng.rand()),
                        (int(rng.randint(0, 6)), bool(rng.rand() < 0.2),
                         bool(rng.rand() < 0.5))))
        elif r < 0.82:
            ops.append(("compact", float(rng.rand()), None))
        elif r < 0.88:
            ops.append(("watch", float(rng.rand()), bool(rng.rand() < 0.5)))
        elif r < 0.91:
            ops.append(("cancel", int(rng.randint(8)), None))
        elif r < 0.97:
            ops.append(("hash", float(rng.rand()), None))
        else:
            ops.append(("restart", None, None))
    return ops


def _rev_at(side, u):
    """A revision from [compacted - 1, current + 1], by the fraction u."""
    lo = max(side.kv.first_rev() - 2, 0)
    hi = side.kv.rev() + 1
    return lo + int(u * (hi - lo + 1))


def apply_op(side, op):
    kind, a, b = op
    kv = side.kv
    if kind == "put":
        return _outcome(lambda: kv.put(a, b))
    if kind == "delete":
        return _outcome(lambda: kv.delete_range(a, b))
    if kind == "txn":
        return _outcome(lambda: _txn(side, a))
    if kind == "range":
        limit, count_only, whole = b
        ro = side.watch_mod.RangeOptions(limit=limit, rev=_rev_at(side, a),
                                         count_only=count_only)
        end = b"key\xff" if whole else None
        return _outcome(lambda: kv.range(b"key03" if not whole else b"key",
                                         end, ro))
    if kind == "compact":
        return _outcome(lambda: kv.compact(_rev_at(side, a)))
    if kind == "watch":
        start = _rev_at(side, a)
        end = b"key08" if b else None
        return _outcome(lambda: side.stream.watch(b"key04", end, start))
    if kind == "cancel":
        return _outcome(lambda: side.stream.cancel(a))
    if kind == "hash":
        return _outcome(lambda: kv.hash_kv(_rev_at(side, a)))
    side.restart()
    return None


@pytest.fixture(params=["sortedcontainers", "fallback"])
def index_impl(request, monkeypatch):
    if request.param == "fallback":
        monkeypatch.setattr(jindex, "SortedDict", jsorted.SortedDict)
        monkeypatch.setattr(tindex, "SortedDict", tsorted.SortedDict)
    else:
        pytest.importorskip("sortedcontainers")
        import sortedcontainers
        assert tindex.SortedDict is sortedcontainers.SortedDict
    return request.param


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_mvcc_op_stream_equal(tmp_path, index_impl, seed):
    """Every op's result, the watch events and hash_kv equal after every
    op of the seeded stream, under either SortedDict."""
    j = Side(jbk, _WatchModule(jwatch), str(tmp_path / "jax.db"))
    t = Side(tbk, _WatchModule(twatch), str(tmp_path / "port.db"))
    if index_impl == "fallback":
        assert type(t.kv.index._tree) is tsorted.SortedDict
    kinds = set()
    try:
        for i, op in enumerate(op_stream(seed, 400)):
            got_j, got_t = apply_op(j, op), apply_op(t, op)
            assert got_j == got_t, (i, op, got_j, got_t)
            assert j.events() == t.events(), (i, op)
            assert plain(j.kv.hash_kv()) == plain(t.kv.hash_kv()), (i, op)
            kinds.add(op[0] if not isinstance(got_t, tuple)
                      or got_t[0] != "error" else got_t[1])
    finally:
        j.close()
        t.close()
    # The stream reached every op and both revision errors.
    for k in ("put", "delete", "txn", "range", "compact", "watch", "cancel",
              "hash", "restart", "CompactedError", "FutureRevError"):
        assert k in kinds, (k, kinds)


class _WatchModule:
    """The names a Side needs from one package's mvcc."""

    def __init__(self, watch):
        import importlib

        pkg = importlib.import_module(watch.__name__.rsplit(".", 1)[0])
        self.WatchableStore = watch.WatchableStore
        self.RangeOptions = pkg.RangeOptions


def test_backend_buckets_equal(tmp_path):
    """The backend alone: seeded puts, deletes, range deletes and commits
    in each package's sqlite file; every bucket's rows equal after each
    commit, across a reopen, and each package reads the other's file."""
    rng = np.random.RandomState(SEED)
    paths = {"j": str(tmp_path / "j.db"), "t": str(tmp_path / "t.db")}
    b = {"j": jbk.Backend(paths["j"], batch_interval=10.0),
         "t": tbk.Backend(paths["t"], batch_interval=10.0)}
    mods = {"j": jbk, "t": tbk}

    def rows(side, be):
        rt = be.read_tx()
        return {name: rt.range(getattr(mods[side], name), b"", b"\xff")
                for name in ("KEY", "META", "LEASE")}

    for step in range(300):
        r = rng.rand()
        k = b"k%02d" % int(rng.randint(20))
        v = rng.bytes(int(rng.randint(1, 9)))
        for side, be in b.items():
            bucket = mods[side].KEY if r < 0.8 else mods[side].META
            with be.batch_tx.lock:
                if r < 0.6 or 0.8 <= r < 0.9:
                    be.batch_tx.put(bucket, k, v)
                elif r < 0.7:
                    be.batch_tx.delete(bucket, k)
                else:
                    be.batch_tx.delete_range(bucket, k, k + b"\x05")
            if step % 7 == 0:
                be.force_commit()
        if step % 7 == 0:
            assert rows("j", b["j"]) == rows("t", b["t"]), step
    for side in b:
        b[side].force_commit()
        b[side].close()
    # Reopen each file with the other package's backend.
    cross = {"j": tbk.Backend(paths["j"], batch_interval=10.0),
             "t": jbk.Backend(paths["t"], batch_interval=10.0)}
    try:
        assert rows("t", cross["j"]) == rows("j", cross["t"])
    finally:
        for be in cross.values():
            be.close()
