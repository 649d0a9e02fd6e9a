"""PyTorch port ↔ JAX reference: the storage pieces the hosting layer
imports — the WAL record log's readers, tail classification and salvage,
its fault seam, the snapshotter's fault seam, and the wire codec.

Each package builds its own native record log (``native/src/walog.cc``)
with g++. WAL directories written by each package are read, classified,
scanned and salvaged by both, clean and with torn, corrupt and
damaged-seed tails; the results, the repaired files and the bytes are
equal. Snapshot files and codec frames are read both ways too.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from etcd_tpu.native import walog as jwalog
from etcd_tpu.raft import types as jtypes
from etcd_tpu.storage import snap as jsnap
from etcd_tpu.transport import codec as jcodec
from etcd_tpu_torch.native import walog as twalog
from etcd_tpu_torch.raft import types as ttypes
from etcd_tpu_torch.storage import snap as tsnap
from etcd_tpu_torch.transport import codec as tcodec

WALOGS = {"jax": jwalog, "torch": twalog}


def write_wal(mod, wd, segments=3, recs=5):
    w = mod.Walog(wd, segment_bytes=1 << 16, create=True)
    for s in range(segments):
        if s:
            w.cut(s)
        for i in range(recs):
            w.append(1 + i % 3, b"seg%d-rec%d-" % (s, i) * (1 + i))
    w.flush(sync=True)
    w.close()


def segs(wd):
    return sorted(f for f in os.listdir(wd) if f.endswith(".wal"))


def damage(wd, shape, mod):
    """Tear, rot or unseed the WAL in `wd` (or leave it clean)."""
    names = segs(wd)
    if shape == "clean":
        return
    if shape == "seed":  # a later segment's CRC-reset seed record
        path, off = os.path.join(wd, names[1]), 8
    else:
        path = os.path.join(wd, names[-1])
        recs = mod.segment_records(path)
        off_r, _rt, ln, padded = recs[-2] if shape == "corrupt" else recs[-1]
        if shape == "torn":
            os.truncate(path, off_r + padded - 3)
            return
        off = off_r + 12 + ln // 2
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x40]))


def read_side(mod, wd):
    """Everything a reader can say about `wd`, repair and salvage
    included (run on a copy of their own)."""
    out = {"tail": mod.tail_state(wd), "verify": mod.verify(wd),
           "scan": mod.scan_chain(wd),
           "records": {name: mod.segment_records(os.path.join(wd, name))
                       for name in segs(wd)}}
    try:
        out["classified"] = mod.read_all_classified(wd, repair=True)
    except mod.WalogError as e:
        out["classified"] = ("refused", type(e).__name__)
    out["salvage"] = mod.salvage(wd)
    try:
        out["after"] = mod.read_all(wd)
    except mod.WalogError as e:
        out["after"] = ("refused", type(e).__name__)
    out["files"] = {name: open(os.path.join(wd, name), "rb").read()
                    for name in segs(wd)}
    if out["scan"] is not None:
        out["scan"] = {k: v for k, v in out["scan"].items() if k != "path"}
    return out


@pytest.mark.parametrize("shape", ["clean", "torn", "corrupt", "seed"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_wal_files_read_both_ways(tmp_path, writer, shape):
    src = str(tmp_path / "src")
    write_wal(WALOGS[writer], src)
    damage(src, shape, WALOGS[writer])
    sides = {}
    for pkg, mod in WALOGS.items():
        wd = str(tmp_path / pkg)
        shutil.copytree(src, wd)
        sides[pkg] = read_side(mod, wd)
    assert sides["torch"] == sides["jax"]
    got = sides["torch"]
    want_tail = {"clean": twalog.TAIL_CLEAN, "torn": twalog.TAIL_TORN,
                 "corrupt": twalog.TAIL_CORRUPT,
                 "seed": twalog.TAIL_CLEAN}[shape]
    assert got["tail"] == want_tail
    assert (got["salvage"] is None) == (shape in ("clean", "torn"))
    # A torn tail is a crash boundary, which the reader tolerates.
    assert got["verify"] == (shape in ("clean", "torn"))
    assert twalog.TAIL_NAMES == jwalog.TAIL_NAMES


def test_crc32c_matches():
    rng = np.random.default_rng(2)
    for _ in range(50):
        data = rng.bytes(int(rng.integers(0, 300)))
        seed = int(rng.integers(0, 1 << 32))
        assert twalog.crc32c(data, seed) == jwalog.crc32c(data, seed)
    assert twalog.crc32c(b"123456789") == 0xE3069283


def test_walog_fault_hook(tmp_path):
    """The seam sees every file-affecting call before the native one; a
    DiskFullError raised there leaves nothing written, so the same
    record can be retried; InjectedIOError carries through."""
    seen = {}
    for pkg, mod in WALOGS.items():
        ops, full = [], [False]

        def hook(op, nbytes, ops=ops, full=full, mod=mod):
            ops.append((op, nbytes))
            if full[0] and op == "append":
                raise mod.DiskFullError("ENOSPC")
            if op == "flush":
                raise mod.InjectedIOError("flush")

        wd = str(tmp_path / pkg)
        w = mod.Walog(wd, segment_bytes=1 << 16, create=True,
                      fault_hook=hook)
        w.append(1, b"first")
        full[0] = True
        with pytest.raises(mod.DiskFullError) as ei:
            w.append(1, b"second")
        assert mod.is_disk_full(ei.value)
        full[0] = False
        w.append(1, b"second")
        w.flush(sync=True)
        with pytest.raises(mod.InjectedIOError) as ei:
            w.flush(sync=False)
        assert not mod.is_disk_full(ei.value)
        w.close()
        seen[pkg] = (ops, [r[:2] for r in mod.read_all(wd)])
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1] == [(1, b"first"), (1, b"second")]


def make_snap(types, index, term):
    return types.Snapshot(
        data=b"app-state-%d" % index,
        metadata=types.SnapshotMetadata(
            conf_state=types.ConfState(voters=[1, 2], learners=[3],
                                       auto_leave=True),
            index=index, term=term))


def test_snapshotter_fault_seam(tmp_path):
    """The hook sees the same ops in the same order in both packages
    through save, release and retain; an abort at the rename keeps the
    previous snapshot the newest loadable one; each package loads the
    other's files."""
    seen = {}
    for pkg, (mod, types) in {"jax": (jsnap, jtypes),
                              "torch": (tsnap, ttypes)}.items():
        ops, fail = [], [None]

        def hook(op, nbytes=0, ops=ops, fail=fail):
            ops.append((op, nbytes))
            if op == fail[0]:
                raise OSError(op)

        d = str(tmp_path / pkg)
        os.makedirs(d)
        s = mod.Snapshotter(d, fault_hook=hook)
        for i in (3, 5, 8):
            s.save_snap(make_snap(types, i, 2))
        fail[0] = "snap_rename"
        with pytest.raises(OSError):
            s.save_snap(make_snap(types, 9, 2))
        fail[0] = None
        newest = s.load().metadata.index
        s.release_snap_dbs(5)
        pruned = s.retain(1)
        seen[pkg] = (ops, newest, pruned, s.snap_names())
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1] == 8
    # Each directory read by the other package.
    for a, mod, types in (("jax", tsnap, ttypes), ("torch", jsnap, jtypes)):
        got = mod.Snapshotter(str(tmp_path / a)).load()
        assert dataclasses.asdict(got) == dataclasses.asdict(
            make_snap(types, 8, 2))
        assert mod.Snapshotter(str(tmp_path / a)).load_newest_available(
            [(5, 2), (8, 2)]).metadata.index == 8


def messages(types):
    mt, et = types.MessageType, types.EntryType
    return [
        types.Message(type=mt.MsgApp, to=2, from_=1, term=4, log_term=3,
                      index=10, commit=9, entries=[
                          types.Entry(term=4, index=11, data=b"x" * 40),
                          types.Entry(term=4, index=12,
                                      type=et.EntryConfChangeV2,
                                      data=b"\x08\x01")]),
        types.Message(type=mt.MsgAppResp, to=1, from_=3, term=4, index=12,
                      reject=True, reject_hint=7, context=b"ctx!"),
        types.Message(type=mt.MsgSnap, to=3, from_=1, term=5,
                      snapshot=make_snap(types, 40, 5)),
        types.Message(type=mt.MsgHeartbeat, to=2, from_=1, term=5,
                      commit=40),
    ]


def test_codec_bytes():
    """Equal frames for the same messages; each package decodes the
    other's frames into equal messages."""
    jm, tm = messages(jtypes), messages(ttypes)
    for j, t in zip(jm, tm):
        fj, ft = jcodec.encode_message(j), tcodec.encode_message(t)
        assert ft == fj
        body = ft[4:]
        assert dataclasses.asdict(tcodec.decode_message(body)) == (
            dataclasses.asdict(jcodec.decode_message(body)))
        assert dataclasses.asdict(tcodec.decode_message(body)) == (
            dataclasses.asdict(t))
    assert tcodec.MAX_FRAME == jcodec.MAX_FRAME
