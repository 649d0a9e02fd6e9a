"""ctypes binding for the native segmented record log (src/walog.cc).

Ports ``etcd_tpu/native/walog.py`` whole; the port keeps its own copy and
tests/test_torch_hubs.py pins it equal.
"""

from __future__ import annotations

import ctypes
import os
import time
from typing import Callable, List, Optional, Tuple

from . import load

# Slow-disk emulation for benches/tests (the etcd idiom is a gofail
# sleep on the persistence path — tests/robustness uses it to model
# cloud/HDD-class disks): ETCD_TPU_FSYNC_DELAY_MS adds a GIL-released
# sleep to every sync flush, i.e. pure IO WAIT, which is what a real
# fsync is. Default 0 (off); benches that set it MUST label their
# artifacts with it. This is how the async WAL pipeline's group-commit
# win is measurable on boxes whose local disk syncs in microseconds.
# Read PER Walog INSTANCE (at __init__), not latched at import: tests
# and benches vary it between members/episodes without a fresh
# interpreter.


def _fsync_delay_s() -> float:
    return float(
        os.environ.get("ETCD_TPU_FSYNC_DELAY_MS", "0") or 0) / 1e3

_REC_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_int,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
    ctypes.c_uint64, ctypes.c_uint64,
)


def _lib() -> ctypes.CDLL:
    lib = load("walog")
    if getattr(lib, "_walog_typed", False):
        return lib
    lib.walog_open.restype = ctypes.c_void_p
    lib.walog_open.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.walog_errmsg.restype = ctypes.c_char_p
    lib.walog_errmsg.argtypes = [ctypes.c_void_p]
    lib.walog_append.restype = ctypes.c_int
    lib.walog_append.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64,
    ]
    lib.walog_flush.restype = ctypes.c_int64
    lib.walog_flush.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.walog_cut.restype = ctypes.c_int
    lib.walog_cut.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.walog_release_before.restype = ctypes.c_int
    lib.walog_release_before.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.walog_read_all.restype = ctypes.c_int
    lib.walog_read_all.argtypes = [
        ctypes.c_char_p, ctypes.c_int, _REC_CB, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.walog_tail_state.restype = ctypes.c_int
    lib.walog_tail_state.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.walog_close.argtypes = [ctypes.c_void_p]
    for fn in ("walog_tail_offset", "walog_tail_seq", "walog_last_sync_ns",
               "walog_total_syncs", "walog_total_sync_ns"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib._walog_typed = True
    return lib


class WalogError(Exception):
    pass


class DiskFullError(WalogError):
    """ENOSPC-class WRITE failure raised at the fault-hook seam before
    the bytes touched the native buffer — provably nothing was written,
    so the caller may back-pressure and retry the same record. A
    failure surfacing from the native write/fsync itself never gets
    this type: a partial write or a failed fsync leaves the on-disk /
    page-cache state unknowable, and the IO-error contract
    (hosting.py) fail-stops instead (ATC'19: never retry-fsync over
    possibly-dropped dirty pages)."""


class InjectedIOError(WalogError):
    """Deterministic injected IO failure (DiskFaultPlan fsync/write
    errors). Carries the op name so fail-stop accounting can label the
    stage."""


def is_disk_full(exc: BaseException) -> bool:
    """Whether an exception is the retryable nothing-was-written
    ENOSPC class (see DiskFullError)."""
    return isinstance(exc, DiskFullError)


class Walog:
    """Segmented CRC-chained record log (native handle wrapper).

    ``fault_hook(op, nbytes)`` — the storage fault plane's seam
    (batched/faults.DiskFaultPlan): called BEFORE every file-affecting
    native call with op in {"append", "flush", "fsync"}. The hook may
    sleep (per-op latency injection — the slow-disk-as-a-fault
    generalization of ETCD_TPU_FSYNC_DELAY_MS) or raise
    (DiskFullError / InjectedIOError); a raise at the seam guarantees
    the native op was never started, which is what makes the
    DiskFullError retry contract sound."""

    def __init__(self, dirpath: str, segment_bytes: int = 64 << 20,
                 create: bool = False,
                 fault_hook: Optional[Callable[[str, int], None]] = None,
                 ) -> None:
        self._lib = _lib()
        err = ctypes.create_string_buffer(512)
        self._h = self._lib.walog_open(
            dirpath.encode(), segment_bytes, 1 if create else 0, err, len(err)
        )
        if not self._h:
            raise WalogError(err.value.decode() or "walog_open failed")
        self.dirpath = dirpath
        self.fault_hook = fault_hook
        # Per-instance (NOT import-latched): a test/bench can flip the
        # env var between member boots in one interpreter.
        self._fsync_delay_s = _fsync_delay_s()

    def _check(self, rc: int) -> None:
        if rc < 0:
            raise WalogError(self._lib.walog_errmsg(self._h).decode())

    def append(self, rtype: int, data: bytes) -> None:
        if self.fault_hook is not None:
            self.fault_hook("append", len(data))
        self._check(self._lib.walog_append(self._h, rtype, data, len(data)))

    def flush(self, sync: bool = True) -> int:
        if self.fault_hook is not None:
            self.fault_hook("fsync" if sync else "flush", 0)
        if sync and self._fsync_delay_s > 0:
            time.sleep(self._fsync_delay_s)  # slow-disk emulation (see top)
        rc = self._lib.walog_flush(self._h, 1 if sync else 0)
        self._check(rc)
        return rc

    def cut(self, meta: int) -> None:
        self._check(self._lib.walog_cut(self._h, meta))

    def release_before(self, meta: int) -> int:
        rc = self._lib.walog_release_before(self._h, meta)
        self._check(rc)
        return rc

    def tail_offset(self) -> int:
        return self._lib.walog_tail_offset(self._h)

    def tail_seq(self) -> int:
        return self._lib.walog_tail_seq(self._h)

    def last_sync_ns(self) -> int:
        return self._lib.walog_last_sync_ns(self._h)

    def sync_stats(self) -> Tuple[int, int]:
        """(total_syncs, total_sync_ns) for the fsync histogram."""
        return (
            self._lib.walog_total_syncs(self._h),
            self._lib.walog_total_sync_ns(self._h),
        )

    def close(self) -> None:
        if self._h:
            self._lib.walog_close(self._h)
            self._h = None

    def __enter__(self) -> "Walog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_all(dirpath: str, repair: bool = True) -> List[Tuple[int, bytes, int, int]]:
    """Validated records [(type, payload, seg_seq, seg_meta)] across all
    segments; truncates a torn tail when repair=True. Raises on
    corruption in non-tail segments."""
    lib = _lib()
    out: List[Tuple[int, bytes, int, int]] = []

    @_REC_CB
    def cb(_ctx, rtype, data, length, seq, meta):
        out.append((rtype, ctypes.string_at(data, length), seq, meta))

    err = ctypes.create_string_buffer(512)
    rc = lib.walog_read_all(
        dirpath.encode(), 1 if repair else 0, cb, None, err, len(err)
    )
    if rc < 0:
        raise WalogError(err.value.decode() or "walog_read_all failed")
    return out


# Tail-shape classification (walog_tail_state return values). The
# distinction matters for protocol-aware recovery (FAST'18): a CLEAN
# boundary proves only that no record was mid-write at the crash, while
# a TORN mid-record break proves bytes beyond the last whole record
# were destroyed — if the file's contents were fsync-acknowledged, that
# is lost durable data, a fault class raft's model does not cover.
TAIL_CLEAN, TAIL_TORN, TAIL_CORRUPT = 0, 1, 2
TAIL_NAMES = {TAIL_CLEAN: "clean", TAIL_TORN: "torn",
              TAIL_CORRUPT: "corrupt"}


def tail_state(dirpath: str) -> int:
    """Classify the LAST segment's tail: TAIL_CLEAN (ends exactly at a
    record boundary, chain valid), TAIL_TORN (ends inside a record —
    the mid-record CRC break / past-EOF shapes), or TAIL_CORRUPT (a
    complete record fails its crc). Call BEFORE read_all(repair=True):
    repair truncates the torn evidence back to a clean boundary."""
    lib = _lib()
    err = ctypes.create_string_buffer(512)
    rc = lib.walog_tail_state(dirpath.encode(), err, len(err))
    if rc < 0:
        raise WalogError(err.value.decode() or "walog_tail_state failed")
    return rc


def read_all_classified(
    dirpath: str, repair: bool = True,
) -> Tuple[List[Tuple[int, bytes, int, int]], int]:
    """read_all plus the tail classification taken BEFORE any repair:
    (records, TAIL_*). The recovery path (hosting._replay) uses the
    classification to distinguish a benign crash boundary from a
    mid-record break that destroyed bytes."""
    ts = tail_state(dirpath)
    return read_all(dirpath, repair=repair), ts


def segment_records(path: str) -> List[Tuple[int, int, int, int]]:
    """Frame-walk one segment file WITHOUT crc validation:
    [(offset, rtype, payload_len, padded_size)] for every complete
    record (the CRC-reset seed included). Tooling/test helper for
    locating record boundaries (e.g. to place a deterministic
    mid-record tear); stops at the first record running past EOF."""
    import struct as _struct

    out: List[Tuple[int, int, int, int]] = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + 12 <= len(data):
        ln, rtype = _struct.unpack_from("<IB", data, off)
        padded = (12 + ln + 7) & ~7
        if off + padded > len(data):
            break
        out.append((off, rtype, ln, padded))
        off += padded
    return out


def verify(dirpath: str) -> bool:
    """Validate the whole chain without repairing (ref: wal.Verify
    wal.go:629). Returns True when every segment checks out."""
    try:
        read_all(dirpath, repair=False)
        return True
    except WalogError:
        return False


# -- at-rest corruption salvage ---------------------------------------------
#
# The native reader treats a COMPLETE record failing its CRC as a hard
# error (walog.cc: "auto-truncating them would silently drop fsync'd
# raft entries") — correct as a default, but it leaves a bit-flipped
# at-rest record unbootable. The protocol-aware alternative (FAST'18):
# amputate the log at the first corrupt record, boot, and let the
# durable-watermark fence mark exactly the groups whose acked bytes the
# amputation destroyed (hosting._replay already does that for torn
# tails). salvage() is that amputation: a Python-side CRC32C chain walk
# that truncates the damaged segment at the last good record boundary
# and deletes every later segment, returning what it removed so the
# caller can log/fence honestly. It never runs implicitly — the boot
# path invokes it only after the native reader refused.

_CRC32C_TABLE: Optional[List[int]] = None


def _crc32c_table() -> List[int]:
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
            tbl.append(c)
        _CRC32C_TABLE = tbl
    return _CRC32C_TABLE


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C (Castagnoli), matching walog.cc's chain function.
    Byte-at-a-time — recovery/tooling path only, never hot."""
    tbl = _crc32c_table()
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _is_torn_region(data: bytes, off: int, padded: int) -> bool:
    """Mirror of walog.cc is_torn_record: any >=8-byte disk-sector
    piece of the record region being all zeros means a torn
    preallocated-segment write, not at-rest corruption."""
    end = min(off + padded, len(data))
    pos = off
    while pos < end:
        piece_end = min((pos // 512 + 1) * 512, end)
        if piece_end - pos >= 8 and not any(data[pos:piece_end]):
            return True
        pos = piece_end
    return False


def scan_chain(dirpath: str) -> Optional[dict]:
    """Walk every segment's CRC chain Python-side; return the FIRST
    at-rest corruption found as {"segment", "path", "offset"(=last good
    boundary), "bad_record_off"} or None when the chain is clean/merely
    torn (torn tails are the native repair's job, not salvage's)."""
    import struct as _struct

    segs = sorted(f for f in os.listdir(dirpath) if f.endswith(".wal"))
    crc = 0
    chain_started = False
    for name in segs:
        path = os.path.join(dirpath, name)
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        good = 0
        first = True
        while off + 12 <= len(data):
            ln, rtype = _struct.unpack_from("<IB", data, off)
            (rcrc,) = _struct.unpack_from("<I", data, off + 8)
            padded = (12 + ln + 7) & ~7
            if off + padded > len(data):
                return None  # torn tail: native repair handles it
            if first:
                if rtype != 0:  # missing CRC-reset seed record
                    return {"segment": name, "path": path,
                            "offset": 0, "bad_record_off": off}
                if not chain_started:
                    crc = rcrc
                    chain_started = True
                elif rcrc != crc:
                    # Chain mismatch across the segment boundary: the
                    # seed itself is the damaged record.
                    return {"segment": name, "path": path,
                            "offset": 0, "bad_record_off": off}
                first = False
            else:
                want = crc32c(data[off + 12:off + 12 + ln], crc)
                if want != rcrc:
                    if _is_torn_region(data, off, padded):
                        return None  # torn, not corrupt
                    return {"segment": name, "path": path,
                            "offset": good, "bad_record_off": off}
                crc = want
            off += padded
            good = off
    return None


def salvage(dirpath: str) -> Optional[dict]:
    """Amputate at-rest corruption: truncate the damaged segment at the
    last good record boundary and DELETE every later segment (their
    chain seeds no longer match). Returns
    {"segment", "truncated_at", "bytes_dropped", "removed_segments"}
    or None when the chain held no complete-record corruption. The
    caller owns the consequences: every fsync'd record at-or-beyond
    the cut is gone, and only a durable-watermark fence
    (hosting._replay) makes that loss protocol-visible instead of
    silent."""
    bad = scan_chain(dirpath)
    if bad is None:
        return None
    segs = sorted(f for f in os.listdir(dirpath) if f.endswith(".wal"))
    si = segs.index(bad["segment"])
    if bad["offset"] == 0 and si == 0:
        # The very first segment's SEED record is damaged: no valid
        # prefix exists at all. Refuse — truncating to zero bytes
        # would leave an unbootable husk after destroying the (intact)
        # later segments, and booting EMPTY would forget the member's
        # vote/term, re-opening double-vote windows. Total log loss is
        # operator territory (rejoin as a fresh member), not salvage's.
        return None
    later = segs[si + 1:]
    dropped = 0
    if bad["offset"] == 0:
        # A non-first segment's seed is the damaged record: nothing in
        # this segment survives, but the chain through the PREVIOUS
        # segment is whole — drop the damaged segment entirely (a
        # zero-byte truncation would fail walog_open's seed check) and
        # everything after it; the previous segment becomes the tail.
        later = [bad["segment"]] + later
    else:
        size = os.path.getsize(bad["path"])
        dropped += size - bad["offset"]
        os.truncate(bad["path"], bad["offset"])
        fd = os.open(bad["path"], os.O_RDWR)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    for name in later:
        p = os.path.join(dirpath, name)
        dropped += os.path.getsize(p)
        os.remove(p)
    # Make the amputation itself durable (file sizes + dir entries)
    # before anyone replays the survivor prefix.
    dfd = os.open(dirpath, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    return {
        "segment": bad["segment"],
        "truncated_at": bad["offset"],
        "bytes_dropped": dropped,
        "removed_segments": later,
    }
