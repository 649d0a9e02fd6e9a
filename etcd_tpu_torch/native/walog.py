"""ctypes binding for the native segmented record log (src/walog.cc).

Ports the part of ``etcd_tpu/native/walog.py`` that the WAL facade
(``storage/wal.py``) uses: the ``Walog`` handle, ``read_all`` and
``verify``. The storage fault seam and the at-rest salvage tooling of
etcd_tpu's hosting layer wait for that layer's port.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

from . import load

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
    lib.walog_close.argtypes = [ctypes.c_void_p]
    for fn in ("walog_tail_offset", "walog_tail_seq", "walog_last_sync_ns",
               "walog_total_syncs", "walog_total_sync_ns"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib._walog_typed = True
    return lib


class WalogError(Exception):
    pass


class Walog:
    """Segmented CRC-chained record log (native handle wrapper)."""

    def __init__(self, dirpath: str, segment_bytes: int = 64 << 20,
                 create: bool = False) -> None:
        self._lib = _lib()
        err = ctypes.create_string_buffer(512)
        self._h = self._lib.walog_open(
            dirpath.encode(), segment_bytes, 1 if create else 0, err, len(err)
        )
        if not self._h:
            raise WalogError(err.value.decode() or "walog_open failed")
        self.dirpath = dirpath

    def _check(self, rc: int) -> None:
        if rc < 0:
            raise WalogError(self._lib.walog_errmsg(self._h).decode())

    def append(self, rtype: int, data: bytes) -> None:
        self._check(self._lib.walog_append(self._h, rtype, data, len(data)))

    def flush(self, sync: bool = True) -> int:
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


def verify(dirpath: str) -> bool:
    """Validate the whole chain without repairing (ref: wal.Verify
    wal.go:629). Returns True when every segment checks out."""
    try:
        read_all(dirpath, repair=False)
        return True
    except WalogError:
        return False
