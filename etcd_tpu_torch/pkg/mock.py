"""Action-recorder test doubles (the server/mock analog).

The reference ships no-op recorders that unit tests substitute for the
server's storage / wait / v2 store dependencies, asserting WHICH
operations the server performed rather than their effects
(ref: server/mock/{mockstorage,mockwait,mockstore} and
client/pkg/testutil's Recorder). Same contract here, mirroring this
repo's interfaces (storage.ServerStorage, pkg.wait.Wait,
v2store.Store).

Ports ``etcd_tpu/pkg/mock.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


@dataclass
class Action:
    """One recorded call (ref: testutil.Action)."""

    name: str
    params: Tuple = field(default_factory=tuple)


class Recorder:
    """Buffered action recorder (ref: testutil.RecorderBuffered); the
    ``stream=True`` variant blocks in ``wait`` until the expected
    number of actions arrives (ref: testutil.NewRecorderStream)."""

    def __init__(self, stream: bool = False) -> None:
        self._actions: List[Action] = []
        self._cv = threading.Condition()
        self._stream = stream

    def record(self, a: Action) -> None:
        with self._cv:
            self._actions.append(a)
            self._cv.notify_all()

    def actions(self) -> List[Action]:
        with self._cv:
            return list(self._actions)

    def wait(self, n: int, timeout: Optional[float] = 5.0) -> List[Action]:
        """Return once >= n actions were recorded (stream semantics);
        a buffered recorder returns whatever is there. A stream wait
        that times out RAISES — a short list would let the caller's
        assertion fail confusingly or pass vacuously (the reference's
        Recorder.Wait returns an error, testutil/recorder.go)."""
        with self._cv:
            if self._stream:
                if not self._cv.wait_for(
                        lambda: len(self._actions) >= n,
                        timeout=timeout):
                    raise TimeoutError(
                        f"recorded {len(self._actions)}/{n} actions "
                        f"within {timeout}s: {self._actions}")
            return list(self._actions[:n] if self._stream
                        else self._actions)


class StorageRecorder(Recorder):
    """No-op ServerStorage recording save/save_snap/release/sync
    (ref: mockstorage.storageRecorder)."""

    def save(self, hard_state, entries, must_sync: bool = True) -> None:
        self.record(Action("save"))

    def save_snap(self, snap) -> None:
        if snap is not None and snap.metadata.index:
            self.record(Action("save_snap", (snap.metadata.index,)))

    def release(self, snap) -> None:
        if snap is not None and snap.metadata.index:
            self.record(Action("release", (snap.metadata.index,)))

    def sync(self) -> None:
        self.record(Action("sync"))

    def close(self) -> None:
        self.record(Action("close"))


class WaitRecorder(Recorder):
    """pkg.wait.Wait recording register/trigger; waiters resolve
    immediately with None (ref: mockwait.WaitRecorder)."""

    def register(self, wid: int):
        self.record(Action("register", (wid,)))
        return _DoneWaiter()

    def trigger(self, wid: int, value: Any = None) -> bool:
        self.record(Action("trigger", (wid,)))
        return True

    def is_registered(self, wid: int) -> bool:
        return False


class _DoneWaiter:
    def wait(self, timeout: Optional[float] = None) -> Any:
        return None

    def set(self, value: Any) -> None:
        pass

    def done(self) -> bool:
        return True


class StoreRecorder(Recorder):
    """v2store.Store recorder: every API call is recorded and answered
    with a benign empty result (ref: mockstore.StoreRecorder). Only
    the surface EtcdServer's v2 apply path touches is materialized;
    unknown methods record via __getattr__ so new call sites cannot
    silently bypass the recorder."""

    def get(self, path, recursive=False, sorted_=False):
        self.record(Action("get", (path, recursive, sorted_)))
        return None

    def set(self, path, dir_=False, value="", **kw):
        self.record(Action("set", (path, dir_, value)))
        return None

    def update(self, path, value="", **kw):
        self.record(Action("update", (path, value)))
        return None

    def create(self, path, dir_=False, value="", unique=False, **kw):
        self.record(Action("create", (path, dir_, value, unique)))
        return None

    def delete(self, path, dir_=False, recursive=False, **kw):
        self.record(Action("delete", (path, dir_, recursive)))
        return None

    def compare_and_swap(self, path, prev_value, prev_index, value, **kw):
        self.record(Action(
            "compare_and_swap", (path, prev_value, prev_index, value)))
        return None

    def compare_and_delete(self, path, prev_value, prev_index, **kw):
        self.record(Action(
            "compare_and_delete", (path, prev_value, prev_index)))
        return None

    def watch(self, path, recursive=False, stream=False, since=0):
        self.record(Action("watch", (path,)))
        return None

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def _rec(*a, **kw):
            self.record(Action(name, a))
            return None

        return _rec
