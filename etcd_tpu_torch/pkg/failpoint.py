"""gofail-style failpoints (ref: the gofail comment-macros compiled
into the reference's persistence path, etcdserver/raft.go:222-265
raftBeforeSave/raftAfterSave/raftBeforeSaveSnap/…, toggled at runtime
by the functional tester's RANDOM_FAILPOINTS via the agent endpoint).

Sites call ``fp("name")``; enabled actions:

* ``panic``        — raise FailpointPanic (crashes the calling loop)
* ``sleep(<ms>)``  — delay the caller
* ``error``        — raise FailpointError (recoverable error injection)
* a callable       — run arbitrary code at the site

Disabled sites cost one dict lookup.

Ports ``etcd_tpu/pkg/failpoint.py`` whole; the port keeps its own copy and
tests/test_torch_hubs.py pins it equal.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, List, Union

Action = Union[str, Callable[[], None]]


class FailpointPanic(BaseException):
    """Deliberate crash (BaseException so normal handlers don't eat it;
    the test harness catches it at thread top-level)."""


class FailpointError(Exception):
    """Recoverable injected error."""


_lock = threading.Lock()
_active: Dict[str, Action] = {}
_hits: Dict[str, int] = {}


def enable(name: str, action: Action = "panic") -> None:
    with _lock:
        _active[name] = action


def disable(name: str) -> None:
    with _lock:
        _active.pop(name, None)


def disable_all() -> None:
    with _lock:
        _active.clear()
        _hits.clear()


def status() -> List[str]:
    with _lock:
        return sorted(_active)


def hits(name: str) -> int:
    with _lock:
        return _hits.get(name, 0)


def fp(name: str) -> None:
    """The failpoint site."""
    action = _active.get(name)
    if action is None:
        return
    with _lock:
        _hits[name] = _hits.get(name, 0) + 1
    if callable(action):
        action()
        return
    if action == "panic":
        raise FailpointPanic(name)
    if action == "error":
        raise FailpointError(name)
    m = re.match(r"sleep\((\d+)\)", action)
    if m:
        time.sleep(int(m.group(1)) / 1000.0)
        return
    raise ValueError(f"unknown failpoint action {action!r}")
