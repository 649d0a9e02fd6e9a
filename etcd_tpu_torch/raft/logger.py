"""Logger interface for the consensus core (ref: raft/logger.go).

Ports ``etcd_tpu/raft/logger.py`` whole. Log lines are part of the
observable contract, so formatting uses printf-style strings identical to
the reference's.
"""

from __future__ import annotations

import sys


class Logger:
    """Level methods mirror raft/logger.go:25 Logger."""

    def debugf(self, fmt: str, *args) -> None: ...

    def infof(self, fmt: str, *args) -> None: ...

    def warningf(self, fmt: str, *args) -> None: ...

    def errorf(self, fmt: str, *args) -> None: ...

    def fatalf(self, fmt: str, *args) -> None: ...

    def panicf(self, fmt: str, *args) -> None:
        raise RuntimeError(fmt % args if args else fmt)

    def error(self, *args) -> None: ...


class DefaultLogger(Logger):
    """Prints to stderr (ref: raft/logger.go DefaultLogger)."""

    def __init__(self, level: int = 1):
        self.level = level  # 0=DEBUG 1=INFO 2=WARN 3=ERROR

    def _emit(self, lvl: int, name: str, fmt: str, args) -> None:
        if self.level <= lvl:
            print(name, fmt % args if args else fmt, file=sys.stderr)

    def debugf(self, fmt: str, *args) -> None:
        self._emit(0, "DEBUG", fmt, args)

    def infof(self, fmt: str, *args) -> None:
        self._emit(1, "INFO", fmt, args)

    def warningf(self, fmt: str, *args) -> None:
        self._emit(2, "WARN", fmt, args)

    def errorf(self, fmt: str, *args) -> None:
        self._emit(3, "ERROR", fmt, args)

    def error(self, *args) -> None:
        self._emit(3, "ERROR", " ".join(str(a) for a in args), ())

    def fatalf(self, fmt: str, *args) -> None:
        self._emit(4, "FATAL", fmt, args)

    def panicf(self, fmt: str, *args) -> None:
        self._emit(4, "FATAL", fmt, args)
        raise RuntimeError(fmt % args if args else fmt)


_global_logger = DefaultLogger()


def get_logger() -> Logger:
    return _global_logger


def set_logger(logger: Logger) -> None:
    global _global_logger
    _global_logger = logger
