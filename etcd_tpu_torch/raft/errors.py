"""Error types of the consensus core (ref: raft/storage.go:24-38,
raft/raft.go:75, raft/rawnode.go:24-29).

Ports ``etcd_tpu/raft/errors.py`` whole; the strings are the reference's.
"""


class RaftError(Exception):
    pass


class CompactedError(RaftError):
    def __str__(self) -> str:
        return "requested index is unavailable due to compaction"


class SnapOutOfDateError(RaftError):
    def __str__(self) -> str:
        return "requested index is older than the existing snapshot"


class UnavailableError(RaftError):
    def __str__(self) -> str:
        return "requested entry at index is unavailable"


class SnapshotTemporarilyUnavailableError(RaftError):
    def __str__(self) -> str:
        return "snapshot is temporarily unavailable"


class ProposalDroppedError(RaftError):
    def __str__(self) -> str:
        return "raft proposal dropped"


class StepLocalMsgError(RaftError):
    def __str__(self) -> str:
        return "raft: cannot step raft local message"


class StepPeerNotFoundError(RaftError):
    def __str__(self) -> str:
        return "raft: cannot step as peer not found"
