"""Shared error types spanning layers (ref: api/v3rpc/rpctypes/error.go
— one canonical table; the client failover set matches these by class
name, so every layer must raise the same classes).

Ports ``etcd_tpu/pkg/errors.py`` whole; the port keeps its own copy and
tests/test_torch_hubs.py pins it equal.
"""


class NotLeaderError(Exception):
    """ref: rpctypes.ErrNotLeader — retry against the leader."""


class LearnerNotReadyError(Exception):
    """ref: rpctypes.ErrGRPCLearnerNotReady — can only promote a
    learner member which is in sync with the leader."""
