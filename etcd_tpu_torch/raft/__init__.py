"""Single-group Raft consensus core, reference semantics.

Ports ``etcd_tpu/raft`` whole and re-exports its public names. It is the
independent Raft of the port: the shadow cluster (``batched/shadow.py``)
holds every deliver shape of the batched round against it, and
raftexample's ``"host"`` backend runs on it. It imports no torch.
"""

from .types import (  # noqa: F401
    Entry,
    EntryType,
    HardState,
    Message,
    MessageType,
    Snapshot,
    SnapshotMetadata,
    ConfState,
    ConfChange,
    ConfChangeV2,
    ConfChangeSingle,
    ConfChangeType,
    ConfChangeTransition,
    EMPTY_HARD_STATE,
    is_empty_hard_state,
    is_empty_snap,
)
from .errors import (  # noqa: F401
    CompactedError,
    UnavailableError,
    SnapOutOfDateError,
    SnapshotTemporarilyUnavailableError,
    ProposalDroppedError,
    StepLocalMsgError,
    StepPeerNotFoundError,
)
from .storage import MemoryStorage, Storage  # noqa: F401
from .raft import Config, Raft, StateType, ReadOnlyOption, NONE  # noqa: F401
from .rawnode import RawNode, Ready, SoftState, ReadState  # noqa: F401
