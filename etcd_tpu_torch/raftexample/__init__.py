"""The raftexample-equivalent: a minimal replicated KV on the batched
raft round (ref: contrib/raftexample — the canonical Ready loop outside
etcdserver).

Ports ``etcd_tpu/raftexample``: ticker → Node; proposal queue → MsgProp;
Ready drain → WAL append/fsync → message router → apply to an in-memory
KV; in-proc N-node network with fault injection. Each member's Node is a
``BatchedNode`` (one row of the device round).
"""

from .transport import InProcNetwork  # noqa: F401
from .raftnode import ExampleRaftNode  # noqa: F401
from .kvstore import ReplicatedKV  # noqa: F401
