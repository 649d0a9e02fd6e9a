"""Wire-compatible raftpb message layer.

``raft_pb2`` is protoc-generated from ``raft.proto`` — a schema whose
field numbers replicate the reference's
``raft/raftpb/raft.proto`` (field numbers ARE the wire contract;
the gogoproto/versionpb options there are codegen-only and do not
affect the encoding). ``convert`` maps this repo's dataclass wire
types to/from the protobuf messages, emitting every non-nullable
field explicitly — the reference's gogo marshaler writes them
unconditionally, so explicit presence makes our bytes equal
byte-for-byte to Go's for the same logical message (decoding is
forgiving in both directions regardless).

``kv_pb2``/``kv_convert`` do the same for the etcdserverpb KV client
subset (KeyValue/ResponseHeader/Range/Put/DeleteRange plus the Txn
family: Compare with its target_union oneof, RequestOp/ResponseOp
unions, nested TxnRequest recursion — proto3, where
zero scalars are omitted by both sides, so no presence discipline is
needed). This closes the MESSAGE half of ecosystem interop; gRPC
transport framing remains descoped (README "Wire interop").

Ports ``etcd_tpu/pb/__init__.py``.
"""

from . import kv_pb2, raft_pb2  # noqa: F401
from . import kv_convert  # noqa: F401
from .convert import (  # noqa: F401
    confchange_from_pb,
    confchange_to_pb,
    confchange_v2_from_pb,
    confchange_v2_to_pb,
    entry_from_pb,
    entry_to_pb,
    hardstate_from_pb,
    hardstate_to_pb,
    message_from_bytes,
    message_from_pb,
    message_to_bytes,
    message_to_pb,
    snapshot_from_pb,
    snapshot_to_pb,
)
