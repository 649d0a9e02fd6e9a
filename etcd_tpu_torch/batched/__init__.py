"""Batched multi-Raft engine in PyTorch (ports ``etcd_tpu/batched``).

Groups are packed into structure-of-arrays tensors and stepped in
lockstep, one row per replica instance:

- ``state``:   per-instance SoA state ``[N, ...]``, ``N = groups ×
               replicas``; log tails are ``[N, W]`` term rings; leader
               progress is ``[N, R]``.
- ``kernels``: the replica-axis reductions and log-ring primitives as
               plain PyTorch; the quorum and term sites launch the
               Hopper kernels on CUDA tensors.
- ``hopper_kernels``: the two CUDA kernels (``csrc/quorum_ring.cu``),
               their build, launch counts and plain versions.
- ``step``:    the branch-free round over the instance axis (vectorized
               deliver → tick → control → propose → emit), its
               telemetry and fleet frames, and the router (a transpose
               over the dense layout).
- ``telemetry``: the telemetry frame's counter and invariant layout, the
               host hub and the metric families.
- ``applyplane``: the device apply plane (hash-slot MVCC, watches and
               lease expiry over a row axis) and its host oracle.
- ``membership``: the per-group membership store (GroupConfStore).
- ``engine``:  the closed-loop MultiRaftEngine (on CUDA, a replayed
               CUDA graph of one round).
- ``rawnode``: BatchedRawNode, the hosted entry point (stage → round →
               BatchedReady → advance; on CUDA a graph replay per round).
- ``msgblock``: the SoA message codec (frames byte-equal to etcd_tpu's).
- ``graph``:   the capture, replay and write-back shared by the two.
- ``convert``: state and messages to and from numpy.
- ``node``:    BatchedNode, the raft.Node boundary over the rawnode.
- ``hosting``: MultiRaftMember/MultiRaftCluster — G groups × R members
               served end-to-end (native WAL, per-group KV apply), with
               the in-process and TCP routers.
- ``shmfabric``: the mmap'd shared-memory ring fabric between members.
- ``faults``:  the seeded chaos plane over hosting (message, storage,
               disk and process faults) and its invariant checks.
"""

from .state import BatchedConfig, BatchedState, init_state  # noqa: F401
from .step import make_step_round  # noqa: F401
from .engine import MultiRaftEngine  # noqa: F401
from .rawnode import BatchedRawNode, BatchedReady, RowRestore  # noqa: F401
from .node import BatchedNode  # noqa: F401
from .hosting import MultiRaftCluster, MultiRaftMember  # noqa: F401
from .faults import (  # noqa: F401
    ChaosHarness,
    FaultPlan,
    FaultSpec,
    FaultyFabric,
    LeaderObserver,
)
from .telemetry import (  # noqa: F401
    INV_NAMES,
    TM_INDEX,
    TM_NAMES,
    TelemetryHub,
)
