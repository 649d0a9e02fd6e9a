"""SoA state for the batched multi-Raft engine, in PyTorch.

Ports ``etcd_tpu/batched/state.py``. Layout: one *replica instance* per
row. Instance ``i`` is replica slot ``i % R`` of group ``i // R``; the
dense layout makes the network router a transpose (see step.py). All
tensors are int32/bool, with the instance axis first: ``[N]``,
``[N, R]`` and the ``[N, W]`` term ring.

State fields mirror the reference raft struct (ref: raft/raft.go:243-316)
and tracker.Progress (ref: raft/tracker/progress.go:30-80), with the
per-peer maps flattened to ``[N, R]`` and the log flattened to a term
ring (entry payloads live in the host arena; commit decisions only ever
touch (term, index)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Role encoding (matches the raft StateType values).
FOLLOWER, CANDIDATE, LEADER, PRECANDIDATE = 0, 1, 2, 3

# Progress state encoding (matches tracker.ProgressStateType).
PROBE, REPLICATE, SNAPSHOT = 0, 1, 2

I32 = torch.int32
I16 = torch.int16
I8 = torch.int8

# The SoA wire record packs the per-message entry count as one byte; a
# config exceeding this would silently wrap the count on the wire.
MAX_WIRE_ENTS = 255

# The deliver shapes a config may name (BatchedConfig.deliver_shape):
# the sender scans "lanes" and "merged" and the scan-free "vectorized"
# fold (step.py _deliver_all).
DELIVER_SHAPES = ("lanes", "merged", "vectorized")


def default_deliver_shape() -> str:
    """deliver_shape="auto" resolves to the vectorized shape: it is the
    only shape with no sequential sender scan, so each round is a fixed
    sequence of whole-batch tensor ops."""
    return "vectorized"


def resolve_device(device=None) -> torch.device:
    """The device an entry point places its tensors on: the GPU unless
    the caller names another. Without CUDA, a caller that named no
    device gets an error, never a quiet run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


class BatchedConfig(NamedTuple):
    """Static engine configuration (field-for-field the JAX package's)."""

    num_groups: int
    num_replicas: int  # R: replica slots per group
    window: int  # W: log-ring capacity per instance
    max_ents_per_msg: int  # E: entries carried by one MsgApp
    max_props_per_round: int  # P: proposals appended per instance per round
    election_timeout: int = 10
    heartbeat_timeout: int = 1
    max_inflight: int = 256
    pre_vote: bool = False
    check_quorum: bool = False
    # Advance snap_index toward the applied watermark each round,
    # keeping window//2 entries of tail for follower catch-up; laggards
    # beyond that take the snapshot path (ref: etcdserver's
    # SnapshotCount / CatchUpEntries policy, server.go:73,80).
    auto_compact: bool = False
    # A layout hint for the TPU (instance axis minor inside the round).
    # The PyTorch round always runs instance-major; the field is kept so
    # configs stay field-equal across the two packages.
    lanes_minor: bool = False
    # How one instance's [R, K] inbox is folded into state: "lanes",
    # "merged" or "vectorized" (step.py _deliver_all); "auto" resolves
    # to default_deliver_shape().
    deliver_shape: str = "auto"
    # Store the bounded hot lanes (NARROW_DTYPES) in int8/int16 between
    # rounds; the round widens them to int32 at entry and narrows at
    # exit, so protocol math is bit-identical.
    narrow_lanes: bool = False
    # Per-round telemetry and fleet-summary frames (not ported yet:
    # make_step_round refuses them).
    telemetry: bool = False
    fleet_summary: bool = False
    # Device apply plane knobs: a separate program, never part of the
    # round (apply_plane_key strips them).
    apply_plane: bool = False
    apply_capacity: int = 256
    apply_watch_slots: int = 8
    apply_records: int = 8
    lease_read_margin: int = 2

    @property
    def num_instances(self) -> int:
        return self.num_groups * self.num_replicas

    def validate(self) -> "BatchedConfig":
        """Bounds the wire/state layouts rely on; a bad config fails at
        build time instead of corrupting silently at runtime."""
        if not 0 < self.max_ents_per_msg <= MAX_WIRE_ENTS:
            raise ValueError(
                f"max_ents_per_msg={self.max_ents_per_msg} out of range: "
                f"the wire record packs n_ents as one byte "
                f"(1..{MAX_WIRE_ENTS}); larger appends would wrap the "
                "entry count on the SoA block path")
        if not 0 < self.num_replicas <= 127:
            raise ValueError(
                f"num_replicas={self.num_replicas} out of range: member "
                "ids (slot+1) ride one-byte wire fields and int8 lanes")
        if self.narrow_lanes and self.max_inflight > 32767:
            raise ValueError(
                f"max_inflight={self.max_inflight} does not fit the "
                "int16 inflight lane; lower it or disable narrow_lanes")
        if self.deliver_shape not in ("auto",) + DELIVER_SHAPES:
            raise ValueError(
                f"deliver_shape={self.deliver_shape!r} not in "
                f"{('auto',) + DELIVER_SHAPES}")
        if self.apply_plane:
            if self.apply_capacity < 1:
                raise ValueError(
                    f"apply_capacity={self.apply_capacity} must be >= 1")
            if not 0 < self.apply_watch_slots <= 32:
                raise ValueError(
                    f"apply_watch_slots={self.apply_watch_slots} out of "
                    "range 1..32: watch matches pack into one i32 "
                    "bitmap lane of the event frame")
            if self.apply_records < 1:
                raise ValueError(
                    f"apply_records={self.apply_records} must be >= 1")
            if self.lease_read_margin < 1:
                raise ValueError(
                    f"lease_read_margin={self.lease_read_margin} must "
                    "be >= 1: a zero margin serves a read on the tick "
                    "the lease dies")
        return self

    def apply_plane_key(self) -> "BatchedConfig":
        """The config with every apply-plane knob at its default: the
        plane is a separate program, so none of its knobs may change
        the round."""
        return self._replace(
            apply_plane=False,
            apply_capacity=256,
            apply_watch_slots=8,
            apply_records=8,
            lease_read_margin=2,
        )

    def resolved(self) -> "BatchedConfig":
        """Resolve deliver_shape="auto" to default_deliver_shape()."""
        if self.deliver_shape != "auto":
            return self
        return self._replace(deliver_shape=default_deliver_shape())


class BatchedState(NamedTuple):
    """Per-instance consensus state, all leading dim N = G*R."""

    # HardState + role (ref: raft.go:246-247,259,267)
    term: torch.Tensor  # [N] i32
    vote: torch.Tensor  # [N] i32, replica slot + 1; 0 = None
    role: torch.Tensor  # [N] i32 (FOLLOWER/CANDIDATE/LEADER/PRECANDIDATE)
    lead: torch.Tensor  # [N] i32, slot + 1; 0 = None

    # Log (ref: raft/log.go raftLog) — ring of terms plus watermarks.
    log_term: torch.Tensor  # [N, W] i32; term of entry i at ring slot i % W
    snap_index: torch.Tensor  # [N] i32: index covered by snapshot
    snap_term: torch.Tensor  # [N] i32
    last: torch.Tensor  # [N] i32: last log index
    commit: torch.Tensor  # [N] i32
    applied: torch.Tensor  # [N] i32

    # Ticks (ref: raft.go:285-303)
    election_elapsed: torch.Tensor  # [N] i32
    heartbeat_elapsed: torch.Tensor  # [N] i32
    randomized_timeout: torch.Tensor  # [N] i32
    reset_count: torch.Tensor  # [N] i32 (drives the timeout hash)

    # Leader-side per-peer progress (ref: tracker/progress.go)
    match: torch.Tensor  # [N, R] i32
    next: torch.Tensor  # [N, R] i32
    pr_state: torch.Tensor  # [N, R] i32 (PROBE/REPLICATE/SNAPSHOT)
    probe_sent: torch.Tensor  # [N, R] bool
    pending_snapshot: torch.Tensor  # [N, R] i32
    recent_active: torch.Tensor  # [N, R] bool
    inflight: torch.Tensor  # [N, R] i32 (count of in-flight appends)

    # Votes: -1 not voted, 0 rejected, 1 granted
    votes: torch.Tensor  # [N, R] i32

    # Membership (ref: tracker.Config / quorum/joint.go): incoming
    # voters, outgoing voters (joint), learners; in_joint gates the
    # second quorum half.
    voter: torch.Tensor  # [N, R] bool
    voter_out: torch.Tensor  # [N, R] bool (only meaningful when in_joint)
    learner: torch.Tensor  # [N, R] bool
    in_joint: torch.Tensor  # [N] bool

    # Durability fence: a fenced instance neither campaigns nor grants
    # votes, but still accepts appends and heartbeats.
    fenced: torch.Tensor  # [N] bool

    # Leader transfer (ref: raft.go:1339-1372; raft.leadTransferee).
    transferee: torch.Tensor  # [N] i32, slot+1; 0 = no transfer pending
    transfer_sent: torch.Tensor  # [N] bool — TimeoutNow already emitted

    # ReadIndex (ref: read_only.go:39-112, ReadOnlySafe).
    read_seq: torch.Tensor  # [N] i32
    read_index: torch.Tensor  # [N] i32, commit at request time; -1 none
    read_acks: torch.Tensor  # [N, R] bool
    read_ready: torch.Tensor  # [N] bool
    read_req_latch: torch.Tensor  # [N] bool

    # Pending send flags consumed by the emit phase.
    send_append: torch.Tensor  # [N, R] bool
    send_heartbeat: torch.Tensor  # [N, R] bool
    send_vote_req: torch.Tensor  # [N] bool
    vote_req_is_pre: torch.Tensor  # [N] bool
    vote_req_transfer: torch.Tensor  # [N] bool
    send_timeout_now: torch.Tensor  # [N] bool

    # Leader lease: remaining ticks for which this leader may serve
    # linearizable reads locally (zero on every non-leader).
    lease_ticks: torch.Tensor  # [N] i32


# Narrow storage dtype per hot lane (cfg.narrow_lanes). Values are
# bounded: roles 0..3, member ids 0..R+1 (R <= 127), vote tallies
# -1..1, progress states 0..2, inflight <= max_inflight (validated
# <= int16 max). Everything else keeps its wide dtype.
NARROW_DTYPES = {
    "role": I8,
    "vote": I8,
    "lead": I8,
    "transferee": I8,
    "votes": I8,
    "pr_state": I8,
    "inflight": I16,
}


def narrow_state(st: BatchedState) -> BatchedState:
    """Cast the bounded lanes to their narrow storage dtypes."""
    return st._replace(**{
        f: getattr(st, f).to(dt) for f, dt in NARROW_DTYPES.items()
    })


def widen_state(st: BatchedState) -> BatchedState:
    """Cast narrow storage lanes back to int32 for the round."""
    return st._replace(**{f: getattr(st, f).to(I32) for f in NARROW_DTYPES})


def instance_slot(cfg: BatchedConfig, device=None) -> torch.Tensor:
    """[N] replica slot of each instance (used as `self id - 1`)."""
    dev = resolve_device(device)
    return torch.arange(cfg.num_instances, dtype=I32, device=dev) % (
        cfg.num_replicas)


def init_state(cfg: BatchedConfig, start_index: int = 0, iids=None,
               device=None) -> BatchedState:
    """All groups bootstrapped as followers at term 0 with R voters, log
    beginning at start_index.

    `iids` (optional) gives each row its global instance id
    (group*R + slot), so the deterministic randomized-timeout hash of a
    subset of rows matches the dense all-replica layout. Tensors go to
    `device` (default: the GPU), or to the device of a tensor `iids`."""
    if isinstance(iids, torch.Tensor) and device is None:
        dev = iids.device
    else:
        dev = resolve_device(device)
    r, w = cfg.num_replicas, cfg.window
    if iids is None:
        iids = torch.arange(cfg.num_instances, dtype=I32, device=dev)
    else:
        iids = torch.as_tensor(iids, dtype=I32, device=dev)
    n = iids.shape[0]

    def full(shape, value, dtype=I32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    zeros_n = lambda: full((n,), 0)  # noqa: E731
    start = lambda: full((n,), start_index)  # noqa: E731
    st = BatchedState(
        term=zeros_n(),
        vote=zeros_n(),
        role=full((n,), FOLLOWER),
        lead=zeros_n(),
        log_term=full((n, w), 0),
        snap_index=start(),
        snap_term=full((n,), 1 if start_index > 0 else 0),
        last=start(),
        commit=start(),
        applied=start(),
        election_elapsed=zeros_n(),
        heartbeat_elapsed=zeros_n(),
        # Per-instance randomized [et, 2et) from the start (reset_count
        # 0 of the deterministic hash): a uniform value would make every
        # boot election a guaranteed split vote.
        randomized_timeout=cfg.election_timeout
        + ((iids + 1) * 7919 % cfg.election_timeout),
        reset_count=zeros_n(),
        match=full((n, r), 0),
        next=full((n, r), start_index + 1),
        pr_state=full((n, r), PROBE),
        probe_sent=full((n, r), False, torch.bool),
        pending_snapshot=full((n, r), 0),
        recent_active=full((n, r), False, torch.bool),
        inflight=full((n, r), 0),
        votes=full((n, r), -1),
        voter=full((n, r), True, torch.bool),
        voter_out=full((n, r), False, torch.bool),
        learner=full((n, r), False, torch.bool),
        in_joint=full((n,), False, torch.bool),
        fenced=full((n,), False, torch.bool),
        transferee=zeros_n(),
        transfer_sent=full((n,), False, torch.bool),
        read_seq=zeros_n(),
        read_index=full((n,), -1),
        read_acks=full((n, r), False, torch.bool),
        read_ready=full((n,), False, torch.bool),
        read_req_latch=full((n,), False, torch.bool),
        send_append=full((n, r), False, torch.bool),
        send_heartbeat=full((n, r), False, torch.bool),
        send_vote_req=full((n,), False, torch.bool),
        vote_req_is_pre=full((n,), False, torch.bool),
        vote_req_transfer=full((n,), False, torch.bool),
        send_timeout_now=full((n,), False, torch.bool),
        lease_ticks=zeros_n(),
    )
    if cfg.narrow_lanes:
        st = narrow_state(st)
    return st
