"""Layout of the round's telemetry frame: counter columns and invariant
bits.

Ports the constants of ``etcd_tpu/batched/telemetry.py`` (the port
keeps its own copy; tests/test_torch_planes.py pins it equal). With
``BatchedConfig.telemetry`` on, the round emits per-instance event
counters in ``TM_NAMES`` column order and an invariant bitmap in
``INV_NAMES`` bit order (step.py ``_telemetry_frame``,
kernels.py ``invariant_bits``); the engine accumulates both on the
device. The host hub (``TelemetryHub``) and its metric families are
not ported yet (ROADMAP A9, beside the hosting slice): the engine's
drains and the rawnode take any object with the hub's methods, and
the rawnode hands it each round's frame with ``lane_summary`` of the
outbox.
"""

from __future__ import annotations

from typing import List

import numpy as np

# Column order of TelemetryFrame.counters.
TM_NAMES = (
    "sent_vote_req",       # vote / pre-vote requests emitted
    "sent_append",         # MsgApp emitted (probes included)
    "sent_snapshot",       # MsgSnap emitted
    "sent_heartbeat",      # MsgHeartbeat emitted
    "sent_timeout_now",    # MsgTimeoutNow emitted (leader transfer)
    "sent_vote_resp",      # vote / pre-vote responses emitted
    "sent_append_resp",    # MsgAppResp emitted (accepts + rejects)
    "sent_heartbeat_resp",  # MsgHeartbeatResp emitted
    "recv_messages",       # inbox slots delivered (post-isolation)
    "append_accepted",     # inbound appends acked (reject=false)
    "append_rejected",     # inbound appends rejected (hint probing)
    "probe_to_replicate",  # peer transitions PROBE -> REPLICATE
    "to_snapshot",         # peer transitions into SNAPSHOT
    "to_probe",            # peer transitions into PROBE
    "elections_started",   # campaigns entered (candidate/pre-candidate)
    "elections_won",       # transitions into LEADER
    "commit_delta",        # commit-index advance this round
    "reads_confirmed",     # ReadIndex batches quorum-confirmed
    "proposals_dropped",   # staged proposals the device did not append
    "fenced_rounds",       # rounds spent durability-fenced
    # Membership-mask applications: always zero on the device (entry
    # types live in the host arena); the host adds them where it
    # stages the masks.
    "conf_changes_applied",
)
NUM_COUNTERS = len(TM_NAMES)
TM_INDEX = {n: i for i, n in enumerate(TM_NAMES)}

# Bit order of the invariant bitmap. Every bit is impossible under the
# raft model: a set bit means a kernel bug or a violated environment
# assumption (a torn WAL tail).
INV_NAMES = (
    "next_le_match",        # progress next <= match on a tracked peer
    "commit_gt_last",       # commit beyond the last log index
    "snap_gt_commit",       # compaction floor above commit
    "leader_lead_mismatch",  # leader whose lead pointer names another
    "probe_wedge",          # paused probe with next <= match
    "snapshot_stuck",       # SNAPSHOT state with pending <= match
    "read_ready_no_batch",  # confirmed read with no batch open
    "fenced_leader",        # durability-fenced instance became leader
    "voter_out_no_joint",   # outgoing-voter residue outside a joint config
    "ring_over_window",     # log-ring occupancy beyond the ring width W
    "lease_on_nonleader",   # leader-lease tick residue on a non-leader
)


def decode_invariants(bits: int) -> List[str]:
    return [n for i, n in enumerate(INV_NAMES) if bits & (1 << i)]


def lane_summary(valid: np.ndarray) -> List[int]:
    """Per-lane message counts from a [n, R, K] validity mask — the
    decoded inbox/outbox summary the flight recorder rides."""
    return np.asarray(valid).sum(axis=(0, 1)).astype(int).tolist()
