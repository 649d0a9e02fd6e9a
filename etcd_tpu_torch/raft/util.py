"""Human-readable descriptions of raft data structures (ref: raft/util.go).

Ports ``etcd_tpu/raft/util.py`` whole; the renderings are byte-compatible
with the reference's.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .rawnode import Ready
from .read_only import ReadState
from .types import (
    ConfChange,
    ConfChangeV2,
    ConfState,
    Entry,
    EntryType,
    HardState,
    Message,
    Snapshot,
    conf_changes_to_string,
    is_empty_hard_state,
    is_empty_snap,
)
from .raft import SoftState

EntryFormatter = Callable[[bytes], str]

_GO_ESCAPES = {
    0x07: "\\a",
    0x08: "\\b",
    0x0C: "\\f",
    0x0A: "\\n",
    0x0D: "\\r",
    0x09: "\\t",
    0x0B: "\\v",
    0x5C: "\\\\",
    0x22: '\\"',
}


def go_quote(data: bytes) -> str:
    """Equivalent of Go's %q for a byte slice."""
    out = ['"']
    for b in data:
        if b in _GO_ESCAPES:
            out.append(_GO_ESCAPES[b])
        elif 0x20 <= b < 0x7F:
            out.append(chr(b))
        else:
            out.append(f"\\x{b:02x}")
    out.append('"')
    return "".join(out)


def default_entry_formatter(data: bytes) -> str:
    return go_quote(data)


def describe_hard_state(hs: HardState) -> str:
    buf = f"Term:{hs.term}"
    if hs.vote != 0:
        buf += f" Vote:{hs.vote}"
    buf += f" Commit:{hs.commit}"
    return buf


def describe_soft_state(ss: SoftState) -> str:
    return f"Lead:{ss.lead} State:{ss.raft_state}"


def describe_conf_state(state: ConfState) -> str:
    def sl(v: List[int]) -> str:
        return "[" + " ".join(str(x) for x in v) + "]"

    return (
        f"Voters:{sl(state.voters)} VotersOutgoing:{sl(state.voters_outgoing)} "
        f"Learners:{sl(state.learners)} LearnersNext:{sl(state.learners_next)} "
        f"AutoLeave:{'true' if state.auto_leave else 'false'}"
    )


def describe_snapshot(snap: Snapshot) -> str:
    m = snap.metadata
    return f"Index:{m.index} Term:{m.term} ConfState:{describe_conf_state(m.conf_state)}"


def describe_read_state(rs: ReadState) -> str:
    return "{%d %s}" % (rs.index, "[" + " ".join(str(b) for b in rs.request_ctx) + "]")


def describe_entry(e: Entry, f: Optional[EntryFormatter]) -> str:
    """ref: raft/util.go:166-199."""
    if f is None:
        f = go_quote

    if e.type == EntryType.EntryNormal:
        formatted = f(e.data)
    elif e.type == EntryType.EntryConfChange:
        formatted = conf_changes_to_string(ConfChange.unmarshal(e.data).as_v2().changes)
    elif e.type == EntryType.EntryConfChangeV2:
        formatted = conf_changes_to_string(ConfChangeV2.unmarshal(e.data).changes)
    else:
        formatted = ""
    if formatted:
        formatted = " " + formatted
    return f"{e.term}/{e.index} {e.type}{formatted}"


def describe_entries(ents: List[Entry], f: Optional[EntryFormatter]) -> str:
    return "".join(describe_entry(e, f) + "\n" for e in ents)


def describe_message(m: Message, f: Optional[EntryFormatter]) -> str:
    """ref: raft/util.go:137-163."""
    buf = [
        "%x->%x %s Term:%d Log:%d/%d"
        % (m.from_, m.to, m.type, m.term, m.log_term, m.index)
    ]
    if m.reject:
        buf.append(f" Rejected (Hint: {m.reject_hint})")
    if m.commit != 0:
        buf.append(f" Commit:{m.commit}")
    if m.entries:
        buf.append(" Entries:[")
        buf.append(", ".join(describe_entry(e, f) for e in m.entries))
        buf.append("]")
    if not is_empty_snap(m.snapshot):
        buf.append(f" Snapshot: {describe_snapshot(m.snapshot)}")
    return "".join(buf)


def describe_ready(rd: Ready, f: Optional[EntryFormatter]) -> str:
    """ref: raft/util.go:90-124."""
    buf: List[str] = []
    if rd.soft_state is not None:
        buf.append(describe_soft_state(rd.soft_state) + "\n")
    if not is_empty_hard_state(rd.hard_state):
        buf.append(f"HardState {describe_hard_state(rd.hard_state)}\n")
    if rd.read_states:
        states = " ".join(describe_read_state(rs) for rs in rd.read_states)
        buf.append(f"ReadStates [{states}]\n")
    if rd.entries:
        buf.append("Entries:\n")
        buf.append(describe_entries(rd.entries, f))
    if not is_empty_snap(rd.snapshot):
        buf.append(f"Snapshot {describe_snapshot(rd.snapshot)}\n")
    if rd.committed_entries:
        buf.append("CommittedEntries:\n")
        buf.append(describe_entries(rd.committed_entries, f))
    if rd.messages:
        buf.append("Messages:\n")
        for msg in rd.messages:
            buf.append(describe_message(msg, f) + "\n")
    if buf:
        return "Ready MustSync=%s:\n%s" % (
            "true" if rd.must_sync else "false",
            "".join(buf),
        )
    return "<empty Ready>"
