"""Interaction environment for data-driven raft testing
(ref: raft/rafttest/interaction_env.go and the handler files).

Ports ``etcd_tpu/rafttest/interaction.py`` whole, over the port's scalar
core (``etcd_tpu_torch/raft``); host code, no device. Semantics —
including output formatting, indentation, quiet levels and error
rendering — mirror the reference, so a script's expected text is the
same from either package. ``default_raft_config`` passes no ``rand``:
the text is deterministic because the interaction language has no
election ticks (elections come from ``campaign``).
"""

from __future__ import annotations

from typing import List, Optional

from ..raft.errors import RaftError
from ..raft.logger import Logger
from ..raft.raft import Config
from ..raft.rawnode import RawNode
from ..raft.storage import MemoryStorage
from ..raft.tracker import progress_map_str
from ..raft.types import (
    ConfChange,
    ConfChangeTransition,
    ConfChangeV2,
    Entry,
    EntryType,
    Message,
    Snapshot,
    SnapshotMetadata,
    ConfState,
    conf_changes_from_string,
    is_empty_hard_state,
    is_empty_snap,
)
from ..raft.util import (
    default_entry_formatter,
    describe_entries,
    describe_message,
    describe_ready,
)
from .datadriven import TestData

NO_LIMIT = (1 << 64) - 1
MAX_INT32 = (1 << 31) - 1

LVL_NAMES = ["DEBUG", "INFO", "WARN", "ERROR", "FATAL", "NONE"]


class RedirectLogger(Logger):
    """Level-gated logger writing into a string buffer
    (ref: rafttest/interaction_env_logger.go)."""

    def __init__(self):
        self.parts: List[str] = []
        self.lvl = 0  # 0=DEBUG 1=INFO 2=WARN 3=ERROR 4=FATAL 5=NONE

    # direct (ungated) writes, like fmt.Fprintf(env.Output, ...)
    def write(self, s: str) -> None:
        self.parts.append(s)

    def getvalue(self) -> str:
        return "".join(self.parts)

    def __len__(self) -> int:
        return sum(len(p) for p in self.parts)

    def reset(self) -> None:
        self.parts = []

    def _printf(self, lvl: int, fmt: str, args) -> None:
        if self.lvl <= lvl:
            msg = fmt % args if args else fmt
            if not msg.endswith("\n"):
                msg += "\n"
            self.parts.append(f"{LVL_NAMES[lvl]} {msg}")

    def debugf(self, fmt, *args):
        self._printf(0, fmt, args)

    def infof(self, fmt, *args):
        self._printf(1, fmt, args)

    def warningf(self, fmt, *args):
        self._printf(2, fmt, args)

    def errorf(self, fmt, *args):
        self._printf(3, fmt, args)

    def error(self, *args):
        if self.lvl <= 3:
            self.parts.append("ERROR " + " ".join(str(a) for a in args) + "\n")

    def fatalf(self, fmt, *args):
        self._printf(4, fmt, args)

    def panicf(self, fmt, *args):
        self._printf(4, fmt, args)
        raise RuntimeError(fmt % args if args else fmt)


class _HistorySnapshotStorage(MemoryStorage):
    """MemoryStorage whose snapshot() returns the most recent snapshot in
    the node's history (ref: interaction_env_handler_add_nodes.go
    snapOverrideStorage)."""

    def __init__(self, env: "InteractionEnv", node_id: int):
        super().__init__()
        self._env = env
        self._node_id = node_id

    def snapshot(self) -> Snapshot:
        snaps = self._env.nodes[self._node_id - 1].history
        return snaps[-1]


class Node:
    def __init__(self, rawnode: RawNode, storage: MemoryStorage, config: Config,
                 history: List[Snapshot]):
        self.rawnode = rawnode
        self.storage = storage
        self.config = config
        self.history = history


def default_raft_config(node_id: int, applied: int, storage) -> Config:
    """ref: rafttest/interaction_env.go:89-99."""
    return Config(
        id=node_id,
        applied=applied,
        election_tick=3,
        heartbeat_tick=1,
        storage=storage,
        max_size_per_msg=NO_LIMIT,
        max_inflight_msgs=MAX_INT32,
    )


class InteractionEnv:
    """ref: rafttest/interaction_env.go:43-49."""

    def __init__(self, on_config=None):
        self.on_config = on_config
        self.nodes: List[Node] = []
        self.messages: List[Message] = []  # in-flight
        self.output = RedirectLogger()

    # -- top-level dispatch ---------------------------------------------------

    def handle(self, d: TestData) -> str:
        self.output.reset()
        err: Optional[BaseException] = None
        try:
            handler = {
                "_breakpoint": lambda d: None,
                "add-nodes": self._handle_add_nodes,
                "campaign": self._handle_campaign,
                "compact": self._handle_compact,
                "deliver-msgs": self._handle_deliver_msgs,
                "process-ready": self._handle_process_ready,
                "log-level": self._handle_log_level,
                "raft-log": self._handle_raft_log,
                "raft-state": self._handle_raft_state,
                "stabilize": self._handle_stabilize,
                "status": self._handle_status,
                "tick-heartbeat": self._handle_tick_heartbeat,
                "transfer-leadership": self._handle_transfer_leadership,
                "propose": self._handle_propose,
                "propose-conf-change": self._handle_propose_conf_change,
            }.get(d.cmd)
            if handler is None:
                raise ValueError("unknown command")
            handler(d)
        except (RaftError, ValueError) as e:
            err = e
        if err is not None:
            self.output.write(str(err))
        if len(self.output) == 0:
            return "ok"
        if self.output.lvl == len(LVL_NAMES) - 1:
            if err is not None:
                return str(err)
            return "ok (quiet)"
        return self.output.getvalue()

    def _with_indent(self, f) -> None:
        """Indent all output produced by f by two spaces
        (ref: interaction_env.go:63-73)."""
        orig = self.output.parts
        self.output.parts = []
        f()
        produced = "".join(self.output.parts)
        self.output.parts = orig
        for line in produced.splitlines():
            self.output.write("  " + line + "\n")

    # -- handlers -------------------------------------------------------------

    def _handle_add_nodes(self, d: TestData) -> None:
        n = int(d.cmd_args[0].key)
        snap = Snapshot()
        for arg in d.cmd_args[1:]:
            for val in arg.vals:
                if arg.key == "voters":
                    snap.metadata.conf_state.voters.append(int(val))
                elif arg.key == "learners":
                    snap.metadata.conf_state.learners.append(int(val))
                elif arg.key == "index":
                    snap.metadata.index = int(val)
                elif arg.key == "content":
                    snap.data = val.encode()
        self.add_nodes(n, snap)

    def add_nodes(self, n: int, snap: Snapshot) -> None:
        """ref: interaction_env_handler_add_nodes.go:67-133."""
        bootstrap = bool(
            snap.data
            or snap.metadata.index
            or snap.metadata.term
            or snap.metadata.conf_state.voters
            or snap.metadata.conf_state.learners
        )
        for _ in range(n):
            node_id = 1 + len(self.nodes)
            s = _HistorySnapshotStorage(self, node_id)
            if bootstrap:
                if snap.metadata.index <= 1:
                    raise ValueError("index must be specified as > 1 due to bootstrap")
                snap.metadata.term = 1
                s.apply_snapshot(
                    Snapshot(
                        data=snap.data,
                        metadata=SnapshotMetadata(
                            conf_state=snap.metadata.conf_state.clone(),
                            index=snap.metadata.index,
                            term=snap.metadata.term,
                        ),
                    )
                )
                fi = s.first_index()
                if fi != snap.metadata.index + 1:
                    raise ValueError(
                        f"failed to establish first index {snap.metadata.index + 1}; got {fi}"
                    )
            cfg = default_raft_config(node_id, snap.metadata.index, s)
            if self.on_config is not None:
                self.on_config(cfg)
            cfg.logger = self.output
            rn = RawNode(cfg)
            node_snap = Snapshot(
                data=snap.data,
                metadata=SnapshotMetadata(
                    conf_state=snap.metadata.conf_state.clone(),
                    index=snap.metadata.index,
                    term=snap.metadata.term,
                ),
            )
            self.nodes.append(Node(rn, s, cfg, [node_snap]))

    def _handle_campaign(self, d: TestData) -> None:
        idx = int(d.cmd_args[0].key) - 1
        self.nodes[idx].rawnode.campaign()

    def _handle_compact(self, d: TestData) -> None:
        idx = int(d.cmd_args[0].key) - 1
        new_first_index = int(d.cmd_args[1].key)
        self.nodes[idx].storage.compact(new_first_index)
        self.raft_log(idx)

    def _handle_deliver_msgs(self, d: TestData) -> None:
        recipients = []  # (id, drop)
        for arg in d.cmd_args:
            if not arg.vals:
                recipients.append((int(arg.key), False))
            elif arg.key == "drop":
                for val in arg.vals:
                    recipients.append((int(val), True))
        if self.deliver_msgs(recipients) == 0:
            self.output.write("no messages\n")

    def deliver_msgs(self, recipients) -> int:
        """ref: interaction_env_handler_deliver_msgs.go:70-96."""
        n = 0
        for rid, drop in recipients:
            msgs = [m for m in self.messages if m.to == rid]
            self.messages = [m for m in self.messages if m.to != rid]
            n += len(msgs)
            for msg in msgs:
                if drop:
                    self.output.write("dropped: ")
                self.output.write(
                    describe_message(msg, default_entry_formatter) + "\n"
                )
                if drop:
                    continue
                to_idx = msg.to - 1
                try:
                    self.nodes[to_idx].rawnode.step(msg)
                except RaftError as e:
                    self.output.write(str(e) + "\n")
        return n

    def _handle_process_ready(self, d: TestData) -> None:
        idxs = self._node_idxs(d)
        for idx in idxs:
            if len(idxs) > 1:
                self.output.write(f"> {idx + 1} handling Ready\n")
                self._with_indent(lambda idx=idx: self.process_ready(idx))
            else:
                self.process_ready(idx)

    def process_ready(self, idx: int) -> None:
        """The canonical Ready-handling sequence: persist HardState and
        entries, apply snapshot, apply committed entries (an "appender"
        state machine recorded into history), collect messages, Advance
        (ref: interaction_env_handler_process_ready.go:43-105)."""
        node = self.nodes[idx]
        rn, s = node.rawnode, node.storage
        rd = rn.ready()
        self.output.write(describe_ready(rd, default_entry_formatter))
        if not is_empty_hard_state(rd.hard_state):
            s.set_hard_state(rd.hard_state)
        s.append(rd.entries)
        if not is_empty_snap(rd.snapshot):
            s.apply_snapshot(rd.snapshot)
        for ent in rd.committed_entries:
            update = b""
            cs: Optional[ConfState] = None
            if ent.type == EntryType.EntryConfChange:
                cc = ConfChange.unmarshal(ent.data)
                update = cc.context
                cs = rn.apply_conf_change(cc)
            elif ent.type == EntryType.EntryConfChangeV2:
                cc2 = ConfChangeV2.unmarshal(ent.data)
                cs = rn.apply_conf_change(cc2)
                update = cc2.context
            else:
                update = ent.data
            last_snap = node.history[-1]
            snap = Snapshot(data=last_snap.data + update)
            snap.metadata.index = ent.index
            snap.metadata.term = ent.term
            if cs is None:
                cs = node.history[-1].metadata.conf_state
            snap.metadata.conf_state = cs.clone()
            node.history.append(snap)
        self.messages.extend(rd.messages)
        rn.advance(rd)

    def _handle_log_level(self, d: TestData) -> None:
        name = d.cmd_args[0].key
        for i, s in enumerate(LVL_NAMES):
            if s.lower() == name.lower():
                self.output.lvl = i
                return
        raise ValueError(f"log levels must be either of {LVL_NAMES}")

    def _handle_raft_log(self, d: TestData) -> None:
        idx = int(d.cmd_args[0].key) - 1
        self.raft_log(idx)

    def raft_log(self, idx: int) -> None:
        s = self.nodes[idx].storage
        fi, li = s.first_index(), s.last_index()
        if li < fi:
            self.output.write(f"log is empty: first index={fi}, last index={li}")
            return
        ents = s.entries(fi, li + 1, NO_LIMIT)
        self.output.write(describe_entries(ents, default_entry_formatter))

    def _handle_raft_state(self, d: TestData) -> None:
        """ref: interaction_env_handler_raftstate.go:31-44."""
        for node in self.nodes:
            st = node.rawnode.status()
            voter = st.basic.id in st.config.voters.ids()
            status = "(Voter)" if voter else "(Non-Voter)"
            self.output.write(f"{st.basic.id}: {st.raft_state} {status}\n")

    def _handle_stabilize(self, d: TestData) -> None:
        idxs = self._node_idxs(d)
        self.stabilize(idxs)

    def stabilize(self, idxs: List[int]) -> None:
        """Run Ready handling and message delivery to a fixed point
        (ref: interaction_env_handler_stabilize.go:32-63)."""
        nodes = [self.nodes[i] for i in idxs] if idxs else list(self.nodes)
        while True:
            done = True
            for node in nodes:
                if node.rawnode.has_ready():
                    done = False
                    idx = node.rawnode.status().basic.id - 1
                    self.output.write(f"> {idx + 1} handling Ready\n")
                    self._with_indent(lambda idx=idx: self.process_ready(idx))
            for node in nodes:
                node_id = node.rawnode.status().basic.id
                if any(m.to == node_id for m in self.messages):
                    self.output.write(f"> {node_id} receiving messages\n")
                    self._with_indent(
                        lambda node_id=node_id: self.deliver_msgs([(node_id, False)])
                    )
                    done = False
            if done:
                return

    def _handle_status(self, d: TestData) -> None:
        idx = int(d.cmd_args[0].key) - 1
        st = self.nodes[idx].rawnode.status()
        self.output.write(progress_map_str(st.progress))

    def _handle_tick_heartbeat(self, d: TestData) -> None:
        idx = int(d.cmd_args[0].key) - 1
        for _ in range(self.nodes[idx].config.heartbeat_tick):
            self.nodes[idx].rawnode.tick()

    def _handle_transfer_leadership(self, d: TestData) -> None:
        from_id = to_id = 0
        for arg in d.cmd_args:
            if arg.key == "from":
                from_id = int(arg.vals[0])
            elif arg.key == "to":
                to_id = int(arg.vals[0])
        if from_id == 0 or from_id > len(self.nodes):
            raise ValueError('expected valid "from" argument')
        if to_id == 0 or to_id > len(self.nodes):
            raise ValueError('expected valid "to" argument')
        self.nodes[from_id - 1].rawnode.transfer_leader(to_id)

    def _handle_propose(self, d: TestData) -> None:
        idx = int(d.cmd_args[0].key) - 1
        if len(d.cmd_args) != 2 or d.cmd_args[1].vals:
            raise ValueError("expected exactly one key with no vals")
        self.nodes[idx].rawnode.propose(d.cmd_args[1].key.encode())

    def _handle_propose_conf_change(self, d: TestData) -> None:
        idx = int(d.cmd_args[0].key) - 1
        v1 = False
        transition = ConfChangeTransition.ConfChangeTransitionAuto
        for arg in d.cmd_args[1:]:
            for val in arg.vals:
                if arg.key == "v1":
                    v1 = val.lower() == "true"
                elif arg.key == "transition":
                    transition = {
                        "auto": ConfChangeTransition.ConfChangeTransitionAuto,
                        "implicit": ConfChangeTransition.ConfChangeTransitionJointImplicit,
                        "explicit": ConfChangeTransition.ConfChangeTransitionJointExplicit,
                    }.get(val)
                    if transition is None:
                        raise ValueError(f"unknown transition {val}")
                else:
                    raise ValueError(f"unknown command {arg.key}")
        ccs = conf_changes_from_string(d.input)
        if v1:
            if len(ccs) > 1 or transition != ConfChangeTransition.ConfChangeTransitionAuto:
                raise ValueError(
                    "v1 conf change can only have one operation and no transition"
                )
            cc = ConfChange(type=ccs[0].type, node_id=ccs[0].node_id)
            self.nodes[idx].rawnode.propose_conf_change(cc)
        else:
            cc2 = ConfChangeV2(transition=transition, changes=ccs)
            self.nodes[idx].rawnode.propose_conf_change(cc2)

    # -- helpers --------------------------------------------------------------

    @staticmethod
    def _node_idxs(d: TestData) -> List[int]:
        return [int(a.key) - 1 for a in d.cmd_args if not a.vals]
