"""Parser for the cockroachdb/datadriven test-file format used by the
reference's interaction tests (ref: raft/interaction_test.go:24-38).

Ports ``etcd_tpu/rafttest/datadriven.py`` whole (stdlib only).

File format:

    # comment
    cmd arg1 key=val key2=(v1,v2)
    optional input lines
    ----
    expected output (terminated by a blank line)

Outputs containing blank lines are wrapped in double separators::

    cmd
    ----
    ----
    multi-line output

    with blank lines
    ----
    ----
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple


@dataclass
class CmdArg:
    key: str
    vals: List[str] = field(default_factory=list)


@dataclass
class TestData:
    pos: str = ""
    cmd: str = ""
    cmd_args: List[CmdArg] = field(default_factory=list)
    input: str = ""
    expected: str = ""


def _parse_args(tokens: List[str]) -> List[CmdArg]:
    args = []
    for tok in tokens:
        if "=" in tok:
            key, val = tok.split("=", 1)
            if val.startswith("(") and val.endswith(")"):
                vals = [v.strip() for v in val[1:-1].split(",") if v.strip()]
            else:
                vals = [val]
            args.append(CmdArg(key=key, vals=vals))
        else:
            args.append(CmdArg(key=tok))
    return args


def _tokenize(line: str) -> List[str]:
    """Split on whitespace, but keep parenthesized value lists intact even
    if they contain spaces (e.g. ``voters=(1, 2, 3)``)."""
    tokens: List[str] = []
    cur: List[str] = []
    depth = 0
    for ch in line:
        if ch == "(":
            depth += 1
            cur.append(ch)
        elif ch == ")":
            depth -= 1
            cur.append(ch)
        elif ch.isspace() and depth == 0:
            if cur:
                tokens.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        tokens.append("".join(cur))
    return tokens


def parse_file(path: str) -> List[TestData]:
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().split("\n")

    datas: List[TestData] = []
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            i += 1
            continue
        # Directive line.
        d = TestData(pos=f"{path}:{i + 1}")
        tokens = _tokenize(stripped)
        d.cmd = tokens[0]
        d.cmd_args = _parse_args(tokens[1:])
        i += 1
        # Input lines until the ---- separator.
        input_lines: List[str] = []
        while i < n and lines[i].strip() != "----":
            input_lines.append(lines[i])
            i += 1
        d.input = "\n".join(input_lines).strip()
        if i >= n:
            raise ValueError(f"{d.pos}: missing ---- separator")
        i += 1  # consume ----
        # Double-separator form allows blank lines in the output.
        if i < n and lines[i].strip() == "----":
            i += 1
            out_lines: List[str] = []
            while i < n:
                if (
                    lines[i].strip() == "----"
                    and i + 1 < n
                    and lines[i + 1].strip() == "----"
                ):
                    i += 2
                    break
                out_lines.append(lines[i])
                i += 1
            d.expected = "\n".join(out_lines)
        else:
            out_lines = []
            while i < n and lines[i].strip() != "":
                out_lines.append(lines[i])
                i += 1
            d.expected = "\n".join(out_lines)
        datas.append(d)
    return datas


def run_file(
    path: str, handler: Callable[[TestData], str]
) -> List[Tuple[TestData, str]]:
    """Run every directive through handler; returns (data, actual) for any
    mismatches (empty list == full parity)."""
    failures = []
    for d in parse_file(path):
        actual = handler(d)
        if actual.rstrip("\n") != d.expected.rstrip("\n"):
            failures.append((d, actual))
    return failures
