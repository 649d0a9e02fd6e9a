"""The yardstick of the Hopper kernels' roofline: the chip's published
peaks and each kernel form's bytes and operations.

A frozen copy of ``bound_ms`` and ``form_cost`` of
``etcd_tpu_torch/tools/kernel_times.py`` as the benchmark was written
(portbench/tests holds the two equal on seeded inputs). The bytes count
the work of the form's inputs, whatever implements it: each input read
once (for the ring, the distinct slots the queries read inside it),
each output written once.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
# The 32-bit rate outside the tensor cores (67 TFLOP/s float32): the
# quorum and ring kernels do integer compares and adds, no matrix work.
OPS_PER_S = 67e12


def bound_ms(nbytes: float, ops: float) -> "tuple[float, str]":
    """The least time the card could take: bytes at the HBM rate or
    operations at the 32-bit rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def form_cost(key: str, args) -> "tuple[float, float]":
    """The bytes and operations of one call of form `key` ("quorum_commit_vote
    commit ...", "... vote ...", "... both ...", "term_at_batch ...") on
    `args`, its wrapper's arguments (quorum_commit, quorum_vote,
    quorum_commit_vote, term_at_batch). Operations: B1's O(R^2) support
    loop a half for commit, 4R compares a half for a vote tally, on every
    row, twice on a joint row; B2's 8 a query."""
    if key.startswith("term_at_batch"):
        log_term, snap_index, _snap_term, last, idx = args[:5]
        n, w = log_term.shape
        flat = idx.reshape(n, -1)
        ring = ((flat > snap_index.unsqueeze(-1))
                & (flat <= last.unsqueeze(-1)))
        slots = torch.where(flat >= 0, flat % w, 0).long() + w * torch.arange(
            n, device=flat.device).unsqueeze(-1)
        reads = torch.unique(slots[ring]).numel()
        return 4 * (3 * n + 2 * flat.numel() + reads), 8 * flat.numel()
    vals, voter, _voter_out, in_joint = args[:4]
    n, r = voter.shape
    rows = vals.numel() // r  # B tallies an instance
    joint = in_joint.float().mean().item()
    kind = key.split()[1]
    support = r + r * (2 * r + 2)  # the O(R^2) support loop of a half
    per_row = {"commit": support, "vote": 4 * r, "both": support + 4 * r}
    tallies = 2 if kind == "both" else 1  # commit's inputs and votes
    return (tallies * rows * (4 * r + 4) + n * (2 * r + 1),
            rows * (1 + joint) * per_row[kind])


def form_key(wrapper: str, args) -> str:
    """The form of one wrapper call, as the program's launch counts name
    it: "quorum_commit_vote <mode> R=<r> B=<tallies>" or
    "term_at_batch K=<k> W=<w>"."""
    if wrapper == "term_at_batch":
        log_term, idx = args[0], args[4]
        k = idx.shape[1] if idx.dim() == 2 else 1
        return f"term_at_batch K={k} W={log_term.shape[1]}"
    r = args[1].shape[1]
    if wrapper == "quorum_commit":
        return f"quorum_commit_vote commit R={r} B=1"
    if wrapper == "quorum_vote":
        tallies = args[4] if len(args) > 4 else 1
        return f"quorum_commit_vote vote R={r} B={tallies}"
    return f"quorum_commit_vote both R={r} B=1"


def spy_bounds(hk, run) -> "tuple[dict, float]":
    """Run `run()` (one eager round) with a spy on the program's kernel
    wrappers (module `hk`): each launch's form and bound. Returns
    ({form: launches}, the round's summed bound in ms)."""
    names = ("quorum_commit", "quorum_vote", "quorum_commit_vote",
             "term_at_batch")
    wrappers = {name: getattr(hk, name) for name in names}
    seen = []

    def spy(name):
        def call(*args):
            seen.append((form_key(name, args),
                         [a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args]))
            return wrappers[name](*args)
        return call

    for name in names:
        setattr(hk, name, spy(name))
    try:
        run()
    finally:
        for name, fn in wrappers.items():
            setattr(hk, name, fn)
    forms: dict = {}
    total = 0.0
    for key, args in seen:
        forms[key] = forms.get(key, 0) + 1
        total += bound_ms(*form_cost(key, args))[0]
    return forms, total
