"""The check turns ``correct`` false when the timed path is broken
underneath a run (every other part of the run as it is), and for the
control: the program with the guarantee that the configurations state
broken, committing what one replica fewer than a majority holds.

Faults: a round that returns its state unchanged; half the groups left
out of each round; an answer altered where it is produced (a leader
acknowledges entries a majority does not hold); one commit withheld
from a sampled group for a round. One chip has no exchange between
chips to leave out."""

import contextlib
import sys

import pytest
import torch

from portbench import bench, spec
from portbench.tests.tiny import run_tiny

FAULT_ROUND = 30  # the loop round a one-off fault hits


class Faulty:
    """The program's engine with a fault planted under the benchmark's
    rounds (those called with proposal counts); set-up runs as it is."""

    def __init__(self, fields, device, fault, group=0):
        self.eng = bench.program_engine(fields, device)
        self.fault, self.group = fault, group
        self.r = fields["num_replicas"]
        self.rounds = 0

    def __getattr__(self, name):
        return getattr(self.eng, name)

    def run_rounds(self, rounds, tick=True, propose_n=None):
        if propose_n is None:
            return self.eng.run_rounds(rounds, tick=tick)
        self.rounds += 1
        st = self.eng.state
        if self.fault == "unchanged":
            return None
        if self.fault == "half":
            n = st.term.shape[0]
            cut = n // self.r // 2 * self.r
            keep = [x[cut:].clone() for x in tuple(st) + tuple(self.inbox)]
            self.eng.run_rounds(rounds, tick=tick, propose_n=propose_n)
            for x, old in zip(tuple(st) + tuple(self.inbox), keep):
                x[cut:] = old
            return None
        self.eng.run_rounds(rounds, tick=tick, propose_n=propose_n)
        if self.rounds == FAULT_ROUND:
            row = self.group * self.r
            if self.fault == "false_ack":
                st.commit[row] = st.last[row]
            elif self.fault == "withheld":
                st.commit[row] -= 1
        return None


def _outside_sample(groups, seed):
    """A group the check's sample leaves out (a closed loop's sample)."""
    sample = bench.sample_groups(groups, 3,
                                 torch.Generator().manual_seed(seed),
                                 None).tolist()
    return next(g for g in range(groups) if g not in sample)


@pytest.mark.parametrize("fault", ["unchanged", "half", "withheld"])
def test_a_broken_round_is_not_correct(fault):
    out = run_tiny("r3-100k.closed", make_engine=lambda f, d: Faulty(
        f, d, fault))
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["ref_mismatches"]["value"] > 0


def test_a_false_ack_outside_the_sample_is_not_correct():
    groups, seed = 72, 99
    group = _outside_sample(groups, seed)
    out = run_tiny("r3-100k.closed", seed=seed, groups=groups,
                   make_engine=lambda f, d: Faulty(f, d, "false_ack", group))
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["guarantee_breaks"]["value"] > 0


def _quorum_of_one(match, voter, voter_out, in_joint):
    """Commit what any one voter holds: the leader's own log. (A quorum
    one replica short reads as a majority at R = 5, where the followers
    acknowledge in the same rounds.)"""
    return torch.where(voter, match, 0).max(-1).values.contiguous()


class Control:
    """The program, committing on a quorum of one for every round it
    runs or captures: the one guarantee of the configuration that it
    breaks."""

    def __init__(self, fields, device):
        with self._broken():
            self.eng = bench.program_engine(fields, device)

    @staticmethod
    @contextlib.contextmanager
    def _broken():
        from etcd_tpu_torch.batched import step

        old = step.joint_committed
        step.joint_committed = _quorum_of_one
        try:
            yield
        finally:
            step.joint_committed = old

    def __getattr__(self, name):
        attr = getattr(self.eng, name)
        if not callable(attr):
            return attr

        def broken(*args, **kw):
            with self._broken():
                return attr(*args, **kw)
        return broken


@pytest.mark.parametrize("workload", ["r3-100k.closed", "r5-10k.open"])
def test_the_control_is_not_correct(workload):
    out = run_tiny(workload, make_engine=Control)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["ref_mismatches"]["value"] > 0
    assert out["checks"]["guarantee_breaks"]["value"] > 0


WORKLOADS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_at_the_cells_size(workload, cuda_device):
    """On the card, at the cell's own size and load, on three seeds:
    the control's readings of each number compared."""
    import time

    cell = spec.load_cell(workload)
    for seed in (2**31 + 7, 2**31 + 8, 2**31 + 9):
        out = bench.run_cell(cell, seed, 5.0, False, cuda_device,
                             time.perf_counter(), make_engine=Control)
        print(f"control {workload} seed={seed}: "
              + ", ".join(f"{k}={v['value']}"
                          for k, v in out["checks"].items()),
              file=sys.stderr)
        assert out["correct"] is False
