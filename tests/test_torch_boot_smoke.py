"""chip_smoke's boot phase, rehearsed on the CPU.

``run_boot`` with the members on ``--device cpu`` (three
``python -m etcd_tpu_torch`` processes, the port's benchmark tool in its
own processes, at 100 puts and 100 ranges a consistency a member, one a
connection): every
acked put read back on every member, hash_kv, kill -9 of the leader and
its restart, a snapshot restored by the port's etcdutl into a solo
member, the ``ctl`` stage (the port's etcdctl, grpc-proxy and gateway
processes, make-mirror of 20 keys into the solo member), linearizable
reads with a member slowed (1 s a run), and each member's launch line
from its orderly stop (node rounds; no launch on the CPU, where the plain
forms run). ``nvidia-smi`` is stubbed.
"""

import torch

import chip_smoke


def test_boot_phase_on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "smi", lambda _q: "cpu")
    out = chip_smoke.run_boot(torch.device("cpu"), puts=100, ranges=100,
                              checked=30, mirror_keys=20, c17_seconds=1.0)
    assert out["rounds"] > 0
    assert out["launches"] == {"quorum_commit_vote": 0, "term_at_batch": 0}
