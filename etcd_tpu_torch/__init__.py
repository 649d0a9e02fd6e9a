"""etcd_tpu_torch: the batched multi-Raft engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of ``etcd_tpu.batched`` (JAX on a TPU), which stays in the
repository as the reference. The port is self-contained: it imports
``torch`` and never ``jax`` or any module of ``etcd_tpu``.

  - ``etcd_tpu_torch.batched`` — SoA state, the vectorized round with
    its telemetry and fleet planes, the closed-loop engine (a CUDA
    graph of one round on the GPU), the hosted BatchedRawNode and its
    message codec, the device apply plane, the telemetry hub, the
    membership store, and the quorum/ring-term Hopper kernels.
  - ``etcd_tpu_torch.raft``    — the scalar raft core and its wire types.
  - ``etcd_tpu_torch.server``  — the etcd v3 server (``EtcdServer``) over
    ``storage.mvcc``, ``storage.backend``, ``lease``, ``auth`` and
    ``v2store``, with consensus on the batched node (the GPU by default)
    or the scalar core; ``v3rpc`` serves it over framed TCP, ``client``
    speaks to it, ``functional`` runs clusters of it in process.
  - ``etcd_tpu_torch.obs``     — the fleet hub and its frame layout, the
    proposal tracer, its chrome-trace export and cross-member merge.
  - ``etcd_tpu_torch.pkg``, ``storage``, ``native``, ``transport`` — the
    metrics registry, failpoints, shared errors, the WAL and its native
    record log, snapshots, and the wire codec.
  - ``etcd_tpu_torch.tools``   — the bench setup, the bench twin and the
    kernel timers.
"""
