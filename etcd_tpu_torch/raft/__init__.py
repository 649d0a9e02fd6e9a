"""The consensus core's wire types, as far as the batched port uses
them (ports the part of ``etcd_tpu/raft`` that the rawnode and the
message codec need)."""
