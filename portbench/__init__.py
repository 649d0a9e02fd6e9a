"""The benchmark of etcd_tpu_torch: see BENCHMARK.json and run.py."""
