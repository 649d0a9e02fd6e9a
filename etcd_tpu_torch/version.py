"""Version info (ref: api/version/version.go).

Ports ``etcd_tpu/version.py``.
"""

# The etcd API surface this framework is capability-parity with.
MIN_CLUSTER_VERSION = "3.0.0"
CLUSTER_VERSION = "3.6.0"
SERVER_VERSION = "3.6.0-alpha.0+tpu"
API_VERSION = "3.6"
