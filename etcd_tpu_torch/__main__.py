"""`python -m etcd_tpu_torch` → etcdmain (ref: server/main.go).

Ports ``etcd_tpu/__main__.py``.
"""

import sys

from .etcdmain import main

if __name__ == "__main__":
    sys.exit(main())
