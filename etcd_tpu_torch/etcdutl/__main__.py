"""Ports ``etcd_tpu/etcdutl/__main__.py``."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
