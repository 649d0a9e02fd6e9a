"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX
package's)."""

import json
import subprocess
import sys

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "etcd_tpu"}

PROGRAM = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.tests.tiny import run_tiny
out = run_tiny("r3-100k.open", seconds=0.4)
from portbench.run import forbidden_modules
print(json.dumps({{"correct": out["correct"], "forbidden": forbidden_modules(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_run_loads_no_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", PROGRAM.format(root=str(spec.ROOT))],
        capture_output=True, text=True, timeout=300, check=True)
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert got["forbidden"] == []
    assert not FORBIDDEN & set(got["top"])
    assert "etcd_tpu_torch" in got["top"]


def test_the_harness_sources_name_no_jax():
    for path in spec.HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for bad in ("import jax", "from jax", "import etcd_tpu\n",
                    "from etcd_tpu import", "from etcd_tpu.", "import flax"):
            assert bad not in text, (path, bad)
