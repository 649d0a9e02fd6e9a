"""A traffic mix, from its data: ``traffic/<mix>.json`` names its
generator (``generators/<generator>.py``, found by name) and holds the
parameters, with the cell's own from ``cells/<cell>.json`` over them.

Every mix has the loop's keys (LOOP_KEYS); every other key must be one
that its generator reads (the module's ``PARAMS``), so that a mix that
names a parameter no generator reads fails instead of running other
traffic. A generator's ``Generator`` offers each group's leader its
proposals before each round (``offer``), and says how its proposals
were submitted: on a schedule of due times (``due``, [G, K]) or by
``clients`` closed-loop clients a group.

The engine clamps each round's offer by P and by ring headroom; what it
accepted shows in the leader's ``last``, so the generators keep no
count of their own but the offered one.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
LOOP_KEYS = ("generator", "warm_rounds", "drain_s", "in_flight_rounds")


def generator(name: str):
    """The module generators/<name>.py."""
    path = HERE / "generators" / f"{name}.py"
    if not path.exists():
        raise ValueError(f"no traffic generator {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "portbench_generator_" + name.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(params: dict, groups: int, seconds: float, gen, device):
    """The generator that the mix `params` names, with its parameters."""
    mod = generator(params["generator"])
    unknown = sorted(set(params) - set(LOOP_KEYS) - set(mod.PARAMS))
    if unknown:
        raise ValueError(f"traffic generator {params['generator']!r} reads "
                         f"no {', '.join(unknown)}")
    return mod.Generator(params, groups, seconds, gen, device)
