"""Move round state and messages between numpy and torch.

The counterpart of checkpoint weights for this system: a BatchedState
(and an inbox/outbox of MsgSlots) is the whole of what one round hands
the next, and a PlaneState the whole of what one apply-plane dispatch
hands the next. A state saved by another implementation of the same round —
as numpy arrays, field by field — loads here and steps on, and a state
from here reads back the same way, so two implementations can start
from one state and be compared field by field.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .applyplane import PlaneState
from .state import BatchedState, resolve_device
from .step import MsgSlots


def _load(cls, fields: Dict[str, np.ndarray], device):
    dev = resolve_device(device)
    missing = set(cls._fields) - set(fields)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    # np.array copies: torch cannot wrap a read-only buffer.
    return cls(**{
        f: torch.as_tensor(np.array(fields[f]), device=dev)
        for f in cls._fields
    })


def _dump(x) -> Dict[str, np.ndarray]:
    return {f: getattr(x, f).cpu().numpy() for f in x._fields}


def state_from_numpy(fields: Dict[str, np.ndarray], device=None) -> BatchedState:
    """A BatchedState from one numpy array per field (dtypes kept)."""
    return _load(BatchedState, fields, device)


def msgs_from_numpy(fields: Dict[str, np.ndarray], device=None) -> MsgSlots:
    """MsgSlots from one numpy array per field (dtypes kept)."""
    return _load(MsgSlots, fields, device)


def state_to_numpy(st: BatchedState) -> Dict[str, np.ndarray]:
    return _dump(st)


def msgs_to_numpy(m: MsgSlots) -> Dict[str, np.ndarray]:
    return _dump(m)


def plane_from_numpy(fields: Dict[str, np.ndarray], device=None) -> PlaneState:
    """An apply-plane PlaneState from one numpy array per field."""
    return _load(PlaneState, fields, device)


def plane_to_numpy(plane: PlaneState) -> Dict[str, np.ndarray]:
    return _dump(plane)
