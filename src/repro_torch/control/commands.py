"""Typed control-plane commands (the versioned mutation vocabulary), torch port.

Every way a running data plane can be mutated is one of these five
commands; anything else is a bug.  Commands are plain frozen dataclasses
so an epoch is a value: it can be logged, diffed and replayed.
``describe()`` renders the serialized delta that goes into the command log;
weight payloads are summarized by their byte count, never inlined.

Command semantics (applied by the runtime at a tick boundary):

* ``SwapSlot``      — replace one resident bank slot with delivered
  weights.  In-flight work keeps the bank version it was dispatched with.
* ``ProgramReta``   — install a full indirection table.
* ``FailQueues``    — mark queues dead and remap their RETA buckets onto
  survivors (round-robin, affinity-preserving for live flows).
* ``RestoreQueues`` — return queues to service; with no queues named,
  restore everything and reinstall the default round-robin RETA.
* ``SetPolicy``     — install (or clear) the closed-loop routing policy
  consulted at tick boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

#: Control-plane wire/API version, the reference's (v3: every epoch records
#: a ``commit_mode``).
API_VERSION = 3


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


@dataclasses.dataclass(frozen=True)
class SwapSlot:
    """Replace resident slot ``slot`` with already-delivered ``params``."""
    slot: int
    params: Any  # dict of tensors or numpy arrays shaped like one bank slot

    def describe(self) -> dict:
        nbytes = sum(_nbytes(leaf) for leaf in _leaves(self.params))
        return {"cmd": "swap_slot", "slot": int(self.slot),
                "delta_bytes": int(nbytes)}


@dataclasses.dataclass(frozen=True)
class ProgramReta:
    """Install a full indirection table (tuple so the command is a value)."""
    reta: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "reta",
                           tuple(int(q) for q in np.asarray(self.reta).ravel()))

    def describe(self) -> dict:
        return {"cmd": "program_reta", "size": len(self.reta),
                "queues": sorted(set(self.reta))}


@dataclasses.dataclass(frozen=True)
class FailQueues:
    """Take queues out of service; their buckets remap onto survivors."""
    queues: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "queues",
                           tuple(sorted(int(q) for q in self.queues)))

    def describe(self) -> dict:
        return {"cmd": "fail_queues", "queues": list(self.queues)}


@dataclasses.dataclass(frozen=True)
class RestoreQueues:
    """Return queues to service (all of them when ``queues`` is empty)."""
    queues: tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "queues",
                           tuple(sorted(int(q) for q in self.queues)))

    def describe(self) -> dict:
        return {"cmd": "restore_queues",
                "queues": list(self.queues) or "all"}


@dataclasses.dataclass(frozen=True)
class SetPolicy:
    """Install a closed-loop routing policy (None clears it)."""
    policy: Any  # RoutingPolicy | None

    def describe(self) -> dict:
        name = getattr(self.policy, "name", None)
        return {"cmd": "set_policy", "policy": name}


Command = SwapSlot | ProgramReta | FailQueues | RestoreQueues | SetPolicy
COMMAND_KINDS = (SwapSlot, ProgramReta, FailQueues, RestoreQueues, SetPolicy)
