"""Deterministic fault injection for the data plane (torch port).

Emergency networks are exactly where hosts stall, crash, and rejoin
mid-operation — the Emergency-HRL line treats node failure as the normal
case and the INSIGHT survey names fault tolerance as the open gap for
in-network AI.  This module makes those failures *first-class inputs*:
a ``FaultPlan`` is a typed, serializable schedule of faults, and a
``FaultInjector`` fires them at **named injection points** inside
`repro_torch.dataplane.runtime.DataplaneRuntime` and
`repro_torch.dataplane.mesh.MeshDataplane` — deterministically, so a
faulted run records and replays bit-exactly (the plan rides along in trace
metadata).  The single-host runtime is host 0 and consults the ``tick``,
``stage`` and ``apply`` points; the mesh consults every point for every
host, and only there do crashes, lost acks and delayed retires act.  Plans
and their JSON form are shared with the reference.

Fault vocabulary (one frozen dataclass per class):

* ``StallHost(host, at_tick, ticks)``   — the host neither ticks nor
  heartbeats for ``ticks`` mesh ticks (a GC pause, a wedged NIC queue);
* ``CrashHost(host, at_tick)``          — the host goes permanently
  unresponsive; packets already in its rings are *stranded* (counted by
  the mesh conservation audit) until a rejoin drains them;
* ``ShardError(host, at_tick, point)``  — the host raises
  ``InjectedFault`` the next time it stages (``point="stage"``) or
  applies (``point="apply"``) a control epoch — the deterministic form
  of a shard exception mid-transaction;
* ``DropAck(host, at_tick, count)``     — the host applies an epoch but
  its commit acknowledgement is lost ``count`` times;
* ``DelayRetire(host, at_tick, ticks)`` — the host keeps ticking but
  cannot quiesce at an epoch barrier for ``ticks`` ticks (the barrier
  straggler).

Injection points (``POINTS``): ``tick`` (host liveness each mesh tick),
``stage``/``apply`` (the two phases of the epoch broadcast),
``commit-ack`` (quorum collection), ``retire`` (barrier readiness).

``InjectedFault`` subclasses `repro_torch.control.NonFatalControlError`: an
epoch it rejects rolls back atomically and is *logged*, but the run
continues — chaos is an input, not a crash of the harness itself.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.control.plane import NonFatalControlError

#: Named injection points the runtimes consult.
POINTS = ("tick", "stage", "apply", "commit-ack", "retire")

PLAN_VERSION = 1

#: Fault-class names (CI fault matrix and ``demo_plan`` vocabulary).
FAULT_CLASSES = ("stall", "crash", "stage-error", "apply-error",
                 "drop-ack", "delay-retire")


class InjectedFault(NonFatalControlError):
    """A deterministic injected shard failure (stage/apply points)."""


@dataclasses.dataclass(frozen=True)
class StallHost:
    """Host is unresponsive for ``ticks`` ticks starting at ``at_tick``."""
    host: int
    at_tick: int
    ticks: int

    def window(self) -> tuple[int, float]:
        return (self.at_tick, self.at_tick + self.ticks)


@dataclasses.dataclass(frozen=True)
class CrashHost:
    """Host is permanently unresponsive from ``at_tick`` on."""
    host: int
    at_tick: int

    def window(self) -> tuple[int, float]:
        return (self.at_tick, float("inf"))


@dataclasses.dataclass(frozen=True)
class ShardError:
    """Raise ``InjectedFault`` on the host's next ``point`` at >= at_tick."""
    host: int
    at_tick: int
    point: str = "apply"            # "stage" | "apply"

    def __post_init__(self):
        if self.point not in ("stage", "apply"):
            raise ValueError(f"ShardError point must be stage|apply, "
                             f"got {self.point!r}")


@dataclasses.dataclass(frozen=True)
class DropAck:
    """Drop the host's next ``count`` commit acks at >= at_tick."""
    host: int
    at_tick: int
    count: int = 1


@dataclasses.dataclass(frozen=True)
class DelayRetire:
    """Host ticks but cannot quiesce at a barrier for ``ticks`` ticks."""
    host: int
    at_tick: int
    ticks: int

    def window(self) -> tuple[int, float]:
        return (self.at_tick, self.at_tick + self.ticks)


Fault = StallHost | CrashHost | ShardError | DropAck | DelayRetire
FAULT_KINDS = {
    "stall": StallHost,
    "crash": CrashHost,
    "shard-error": ShardError,
    "drop-ack": DropAck,
    "delay-retire": DelayRetire,
}
_KIND_OF = {v: k for k, v in FAULT_KINDS.items()}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A serializable schedule of faults (the injector's only input)."""
    faults: tuple = ()
    name: str = ""
    seed: int | None = None         # provenance of generated plans

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))
        for f in self.faults:
            if type(f) not in _KIND_OF:
                raise TypeError(f"not a fault: {f!r}")

    def to_dict(self) -> dict:
        return {
            "version": PLAN_VERSION,
            "name": self.name,
            "seed": self.seed,
            "faults": [dict(kind=_KIND_OF[type(f)],
                            **dataclasses.asdict(f))
                       for f in self.faults],
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "FaultPlan":
        version = int(doc.get("version", PLAN_VERSION))
        if version != PLAN_VERSION:
            raise ValueError(f"fault plan version {version} unsupported "
                             f"(this build reads v{PLAN_VERSION})")
        faults = []
        for d in doc.get("faults", ()):
            d = dict(d)
            kind = d.pop("kind")
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r} "
                                 f"(known: {sorted(FAULT_KINDS)})")
            faults.append(FAULT_KINDS[kind](**d))
        return cls(faults=tuple(faults), name=doc.get("name", ""),
                   seed=doc.get("seed"))


def save_plan(plan: FaultPlan, path: str) -> None:
    with open(path, "w") as f:
        json.dump(plan.to_dict(), f, indent=2)
        f.write("\n")


def load_plan(path: str) -> FaultPlan:
    with open(path) as f:
        return FaultPlan.from_dict(json.load(f))


class FaultInjector:
    """Deterministic fault firing against a ``FaultPlan``.

    Stateless for window faults (stall / crash / delay-retire: pure
    functions of the tick) and consume-once for point faults
    (shard errors, dropped acks), so the same plan over the same step
    stream always produces the same failure history — ``events`` is that
    history, for reports and tests.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._stalls = [f for f in plan.faults
                        if isinstance(f, (StallHost, CrashHost))]
        self._delays = [f for f in plan.faults
                        if isinstance(f, DelayRetire)]
        self._errors = [f for f in plan.faults if isinstance(f, ShardError)]
        self._acks = {id(f): f.count for f in plan.faults
                      if isinstance(f, DropAck)}
        self._ack_faults = [f for f in plan.faults if isinstance(f, DropAck)]
        self.events: list[dict] = []
        self._seen: set[tuple] = set()

    def _event(self, tick: int, point: str, host: int, detail: str,
               *, once_key: tuple | None = None) -> None:
        if once_key is not None:
            if once_key in self._seen:
                return
            self._seen.add(once_key)
        self.events.append({"tick": int(tick), "point": point,
                            "host": int(host), "detail": detail})

    # -- window faults -------------------------------------------------------

    def responsive(self, host: int, tick: int) -> bool:
        """``tick`` point: False while the host is stalled or crashed."""
        for f in self._stalls:
            lo, hi = f.window()
            if f.host == host and lo <= tick < hi:
                self._event(tick, "tick", host,
                            f"{_KIND_OF[type(f)]} (from tick {lo})",
                            once_key=("win", id(f)))
                return False
        return True

    def crashed(self, host: int, tick: int) -> bool:
        return any(isinstance(f, CrashHost) and f.host == host
                   and tick >= f.at_tick for f in self._stalls)

    def retire_blocked(self, host: int, tick: int) -> bool:
        """``retire`` point: host cannot quiesce at a barrier right now."""
        for f in self._delays:
            lo, hi = f.window()
            if f.host == host and lo <= tick < hi:
                self._event(tick, "retire", host,
                            f"delay-retire (from tick {lo})",
                            once_key=("ret", id(f)))
                return True
        return False

    # -- consume-once faults -------------------------------------------------

    def check(self, point: str, host: int, tick: int) -> None:
        """``stage``/``apply`` points: raise ``InjectedFault`` once per
        armed ``ShardError`` whose window has opened."""
        for f in list(self._errors):
            if f.point == point and f.host == host and tick >= f.at_tick:
                self._errors.remove(f)
                self._event(tick, point, host, "shard error raised")
                raise InjectedFault(
                    f"injected shard error on host {host} at {point} "
                    f"(tick {tick})")

    def drop_ack(self, host: int, tick: int) -> bool:
        """``commit-ack`` point: True when this host's ack is dropped."""
        for f in self._ack_faults:
            if f.host == host and tick >= f.at_tick and self._acks[id(f)] > 0:
                self._acks[id(f)] -= 1
                self._event(tick, "commit-ack", host, "commit ack dropped")
                return True
        return False

    @property
    def armed(self) -> bool:
        return bool(self.plan.faults)


# ---------------------------------------------------------------------------
# plan generators
# ---------------------------------------------------------------------------

def demo_plan(kind: str, *, hosts: int, lease_ticks: int = 8,
              at_tick: int = 6) -> FaultPlan:
    """The canonical one-fault plan per fault class.

    Always targets the last host so host 0 survives.  On a single host
    the host-loss classes degenerate to a short stall (killing the only
    host would strand the whole data plane — there is nothing to fail
    over *to*), which still exercises lease accounting.
    """
    victim = hosts - 1
    if hosts == 1 and kind in ("crash", "delay-retire", "drop-ack"):
        kind = "stall"
    if kind == "stall":
        # long enough to expire the lease, short enough to rejoin
        f: Fault = StallHost(victim, at_tick, lease_ticks + 4)
    elif kind == "crash":
        f = CrashHost(victim, at_tick)
    elif kind == "stage-error":
        f = ShardError(victim, at_tick, "stage")
    elif kind == "apply-error":
        f = ShardError(victim, at_tick, "apply")
    elif kind == "drop-ack":
        f = DropAck(victim, max(at_tick - 4, 0), count=1)
    elif kind == "delay-retire":
        f = DelayRetire(victim, at_tick, lease_ticks + 4)
    else:
        raise ValueError(f"unknown fault class {kind!r} "
                         f"(known: {list(FAULT_CLASSES)})")
    return FaultPlan(faults=(f,), name=f"demo-{kind}")


def random_plan(seed: int, *, hosts: int, horizon: int = 24,
                max_faults: int = 3, allow_crash: bool = True) -> FaultPlan:
    """A seeded random plan over the recoverable fault classes.

    Deterministic in ``seed``.  Host 0 is never stalled or crashed (a
    survivor always exists to absorb failover), and shard errors are
    excluded (they reject epochs by design).
    """
    rng = np.random.default_rng(seed)
    kinds = ["stall", "delay-retire", "drop-ack"]
    if allow_crash and hosts > 1:
        kinds.append("crash")
    faults: list[Fault] = []
    crashed_hosts: set[int] = set()
    for _ in range(int(rng.integers(0, max_faults + 1))):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        host = int(rng.integers(1, hosts)) if hosts > 1 else 0
        at = int(rng.integers(0, horizon))
        ticks = int(rng.integers(1, 12))
        if kind == "stall":
            faults.append(StallHost(host, at, ticks))
        elif kind == "delay-retire":
            faults.append(DelayRetire(host, at, ticks))
        elif kind == "drop-ack":
            faults.append(DropAck(host, at, count=int(rng.integers(1, 3))))
        elif kind == "crash" and host not in crashed_hosts \
                and len(crashed_hosts) + 1 < hosts:
            faults.append(CrashHost(host, at))
            crashed_hosts.add(host)
    return FaultPlan(faults=tuple(faults), name=f"random-{seed}", seed=seed)
