"""Transactional, epoch-stamped control plane for the data-plane runtime
(torch port).

* **Epochs are atomic.**  Commands submitted together apply together, in
  submission order, between two ticks; no packet ever observes half an
  epoch.
* **Application happens at tick boundaries only.**  ``submit`` never
  mutates the runtime; the runtime calls ``apply_pending`` when it is
  quiescent between ticks.  In-flight device work keeps the bank/RETA
  version it was dispatched with.
* **Everything is logged.**  Each epoch records its id, the tick it became
  effective, the serialized command deltas, its outcome (``commit_mode``)
  and two wall-clock latencies: submit-to-effective and the apply cost
  itself.  ``continuity_audit`` joins the log with the runtime's
  wrong-verdict counter so every epoch can prove it corrupted zero packets.

Failures that are expected chaos outcomes subclass
``NonFatalControlError``: their epoch rolls back and is logged, and
``apply_pending`` carries on with the next epoch.

The in-memory log is bounded: ``log_capacity`` evicts the oldest records
into a compressed spill (``SPILL_MAGIC``, then ``u32 length +
zlib(MessagePack)`` chunks, the reference's format, written by the port's
own codec `repro_torch.codec`), each stamped with its closed wrong-verdict
window first, so slot-thrash regimes (one epoch per tick) run in
O(capacity) memory while ``continuity_audit`` still proves every spilled
window was clean.

In the megastep's deferred mode each applied bank or RETA mutation is also
serialized as a ``DeviceDelta`` (``serialize_device_delta``) for the
window's bounded epoch queue.
"""

from __future__ import annotations

import dataclasses
import struct
import time
import zlib
from typing import Any

import numpy as np

from repro_torch import codec
from repro_torch.control.commands import (API_VERSION, COMMAND_KINDS, Command,
                                          FailQueues, ProgramReta,
                                          RestoreQueues, SwapSlot)

#: Spill-file framing: magic + u8 version, then length-prefixed chunks.
SPILL_MAGIC = b"BSWELOG1"

#: The only outcomes an epoch may end in.
COMMIT_MODES = ("atomic", "degraded", "rollback")


class NonFatalControlError(Exception):
    """An epoch failure that is an expected chaos outcome, not a bug: the
    epoch rolls back atomically and is logged with its error, but
    ``apply_pending`` continues with the next epoch instead of raising."""


@dataclasses.dataclass
class EpochRecord:
    """One applied (or pending) epoch in the command log."""
    epoch: int
    commands: tuple[Command, ...]
    summaries: tuple[dict, ...]        # describe() frozen at submit time
    submitted_s: float                 # perf_counter at submit
    applied_tick: int | None = None    # runtime tick the epoch preceded
    apply_latency_us: float | None = None  # submit -> effective
    apply_us: float | None = None          # apply duration alone
    wrong_verdict_at_apply: int | None = None
    error: str | None = None           # set when the epoch was rejected
    commit_mode: str | None = None     # one of COMMIT_MODES once decided
    host_ticks: tuple[int, ...] | None = None  # mesh runtimes only

    @property
    def applied(self) -> bool:
        return self.applied_tick is not None

    def as_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "api_version": API_VERSION,
            "commands": list(self.summaries),
            "applied_tick": self.applied_tick,
            "apply_latency_us": self.apply_latency_us,
            "apply_us": self.apply_us,
            "error": self.error,
            "commit_mode": self.commit_mode,
            "host_ticks": (list(self.host_ticks)
                           if self.host_ticks is not None else None),
        }


# -- device-delta serialization (the megastep's epoch queue) -----------------

#: DeviceDelta.kind codes.
DELTA_SWAP = 1
DELTA_RETA = 2


@dataclasses.dataclass(frozen=True)
class DeviceDelta:
    """One control command serialized for the megastep's epoch queue.

    An epoch that lands inside a staged window applies eagerly to the host
    mirrors and is also recorded here in a fixed form: ``step`` is the
    window step the delta precedes (it is in effect for every row popped
    at steps >= ``step``, the sequential tick-boundary semantics), and
    within one step later entries overwrite earlier ones (submission
    order).  Rolling back a failed epoch truncates the staged list back to
    its pre-epoch length, so the device never sees a rolled-back epoch.
    """
    step: int                    # window step the delta applies before
    kind: int                    # DELTA_SWAP | DELTA_RETA
    slot: int = -1               # bank slot (DELTA_SWAP)
    reta: Any = None             # (reta_size,) int32 (DELTA_RETA)
    params: Any = None           # one bank slot's params (DELTA_SWAP)


def serialize_device_delta(cmd, *, step: int, runtime,
                           reta_size: int) -> DeviceDelta | None:
    """Serialize one already applied command into its device delta.

    Called by the runtime's ``_apply_command`` in deferred (megastep) mode
    after the host mirror mutated: ``SwapSlot`` captures the new slot's
    params; every RETA-affecting command (``ProgramReta``, ``FailQueues``,
    ``RestoreQueues``) captures the resulting host table, padded with -1 or
    truncated to ``reta_size``.  Commands with no device-visible state
    (``SetPolicy``) return None.
    """
    if isinstance(cmd, SwapSlot):
        return DeviceDelta(step=step, kind=DELTA_SWAP, slot=int(cmd.slot),
                           params=cmd.params)
    if isinstance(cmd, (ProgramReta, FailQueues, RestoreQueues)):
        table = np.asarray(runtime.reta, np.int32)
        out = np.full(reta_size, -1, np.int32)
        n = min(reta_size, table.shape[0])
        out[:n] = table[:n]
        return DeviceDelta(step=step, kind=DELTA_RETA, reta=out)
    return None


class ControlPlane:
    """Epoch queue + command log in front of one ``DataplaneRuntime``."""

    API_VERSION = API_VERSION

    def __init__(self, runtime, *, log_capacity: int | None = None,
                 spill_path: str | None = None):
        if log_capacity is not None and log_capacity < 1:
            raise ValueError("log_capacity must be >= 1 (or None)")
        self._runtime = runtime
        self._next_epoch = 1
        self._pending: list[EpochRecord] = []
        self._log: list[EpochRecord] = []
        self._log_capacity = log_capacity
        self._spill_path = spill_path
        self._spill_chunks: list[bytes] = []   # when no spill_path is given
        self._spill_header_written = False
        self.spilled_epochs = 0
        self._spilled_wrong = 0
        self._mode_counts = {m: 0 for m in COMMIT_MODES}
        # observability tap: called with each EpochRecord as it lands in
        # the log (committed AND rolled-back epochs)
        self.on_record = None

    # -- submission ---------------------------------------------------------

    def submit(self, *commands: Command) -> int:
        """Queue one atomic epoch; returns its id.  Nothing is applied
        until the runtime reaches a tick boundary.

        Runtimes with a double-buffered bank expose ``_prestage_epoch``;
        it runs here, after the epoch is queued, so SwapSlot payloads
        start staging into the shadow bank while traffic still flows and
        the barrier commit is a pointer flip.  Prestaging is best-effort
        and mutates no runtime-visible state."""
        if not commands:
            raise ValueError("an epoch needs at least one command")
        for c in commands:
            if not isinstance(c, COMMAND_KINDS):
                raise TypeError(f"not a control command: {c!r}")
        rec = EpochRecord(
            epoch=self._next_epoch,
            commands=tuple(commands),
            summaries=tuple(c.describe() for c in commands),
            submitted_s=time.perf_counter(),
        )
        self._next_epoch += 1
        self._pending.append(rec)
        prestage = getattr(self._runtime, "_prestage_epoch", None)
        if prestage is not None:
            prestage(rec)
        return rec.epoch

    @property
    def pending(self) -> list[EpochRecord]:
        """Epochs queued but not yet applied (a defensive copy)."""
        return list(self._pending)

    @property
    def has_pending(self) -> bool:
        return bool(self._pending)

    # -- application (runtime-side, tick boundary only) ---------------------

    def apply_pending(self, tick: int) -> list[EpochRecord]:
        """Apply every queued epoch atomically, in submission order.

        Called by the runtime when it is quiescent between ticks; user
        code submits and lets the next tick boundary (or
        ``runtime.flush_control()``) pick it up."""
        applied = []
        finish = getattr(self._runtime, "_finish_epoch", None)
        while self._pending:
            rec = self._pending.pop(0)
            t0 = time.perf_counter()
            state = self._runtime._control_state()
            try:
                # validate the WHOLE epoch up front; the state snapshot
                # backstops apply-time failures validation cannot see
                # (commands that only conflict with each other)
                for cmd in rec.commands:
                    self._runtime._validate_command(cmd)
                for cmd in rec.commands:
                    self._runtime._apply_command(cmd)
                if finish is not None:
                    finish(rec)
            except Exception as e:
                self._runtime._rollback_control_state(state)
                rec.error = f"{type(e).__name__}: {e}"
                rec.commit_mode = "rollback"
                rec.host_ticks = None
                rec.wrong_verdict_at_apply = \
                    self._runtime.telemetry.wrong_verdict
                self._append_log(rec)
                if isinstance(e, NonFatalControlError):
                    continue
                raise
            t1 = time.perf_counter()
            rec.applied_tick = tick
            rec.apply_us = (t1 - t0) * 1e6
            rec.apply_latency_us = (t1 - rec.submitted_s) * 1e6
            rec.wrong_verdict_at_apply = \
                self._runtime.telemetry.wrong_verdict
            if rec.commit_mode is None:
                rec.commit_mode = "atomic"
            self._append_log(rec)
            applied.append(rec)
        return applied

    def _append_log(self, rec: EpochRecord) -> None:
        # the log keeps the summary (``delta_bytes``), never the payload, so
        # a long-lived runtime does not pin every model it has swapped in
        if any(isinstance(c, SwapSlot) and c.params is not None
               for c in rec.commands):
            rec.commands = tuple(
                dataclasses.replace(c, params=None) if isinstance(c, SwapSlot)
                else c for c in rec.commands)
        self._mode_counts[rec.commit_mode] += 1
        if self.on_record is not None:
            self.on_record(rec)
        self._log.append(rec)
        cap = self._log_capacity
        if cap is not None and len(self._log) > cap:
            evicted, self._log = self._log[:-cap], self._log[-cap:]
            self._spill(evicted)

    def _spill(self, evicted: list[EpochRecord]) -> None:
        """Close each evicted record's wrong-verdict window (its successor
        is still known here) and push the batch out as one compressed
        chunk."""
        succ = self._log[0] if self._log else None
        docs = []
        for i, rec in enumerate(evicted):
            nxt = evicted[i + 1] if i + 1 < len(evicted) else succ
            doc = rec.as_dict()
            window = None
            if (nxt is not None and rec.wrong_verdict_at_apply is not None
                    and nxt.wrong_verdict_at_apply is not None):
                window = nxt.wrong_verdict_at_apply - rec.wrong_verdict_at_apply
                self._spilled_wrong += window
            doc["wrong_verdict_in_window"] = window
            docs.append(doc)
        self.spilled_epochs += len(docs)
        blob = zlib.compress(codec.packb(docs), 6)
        if self._spill_path is None:
            self._spill_chunks.append(blob)
            return
        with open(self._spill_path, "ab" if self._spill_header_written else "wb") as f:
            if not self._spill_header_written:
                f.write(SPILL_MAGIC)
            f.write(struct.pack("<I", len(blob)))
            f.write(blob)
        self._spill_header_written = True

    def spilled_records(self) -> list[dict]:
        """Decode the in-memory spill chunks (oldest first)."""
        out: list[dict] = []
        for blob in self._spill_chunks:
            out.extend(codec.unpackb(zlib.decompress(blob)))
        return out

    # -- observability ------------------------------------------------------

    @property
    def log(self) -> list[EpochRecord]:
        """The epoch log, oldest first (a defensive copy)."""
        return list(self._log)

    def command_log(self) -> list[dict]:
        """The auditable, serializable command log."""
        return [rec.as_dict() for rec in self._log]

    def continuity_audit(self) -> dict:
        """Per-epoch continuity: wrong-verdict packets attributed to the
        window each epoch opened (its apply to the next epoch's apply, or
        to now for the last one).  With the runtime in audit mode, an
        all-zero column proves no command kind ever corrupted a verdict."""
        wrong_now = self._runtime.telemetry.wrong_verdict
        epochs = []
        for i, rec in enumerate(self._log):
            nxt = (self._log[i + 1].wrong_verdict_at_apply
                   if i + 1 < len(self._log) else wrong_now)
            epochs.append({
                "epoch": rec.epoch,
                "applied_tick": rec.applied_tick,
                "commands": [s["cmd"] for s in rec.summaries],
                "commit_mode": rec.commit_mode,
                "wrong_verdict_in_window": nxt - rec.wrong_verdict_at_apply,
            })
        ok = (wrong_now == 0
              and all(e["wrong_verdict_in_window"] == 0 for e in epochs)
              and self._spilled_wrong == 0)
        out = {
            "api_version": API_VERSION,
            "epochs": epochs,
            "commit_modes": dict(self._mode_counts),
            "spilled_epochs": self.spilled_epochs,
            "spilled_wrong_verdict": self._spilled_wrong,
            "wrong_verdict_total": wrong_now,
            "ok": ok,
        }
        cons_fn = getattr(self._runtime, "audit_conservation", None)
        if cons_fn is not None:
            cons = cons_fn()
            out["conservation_ok"] = bool(cons["ok"])
            out["ok"] = ok and bool(cons["ok"])
        return out

    def stats(self) -> dict:
        """Aggregate epoch latencies for telemetry snapshots."""
        applied = [r for r in self._log if r.applied]
        lat = [r.apply_latency_us for r in applied]
        return {
            "api_version": API_VERSION,
            "epochs_applied": len(applied),
            "epochs_pending": len(self._pending),
            "epochs_spilled": self.spilled_epochs,
            "commit_modes": dict(self._mode_counts),
            "apply_latency_us_max": max(lat) if lat else None,
        }


def load_epoch_spill(path: str) -> list[dict]:
    """Read a spill file written by a capacity-bounded ``ControlPlane`` (the
    port's or the reference's) back into epoch dicts (oldest first)."""
    with open(path, "rb") as f:
        if f.read(len(SPILL_MAGIC)) != SPILL_MAGIC:
            raise ValueError(f"not an epoch spill file: {path}")
        out: list[dict] = []
        while head := f.read(4):
            if len(head) != 4:
                raise ValueError(f"{path}: truncated chunk header")
            (n,) = struct.unpack("<I", head)
            blob = f.read(n)
            if len(blob) != n:
                raise ValueError(f"{path}: truncated chunk body")
            out.extend(codec.unpackb(zlib.decompress(blob)))
        return out
