"""Multi-queue data-plane runtime: RSS dispatch -> rings -> fused workers
(torch port).

The NIC hashes each flow to one of N queues (``rss``), every queue buffers
into a bounded host ring (``ring``), and the queues drain through the same
resident-bank forwarding program (`repro_torch.core.pipeline.packet_step`):
one fused launch per queue-block, per-queue FIFO order, and online slot
swaps that never produce a wrong verdict.

Every mutation (slot swap, RETA rewrite, queue fail/restore, policy change)
flows through ``self.control`` (`repro_torch.control.ControlPlane`) as an
epoch-stamped command batch, applied only at tick boundaries, so in-flight
device work keeps the bank/RETA version it was dispatched with.

Fan-out modes (``fanout=``):

* ``loop`` — one ``packet_step`` per non-empty queue per tick (one fused
  launch per queue-block);
* ``vmap`` — the queue batches stacked to (Q, B, 272) and served by ONE
  call over all of them: ``packet_forward_fused``'s queue-major path for
  the fused strategy, ``packet_step`` on the flattened batch otherwise;
* ``auto`` — ``loop`` for the fused/grouped strategies, ``vmap`` else.

Each tick sends its rows to the device once, records a CUDA event after
its work, and is retired by waiting on that event; results come back in
one device-to-host copy per queue.  The tick loop keeps a bounded window
of ``pipeline_depth`` in-flight ticks; any depth gives identical verdicts
because every tick captures the bank/RETA version current at its
dispatch.  ``audit=True`` re-scores every tick through the exact ``take``
path against that captured bank and counts mismatches.

A ``fault_injector`` (`repro_torch.dataplane.faults`) is consulted as host
0: an injected stall spends the tick and serves nothing (pending epochs stay
queued, rings keep their backlog), and an injected shard error raises
``InjectedFault`` at the epoch's stage or apply, which rolls the epoch back
and is logged.  ``log_capacity``/``log_spill`` bound the control plane's
in-memory epoch log.

``megastep_ticks > 1`` turns on deferred mode (`repro_torch.dataplane.
megastep`): ``dispatch``/``tick`` stage their work and run the host ring
simulation, and each window of N ticks is served on the device by one
fused launch, drained once.  It needs the fused strategy, the ``cuda`` or
``ref`` backend and no fault injector; every other configuration keeps the
sequential loop, with the same verdicts and telemetry totals.

Host taps (they must treat their arguments as read-only and stay cheap):
``on_retire(queue, rows, slots, verdicts, actions, tick)`` for every
retired queue batch, ``on_drop(queue, rows)`` for dispatch-edge tail drops.

Not ported yet, and refused with ``NotImplementedError``: the
``shard_map`` fan-out (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import collections
import time
import warnings

import numpy as np
import torch

from repro_torch.control import (ControlPlane, FailQueues, ProgramReta,
                                 RestoreQueues, SetPolicy, SwapSlot)
from repro_torch.control import policy as policy_mod
from repro_torch.core import bank as bank_lib, packet as pkt, pipeline
from repro_torch.dataplane import rss
from repro_torch.dataplane.megastep import MegastepEngine
from repro_torch.dataplane.ring import PacketRing
from repro_torch.dataplane.telemetry import Telemetry
from repro_torch.dataplane.workloads.phases import SEQ_WORD
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_LOOP_STRATEGIES = ("fused", "grouped", "grouped_staged")

_DEPRECATION = ("%s() is a deprecation shim: submit a %s command through "
                "runtime.control.submit(...) instead")


def apply_routing_command(rt, cmd) -> bool:
    """Apply the service-state commands: ``FailQueues`` (union +
    affinity-preserving failover), ``RestoreQueues`` (default table minus
    still-failed), ``SetPolicy``.  Returns False for any other command so
    callers keep their own dispatch."""
    if isinstance(cmd, FailQueues):
        failed = rt.failed_queues | set(cmd.queues)
        # compute-then-commit: an unservable failover (zero live queues)
        # raises here without mutating any runtime state
        table = rss.failover_table(rt.reta, tuple(sorted(failed)),
                                   num_queues=rt.num_queues)
        rt.failed_queues = failed
        rt._install_reta(table)
    elif isinstance(cmd, RestoreQueues):
        rt.failed_queues -= set(cmd.queues or range(rt.num_queues))
        rt._install_reta(rss.restore_table(
            rt.num_queues, len(rt.reta), rt.failed_queues))
    elif isinstance(cmd, SetPolicy):
        rt.policy = cmd.policy
    else:
        return False
    return True


def consult_policy(rt) -> None:
    """Tick-boundary policy consultation: freeze a view of the runtime's
    queue pressure and submit any proposal as an ordinary ``ProgramReta``
    epoch (effective at the *next* boundary)."""
    if rt.policy is None:
        return
    view = policy_mod.PolicyView(
        tick=rt._tick_count,
        num_queues=rt.num_queues,
        reta=rt.reta.copy(),
        queue_depth=np.array([len(r) for r in rt.rings], np.int64),
        queue_dropped=np.array(
            [r.counters.dropped for r in rt.rings], np.int64),
        bucket_load=rt.bucket_load.copy(),
        failed_queues=frozenset(rt.failed_queues),
    )
    proposal = rt.policy.propose(view)
    if proposal is not None and not np.array_equal(proposal, rt.reta):
        rt.control.submit(ProgramReta(tuple(proposal)))


def drain_rings(rt, max_ticks: int = 100_000) -> int:
    """Tick until every ring is empty, then flush the pipeline."""
    done = 0
    for _ in range(max_ticks):
        n = rt.tick()
        done += n
        if n == 0 and not any(len(r) for r in rt.rings):
            rt.retire_all()
            return done
    raise RuntimeError("drain did not converge")


class _InFlight:
    """One dispatched-but-unretired tick (the device stage of the pipeline)."""

    __slots__ = ("tick", "popped", "counts", "x", "results", "bank", "done",
                 "t0")

    def __init__(self, tick, popped, counts, x, results, bank, done, t0):
        self.tick = tick
        self.popped = popped      # [(rows, ts)] per queue
        self.counts = counts      # rows popped per queue
        self.x = x                # {queue: (batch, 272) device rows}
        self.results = results    # {queue: (3, batch) int32 slot/verdict/action}
        self.bank = bank          # bank version captured at dispatch
        self.done = done          # CUDA event after the tick's work (or None)
        self.t0 = t0


class DataplaneRuntime:
    """Single-host multi-queue data-plane runtime.

    Public surface: ``dispatch`` (arrival edge), ``tick`` (pipeline step),
    ``retire_all``/``drain`` (flush), ``control`` (the epoch-stamped
    mutation funnel), ``flush_control``, ``adopt_bank``,
    ``audit_conservation`` and ``snapshot``.  ``device=None`` means CUDA;
    the bank must already sit on that device (``ValueError`` otherwise:
    the runtime never moves it).

    With ``double_buffer=True`` (default) the bank is held in a
    `repro_torch.core.bank.DoubleBufferedBank`: SwapSlot params stage into
    the shadow copy at submit time while traffic flows, and the epoch
    commit is an O(1) reference flip instead of a bank re-stage.
    """

    def __init__(
        self,
        bank,
        *,
        num_queues: int,
        strategy: str = "fused",
        fanout: str = "auto",
        batch: int = 128,
        block_b: int = 32,
        ring_capacity: int = 2048,
        backend: str = "auto",
        rss_key: bytes = rss.DEFAULT_KEY,
        audit: bool = False,
        record: bool = False,
        pipeline_depth: int = 1,
        megastep_ticks: int = 1,
        policy=None,
        fault_injector=None,
        log_capacity: int | None = None,
        log_spill: str | None = None,
        double_buffer: bool = True,
        device=None,
    ):
        if fanout == "shard_map":
            raise NotImplementedError(
                "fanout='shard_map' is not ported yet: ROADMAP.md Queue 1 "
                "item 9 (mesh)")
        if megastep_ticks < 1:
            raise ValueError("megastep_ticks must be >= 1")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if any(leaf.device != dev for leaf in bank.values()):
            raise ValueError(f"the bank must be on the runtime's device {dev}")
        self.device = dev
        self.bank = bank
        self.num_queues = int(num_queues)
        self.num_slots = bank_lib.bank_size(bank)
        # Double-buffered bank: the runtime owns two private device
        # copies; ``self.bank`` aliases the active one.  The caller's
        # ``bank`` is never written.
        self._bankbuf = None
        self._epoch_nonce: object = None
        if double_buffer:
            self._bankbuf = bank_lib.DoubleBufferedBank(bank)
            self.bank = self._bankbuf.active
        self.strategy = strategy
        self.batch = int(batch)
        self.block_b = min(int(block_b), self.batch)
        self.backend = backend
        self.rss_key = rss_key
        self.audit = audit
        self.reta = rss.indirection_table(self.num_queues)
        self.rings = [PacketRing(ring_capacity) for _ in range(self.num_queues)]
        self.telemetry = Telemetry(self.num_queues, self.num_slots)
        self._record = record
        self.completed_seq = [[] for _ in range(self.num_queues)]
        self.completed_verdicts = [[] for _ in range(self.num_queues)]
        self.completed_slots = [[] for _ in range(self.num_queues)]
        self.dropped_seq: list[int] = []
        # host taps:
        #   on_retire(queue, rows, slots, verdicts, actions, tick)
        #   on_drop(queue, rows)   (dispatch-edge tail drops)
        self.on_retire = None
        self.on_drop = None
        self._t_start: float | None = None
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self.pipeline_depth = int(pipeline_depth)
        self._inflight: collections.deque[_InFlight] = collections.deque()
        self._last_retire_s: float | None = None
        self._tick_count = 0
        self._faults = fault_injector
        self.control = ControlPlane(self, log_capacity=log_capacity,
                                    spill_path=log_spill)
        self.policy = policy          # initial config, not a mutation
        self.failed_queues: set[int] = set()
        self.bucket_load = np.zeros(len(self.reta), np.int64)
        if fanout == "auto":
            fanout = "loop" if strategy in _LOOP_STRATEGIES else "vmap"
        if fanout not in ("loop", "vmap"):
            raise ValueError(f"unknown fanout {fanout!r}")
        self.fanout = fanout
        self.megastep_ticks = int(megastep_ticks)
        # Deferred (megastep) mode: a window of N ticks runs on the device
        # in one fused launch at flush.  Fault injection needs per-tick host
        # control, and the window replicates the fused strategy on the
        # kernel or its plain version; every other configuration keeps the
        # sequential loop.
        self._mega = None
        if (self.megastep_ticks > 1 and fault_injector is None
                and strategy == "fused"
                and ops.resolve(backend, self.bank["b1"]) in ("cuda", "ref")):
            self._mega = MegastepEngine(self)

    # -- workers --------------------------------------------------------------

    def _step_kwargs(self) -> dict:
        return dict(num_slots=self.num_slots, strategy=self.strategy,
                    backend=self.backend, block_b=self.block_b)

    def _stacked_step(self, bank, x3: torch.Tensor) -> pipeline.PacketResult:
        """All queues in one call: ``x3`` is (Q, B, 272); results are over
        the flattened (Q * B) batch, queue q at rows q*B .. (q+1)*B."""
        flat = x3.reshape(-1, x3.shape[-1])
        if (self.strategy != "fused"
                or ops.resolve(self.backend, flat) != "cuda"):
            return pipeline.packet_step(bank, flat, **self._step_kwargs())
        slots = pkt.slot_of(flat, self.num_slots)
        g = bank_lib.group_by_slot_padded(slots, self.num_slots, self.block_b)
        scores_pad, actions_pad = ops.packet_forward_fused(
            bank, x3, g.block_slots, g.row_ids, meta_words=pkt.META_WORDS,
            block_b=self.block_b, backend=self.backend)
        rows = g.result_rows.to(torch.int64)
        scores = scores_pad[rows, 0]
        return pipeline.PacketResult(slots, scores, scores > 0.0,
                                     actions_pad[rows])

    @staticmethod
    def _packed(res: pipeline.PacketResult) -> torch.Tensor:
        """slots / verdicts / actions as one (3, n) int32 tensor, so a
        queue's results come back in one device-to-host copy."""
        return torch.stack([res.slots.to(torch.int32),
                            res.verdicts.to(torch.int32),
                            res.actions.to(torch.int32)])

    # -- control plane: command application (ControlPlane-only entry) -------

    def _validate_command(self, cmd) -> None:
        """Raise without mutating when ``cmd`` cannot apply to the current
        state.  ``ControlPlane.apply_pending`` validates a whole epoch
        before applying any of it, so a rejected epoch is atomic."""
        self._fault_check("stage")
        if isinstance(cmd, SwapSlot):
            if not 0 <= int(cmd.slot) < self.num_slots:
                raise ValueError(f"slot {cmd.slot} out of range")
            if not isinstance(cmd.params, dict) or set(cmd.params) != set(self.bank):
                raise ValueError("params structure does not match bank slots")
        elif isinstance(cmd, ProgramReta):
            reta = np.asarray(cmd.reta, np.int32)
            if reta.size == 0:
                raise ValueError("empty RETA")
            if reta.min() < 0 or reta.max() >= self.num_queues:
                raise ValueError("RETA entry out of queue range")
        elif isinstance(cmd, FailQueues):
            if any(not 0 <= q < self.num_queues for q in cmd.queues):
                raise ValueError("failed queue id out of range")
            # no zero-live-queues check here: it would judge each command
            # against the pre-epoch state and reject sequentially valid
            # epochs like [RestoreQueues, FailQueues]; the apply-time
            # failover_table raises instead and the epoch rolls back
        elif isinstance(cmd, RestoreQueues):
            if any(not 0 <= q < self.num_queues for q in cmd.queues):
                raise ValueError("restored queue id out of range")
        elif isinstance(cmd, SetPolicy):
            if cmd.policy is not None and not hasattr(cmd.policy, "propose"):
                raise TypeError("policy must implement propose(view)")
        else:
            raise TypeError(f"not a control command: {cmd!r}")

    def _apply_command(self, cmd) -> None:
        """Apply ONE control command.  Only ``ControlPlane.apply_pending``
        may call this: it is the single mutation funnel."""
        self._fault_check("apply")
        if isinstance(cmd, SwapSlot):
            if self._bankbuf is not None:
                # zero-copy path: make sure the params are staged in the
                # shadow (a no-op when the epoch prestaged at submit), then
                # leave publication to the _finish_epoch flip
                tok = id(cmd)
                if not self._bankbuf.committed(tok):
                    self._bankbuf.stage(int(cmd.slot), cmd.params,
                                        token=tok, epoch=self._epoch_nonce,
                                        force=True)
            else:
                self.bank = bank_lib.update_slot(
                    self.bank, int(cmd.slot), cmd.params)
            self.telemetry.slot_swaps += 1
        elif isinstance(cmd, ProgramReta):
            self._install_reta(np.asarray(cmd.reta, np.int32))
        elif not apply_routing_command(self, cmd):
            raise TypeError(f"not a control command: {cmd!r}")
        if self._mega is not None:
            # deferred mode: the host mirror just mutated; serialize the
            # same mutation into the window's epoch queue
            self._mega.stage_delta(cmd)

    def _fault_check(self, point: str) -> None:
        """Consult the armed ``FaultInjector`` (if any) at a stage/apply
        injection point; a single-host runtime is always host 0."""
        if self._faults is not None:
            self._faults.check(point, 0, self._tick_count)

    def _control_state(self) -> dict:
        """Snapshot everything epochs mutate (apply-time rollback).  Safe
        by reference: appliers install fresh objects, and the active bank
        buffer is never written in place."""
        self._epoch_nonce = object()  # scopes apply-time staging
        return dict(bank=self.bank, reta=self.reta,
                    failed=set(self.failed_queues), policy=self.policy,
                    bucket_load=self.bucket_load,
                    slot_swaps=self.telemetry.slot_swaps,
                    reta_updates=self.telemetry.reta_updates,
                    bankswap=(self._bankbuf.mark()
                              if self._bankbuf is not None else None),
                    mega=(self._mega.delta_mark()
                          if self._mega is not None else None))

    def _rollback_control_state(self, s: dict) -> None:
        if self._bankbuf is not None and s.get("bankswap") is not None:
            self._bankbuf.restore(s["bankswap"])
            # the rolled-back epoch's staged params are garbage; its slots
            # go dirty and resync from the (restored) active bank later
            self._bankbuf.discard_staged()
        self.bank = s["bank"]
        self.reta = s["reta"]
        self.failed_queues = s["failed"]
        self.policy = s["policy"]
        self.bucket_load = s["bucket_load"]
        self.telemetry.slot_swaps = s["slot_swaps"]
        self.telemetry.reta_updates = s["reta_updates"]
        if self._mega is not None and s.get("mega") is not None:
            self._mega.delta_rollback(s["mega"])

    def _prestage_epoch(self, rec) -> None:
        """Submit-time hook (``ControlPlane.submit``): stage the epoch's
        SwapSlot params into the shadow bank while traffic keeps flowing,
        so the barrier commit is a pointer flip.  Best-effort: a busy
        shadow defers staging to apply time, and invalid commands are left
        for ``_validate_command`` to reject."""
        if self._bankbuf is None:
            return
        for cmd in rec.commands:
            if not isinstance(cmd, SwapSlot):
                continue
            if not 0 <= int(cmd.slot) < self.num_slots:
                continue
            try:
                self._bankbuf.stage(int(cmd.slot), cmd.params,
                                    token=id(cmd), epoch=rec.epoch)
            except (ValueError, TypeError):
                # params that do not fit a slot: apply-time validation
                # owns the rejection; drop whatever staged before them
                self._bankbuf.discard_staged()

    def _finish_epoch(self, rec) -> None:
        """Epoch barrier commit: publish every staged SwapSlot by flipping
        which device buffer is active.  O(1): no weights move."""
        if self._bankbuf is not None:
            self.bank = self._bankbuf.commit()

    def adopt_bank(self, bank) -> None:
        """Install externally supplied bank contents outside the epoch path.
        Under double buffering the contents are copied into a fresh active
        buffer; otherwise a plain reference install."""
        if any(leaf.device != self.device for leaf in bank.values()):
            raise ValueError(f"the bank must be on the runtime's device {self.device}")
        if self._bankbuf is not None:
            self._bankbuf.reseed(bank)
            self.bank = self._bankbuf.active
        else:
            self.bank = bank

    def bank_pin(self):
        """Pin the current active bank buffer (for holders that outlive the
        next epoch, e.g. an open megastep window): staging then copies
        instead of writing it.  Returns a handle for ``bank_unpin``; None
        without double buffering (nothing is written in place then)."""
        return (self._bankbuf.pin_active()
                if self._bankbuf is not None else None)

    def bank_unpin(self, handle) -> None:
        """Release a ``bank_pin`` handle."""
        if handle is not None and self._bankbuf is not None:
            self._bankbuf.unpin(handle)

    def _install_reta(self, reta: np.ndarray) -> None:
        reta = np.asarray(reta, np.int32)
        if reta.min() < 0 or reta.max() >= self.num_queues:
            raise ValueError("RETA entry out of queue range")
        if len(reta) != len(self.bucket_load):
            self.bucket_load = np.zeros(len(reta), np.int64)
        self.reta = reta
        self.telemetry.reta_updates += 1

    def _apply_control(self) -> None:
        """Apply queued epochs at a fully quiescent boundary: in-flight
        ticks retire first, so each epoch's wrong-verdict snapshot has
        absorbed every pre-epoch tick, and no in-flight tick reads the
        buffer a commit demotes to shadow.

        In deferred (megastep) mode epochs do not force a flush: they apply
        eagerly to the host mirrors and their serialized deltas land
        mid-window at the matching step (the window's bank is pinned).  The
        window flushes early only when the epoch batch would overflow the
        bounded delta queue.  Each epoch's ``wrong_verdict_at_apply`` is
        then the value as of the last flush."""
        if self.control.has_pending:
            if self._mega is not None:
                self._mega.prepare_epochs(
                    sum(len(r.commands) for r in self.control.pending))
            else:
                self.retire_all()
            self.control.apply_pending(self._tick_count)

    def _tick_boundary(self) -> None:
        """Apply queued control epochs, then let the routing policy react
        (its proposal lands as an epoch at the *next* boundary)."""
        self._apply_control()
        consult_policy(self)

    def flush_control(self) -> None:
        """Force-apply pending epochs now."""
        self._apply_control()

    # -- deprecated direct-mutation shims ------------------------------------

    def swap_slot(self, k: int, params) -> None:
        """Deprecated: emits a single-command ``SwapSlot`` epoch."""
        warnings.warn(_DEPRECATION % ("swap_slot", "SwapSlot"),
                      DeprecationWarning, stacklevel=2)
        self.control.submit(SwapSlot(int(k), params))
        self.flush_control()

    def set_reta(self, reta: np.ndarray) -> None:
        """Deprecated: emits a single-command ``ProgramReta`` epoch."""
        warnings.warn(_DEPRECATION % ("set_reta", "ProgramReta"),
                      DeprecationWarning, stacklevel=2)
        self.control.submit(ProgramReta(tuple(np.asarray(reta, np.int32))))
        self.flush_control()

    def fail_queues(self, failed: tuple[int, ...]) -> None:
        """Deprecated: emits a single-command ``FailQueues`` epoch."""
        warnings.warn(_DEPRECATION % ("fail_queues", "FailQueues"),
                      DeprecationWarning, stacklevel=2)
        self.control.submit(FailQueues(tuple(failed)))
        self.flush_control()

    def reset_reta(self) -> None:
        """Deprecated: emits a single-command ``RestoreQueues`` epoch."""
        warnings.warn(_DEPRECATION % ("reset_reta", "RestoreQueues"),
                      DeprecationWarning, stacklevel=2)
        self.control.submit(RestoreQueues())
        self.flush_control()

    # -- data plane ---------------------------------------------------------

    def dispatch(self, packets_np: np.ndarray, now: float | None = None) -> dict:
        """RSS-dispatch one arrival burst of (n, 272) uint32 rows into the
        per-queue rings.  The arrival edge is a tick boundary: queued
        control epochs become effective before routing."""
        self._apply_control()
        if self._t_start is None:
            self._t_start = time.perf_counter()
        if now is None:
            now = time.perf_counter()
        packets_np = np.asarray(packets_np)
        h = rss.toeplitz_hash(rss.flow_words_of(packets_np), self.rss_key)
        bucket = rss.bucket_index(h, len(self.reta)).astype(np.int64)
        self.bucket_load += np.bincount(bucket, minlength=len(self.reta))
        q = self.reta[bucket]
        self.telemetry.touch(now)
        per_queue = []
        for i, ring in enumerate(self.rings):
            rows = packets_np[q == i]
            admitted = ring.push(rows, now)
            if self._record and admitted < rows.shape[0]:
                self.dropped_seq.extend(
                    int(s) for s in rows[admitted:, SEQ_WORD])
            if self.on_drop is not None and admitted < rows.shape[0]:
                self.on_drop(i, rows[admitted:])
            self.telemetry.record_drops(i, int(rows.shape[0]) - admitted)
            per_queue.append({"offered": int(rows.shape[0]),
                              "admitted": admitted,
                              "dropped": int(rows.shape[0]) - admitted})
        if self._mega is not None:
            # deferred mode: the host rings above stay authoritative; the
            # device replays the identical admission at flush
            self._mega.stage_burst(packets_np, q)
        return {"per_queue": per_queue,
                "dropped": sum(p["dropped"] for p in per_queue)}

    def _pad(self, rows: np.ndarray) -> np.ndarray:
        n = rows.shape[0]
        if n == self.batch:
            return rows
        out = np.zeros((self.batch, rows.shape[1]), np.uint32)
        out[:n] = rows
        if n:  # repeat the last valid row; results beyond n are discarded
            out[n:] = rows[n - 1]
        return out

    def tick(self) -> int:
        """Pipeline stage 1 (dispatch): pop up to ``batch`` rows per queue,
        send them to the device in one copy and issue the workers; stage 3
        (retire) runs for the oldest tick once more than
        ``pipeline_depth`` are in flight."""
        if (self._faults is not None
                and not self._faults.responsive(0, self._tick_count)):
            # injected stall: the tick elapses but the host serves
            # nothing; pending epochs stay queued, rings keep backlog
            self._tick_count += 1
            return 0
        self._tick_boundary()
        self._tick_count += 1
        self.telemetry.runtime_ticks += 1
        if self._mega is not None:
            # deferred mode: pop the host mirror now, serve on the device
            # at flush (``pipeline_depth`` is superseded by the window)
            return self._mega.stage_tick()
        popped = [ring.pop(self.batch) for ring in self.rings]
        counts = [rows.shape[0] for rows, _ in popped]
        total = sum(counts)
        if total == 0:
            return 0
        t0 = time.perf_counter()
        live = [q for q in range(self.num_queues) if counts[q]]
        if self.fanout == "loop":
            x_all = pkt.to_device(
                np.stack([self._pad(popped[q][0]) for q in live]), self.device)
            x = dict(zip(live, x_all))
            results = {q: self._packed(pipeline.packet_step(
                self.bank, x[q], **self._step_kwargs())) for q in live}
        else:
            x_all = pkt.to_device(
                np.stack([self._pad(rows) for rows, _ in popped]), self.device)
            res = self._packed(self._stacked_step(self.bank, x_all))
            b = self.batch
            x = {q: x_all[q] for q in live}
            results = {q: res[:, q * b:(q + 1) * b] for q in live}
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self._inflight.append(_InFlight(
            self._tick_count, popped, counts, x, results, self.bank, done, t0))
        while len(self._inflight) > self.pipeline_depth - 1:
            self._retire(self._inflight.popleft())
        return total

    def _retire(self, rec: _InFlight) -> None:
        """Pipeline stage 3: wait for the tick's device work, then fold
        results into telemetry / audit / record and retire ring rows."""
        total = sum(rec.counts)
        if rec.done is not None:
            rec.done.synchronize()
        now = time.perf_counter()
        # busy time must not double-count overlapping in-flight windows:
        # charge this tick only for the span since the previous retire
        start = (rec.t0 if self._last_retire_s is None
                 else max(rec.t0, self._last_retire_s))
        tick_s = now - start
        self._last_retire_s = now
        for q, res in rec.results.items():
            n = rec.counts[q]
            rows, ts = rec.popped[q]
            host = res[:, :n].cpu().numpy()
            slots, verdicts, actions = host[0], host[1].astype(bool), host[2]
            if self.on_retire is not None:
                self.on_retire(q, rows, slots, verdicts, actions, rec.tick)
            self.telemetry.record_tick(
                q, slots, verdicts, actions,
                latency_us=(now - ts) * 1e6,
                tick_s=tick_s * n / total,
            )
            self.rings[q].mark_completed(n)
            if self.audit:
                # audit against the bank version this tick was dispatched
                # with: a later epoch must not invalidate earlier work
                exact = self._packed(pipeline.packet_step(
                    rec.bank, rec.x[q], num_slots=self.num_slots,
                    strategy="take", backend=self.backend))[:, :n].cpu().numpy()
                bad = (exact[1].astype(bool) != verdicts).sum()
                bad += (exact[0] != slots).sum()
                self.telemetry.wrong_verdict += int(bad)
            if self._record:
                self.completed_seq[q].extend(int(s) for s in rows[:, SEQ_WORD])
                self.completed_verdicts[q].extend(bool(v) for v in verdicts)
                self.completed_slots[q].extend(int(s) for s in slots)
        self.telemetry.touch(now)
        if self.telemetry.has_sink:
            self.telemetry.emit_delta(
                tick=rec.tick, now=now,
                depths=[len(r) for r in self.rings])

    def retire_all(self) -> None:
        """Flush the pipeline: retire every in-flight tick (oldest first).
        In deferred mode this is the megastep flush point."""
        if self._mega is not None:
            self._mega.flush()
        while self._inflight:
            self._retire(self._inflight.popleft())
        if self.telemetry.has_sink:
            # flush counters with no retire to ride on (e.g. trailing
            # dispatch-edge drops) so the delta stream sums to snapshot()
            self.telemetry.emit_delta(tick=self._tick_count)

    def in_flight_rows(self) -> list[int]:
        """Rows popped but not yet retired, per queue: in-flight ticks, plus
        the staged-but-unflushed megastep window in deferred mode."""
        out = [0] * self.num_queues
        for rec in self._inflight:
            for q, n in enumerate(rec.counts):
                out[q] += n
        if self._mega is not None:
            for q, n in enumerate(self._mega.staged_rows()):
                out[q] += n
        return out

    def drain(self, max_ticks: int = 100_000) -> int:
        """Tick until every ring is empty, then flush the pipeline.
        Returns the number of rows served."""
        return drain_rings(self, max_ticks)

    # -- audit + reporting --------------------------------------------------

    def audit_conservation(self) -> dict:
        """Per-queue + aggregate packet conservation; must always hold,
        mid-pipeline too, where popped-but-unretired rows count as
        ``in_flight``."""
        inflight = self.in_flight_rows()
        per_queue = [ring.conservation(in_flight=inflight[q])
                     for q, ring in enumerate(self.rings)]
        totals = {k: sum(c[k] for c in per_queue)
                  for k in ("offered", "admitted", "dropped", "completed",
                            "occupancy", "in_flight")}
        ok = all(c["producer_ok"] and c["consumer_ok"] for c in per_queue)
        return {"per_queue": per_queue, "totals": totals, "ok": ok,
                "wrong_verdict": self.telemetry.wrong_verdict}

    def snapshot(self) -> dict:
        """One-call runtime report: telemetry totals, conservation audit,
        configuration echo, and control-plane stats."""
        elapsed = (time.perf_counter() - self._t_start
                   if self._t_start is not None else None)
        out = self.telemetry.snapshot(elapsed_s=elapsed)
        out["conservation"] = self.audit_conservation()
        out["fanout"] = self.fanout
        out["strategy"] = self.strategy
        out["pipeline_depth"] = self.pipeline_depth
        out["policy"] = getattr(self.policy, "name", None)
        out["control"] = self.control.stats()
        return out
