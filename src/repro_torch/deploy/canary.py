"""Canary rollout: stage new weights on a canary subset, bake, decide
(torch port).

``CanaryController`` rolls new slot weights out in three audited moves,
every one a typed control-plane epoch (visible in the epoch log, covered
by ``continuity_audit()``):

1. **start** — one epoch swaps the weights into a designated *canary
   slot* and reprograms a small bucket share of the RETA onto a canary
   queue (``ProgramReta``), so the new model serves real traffic without
   touching the incumbent slot.
2. **bake** — for ``bake_ticks`` ticks the controller watches the
   dataplane (wrong-verdict counter, ring-edge drop fraction) while the
   sampler accumulates labeled examples from the live window.
3. **decide** — a paired evaluation of new-vs-baseline weights on the
   bake window picks exactly one terminal outcome: *promote* (one epoch
   installs the weights in the target slot, restores the canary slot and
   the prior RETA) or *roll back* (one epoch restores both).  No samples,
   a quality regression, or any dataplane-health regression all roll
   back — the conservative default.

Every transition appends a decision record to ``runtime.deploy_log``
(surfaced by the ``/epochs`` endpoint via ``obs.spans.epoch_log_doc``).
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.control.commands import ProgramReta, SwapSlot
from repro_torch.core import bank as bank_lib
from repro_torch.core import executor
from repro_torch.core import packet as pkt


def unwrap(runtime):
    """Peel same-API facades (TraceRecorder ``_rt``, DeployDriver
    ``_inner``) down to the base runtime/mesh.  ``__dict__`` lookups so a
    facade's ``__getattr__`` delegation can't loop."""
    while True:
        inner = (runtime.__dict__.get("_inner")
                 or runtime.__dict__.get("_rt"))
        if inner is None:
            return runtime
        runtime = inner


def deploy_log_of(runtime) -> list:
    """The runtime's deployment decision log (created on first use).

    Always stored on the *base* runtime so the one epoch-log serializer
    (``obs.spans.epoch_log_doc``) finds it regardless of which facade a
    controller was handed.
    """
    base = unwrap(runtime)
    log = base.__dict__.get("deploy_log")
    if log is None:
        log = []
        base.deploy_log = log
    return log


def bank_of(runtime):
    """Resident bank of a runtime or mesh facade (slots are global)."""
    bank = getattr(runtime, "bank", None)
    return bank if bank is not None else runtime.shards[0].bank


def wrong_verdict_total(runtime) -> int:
    shards = getattr(runtime, "shards", None) or [runtime]
    return sum(int(s.telemetry.wrong_verdict) for s in shards)


def live_queues(runtime) -> list[int]:
    """Global ids of queues not administratively failed."""
    shards = getattr(runtime, "shards", None)
    if shards is None:
        return [q for q in range(runtime.num_queues)
                if q not in runtime.failed_queues]
    qph = runtime.num_queues_per_host
    return [h * qph + q for h, s in enumerate(shards)
            for q in range(qph) if q not in s.failed_queues]


def paired_err(params, payload_words: np.ndarray, labels: np.ndarray) -> float:
    """Misclassification rate of packed ``params`` on labeled payloads, on
    the params' device (``executor.forward``: ``xnor_matmul`` on the card)."""
    x = pkt.to_device(np.asarray(payload_words, np.uint32),
                      params["w1p"].device)
    scores = executor.forward(params, x)[:, 0].cpu().numpy()
    return float(((scores > 0) != (np.asarray(labels) == 1)).mean())


def slot_copy(bank, slot: int) -> dict:
    """A private copy of one resident slot.  ``select_slot`` returns views
    of the bank's leaves, and the runtime's double buffer stages later
    epochs into those buffers in place, so a slot held across epochs (a
    rollback target, a baseline) must own its tensors."""
    return {name: leaf.clone()
            for name, leaf in bank_lib.select_slot(bank, slot).items()}


class CanaryController:
    """One in-flight canary rollout; terminal state is exactly one of
    ``promoted`` / ``rolled_back`` (``flush()`` forces the decision when
    traffic ends mid-bake, so a canary can never dangle)."""

    IDLE, BAKING = "idle", "baking"

    def __init__(self, runtime, sampler=None, *, target_slot: int = 0,
                 canary_slot: int | None = None, canary_share: float = 0.125,
                 bake_ticks: int = 16, tolerance: float = 0.02,
                 min_samples: int = 24, drop_tolerance: float = 0.10):
        num_slots = runtime.num_slots
        if num_slots < 2:
            raise ValueError("canary rollout needs >= 2 resident slots")
        self.target_slot = int(target_slot)
        self.canary_slot = (int(canary_slot) if canary_slot is not None
                            else (self.target_slot + 1) % num_slots)
        if self.canary_slot == self.target_slot:
            raise ValueError("canary slot must differ from target slot")
        if not 0 < canary_share <= 0.5:
            raise ValueError("canary_share must be in (0, 0.5]")
        self.runtime = runtime
        self.sampler = sampler
        self.canary_share = float(canary_share)
        self.bake_ticks = int(bake_ticks)
        self.tolerance = float(tolerance)
        self.min_samples = int(min_samples)
        self.drop_tolerance = float(drop_tolerance)
        self.log = deploy_log_of(runtime)
        self.decisions: list[dict] = []   # terminal records only
        self.state = self.IDLE

    # -- lifecycle -----------------------------------------------------------

    def start(self, params, *, baseline=None, reason: str = "manual") -> int:
        """Stage ``params`` on the canary slot + steered bucket share;
        returns the epoch id of the canary_start transition."""
        if self.state != self.IDLE:
            raise RuntimeError("a canary is already baking")
        rt = self.runtime
        bank = bank_of(rt)
        self._params = params
        self._baseline = (baseline if baseline is not None
                          else slot_copy(bank, self.target_slot))
        self._old_canary = slot_copy(bank, self.canary_slot)
        self._prior_reta = np.asarray(rt.reta, np.int32).copy()
        live = live_queues(rt) or [0]
        canary_queue = live[-1]
        steered = self._prior_reta.copy()
        n_steer = max(1, int(round(len(steered) * self.canary_share)))
        buckets = np.linspace(0, len(steered) - 1, n_steer).astype(np.int64)
        steered[buckets] = canary_queue

        self._tick0 = int(rt._tick_count)
        self._t0 = time.perf_counter()
        self._wv0 = wrong_verdict_total(rt)
        totals = rt.audit_conservation()["totals"]
        self._drop0, self._offered0 = totals["dropped"], totals["offered"]

        epoch = rt.control.submit(
            SwapSlot(self.canary_slot, params),
            ProgramReta(tuple(int(q) for q in steered)))
        rt.flush_control()
        self.state = self.BAKING
        self._log("canary_start", epoch=epoch, reason=reason, metrics={
            "share": self.canary_share, "bake_ticks": self.bake_ticks,
            "canary_queue": int(canary_queue), "steered_buckets": int(n_steer),
        })
        return epoch

    def step(self) -> dict | None:
        """Advance the bake clock; returns the terminal decision record
        once the window closes, else None.  Call after each tick."""
        if self.state != self.BAKING:
            return None
        if self.runtime._tick_count - self._tick0 < self.bake_ticks:
            return None
        return self._decide()

    def flush(self) -> dict | None:
        """Force the decision now (end of traffic)."""
        if self.state == self.BAKING:
            return self._decide()
        return None

    # -- decision ------------------------------------------------------------

    def _decide(self) -> dict:
        rt = self.runtime
        metrics: dict = {"bake_window_ticks":
                         int(rt._tick_count - self._tick0)}
        wv_delta = wrong_verdict_total(rt) - self._wv0
        totals = rt.audit_conservation()["totals"]
        offered = totals["offered"] - self._offered0
        drop_frac = (totals["dropped"] - self._drop0) / max(offered, 1)
        metrics.update(wrong_verdict_delta=int(wv_delta),
                       drop_frac=round(float(drop_frac), 4))

        if self.sampler is not None:
            words, labels, _verdicts, _slots = \
                self.sampler.window_since(self._tick0)
        else:
            words = np.zeros((0, 256), np.uint32)
            labels = np.zeros(0, np.int8)
        metrics["bake_samples"] = int(labels.size)

        promote, reason = False, ""
        if wv_delta > 0:
            reason = f"wrong verdicts during bake ({wv_delta})"
        elif drop_frac > self.drop_tolerance:
            reason = f"drop fraction {drop_frac:.3f} > {self.drop_tolerance}"
        elif labels.size < self.min_samples:
            reason = (f"insufficient labeled bake samples "
                      f"({labels.size} < {self.min_samples})")
        else:
            err_new = paired_err(self._params, words, labels)
            err_base = paired_err(self._baseline, words, labels)
            metrics.update(err_new=round(err_new, 4),
                           err_base=round(err_base, 4))
            if err_new <= err_base + self.tolerance:
                promote = True
                reason = (f"err {err_new:.3f} <= baseline {err_base:.3f} "
                          f"+ tol {self.tolerance}")
            else:
                reason = (f"err {err_new:.3f} > baseline {err_base:.3f} "
                          f"+ tol {self.tolerance}")

        prior_reta = ProgramReta(tuple(int(q) for q in self._prior_reta))
        if promote:
            epoch = rt.control.submit(
                SwapSlot(self.target_slot, self._params),
                SwapSlot(self.canary_slot, self._old_canary),
                prior_reta)
        else:
            epoch = rt.control.submit(
                SwapSlot(self.canary_slot, self._old_canary),
                prior_reta)
        rt.flush_control()
        self.state = self.IDLE
        metrics["elapsed_us"] = round((time.perf_counter() - self._t0) * 1e6, 1)
        rec = self._log("promoted" if promote else "rolled_back",
                        epoch=epoch, reason=reason, metrics=metrics)
        self.decisions.append(rec)
        return rec

    def _log(self, event: str, *, epoch=None, reason: str = "",
             metrics: dict | None = None) -> dict:
        rec = {"event": event, "tick": int(self.runtime._tick_count),
               "slot": self.target_slot, "canary_slot": self.canary_slot,
               "epoch": epoch, "reason": reason, "metrics": metrics or {}}
        self.log.append(rec)
        return rec
