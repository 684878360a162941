"""Auto-remediation + deploy drivers (torch port): detector proposals become
audited online control epochs; retrain triggers become sampler -> trainer ->
canary pipelines.

``AutoRemediator`` polls an ``AnomalyDetector`` between ticks and acts on
its typed proposals:

* ``ProgramReta`` / ``FailQueues`` — submitted directly as control
  epochs (same stage/apply/rollback path as any operator epoch).
* ``RetrainRequest`` (and its ``SwapSlot`` spec carrier) — fine-tune the
  named slot on the sampler's labeled reservoirs and roll the result out
  through a ``CanaryController``; the canary decides promote/rollback.

Every action appends to the runtime's ``deploy_log``, so the decision
trail rides the same epoch-log document operators already read
(``/epochs``, ``obs.spans.epoch_log_doc``).

``DeployDriver`` is a same-API facade (the ``TraceRecorder`` precedent)
that steps registered pilots (remediator / scheduled rollouts) after
every tick, including through drains, without touching ``workloads.play``.
Pilots should submit epochs through the *driver's* ``control`` so that a
wrapped ``TraceRecorder`` records deployment epochs into the trace.
"""

from __future__ import annotations

from repro_torch.control.commands import FailQueues, ProgramReta
from repro_torch.deploy.canary import CanaryController, deploy_log_of
from repro_torch.obs.anomaly import RetrainRequest


def corrupt_params(params: dict) -> dict:
    """Adversarial weights for forced-rollback demos: negating the output
    layer inverts every verdict while keeping the pytree structure (and
    thus epoch staging) identical."""
    return {**params, "w2": -params["w2"], "b2": -params["b2"]}


def _proposal_key(prop) -> tuple:
    if isinstance(prop, RetrainRequest):
        return ("retrain", int(prop.slot), prop.reason)
    return (type(prop).__name__, repr(prop.describe()))


class AutoRemediator:
    """Detector proposals -> online epochs / retrain-canary pipelines."""

    def __init__(self, runtime, detector, *, sampler=None, trainer=None,
                 canary_kw: dict | None = None,
                 min_retrain_samples: int = 48, cooldown_ticks: int = 24,
                 max_actions: int = 8):
        self.runtime = runtime
        self.detector = detector
        self.sampler = sampler
        self.trainer = trainer
        self.canary_kw = dict(canary_kw or {})
        self.min_retrain_samples = int(min_retrain_samples)
        self.cooldown_ticks = int(cooldown_ticks)
        self.max_actions = int(max_actions)
        self.log = deploy_log_of(runtime)
        self.canary: CanaryController | None = None
        self.actions = 0
        self._acted: set[tuple] = set()
        self._last_action: int | None = None

    def step(self) -> None:
        rt = self.runtime
        if self.canary is not None and self.canary.step() is not None:
            self.canary = None
        self.detector.poll()
        tick = int(rt._tick_count)
        if self.actions >= self.max_actions:
            return
        if (self._last_action is not None
                and tick - self._last_action < self.cooldown_ticks):
            return
        for prop in self.detector.proposals():
            key = _proposal_key(prop)
            if key in self._acted:
                continue
            if isinstance(prop, (ProgramReta, FailQueues)):
                self._acted.add(key)
                epoch = rt.control.submit(prop)
                self.log.append({
                    "event": "auto_remediate", "tick": tick, "epoch": epoch,
                    "command": prop.describe(),
                    "reason": "detector proposal"})
                self._mark_action(tick)
                return
            if isinstance(prop, RetrainRequest):
                if self._retrain(prop, tick):
                    return
            # SwapSlot specs (params=None) are the RetrainRequest's
            # carrier — the retrain pipeline materializes the weights.

    def _retrain(self, prop: RetrainRequest, tick: int) -> bool:
        if (self.canary is not None or self.trainer is None
                or self.sampler is None):
            return False
        words, labels = self.sampler.training_batch()
        if labels.size < self.min_retrain_samples:
            return False
        self._acted.add(_proposal_key(prop))
        result = self.trainer.fine_tune(words, labels,
                                        extra={"reason": prop.reason})
        self.log.append({
            "event": "retrain", "tick": tick, "slot": int(prop.slot),
            "reason": prop.reason, "checkpoint": result.checkpoint_path,
            "metrics": {k: float(v) for k, v in result.metrics.items()}})
        kw = dict(self.canary_kw)
        kw.setdefault("target_slot", int(prop.slot))
        self.canary = CanaryController(self.runtime, self.sampler, **kw)
        self.canary.start(result.params, reason=f"retrain:{prop.reason}")
        self._mark_action(tick)
        return True

    def _mark_action(self, tick: int) -> None:
        self._last_action = tick
        self.actions += 1

    def flush(self) -> None:
        """End of traffic: force any baking canary to a terminal decision."""
        if self.canary is not None:
            self.canary.flush()
            self.canary = None


class ScheduledRollout:
    """Scripted fine-tune -> canary (demos / fig14):
    after ``warmup_ticks`` and enough labeled samples, fine-tune on the
    sampler's reservoirs and start one canary.  ``corrupt=True`` negates
    the trained output layer first, forcing the bake-window evaluation to
    roll the rollout back."""

    def __init__(self, runtime, sampler, trainer, *, target_slot: int = 0,
                 warmup_ticks: int = 24, min_samples: int = 48,
                 corrupt: bool = False, canary_kw: dict | None = None):
        self.runtime = runtime
        self.sampler = sampler
        self.trainer = trainer
        self.target_slot = int(target_slot)
        self.warmup_ticks = int(warmup_ticks)
        self.min_samples = int(min_samples)
        self.corrupt = bool(corrupt)
        self.canary_kw = dict(canary_kw or {})
        self.log = deploy_log_of(runtime)
        self.canary: CanaryController | None = None
        self.result = None

    def step(self) -> None:
        if self.canary is not None:
            self.canary.step()
            return
        rt = self.runtime
        if self.result is not None or rt._tick_count < self.warmup_ticks:
            return
        words, labels = self.sampler.training_batch()
        if labels.size < self.min_samples:
            return
        self.result = self.trainer.fine_tune(words, labels)
        params = self.result.params
        reason = "scheduled"
        if self.corrupt:
            params = corrupt_params(params)
            reason = "scheduled:corrupted"
        self.log.append({
            "event": "retrain", "tick": int(rt._tick_count),
            "slot": self.target_slot, "reason": reason,
            "checkpoint": self.result.checkpoint_path,
            "metrics": {k: float(v) for k, v in self.result.metrics.items()}})
        self.canary = CanaryController(
            rt, self.sampler, target_slot=self.target_slot, **self.canary_kw)
        self.canary.start(params, reason=reason)

    def flush(self) -> None:
        if self.canary is not None:
            self.canary.flush()

    @property
    def decision(self) -> dict | None:
        if self.canary is not None and self.canary.decisions:
            return self.canary.decisions[-1]
        return None


class DeployDriver:
    """Same-API facade that steps deploy pilots after every tick.

    Wraps a runtime, mesh, or ``TraceRecorder`` (``__getattr__``
    delegation, the recorder precedent); ``drain`` ticks through the
    facade so pilots keep stepping while rings empty, then hands the
    converged (empty) drain to the inner driver so a wrapped recorder
    still logs its drain step and flushes the pipeline.
    """

    def __init__(self, inner, *pilots):
        self._inner = inner
        self._pilots = list(pilots)

    def add(self, pilot) -> "DeployDriver":
        self._pilots.append(pilot)
        return self

    def dispatch(self, packets_np, now=None, **kw):
        return self._inner.dispatch(packets_np, now=now, **kw)

    def tick(self) -> int:
        n = self._inner.tick()
        for p in self._pilots:
            p.step()
        return n

    def drain(self, max_ticks: int = 100_000) -> int:
        done = 0
        for _ in range(max_ticks):
            n = self.tick()
            done += n
            if n == 0 and not self._backlog():
                return done + self._inner.drain(max_ticks)
        raise RuntimeError("drain did not converge")

    def flush_deploy(self) -> None:
        """End of run: force every pilot's pending canary to a decision."""
        for p in self._pilots:
            p.flush()

    def _backlog(self) -> bool:
        inner = self._inner
        shards = getattr(inner, "shards", None)
        if shards is not None:
            if any(len(r) for h, s in enumerate(shards)
                   if not inner.health.is_dead(h) for r in s.rings):
                return True
            return bool(inner._barrier_deferred)
        return any(len(r) for r in inner.rings)

    def __getattr__(self, name):
        return getattr(self._inner, name)
