"""Rolling-window anomaly detection over the telemetry delta stream
(torch port: NumPy over the stream, the reference's rules).

``AnomalyDetector`` tails a ``TelemetryStream`` (``poll()``) and folds
delta / epoch / health events into per-tick features: aggregate load,
ring-edge drops, per-queue completion shares, slot-mix windows, the
epoch timeline, and health-lease transitions.  Five detectors run over
those features —

* **pps spike**              — load >= ``spike_factor`` x trailing median
* **drop-rate surge**        — window drop fraction >= ``drop_frac``
* **slot-mix shift**         — windowed mix L1-distance >= ``mix_shift``
* **queue silence**          — backlogged queue completing nothing
* **barrier-latency inflation** — epoch latency >> median, or any
  degraded/rollback commit

— and a decision tree over the same features classifies the active
traffic regime with one of the 11 corpus names (``generators.
REGIME_NAMES``) or ``"steady"``.  The detector only ever *proposes*
typed command epochs (``proposals()``); nothing is auto-applied — an
operator (or a later learned agent) decides.  ``timeline`` records the
rolling classification after every processed tick, so replay tests and
fig13 can measure detect-latency-in-ticks.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np

from repro_torch.control.commands import FailQueues, ProgramReta, SwapSlot
from repro_torch.dataplane import rss
from repro_torch.obs.stream import TelemetryStream


@dataclasses.dataclass(frozen=True)
class RetrainRequest:
    """Deploy-plane proposal — NOT a control command (never staged on the
    control plane): fine-tune the named slot's model on freshly sampled
    traffic and roll the result out through a canary ``SwapSlot`` epoch
    (``repro_torch.deploy``).  Carries the same ``describe()`` surface as the
    typed commands so dashboards serialize proposals uniformly."""
    slot: int
    reason: str
    tick: int

    def describe(self) -> dict:
        return {"cmd": "retrain", "slot": int(self.slot),
                "reason": self.reason, "tick": int(self.tick)}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One detector firing at one tick."""
    detector: str
    tick: int
    detail: dict

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class AnomalyDetector:
    """Streaming regime classifier + epoch proposer (read-only)."""

    def __init__(self, stream: TelemetryStream, *, num_queues: int,
                 num_slots: int, hosts: int = 1,
                 reta_size: int = rss.RETA_SIZE,
                 window: int = 8, spike_factor: float = 3.0,
                 drop_frac: float = 0.05, mix_shift: float = 0.5,
                 silence_ticks: int = 6, latency_factor: float = 8.0,
                 dominance_share: float = 0.55, dominance_run: int = 10):
        self.stream = stream
        self.num_queues = num_queues      # global (all hosts)
        self.num_slots = num_slots
        self.hosts = hosts
        self.queues_per_host = num_queues // max(hosts, 1)
        self.reta_size = reta_size
        self.window = window
        self.spike_factor = spike_factor
        self.drop_frac = drop_frac
        self.mix_shift = mix_shift
        self.silence_ticks = silence_ticks
        self.latency_factor = latency_factor
        self.dominance_share = dominance_share
        self.dominance_run = dominance_run
        self._cursor = 0
        # per-tick features (tick -> value); ticks with no traffic are absent
        self.load: dict[int, int] = {}
        self.drops: dict[int, int] = {}
        self.qload: dict[int, dict[int, int]] = {}
        self.slot_mix: dict[int, np.ndarray] = {}
        self.depth: dict[int, int] = {}           # gid -> last seen depth
        self._last_completion: dict[int, int] = {}  # gid -> last active tick
        self.epochs: list[dict] = []
        self.health: list[dict] = []
        self.findings: list[Finding] = []
        self.timeline: list[tuple[int, str]] = []  # (tick, rolling regime)
        self._fired: set[tuple] = set()
        self._seen_tick: int | None = None

    # -- ingestion -----------------------------------------------------------

    def poll(self) -> int:
        """Consume pending stream events; returns how many were processed.

        The rolling classification is re-run every time the observed
        tick advances, so ``timeline`` records what the detector would
        have said live at each tick (detect-latency is measured off it).
        """
        events, self._cursor = self.stream.tail(self._cursor, limit=1 << 20)
        for ev in events:
            kind = ev.get("kind")
            if kind == "delta":
                t = ev["tick"]
                if self._seen_tick is not None and t > self._seen_tick:
                    self.timeline.append(
                        (self._seen_tick, self._classify()[0]))
                self._seen_tick = (t if self._seen_tick is None
                                   else max(self._seen_tick, t))
                self._ingest_delta(ev)
            elif kind == "epoch":
                self._ingest_epoch(ev)
            elif kind == "health":
                self.health.append(ev)
        return len(events)

    def _gid(self, ev: dict, queue: int) -> int:
        return ev.get("host", 0) * self.queues_per_host + queue

    def _ingest_delta(self, ev: dict) -> None:
        t = ev["tick"]
        for q in ev["queues"]:
            gid = self._gid(ev, q["queue"])
            done = q["completed"]
            self.load[t] = self.load.get(t, 0) + done
            self.drops[t] = self.drops.get(t, 0) + q["dropped"]
            if done:
                self.qload.setdefault(t, {})
                self.qload[t][gid] = self.qload[t].get(gid, 0) + done
                self._last_completion[gid] = t
            if "depth" in q:
                self.depth[gid] = q["depth"]
            mix = self.slot_mix.setdefault(
                t, np.zeros(self.num_slots, np.int64))
            mix += np.asarray(q["per_slot"], np.int64)
        self._run_detectors(t)

    def _ingest_epoch(self, ev: dict) -> None:
        kinds = [c["cmd"] for c in ev["commands"]]
        fail = sorted(set(q for c in ev["commands"] if c["cmd"] == "fail_queues"
                          for q in c["queues"]))
        self.epochs.append({
            "epoch": ev["epoch"], "tick": ev["applied_tick"],
            "kinds": kinds, "fail": fail,
            "commit_mode": ev["commit_mode"],
            "latency_us": ev["apply_latency_us"],
        })
        self._detect_latency_inflation(self.epochs[-1])

    # -- rolling detectors ---------------------------------------------------

    def _fire(self, detector: str, tick: int, **detail) -> None:
        key = (detector, tick, tuple(sorted(detail.get("queues", ()))))
        if key in self._fired:
            return
        self._fired.add(key)
        self.findings.append(Finding(detector, tick, detail))

    def _trailing(self, series: dict[int, int], tick: int) -> list[int]:
        ticks = sorted(t for t in series if t < tick)[-self.window:]
        return [series[t] for t in ticks]

    def _run_detectors(self, tick: int) -> None:
        load = self.load.get(tick, 0)
        prior = self._trailing(self.load, tick)
        if len(prior) >= 3:
            med = statistics.median(prior)
            if med > 0 and load >= self.spike_factor * med:
                self._fire("pps_spike", tick, load=load, median=med)
        window_ticks = sorted(t for t in self.load if t <= tick)[-self.window:]
        w_load = sum(self.load[t] for t in window_ticks)
        w_drops = sum(self.drops.get(t, 0) for t in window_ticks)
        if w_load + w_drops > 0 and w_drops >= self.drop_frac * (w_load + w_drops):
            self._fire("drop_surge", tick, dropped=w_drops, window_load=w_load)
        self._detect_mix_shift(tick)
        self._detect_silence(tick)

    def _detect_mix_shift(self, tick: int) -> None:
        ticks = sorted(t for t in self.slot_mix if t <= tick)
        if len(ticks) < 2 * self.window:
            return
        zero = np.zeros(self.num_slots, np.float64)
        cur = sum((self.slot_mix[t] for t in ticks[-self.window:]), zero)
        prev = sum((self.slot_mix[t] for t in
                    ticks[-2 * self.window:-self.window]), zero.copy())
        if cur.sum() == 0 or prev.sum() == 0:
            return
        l1 = float(np.abs(cur / cur.sum() - prev / prev.sum()).sum())
        if l1 >= self.mix_shift:
            self._fire("slot_mix_shift", tick, l1=round(l1, 3))

    def _detect_silence(self, tick: int) -> None:
        failed = set(q for e in self.epochs for q in e["fail"])
        silent = [gid for gid, d in self.depth.items()
                  if d > 0 and gid not in failed
                  and tick - self._last_completion.get(gid, tick) >=
                  self.silence_ticks]
        if silent:
            self._fire("queue_silence", tick, queues=tuple(sorted(silent)))

    def _detect_latency_inflation(self, epoch: dict) -> None:
        if epoch["commit_mode"] in ("degraded", "rollback"):
            self._fire("barrier_latency_inflation", epoch["tick"] or 0,
                       commit_mode=epoch["commit_mode"], epoch=epoch["epoch"])
            return
        prior = [e["latency_us"] for e in self.epochs[:-1]
                 if e["latency_us"] is not None]
        lat = epoch["latency_us"]
        if lat is not None and len(prior) >= 3:
            med = statistics.median(prior)
            if med > 0 and lat >= self.latency_factor * med:
                self._fire("barrier_latency_inflation", epoch["tick"] or 0,
                           latency_us=lat, median_us=med)

    # -- regime features -----------------------------------------------------

    def _spike_regions(self) -> list[tuple[int, int, int]]:
        """Maximal (onset, end, peak) regions around trailing-median
        spikes, extended while load stays >= half the region peak."""
        spikes = sorted({f.tick for f in self.findings
                         if f.detector == "pps_spike"})
        ticks = sorted(self.load)
        regions: list[tuple[int, int, int]] = []
        for s in spikes:
            if regions and regions[-1][0] <= s <= regions[-1][1]:
                continue
            region = [t for t in ticks if t >= s]
            peak = self.load[s]
            end = s
            for t in region:
                if self.load[t] >= 0.5 * peak:
                    peak = max(peak, self.load[t])
                    end = t
                else:
                    break
            regions.append((s, end, peak))
        return regions

    def _dominance_run(self) -> tuple[int, int | None]:
        """Longest run of consecutive active ticks where one queue owns
        >= ``dominance_share`` of completions; returns (length, gid)."""
        best, best_gid = 0, None
        run, run_gid, prev_t = 0, None, None
        for t in sorted(self.qload):
            total = sum(self.qload[t].values())
            gid, top = max(self.qload[t].items(), key=lambda kv: kv[1])
            dominated = total >= 32 and top >= self.dominance_share * total
            contiguous = prev_t is None or t - prev_t <= 2
            if dominated and gid == run_gid and contiguous:
                run += 1
            elif dominated:
                run, run_gid = 1, gid
            else:
                run, run_gid = 0, None
            if run > best:
                best, best_gid = run, run_gid
            prev_t = t
        return best, best_gid

    def _host_group(self, queues: list[int]) -> int | None:
        """The host whose full queue set ``queues`` is, if any."""
        if self.hosts < 2 or not queues:
            return None
        h = queues[0] // self.queues_per_host
        group = set(range(h * self.queues_per_host,
                          (h + 1) * self.queues_per_host))
        return h if set(queues) == group else None

    def _epoch_burst_rate(self) -> float:
        """Max applied-epoch count in any ``window`` consecutive ticks,
        normalized by the window."""
        ticks = sorted(e["tick"] for e in self.epochs
                       if e["tick"] is not None)
        if not ticks:
            return 0.0
        best = max(sum(1 for t in ticks if lo <= t < lo + self.window)
                   for lo in ticks)
        return best / self.window

    # -- classification ------------------------------------------------------

    def classify(self) -> dict:
        """Name the active regime from everything ingested so far."""
        regime, evidence = self._classify()
        return {"regime": regime, "evidence": evidence,
                "findings": len(self.findings)}

    def _classify(self) -> tuple[str, dict]:
        deaths = [h for h in self.health if h["to"] == "dead"]
        if deaths:
            t_dead = deaths[0]["tick"]
            rejoined = any(h["to"] in ("recovering", "healthy")
                           and h["tick"] > t_dead for h in self.health)
            if rejoined:
                return "barrier-straggler", {"dead_at": t_dead,
                                             "rejoined": True}
            return "crash-mid-commit", {"dead_at": t_dead, "rejoined": False}

        fail_epochs = [e for e in self.epochs
                       if e["fail"] and e["tick"] is not None]
        rate = self._epoch_burst_rate()
        if not fail_epochs and rate >= 0.75:
            return "slot-thrash", {"epoch_burst_rate": rate}

        spikes = self._spike_regions()
        if fail_epochs:
            sets = [set(e["fail"]) for e in fail_epochs]
            if len(sets) >= 2 and any(
                    a < b for a, b in zip(sets, sets[1:])):
                return "cascading-failover", {
                    "fail_sets": [sorted(s) for s in sets]}
            host = self._host_group(fail_epochs[0]["fail"])
            if host is not None:
                return "chaos-host-failover", {"host": host}
            t_fail = fail_epochs[0]["tick"]
            in_spike = any(lo <= t_fail <= hi + 1 for lo, hi, _ in spikes)
            if in_spike:
                return "chaos-queue-surge", {
                    "fail_tick": t_fail, "spikes": spikes}
            return "emergency", {"fail_tick": t_fail}

        run, gid = self._dominance_run()
        if run >= self.dominance_run:
            return "elephant-skew", {"dominant_queue": gid, "run": run}
        # a flash crowd is a TRANSIENT: the elevated region rises and
        # falls within ~one window (a diurnal ramp or a multi-phase file
        # load also trips the trailing-median test, but stays elevated)
        transient = [s for s in spikes if s[1] - s[0] <= self.window + 2]
        if transient:
            return "flash-crowd", {"spikes": transient}

        shape = self._load_shape()
        if shape is not None:
            return "diurnal", shape
        levels = self._load_levels()
        if len(levels) >= 3:
            return "file-replay", {"levels": levels}
        return "steady", {}

    def _load_shape(self) -> dict | None:
        """Rise-and-fall (diurnal) shape: peak in the middle, both ends
        well below it."""
        ticks = sorted(self.load)
        if len(ticks) < 3 * self.window:
            return None
        loads = [self.load[t] for t in ticks]
        n = len(loads)
        q = max(1, n // 4)
        head, tail = statistics.mean(loads[:q]), statistics.mean(loads[-q:])
        peak = max(loads)
        peak_at = loads.index(peak) / n
        if (head <= 0.6 * peak and tail <= 0.6 * peak
                and 0.2 <= peak_at <= 0.85):
            return {"peak": peak, "head": head, "tail": tail,
                    "peak_at": round(peak_at, 2)}
        return None

    def _load_levels(self) -> list[int]:
        """Distinct sustained load plateaus (log2-bucketed)."""
        counts: dict[int, int] = {}
        for v in self.load.values():
            if v >= 8:
                b = int(np.log2(v))
                counts[b] = counts.get(b, 0) + 1
        return sorted(b for b, c in counts.items() if c >= 2)

    # -- outputs -------------------------------------------------------------

    def detect_tick(self) -> int | None:
        """First tick of the stable suffix of the rolling classification
        (== the final regime); None when nothing was observed."""
        if self._seen_tick is None:
            return None
        final = self._classify()[0]
        tick = self._seen_tick
        for t, regime in reversed(self.timeline):
            if regime != final:
                break
            tick = t
        return tick

    def proposals(self) -> list:
        """Typed command epochs the detector would submit — NEVER applied
        here; the caller stages them (``_validate_command``) or shows an
        operator."""
        out = []
        regime = self.classify()["regime"]
        run, gid = self._dominance_run()
        if regime == "elephant-skew" and gid is not None:
            out.append(ProgramReta(tuple(
                self._rebalanced_reta(gid).tolist())))
        silent = sorted({q for f in self.findings
                         if f.detector == "queue_silence"
                         for q in f.detail["queues"]})
        if silent:
            out.append(FailQueues(tuple(silent)))
        # model-quality regimes: a shifted slot mix or a sustained drop
        # surge (routing skew already handled above) means the resident
        # model no longer matches the traffic — propose a retrain of the
        # dominant slot plus the SwapSlot that would carry it.  The
        # SwapSlot is a *spec* (params=None, the trace-format convention):
        # the deploy plane materializes freshly trained weights before it
        # can stage (`phases.materialize_command` in tests).
        slot = self._dominant_slot()
        if slot is not None:
            shifts = [f for f in self.findings
                      if f.detector == "slot_mix_shift"]
            surges = [f for f in self.findings if f.detector == "drop_surge"]
            if shifts:
                out.append(SwapSlot(slot, None))
                out.append(RetrainRequest(slot, "slot_mix_shift",
                                          shifts[-1].tick))
            elif surges and regime != "elephant-skew":
                out.append(SwapSlot(slot, None))
                out.append(RetrainRequest(slot, "drop_surge",
                                          surges[-1].tick))
        return out

    def _dominant_slot(self) -> int | None:
        """The slot carrying the most completions over the last window."""
        ticks = sorted(self.slot_mix)[-self.window:]
        if not ticks:
            return None
        mix = sum((self.slot_mix[t] for t in ticks),
                  np.zeros(self.num_slots, np.int64))
        return int(mix.argmax()) if mix.sum() else None

    def _rebalanced_reta(self, hot: int) -> np.ndarray:
        """Round-robin RETA with half the hot queue's buckets re-dealt to
        the other queues — the skew-relief rebalance."""
        reta = rss.indirection_table(self.num_queues, self.reta_size)
        others = [q for q in range(self.num_queues) if q != hot]
        if not others:
            return reta
        hot_buckets = np.flatnonzero(reta == hot)
        for i, b in enumerate(hot_buckets[::2]):
            reta[b] = others[i % len(others)]
        return reta
