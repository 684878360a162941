"""The one traffic generator: a mix file of parameters -> packets and a schedule.

A mix (``traffic/<name>.json``) is data:

* ``loop``: ``closed`` (one burst is offered, then the data plane ticks once,
  as fast as it goes) or ``open`` (bursts are due on a fixed schedule, and the
  data plane ticks while it has a backlog);
* ``burst``: packets per emission;
* ``base_rate_pps`` (open loop): the rate R; each phase runs at ``rate`` x R;
* ``phases``: each with ``seconds`` (open loop; the storyline cycles),
  ``rate``, its flows (``flows`` drawn at random, or ``flows_per_queue``
  pinned to queues by the frozen RSS hash under the default RETA), its slot
  stream (``slots``), ``monitor_frac``, ``queue_share`` (``equal``: every
  burst gives every queue exactly its share), ``elephants`` (``flows`` heavy
  flows pinned to ``queue`` that carry ``share`` of the phase's packets, the
  storyline's elephant skew) and an entry ``epoch`` (a list of command
  specs, as ``phase_command_specs`` renders a storyline phase);
* ``pool_bursts`` (closed loop) or ``pool_rows`` (open loop, one phase): how
  many distinct rows are generated; the stream cycles over them, and every
  emission stamps fresh packet ids into ``SEQ_WORD``;
* ``swaps`` (open loop): ``per_second`` SwapSlot epochs rotating over the
  slots, each installing the next of ``versions`` parameter sets of its slot.

Packets follow the storyline's rule for flows and slot mixes: a phase owns a
set of flow tuples (reg0 words 4..7), each packet picks one at random (or,
with ``queue_share: equal``, one of its queue's), and its slot follows the
phase's slot stream.  Every packet's 1024 payload bytes are drawn from the
seed, so every pool row has a score of its own (the correctness check needs
scores near the decision boundary to see a lower precision).

A mix that needs new code names a module under ``traffic/`` as its
``generator``; that module's ``build`` takes the arguments of ``build`` here
and returns a ``Traffic``.

Everything is drawn from ``numpy.random.default_rng(seed)``: the same seed
gives the same packets and schedule.  The schedule and the amount of work do
not depend on the seed at all; only which flows, payloads and queue order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchkit import layout as L


@dataclasses.dataclass
class Traffic:
    pool: np.ndarray                 # (N, 272) uint32 rows, ids unstamped
    burst: int
    closed: bool
    # closed loop: emission e uses pool rows [(e % pool_bursts) * burst, ...)
    pool_bursts: int = 0
    # open loop: one entry per scheduled burst, in due order
    due: np.ndarray | None = None    # (n,) seconds after the window opens
    starts: np.ndarray | None = None  # (n,) first pool row of each burst
    # open loop: epochs, (due seconds, [command spec dicts], tag), in due
    # order; the tag is the phase whose entry it is, or "swap"
    epochs: list = dataclasses.field(default_factory=list)
    phase_starts: tuple = ()         # each phase's first pool row

    def start_of(self, e: int) -> int:
        """First pool row of emission ``e``."""
        if self.closed:
            return (e % self.pool_bursts) * self.burst
        return int(self.starts[e])

    def rows_of_ids(self, ids: np.ndarray) -> np.ndarray:
        """Pool row of each packet id (id = emission * burst + offset)."""
        ids = np.asarray(ids, np.int64)
        e, j = ids // self.burst, ids % self.burst
        if self.closed:
            return (e % self.pool_bursts) * self.burst + j
        return self.starts[e] + j

    def emission(self, e: int) -> np.ndarray:
        """Emission ``e``'s rows with their ids stamped (a view of the pool;
        the data plane copies what it admits)."""
        s = self.start_of(e)
        rows = self.pool[s:s + self.burst]
        rows[:, L.SEQ_WORD] = np.arange(e * self.burst, (e + 1) * self.burst,
                                        dtype=np.uint32)
        return rows


def _slot_stream(spec: dict, n: int, num_slots: int, rng) -> np.ndarray:
    kind = spec["kind"]
    if kind == "uniform":
        return rng.integers(0, num_slots, n)
    if kind == "peaked":  # the storyline's ``_peaked`` mix
        w = float(spec["weight"])
        p = np.full(num_slots, (1.0 - w) / max(num_slots - 1, 1))
        p[int(spec["slot"]) % num_slots] = w
        return rng.choice(num_slots, size=n, p=p / p.sum())
    if kind == "blocks":  # runs of ``block`` packets on each slot in turn
        order = np.asarray(spec["order"], np.int64) % num_slots
        return order[(np.arange(n) // int(spec["block"])) % len(order)]
    raise ValueError(f"unknown slot stream {kind!r}")


def pinned_flows(rng, counts, num_queues: int) -> tuple[np.ndarray, np.ndarray]:
    """Flow tuples rejection-sampled so that ``counts[q]`` of them hash to
    queue ``q`` under the default RETA.  Returns (flow words, queue of each)."""
    words, queues = [], []
    for q, c in enumerate(counts):
        got = np.empty((0, L.FLOW_WORDS), np.uint32)
        while got.shape[0] < c:
            cand = rng.integers(0, 2**32, (64 * num_queues, L.FLOW_WORDS),
                                dtype=np.uint32)
            got = np.concatenate(
                [got, cand[L.default_queue_of(cand, num_queues) == q]])
        words.append(got[:c])
        queues.append(np.full(c, q, np.int64))
    return np.concatenate(words), np.concatenate(queues)


def _phase_flows(ph: dict, num_queues: int, rng):
    if "flows_per_queue" in ph:
        per = ph["flows_per_queue"]
        counts = ([int(per)] * num_queues if np.isscalar(per)
                  else [int(c) for c in per])
        if len(counts) != num_queues:
            raise ValueError(f"phase {ph['name']!r}: flows_per_queue has "
                             f"{len(counts)} entries for {num_queues} queues")
        # which queue takes which count is the seed's choice; the counts
        # themselves, and so the load on the busiest queue, are fixed
        counts = [counts[i] for i in rng.permutation(num_queues)]
        return pinned_flows(rng, counts, num_queues)
    words = rng.integers(0, 2**32, (int(ph["flows"]), L.FLOW_WORDS),
                         dtype=np.uint32)
    return words, L.default_queue_of(words, num_queues)


def _phase_rows(ph: dict, n: int, burst: int, *, num_slots: int,
                num_queues: int, rng) -> np.ndarray:
    """``n`` rows of one phase, ``n`` a multiple of ``burst``."""
    flow_words, flow_queue = _phase_flows(ph, num_queues, rng)
    heavy = ph.get("elephants")
    if heavy:
        counts = [0] * num_queues
        counts[int(heavy["queue"]) % num_queues] = int(heavy["flows"])
        ew, eq = pinned_flows(rng, counts, num_queues)
        flow_words = np.concatenate([ew, flow_words])
        flow_queue = np.concatenate([eq, flow_queue])
    if heavy and ph.get("queue_share") == "equal":
        raise ValueError(f"phase {ph['name']!r}: elephants and an equal "
                         "queue share exclude each other")
    if heavy:
        ne = int(heavy["flows"])
        fidx = np.where(rng.random(n) < float(heavy["share"]),
                        rng.integers(0, ne, n),
                        ne + rng.integers(0, flow_words.shape[0] - ne, n))
    elif ph.get("queue_share") == "equal":
        if burst % num_queues:
            raise ValueError("queue_share equal needs burst % queues == 0")
        per = burst // num_queues
        fidx = np.empty(n, np.int64)
        for b in range(n // burst):
            parts = []
            for q in range(num_queues):
                mine = np.nonzero(flow_queue == q)[0]
                if mine.size == 0:
                    raise ValueError(f"phase {ph['name']!r}: queue {q} has no flow")
                parts.append(mine[rng.integers(0, mine.size, per)])
            fidx[b * burst:(b + 1) * burst] = rng.permutation(np.concatenate(parts))
    else:
        fidx = rng.integers(0, flow_words.shape[0], n)
    rows = np.zeros((n, L.PACKET_WORDS), np.uint32)
    rows[:, L.SLOT_WORD] = _slot_stream(ph["slots"], n, num_slots, rng)
    rows[:, L.VERSION_WORD] = L.FORMAT_VERSION
    rows[:, L.CONTROL_WORD] = np.where(
        rng.random(n) < float(ph.get("monitor_frac", 0.0)),
        L.CTRL_MONITOR_ONLY, 0).astype(np.uint32)
    rows[:, L.FLOW_WORD_LO:L.FLOW_WORD_LO + L.FLOW_WORDS] = flow_words[fidx]
    rows[:, L.META_WORDS:] = rng.integers(0, 2**32, (n, L.PAYLOAD_WORDS),
                                          dtype=np.uint32)
    return rows


def epoch_commands(specs, *, num_queues: int) -> list[dict]:
    """A phase's entry epoch as the storyline renders it: a failover that
    would leave no live queue becomes a plain restore."""
    out = []
    for c in specs:
        if c["cmd"] == "fail_queues":
            failed = sorted(q for q in c["queues"] if q < num_queues)
            if failed and set(failed) != set(range(num_queues)):
                out.append({"cmd": "fail_queues", "queues": failed})
            else:
                out.append({"cmd": "restore_queues"})
        elif c["cmd"] in ("restore_queues", "swap_slot"):
            out.append(dict(c))
        else:
            raise ValueError(f"unknown command spec {c!r}")
    return out


def build(mix: dict, *, num_slots: int, num_queues: int, seed: int,
          seconds: float) -> Traffic:
    """The cell's traffic for a window of ``seconds``."""
    rng = np.random.default_rng(int(seed))
    burst = int(mix["burst"])
    phases = mix["phases"]
    kw = dict(num_slots=num_slots, num_queues=num_queues, rng=rng)
    if mix["loop"] == "closed":
        if len(phases) != 1:
            raise ValueError("a closed-loop mix has one phase")
        nb = int(mix["pool_bursts"])
        pool = _phase_rows(phases[0], nb * burst, burst, **kw)
        return Traffic(pool=pool, burst=burst, closed=True, pool_bursts=nb,
                       phase_starts=(0,))
    if mix["loop"] != "open":
        raise ValueError(f"unknown loop {mix['loop']!r}")
    rate = float(mix["base_rate_pps"])
    if len(phases) == 1 and phases[0].get("seconds") is None:
        # one endless phase: bursts evenly spaced, the pool cycled
        n_pool = int(mix["pool_rows"]) // burst
        pool = _phase_rows(phases[0], n_pool * burst, burst, **kw)
        n = int(np.floor(seconds * rate * float(phases[0].get("rate", 1.0)) / burst))
        due = np.arange(n) * burst / (rate * float(phases[0].get("rate", 1.0)))
        starts = (np.arange(n) % n_pool) * burst
        epochs = []
        if phases[0].get("epoch"):
            epochs.append((0.0, epoch_commands(phases[0]["epoch"],
                                               num_queues=num_queues),
                           phases[0]["name"]))
        return Traffic(pool=pool, burst=burst, closed=False, due=due,
                       starts=starts, epochs=epochs, phase_starts=(0,))
    # a storyline: the phases in turn, cycled until the window closes; each
    # phase replays the same pool rows in every cycle
    per_phase = [int(round(float(p["seconds"]) * float(p["rate"]) * rate / burst))
                 for p in phases]
    pools, first = [], []
    for p, nb in zip(phases, per_phase):
        first.append(sum(x.shape[0] for x in pools))
        pools.append(_phase_rows(p, max(nb, 1) * burst, burst, **kw))
    pool = np.concatenate(pools)
    due, starts, epochs = [], [], []
    t = 0.0
    while t < seconds:
        for i, (p, nb) in enumerate(zip(phases, per_phase)):
            if t >= seconds:
                break
            if p.get("epoch"):
                epochs.append((t, epoch_commands(p["epoch"], num_queues=num_queues),
                               p["name"]))
            d = float(p["seconds"])
            for b in range(nb):
                tb = t + b * d / nb
                if tb >= seconds:
                    break
                due.append(tb)
                starts.append(first[i] + b * burst)
            t += d
    sw = mix.get("swaps")
    if sw:
        k = 0
        per = float(sw["per_second"])
        while (k + 0.5) / per < seconds:
            epochs.append(((k + 0.5) / per,
                           [{"cmd": "swap_slot", "slot": k % num_slots}], "swap"))
            k += 1
        epochs.sort(key=lambda e: e[0])
    return Traffic(pool=pool, burst=burst, closed=False,
                   due=np.asarray(due, np.float64),
                   starts=np.asarray(starts, np.int64),
                   epochs=epochs, phase_starts=tuple(first))
