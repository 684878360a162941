"""Telemetry-attached packet sampling: labeled reservoirs off the retire tap
(torch port; host NumPy over rows the runtime already copied back).

``PacketSampler`` hooks the runtime's ``on_retire`` / ``on_drop`` taps
(mesh: one hook per host shard) and harvests a bounded, uniformly-sampled
stream of labeled examples from live traffic — per-slot training
reservoirs (Algorithm R), a recent-window ring for canary bake-window
evaluation, and a drop reservoir for packets lost at the ring edge.  The
taps run on the host thread between device launches, so they do the bare
minimum inline: enqueue references to the already-copied retired batch
and return.  Subsampling to O(``per_tick``) rows, labeling, and
reservoir filing all happen in ``flush()`` — one vectorized pass over
the queued batches, run from the consumption APIs (``training_batch`` /
``window_since`` / ``stats`` / ``detach``) or when the queue hits its
``max_pending`` bound, never per tick (fig14 audits the
attached-vs-detached overhead at <= 5%).

Ground truth comes from a ``LabelOracle`` built over the workload's
labeled payload pool.  The trace renderer twists payload word 0 with a
per-packet nonce (``workloads.phases.render``), so oracle keys cover
payload words[1:] only; packets with payloads outside the pool (synthetic
regimes without a corpus) simply stay unlabeled and are counted, not
sampled.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.packet import META_WORDS
from repro_torch.data import packets as pk


def labeled_pool(samples_per_group: int = 512, seed: int = 0):
    """(pool_words (N,256) uint32, labels (N,) {0,1}) from the corpus."""
    xb, yb = pk.load_split("train", samples_per_group, seed)
    return pk.to_payload_words(xb), yb


class LabelOracle:
    """payload words -> ground-truth label for live traffic (-1 unknown).

    Rows are keyed by a vectorized 64-bit multiplicative hash over 32
    randomly chosen payload columns (word 0 excluded — it carries the
    renderer's nonce twist), resolved against a sorted key array with
    ``searchsorted``; a Python dict costs ~0.5 us/row just in the get
    loop — the whole fig14 overhead budget by itself.  A collision
    mislabeling a packet needs two payloads agreeing on 32 sampled words
    *and* a random-odd-multiplier checksum: ~N^2/2^64 for an N-row pool,
    negligible."""

    _HASH_SEED = 0x9E3779B97F4A7C15

    def __init__(self, pool_words: np.ndarray, labels: np.ndarray):
        pool = np.asarray(pool_words)
        rng = np.random.default_rng(self._HASH_SEED)
        k = min(32, pool.shape[1] - 1)
        self._cols = np.sort(rng.choice(np.arange(1, pool.shape[1]),
                                        size=k, replace=False))
        # odd multipliers: every sampled word stays information-bearing
        self._mult = rng.integers(0, 1 << 62, k, dtype=np.uint64) * 2 + 1
        keys = self._hash(pool)
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._vals = np.asarray(labels, np.int8)[order]

    @classmethod
    def from_corpus(cls, samples_per_group: int = 512, seed: int = 0):
        return cls(*labeled_pool(samples_per_group, seed))

    def __len__(self) -> int:
        return int(self._keys.size)

    def _hash(self, payload_words: np.ndarray) -> np.ndarray:
        sub = np.asarray(payload_words)[:, self._cols].astype(np.uint64)
        return (sub * self._mult).sum(axis=1, dtype=np.uint64)

    def lookup(self, payload_words: np.ndarray) -> np.ndarray:
        keys = self._hash(payload_words)
        if self._keys.size == 0:
            return np.full(keys.shape[0], -1, np.int8)
        pos = np.minimum(np.searchsorted(self._keys, keys),
                         self._keys.size - 1)
        return np.where(self._keys[pos] == keys, self._vals[pos],
                        np.int8(-1)).astype(np.int8)


class Reservoir:
    """Bounded uniform sample (Algorithm R) over an unbounded row stream."""

    def __init__(self, capacity: int, width: int,
                 rng: np.random.Generator | None = None):
        self.capacity = int(capacity)
        self.words = np.zeros((self.capacity, width), np.uint32)
        self.labels = np.full(self.capacity, -1, np.int8)
        self.verdicts = np.full(self.capacity, -1, np.int8)
        self.ticks = np.zeros(self.capacity, np.int64)
        self.count = 0
        self.seen = 0
        self._rng = rng if rng is not None else np.random.default_rng(0)

    def add(self, words, labels, verdicts, tick) -> None:
        """Batched Algorithm R: row i of the batch is stream position
        ``seen + i``; it replaces a uniformly drawn slot iff that draw
        lands under ``capacity`` (within-batch duplicate draws resolve
        newest-wins, which is itself a uniform choice).  ``tick`` may be
        a scalar or a per-row array."""
        n = int(words.shape[0])
        if n == 0:
            return
        start = self.seen
        self.seen += n
        vds = (np.full(n, -1, np.int8) if verdicts is None
               else np.asarray(verdicts))
        tks = np.broadcast_to(np.asarray(tick, np.int64), (n,))
        fill = min(self.capacity - self.count, n)
        if fill:
            dst = np.arange(self.count, self.count + fill)
            self._write(dst, words[:fill], labels[:fill], vds[:fill],
                        tks[:fill])
            self.count += fill
        if fill < n:
            src = np.arange(fill, n)
            j = self._rng.integers(0, start + src + 1)
            keep = j < self.capacity
            if keep.any():
                src = src[keep]
                self._write(j[keep], words[src], labels[src], vds[src],
                            tks[src])

    def _write(self, dst, words, labels, verdicts, ticks) -> None:
        self.words[dst] = words
        self.labels[dst] = labels
        self.verdicts[dst] = verdicts
        self.ticks[dst] = ticks

    def rows(self):
        """(words, labels, verdicts) of everything currently held."""
        n = self.count
        return self.words[:n], self.labels[:n], self.verdicts[:n]


class _Window:
    """Circular recent-sample ring keyed by tick (canary bake evaluation)."""

    def __init__(self, capacity: int, width: int):
        self.capacity = int(capacity)
        self.words = np.zeros((self.capacity, width), np.uint32)
        self.labels = np.full(self.capacity, -1, np.int8)
        self.verdicts = np.full(self.capacity, -1, np.int8)
        self.slots = np.zeros(self.capacity, np.int32)
        self.ticks = np.full(self.capacity, -1, np.int64)
        self._head = 0
        self.count = 0

    def add(self, words, labels, verdicts, slots, tick) -> None:
        n = words.shape[0]
        if n == 0:
            return
        tks = np.broadcast_to(np.asarray(tick, np.int64), (n,))
        if n > self.capacity:  # only the newest rows can survive anyway
            words, labels = words[-self.capacity:], labels[-self.capacity:]
            verdicts, slots = verdicts[-self.capacity:], slots[-self.capacity:]
            tks = tks[-self.capacity:]
            n = self.capacity
        idx = (self._head + np.arange(n)) % self.capacity
        self.words[idx] = words
        self.labels[idx] = labels
        self.verdicts[idx] = verdicts
        self.slots[idx] = slots
        self.ticks[idx] = tks
        self._head = (self._head + n) % self.capacity
        self.count = min(self.count + n, self.capacity)

    def since(self, tick: int):
        """(words, labels, verdicts, slots) sampled at tick >= ``tick``."""
        mask = self.ticks >= tick
        return (self.words[mask], self.labels[mask],
                self.verdicts[mask], self.slots[mask])


class PacketSampler:
    """Bounded labeled-example harvester attached to a running dataplane."""

    def __init__(self, oracle: LabelOracle | None = None, *,
                 num_slots: int, capacity: int = 1024,
                 window_capacity: int = 4096, per_tick: int = 32,
                 seed: int = 0, width: int = 256, max_pending: int = 256):
        self.oracle = oracle
        self.num_slots = int(num_slots)
        self.per_tick = int(per_tick)
        # bounded backlog of un-labeled batches (256 full 128-row batches
        # is ~36 MB held at peak; the arrays were already allocated by
        # the runtime — the queue only delays their release until flush,
        # and a consumer flush normally fires long before the bound does)
        self._pending: list = []        # (rows, slots, verdicts, tick)
        self._pending_drops: list = []  # payload words
        self._max_pending = int(max_pending)
        self._rng = np.random.default_rng(seed)
        self.reservoirs = [Reservoir(capacity, width, self._rng)
                           for _ in range(self.num_slots)]
        self.drop_reservoir = Reservoir(capacity, width, self._rng)
        self.window = _Window(window_capacity, width)
        self.seen = 0
        self.sampled = 0
        self.labeled = 0
        self.unknown = 0
        self.mispredicted = 0
        self.drops_seen = 0
        self.slot_mispredicts = np.zeros(self.num_slots, np.int64)
        self._attached: list = []

    # -- tap wiring ----------------------------------------------------------

    def attach(self, runtime) -> "PacketSampler":
        """Hook every shard's retire/drop taps; returns self."""
        shards = getattr(runtime, "shards", None) or [runtime]
        for host, sh in enumerate(shards):
            if sh.on_retire is not None or sh.on_drop is not None:
                raise RuntimeError(f"host {host} already has a sampler tap")
            sh.on_retire = self._make_retire(host)
            sh.on_drop = self._make_drop(host)
            self._attached.append(sh)
        return self

    def detach(self) -> None:
        for sh in self._attached:
            sh.on_retire = None
            sh.on_drop = None
        self._attached = []
        self.flush()

    def _make_retire(self, host: int):
        def tap(queue, rows, slots, verdicts, actions, tick):
            self._on_retire(rows, slots, verdicts, tick)
        return tap

    def _make_drop(self, host: int):
        def tap(queue, rows):
            self._on_drop(rows)
        return tap

    # -- ingestion (tick-path: enqueue references, nothing else) -------------
    #
    # The retire tap receives arrays the runtime just created and never
    # reuses (`ring.pop` copies out of the ring; slots/verdicts are fresh
    # device fetches), so the tap holds references and returns — no copy,
    # no RNG, no labeling.  The drop tap's rows are a view of the caller's
    # dispatch buffer, so it subsamples + copies before enqueueing.

    def _subsample(self, rows: np.ndarray) -> np.ndarray:
        """Indices of <= ``per_tick`` uniformly chosen rows.

        Without-replacement draw via argpartition over random keys: ~5 us
        for a 128-row batch, vs ~40 us for ``Generator.choice`` (which
        permutes the whole batch)."""
        n = rows.shape[0]
        if n <= self.per_tick:
            return np.arange(n)
        return np.argpartition(self._rng.random(n),
                               self.per_tick)[:self.per_tick]

    def _on_retire(self, rows, slots, verdicts, tick: int) -> None:
        n = rows.shape[0]
        self.seen += int(n)
        if n == 0:
            return
        if self.oracle is None:
            k = min(n, self.per_tick)
            self.sampled += k
            self.unknown += k
            return
        self._pending.append((rows, slots, verdicts, tick))
        if len(self._pending) >= self._max_pending:
            self.flush()

    def _on_drop(self, rows) -> None:
        n = rows.shape[0]
        self.drops_seen += int(n)
        if n == 0 or self.oracle is None:
            return
        idx = self._subsample(rows)
        self._pending_drops.append(rows[idx, META_WORDS:])
        if len(self._pending_drops) >= self._max_pending:
            self.flush()

    # -- deferred labeling (off the tick path, one vectorized pass) ----------

    def flush(self) -> None:
        """Subsample + label + file everything the taps enqueued."""
        if self._pending:
            batches, self._pending = self._pending, []
            rws, svs_l, vds_l, sizes, ticks = [], [], [], [], []
            for rows, slots, verdicts, tick in batches:
                if rows.shape[0] > self.per_tick:
                    idx = self._subsample(rows)
                    rows = rows[idx]
                    slots = np.asarray(slots)[idx]
                    verdicts = np.asarray(verdicts)[idx]
                rws.append(rows)
                svs_l.append(slots)
                vds_l.append(verdicts)
                sizes.append(rows.shape[0])
                ticks.append(tick)
            self.sampled += int(sum(sizes))
            words = np.concatenate(rws)[:, META_WORDS:]
            svs = np.concatenate(svs_l).astype(np.int32)
            vds = np.concatenate(vds_l).astype(np.int8)
            tks = np.repeat(np.asarray(ticks, np.int64), sizes)
            labels = self.oracle.lookup(words)
            known = labels >= 0
            nk = int(known.sum())
            self.labeled += nk
            self.unknown += int(labels.size - nk)
            mis = known & (vds != labels)
            self.mispredicted += int(mis.sum())
            np.add.at(self.slot_mispredicts, svs[mis] % self.num_slots, 1)
            if nk:
                kw, kl, kv = words[known], labels[known], vds[known]
                ks, kt = svs[known], tks[known]
                for s in np.unique(ks):
                    m = ks == s
                    self.reservoirs[int(s) % self.num_slots].add(
                        kw[m], kl[m], kv[m], kt[m])
                self.window.add(kw, kl, kv, ks, kt)
        if self._pending_drops:
            drops, self._pending_drops = self._pending_drops, []
            words = np.concatenate(drops)
            labels = self.oracle.lookup(words)
            known = labels >= 0
            if known.any():
                self.drop_reservoir.add(words[known], labels[known], None, 0)

    # -- consumption ---------------------------------------------------------

    def training_batch(self, slot: int | None = None,
                       include_drops: bool = True):
        """(payload_words, labels) pooled from the training reservoirs.

        ``slot=None`` pools every slot — labels are global (malicious or
        not), so any slot's traffic trains any slot model; dropped
        packets ride along as extra signal when ``include_drops``.
        """
        self.flush()
        parts = (self.reservoirs if slot is None
                 else [self.reservoirs[int(slot) % self.num_slots]])
        if include_drops:
            parts = list(parts) + [self.drop_reservoir]
        words = [r.words[:r.count] for r in parts if r.count]
        labels = [r.labels[:r.count] for r in parts if r.count]
        if not words:
            return (np.zeros((0, 256), np.uint32), np.zeros(0, np.int8))
        return np.concatenate(words), np.concatenate(labels)

    def window_since(self, tick: int):
        self.flush()
        return self.window.since(tick)

    def stats(self) -> dict:
        self.flush()
        return {
            "seen": self.seen, "sampled": self.sampled,
            "labeled": self.labeled, "unknown": self.unknown,
            "mispredicted": self.mispredicted,
            "drops_seen": self.drops_seen,
            "reservoir_rows": [r.count for r in self.reservoirs],
            "drop_rows": self.drop_reservoir.count,
            "window_rows": self.window.count,
        }
