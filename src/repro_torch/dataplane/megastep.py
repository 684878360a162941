"""Device-resident megastep: a window of N ticks served by one fused launch
(torch port of the reference's deferred mode).

The sequential runtime goes through Python for every tick: pad, copy,
dispatch, event wait and retire.  In deferred mode ``dispatch``/``tick``
only stage their work (and run the authoritative host ring simulation),
and ``flush`` replays the whole window on the device:

* ``device_rings`` (`repro_torch.dataplane.ring`) hold the multi-queue
  ring state on the device across flushes, full 272-word rows.
* One loop over the window's padded steps replays the ring traffic: each
  step pushes its arrival bursts, pops up to ``batch`` rows FIFO from
  every ring and compacts them queue-major into one ``(width, 272)``
  batch; the steps stack into a ``(T, width, 272)`` slab.
* The forwarding math for the whole window is then ONE launch of the
  port's fused kernel (`repro_torch.kernels.ops.packet_forward_fused`,
  gather mode, ``meta_words=16`` with actions) over the flattened slab:
  the sequential path's kernel, so verdicts equal the sequential ticks'
  by construction.
* Control epochs apply eagerly to the host mirrors (atomic apply,
  rollback and the epoch log keep their semantics) and are also
  serialized as ``DeviceDelta`` entries into a bounded epoch queue
  (`repro_torch.control.plane.serialize_device_delta`).  At flush the swap
  deltas' params are stacked behind the window's pinned bank as an
  *extended bank* (K + ``EPOCH_CAPACITY`` slots), and every row is grouped
  by the extended index ``es`` of the bank version live at its step, so a
  mid-window SwapSlot resolves per row with no weight written in place.
  The reported slot stays ``clamp(reg0 slot word, 0, K - 1)``.
* Counters accumulate on the device; with the ``(T, width)`` verdict,
  slot and action slabs they come back in ONE device-to-host copy per
  window, the window's only host synchronisation.  The drain then folds
  the counters in bulk (``Telemetry.record_window``) and makes one pass
  over the staged window for the taps and the trace recorder.

The host ``PacketRing`` mirror stays authoritative for counters,
timestamps, routing and policy views, so every host-visible return value
is exact without a device sync; the flush raises if the device rings'
pop counts diverge from the mirror's.

Contract (``tests/test_torch_megastep.py``): verdicts, slots, actions,
telemetry count totals and epoch apply ticks equal those of N sequential
``tick()`` calls.  Wall-clock attribution (``busy_s``, latency histograms,
epoch ``apply_latency_us``) is measured at flush granularity instead.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.control.plane import (DELTA_RETA, DELTA_SWAP,
                                       serialize_device_delta)
from repro_torch.core import bank as bank_lib, packet as pkt
from repro_torch.dataplane import ring as ring_lib
from repro_torch.dataplane.workloads.phases import SEQ_WORD
from repro_torch.kernels import ops

#: Bounded epoch queue depth per window.  The runtime flushes the window
#: before applying an epoch batch that would not fit, so the queue cannot
#: overflow mid-transaction.
EPOCH_CAPACITY = 8

#: Fixed device RETA mirror length (tables are padded or truncated).
DEVICE_RETA_SIZE = 128

#: Shape grains: burst capacity, compaction width and window length round
#: up to these, so phase-constant traffic reuses a handful of shapes (what a
#: captured CUDA graph of the window would need).
_BURST_GRAIN = 64
_WIDTH_GRAIN = 32
_TICK_GRAIN = 8

#: ``fused_forward.launches`` key suffix of the window's launches.
WINDOW_TAG = "/window"


def _round_up(n: int, g: int) -> int:
    return ((int(n) + g - 1) // g) * g


@dataclasses.dataclass
class _Staged:
    """One staged tick: the host mirror already popped its rows; the device
    replays the same push/pop/compute at flush."""
    tick: int                # runtime tick id (``_tick_count`` after bump)
    rows: np.ndarray         # (nb, words) arrival bursts since prior tick
    qids: np.ndarray         # (nb,) int32 queue id per burst row
    pops: list               # [(rows, ts)] per queue, host-mirror copies
    counts: list             # rows popped per queue


def _run_window(rings, bankx, xs, cur, *, capacity: int, width: int,
                num_slots: int, block_b: int, backend: str, audit: bool):
    """The window on the device: replay the staged ring traffic step by
    step, then serve every popped row with one fused launch over the
    extended bank ``bankx``.  Issues no host synchronisation.

    ``xs`` holds the staged steps: ``rows`` (T, bmax, words), ``qids``
    (T, bmax), ``count`` (T,) burst rows, ``bt`` (T,) pop budget (0 on
    padded steps); ``cur`` (T, K) maps each step's slot to its extended
    bank index.  Returns the rings and one int32 tensor: per-queue
    completed, served ticks, per-slot and per-slot-malicious counts,
    action counts, the audit's wrong verdicts, then the (T, width) slot,
    verdict and action slabs, flattened.
    """
    num_queues = rings["head"].shape[0]
    t_pad = xs["bt"].shape[0]
    k = num_slots
    popped, qqs, pvs, ns = [], [], [], []
    for t in range(t_pad):
        if xs["rows"].shape[1]:
            rings = ring_lib.device_push(rings, xs["rows"][t], xs["qids"][t],
                                         xs["count"][t], capacity=capacity)
        rings, rows_t, qq, pvalid, n = ring_lib.device_pop(
            rings, xs["bt"][t], width, capacity=capacity)
        popped.append(rows_t)
        qqs.append(qq)
        pvs.append(pvalid)
        ns.append(n)
    rows = torch.stack(popped).view(t_pad * width, -1)
    qq, pvalid, n = torch.cat(qqs), torch.cat(pvs), torch.stack(ns)
    slots = pkt.slot_of(rows, k).to(torch.int64)
    es = torch.gather(cur, 1, slots.view(t_pad, width)).view(-1)

    g = bank_lib.group_by_slot_padded(es, bankx["b1"].shape[0], block_b)
    scores_pad, actions_pad = ops.packet_forward_fused(
        bankx, rows, g.block_slots, g.row_ids, meta_words=pkt.META_WORDS,
        block_b=block_b, backend=backend, tag=WINDOW_TAG)
    res = g.result_rows.to(torch.int64)
    verd = scores_pad[res, 0] > 0.0
    acts = actions_pad[res].to(torch.int64)

    wrong = torch.zeros(1, dtype=torch.int64, device=rows.device)
    if audit:
        # the plain exact path against the same extended-bank entry
        exact = ops.bnn_forward_banked(bankx, pkt.payload_of(rows), es,
                                       backend="ref")
        wrong = (((exact[:, 0] > 0.0) != verd) & pvalid).sum().view(1)

    pv = pvalid.to(torch.int64)

    def per_queue(cols, idx, weight):
        # scatter_add_ (atomics): index_put_'s accumulate sorts its indices
        out = torch.zeros(num_queues * cols, dtype=torch.int64,
                          device=rows.device)
        return out.scatter_add_(0, qq * cols + idx, weight)

    out = torch.cat([
        n.sum(dim=0), (n > 0).sum(dim=0),
        per_queue(k, slots, pv), per_queue(k, slots, pv * verd),
        per_queue(3, acts, pv), wrong, slots, verd.to(torch.int64), acts,
    ]).to(torch.int32)
    return rings, out


class MegastepEngine:
    """Deferred-execution engine behind ``DataplaneRuntime``.

    ``dispatch()``/``tick()`` stage work (and run the authoritative host
    ring simulation); ``flush()`` replays the window on the device and
    drains the results to telemetry, taps and the trace recorder.  Flush
    triggers: the window reaching ``megastep_ticks`` staged ticks,
    ``retire_all()``, or an epoch batch that would overflow the bounded
    delta queue.
    """

    def __init__(self, runtime):
        rt = runtime
        self.rt = rt
        self.window = rt.megastep_ticks
        self.capacity = rt.rings[0].capacity
        self.words = rt.rings[0]._buf.shape[1]
        self.dev_rings = ring_lib.device_rings(
            rt.num_queues, self.capacity, packet_words=self.words,
            device=rt.device)
        self._reta_cache = None
        self.dev_reta = None
        self._sync_reta()
        self._steps: list[_Staged] = []
        self._pend_rows: list[np.ndarray] = []
        self._pend_qids: list[np.ndarray] = []
        self._deltas: list = []          # [(seq, DeviceDelta)]
        self._seq = 0
        self._window_bank = None         # bank version at window start
        self._window_pin = None          # pin on that buffer
        self._window_t0: float | None = None
        self._last_flush_s: float | None = None

    # -- staging (the runtime's dispatch/tick edge) --------------------------

    def stage_burst(self, rows: np.ndarray, qids: np.ndarray) -> None:
        """Record one routed arrival burst; the host rings already admitted
        it, and the device replays the identical admission."""
        if rows.shape[0] == 0:
            return
        self._open_window()
        self._pend_rows.append(np.array(rows, np.uint32))
        self._pend_qids.append(np.array(qids, np.int32))

    def stage_tick(self) -> int:
        """Stage one tick: pop the host mirror (authoritative counters,
        timestamps, FIFO order) and defer the device work.  A tick that
        moves no rows and carries no pending burst is never staged, so
        drain loops do not pad the window."""
        rt = self.rt
        popped = [ring.pop(rt.batch) for ring in rt.rings]
        counts = [rows.shape[0] for rows, _ in popped]
        total = sum(counts)
        if total == 0 and not self._pend_rows:
            return 0
        self._open_window()
        rows, qids = self._take_pending()
        self._steps.append(_Staged(tick=rt._tick_count, rows=rows,
                                   qids=qids, pops=popped, counts=counts))
        if len(self._steps) >= self.window:
            self.flush()
        return total

    def _take_pending(self) -> tuple[np.ndarray, np.ndarray]:
        if not self._pend_rows:
            return (np.zeros((0, self.words), np.uint32),
                    np.zeros(0, np.int32))
        if len(self._pend_rows) == 1:
            rows, qids = self._pend_rows[0], self._pend_qids[0]
        else:
            rows = np.concatenate(self._pend_rows)
            qids = np.concatenate(self._pend_qids)
        self._pend_rows, self._pend_qids = [], []
        return rows, qids

    def prepare_epochs(self, n_commands: int) -> None:
        """Make room in the bounded delta queue before an epoch batch
        applies, so a flush never lands mid-transaction."""
        if self._deltas and len(self._deltas) + n_commands > EPOCH_CAPACITY:
            self.flush()

    def stage_delta(self, cmd) -> None:
        """Serialize one just-applied command for the epoch queue (called
        from ``_apply_command`` inside the epoch transaction)."""
        d = serialize_device_delta(cmd, step=len(self._steps),
                                   runtime=self.rt,
                                   reta_size=DEVICE_RETA_SIZE)
        if d is None:
            return
        if self._window_bank is None:
            # empty window: the next window opens on the (already mutated)
            # host bank, so only the RETA mirror needs syncing
            if d.kind == DELTA_RETA:
                self._sync_reta()
            return
        self._seq += 1
        self._deltas.append((self._seq, d))

    def delta_mark(self) -> int:
        """Rollback cookie for ``_control_state`` snapshots."""
        return self._seq

    def delta_rollback(self, mark: int) -> None:
        """Drop deltas staged after ``mark``: a rolled-back epoch never
        reaches the device."""
        self._deltas = [(s, d) for s, d in self._deltas if s <= mark]

    def staged_rows(self) -> list[int]:
        """Popped-but-unflushed rows per queue (conservation in_flight)."""
        out = [0] * self.rt.num_queues
        for st in self._steps:
            for q, n in enumerate(st.counts):
                out[q] += n
        return out

    def _open_window(self) -> None:
        if self._window_bank is None:
            self._window_bank = self.rt.bank
            # pin the active buffer: a mid-window epoch flip makes it the
            # staging shadow, and staging un-aliases a pinned buffer instead
            # of writing it, so the window keeps its opening version
            self._window_pin = self.rt.bank_pin()
            self._window_t0 = time.perf_counter()

    def _sync_reta(self) -> None:
        """Refresh the device RETA mirror iff the host table changed
        (direct ``_install_reta`` callers bypass the deltas)."""
        table = np.asarray(self.rt.reta, np.int32)
        if self._reta_cache is not None and \
                np.array_equal(table, self._reta_cache):
            return
        self._reta_cache = table.copy()
        out = np.full(DEVICE_RETA_SIZE, -1, np.int32)
        n = min(DEVICE_RETA_SIZE, table.shape[0])
        out[:n] = table[:n]
        self.dev_reta = torch.from_numpy(out).to(self.rt.device)

    # -- flush ---------------------------------------------------------------

    def flush(self) -> None:
        """Run the staged window on the device and drain it host-side.

        Every host-to-device copy is issued before the window's device
        work, so the drain's copy back is the window's one wait."""
        rt = self.rt
        dev = rt.device
        steps, self._steps = self._steps, []
        deltas = [d for _, d in self._deltas]
        self._deltas = []
        trailing = self._upload_trailing()
        if not steps:
            # queued deltas only exist alongside staged steps; with the
            # window empty the host mirrors already carry every epoch
            self._push_trailing(trailing)
            self._close_window()
            return

        t_pad = min(_round_up(len(steps), _TICK_GRAIN), self.window)
        k = rt.num_slots
        bmax = max(st.rows.shape[0] for st in steps)
        bmax = _round_up(bmax, _BURST_GRAIN) if bmax else 0
        width = max(_WIDTH_GRAIN,
                    _round_up(max(sum(st.counts) for st in steps),
                              _WIDTH_GRAIN))

        # per-step extended-bank view: cur[s] is the extended index of
        # slot s's live params (base bank, or K + delta index after a
        # mid-window SwapSlot); padded steps repeat the last view
        cur = np.arange(k, dtype=np.int64)
        cur_by_step = np.empty((t_pad, k), np.int64)
        di = 0
        for t in range(len(steps)):
            while di < len(deltas) and deltas[di].step <= t:
                if deltas[di].kind == DELTA_SWAP:
                    cur[deltas[di].slot] = k + di
                di += 1
            cur_by_step[t] = cur
        cur_by_step[len(steps):] = cur
        has_eps = any(d.kind == DELTA_SWAP for d in deltas)

        # Each step's burst is copied straight into its slice of the device
        # tensor: no padded host copy.  The rest stays uninitialised: rows
        # at and beyond ``count`` go to the sink row.
        rows = torch.empty((t_pad, bmax, self.words), dtype=torch.int32,
                           device=dev)
        qids = np.zeros((t_pad, bmax), np.int32)
        count = np.zeros(t_pad, np.int64)
        bt = np.zeros(t_pad, np.int64)
        for t, st in enumerate(steps):
            nb = st.rows.shape[0]
            if nb:
                rows[t, :nb].copy_(torch.from_numpy(
                    np.ascontiguousarray(st.rows).view(np.int32)))
            qids[t, :nb] = st.qids
            count[t] = nb
            bt[t] = rt.batch
        xs = dict(rows=rows, qids=torch.from_numpy(qids).to(dev),
                  count=torch.from_numpy(count).to(dev),
                  bt=torch.from_numpy(bt).to(dev))
        cur_dev = torch.from_numpy(cur_by_step).to(dev)

        bankx = self._window_bank
        if has_eps:
            eps = {name: torch.zeros(
                       (max(EPOCH_CAPACITY, len(deltas)),) + leaf.shape[1:],
                       dtype=leaf.dtype, device=dev)
                   for name, leaf in bankx.items()}
            for e, dlt in enumerate(deltas):
                if dlt.kind == DELTA_SWAP:
                    params = bank_lib.slot_tensors(dlt.params, bankx)
                    for name, leaf in eps.items():
                        leaf[e].copy_(params[name])
            bankx = {name: torch.cat([leaf, eps[name]])
                     for name, leaf in bankx.items()}

        self.dev_rings, out = _run_window(
            self.dev_rings, bankx, xs, cur_dev, capacity=self.capacity,
            width=width, num_slots=k, block_b=rt.block_b,
            backend=rt.backend, audit=rt.audit)
        self._push_trailing(trailing)
        self._drain(steps, out, t_pad, width)
        self._close_window()

    def _close_window(self) -> None:
        self.rt.bank_unpin(self._window_pin)
        self._window_pin = None
        self._window_bank = None
        self._window_t0 = None
        self._sync_reta()

    def _upload_trailing(self):
        """Bursts staged after the window's last tick (a flush with no
        following ``tick()``, e.g. an audit right after a dispatch), padded
        to the burst grain and copied to the device; None if there are
        none."""
        if not self._pend_rows:
            return None
        rows, qids = self._take_pending()
        nb = rows.shape[0]
        pad = _round_up(nb, _BURST_GRAIN)
        prows = np.zeros((pad, rows.shape[1]), np.uint32)
        prows[:nb] = rows
        pqids = np.zeros(pad, np.int32)
        pqids[:nb] = qids
        dev = self.rt.device
        return (pkt.to_device(prows, dev), torch.from_numpy(pqids).to(dev),
                nb)

    def _push_trailing(self, trailing) -> None:
        if trailing is not None:
            rows, qids, nb = trailing
            self.dev_rings = ring_lib.device_push(
                self.dev_rings, rows, qids, nb, capacity=self.capacity)

    def _drain(self, steps, out: torch.Tensor, t_pad: int,
               width: int) -> None:
        """Once-per-window drain to the Python side: one copy back, bulk
        counter fold, ring completion, taps, trace recorder."""
        rt = self.rt
        nq, k = rt.num_queues, rt.num_slots
        host = out.cpu().numpy()  # the window's one device-to-host copy
        sizes = (nq, nq, nq * k, nq * k, nq * 3, 1) + (t_pad * width,) * 3
        parts = np.split(host, np.cumsum(sizes)[:-1])
        completed, served = parts[0], parts[1]
        per_slot = parts[2].reshape(nq, k)
        per_slot_mal = parts[3].reshape(nq, k)
        acts_ctr = parts[4].reshape(nq, 3)
        wrong = int(parts[5][0])
        slots, verd, acts = (p.reshape(t_pad, width) for p in parts[6:])
        verd = verd.astype(bool)

        hostc = np.zeros(nq, np.int64)
        for st in steps:
            hostc += np.asarray(st.counts, np.int64)
        if not np.array_equal(completed, hostc):
            raise RuntimeError(
                f"device ring divergence: device popped {completed.tolist()}"
                f" rows/queue, host mirror {hostc.tolist()}")
        now = time.perf_counter()
        start = (self._window_t0 if self._last_flush_s is None
                 else max(self._window_t0, self._last_flush_s))
        span = now - start
        self._last_flush_s = now
        total = int(completed.sum())
        for q in range(nq):
            if not completed[q]:
                continue
            lat = np.concatenate(
                [st.pops[q][1] for st in steps if st.counts[q]])
            rt.telemetry.record_window(
                q, ticks=int(served[q]), completed=int(completed[q]),
                per_slot_total=per_slot[q], per_slot_malicious=per_slot_mal[q],
                actions=acts_ctr[q], latency_us=(now - lat) * 1e6,
                busy_s=span * int(completed[q]) / total)
            rt.rings[q].mark_completed(int(completed[q]))
        if rt.audit:
            rt.telemetry.wrong_verdict += wrong
        if rt.on_retire is not None or rt._record:
            for t, st in enumerate(steps):
                off = 0
                for q, n in enumerate(st.counts):
                    if not n:
                        continue
                    sl = slice(off, off + n)
                    off += n
                    if rt.on_retire is not None:
                        rt.on_retire(q, st.pops[q][0], slots[t, sl],
                                     verd[t, sl], acts[t, sl], st.tick)
                    if rt._record:
                        rt.completed_seq[q].extend(
                            int(s) for s in st.pops[q][0][:, SEQ_WORD])
                        rt.completed_verdicts[q].extend(
                            bool(v) for v in verd[t, sl])
                        rt.completed_slots[q].extend(
                            int(s) for s in slots[t, sl])
        rt.telemetry.touch(now)
        if rt.telemetry.has_sink:
            rt.telemetry.emit_delta(tick=steps[-1].tick, now=now,
                                    depths=[len(r) for r in rt.rings])
