"""One run of one cell: set-up, the timed window, the drain, the check.

``run_cell`` builds the cell's data plane from its configuration, generates
its weights on the device and its traffic on the host from ``seed``, warms
the shapes the traffic uses, then drives ``DataplaneRuntime.dispatch``,
``tick`` and ``control.submit`` for ``seconds``.  The ``on_retire`` tap only
stores arrays.  After the window it drains the rings, reads the peak memory,
frees the program's state and holds every served packet against the plain
reference.  Host spans (``bench.dispatch``, ``bench.tick``,
``bench.submit``) time each call into the program; with ``trace`` a
``torch.profiler`` sub-window of the timed window gives the device numbers.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from pathlib import Path

import numpy as np

from benchkit import layout as L
from benchkit import profiling
from benchkit.spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SUB_SHARE, SUB_MAX_S = 0.3, 3.0


class NoDevice(RuntimeError):
    """The card the cell asks for is not there."""


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package was loaded."""


class Overloaded(RuntimeError):
    """So many packets failed that the latency tail is not finite."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def make_weights(model: dict, num_slots: int, versions: int, seed: int, dev):
    """``versions`` parameter sets per slot, on ``dev``, from ``seed``, in a
    few large calls: leaves shaped (K, V, ...) as the bank stacks them."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % 2**63)
    h, w, c = int(model["hidden"]), int(model["d_bits"]) // 32, int(model["n_out"])
    kv = (num_slots, versions)
    init = model["init"]
    f32 = dict(generator=g, device=dev, dtype=torch.float32)
    return {
        "w1p": torch.randint(-2**31, 2**31, kv + (h, w), generator=g,
                             device=dev, dtype=torch.int32),
        "b1": torch.randn(kv + (h,), **f32) * float(init["b1_std"]),
        "w2": torch.randn(kv + (c, h), **f32)
        * float(init["w2_std_times_sqrt_hidden"]) / math.sqrt(h),
        "b2": torch.randn(kv + (c,), **f32) * float(init["b2_std"]),
    }


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


class _Columns:
    """Columns that grow in large chunks allocated apart from the program's
    heap.  The taps copy into them and keep none of the program's arrays:
    holding those arrays slowed the program's own allocations by a third
    over a 20 s window (retire rate 580 falling to 340 kpps against a flat
    ~600 without them, ``h32-k2-q1.boundary-sat`` on the H100)."""

    CHUNK = 1 << 20

    def __init__(self, *dtypes):
        self.dtypes = dtypes
        self.chunks: list = []
        self.fill = self.CHUNK
        self.n = 0

    def add(self, *cols):
        n, i = cols[0].shape[0], 0
        while i < n:
            if self.fill == self.CHUNK:
                self.chunks.append([np.empty(self.CHUNK, d) for d in self.dtypes])
                self.fill = 0
            k = min(n - i, self.CHUNK - self.fill)
            for buf, c in zip(self.chunks[-1], cols):
                buf[self.fill:self.fill + k] = c[i:i + k]
            self.fill += k
            i += k
        self.n += n

    def arrays(self):
        return [np.concatenate([ch[j] for ch in self.chunks] or
                               [np.zeros(0, d)])[:self.n]
                for j, d in enumerate(self.dtypes)]


class _Recorder:
    """The ``on_retire`` / ``on_drop`` taps: copies into columns, and one
    (count, tick, time) entry per call."""

    def __init__(self, clock):
        self.clock = clock
        self.served = _Columns(np.uint32, np.int32, np.bool_, np.int8)
        self.calls: list = []
        self.dropped = _Columns(np.uint32)

    def on_retire(self, queue, rows, slots, verdicts, actions, tick):
        self.served.add(rows[:, L.SEQ_WORD], slots, verdicts, actions)
        self.calls.append((rows.shape[0], tick, self.clock()))

    def on_drop(self, queue, rows):
        self.dropped.add(rows[:, L.SEQ_WORD])

    def arrays(self):
        ids, slots, verdicts, actions = self.served.arrays()
        n, ticks, t = (np.asarray([c[j] for c in self.calls], d)
                       for j, d in enumerate((np.int64, np.int64, np.float64)))
        return dict(ids=ids.astype(np.int64), slots=slots.astype(np.int64),
                    verdicts=verdicts, actions=actions.astype(np.int64),
                    ticks=np.repeat(ticks, n), t=np.repeat(t, n))

    def dropped_ids(self):
        return self.dropped.arrays()[0].astype(np.int64)


def _chain(first, then):
    if then is None:
        return first

    def both(*args):
        first(*args)
        then(*args)
    return both


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, overrides: dict | None = None, t_start=None,
             control: bool = False, log=None) -> dict:
    """Run one cell once: the data plane here, or the runner its
    configuration names (``Spec``).  Returns the result (the printed line's object,
    ``checks`` last: each compared number with its limit).  ``device=None``
    means the card and raises ``NoDevice`` without one; ``overrides``
    (``{"config": ..., "mix": ...}``) merges into the configuration and the
    mix: tests run tiny shapes on the CPU with it.  ``control=True`` also
    judges the control, the reference in a lower precision put in the
    program's place for the same served packets, by the same comparison:
    its verdict is the result's ``control`` (``correct`` and ``checks``)."""
    clock = time.perf_counter
    t_start = clock() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    root = Path(root)
    cell = Spec(root).cell(workload)
    if cell.runner is not None:
        return cell.runner.run_cell(root, workload, seed, seconds, trace,
                                    device=device, overrides=overrides,
                                    t_start=t_start, control=control, log=log)
    overrides = overrides or {}
    cfg = _merge(cell.config, overrides.get("config"))
    cell.mix = _merge(cell.mix, overrides.get("mix"))
    model, rcfg = cfg["model"], dict(cfg["runtime"])
    # the runtime block as the configuration gives it; the audit and the
    # recorder stay off where it does not name them
    rcfg.setdefault("audit", False)
    rcfg.setdefault("record", False)
    num_slots = int(cfg["bank"]["slots"])
    import torch

    sys.path.insert(0, str(root / "src"))
    from repro_torch.control import FailQueues, RestoreQueues, SwapSlot
    from repro_torch.control.policy import make_policy
    from repro_torch.dataplane.runtime import DataplaneRuntime

    if isinstance(rcfg.get("policy"), str):      # a routing policy by name
        rcfg["policy"] = make_policy(rcfg["policy"])

    traffic = cell.generator(cell.mix, num_slots=num_slots,
                             num_queues=int(rcfg["num_queues"]), seed=seed,
                             seconds=seconds)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoDevice(f"cell {workload} needs {cell.chips} CUDA device(s)")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    versions = int(cell.mix.get("swaps", {}).get("versions", 1))
    weights = make_weights(model, num_slots, versions, seed, dev)
    ref_weights = {k: v.cpu().clone() for k, v in weights.items()}
    bank = {k: v[:, 0].contiguous() for k, v in weights.items()}
    rt = DataplaneRuntime(bank, device=dev, **rcfg)
    for hook in cell.hooks:
        hook.attach(rt)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    n_ticks = 0

    def tick():
        nonlocal n_ticks
        n_ticks += 1
        return rt.tick()

    swap_count = [0] * num_slots
    swap_log = []            # (first tick served with it, slot, version)

    def commands(specs, *, warm=False):
        out = []
        for c in specs:
            if c["cmd"] == "fail_queues":
                out.append(FailQueues(tuple(c["queues"])))
            elif c["cmd"] == "restore_queues":
                out.append(RestoreQueues())
            else:
                s = int(c["slot"])
                v = 0 if warm else (swap_count[s] + 1) % versions
                if not warm:
                    swap_count[s] += 1
                    swap_log.append((n_ticks + 1, s, v))
                out.append(SwapSlot(s, {k: w[s, v] for k, w in weights.items()}))
        return out

    # -- warm-up: the cell's own shapes, then an empty data plane ----------
    b = traffic.burst
    full = traffic.pool[:rt.batch * rt.num_queues]
    for _ in range(2):
        rt.dispatch(full)
        while tick():
            pass
    kinds = {c["cmd"]: c for _, cs, _ in traffic.epochs for c in cs}
    for spec in kinds.values():
        rt.control.submit(*commands([spec], warm=True))
        for s0 in traffic.phase_starts:
            rt.dispatch(traffic.pool[s0:s0 + b])
            while tick():
                pass
    if "fail_queues" in kinds:
        rt.control.submit(RestoreQueues())
        while tick():
            pass
    rt.retire_all()
    sync()
    # a deployment setting of the configuration's: everything made so far
    # lives for the whole run, so it leaves the collector's sight and a full
    # collection in the window walks only what the window makes
    freeze = bool(cfg.get("host", {}).get("gc_freeze_after_setup", False))
    if freeze:
        gc.collect()
        gc.freeze()
    rec = _Recorder(clock)
    # the recorder's taps first, then any a hook put there (a sampler)
    rt.on_retire = _chain(rec.on_retire, rt.on_retire)
    rt.on_drop = _chain(rec.on_drop, rt.on_drop)
    ring0 = [r.counters.as_dict() for r in rt.rings]
    log0 = len(rt.control.log)

    # -- the window ---------------------------------------------------------
    # With ``trace``, a profiler covers the window's last stretch, started
    # there and stopped once the window has closed: its start-up ran in
    # set-up, and the host spans and rates come from the part before it.
    if trace:
        profiling.warm()
    prof = None
    sub, pre = {}, {}
    spans = {"dispatch": 0.0, "tick": 0.0, "submit": 0.0}
    served_w = emitted = ticks_w = 0
    lateness, backlog = [], {}
    swaps_open, swap_lat, swap_epochs = [], [], []
    sub_from = seconds - min(SUB_MAX_S, SUB_SHARE * seconds)

    def span(name):
        if prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(profiling.SPAN_PREFIX + name)

    def timed_tick():
        nonlocal served_w, ticks_w
        a = clock()
        with span("tick"):
            n = tick()
        c = clock()
        spans["tick"] += c - a
        served_w += n
        ticks_w += n > 0
        if n and swaps_open:
            swap_lat.extend((c - t) * 1e6 for t in swaps_open)
            swaps_open.clear()
        return n, c

    def maybe_profile(t_rel):
        nonlocal prof
        if trace and prof is None and not pre and t_rel >= sub_from:
            sync()
            pre.update(spans, window_s=clock() - t0, emitted=emitted,
                       served_window=served_w, ticks_window=ticks_w)
            prof = profiling.start()
            sub.update(t0=clock(), served0=served_w, ticks0=ticks_w)

    t_setup_end = t0 = clock()
    pending = 0
    if traffic.closed:
        while True:
            rows = traffic.emission(emitted)
            a = clock()
            with span("dispatch"):
                rt.dispatch(rows)
            spans["dispatch"] += clock() - a
            emitted += 1
            _, c = timed_tick()
            maybe_profile(c - t0)
            if c - t0 >= seconds:
                break
        window_s = c - t0
    else:
        ev = sorted([(float(e[0]), 0, i) for i, e in enumerate(traffic.epochs)]
                    + [(float(t), 1, k) for k, t in enumerate(traffic.due)])
        ev_t = [e[0] for e in ev]
        i = 0
        while True:
            t = clock() - t0
            while i < len(ev) and ev_t[i] <= t:
                _, kind, k = ev[i]
                i += 1
                if kind == 1:
                    rows = traffic.emission(k)
                    a = clock()
                    lateness.append(a - t0 - traffic.due[k])
                    with span("dispatch"):
                        out = rt.dispatch(rows)
                    spans["dispatch"] += clock() - a
                    emitted += 1
                    pending += b - out["dropped"]
                else:
                    _, specs, tag = traffic.epochs[k]
                    backlog.setdefault(tag, []).append(pending)
                    cmds = commands(specs)
                    a = clock()
                    with span("submit"):
                        epoch = rt.control.submit(*cmds)
                    spans["submit"] += clock() - a
                    if any(c["cmd"] == "swap_slot" for c in specs):
                        swaps_open.append(a)
                        swap_epochs.append(epoch)
            maybe_profile(t)
            if t >= seconds and i >= len(ev):
                break
            if pending > 0:
                n, _ = timed_tick()
                pending -= n
            elif i < len(ev):
                gap = t0 + ev_t[i] - clock()
                if gap > 6e-4:
                    time.sleep(gap - 4e-4)
        window_s = float(seconds)
    if prof is not None:
        sync()
        sub.update(t1=clock(), served1=served_w, ticks1=ticks_w)
        prof.stop()
        sub["prof"] = prof
    while pending > 0:           # the drain: packets due in the window
        n = tick()
        pending -= n
        if n and swaps_open:
            c = clock()
            swap_lat.extend((c - t) * 1e6 for t in swaps_open)
            swaps_open.clear()
    rt.retire_all()
    sync()

    # -- after the window: counters, memory, then the program's state goes --
    found = forbidden_modules()
    if found:
        raise ForbiddenImport("loaded after the window: " + ", ".join(found))
    ring1 = [r.counters.as_dict() for r in rt.rings]
    ring = {k: sum(r1[k] - r0[k] for r0, r1 in zip(ring0, ring1))
            for k in ("offered", "admitted", "dropped", "completed")}
    apply_us = {r.epoch: r.apply_us for r in rt.control.log[log0:]}
    epoch_apply_us = [apply_us[e] for e in swap_epochs if apply_us.get(e) is not None]
    mem_peak = (int(torch.cuda.max_memory_allocated(dev))
                if dev.type == "cuda" else 0)
    summary = None
    if trace:
        if "prof" not in sub:
            raise RuntimeError("the traced sub-window never opened")
        summary = profiling.summarize(sub["prof"])
        if summary["busy_s"] <= 0:
            raise RuntimeError("the profiler shows no device time in the "
                               "traced sub-window")
    rt.on_retire = rt.on_drop = None
    del rt, bank
    if freeze:
        gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    served = rec.arrays()
    dropped = rec.dropped_ids()
    total = emitted * b
    checks, ctl_checks, note = check_answers(
        cell.reference, traffic, served, dropped, total, ring, ref_weights,
        swap_log, num_slots=num_slots, dev=dev, control=control)
    for line in note:
        log(line)

    # What a reader (``metrics/<name>.py``, ``read(ctx)``) is given.
    # ``closed``: the loop's kind.  Host spans and rates, of the whole window
    # or, in a traced run, of the part before the profiler started:
    # ``window_s``; ``emitted`` and ``served_window`` (packets dispatched and
    # handed to the device by its ticks); ``retired_window`` (packets whose
    # verdict reached the host in it); ``ticks_window`` (ticks that served);
    # ``dispatch_s``,
    # ``tick_s``, ``submit_s`` (host seconds inside those calls).  Of the
    # whole run: ``served``, ``dropped``, ``latency_us`` (open loop, per
    # packet due in the window, inf if never served), ``swap_latency_us``,
    # ``epoch_apply_us``, ``setup_s``.  From the configuration: ``model``,
    # ``num_slots``.  ``sub`` (traced runs): ``profiling.summarize``'s
    # numbers with the sub-window's ``wall_s``, ``served`` and ``ticks``, and
    # ``served_rate_unprofiled``.
    host = pre or dict(spans, window_s=window_s, emitted=emitted,
                       served_window=served_w, ticks_window=ticks_w)
    ctx = dict(
        closed=traffic.closed,
        window_s=host["window_s"], setup_s=t_setup_end - t_start,
        emitted=host["emitted"] * b, served=len(served["ids"]),
        served_window=host["served_window"], ticks_window=host["ticks_window"],
        retired_window=int(np.count_nonzero(
            (served["t"] > t0) & (served["t"] <= t0 + host["window_s"]))),
        dropped=len(dropped), dispatch_s=host["dispatch"],
        tick_s=host["tick"], submit_s=host["submit"], model=model,
        num_slots=num_slots,
        swap_latency_us=np.asarray(swap_lat, np.float64),
        epoch_apply_us=np.asarray(epoch_apply_us, np.float64),
        latency_us=None, sub=None)
    if not traffic.closed and total:
        lat = np.full(total, np.inf)
        due = t0 + traffic.due[served["ids"] // b]
        lat[served["ids"]] = (served["t"] - due) * 1e6
        ctx["latency_us"] = lat
        q = np.quantile(lat, (0.5, 0.9, 0.99), method="higher")
        log(f"latency us: p50 {q[0]:.1f} p90 {q[1]:.1f} p99 {q[2]:.1f} "
            f"max {lat.max():.1f} over {lat.size} packets")
        late = np.asarray(lateness) * 1e6
        log(f"generator lateness us: p50 {np.percentile(late, 50):.1f} "
            f"p99 {np.percentile(late, 99):.1f} max {late.max():.1f} "
            f"over {late.size} bursts")
    for tag, depth in backlog.items():
        if tag != "swap":
            log(f"backlog at entry of {tag}: max {max(depth)} mean "
                f"{np.mean(depth):.1f} packets over {len(depth)} entries")
    if summary is not None:
        ctx["sub"] = dict(summary, wall_s=sub["t1"] - sub["t0"],
                          served=sub["served1"] - sub["served0"],
                          ticks=sub["ticks1"] - sub["ticks0"],
                          served_rate_unprofiled=host["served_window"]
                          / max(host["window_s"], 1e-9))
    if swap_lat:
        log(f"swap latency us (submit to the first tick served with the new "
            f"weights): p50 {np.percentile(swap_lat, 50):.1f} p95 "
            f"{np.quantile(swap_lat, 0.95, method='higher'):.1f} over "
            f"{len(swap_lat)} swaps")
    log(f"window {window_s:.3f} s: emitted {total} served {ctx['served']} "
        f"dropped {ctx['dropped']} ticks {ticks_w} swaps {len(swap_lat)}; "
        f"host s in dispatch {spans['dispatch']:.3f} tick {spans['tick']:.3f} "
        f"submit {spans['submit']:.4f}")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.reader.read(ctx)
        if v is None:
            continue
        if not math.isfinite(v):
            raise Overloaded(f"{m.name} is not finite ({ctx['dropped']} of "
                             f"{total} packets failed)")
        metrics[m.name] = {"value": float(v), "unit": m.unit}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else dev.type),
            "count": cell.chips, "memory_peak_bytes": mem_peak}
    result = {"correct": passes(checks),
              "attempted": total, "failed": int(total - ctx["served"]),
              "metrics": metrics, "device": info}
    if summary is not None:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = ctx["sub"]["wall_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in summary["device_ops"]],
                               "idle_gaps": [list(x) for x in summary["idle_gaps"]]}
    if ctl_checks is not None:
        result["control"] = {"correct": passes(ctl_checks), "checks": ctl_checks}
    result["checks"] = checks
    return result


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def version_at(swap_log, slots: np.ndarray, ticks: np.ndarray,
               num_slots: int) -> np.ndarray:
    """The weights version each packet's tick served it with: the last
    SwapSlot of its slot submitted before the tick's boundary (version 0
    before any)."""
    out = np.zeros(slots.shape[0], np.int64)
    for s in range(num_slots):
        log = [(t, v) for t, ss, v in swap_log if ss == s]
        if not log:
            continue
        mine = slots == s
        eff = np.asarray([t for t, _ in log], np.int64)
        ver = np.asarray([0] + [v for _, v in log], np.int64)
        out[mine] = ver[np.searchsorted(eff, ticks[mine], side="right")]
    return out


def check_answers(ref, traffic, served, dropped, total, ring, weights,
                  swap_log, *, num_slots: int, dev, control: bool):
    """Hold every served packet's slot, verdict and action against the plain
    reference under the weights its tick served it with, and the counts
    against conservation.  With ``control``, the control's verdicts, and the
    slots and actions the reference's rule gives with them, take the served
    ones' place in a second, identical comparison.  Returns
    ({name: {value, limit}}, the control's or None, log lines)."""
    import torch

    ids = served["ids"]
    checks, note = {}, []
    # conservation: each offered packet served once or counted dropped
    seen = np.zeros(total + 1, np.int64)
    np.add.at(seen, np.clip(ids, 0, total), 1)
    np.add.at(seen, np.clip(dropped, 0, total), 1)
    lost_or_twice = int(np.count_nonzero(seen[:total] != 1)) + int(seen[total])
    ring_bad = int(ring["offered"] != total) + int(ring["completed"] != len(ids)) \
        + int(ring["dropped"] != len(dropped))
    checks["conservation_errors"] = {"value": lost_or_twice + ring_bad, "limit": 0}
    if ids.size == 0 or (ids >= total).any() or (ids < 0).any():
        checks["wrong_answers"] = {"value": int(max(ids.size, 1)), "limit": 0}
        return checks, (dict(checks) if control else None), \
            ["no packet served, or ids out of range"]
    rows_idx = traffic.rows_of_ids(ids)
    head = traffic.pool[rows_idx, :3]       # the slot and control words
    ref_slot = np.clip(head[:, 0].view(np.int32).astype(np.int64), 0,
                       num_slots - 1)
    ver = version_at(swap_log, ref_slot, served["ticks"], num_slots)
    key = rows_idx * 64 + ver
    uniq, inv = np.unique(key, return_inverse=True)
    u_rows, u_ver = uniq // 64, uniq % 64
    pool_rows = traffic.pool[u_rows]
    u_slot = np.clip(pool_rows[:, 0].view(np.int32).astype(np.int64), 0,
                     num_slots - 1)
    y = np.zeros(uniq.size)
    y_ctl = np.zeros(uniq.size)
    margin = np.zeros(uniq.size)
    rows_t = torch.from_numpy(pool_rows.view(np.int32)).to(dev)
    w = {k: v.to(dev) for k, v in weights.items()}
    for s, v in sorted(set(zip(u_slot.tolist(), u_ver.tolist()))):
        sel = np.nonzero((u_slot == s) & (u_ver == v))[0]
        slot_w = {k: t[s, v] for k, t in w.items()}
        part = rows_t[torch.from_numpy(sel).to(dev)]
        ys, m = ref.scores(part, slot_w)
        y[sel], margin[sel] = ys.cpu().numpy(), m
        if control:
            yc, _ = ref.scores(part, slot_w, control=True)
            y_ctl[sel] = yc.cpu().numpy()
    y, margin = y[inv], margin[inv]
    decided = np.abs(y) > margin
    ref_verdict = y > 0
    rows_c = torch.from_numpy(head.view(np.int32))

    def acts(verdicts):
        return ref.actions_of(rows_c, torch.from_numpy(verdicts)).numpy()

    def wrong(slots, verdicts, actions):
        bad = slots != ref_slot
        bad |= decided & (verdicts != ref_verdict)
        bad |= actions != acts(verdicts)
        bad |= decided & (actions != acts(ref_verdict))
        return {"value": int(bad.sum()), "limit": 0}

    checks["wrong_answers"] = wrong(served["slots"], served["verdicts"],
                                    served["actions"])
    note.append(f"compared {ids.size} served packets ({uniq.size} distinct "
                f"row and weights pairs, {len(swap_log)} swaps); "
                f"{int((~decided).sum())} within the float32 margin, their "
                f"verdicts not compared")
    ctl_checks = None
    if control:
        ctl = y_ctl[inv] > 0
        ctl_checks = dict(checks, wrong_answers=wrong(ref_slot, ctl, acts(ctl)))
    return checks, ctl_checks, note
