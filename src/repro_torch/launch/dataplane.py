"""Multi-queue data-plane driver on the port: RSS -> rings -> fused workers.

The counterpart of the reference's ``repro.launch.dataplane``, with the
same flags, defaults, printed lines, ``--json`` document and exit status,
plus one flag of its own: ``--device`` (CUDA unless ``cpu`` is asked for;
without a card the run raises).

Runs a workload regime from the trace-driven engine (``--scenario``
names any regime in `repro_torch.dataplane.workloads.REGIME_NAMES`: the
emergency storyline, elephant skew, cascading failover, diurnal load,
flash-crowd surge, adversarial slot thrash, chaos regimes, recorded-file
replay) through the multi-queue runtime and reports per-phase
throughput, per-queue telemetry, the packet-conservation audit, and the
control-plane epoch log.  ``--hosts`` lifts the run to the multi-host
mesh data plane; ``--policy`` installs a closed-loop routing policy;
``--pipeline-depth`` overlaps dispatch/device/retire; ``--megastep-ticks``
serves each window of N ticks with one fused launch.

``--trace record PATH`` records the run (packet batches, typed command
timeline, per-phase invariants and the initial bank) as a versioned
compressed trace streamed to disk in chunks; ``--trace replay PATH``
replays a recorded trace bit-exactly (verdict-stream digest checked)
through a runtime rebuilt from the trace's own metadata.  Traces of
either package replay in the other.

``--observe PORT`` serves the dashboard and its JSON/SSE endpoints
(`repro_torch.obs.server`) while the run executes; ``--observe-linger
SECS`` keeps it up after the run; ``--epoch-log-json PATH`` writes the
machine-readable epoch log.  ``--auto-remediate`` acts on the anomaly
detector's proposals online and ``--deploy-demo promote|rollback``
scripts one fine-tune -> canary rollout (`repro_torch.deploy`) that must
reach the named decision.  ``--fault-plan FILE`` arms a typed fault plan;
``--lease-ticks`` and ``--quorum`` shape the mesh's degraded commits;
``--log-capacity``/``--log-spill`` bound the epoch log.  ``--slot-cache
N`` churns N models through an LRU cache over the resident slots, and
``--prefetch`` polls the telemetry-driven prefetcher.

Three draws differ from the reference's by design: the resident bank
(``initial_bank``), the slot cache's extra models (``extra_model``) and
the default swap delivery (``swap_delivery``) come from
``np.random.default_rng`` with the reference's seeds, where the reference
draws from ``jax.random``; so a default-seeded run serves other weights in
each package, and a cold ``--deploy-demo`` fine-tune starts from another
latent.

    python -m repro_torch.launch.dataplane --queues 4 --audit
    python -m repro_torch.launch.dataplane --device cpu --queues 4 --audit
    python -m repro_torch.launch.dataplane \\
        --hosts 2 --scenario crash-mid-commit --lease-ticks 4 --audit
    python -m repro_torch.launch.dataplane \\
        --scenario diurnal --trace record build/diurnal.bswt
    python -m repro_torch.launch.dataplane \\
        --trace replay build/diurnal.bswt --audit
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

from repro_torch.control import make_policy
from repro_torch.core import executor
from repro_torch.dataplane import (DataplaneRuntime, MeshDataplane, faults,
                                   workloads)
from repro_torch.device import resolve_device


def initial_bank(seed: int, slots: int, device):
    """The resident bank, drawn from ``np.random.default_rng(seed)``."""
    return executor.init_bank(np.random.default_rng(seed), slots, device=device)


def extra_model(seed: int, device) -> dict:
    """One slot-cache model beyond the bank, from ``default_rng(seed)``."""
    return executor.init_params(np.random.default_rng(seed), device=device)


#: the delivered weights of a scenario's ``SwapSlot`` specs
swap_delivery = workloads.default_swap_delivery


def _print_run_report(rt, reports, hosts: int, queues_per_host: int) -> dict:
    """Shared tail of both the play and replay paths: per-phase table,
    telemetry, conservation, epoch log.  Returns the snapshot."""
    print(f"{'phase':<16}{'offered':>9}{'done':>9}{'dropped':>9}"
          f"{'wrong':>7}{'kpps':>10}")
    for r in reports:
        kpps = r.get("kpps")
        print(f"{r['phase']:<16}{r['offered']:>9}{r['completed']:>9}"
              f"{r['dropped']:>9}{r['wrong_verdict']:>7}"
              + (f"{kpps:>10.1f}" if kpps is not None else f"{'-':>10}"))

    snap = rt.snapshot()
    for q in snap["queues"]:
        label = (f"host {q['queue'] // queues_per_host} "
                 f"queue {q['queue'] % queues_per_host}"
                 if hosts > 1 else f"queue {q['queue']}")
        print(f"{label}: completed={q['completed']} "
              f"pps_busy={q['pps_busy']:.0f} "
              f"lat p50/p99/max={q['latency_p50_us']:.0f}/"
              f"{q['latency_p99_us']:.0f}/{q['latency_max_us']:.0f}us "
              f"per_slot={q['per_slot_total']}")
    aud = snap["conservation"]
    print(f"conservation: offered={aud['totals']['offered']} = "
          f"completed={aud['totals']['completed']} + "
          f"dropped={aud['totals']['dropped']} "
          f"(+{aud['totals']['occupancy']} queued, "
          f"+{aud['totals']['in_flight']} in flight) "
          f"ok={aud['ok']} wrong_verdict={aud['wrong_verdict']}")
    if hosts > 1:
        for i, h in enumerate(aud["per_host"]):
            t = h["totals"]
            print(f"  host {i}: offered={t['offered']} "
                  f"completed={t['completed']} dropped={t['dropped']} "
                  f"ok={h['ok']}")

    deploy_log = getattr(rt, "deploy_log", None) or []
    for d in deploy_log:
        ep = d.get("epoch")
        slot = d.get("slot")
        print(f"deploy: tick {d['tick']:>4} {d['event']:<14}"
              + (f" slot={slot}" if slot is not None else "")
              + (f" epoch={ep}" if ep is not None else "")
              + (f" ({d['reason']})" if d.get("reason") else ""))
    snap["deployments"] = deploy_log

    log = rt.control.command_log()
    cont = rt.control.continuity_audit()
    modes = cont.get("commit_modes", {})
    mode_str = " ".join(f"{k}={v}" for k, v in modes.items() if v)
    print(f"control: api_v{rt.control.API_VERSION}, "
          f"{len(log)} epoch(s) in log, continuity ok={cont['ok']}"
          + (f" [{mode_str}]" if mode_str else ""))
    if cont.get("spilled_epochs"):
        print(f"  ({cont['spilled_epochs']} older epoch(s) spilled, "
              f"wrong_verdict_in_spill={cont['spilled_wrong_verdict']})")
    for rec in log:
        cmds = ", ".join(c["cmd"] for c in rec["commands"])
        barrier = (f" hosts@{rec['host_ticks']}"
                   if rec.get("host_ticks") else "")
        mode = rec.get("commit_mode")
        tag = f" <{mode}>" if mode and mode != "atomic" else ""
        at = rec["applied_tick"] if rec["applied_tick"] is not None else "-"
        head = f"  epoch {rec['epoch']:>3} @tick {at!s:<6} [{cmds}]"
        if rec.get("apply_us") is None:
            print(f"{head} ROLLED BACK{tag}: {rec.get('error')}")
        else:
            print(f"{head} apply={rec['apply_us']:.0f}us "
                  f"latency={rec['apply_latency_us']:.0f}us{barrier}{tag}")
    health = snap.get("health")
    if health and health.get("transitions"):
        states = " ".join(f"host{h['host']}={h['state']}"
                          for h in health["hosts"])
        print(f"health: lease={health['lease_ticks']} ticks, {states}")
        for t in health["transitions"]:
            print(f"  tick {t['tick']:>4}: host {t['host']} "
                  f"{t['frm']} -> {t['to']} ({t['reason']})")
    for ev in snap.get("fault_events") or ():
        print(f"fault: tick {ev['tick']} host {ev['host']} "
              f"@{ev['point']}: {ev['detail']}")
    stranded = snap["conservation"].get("stranded")
    if stranded and stranded["packets"]:
        print(f"stranded: {stranded['packets']} packet(s) on dead "
              f"host(s) {stranded['hosts']} (counted, not lost)")
    snap["control_log"] = log
    snap["continuity"] = cont
    return snap


def _make_detector(rt, args, *, num_slots: int):
    """Attach the delta stream + anomaly detector when ``--observe`` or
    ``--auto-remediate`` needs them; returns (stream, detector)."""
    if args.observe is None and not getattr(args, "auto_remediate", False):
        return None, None
    from repro_torch.obs import AnomalyDetector, TelemetryStream, attach
    stream = TelemetryStream()
    attach(rt, stream)
    det = AnomalyDetector(stream, num_queues=rt.num_queues,
                          num_slots=num_slots,
                          hosts=getattr(rt, "hosts", 1))
    return stream, det


def _start_observer(rt, args, *, num_slots: int, stream=None, detector=None):
    """``--observe PORT``: serve the dashboard over the attached stream."""
    if args.observe is None:
        return None
    from repro_torch.obs.server import ObsServer
    if stream is None:
        stream, detector = _make_detector(rt, args, num_slots=num_slots)
    srv = ObsServer(rt, stream, port=args.observe, detector=detector).start()
    print(f"observe: http://{srv.host}:{srv.port}/ "
          f"(/metrics /epochs /anomaly /stream /healthz)")
    return srv


def _finish_observer(srv, rt, args) -> None:
    """Write ``--epoch-log-json`` and wind down the observe server."""
    if args.epoch_log_json:
        from repro_torch.obs import spans
        from repro_torch.obs.server import _json_default
        with open(args.epoch_log_json, "w") as f:
            json.dump(spans.epoch_log_doc(rt), f, indent=2,
                      default=_json_default)
            f.write("\n")
        print(f"wrote {args.epoch_log_json}")
    if srv is not None:
        if args.observe_linger > 0:
            print(f"observe: lingering {args.observe_linger:.0f}s on "
                  f"port {srv.port}", flush=True)
            time.sleep(args.observe_linger)
        srv.stop()


def _replay_main(args, dev) -> None:
    """``--trace replay PATH``: runtime shape comes from the trace."""
    trace = workloads.load(args.trace[1])
    meta = trace.meta
    hosts = int(meta.get("hosts", 1))
    queues = int(meta.get("queues_per_host", args.queues))
    print(f"replaying {args.trace[1]}: trace v{meta['version']} "
          f"{meta.get('name')!r} ({meta.get('kind', 'recorded')}), "
          f"{trace.total_packets} packets, "
          f"{len(trace.command_timeline())} command epoch(s), "
          f"{hosts} host(s) x {queues} queue(s)")
    rt = workloads.make_runtime(trace, audit=args.audit, device=dev,
                                megastep_ticks=args.megastep_ticks)
    observer = _start_observer(rt, args,
                               num_slots=int(meta.get("num_slots") or 4))
    try:
        rep = workloads.replay(trace, rt, swap_delivery=swap_delivery)
        snap = _print_run_report(rt, rep["phases"], hosts, queues)
        dig = rep["digest"]
        print(f"replay: ok={rep['ok']} digest_ok={rep['digest_ok']}"
              + (f" sha256={dig['sha256'][:16]}..." if dig else ""))
        for m in rep["mismatches"]:
            print(f"  MISMATCH {m}")
        _finish_observer(observer, rt, args)
        observer = None
    finally:
        if observer is not None:  # the run raised: stop the server thread
            observer.stop()
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"replay": {k: rep[k] for k in
                                  ("ok", "mismatches", "phases", "totals",
                                   "digest", "digest_ok")},
                       "snapshot": snap}, f, indent=2, default=str)
            f.write("\n")
        print(f"wrote {args.json}")
    aud = snap["conservation"]
    if (not rep["ok"] or rep["digest_ok"] is False or not aud["ok"]
            or aud["wrong_verdict"] or not snap["continuity"]["ok"]):
        sys.exit(1)


class CacheChurnDriver:
    """Same-API facade (the ``DeployDriver`` precedent) that churns a
    ``SlotCache`` while traffic flows: every ``stride`` ticks it demands
    the next model of a rotating schedule wider than the resident bank,
    so the run exercises hits, misses, LRU evictions, and — with a
    prefetcher — flip-only prefetch promotions, all under the normal
    zero-wrong-verdict audit."""

    def __init__(self, inner, cache, schedule, *, stride: int = 4,
                 prefetcher=None):
        self._inner = inner
        self.cache = cache
        self.prefetcher = prefetcher
        self._schedule = list(schedule)
        self._stride = max(1, int(stride))
        self._ticks = 0
        self._i = 0

    def tick(self) -> int:
        n = self._inner.tick()
        self._ticks += 1
        if self._schedule and self._ticks % self._stride == 0:
            self.cache.ensure(self._schedule[self._i % len(self._schedule)])
            self._i += 1
            if self.prefetcher is not None:
                self.prefetcher.poll()
        return n

    def dispatch(self, packets_np, now=None, **kw):
        return self._inner.dispatch(packets_np, now=now, **kw)

    def drain(self, max_ticks: int = 100_000) -> int:
        return self._inner.drain(max_ticks)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _make_slot_cache(rt, args, bank, dev):
    """``--slot-cache N``: register N models (the bank's own slots first,
    then fresh inits) and return (cache, churn schedule, prefetcher)."""
    from repro_torch.control import SlotCache, SlotMixPrefetcher
    from repro_torch.core import bank as bank_lib
    n = args.slot_cache
    k = rt.num_slots
    names = [f"model{i:02d}" for i in range(n)]
    cache = SlotCache(rt, resident=names[:k])
    for i, name in enumerate(names):
        if i < k:
            cache.register(name, bank_lib.select_slot(bank, i))
        else:
            cache.register(name, extra_model(args.seed + 1000 + i, dev))
    prefetcher = SlotMixPrefetcher(cache) if args.prefetch else None
    return cache, names, prefetcher


def build_parser() -> argparse.ArgumentParser:
    """The launcher's argparse parser: the reference's flag set (documented
    in docs/cli.md) plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hosts", type=int, default=1,
                    help="mesh host shards (1 = single-host runtime)")
    ap.add_argument("--queues", type=int, default=4,
                    help="hardware queues per host")
    ap.add_argument("--slots", type=int, default=4,
                    help="resident bank size (models preloaded)")
    ap.add_argument("--strategy", default="fused",
                    choices=["fused", "grouped", "grouped_staged", "take",
                             "onehot"])
    ap.add_argument("--fanout", default="auto",
                    choices=["auto", "loop", "vmap", "shard_map"])
    ap.add_argument("--batch", type=int, default=128,
                    help="max rows drained per queue per tick")
    ap.add_argument("--ring-capacity", type=int, default=1024)
    ap.add_argument("--scenario", default="emergency",
                    choices=list(workloads.REGIME_NAMES),
                    help="workload regime from the generator library")
    ap.add_argument("--policy", default=None,
                    choices=["static", "least-depth", "drop-rate"],
                    help="closed-loop routing policy (default: none)")
    ap.add_argument("--megastep-ticks", type=int, default=1,
                    help="serve N ticks as one window with one fused "
                         "launch (deferred megastep mode); 1 = the "
                         "sequential per-tick loop.  Verdicts and "
                         "telemetry totals are equal at any N")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="bounded in-flight tick window (1 = synchronous)")
    ap.add_argument("--scale", type=int, default=1,
                    help="burst-size multiplier for every phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--audit", action="store_true",
                    help="re-score every tick through the exact take path "
                         "and count wrong verdicts")
    ap.add_argument("--trace", nargs=2, metavar=("MODE", "PATH"),
                    default=None,
                    help="'record PATH' saves this run as a replayable "
                         "trace; 'replay PATH' replays a recorded trace "
                         "(runtime shape from the trace itself)")
    ap.add_argument("--fault-plan", metavar="FILE", default=None,
                    help="JSON fault plan to arm (overrides the "
                         "regime's built-in plan)")
    ap.add_argument("--lease-ticks", type=int, default=8,
                    help="mesh host-health lease: max ticks a straggler "
                         "may defer the barrier before degraded commit")
    ap.add_argument("--quorum", type=int, default=None,
                    help="hosts that must ack a commit "
                         "(default: majority)")
    ap.add_argument("--log-capacity", type=int, default=None,
                    help="bound the in-memory epoch log; evicted "
                         "records spill in trace-style chunks")
    ap.add_argument("--log-spill", metavar="PATH", default=None,
                    help="file to receive spilled epoch records")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the full report as JSON")
    ap.add_argument("--observe", type=int, metavar="PORT", default=None,
                    help="serve the live dashboard/API on this port "
                         "(0 = ephemeral) while the run executes")
    ap.add_argument("--observe-linger", type=float, metavar="SECS",
                    default=0.0,
                    help="keep the observe server up this long after "
                         "the run finishes")
    ap.add_argument("--epoch-log-json", metavar="PATH", default=None,
                    help="write the machine-readable epoch log (same "
                         "serializer as the /epochs endpoint)")
    ap.add_argument("--auto-remediate", action="store_true",
                    help="act on anomaly-detector proposals online: "
                         "ProgramReta/FailQueues epochs directly, retrain "
                         "triggers via fine-tune -> canary rollout")
    ap.add_argument("--deploy-demo", default=None,
                    choices=["promote", "rollback"],
                    help="script one end-to-end rollout: fine-tune on "
                         "sampled traffic, canary it, and require the "
                         "named terminal decision ('rollback' corrupts "
                         "the weights to force the auto-rollback path)")
    ap.add_argument("--deploy-bake-ticks", type=int, default=12,
                    help="canary bake window before promote/rollback")
    ap.add_argument("--deploy-warmup-ticks", type=int, default=16,
                    help="ticks of sampling before a scripted rollout "
                         "fine-tunes (--deploy-demo)")
    ap.add_argument("--deploy-steps", type=int, default=32,
                    help="SGD steps per online fine-tune")
    ap.add_argument("--deploy-share", type=float, default=0.125,
                    help="RETA bucket share steered at the canary queue")
    ap.add_argument("--checkpoint-dir", metavar="DIR", default=None,
                    help="where online fine-tunes commit checkpoints "
                         "(default: a fresh temp dir)")
    ap.add_argument("--slot-cache", type=int, metavar="N", default=None,
                    help="register N models behind the LRU slot-cache "
                         "and churn residency during the run; N may "
                         "exceed --slots")
    ap.add_argument("--prefetch", action="store_true",
                    help="poll the telemetry-driven prefetcher during "
                         "slot-cache churn so predicted misses commit "
                         "flip-only (needs --slot-cache)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when "
                         "asked for)")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.hosts < 1:
        ap.error("--hosts must be >= 1")
    if args.trace and args.trace[0] not in ("record", "replay"):
        ap.error("--trace MODE must be 'record' or 'replay'")
    if args.prefetch and not args.slot_cache:
        ap.error("--prefetch needs --slot-cache N")
    if args.slot_cache is not None and args.slot_cache < 1:
        ap.error("--slot-cache must be >= 1")
    dev = resolve_device(args.device)

    if args.trace and args.trace[0] == "replay":
        _replay_main(args, dev)
        return

    deploy_active = bool(args.auto_remediate or args.deploy_demo)
    if deploy_active and args.slots < 2:
        ap.error("--auto-remediate/--deploy-demo need --slots >= 2 "
                 "(a canary slot)")

    total_queues = args.hosts * args.queues
    print(f"== resident bank: {args.slots} slots (random init) ==")
    bank = initial_bank(args.seed, args.slots, dev)
    workload = workloads.make_workload(
        args.scenario, num_slots=args.slots, num_queues=args.queues,
        scale=args.scale, hosts=args.hosts)
    pool, pool_labels = workload.payload_pool, None
    if deploy_active and pool is None:
        # synthetic regimes render random payloads with no ground truth;
        # deployment needs labeled traffic, so render from the corpus
        # pool instead (the oracle keys on payload words[1:])
        from repro_torch.deploy import labeled_pool
        pool, pool_labels = labeled_pool(samples_per_group=512,
                                         seed=args.seed)
        print(f"deploy: labeled payload pool ({pool.shape[0]} examples, "
              f"{int(pool_labels.sum())} malicious)")
    trace = workloads.render(
        list(workload.phases), num_slots=args.slots, seed=args.seed,
        num_queues=total_queues, payload_pool=pool)
    chaos_epochs = sum(len(p.chaos) for p in workload.phases)
    print(f"scenario: {args.scenario}, {len(workload.phases)} phases, "
          f"{trace.total_packets} packets, {chaos_epochs} chaos event(s), "
          f"seed={args.seed} (replayable)")

    plan = (faults.load_plan(args.fault_plan) if args.fault_plan
            else workload.fault_plan)
    injector = faults.FaultInjector(plan) if plan is not None else None
    if injector is not None and injector.armed:
        kinds = ", ".join(sorted({type(f).__name__ for f in plan.faults}))
        print(f"fault plan: {plan.name!r}, {len(plan.faults)} fault(s) "
              f"armed ({kinds}), lease={args.lease_ticks} ticks")

    policy = make_policy(args.policy) if args.policy else None
    recording = bool(args.trace)
    kw = dict(strategy=args.strategy, fanout=args.fanout, batch=args.batch,
              ring_capacity=args.ring_capacity, audit=args.audit,
              pipeline_depth=args.pipeline_depth,
              megastep_ticks=args.megastep_ticks, policy=policy,
              record=recording, fault_injector=injector,
              log_capacity=args.log_capacity, log_spill=args.log_spill,
              device=dev)
    if args.hosts > 1:
        rt = MeshDataplane(bank, hosts=args.hosts, num_queues=args.queues,
                           lease_ticks=args.lease_ticks, quorum=args.quorum,
                           **kw)
        shape = (f"{args.hosts} hosts x {args.queues} queues "
                 f"({total_queues} global)")
    else:
        rt = DataplaneRuntime(bank, num_queues=args.queues, **kw)
        shape = f"{args.queues} queues"
    print(f"runtime: {shape} x batch {args.batch}, "
          f"strategy={args.strategy}, "
          f"ring={args.ring_capacity}, depth={rt.pipeline_depth}, "
          f"policy={getattr(policy, 'name', None)}")

    stream, detector = _make_detector(rt, args, num_slots=args.slots)
    observer = _start_observer(rt, args, num_slots=args.slots,
                               stream=stream, detector=detector)
    try:
        driver = (workloads.record(rt, path=args.trace[1]) if recording
                  else rt)
        sampler = None
        if deploy_active:
            from repro_torch import deploy
            oracle = (deploy.LabelOracle(pool, pool_labels)
                      if pool_labels is not None else None)
            sampler = deploy.PacketSampler(oracle, num_slots=args.slots,
                                           seed=args.seed).attach(rt)
            ckpt_dir = args.checkpoint_dir or tempfile.mkdtemp(
                prefix="deploy-ckpt-")
            trainer = deploy.OnlineTrainer(checkpoint_dir=ckpt_dir,
                                           steps=args.deploy_steps,
                                           seed=args.seed, device=dev)
            canary_kw = dict(canary_share=args.deploy_share,
                             bake_ticks=args.deploy_bake_ticks)
            driver = deploy.DeployDriver(driver)
            if args.deploy_demo:
                driver.add(deploy.ScheduledRollout(
                    driver, sampler, trainer, target_slot=0,
                    warmup_ticks=args.deploy_warmup_ticks,
                    corrupt=args.deploy_demo == "rollback",
                    canary_kw=canary_kw))
            if args.auto_remediate:
                driver.add(deploy.AutoRemediator(
                    driver, detector, sampler=sampler, trainer=trainer,
                    canary_kw=canary_kw))
            mode = args.deploy_demo or "auto-remediate"
            print(f"deploy: {mode}, labeled oracle="
                  f"{'yes' if oracle is not None else 'no'}, "
                  f"bake={args.deploy_bake_ticks} ticks, "
                  f"share={args.deploy_share}, checkpoints -> {ckpt_dir}")
        cache = None
        if args.slot_cache:
            cache, schedule, prefetcher = _make_slot_cache(rt, args, bank, dev)
            if prefetcher is not None and stream is None:
                # no observe/remediate stream attached; give the prefetcher
                # its own delta tail so slot-mix evidence still flows
                from repro_torch.obs import TelemetryStream, attach
                stream = TelemetryStream()
                attach(rt, stream)
            if prefetcher is not None:
                prefetcher.stream = stream
            driver = CacheChurnDriver(driver, cache, schedule,
                                      prefetcher=prefetcher)
            print(f"slot-cache: {args.slot_cache} models over "
                  f"{rt.num_slots} slots, prefetch="
                  f"{'on' if prefetcher is not None else 'off'}")
        reports = workloads.play(driver, trace, swap_delivery=swap_delivery)
        if deploy_active:
            driver.flush_deploy()   # no canary may dangle past end of traffic
            sampler.detach()
        snap = _print_run_report(rt, reports, args.hosts, args.queues)
        if cache is not None:
            cs = cache.stats()
            hr = f"{cs['hit_rate']:.2f}" if cs["hit_rate"] is not None else "-"
            print(f"slot-cache: {cs['registered']} registered, "
                  f"{cs['resident']}/{cs['num_slots']} resident, "
                  f"hits={cs['hits']} misses={cs['misses']} hit_rate={hr} "
                  f"evictions={cs['evictions']} "
                  f"prefetch={cs['prefetch_hits']}/{cs['prefetch_issued']}")
            snap["slot_cache"] = cs

        if recording:
            saved = driver.finish(name=args.scenario, seed=args.seed)
            print(f"recorded trace: {saved.steps} steps, "
                  f"{saved.total_packets} packets, "
                  f"digest={'yes' if 'digest' in saved.expect else 'no'} "
                  f"-> {saved.path} ({saved.nbytes} bytes, streamed)")

        if args.json:
            with open(args.json, "w") as f:
                json.dump({"phases": reports, "snapshot": snap,
                           "control_log": snap["control_log"],
                           "continuity": snap["continuity"]}, f, indent=2)
                f.write("\n")
            print(f"wrote {args.json}")
        _finish_observer(observer, rt, args)
        observer = None
    finally:
        if observer is not None:  # the run raised: stop the server thread
            observer.stop()
    ok = True
    if args.deploy_demo:
        want = ("promoted" if args.deploy_demo == "promote"
                else "rolled_back")
        events = [d["event"] for d in snap.get("deployments", [])]
        if want not in events:
            print(f"deploy-demo FAILED: expected a {want!r} decision, "
                  f"got {events}")
            ok = False
    aud = snap["conservation"]
    if (not ok or not aud["ok"] or aud["wrong_verdict"]
            or not snap["continuity"]["ok"]):
        sys.exit(1)


if __name__ == "__main__":
    main()
