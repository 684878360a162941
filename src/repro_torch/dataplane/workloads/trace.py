"""Versioned, compressed workload traces: record any run, replay bit-exactly
(torch port).

A ``WorkloadTrace`` is an ordered **step stream** plus expectations:

* ``{"kind": "burst"}``     — one arrival burst (B, 272) uint32 packet rows;
* ``{"kind": "tick"}``      — one runtime tick (the dispatch/tick
  interleaving is part of the recording: ring backpressure, drops, and
  pipeline behavior depend on it, so replay preserves it exactly);
* ``{"kind": "commands"}``  — one atomic control epoch of typed commands
  (phase entries AND chaos events, in submission order relative to the
  packet steps around them);
* ``{"kind": "drain"}``     — drain-to-empty;
* ``{"kind": "phase"}``     — a phase boundary marker carrying the
  *expected per-phase invariants* (offered/completed/dropped/
  wrong_verdict) observed at record time, checked at replay time.

Trace-level ``expect`` adds end-of-run totals and a SHA-256 **digest**
over the completed per-queue (seq, verdict, slot) streams and the
dropped-seq stream: a replay that reproduces the digest reproduced every
verdict, in order, on the same queue.

The file format is the reference's, so traces move both ways between the
packages: ``MAGIC + version byte`` followed by (v2, current) a sequence of
independently compressed chunks — ``tag + u32 length + zlib(MessagePack
(payload))`` with step chunks (``S``) in stream order and one tail chunk
(``T``: meta + expect + bank) last — or (v1, still loadable) one
monolithic ``zlib(MessagePack(doc))`` blob.  MessagePack is the port's own
codec (`repro_torch.codec`).  Packet arrays are raw little-endian bytes;
the bank and every ``SwapSlot`` weight payload are stored as leaves in the
reference's flatten order, ``BANK_LEAVES`` (sorted keys), with ``w1p`` as
uint32; ``SetPolicy`` stores the policy's registry name.  Loading rejects
an unknown magic or version.

A *recorded* trace carries its initial bank and every swapped-in model,
so it replays to the same digest in either package.  A *synthesized*
trace (``synthesize``) carries neither: its ``SwapSlot`` specs are
materialized at replay by ``swap_delivery``, and ``make_runtime`` without
a ``bank`` draws one from ``np.random.default_rng(seed)``, while the
reference draws both from ``jax.random`` keys.  A synthesized trace
therefore replays to the same digest in both packages only when the
caller passes both the same bank and the same ``swap_delivery``.

``record()``/``TraceRecorder`` capture from a live runtime, single-host
or mesh, by wrapping it in a same-API facade; ``replay()`` feeds a trace
back through a runtime and verifies the invariants.  Policy rebalances and
the failover/restore epochs the mesh's health layer synthesizes are not
recorded: they regenerate from ``meta["policy"]``, ``meta["fault_plan"]``
and (on a mesh) ``meta["lease_ticks"]``/``meta["quorum"]``.  A trace of
more than one host rebuilds as a `repro_torch.dataplane.mesh.MeshDataplane`
(``make_runtime``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
import zlib

import numpy as np
import torch

from repro_torch import codec
from repro_torch.control import (FailQueues, ProgramReta, RestoreQueues,
                                 SetPolicy, SwapSlot, make_policy)
from repro_torch.control import policy as policy_mod
from repro_torch.core import bank as bank_lib
from repro_torch.core import executor
from repro_torch.core import packet as pkt
from repro_torch.dataplane import faults as faults_mod
from repro_torch.dataplane.workloads.phases import (ScenarioTrace, chaos_by_tick,
                                                    default_swap_delivery,
                                                    materialize_command,
                                                    phase_command_specs, render)
from repro_torch.device import resolve_device

MAGIC = b"BSWTRACE"
TRACE_VERSION = 2
#: zlib level for v2 chunks: level 1 is several times faster than level 6
#: at a modest size cost, the right trade for always-on recording
CHUNK_ZLIB_LEVEL = 1
#: flush a step chunk once its raw payload bytes reach this bound
CHUNK_BYTES = 1 << 20

#: per-phase / end-of-run counter keys compared between record and replay
#: (timing keys like elapsed_s/kpps are machine-dependent and never stored)
INVARIANT_KEYS = ("offered", "completed", "dropped", "wrong_verdict")

#: Bank leaves in the order the files hold them: the reference's
#: ``jax.tree_util`` flatten order of the bank dict, which sorts the keys.
BANK_LEAVES = ("b1", "b2", "w1p", "w2")


@dataclasses.dataclass(frozen=True)
class PackedLeaves:
    """Flattened ``SwapSlot`` weight payload as loaded from disk (numpy
    leaves in ``BANK_LEAVES`` order); replay turns it back into a slot."""
    leaves: tuple


@dataclasses.dataclass
class WorkloadTrace:
    """Versioned step stream + expectations (+ optionally the initial bank,
    so a saved trace replays standalone, bit-exactly)."""
    meta: dict
    steps: list[dict]
    expect: dict = dataclasses.field(default_factory=dict)
    bank_leaves: tuple | None = None

    @property
    def total_packets(self) -> int:
        return sum(s["rows"].shape[0] for s in self.steps
                   if s["kind"] == "burst")

    def command_timeline(self) -> list[tuple[int, tuple]]:
        """(step index, commands) for every epoch in the trace."""
        return [(i, s["commands"]) for i, s in enumerate(self.steps)
                if s["kind"] == "commands"]


# ---------------------------------------------------------------------------
# banks as host leaves
# ---------------------------------------------------------------------------

def _host_leaf(leaf) -> np.ndarray:
    """A private host copy of one leaf, packed words as uint32."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    arr = np.array(leaf, copy=True)
    return arr.view(np.uint32) if arr.dtype == np.int32 else arr


def _leaves_of(tree) -> tuple:
    """A bank or slot dict as host leaves in ``BANK_LEAVES`` order."""
    if set(tree) != set(BANK_LEAVES):
        raise ValueError(f"bank leaves {sorted(tree)} are not {list(BANK_LEAVES)}")
    return tuple(_host_leaf(tree[name]) for name in BANK_LEAVES)


def _tree_of(leaves, device) -> dict:
    """Host leaves in ``BANK_LEAVES`` order -> a bank or slot on ``device``."""
    return bank_lib.from_jax_bank(dict(zip(BANK_LEAVES, leaves)), device)


# ---------------------------------------------------------------------------
# runtime introspection helpers (single-host runtime and mesh facade)
# ---------------------------------------------------------------------------

def _template(rt):
    """The runtime itself, or a mesh's first shard (every shard has the
    same shape and bank)."""
    return rt.shards[0] if hasattr(rt, "shards") else rt


def _bank_of(rt):
    return _template(rt).bank


def _set_bank(rt, bank) -> None:
    """Install the recorded initial bank before replay starts (set-up, not
    a runtime mutation: no packets are in flight).  Every shard of a mesh
    copies it through ``adopt_bank``."""
    for t in (rt.shards if hasattr(rt, "shards") else [rt]):
        t.adopt_bank(bank)


def _records(rt) -> bool:
    return bool(_template(rt)._record)


def _policy_name(policy) -> str | None:
    """Registry name of an installed policy — or raise: a policy the
    registry cannot rebuild would make the trace silently unreplayable
    (its rebalance epochs regenerate from the replaying runtime's own
    policy loop, so the replay MUST install the same policy)."""
    if policy is None:
        return None
    name = getattr(policy, "name", None)
    if name is None or name not in policy_mod.POLICIES:
        raise ValueError(
            f"cannot record a run with non-registry policy {policy!r}; "
            "give it a `name` listed in repro_torch.control.policy.POLICIES")
    return name


def runtime_meta(rt) -> dict:
    """The runtime shape a trace was recorded against (what a replay must
    reconstruct for bit-exactness).  The policy and an armed fault plan
    are part of it: their epochs are not in the recorded command timeline
    but regenerate from the replaying runtime's own policy and injector."""
    t = _template(rt)
    injector = getattr(rt, "_faults", None)
    meta = {
        "hosts": getattr(rt, "hosts", 1),
        "queues_per_host": getattr(rt, "num_queues_per_host", rt.num_queues),
        "num_slots": t.num_slots,
        "strategy": t.strategy,
        "batch": t.batch,
        "ring_capacity": t.rings[0].capacity,
        "pipeline_depth": t.pipeline_depth,
        # a mesh holds its policy at facade scope
        "policy": _policy_name(getattr(rt, "policy", None)),
        "fault_plan": (injector.plan.to_dict()
                       if injector is not None else None),
    }
    if hasattr(rt, "lease_ticks"):
        # the lease and quorum drive the mesh's failure detection, whose
        # synthesized epochs regenerate at replay
        meta["lease_ticks"] = rt.lease_ticks
        meta["quorum"] = rt.quorum
    return meta


def digest(rt) -> dict:
    """SHA-256 over the completed per-queue (seq, verdict, slot) streams
    and the dropped-seq stream — requires a ``record=True`` runtime.  The
    bytes are those of numpy int64 / uint8 / int64 arrays per queue, each
    queue followed by ``b"|"``, then the sorted dropped seqs as int64, as
    in the reference."""
    h = hashlib.sha256()
    for q in range(len(rt.completed_seq)):
        h.update(np.asarray(rt.completed_seq[q], np.int64).tobytes())
        h.update(np.asarray(rt.completed_verdicts[q], np.uint8).tobytes())
        h.update(np.asarray(rt.completed_slots[q], np.int64).tobytes())
        h.update(b"|")
    h.update(np.asarray(sorted(rt.dropped_seq), np.int64).tobytes())
    return {"sha256": h.hexdigest(),
            "completed": int(sum(len(s) for s in rt.completed_seq)),
            "dropped": int(len(rt.dropped_seq))}


# ---------------------------------------------------------------------------
# synthesize: generator phases -> trace (no runtime involved)
# ---------------------------------------------------------------------------

def synthesize(
    phases,
    *,
    num_slots: int,
    num_queues: int,
    seed: int = 0,
    name: str = "synthesized",
    payload_pool: np.ndarray | None = None,
) -> WorkloadTrace:
    """Render phases into a step-stream trace without running a runtime.

    ``num_queues`` is the *global* queue count (hosts x per-host).  The
    command timeline uses command specs (``SwapSlot`` payloads stay
    ``None`` and are materialized at replay), phase markers carry the
    statically known invariants (offered count, zero wrong verdicts);
    completion/drop counts depend on the runtime's shape and are omitted.
    """
    rendered: ScenarioTrace = render(
        list(phases), num_slots=num_slots, seed=seed,
        payload_pool=payload_pool, num_queues=num_queues)
    steps: list[dict] = []
    for phase, phase_bursts in zip(rendered.phases, rendered.bursts):
        steps.append({"kind": "commands", "commands": tuple(
            phase_command_specs(phase, num_queues=num_queues))})
        chaos = chaos_by_tick(phase)
        offered = 0
        for t, burst in enumerate(phase_bursts):
            for ev in chaos.get(t, ()):
                steps.append({"kind": "commands",
                              "commands": tuple(ev.commands)})
            steps.append({"kind": "burst", "rows": burst})
            steps.append({"kind": "tick"})
            offered += int(burst.shape[0])
        steps.append({"kind": "drain"})
        steps.append({"kind": "phase", "name": phase.name,
                      "expect": {"offered": offered, "wrong_verdict": 0}})
    return WorkloadTrace(
        meta={"version": TRACE_VERSION, "name": name, "seed": seed,
              "num_slots": num_slots, "num_queues": num_queues,
              "kind": "synthesized"},
        steps=steps,
        expect={"totals": {"offered": rendered.total_packets,
                           "wrong_verdict": 0}},
    )


# ---------------------------------------------------------------------------
# record: wrap a live runtime in a same-API recording facade
# ---------------------------------------------------------------------------

class _RecordingControl:
    """``runtime.control`` proxy that logs every submitted epoch as a
    commands step at its position in the step stream."""

    def __init__(self, inner, recorder):
        self._inner = inner
        self._recorder = recorder

    def submit(self, *commands):
        self._recorder._log({"kind": "commands", "commands": tuple(commands)})
        return self._inner.submit(*commands)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@dataclasses.dataclass(frozen=True)
class StreamedTrace:
    """What a streaming recording leaves behind: the finished trace file
    plus the summary a buffered ``finish()`` would have computed.  Use
    ``load(path)`` to get the replayable ``WorkloadTrace`` back."""
    path: str
    nbytes: int
    steps: int
    total_packets: int
    meta: dict
    expect: dict


class TraceRecorder:
    """Same-API facade over a runtime (or mesh) that records the step
    stream flowing through it.  Drive it with ``play`` or any custom loop,
    then ``finish()`` the trace:

        rec = TraceRecorder(runtime)
        play(rec, rendered)
        trace = rec.finish(name="emergency")
        save(trace, "emergency.bswt")

    With ``path=...`` the recorder *streams*: each step is encoded as it
    happens and appended to the open file in compressed chunks, and
    ``finish()`` only writes the small tail chunk (meta/expect/bank) and
    returns a ``StreamedTrace`` summary; the file is byte-identical to
    ``save()`` of the equivalent buffered trace.

    The initial bank is copied to host memory at construction: the
    runtime's device buffers are written in place by later ``SwapSlot``
    staging.
    """

    def __init__(self, runtime, *, path: str | None = None,
                 chunk_bytes: int = CHUNK_BYTES):
        self._rt = runtime
        self.steps: list[dict] = []
        self._bank0 = _leaves_of(_bank_of(runtime))
        self._writer = (_ChunkWriter(path, chunk_bytes=chunk_bytes)
                        if path is not None else None)
        self._stream_packets = 0
        self.control = _RecordingControl(runtime.control, self)
        self._mark_totals = None
        self._mark_wrong = 0

    def _log(self, step: dict) -> None:
        if self._writer is not None:
            if step["kind"] == "burst":
                self._stream_packets += int(step["rows"].shape[0])
            self._writer.add_step(step)
        else:
            self.steps.append(step)

    # -- recorded data-plane surface ----------------------------------------

    def dispatch(self, packets_np, now=None, **kw):
        self._log({"kind": "burst",
                   "rows": np.array(packets_np, np.uint32, copy=True)})
        return self._rt.dispatch(packets_np, now=now, **kw)

    def tick(self):
        self._log({"kind": "tick"})
        return self._rt.tick()

    def drain(self, *args, **kw):
        self._log({"kind": "drain"})
        return self._rt.drain(*args, **kw)

    def mark_phase(self, name: str, report: dict | None = None) -> None:
        """Record a phase boundary with the invariants observed since the
        previous mark (``play`` calls this automatically)."""
        totals = self._rt.audit_conservation()["totals"]
        wrong = self._rt.telemetry.wrong_verdict
        if report is not None:
            expect = {k: int(report[k]) for k in INVARIANT_KEYS}
        else:
            prev = self._mark_totals or {k: 0 for k in totals}
            expect = {k: int(totals[k] - prev[k])
                      for k in ("offered", "completed", "dropped")}
            expect["wrong_verdict"] = int(wrong - self._mark_wrong)
        self._mark_totals = dict(totals)
        self._mark_wrong = wrong
        self._log({"kind": "phase", "name": name, "expect": expect})

    def __getattr__(self, name):
        return getattr(self._rt, name)

    # -- finalization --------------------------------------------------------

    def finish(self, *, name: str = "recorded", seed: int | None = None,
               include_bank: bool = True) -> "WorkloadTrace | StreamedTrace":
        self._rt.retire_all()
        totals = self._rt.audit_conservation()["totals"]
        expect = {"totals": {k: int(totals[k]) for k in
                             ("offered", "completed", "dropped")}}
        expect["totals"]["wrong_verdict"] = int(
            self._rt.telemetry.wrong_verdict)
        if _records(self._rt):
            expect["digest"] = digest(self._rt)
        meta = {"version": TRACE_VERSION, "name": name, "seed": seed,
                "kind": "recorded", **runtime_meta(self._rt)}
        meta["num_queues"] = meta["hosts"] * meta["queues_per_host"]
        bank = self._bank0 if include_bank else None
        if self._writer is not None:
            nbytes = self._writer.finish(meta=meta, expect=expect,
                                         bank_leaves=bank)
            return StreamedTrace(path=self._writer.path, nbytes=nbytes,
                                 steps=self._writer.steps,
                                 total_packets=self._stream_packets,
                                 meta=meta, expect=expect)
        return WorkloadTrace(meta=meta, steps=list(self.steps),
                             expect=expect, bank_leaves=bank)

    def abort(self) -> None:
        """Close a streaming recording without writing the tail chunk
        (the partial file will be rejected by ``load``)."""
        if self._writer is not None:
            self._writer.abort()


def record(runtime, *, path: str | None = None,
           chunk_bytes: int = CHUNK_BYTES) -> TraceRecorder:
    """Wrap ``runtime`` for recording: ``rec = record(rt); play(rec, trace);
    rec.finish()``.  Pass ``path=`` to stream the recording straight to
    disk."""
    return TraceRecorder(runtime, path=path, chunk_bytes=chunk_bytes)


# ---------------------------------------------------------------------------
# replay: trace -> runtime, invariants checked
# ---------------------------------------------------------------------------

def _replay_command(cmd, swap_delivery):
    if isinstance(cmd, SwapSlot) and isinstance(cmd.params, PackedLeaves):
        # CPU tensors: the runtime stages them onto its device
        return dataclasses.replace(cmd, params=_tree_of(cmd.params.leaves, "cpu"))
    if isinstance(cmd, SetPolicy) and isinstance(cmd.policy, str):
        return dataclasses.replace(cmd, policy=make_policy(cmd.policy))
    return materialize_command(cmd, swap_delivery)


def restore_bank(trace: WorkloadTrace, template_bank):
    """The trace's recorded initial bank on the device of
    ``template_bank`` (None when the trace carries no bank)."""
    if trace.bank_leaves is None:
        return None
    return _tree_of(trace.bank_leaves, next(iter(template_bank.values())).device)


def make_runtime(trace: WorkloadTrace, *, bank=None, audit: bool = False,
                 device=None, **overrides):
    """Build the runtime a trace expects: shape from ``trace.meta``, the
    recorded initial bank when the trace carries one (else ``bank``, else a
    bank drawn from ``np.random.default_rng(meta["seed"])``), the recorded
    policy and fault plan, and ``record=True`` so the digest is checkable.
    A trace of more than one host gives a
    `repro_torch.dataplane.mesh.MeshDataplane` with the recorded lease and
    quorum.  ``device=None`` means ``bank``'s device when a bank is given,
    else CUDA."""
    from repro_torch.dataplane.mesh import MeshDataplane
    from repro_torch.dataplane.runtime import DataplaneRuntime

    meta = trace.meta
    hosts = int(meta.get("hosts", 1))
    if device is None and bank is not None:
        dev = next(iter(bank.values())).device
    else:
        dev = resolve_device(device)
    if trace.bank_leaves is not None:
        bank = _tree_of(trace.bank_leaves, dev)
    elif bank is None:
        bank = executor.init_bank(
            np.random.default_rng(int(meta.get("seed") or 0)),
            int(meta.get("num_slots") or 4), device=dev)
    kw = dict(strategy=meta.get("strategy", "fused"),
              batch=int(meta.get("batch", 128)),
              ring_capacity=int(meta.get("ring_capacity", 2048)),
              pipeline_depth=int(meta.get("pipeline_depth", 1)),
              policy=(make_policy(meta["policy"])
                      if meta.get("policy") else None),
              record=True, audit=audit, device=dev)
    if meta.get("fault_plan") is not None:
        kw["fault_injector"] = faults_mod.FaultInjector(
            faults_mod.FaultPlan.from_dict(meta["fault_plan"]))
    if hosts > 1:
        if meta.get("lease_ticks") is not None:
            kw["lease_ticks"] = int(meta["lease_ticks"])
        if meta.get("quorum") is not None:
            kw["quorum"] = int(meta["quorum"])
    kw.update(overrides)
    queues = int(meta.get("queues_per_host")
                 or meta.get("num_queues", 4) // hosts)
    if hosts > 1:
        return MeshDataplane(bank, hosts=hosts, num_queues=queues, **kw)
    return DataplaneRuntime(bank, num_queues=queues, **kw)


def replay(
    trace: WorkloadTrace,
    runtime,
    *,
    swap_delivery=default_swap_delivery,
    strict: bool = False,
    install_bank: bool = True,
) -> dict:
    """Feed a trace's step stream through ``runtime`` and verify it.

    Returns ``{"ok", "mismatches", "phases", "totals", "digest",
    "digest_ok"}``: per-phase reports with every invariant the trace
    carries checked, plus the end-of-run totals and (for recorded traces
    replayed on a ``record=True`` runtime) the bit-exactness digest.
    ``strict=True`` raises on the first mismatch instead of collecting
    them.
    """
    if install_bank and trace.bank_leaves is not None:
        _set_bank(runtime, restore_bank(trace, _bank_of(runtime)))
    mismatches: list[str] = []
    phases: list[dict] = []
    prev_totals: dict | None = None
    prev_wrong = runtime.telemetry.wrong_verdict

    def check(label: str, expect: dict | None, got: dict) -> None:
        for key, want in (expect or {}).items():
            if key in got and int(got[key]) != int(want):
                mismatches.append(
                    f"{label}: {key} = {got[key]} != recorded {want}")
                if strict:
                    raise AssertionError(mismatches[-1])

    for step in trace.steps:
        kind = step["kind"]
        if kind == "burst":
            runtime.dispatch(step["rows"])
        elif kind == "tick":
            runtime.tick()
        elif kind == "drain":
            runtime.drain()
        elif kind == "commands":
            runtime.control.submit(*(
                _replay_command(c, swap_delivery) for c in step["commands"]))
        elif kind == "phase":
            totals = runtime.audit_conservation()["totals"]
            wrong = runtime.telemetry.wrong_verdict
            prev = prev_totals or {k: 0 for k in totals}
            got = {k: int(totals[k] - prev[k])
                   for k in ("offered", "completed", "dropped")}
            got["wrong_verdict"] = int(wrong - prev_wrong)
            prev_totals, prev_wrong = dict(totals), wrong
            check(f"phase {step['name']!r}", step.get("expect"), got)
            phases.append({"phase": step["name"], **got})
        else:
            raise ValueError(f"unknown trace step kind {kind!r}")
    if not trace.steps or trace.steps[-1]["kind"] not in ("drain", "phase"):
        runtime.drain()
    runtime.retire_all()

    totals = runtime.audit_conservation()["totals"]
    got_totals = {k: int(totals[k]) for k in
                  ("offered", "completed", "dropped")}
    got_totals["wrong_verdict"] = int(runtime.telemetry.wrong_verdict)
    check("totals", trace.expect.get("totals"), got_totals)

    dig, dig_ok = None, None
    if _records(runtime):
        dig = digest(runtime)
        want = trace.expect.get("digest")
        if want is not None:
            dig_ok = dig["sha256"] == want["sha256"]
            if not dig_ok:
                mismatches.append(
                    f"digest: {dig['sha256'][:16]}... != recorded "
                    f"{want['sha256'][:16]}... (verdict streams diverged)")
                if strict:
                    raise AssertionError(mismatches[-1])
    return {"ok": not mismatches, "mismatches": mismatches,
            "phases": phases, "totals": got_totals,
            "digest": dig, "digest_ok": dig_ok}


# ---------------------------------------------------------------------------
# on-disk codec
# ---------------------------------------------------------------------------

def _enc_nd(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"dt": str(a.dtype), "sh": list(a.shape),
            "b": a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()}


def _dec_nd(d: dict) -> np.ndarray:
    a = np.frombuffer(d["b"], dtype=np.dtype(d["dt"]).newbyteorder("<"))
    return a.reshape(d["sh"]).astype(np.dtype(d["dt"]), copy=False)


def _enc_cmd(cmd) -> dict:
    if isinstance(cmd, SwapSlot):
        if cmd.params is None:
            leaves = None
        elif isinstance(cmd.params, PackedLeaves):
            leaves = [_enc_nd(leaf) for leaf in cmd.params.leaves]
        else:
            leaves = [_enc_nd(leaf) for leaf in _leaves_of(cmd.params)]
        return {"c": "swap", "slot": int(cmd.slot), "leaves": leaves}
    if isinstance(cmd, ProgramReta):
        return {"c": "reta", "reta": [int(q) for q in cmd.reta]}
    if isinstance(cmd, FailQueues):
        return {"c": "fail", "queues": [int(q) for q in cmd.queues]}
    if isinstance(cmd, RestoreQueues):
        return {"c": "restore", "queues": [int(q) for q in cmd.queues]}
    if isinstance(cmd, SetPolicy):
        name = (cmd.policy if isinstance(cmd.policy, str)
                else _policy_name(cmd.policy))
        return {"c": "policy", "name": name}
    raise TypeError(f"cannot serialize command {cmd!r}")


def _dec_cmd(d: dict):
    kind = d["c"]
    if kind == "swap":
        params = (None if d["leaves"] is None else
                  PackedLeaves(tuple(_dec_nd(x) for x in d["leaves"])))
        return SwapSlot(int(d["slot"]), params)
    if kind == "reta":
        return ProgramReta(tuple(d["reta"]))
    if kind == "fail":
        return FailQueues(tuple(d["queues"]))
    if kind == "restore":
        return RestoreQueues(tuple(d["queues"]))
    if kind == "policy":
        return SetPolicy(d["name"])
    raise ValueError(f"unknown serialized command kind {kind!r}")


def _enc_step(step: dict) -> dict:
    kind = step["kind"]
    if kind == "burst":
        return {"k": "b", "rows": _enc_nd(step["rows"])}
    if kind == "tick":
        return {"k": "t"}
    if kind == "drain":
        return {"k": "d"}
    if kind == "commands":
        return {"k": "c", "cmds": [_enc_cmd(c) for c in step["commands"]]}
    if kind == "phase":
        return {"k": "p", "name": step["name"],
                "expect": step.get("expect")}
    raise ValueError(f"unknown trace step kind {kind!r}")


def _dec_step(d: dict) -> dict:
    kind = d["k"]
    if kind == "b":
        return {"kind": "burst", "rows": _dec_nd(d["rows"])}
    if kind == "t":
        return {"kind": "tick"}
    if kind == "d":
        return {"kind": "drain"}
    if kind == "c":
        return {"kind": "commands",
                "commands": tuple(_dec_cmd(c) for c in d["cmds"])}
    if kind == "p":
        return {"kind": "phase", "name": d["name"], "expect": d["expect"]}
    raise ValueError(f"unknown serialized step kind {kind!r}")


#: v2 chunk tags: ``S`` = a batch of encoded steps (stream order),
#: ``T`` = the tail (meta + expect + bank), exactly one, written last
_TAG_STEPS = b"S"
_TAG_TAIL = b"T"

#: first packet word eligible for payload dictionary encoding: the 16
#: meta words and payload word 0 are per-packet (seq numbers, flow words,
#: the render-time payload twist), but words 17..271 are a flow's base
#: payload repeated verbatim across every burst: the bulk of a trace's
#: bytes and the part deflate spends its time on
_PDICT_LO = pkt.META_WORDS + 1
#: sentinel index for rows whose tail is not in the dictionary
_PDICT_INLINE = 0xFFFFFFFF
#: dictionary entry cap: bounds writer/loader memory for always-on
#: recording of non-repeating traffic (overflow rows encode inline)
_PDICT_CAP = 1 << 16


def _step_nbytes(enc: dict) -> int:
    n = 64
    for v in enc.values():
        if isinstance(v, (bytes, bytearray)):
            n += len(v)
        elif isinstance(v, dict):
            n += _step_nbytes(v)
        elif isinstance(v, list):
            n += sum(_step_nbytes(x) for x in v if isinstance(x, dict))
    return n


class _ChunkWriter:
    """Appends compressed step chunks to an open file as they fill.

    Both ``save()`` and the streaming ``TraceRecorder`` write through this
    class with the same flush policy, so a buffered save and a streamed
    recording of the same run produce byte-identical files.
    """

    def __init__(self, path: str, *, level: int = CHUNK_ZLIB_LEVEL,
                 chunk_bytes: int = CHUNK_BYTES):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(MAGIC + bytes([TRACE_VERSION]))
        self._f.flush()
        self._level = level
        self._chunk_bytes = chunk_bytes
        self._buf: list[dict] = []
        self._buf_bytes = 0
        self._pdict: dict[bytes, int] = {}
        self._tab_new: list[bytes] = []
        self.nbytes = len(MAGIC) + 1
        self.steps = 0

    def add_step(self, step: dict) -> None:
        if step["kind"] == "burst":
            enc = {"k": "b", "rows": self._enc_rows(step["rows"])}
        else:
            enc = _enc_step(step)
        self._buf.append(enc)
        self.steps += 1
        self._buf_bytes += _step_nbytes(enc)
        if self._buf_bytes >= self._chunk_bytes:
            self._flush_steps()

    def _enc_rows(self, rows: np.ndarray) -> dict:
        """Dictionary-encode a burst against the file-global payload table:
        per-burst ``np.unique`` collapses repeats, then only the per-burst
        uniques hit the python dict."""
        rows = np.ascontiguousarray(rows).astype("<u4", copy=False)
        B, W = rows.shape
        if W <= _PDICT_LO or B == 0:
            return _enc_nd(rows)
        tail = np.ascontiguousarray(rows[:, _PDICT_LO:])
        void = tail.view([("v", f"V{tail.shape[1] * 4}")]).ravel()
        uniq, inv = np.unique(void, return_inverse=True)
        idx_of = np.empty(len(uniq), np.int64)
        for u, key_v in enumerate(uniq):
            key = key_v.tobytes()
            gi = self._pdict.get(key)
            if gi is None and len(self._pdict) < _PDICT_CAP:
                gi = len(self._pdict)
                self._pdict[key] = gi
                self._tab_new.append(key)
            idx_of[u] = _PDICT_INLINE if gi is None else gi
        gidx = idx_of[inv].astype("<u4")
        inline = tail[gidx == _PDICT_INLINE]
        return {"dt": "<u4", "sh": [B, W], "pd": 1,
                "head": rows[:, :_PDICT_LO].tobytes(),
                "idx": gidx.tobytes(), "inl": inline.tobytes()}

    def _write_chunk(self, tag: bytes, payload) -> None:
        blob = zlib.compress(codec.packb(payload), self._level)
        self._f.write(tag + struct.pack("<I", len(blob)))
        self._f.write(blob)
        self._f.flush()  # chunks are durable during the run, not at close
        self.nbytes += 5 + len(blob)

    def _flush_steps(self) -> None:
        if self._buf:
            self._write_chunk(_TAG_STEPS, {"s": self._buf, "t": self._tab_new})
            self._buf, self._buf_bytes, self._tab_new = [], 0, []

    def finish(self, *, meta: dict, expect: dict, bank_leaves) -> int:
        self._flush_steps()
        self._write_chunk(_TAG_TAIL, {
            "meta": meta, "expect": expect,
            "bank": (None if bank_leaves is None else
                     [_enc_nd(np.asarray(leaf)) for leaf in bank_leaves]),
        })
        self._f.close()
        return self.nbytes

    def abort(self) -> None:
        if not self._f.closed:
            self._f.close()


def save(trace: WorkloadTrace, path: str) -> int:
    """Write the v2 chunked container; returns bytes written."""
    w = _ChunkWriter(path)
    for s in trace.steps:
        w.add_step(s)
    return w.finish(meta=dict(trace.meta, version=TRACE_VERSION),
                    expect=trace.expect, bank_leaves=trace.bank_leaves)


def _dec_rows_pd(d: dict, table: np.ndarray) -> np.ndarray:
    """Decode a dictionary-encoded burst against the accumulated table."""
    B, W = d["sh"]
    tail_w = W - _PDICT_LO
    rows = np.empty((B, W), "<u4")
    rows[:, :_PDICT_LO] = np.frombuffer(
        d["head"], "<u4").reshape(B, _PDICT_LO)
    idx = np.frombuffer(d["idx"], "<u4")
    tail_view = rows[:, _PDICT_LO:]
    inline_mask = idx == _PDICT_INLINE
    if inline_mask.any():
        tail_view[inline_mask] = np.frombuffer(
            d["inl"], "<u4").reshape(-1, tail_w)
    hit_mask = ~inline_mask
    if hit_mask.any():
        tail_view[hit_mask] = table[idx[hit_mask]]
    return rows.astype(np.uint32, copy=False)


def _load_v2(f, path: str) -> WorkloadTrace:
    steps: list[dict] = []
    tail = None
    table = np.empty((0, pkt.PACKET_WORDS - _PDICT_LO), "<u4")
    while True:
        head = f.read(5)
        if not head:
            break
        if len(head) != 5:
            raise ValueError(f"{path}: truncated chunk header")
        tag, (length,) = head[:1], struct.unpack("<I", head[1:])
        blob = f.read(length)
        if len(blob) != length:
            raise ValueError(f"{path}: truncated chunk body")
        payload = codec.unpackb(zlib.decompress(blob))
        if tag == _TAG_STEPS:
            if payload["t"]:
                new = np.frombuffer(b"".join(payload["t"]),
                                    "<u4").reshape(len(payload["t"]), -1)
                table = np.concatenate([table, new]) if table.size else new
            for enc in payload["s"]:
                if enc["k"] == "b" and enc["rows"].get("pd"):
                    steps.append({"kind": "burst",
                                  "rows": _dec_rows_pd(enc["rows"], table)})
                else:
                    steps.append(_dec_step(enc))
        elif tag == _TAG_TAIL:
            tail = payload
        else:
            raise ValueError(f"{path}: unknown chunk tag {tag!r}")
    if tail is None:
        raise ValueError(f"{path}: no tail chunk (recording not finished?)")
    bank = tail.get("bank")
    return WorkloadTrace(
        meta=tail["meta"],
        steps=steps,
        expect=tail.get("expect") or {},
        bank_leaves=(None if bank is None else
                     tuple(_dec_nd(x) for x in bank)),
    )


def load(path: str) -> WorkloadTrace:
    """Read a v2 (chunked) or v1 (monolithic) trace file, the port's or
    the reference's; anything else raises ``ValueError``."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC) + 1)
        if head[: len(MAGIC)] != MAGIC or len(head) != len(MAGIC) + 1:
            raise ValueError(f"{path}: not a workload trace (bad magic)")
        version = head[len(MAGIC)]
        if version == 2:
            return _load_v2(f, path)
        if version != 1:
            raise ValueError(
                f"{path}: trace version {version} unsupported "
                f"(this build reads v1-v{TRACE_VERSION})")
        blob = f.read()
    doc = codec.unpackb(zlib.decompress(blob))
    bank = doc.get("bank")
    return WorkloadTrace(
        meta=doc["meta"],
        steps=[_dec_step(s) for s in doc["steps"]],
        expect=doc.get("expect") or {},
        bank_leaves=(None if bank is None else
                     tuple(_dec_nd(x) for x in bank)),
    )
