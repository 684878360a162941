"""Multi-queue, multi-host data plane (torch port).

The AF_XDP deployment shape in software: ``rss`` hashes flows to queues
(and, at mesh scale, to (host, queue) pairs through global queue ids),
``ring`` buffers each queue with counted tail-drop, ``runtime`` runs the
fused forwarding program over the queues (loop / vmap / shard_map) behind
the epoch-stamped control plane (`repro_torch.control`), ``mesh`` lifts the
runtime to several hosts (per-host shards, cross-host RSS, epoch-barrier
control fan-out with leases and quorum), ``telemetry`` exports per-queue
counters with a mesh-wide ``merge``, and ``workloads`` generates phased
emergency traffic (eleven regimes), recordable and bit-exactly replayable
as versioned traces, to drive it (``scenarios`` is its compatibility shim).
``faults`` injects typed, deterministic failures (stalls, crashes, shard
errors, lost acks, delayed retires) at named points of both runtimes.
"""

from repro_torch.dataplane.ring import PacketRing, RingCounters  # noqa: F401
from repro_torch.dataplane.runtime import DataplaneRuntime, queue_mesh  # noqa: F401
from repro_torch.dataplane.mesh import MeshDataplane, QuorumLost  # noqa: F401
from repro_torch.dataplane.faults import (  # noqa: F401
    CrashHost, DelayRetire, DropAck, FaultInjector, FaultPlan, InjectedFault,
    ShardError, StallHost, demo_plan, load_plan, random_plan, save_plan,
)
from repro_torch.dataplane.workloads import (  # noqa: F401
    ChaosEvent, Phase, ScenarioTrace, WorkloadTrace,
    cascading_failover_phases, elephant_skew_phases, emergency_phases,
    make_scenario, make_workload, phase_commands, play, render, SEQ_WORD,
)
from repro_torch.dataplane import rss, scenarios, telemetry, workloads  # noqa: F401
