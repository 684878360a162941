"""Single-host multi-queue data plane (torch port).

The AF_XDP deployment shape in software: ``rss`` hashes flows to queues,
``ring`` buffers each queue with counted tail-drop, ``runtime`` runs the
fused forwarding program over the queues behind the epoch-stamped control
plane (`repro_torch.control`), ``telemetry`` exports per-queue counters,
and ``workloads`` generates phased emergency traffic (eleven regimes),
recordable and bit-exactly replayable as versioned traces, to drive it
(``scenarios`` is its compatibility shim).  ``faults`` injects typed,
deterministic failures at named points of the runtime.  The reference's
multi-host mesh is not ported yet (ROADMAP.md Queue 1 item 9).
"""

from repro_torch.dataplane.ring import PacketRing, RingCounters  # noqa: F401
from repro_torch.dataplane.runtime import DataplaneRuntime  # noqa: F401
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
