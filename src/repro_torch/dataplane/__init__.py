"""Single-host multi-queue data plane (torch port).

The AF_XDP deployment shape in software: ``rss`` hashes flows to queues,
``ring`` buffers each queue with counted tail-drop, ``runtime`` runs the
fused forwarding program over the queues behind the epoch-stamped control
plane (`repro_torch.control`), ``telemetry`` exports per-queue counters,
and ``workloads`` generates phased emergency traffic to drive it.
"""

from repro_torch.dataplane.ring import PacketRing, RingCounters  # noqa: F401
from repro_torch.dataplane.runtime import DataplaneRuntime  # noqa: F401
from repro_torch.dataplane.workloads import (  # noqa: F401
    SEQ_WORD, ChaosEvent, Phase, ScenarioTrace, emergency_phases,
    phase_commands, play, render,
)
from repro_torch.dataplane import rss, telemetry, workloads  # noqa: F401
