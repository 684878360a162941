"""Compatibility shim (torch port): the traffic engine lives in
`repro_torch.dataplane.workloads`.

Every public name this module exports resolves to the same object there,
as in the reference, so call sites written against ``scenarios`` keep
working.  New code should import from ``repro_torch.dataplane.workloads``.
"""

from repro_torch.dataplane.workloads.generators import (  # noqa: F401
    cascading_failover_phases, elephant_skew_phases, emergency_phases,
    make_scenario,
)
from repro_torch.dataplane.workloads.phases import (  # noqa: F401
    SEQ_WORD, ChaosEvent, Phase, ScenarioTrace, default_swap_delivery,
    phase_commands, play, render,
)
