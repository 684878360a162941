"""Phased workloads (torch port): ``phases`` holds ``Phase``/``render``/
``play``, ``generators`` the emergency storyline."""

from repro_torch.dataplane.workloads.generators import emergency_phases  # noqa: F401
from repro_torch.dataplane.workloads.phases import (  # noqa: F401
    SEQ_WORD, ChaosEvent, Phase, ScenarioTrace, chaos_by_tick,
    default_swap_delivery, materialize_command, phase_command_specs,
    phase_commands, play, render,
)
