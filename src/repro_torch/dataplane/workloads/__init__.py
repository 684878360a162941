"""Trace-driven workload engine (torch port): ``phases`` holds the
``Phase``/``render``/``play`` kernel (with first-class chaos events),
``generators`` the parameterized regime library and its registry, and
``trace`` the versioned recordable/replayable trace format (``record``
from a live run, bit-exact ``replay`` through a runtime, ``synthesize``
straight from generator phases), whose files the reference reads and
writes too."""

from repro_torch.dataplane.workloads.generators import (  # noqa: F401
    CORPUS_ENV, REGIME_NAMES, SYNTHETIC_CORPUS, Workload,
    barrier_straggler_workload, cascading_failover_phases,
    chaos_host_failover_phases, chaos_queue_surge_phases,
    crash_mid_commit_workload, diurnal_phases, elephant_skew_phases,
    emergency_phases, file_corpus, file_replay_workload, flash_crowd_phases,
    make_scenario, make_workload, slot_thrash_phases,
)
from repro_torch.dataplane.workloads.phases import (  # noqa: F401
    SEQ_WORD, ChaosEvent, Phase, ScenarioTrace, chaos_by_tick,
    default_swap_delivery, materialize_command, phase_command_specs,
    phase_commands, play, render,
)
from repro_torch.dataplane.workloads.trace import (  # noqa: F401
    INVARIANT_KEYS, TRACE_VERSION, PackedLeaves, StreamedTrace, TraceRecorder,
    WorkloadTrace, digest, load, make_runtime, record, replay, restore_bank,
    runtime_meta, save, synthesize,
)
