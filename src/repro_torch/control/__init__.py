"""Versioned control plane for the data-plane runtime (torch port).

``commands`` defines the five typed mutations, ``plane`` batches them into
atomic, epoch-stamped transactions applied only at tick boundaries and
keeps the auditable command log, ``policy`` closes the loop from telemetry
back to ``ProgramReta`` epochs, and ``slotcache`` scales model residency
past the device slot count with LRU eviction and a prefetcher.
"""

from repro_torch.control.commands import (  # noqa: F401
    API_VERSION, Command, FailQueues, ProgramReta, RestoreQueues, SetPolicy,
    SwapSlot,
)
from repro_torch.control.plane import (  # noqa: F401
    COMMIT_MODES, ControlPlane, EpochRecord, NonFatalControlError,
    load_epoch_spill,
)
from repro_torch.control.policy import (  # noqa: F401
    POLICIES, DropRateRebalance, LeastDepth, PolicyView, RoutingPolicy,
    StaticReta, make_policy,
)
from repro_torch.control.slotcache import (  # noqa: F401
    CacheError, SlotCache, SlotMixPrefetcher,
)
