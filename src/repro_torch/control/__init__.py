"""Versioned control plane for the data-plane runtime (torch port).

``commands`` defines the five typed mutations, ``plane`` batches them into
atomic, epoch-stamped transactions applied only at tick boundaries and
keeps the auditable command log, ``policy`` closes the loop from telemetry
back to ``ProgramReta`` epochs, ``health`` keeps the mesh's per-host
leases, and ``slotcache`` scales model residency
past the device slot count with LRU eviction and a prefetcher.
"""

from repro_torch.control.commands import (  # noqa: F401
    API_VERSION, Command, FailQueues, ProgramReta, RestoreQueues, SetPolicy,
    SwapSlot,
)
from repro_torch.control.health import (  # noqa: F401
    HealthMonitor, HostState, Transition,
)
from repro_torch.control.plane import (  # noqa: F401
    COMMIT_MODES, DELTA_RETA, DELTA_SWAP, ControlPlane, DeviceDelta,
    EpochRecord, NonFatalControlError, load_epoch_spill,
    serialize_device_delta,
)
from repro_torch.control.policy import (  # noqa: F401
    POLICIES, DropRateRebalance, LeastDepth, PolicyView, RoutingPolicy,
    StaticReta, make_policy,
)
from repro_torch.control.slotcache import (  # noqa: F401
    CacheError, SlotCache, SlotMixPrefetcher,
)
