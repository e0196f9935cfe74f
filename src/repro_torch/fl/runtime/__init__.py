"""Scale-out federation runtime of the port (wire protocol, population,
executors, round engines). Port of ``repro/fl/runtime``. Import explicitly
— ``from repro_torch.fl.runtime import ...`` — rather than via
``repro_torch.fl`` (which core.spry imports; keeping the runtime out of
that __init__ avoids an import cycle)."""
from repro_torch.fl.runtime.async_engine import (
    AsyncConfig,
    AsyncFederationEngine,
    AsyncRoundReport,
)
from repro_torch.fl.runtime.engine import (
    FederationEngine,
    RoundReport,
    WireConfig,
    WireHealth,
)
from repro_torch.fl.runtime.events import (
    EventHeap,
    UtilizationReport,
    sample_available,
    simulate_async_utilization,
    simulate_sync_utilization,
)
from repro_torch.fl.runtime.executor import (
    SerialExecutor,
    ShardedExecutor,
    pad_cohort,
)
from repro_torch.fl.runtime.faults import (
    FaultConfig,
    FaultCounters,
    FaultInjector,
)
from repro_torch.fl.runtime.messages import (
    WIRE_DTYPES,
    WIRE_SCHEMA,
    ClientUpdate,
    TaskAssignment,
    WireError,
    decode_frame,
    wire_dtype,
)
from repro_torch.fl.runtime.population import (
    ClientPopulation,
    CohortPlan,
    CohortScheduler,
    DeviceTier,
)
