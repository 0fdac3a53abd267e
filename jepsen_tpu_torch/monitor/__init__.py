"""Always-on continuous verification (`jepsen monitor`).

The port's copy of `jepsen_tpu/monitor/`: a paced generator,
rolling-window online checking with constant memory (rolling.py, its
frontiers on the card), a durable time-series observatory
(telemetry/timeseries.py), SLO evaluation with alert routing
(alerts.py), and the standing loop that ties them together (loop.py).
Live-target mode (`--suite`, monitor/live.py) swaps the synthetic
source for a suite-backed client pool with an evolving in-run fault
schedule and supervised recovery; it is imported lazily so the base
monitor stays free of suite dependencies.  The multi-tenant layer
(`jepsen fleet`, fleet.py + retention.py) supervises N such monitors
as isolated tenant children over one checkerd federation.
"""

from .alerts import AlertRouter
from .fleet import (FleetRegistry, FleetSupervisor, TenantSpec,
                    tenant_store_dir)
from .loop import MonitorConfig, run_monitor
from .retention import RetentionPolicy
from .rolling import RollingChecker

__all__ = [
    "AlertRouter",
    "FleetRegistry",
    "FleetSupervisor",
    "MonitorConfig",
    "RetentionPolicy",
    "RollingChecker",
    "TenantSpec",
    "run_monitor",
    "tenant_store_dir",
]
