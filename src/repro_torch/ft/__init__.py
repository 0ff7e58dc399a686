"""Fault tolerance (the port's subset of ``repro.ft``): the straggler
watchdog, the deterministic fault plan (``faults``) and exactly-once
delivery across crash recovery (``recovery``). Elastic resharding
(``reshard_params``, ``rebuild_layout``) is not ported yet."""
from .faults import (Fault, FaultPlan, InjectedFault, SnapshotError,
                     corrupt_snapshot, random_plan)
from .recovery import DeliveryLog, ReplayDivergence
from .watchdog import StragglerWatchdog

__all__ = ["StragglerWatchdog", "Fault", "FaultPlan", "InjectedFault",
           "SnapshotError", "corrupt_snapshot", "random_plan",
           "DeliveryLog", "ReplayDivergence"]
