"""Fault tolerance (the port's ``repro.ft``): the straggler watchdog, the
deterministic fault plan (``faults``), exactly-once delivery across crash
recovery (``recovery``) and elastic rescaling (``elastic``:
``rebuild_layout``, ``reshard_params``)."""
from .faults import (Fault, FaultPlan, InjectedFault, SnapshotError,
                     corrupt_snapshot, random_plan)
from .elastic import rebuild_layout, reshard_params
from .recovery import DeliveryLog, ReplayDivergence
from .watchdog import StragglerWatchdog

__all__ = ["StragglerWatchdog", "Fault", "FaultPlan", "InjectedFault",
           "SnapshotError", "corrupt_snapshot", "random_plan",
           "DeliveryLog", "ReplayDivergence", "rebuild_layout",
           "reshard_params"]
