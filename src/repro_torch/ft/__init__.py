"""Fault tolerance (the port's subset of ``repro.ft``): the straggler
watchdog. Fault injection, snapshots and recovery come later."""
from .watchdog import StragglerWatchdog

__all__ = ["StragglerWatchdog"]
