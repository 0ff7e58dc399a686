"""Cluster serving: a ``Router`` over N ``ShiftEngine`` replicas with
prefix-affinity routing, skew-triggered live KV migration (typed
block-granular :class:`TransferOp` plans, exactly-once delivery), and a
merged observability dump — all through the typed ``ServingClient``
facade, never engine private state (the port's copy of
``repro.cluster``).
"""
from .migration import TransferOp, build_transfer_plan
from .router import ROUTING_POLICIES, Router

__all__ = ["Router", "TransferOp", "build_transfer_plan",
           "ROUTING_POLICIES"]
