"""Typed serving API (the port's copy of ``repro.engine.api``): the
:class:`ServingClient` protocol that ``ShiftEngine`` implements
(``submit``/``cancel``/``step``/``stream``/``stats``), the nested groups
of ``EngineConfig`` (:class:`PrefixConfig`, :class:`FaultConfig`,
:class:`ObsConfig`) and the frozen results :class:`PrefixStats`,
:class:`BlockLedger`, :class:`EngineStats` and :class:`ClusterStats`. The
results carry ``.as_dict()`` and support ``stats["hits"]`` and
``== {...}`` against plain dicts, as the reference's do. ``ClusterStats``
is the record only: the cluster ``Router`` that fills it is not ported
yet."""
from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields
from typing import List, Optional, Protocol, Tuple, runtime_checkable


@runtime_checkable
class ServingClient(Protocol):
    """What a serving backend looks like from the outside: ``submit``
    enqueues a request and returns its rid; ``cancel`` ends a live request
    (False when the rid is unknown or already ended); ``step`` runs one
    scheduling iteration and returns False when idle; ``stream`` returns
    the tokens generated so far for a rid (exactly-once incremental
    delivery is the caller's :class:`~repro_torch.ft.DeliveryLog`'s job);
    ``stats`` returns a typed, frozen summary with ``.as_dict()``."""

    def submit(self, request) -> int: ...

    def cancel(self, rid: int) -> bool: ...

    def step(self) -> bool: ...

    def stream(self, rid: int) -> List[int]: ...

    def stats(self): ...


@dataclass(frozen=True)
class PrefixConfig:
    """Prefix-cache knobs (``repro_torch.cache.PrefixIndex`` on the paged
    pool)."""
    enabled: bool = False     # hash-indexed prefix reuse + COW (opt-in:
    #                           reused blocks make warm prefills shape-
    #                           differently from cold ones, so A/B
    #                           comparisons should enable it on both sides)


@dataclass(frozen=True)
class FaultConfig:
    """Fault-tolerance knobs (queue bounds, deadlines, retry, snapshots).
    ``quarantine_after`` and ``retry_backoff`` act on the requests of a
    failed step (a ``FaultPlan`` given to the engine injects the
    failures); ``auto_snapshot_every`` above 0 keeps the newest
    ``snapshot_keep`` snapshots in the engine's ring."""
    max_queue: int = 0               # bound on UNADMITTED queued requests;
    #                                  0 = unbounded
    shed_policy: str = "reject-newest"   # or "evict-longest-queued"
    deadline_s: Optional[float] = None   # default per-request deadline
    quarantine_after: int = 3        # failed steps before FinishReason.FAILED
    retry_backoff: int = 2           # extra idle steps per accumulated failure
    auto_snapshot_every: int = 0     # snapshot every N steps (0 = off)
    snapshot_keep: int = 2           # retained snapshots in the ring
    straggler_factor: float = 2.5    # watchdog: flag steps slower than
    #                                  factor x the rolling median


@dataclass(frozen=True)
class ObsConfig:
    """Observability knobs (``repro_torch.obs``)."""
    enabled: bool = True      # False swaps in the no-op NullObs (the
    #                           uninstrumented side of obs.overhead_ratio)
    window: int = 1024        # rolling per-step audit-record window
    event_cap: int = 65536    # bounded lifecycle-event log capacity

    def __bool__(self):       # `if cfg.obs:` keeps meaning "is obs on"
        return self.enabled


class _MappingCompat:
    """Dict-compat for the frozen result dataclasses: ``stats["hits"]``,
    ``"hits" in stats``, ``== {...}`` against plain dicts, and
    ``.as_dict()``."""

    def as_dict(self) -> dict:
        return asdict(self)

    def __getitem__(self, key):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def __contains__(self, key):
        return any(f.name == key for f in fields(self))

    def __eq__(self, other):
        if isinstance(other, dict):
            return self.as_dict() == other
        if isinstance(other, type(self)):
            return self.as_dict() == other.as_dict()
        return NotImplemented

    __hash__ = None


@dataclass(frozen=True, eq=False)
class PrefixStats(_MappingCompat):
    """Prefix-cache counters (zeros when caching is off), the engine's COW
    copy count and the reason paging is off (None when paged)."""
    entries: int = 0
    hits: int = 0
    misses: int = 0
    tokens_saved: int = 0
    evictions: int = 0
    cow_copies: int = 0
    paged_disabled_reason: Optional[str] = None


@dataclass(frozen=True, eq=False)
class BlockLedger(_MappingCompat):
    """Paged-block ledger: ``used`` counts blocks held by anyone (sequence
    mappings and prefix pins), ``pinned`` the prefix-index pins (both zero
    after the engine drains and the index is emptied: any remainder is a
    leak); ``free`` / ``free_per_row`` are the allocatable remainder."""
    used: int = 0
    pinned: int = 0
    free: int = 0
    free_per_row: Tuple[int, ...] = ()


@dataclass(frozen=True, eq=False)
class EngineStats(_MappingCompat):
    """One engine's serving state, frozen at a step boundary: everything
    the serve CLI prints comes from here."""
    steps: int = 0
    queue_depth: int = 0              # requests waiting for a slot
    active: int = 0                   # requests holding a slot
    preemptions: int = 0
    config_counts: dict = field(default_factory=dict)   # {"base": n, ...}
    paged: bool = False
    paged_disabled_reason: Optional[str] = None
    dp: int = 1
    block_size: int = 0
    blocks_per_row: int = 0
    free_blocks: int = 0
    queued_block_demand: int = 0      # blocks the unadmitted queue will need
    prefix: PrefixStats = field(default_factory=PrefixStats)
    blocks: BlockLedger = field(default_factory=BlockLedger)
    replica: Optional[int] = None     # set when owned by a cluster router


@dataclass(frozen=True, eq=False)
class ClusterStats(_MappingCompat):
    """A cluster router's view: per-replica :class:`EngineStats` plus the
    cluster-level routing and migration counters."""
    replicas: Tuple[EngineStats, ...] = ()
    routing: str = "affinity"
    steps: int = 0
    migrations: int = 0
    migrated_blocks: int = 0
    affinity_evictions: int = 0       # LRU evictions from the bounded
    #                                   first-chain-key affinity memo

    @property
    def queue_depth(self) -> int:
        return sum(r.queue_depth for r in self.replicas)

    @property
    def active(self) -> int:
        return sum(r.active for r in self.replicas)
