"""Typed engine config groups and results (the port's subset of
``repro.engine.api``): the nested groups of ``EngineConfig``
(:class:`PrefixConfig`, :class:`FaultConfig`, :class:`ObsConfig`) and the
frozen results :class:`PrefixStats` and :class:`BlockLedger`. The results
carry ``.as_dict()`` and support ``stats["hits"]`` and ``== {...}``
against plain dicts, as the reference's do."""
from __future__ import annotations

from dataclasses import asdict, dataclass, fields
from typing import Optional, Tuple


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
    Retries and quarantine need a fault plan, which the port does not have
    yet, so ``quarantine_after`` and ``retry_backoff`` have no effect (as
    in the reference without one); ``auto_snapshot_every`` above 0 raises
    in the engine."""
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
