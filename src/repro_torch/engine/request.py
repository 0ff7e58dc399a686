"""Request lifecycle for the serving engine (the port's copy of
``repro.engine.request``)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class FinishReason(str, enum.Enum):
    """Typed terminal outcome: every request the engine accepts ends in
    exactly one of these (no request is ever silently dropped, even under
    shutdown)."""
    OK = "ok"                 # produced its final token
    TIMEOUT = "timeout"       # deadline passed before completion
    CANCELLED = "cancelled"   # explicit cancel(rid)
    SHED = "shed"             # bounded-queue shed policy / shutdown drain
    FAILED = "failed"         # quarantined: killed the step too many times

    def __str__(self):
        return self.value


@dataclass(eq=False)                  # identity equality: requests go in sets
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    arrival: float = 0.0
    deadline: Optional[float] = None  # absolute (engine-clock) time after
    #                                   which the request times out; None =
    #                                   engine default (cfg.deadline_s past
    #                                   arrival) or no deadline

    # engine state -----------------------------------------------------------
    slot: Optional[int] = None
    row: Optional[int] = None         # dp row this request is routed to
    #                                   (free-block-aware, assigned once and
    #                                   sticky across preemptions, so that
    #                                   the row's prefix cache stays warm)
    prefilled: int = 0                # tokens already written to the cache
    cached_tokens: int = 0            # prefill tokens served by a prefix hit
    #                                   at the current admission (reset on
    #                                   preemption; observability only)
    # prefix-index commit cursor: blocks already committed this residency
    # and the chain hash at that depth (None = root); reset on preemption
    pc_blocks: int = 0
    pc_parent: Optional[int] = None
    # chain hashes of the full prompt blocks this admission will write,
    # published in the engine's in-flight registry so that a same-prefix
    # request admitted behind it waits for the commit instead of prefilling
    # the span again; cleared on preemption and finish
    inflight_keys: List[int] = field(default_factory=list)
    generated: List[int] = field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    finish_reason: Optional[FinishReason] = None
    last_used: int = 0                # engine step that last batched this
    num_preemptions: int = 0
    # fault-tolerance state: failed steps this request was part of, and
    # the step before which it must not be batched or admitted again
    fail_count: int = 0
    retry_at: int = 0

    def all_tokens(self) -> List[int]:
        """Prompt plus generated: after a preemption the whole thing is the
        effective prompt (recompute preemption)."""
        return list(self.prompt) + list(self.generated)

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def pos(self) -> int:
        """Cache write position of the next decode step's input token (the
        last known token)."""
        return self.total_tokens - 1
