"""Request lifecycle for the serving engine (the port's copy of
``repro.engine.request`` without the prefix-cache and fault-tolerance
fields)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class FinishReason(str, enum.Enum):
    """Typed terminal outcome. Without fault tolerance (deadlines, shedding,
    cancellation, quarantine: a later slice) every request ends OK."""
    OK = "ok"                 # produced its final token

    def __str__(self):
        return self.value


@dataclass(eq=False)                  # identity equality: requests go in sets
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    arrival: float = 0.0

    # engine state -----------------------------------------------------------
    slot: Optional[int] = None
    prefilled: int = 0                # tokens already written to the cache
    generated: List[int] = field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    finish_reason: Optional[FinishReason] = None
    last_used: int = 0                # engine step that last batched this
    num_preemptions: int = 0

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
