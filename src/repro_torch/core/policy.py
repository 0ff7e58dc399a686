"""Shift decision policy (paper Algorithm 2; the port's copy of
``repro.core.policy.ThresholdPolicy``): batched-token count above a fixed
threshold -> base (SP) config, otherwise -> shift (TP) config."""
from __future__ import annotations

from dataclasses import dataclass

DEFAULT_SHIFT_THRESHOLD = 32


@dataclass(frozen=True)
class ThresholdPolicy:
    threshold: int = DEFAULT_SHIFT_THRESHOLD   # batched tokens per iteration

    def use_base(self, n_tokens: int, n_prefill_tokens: int = 0) -> bool:
        return n_tokens > self.threshold
