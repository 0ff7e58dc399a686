"""Shift decision policy (paper Algorithm 2; the port's copy of
``repro.core.policy.ThresholdPolicy``): batched-token count above a fixed
threshold -> base (SP) config, otherwise -> shift (TP) config."""
from __future__ import annotations

from dataclasses import dataclass

DEFAULT_SHIFT_THRESHOLD = 32


@dataclass(frozen=True)
class ThresholdPolicy:
    threshold: int = DEFAULT_SHIFT_THRESHOLD   # batched tokens per iteration

    def use_base(self, n_tokens: int, n_prefill_tokens: int = 0,
                 ctx_tokens: int = 0, n_rows: int = 0,
                 ctx_max: int = 0, spec_tokens: int = 0) -> bool:
        """The paper's rule ignores context; ``ctx_tokens`` (sum of the
        batch rows' context lengths), ``n_rows``, ``ctx_max`` (the largest
        row context) and ``spec_tokens`` (speculative draft queries inside
        ``n_tokens``) are accepted so that the engine feeds every policy the
        same iteration facts. Draft queries count toward the threshold like
        any batched token."""
        return n_tokens > self.threshold
