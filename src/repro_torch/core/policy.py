"""Shift decision policies (paper Algorithm 2; the port's copy of
``repro.core.policy``).

``ThresholdPolicy`` is the paper's rule: batched-token count above a fixed
threshold -> base (SP) config, otherwise -> shift (TP) config.

``AdaptivePolicy`` prices both configs with the roofline cost model
(``repro_torch.sim.CostModel``) at the iteration's actual composition and
picks the cheaper one, so that the crossover follows the model and the
hardware instead of a hand-set constant.
"""
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


@dataclass
class AdaptivePolicy:
    """Pick the config of smaller predicted iteration time: base priced as
    ``Strategy("sp", sp·tp)``, shift as ``Strategy("tp", sp·tp)``, ties to
    base.

    The KV-read term scales with the batch's summed context
    (``ctx_tokens``), which the engine passes per iteration; without it the
    batched token count stands in for the context."""

    cost_model: object            # repro_torch.sim.costmodel.CostModel
    sp: int
    tp: int

    def use_base(self, n_tokens: int, n_prefill_tokens: int = 0,
                 ctx_tokens: int = 0, n_rows: int = 0,
                 ctx_max: int = 0, spec_tokens: int = 0) -> bool:
        from repro_torch.sim.costmodel import Strategy
        n_decode = max(n_tokens - n_prefill_tokens, 0)
        n = self.sp * self.tp
        ctx, ctx_lens = ctx_profile(n_tokens, ctx_tokens, n_rows, ctx_max)
        # draft queries share their rows' KV reads (n_spec), so verify-heavy
        # iterations are priced on the compute side
        t_base = self.cost_model.iteration_time(
            n_prefill_tokens, n_decode, ctx, Strategy("sp", n),
            ctx_lens=ctx_lens, n_spec=spec_tokens)
        t_shift = self.cost_model.iteration_time(
            n_prefill_tokens, n_decode, ctx, Strategy("tp", n),
            ctx_lens=ctx_lens, n_spec=spec_tokens)
        return t_base <= t_shift


def ctx_profile(n_tokens: int, ctx_tokens: int = 0, n_rows: int = 0,
                ctx_max: int = 0):
    """The context an iteration is priced at, from the engine's step facts:
    ``(ctx, ctx_lens)``, the mean row context (the batched token count when
    no rows are given) and a per-row profile that keeps both the sum (what
    work-proportional pricing integrates) and the max (what gather
    pricing's pow2 launch bucket derives from), or None without rows."""
    ctx = max(ctx_tokens // n_rows if n_rows else n_tokens, 1)
    if n_rows and ctx_max:
        rest = max(n_rows - 1, 1)
        ctx_lens = [ctx_max] + [(ctx_tokens - ctx_max) // rest] * (n_rows - 1)
    elif n_rows:
        ctx_lens = [ctx_tokens // n_rows] * n_rows
    else:
        ctx_lens = None
    return ctx, ctx_lens
