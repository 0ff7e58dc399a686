"""Self-drafting speculative proposer: a per-request suffix/n-gram cache
(the port's copy of ``repro.spec.drafter``).

No draft model. Each request's own token history (prompt + generated) is
its drafter: an n-gram index maps every gram of length ``ngram_min`` ..
``ngram_max`` to the *most recent earlier* position it ended at. When the
gram ending at the current last token has occurred before, the tokens
that followed that earlier occurrence become the draft — up to ``k``
speculative query tokens the engine verifies in the same mixed forward
pass (Arctic-Inference-style suffix decoding, the companion speedup to
shift parallelism).

Two properties the engine's correctness bar leans on:

- **Pure function of the token sequence.** The index is built
  left-to-right with most-recent-occurrence-wins, and positions are
  indexed lazily (a gram ending at position ``p`` enters the index only
  once the sequence has grown past ``p``), so an incremental index and a
  from-scratch rebuild over the same tokens produce bit-identical
  proposals. Drafter state is therefore *never* snapshotted: after
  restore / reshard / migration a fresh drafter lazily rebuilds from
  ``request.all_tokens()`` and proposes exactly what the lost one would
  have.
- **Proposals never change accepted output.** Drafts are *queries* the
  model verifies; the engine emits only the greedily-accepted prefix
  plus the model's own next token, so streams stay bitwise identical to
  non-speculative decoding regardless of draft quality.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs (``repro_torch.spec``). ``k == 0`` disables
    speculation entirely — the engine then compiles and runs the exact
    pre-spec forward path."""
    k: int = 0            # max draft tokens verified per decode row
    ngram_max: int = 3    # longest suffix gram matched (tried first)
    ngram_min: int = 1    # shortest suffix gram matched (last resort)

    def __post_init__(self):
        if self.k < 0:
            raise ValueError(f"spec k must be >= 0, got {self.k}")
        if self.k and not (1 <= self.ngram_min <= self.ngram_max):
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"[{self.ngram_min}, {self.ngram_max}]")

    def __bool__(self) -> bool:  # `if cfg.spec:` means "is speculation on"
        return self.k > 0


class SuffixDrafter:
    """Per-request n-gram index with lazy, cursor-tracked construction.

    ``propose(rid, tokens, budget)`` first indexes every gram ending at a
    position the cursor has not passed yet — all positions strictly
    before the last one — then looks up the gram ending at the last
    position, longest n first. A hit at earlier position ``p`` proposes
    ``tokens[p+1 : p+1+budget]``. The last position itself is never in
    the index when it is looked up, so a match is always a genuinely
    earlier occurrence.
    """

    def __init__(self, cfg: SpecConfig):
        self.cfg = cfg
        self._ns = tuple(range(cfg.ngram_min, cfg.ngram_max + 1))
        # rid -> {n: {gram tuple: most recent end position}}
        self._idx: Dict[int, Dict[int, Dict[Tuple[int, ...], int]]] = {}
        # rid -> first position whose grams are NOT yet indexed
        self._cursor: Dict[int, int] = {}

    def propose(self, rid: int, tokens: Sequence[int],
                budget: int) -> List[int]:
        """Draft up to ``min(k, budget)`` continuation tokens for the
        sequence ``tokens`` (prompt + generated so far). Returns ``[]``
        on a cold start or when no suffix gram has recurred."""
        n_draft = min(self.cfg.k, budget)
        if n_draft <= 0:
            return []
        L = len(tokens)
        idx = self._idx.get(rid)
        if idx is None:
            idx = self._idx[rid] = {n: {} for n in self._ns}
            self._cursor[rid] = 0
        # index grams ending at every position before the last token
        for p in range(self._cursor[rid], L - 1):
            for n in self._ns:
                if p - n + 1 >= 0:
                    idx[n][tuple(tokens[p - n + 1:p + 1])] = p
        self._cursor[rid] = max(self._cursor[rid], L - 1)
        for n in reversed(self._ns):          # longest gram wins
            if L < n:
                continue
            p = idx[n].get(tuple(tokens[L - n:L]))
            if p is not None:
                draft = tokens[p + 1:p + 1 + n_draft]
                if draft:
                    return [int(t) for t in draft]
        return []

    def drop(self, rid: int):
        """Release a finished/cancelled request's index (memory bound;
        correctness never depends on calling this — see module doc)."""
        self._idx.pop(rid, None)
        self._cursor.pop(rid, None)

    def reset(self):
        """Forget everything (restore/reshard path): indexes rebuild
        lazily and deterministically from each request's tokens."""
        self._idx.clear()
        self._cursor.clear()
