"""Hash-based prefix index over the paged block pool (the port's copy of
``repro.cache.prefix_index``, without the snapshot methods, which come with
fault tolerance).

One entry per FULL block of token ids: chunk ``i`` of a sequence (tokens
``[i*bs, (i+1)*bs)``) is keyed by a *chained* hash
``h_i = hash((h_{i-1}, chunk_i))``. The chain makes the key depend on every
preceding token, as the KV values inside block ``i`` do (causal
attention). Each entry maps its chain hash to a physical block and holds
ONE allocator reference of its own, so a cached block survives
``free_seq`` of every sequence that wrote or mapped it (decrement-not-free)
and is reclaimed only by LRU eviction. The hash of a tuple of ints does not
depend on ``PYTHONHASHSEED``, so every rank of an SPMD engine derives the
same keys.

Hash collisions cannot corrupt output: every entry stores its ``(parent,
tokens)`` pair and a lookup verifies both; a colliding probe is a miss.

Eviction is leaf-first LRU: only entries with no children in the index and
no sequence mapping them (allocator refcount == 1, the index's own pin) are
candidates. Evicting leaf-first keeps every remaining entry reachable from
the root, which is where matching starts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .block_allocator import BlockAllocator

# chain seed for block 0 of every sequence (any fixed int works; entries
# also verify their tokens exactly)
_ROOT = 0x51F7A11E


@dataclass
class PrefixEntry:
    key: int                      # chained hash (dict key, denormalized)
    parent: int                   # chain hash of the previous block (_ROOT)
    tokens: Tuple[int, ...]       # this block's token ids (collision check)
    block: int                    # physical block id (holds one ref)
    last_used: int = 0            # index clock at last match/commit (LRU)
    children: int = 0             # indexed entries chaining off this one


class PrefixIndex:
    # chain seed, exposed so the engine's in-flight registry walks the same
    # chain-hash sequence as commit and match
    ROOT = _ROOT

    def __init__(self, block_size: int, allocator: BlockAllocator):
        self.block_size = block_size
        self.allocator = allocator
        self._entries: Dict[int, PrefixEntry] = {}
        self._clock = 0
        self.hits = 0                 # admissions that reused >= 1 block
        self.misses = 0               # admissions that reused nothing
        self.tokens_saved = 0         # prefill tokens covered by matches
        self.evictions = 0            # entries reclaimed under pressure
        # optional callback(n_blocks_freed) after each evict() that
        # reclaimed anything (eviction runs deep inside allocation)
        self.on_evict = None

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def chain_key(parent: int, chunk: Sequence[int]) -> int:
        return hash((parent, tuple(chunk)))

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # --------------------------------------------------------------- match
    def match(self, tokens: Sequence[int],
              max_tokens: Optional[int] = None,
              bump: bool = True) -> List[int]:
        """Physical blocks of the longest indexed prefix of ``tokens``
        (full blocks only), capped so at most ``max_tokens`` positions are
        reused; the engine caps at ``len(tokens) - 1`` so the last known
        token always runs through the forward pass.

        With ``bump=False`` the call is read-only: an admission gate that
        may not admit probes so, and calls ``bump`` and ``record`` only
        once the match is used, so that a queue head failing admission
        every step does not refresh the recency of entries nobody maps."""
        bs = self.block_size
        limit = len(tokens) if max_tokens is None else min(max_tokens,
                                                           len(tokens))
        t = self._tick() if bump else None
        out: List[int] = []
        parent = _ROOT
        for i in range(limit // bs):
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            e = self._entries.get(self.chain_key(parent, chunk))
            if e is None or e.parent != parent or e.tokens != chunk:
                break                      # miss (or hash collision): stop
            if bump:
                e.last_used = t
            out.append(e.block)
            parent = e.key
        return out

    def bump(self, tokens: Sequence[int], n_blocks: int):
        """LRU-touch the first ``n_blocks`` indexed chunks of ``tokens``:
        the deferred half of a ``match(..., bump=False)`` probe."""
        self.match(tokens, max_tokens=n_blocks * self.block_size)

    @classmethod
    def chain_keys(cls, tokens: Sequence[int], block_size: int,
                   n_blocks: int):
        """Yield the chain hash at each full-block depth ``1..n_blocks``
        of ``tokens``: the one traversal that match, commit and the
        engine's in-flight registry share."""
        parent = cls.ROOT
        for i in range(n_blocks):
            parent = cls.chain_key(
                parent, tuple(tokens[i * block_size:(i + 1) * block_size]))
            yield parent

    def record(self, n_matched_blocks: int):
        """Count one admission's match outcome in the hit/miss stats."""
        if n_matched_blocks > 0:
            self.hits += 1
            self.tokens_saved += n_matched_blocks * self.block_size
        else:
            self.misses += 1

    # -------------------------------------------------------------- commit
    def commit(self, tokens: Sequence[int], n_blocks: int,
               phys_blocks: Sequence[int]) -> int:
        """Index the first ``n_blocks`` full blocks of ``tokens``, backed by
        ``phys_blocks`` (the sequence's block table). Already-indexed
        chunks are LRU-bumped and keep their block: two sequences that
        prefill the same content concurrently converge on one entry, and
        the loser's block stays private to it. Returns the number of new
        entries (each takes one allocator ref)."""
        _, _, new = self.commit_incremental(tokens, 0, n_blocks, None,
                                            phys_blocks)
        return new

    def commit_incremental(self, tokens: Sequence[int], lo: int, hi: int,
                           parent: Optional[int],
                           phys_blocks: Sequence[int]):
        """Index chunks ``lo..hi-1``, continuing a chain whose hash at depth
        ``lo`` is ``parent`` (None: the root), so the engine commits each
        newly completed block in O(1). The caller keeps the returned
        ``(done, parent)`` cursor per request and resets it on preemption
        (a live request pins its own committed chain, so the cursor's
        parent entry is still present). Returns ``(done, parent,
        new_entries)``; ``done < hi`` only on a verified hash collision,
        where indexing stops."""
        bs = self.block_size
        assert hi * bs <= len(tokens) and hi <= len(phys_blocks)
        if parent is None:
            parent = _ROOT
        t = self._tick()
        new = 0
        done = lo
        for i in range(lo, hi):
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            key = self.chain_key(parent, chunk)
            e = self._entries.get(key)
            if e is not None and (e.parent != parent or e.tokens != chunk):
                break                      # hash collision: stop indexing
            if e is None:
                e = PrefixEntry(key, parent, chunk, int(phys_blocks[i]))
                self.allocator.incref(e.block)         # the index's own pin
                self._entries[key] = e
                if parent != _ROOT:
                    self._entries[parent].children += 1
                new += 1
            e.last_used = t
            parent = key
            done = i + 1
        return done, parent, new

    # ------------------------------------------------------------ eviction
    def _candidates(self) -> List[PrefixEntry]:
        """Leaf entries whose block only the index holds (refcount 1):
        evicting one returns exactly one block to the free list."""
        return [e for e in self._entries.values()
                if e.children == 0 and self.allocator.ref_count(e.block) == 1]

    def reclaimable(self) -> int:
        """Blocks eviction could free right now, by simulated leaf peeling
        (evicting a leaf can expose its parent as the next candidate)."""
        children = {k: e.children for k, e in self._entries.items()}
        live = set(self._entries)
        n = 0
        while True:
            leaves = [k for k in live
                      if children[k] == 0
                      and self.allocator.ref_count(self._entries[k].block) == 1]
            if not leaves:
                return n
            for k in leaves:
                live.discard(k)
                p = self._entries[k].parent
                if p in children:
                    children[p] -= 1
            n += len(leaves)

    def evict(self, n_blocks: int) -> int:
        """Reclaim up to ``n_blocks`` blocks, least-recently-used leaves
        first. Returns the blocks freed."""
        freed = 0
        while freed < n_blocks:
            cands = self._candidates()
            if not cands:
                break
            e = min(cands, key=lambda c: c.last_used)
            del self._entries[e.key]
            if e.parent in self._entries:
                self._entries[e.parent].children -= 1
            self.allocator.decref(e.block)             # refcount 1 -> freed
            self.evictions += 1
            freed += 1
        if freed and self.on_evict is not None:
            self.on_evict(freed)
        return freed

    # ------------------------------------------------------------- queries
    def blocks(self) -> List[int]:
        """Physical blocks currently pinned by the index."""
        return [e.block for e in self._entries.values()]

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "tokens_saved": self.tokens_saved,
                "evictions": self.evictions}

    # ----------------------------------------------------------- snapshot
    # The allocator's snapshot already holds the index's pins (one ref per
    # entry), so a restore must rebuild the entries with it, or those refs
    # would leak as blocks pinned for good. The hit, miss, saved-token and
    # eviction tallies are not part of it, as in the reference.
    def state_dict(self) -> dict:
        return {"block_size": self.block_size,
                "entries": [(e.key, e.parent, list(e.tokens), e.block,
                             e.last_used) for e in self._entries.values()],
                "clock": self._clock}

    @classmethod
    def from_state(cls, state: dict,
                   allocator: BlockAllocator) -> "PrefixIndex":
        idx = cls(state["block_size"], allocator)
        idx._clock = state["clock"]
        for key, parent, tokens, block, last_used in state["entries"]:
            idx._entries[key] = PrefixEntry(key, parent, tuple(tokens),
                                            block, last_used)
        for e in idx._entries.values():
            if e.parent in idx._entries:
                idx._entries[e.parent].children += 1
        return idx
