"""Per-sequence block tables over one physical block pool (the port's copy
of ``repro.cache.paged`` for one data-parallel row).

``PagedKVCache`` is the control plane of the paged cache: for each engine
slot it keeps the logical→physical block mapping and the number of mapped
blocks. The data plane, the ``[num_blocks, block_size, kv_slots, Dh]``
pools of every layer, is owned by the model; the manager only decides
which physical block backs each logical block. With a ``prefix_index``
(``PrefixIndex``) a block may be mapped by several slots and the index:
``assign_prefix`` and ``fork`` share blocks, ``copy_on_write`` privatizes
one before a write and returns the copies the data plane must make,
``truncate`` unmaps a rejected speculative tail, and allocation under
pressure first evicts unpinned cached blocks.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .block_allocator import BlockAllocator, BlockOOM
from .prefix_index import PrefixIndex


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Physical blocks needed to hold ``n_tokens`` cache entries (ceil)."""
    return -(-max(n_tokens, 0) // block_size)


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n: the engine's shape-bucketing rule."""
    p = 1
    while p < n:
        p <<= 1
    return p


class PagedKVCache:
    def __init__(self, num_blocks: int, block_size: int, max_seqs: int,
                 max_blocks_per_seq: int):
        self.block_size = block_size
        self.max_seqs = max_seqs
        self.max_blocks_per_seq = max_blocks_per_seq
        # physical blocks INCLUDING the null block
        self.num_blocks = num_blocks
        self.allocator = BlockAllocator(num_blocks)
        # logical block i of slot s lives in physical block table[s, i];
        # unmapped entries point at the null block (0)
        self.table = np.zeros((max_seqs, max_blocks_per_seq), np.int32)
        self.n_mapped = np.zeros((max_seqs,), np.int32)
        # slots whose table rows changed since the last take_dirty(), so the
        # engine re-copies only those rows into its host mirror
        self._dirty: set = set()
        # when set, allocation pressure first evicts the index's unpinned
        # cached-prefix blocks (leaf-first LRU) before reporting OOM
        self.prefix_index: Optional[PrefixIndex] = None

    def take_dirty(self) -> set:
        """Slots whose tables changed since the last call (and clear)."""
        d, self._dirty = self._dirty, set()
        return d

    @property
    def num_free_blocks(self) -> int:
        return self.allocator.num_free

    @property
    def num_used_blocks(self) -> int:
        return self.allocator.num_used

    def can_allocate(self, n_tokens: int, cached_blocks=()) -> bool:
        """True when ``n_tokens`` worth of NEW blocks (less the
        ``cached_blocks`` a prefix match already covers) fits in the free
        list plus what the prefix index's eviction could reclaim now.

        A matched block that only the index holds (refcount 1) is also in
        ``reclaimable()``, but mapping it pins it: it satisfies one needed
        block AND stops being evictable, so it is taken off the eviction
        credit."""
        need = blocks_for_tokens(n_tokens, self.block_size) \
            - len(cached_blocks)
        avail = self.allocator.num_free
        if self.prefix_index is not None:
            matched_evictable = sum(
                1 for b in cached_blocks if self.allocator.ref_count(b) == 1)
            avail += max(self.prefix_index.reclaimable()
                         - matched_evictable, 0)
        return need <= avail

    def seq_blocks(self, seq: int) -> List[int]:
        """Physical block ids mapped by ``seq``, in logical order."""
        return [int(b) for b in self.table[seq, :self.n_mapped[seq]]]

    def ensure(self, seq: int, n_tokens: int) -> bool:
        """Grow ``seq``'s table to cover ``n_tokens`` positions. Returns
        False (state unchanged) when the free list cannot satisfy it."""
        need = blocks_for_tokens(n_tokens, self.block_size)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"sequence needs {need} blocks > max_blocks_per_seq="
                f"{self.max_blocks_per_seq}")
        grow = need - int(self.n_mapped[seq])
        if grow <= 0:
            return True
        try:
            new = self._alloc(grow)
        except BlockOOM:
            return False
        self.table[seq, self.n_mapped[seq]:need] = new
        self.n_mapped[seq] = need
        self._dirty.add(seq)
        return True

    def _alloc(self, n: int) -> List[int]:
        """Allocate ``n`` blocks, evicting unpinned cached-prefix blocks
        under pressure; raises BlockOOM like the allocator. Eviction runs
        only when it covers the whole shortfall, so a doomed allocation
        leaves the index untouched (a failed admission probe must not drain
        the prefix cache)."""
        idx = self.prefix_index
        short = n - self.allocator.num_free
        if short > 0 and idx is not None and idx.reclaimable() >= short:
            idx.evict(short)
        return self.allocator.alloc(n)

    def assign_prefix(self, seq: int, blocks: Sequence[int]):
        """Map cached prefix blocks (from ``PrefixIndex.match``) into an
        empty slot's table, taking one reference per block. The sequence
        then prefills from ``len(blocks) * block_size``."""
        assert self.n_mapped[seq] == 0, "prefix assignment into a mapped slot"
        assert BlockAllocator.NULL_BLOCK not in blocks
        for b in blocks:
            self.allocator.incref(b)
        n = len(blocks)
        self.table[seq, :n] = np.asarray(blocks, np.int32)
        self.n_mapped[seq] = n
        if n:
            self._dirty.add(seq)

    def copy_on_write(self, seq: int, start_tok: int,
                      end_tok: int) -> Tuple[bool, List[Tuple[int, int]]]:
        """Make the mapped blocks covering positions ``[start_tok,
        end_tok)`` exclusively owned before a write: each block there with
        refcount > 1 is remapped to a fresh block. Returns ``(ok,
        copies)``, ``copies`` the [(src, dst), ...] block copies the caller
        must apply to the device pool BEFORE the write lands. On OOM
        returns ``(False, [])`` with the table unchanged."""
        if end_tok <= start_tok:
            return True, []
        first = start_tok // self.block_size
        last = min((end_tok - 1) // self.block_size,
                   int(self.n_mapped[seq]) - 1)
        shared = [i for i in range(first, last + 1)
                  if self.allocator.ref_count(int(self.table[seq, i])) > 1]
        if not shared:
            return True, []
        try:
            fresh = self._alloc(len(shared))
        except BlockOOM:
            return False, []
        copies = []
        for i, dst in zip(shared, fresh):
            src = int(self.table[seq, i])
            self.allocator.decref(src)     # shared: decrements, never frees
            self.table[seq, i] = dst
            copies.append((src, dst))
        self._dirty.add(seq)
        return True, copies

    def free_seq(self, seq: int):
        blocks = self.seq_blocks(seq)
        # a mapped entry is never the null block, so freeing a slot can
        # never decref block 0; shared blocks (prefix pins, forked tables)
        # are decremented here, not freed
        assert BlockAllocator.NULL_BLOCK not in blocks, \
            f"slot {seq} maps the null block: table corrupt"
        self.allocator.free(blocks)
        self.table[seq, :] = BlockAllocator.NULL_BLOCK
        self.n_mapped[seq] = 0
        self._dirty.add(seq)

    def truncate(self, seq: int, n_tokens: int) -> int:
        """Unmap ``seq``'s tail blocks beyond ``n_tokens`` coverage: the
        speculative verify's rollback. Rejected draft KV inside kept blocks
        needs no data-plane work (the context length masks it, and later
        steps overwrite it); blocks wholly past the accepted length are
        released (decrement-not-free, as ``free_seq``). Returns the number
        of table entries unmapped."""
        keep = blocks_for_tokens(n_tokens, self.block_size)
        cur = int(self.n_mapped[seq])
        if keep >= cur:
            return 0
        tail = [int(b) for b in self.table[seq, keep:cur]]
        assert BlockAllocator.NULL_BLOCK not in tail, \
            f"slot {seq} maps the null block: table corrupt"
        self.allocator.free(tail)
        self.table[seq, keep:cur] = BlockAllocator.NULL_BLOCK
        self.n_mapped[seq] = keep
        self._dirty.add(seq)
        return cur - keep

    def fork(self, src: int, dst: int):
        """Share ``src``'s blocks into ``dst`` (ref-counted). Writes into
        ``dst`` must go through ``copy_on_write`` first."""
        assert src != dst, "fork onto itself"
        assert self.n_mapped[dst] == 0, "fork into a mapped slot"
        # dst's table must be all-null, not just n_mapped == 0: stale ids
        # past n_mapped would alias freed blocks after a later ensure()
        assert (self.table[dst] == BlockAllocator.NULL_BLOCK).all(), \
            f"slot {dst} table not cleared before fork"
        for b in self.seq_blocks(src):
            self.allocator.incref(b)
        n = int(self.n_mapped[src])
        self.table[dst, :n] = self.table[src, :n]
        self.n_mapped[dst] = n
        self._dirty.add(dst)
