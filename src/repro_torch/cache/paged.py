"""Per-sequence block tables over one physical block pool (the port's copy
of ``repro.cache.paged`` for one data-parallel row and no prefix index).

``PagedKVCache`` is the control plane of the paged cache: for each engine
slot it keeps the logical→physical block mapping and the number of mapped
blocks. The data plane, the ``[num_blocks, block_size, kv_slots, Dh]``
pools of every layer, is owned by the model; the manager only decides
which physical block backs each logical block.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .block_allocator import BlockAllocator, BlockOOM


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

    def take_dirty(self) -> set:
        """Slots whose tables changed since the last call (and clear)."""
        d, self._dirty = self._dirty, set()
        return d

    @property
    def num_free_blocks(self) -> int:
        return self.allocator.num_free

    def can_allocate(self, n_tokens: int) -> bool:
        """True when ``n_tokens`` worth of new blocks fits in the free list."""
        return blocks_for_tokens(n_tokens, self.block_size) \
            <= self.allocator.num_free

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
            new = self.allocator.alloc(grow)
        except BlockOOM:
            return False
        self.table[seq, self.n_mapped[seq]:need] = new
        self.n_mapped[seq] = need
        self._dirty.add(seq)
        return True

    def free_seq(self, seq: int):
        blocks = self.seq_blocks(seq)
        # a mapped entry is never the null block, so freeing a slot can
        # never decref block 0
        assert BlockAllocator.NULL_BLOCK not in blocks, \
            f"slot {seq} maps the null block: table corrupt"
        self.allocator.free(blocks)
        self.table[seq, :] = BlockAllocator.NULL_BLOCK
        self.n_mapped[seq] = 0
        self._dirty.add(seq)
