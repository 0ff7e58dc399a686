"""Per-sequence block tables over per-dp-row physical block pools (the
port's copy of ``repro.cache.paged``).

``PagedKVCache`` is the control plane of the paged cache: for each engine
slot it keeps the logical→physical block mapping and the number of mapped
blocks. The data plane, the ``[num_blocks, block_size, kv_slots, Dh]``
pools of every layer, is owned by the model; the manager only decides
which physical block backs each logical block.

Data parallelism pages per row: each of the ``dp`` rows owns its own
``BlockAllocator`` over ``num_blocks`` physical blocks (block 0 of every
row is that row's null block), and the engine slots partition into ``dp``
contiguous ranges of ``slots_per_row``: slot ``s`` belongs to row ``s //
slots_per_row``. Block-table entries are row-local ids. In the port each
rank holds only its own row's pool, so a row-local id indexes it directly;
``global_block`` gives the reference's pool-global id, ``row * num_blocks
+ local``.

With a row's ``prefix_indices`` entry (``PrefixIndex``) a block may be
mapped by several slots of that row and the index: ``assign_prefix`` and
``fork`` share blocks, ``copy_on_write`` privatizes one before a write and
returns the copies the data plane must make, ``truncate`` unmaps a
rejected speculative tail, and allocation under pressure first evicts the
row's unpinned cached blocks. Rows never evict each other.
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
                 max_blocks_per_seq: int, dp: int = 1):
        assert dp >= 1 and max_seqs % dp == 0, \
            f"max_seqs={max_seqs} must be divisible by dp={dp}"
        self.block_size = block_size
        self.max_seqs = max_seqs
        self.max_blocks_per_seq = max_blocks_per_seq
        self.dp = dp
        self.slots_per_row = max_seqs // dp
        # physical blocks of each row INCLUDING the row's null block
        self.num_blocks_per_row = num_blocks
        self.allocators: List[BlockAllocator] = [
            BlockAllocator(num_blocks) for _ in range(dp)]
        # logical block i of slot s lives in physical block table[s, i] of
        # row s // slots_per_row's pool (a row-local id); unmapped entries
        # point at the row's null block (0)
        self.table = np.zeros((max_seqs, max_blocks_per_seq), np.int32)
        self.n_mapped = np.zeros((max_seqs,), np.int32)
        # slots whose table rows changed since the last take_dirty(), so the
        # engine re-copies only those rows into its host mirror
        self._dirty: set = set()
        # when a row's entry is set, allocation pressure in that row first
        # evicts the index's unpinned cached-prefix blocks (leaf-first LRU)
        # before reporting OOM
        self.prefix_indices: List[Optional[PrefixIndex]] = [None] * dp

    # ------------------------------------------------------------ dp rows
    @property
    def num_blocks(self) -> int:
        """Physical blocks of one row's pool (the null block included)."""
        return self.num_blocks_per_row

    def row_of(self, seq: int) -> int:
        """The dp row that owns engine slot ``seq``."""
        return seq // self.slots_per_row

    def global_block(self, row: int, local_block: int) -> int:
        """The reference's pool-global id of ``local_block`` in ``row``."""
        return row * self.num_blocks_per_row + local_block

    @property
    def table3(self) -> np.ndarray:
        """``[dp, slots_per_row, nmax]`` view of the block tables (shares
        memory with the flat ``[max_seqs, nmax]`` table)."""
        return self.table.reshape(self.dp, self.slots_per_row,
                                  self.max_blocks_per_seq)

    # ----------------------------------------------------- dp=1 conveniences
    @property
    def allocator(self) -> BlockAllocator:
        """The single allocator of a dp=1 cache; under dp > 1 use
        ``allocators[row]``."""
        assert self.dp == 1, "kv.allocator is ambiguous under dp>1"
        return self.allocators[0]

    @property
    def prefix_index(self) -> Optional[PrefixIndex]:
        assert self.dp == 1, "kv.prefix_index is ambiguous under dp>1"
        return self.prefix_indices[0]

    @prefix_index.setter
    def prefix_index(self, idx: Optional[PrefixIndex]):
        assert self.dp == 1, "kv.prefix_index is ambiguous under dp>1"
        self.prefix_indices[0] = idx

    def take_dirty(self) -> set:
        """Slots whose tables changed since the last call (and clear)."""
        d, self._dirty = self._dirty, set()
        return d

    # ------------------------------------------------------------- queries
    @property
    def num_free_blocks(self) -> int:
        return sum(a.num_free for a in self.allocators)

    @property
    def num_used_blocks(self) -> int:
        return sum(a.num_used for a in self.allocators)

    def row_free_blocks(self, row: int) -> int:
        return self.allocators[row].num_free

    def can_allocate(self, n_tokens: int, cached_blocks=(),
                     row: int = 0) -> bool:
        """True when ``n_tokens`` worth of NEW blocks (less the
        ``cached_blocks`` a prefix match already covers) fits in ``row``'s
        free list plus what that row's prefix index's eviction could
        reclaim now.

        A matched block that only the index holds (refcount 1) is also in
        ``reclaimable()``, but mapping it pins it: it satisfies one needed
        block AND stops being evictable, so it is taken off the eviction
        credit."""
        need = blocks_for_tokens(n_tokens, self.block_size) \
            - len(cached_blocks)
        alloc = self.allocators[row]
        avail = alloc.num_free
        idx = self.prefix_indices[row]
        if idx is not None:
            matched_evictable = sum(
                1 for b in cached_blocks if alloc.ref_count(b) == 1)
            avail += max(idx.reclaimable() - matched_evictable, 0)
        return need <= avail

    def seq_blocks(self, seq: int) -> List[int]:
        """Row-local physical block ids mapped by ``seq``, in logical
        order."""
        return [int(b) for b in self.table[seq, :self.n_mapped[seq]]]

    # ------------------------------------------------------------ alloc/free
    def _alloc(self, n: int, row: int) -> List[int]:
        """Allocate ``n`` blocks from ``row``'s pool, evicting that row's
        unpinned cached-prefix blocks under pressure; raises BlockOOM like
        the allocator. Eviction runs only when it covers the whole
        shortfall, so a doomed allocation leaves the index untouched (a
        failed admission probe must not drain the prefix cache)."""
        alloc = self.allocators[row]
        idx = self.prefix_indices[row]
        short = n - alloc.num_free
        if short > 0 and idx is not None and idx.reclaimable() >= short:
            idx.evict(short)
        return alloc.alloc(n)

    def ensure(self, seq: int, n_tokens: int) -> bool:
        """Grow ``seq``'s table to cover ``n_tokens`` positions. Returns
        False (state unchanged) when its row's free list cannot satisfy
        it."""
        need = blocks_for_tokens(n_tokens, self.block_size)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"sequence needs {need} blocks > max_blocks_per_seq="
                f"{self.max_blocks_per_seq}")
        grow = need - int(self.n_mapped[seq])
        if grow <= 0:
            return True
        try:
            new = self._alloc(grow, self.row_of(seq))
        except BlockOOM:
            return False
        self.table[seq, self.n_mapped[seq]:need] = new
        self.n_mapped[seq] = need
        self._dirty.add(seq)
        return True

    def assign_prefix(self, seq: int, blocks: Sequence[int]):
        """Map cached prefix blocks (row-local ids from the row's
        ``PrefixIndex.match``) into an empty slot's table, taking one
        reference per block. The sequence then prefills from
        ``len(blocks) * block_size``."""
        assert self.n_mapped[seq] == 0, "prefix assignment into a mapped slot"
        assert BlockAllocator.NULL_BLOCK not in blocks
        alloc = self.allocators[self.row_of(seq)]
        for b in blocks:
            alloc.incref(b)
        n = len(blocks)
        self.table[seq, :n] = np.asarray(blocks, np.int32)
        self.n_mapped[seq] = n
        if n:
            self._dirty.add(seq)

    def copy_on_write(self, seq: int, start_tok: int,
                      end_tok: int) -> Tuple[bool, List[Tuple[int, int]]]:
        """Make the mapped blocks covering positions ``[start_tok,
        end_tok)`` exclusively owned before a write: each block there with
        refcount > 1 is remapped to a fresh block of the slot's row.
        Returns ``(ok, copies)``, ``copies`` the [(src, dst), ...] block
        copies in row-local ids (the row is ``row_of(seq)``), which the
        rank holding that row's pool must apply BEFORE the write lands. On
        OOM returns ``(False, [])`` with the table unchanged."""
        if end_tok <= start_tok:
            return True, []
        row = self.row_of(seq)
        alloc = self.allocators[row]
        first = start_tok // self.block_size
        last = min((end_tok - 1) // self.block_size,
                   int(self.n_mapped[seq]) - 1)
        shared = [i for i in range(first, last + 1)
                  if alloc.ref_count(int(self.table[seq, i])) > 1]
        if not shared:
            return True, []
        try:
            fresh = self._alloc(len(shared), row)
        except BlockOOM:
            return False, []
        copies = []
        for i, dst in zip(shared, fresh):
            src = int(self.table[seq, i])
            alloc.decref(src)              # shared: decrements, never frees
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
        self.allocators[self.row_of(seq)].free(blocks)
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
        self.allocators[self.row_of(seq)].free(tail)
        self.table[seq, keep:cur] = BlockAllocator.NULL_BLOCK
        self.n_mapped[seq] = keep
        self._dirty.add(seq)
        return cur - keep

    def fork(self, src: int, dst: int):
        """Share ``src``'s blocks into ``dst`` (ref-counted). Writes into
        ``dst`` must go through ``copy_on_write`` first. Both slots must
        live in one dp row: physical blocks never cross rows."""
        assert src != dst, "fork onto itself"
        assert self.row_of(src) == self.row_of(dst), \
            "fork across dp rows: blocks are row-physical"
        assert self.n_mapped[dst] == 0, "fork into a mapped slot"
        # dst's table must be all-null, not just n_mapped == 0: stale ids
        # past n_mapped would alias freed blocks after a later ensure()
        assert (self.table[dst] == BlockAllocator.NULL_BLOCK).all(), \
            f"slot {dst} table not cleared before fork"
        alloc = self.allocators[self.row_of(src)]
        for b in self.seq_blocks(src):
            alloc.incref(b)
        n = int(self.n_mapped[src])
        self.table[dst, :n] = self.table[src, :n]
        self.n_mapped[dst] = n
        self._dirty.add(dst)

    # ----------------------------------------------------------- snapshot
    def state_dict(self) -> dict:
        """The control plane as the reference snapshots it: the block
        tables and every row's allocator (the indexes snapshot
        themselves)."""
        return {"block_size": self.block_size,
                "max_blocks_per_seq": self.max_blocks_per_seq,
                "dp": self.dp,
                "table": self.table.copy(),
                "n_mapped": self.n_mapped.copy(),
                "allocators": [a.state_dict() for a in self.allocators]}

    @classmethod
    def from_state(cls, state: dict) -> "PagedKVCache":
        """The manager of ``state_dict()`` (tables as arrays or, after a
        JSON round trip, lists), with every slot marked dirty so that the
        engine's host mirror of the tables is rebuilt. A state without
        ``dp`` and with a single ``allocator`` loads as one row, as the
        reference's pre-dp snapshots do."""
        alloc_states = state.get("allocators") or [state["allocator"]]
        table = np.array(state["table"], np.int32)
        kv = cls(alloc_states[0]["num_blocks"], state["block_size"],
                 table.shape[0], state["max_blocks_per_seq"],
                 dp=state.get("dp", 1))
        kv.table = table
        kv.n_mapped = np.array(state["n_mapped"], np.int32)
        kv.allocators = [BlockAllocator.from_state(s) for s in alloc_states]
        kv._dirty = set(range(kv.table.shape[0]))
        return kv
