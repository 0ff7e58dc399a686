"""Free-list allocator for physical KV blocks (the port's copy of
``repro.cache.block_allocator``).

Blocks are ref-counted: a prefix-cache entry and every sequence that maps a
block each hold one reference, so a shared block is decremented, never
freed, until its last holder lets go.

Physical block 0 is reserved as the *null block*: unallocated block-table
entries point at it, and padding rows and columns of a batch scatter their
garbage KV there. It is never handed out, so a stray write through a
padding entry can never corrupt a live sequence.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List


class BlockOOM(Exception):
    """Raised when an allocation cannot be satisfied from the free list."""


class BlockAllocator:
    NULL_BLOCK = 0

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least the null block plus one")
        self.num_blocks = num_blocks
        self._free = deque(range(1, num_blocks))
        self._refs: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return len(self._refs)

    def ref_count(self, block: int) -> int:
        return self._refs.get(block, 0)

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise BlockOOM(f"need {n} blocks, {len(self._free)} free")
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def incref(self, block: int):
        # the null block is never allocated, so it must never be
        # ref-counted: a stray incref/decref would eventually push it onto
        # the free list and hand the garbage sink out as a real block
        assert block != self.NULL_BLOCK, "refcounting the null block"
        assert block in self._refs, f"incref of unallocated block {block}"
        self._refs[block] += 1

    def decref(self, block: int):
        assert block != self.NULL_BLOCK, "refcounting the null block"
        assert block in self._refs, f"double free of block {block}"
        self._refs[block] -= 1
        if self._refs[block] == 0:
            del self._refs[block]
            self._free.append(block)

    def free(self, blocks: List[int]):
        for b in blocks:
            self.decref(b)

    # ----------------------------------------------------------- snapshot
    def state_dict(self) -> dict:
        return {"num_blocks": self.num_blocks, "free": list(self._free),
                "refs": dict(self._refs)}

    @classmethod
    def from_state(cls, state: dict) -> "BlockAllocator":
        """The allocator of ``state_dict()``; also of its JSON round trip
        (whose ``refs`` keys are strings)."""
        a = cls(state["num_blocks"])
        a._free = deque(int(b) for b in state["free"])
        a._refs = {int(b): int(n) for b, n in state["refs"].items()}
        return a
