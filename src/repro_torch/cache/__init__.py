"""Paged KV-cache control plane (host side, numpy only)."""
from .block_allocator import BlockAllocator, BlockOOM
from .paged import PagedKVCache, blocks_for_tokens, pow2_bucket

__all__ = ["BlockAllocator", "BlockOOM", "PagedKVCache",
           "blocks_for_tokens", "pow2_bucket"]
