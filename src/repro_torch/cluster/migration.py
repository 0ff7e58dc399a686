"""Typed block-granular transfer plans for live request migration (the
port's verbatim copy of ``repro.cluster.migration``).

A migration moves one mid-decode request between two ``ShiftEngine``
replicas without recomputing its KV: the Router extracts the committed
blocks on the source, admits the request on the destination, copies the
payload, then releases the source (decrement-not-free). This module is
the *description* of that move — a tuple of frozen :class:`TransferOp`
records, one ``state`` op for the request bookkeeping plus one
``kv_block`` op per physical block — so tests and the obs dump can audit
exactly what crossed the wire instead of trusting an opaque copy.

The ops are pure data: building a plan touches neither engine. The
Router applies the data plane itself (``write_blocks``) and appends the
plan to its ``transfer_log`` only after the copy landed, which is what
makes a logged plan a statement of fact rather than intent.

Block ids in a plan are the reference's pool-global ids
(``PagedKVCache.global_block(row, b)``, ``row * num_blocks_per_row + b``),
so that a plan compares with ``==`` against the reference's. They differ
from the row-local ids the port's own data plane takes (block tables,
``copy_on_write``'s pairs, ``Model.copy_blocks``): a rank holds only its
row's pool, so the engine turns a plan's ids back into row-local ones
before it reads or writes a block.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class TransferOp:
    """One unit of a migration plan.

    ``kind`` is ``"state"`` (the request's scheduler-side bookkeeping:
    prompt, generated tokens, prefill cursor, retry/fault counters) or
    ``"kv_block"`` (one physical KV block). Block ops carry the
    pool-global source and destination block ids, the logical block
    ordinal within the request (``0..n_blocks-1``), and how many of the
    block's token positions hold committed KV (``tokens`` — only the
    last block can be partial).
    """
    kind: str                       # "state" | "kv_block"
    rid: int
    src_replica: int
    dst_replica: int
    src_block: Optional[int] = None  # pool-global id on the source
    dst_block: Optional[int] = None  # pool-global id on the destination
    logical: Optional[int] = None    # block ordinal within the request
    tokens: int = 0                  # committed token positions covered

    def __post_init__(self):
        if self.kind not in ("state", "kv_block"):
            raise ValueError(f"unknown TransferOp kind {self.kind!r}")
        if self.kind == "kv_block" and (self.src_block is None
                                        or self.dst_block is None
                                        or self.logical is None):
            raise ValueError("kv_block ops need src/dst/logical ids")


def build_transfer_plan(export: dict, dst_blocks, src_replica: int,
                        dst_replica: int) -> Tuple[TransferOp, ...]:
    """Typed plan for moving ``export`` (an ``extract_request`` dict) into
    the destination blocks ``dst_blocks`` (pool-global ids returned by
    ``admit_migrated``). One ``state`` op first, then one ``kv_block`` op
    per block in logical order."""
    state = export["state"]
    src_blocks = export["src_blocks"]
    if len(src_blocks) != len(dst_blocks):
        raise ValueError(
            f"rid {state['rid']}: source has {len(src_blocks)} blocks but "
            f"destination allocated {len(dst_blocks)}")
    rid = state["rid"]
    bs = export["block_size"]
    committed = state["prefilled"]
    ops = [TransferOp("state", rid, src_replica, dst_replica,
                      tokens=committed)]
    for i, (src, dst) in enumerate(zip(src_blocks, dst_blocks)):
        covered = max(0, min(bs, committed - i * bs))
        ops.append(TransferOp("kv_block", rid, src_replica, dst_replica,
                              src_block=int(src), dst_block=int(dst),
                              logical=i, tokens=covered))
    return tuple(ops)
