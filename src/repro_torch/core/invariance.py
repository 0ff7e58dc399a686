"""KV-cache invariance (counterpart of ``repro.core.invariance``; paper
§3.3.1, Fig. 6).

In the base config (SP = s, TP = t) the process at grid position (sp rank
i, tp rank j), rank ``i*t + j``, owns head sub-block ``j*s + i`` after the
Ulysses all-to-all; the shift config (TP = s·t) numbers its tp ranks in
that same order, so every rank owns the same KV head slots in both and a
switch moves no byte. The reference proves it on the shardings of its
global arrays; in the port each rank holds its own pool, and
``verify_paged_invariance`` checks it on that rank's tensors.
"""
from __future__ import annotations

from typing import Sequence

import torch


def head_order_base(sp: int, tp: int):
    """Process rank (``i*tp + j``) that owns each head sub-block in the
    base config. The paper's example (sp=3, tp=2) -> [0, 2, 4, 1, 3, 5]."""
    order = [0] * (sp * tp)
    for i in range(sp):
        for j in range(tp):
            order[j * sp + i] = i * tp + j
    return order


def head_order_shift(sp: int, tp: int):
    """Rank order the shift config traverses to load weight shards so that
    rank g gets the heads it owns in the base config: the paper's SP_TP
    group (e.g. [[0, 2, 4, 1, 3, 5]])."""
    return head_order_base(sp, tp)


def kv_slots(model, rank: int) -> range:
    """The global KV head slots that ``model``'s pool holds on ``rank``:
    its tp rank's slots in the shift config, its model rank's in the base
    config (after the all-to-all)."""
    lay, plan = model.lay, model.plan
    g = lay.tp_rank(rank) if lay.sp == 1 else lay.model_rank(rank)
    return range(g * plan.kv_per_rank, (g + 1) * plan.kv_per_rank)


def snapshot_blocks(pool, blocks: Sequence[int]):
    """Copies of the listed physical blocks of every layer's K and V pool,
    for ``verify_paged_invariance``."""
    idx = torch.as_tensor(list(blocks), dtype=torch.long, device=pool.k.device)
    return pool.k[:, idx].clone(), pool.v[:, idx].clone()


def verify_paged_invariance(base, shift, rank: int,
                            shared_blocks: Sequence[int] = (),
                            before=None) -> bool:
    """The paged §3.3.1 check on one rank, for its ``base`` and ``shift``
    models:

    1. both step the same pool tensors (equal ``data_ptr`` of K and V), so
       a switch moves no byte and follows one block table;
    2. the rank owns the same KV head slots in both configs;
    3. with ``before`` (``snapshot_blocks`` of ``shared_blocks``), those
       blocks are bitwise unchanged in the pool."""
    a, b = base.pool, shift.pool
    if a is None or b is None or a.k.data_ptr() != b.k.data_ptr() \
            or a.v.data_ptr() != b.v.data_ptr():
        return False
    if kv_slots(base, rank) != kv_slots(shift, rank):
        return False
    if before is not None:
        now = snapshot_blocks(a, shared_blocks)
        return all(torch.equal(x, y) for x, y in zip(now, before))
    return True
