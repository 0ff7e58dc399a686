"""KV-cache invariance (counterpart of ``repro.core.invariance``; paper
§3.3.1, Fig. 6).

In the base config (SP = s, TP = t) the process at grid position (sp rank
i, tp rank j), rank ``i*t + j``, owns head sub-block ``j*s + i`` after the
Ulysses all-to-all; the shift config (TP = s·t) numbers its tp ranks in
that same order, so every rank owns the same KV head slots in both and a
switch moves no byte. The reference proves it on the shardings of its
global arrays; in the port each rank holds its own pool or dense cache,
and ``verify_paged_invariance`` and ``verify_dense_invariance`` check it
on that rank's tensors. The dense cache's SSD state is sharded over the
heads as the KV cache over its slots (the reference's ``ssd_state_specs``
and ``verify_invariance`` on them), so the same holds for its heads; a
local layer's ring holds the KV cache's slots, and an RG-LRU layer's
state is sharded over its channels as the heads (``rglru_state_specs``,
``rglru_channels``), and a decoder layer's cross cache holds the encoder's
frames at the KV cache's slots (the reference's ``cache_specs`` for
``cross``). An MLA config's latent cache has no heads: it is sharded over the
sequence on the grid's sp (``mla_cache_specs``' ``P(dp, cache_sp,
None)``), and a rank holds the same chunk of it in both configs
(``latent_chunk``).

With dp rows the check also runs per row (the reference's ``dp_axes``
form, ``dp_rows_aligned``): each rank holds one row's pool, and every
table entry of a row's slots must be a row-local id of that pool, so no
row's table reaches another row's blocks.
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


def _head_block(model, rank: int) -> int:
    """The head sub-block ``model`` steps on ``rank``: its tp rank's in the
    shift config, its model rank's in the base config (after the
    all-to-all)."""
    lay = model.lay
    return lay.tp_rank(rank) if lay.sp == 1 else lay.model_rank(rank)


def kv_slots(model, rank: int) -> range:
    """The global KV head slots that ``model``'s cache holds on ``rank``."""
    g, n = _head_block(model, rank), model.plan.kv_per_rank
    return range(g * n, (g + 1) * n)


def ssd_heads(model, rank: int) -> range:
    """The global SSD heads (padded) that ``model``'s dense cache holds on
    ``rank``; empty for a config without SSD layers."""
    from repro_torch.models.ssd import ssd_plan
    if model.cfg.ssm is None:
        return range(0)
    n = ssd_plan(model.cfg, model.lay).h_q_pad // max(model.lay.G, 1)
    g = _head_block(model, rank)
    return range(g * n, (g + 1) * n)


def rglru_channels(model, rank: int) -> range:
    """The global RG-LRU channels that ``model``'s dense cache holds on
    ``rank`` (the contiguous channels of its head sub-block); empty for a
    config without RG-LRU layers."""
    if model.cfg.rglru is None:
        return range(0)
    n = model.cfg.rglru.width(model.cfg.d_model) // max(model.lay.G, 1)
    g = _head_block(model, rank)
    return range(g * n, (g + 1) * n)


def latent_chunk(model, rank: int) -> range:
    """The global sequence positions of the latent cache that ``model``'s
    dense cache holds on ``rank`` (its grid sp rank's contiguous chunk);
    empty for a config without MLA or before ``init_cache``."""
    if model.cfg.mla is None or model.cache is None \
            or model.cache.lat is None:
        return range(0)
    n = model.cache.lat.shape[2]
    i = model.lay.axes_index(model.lay.cache_sp_axes, rank)
    return range(i * n, (i + 1) * n)


def snapshot_dense(cache):
    """Copies of every tensor of a dense cache, by name, for
    ``verify_dense_invariance``."""
    return {name: t.clone() for name, t in cache.tensors().items()}


def snapshot_blocks(pool, blocks: Sequence[int]):
    """Copies of the listed physical blocks of every layer's K and V pool,
    for ``verify_paged_invariance``."""
    idx = torch.as_tensor(list(blocks), dtype=torch.long, device=pool.k.device)
    return pool.k[:, idx].clone(), pool.v[:, idx].clone()


def dp_rows_aligned(kv, pool) -> bool:
    """Per-row alignment of tables and pools: ``pool`` (this rank's) is
    one row's pool of ``kv.num_blocks_per_row`` blocks, and every table
    entry of every row's slots (``kv.table3``) is a row-local id below
    that count, so each row's table indexes exactly its own pool and never
    another row's blocks (a pool-global id, ``row * num_blocks + local``,
    fails this)."""
    nb = kv.num_blocks_per_row
    return (pool.k.shape[1] == pool.v.shape[1] == nb
            and bool(((kv.table3 >= 0) & (kv.table3 < nb)).all()))


def verify_paged_invariance(base, shift, rank: int,
                            shared_blocks: Sequence[int] = (),
                            before=None, kv=None) -> bool:
    """The paged §3.3.1 check on one rank, for its ``base`` and ``shift``
    models:

    1. both step the same pool tensors (equal ``data_ptr`` of K and V), so
       a switch moves no byte and follows one block table;
    2. the rank owns the same KV head slots in both configs;
    3. with ``kv`` (the engine's ``PagedKVCache``), its rows are the
       layout's dp rows and ``dp_rows_aligned`` holds for this rank's pool;
    4. with ``before`` (``snapshot_blocks`` of ``shared_blocks``, row-local
       ids of this rank's row), those blocks are bitwise unchanged in the
       pool."""
    a, b = base.pool, shift.pool
    if a is None or b is None or a.k.data_ptr() != b.k.data_ptr() \
            or a.v.data_ptr() != b.v.data_ptr():
        return False
    if kv_slots(base, rank) != kv_slots(shift, rank):
        return False
    if kv is not None and (kv.dp != base.lay.dp
                           or not dp_rows_aligned(kv, a)):
        return False
    if before is not None:
        now = snapshot_blocks(a, shared_blocks)
        return all(torch.equal(x, y) for x, y in zip(now, before))
    return True


def verify_dense_invariance(base, shift, rank: int) -> bool:
    """The §3.3.1 check of the dense cache on one rank, for its ``base``
    and ``shift`` models:

    1. both step the same cache tensors (equal ``data_ptr`` of every KV,
       cross KV and recurrent state tensor), so a switch moves no byte;
    2. the rank owns the same KV head slots (of the global, the ring and
       the cross caches: a cross cache holds ``kv_per_rank`` slots, those
       of the KV cache), the same SSD heads, the same RG-LRU channels and
       the same chunk of an MLA latent cache in both configs."""
    a, b = base.cache, shift.cache
    if a is None or b is None:
        return False
    ta, tb = a.tensors(), b.tensors()
    if set(ta) != set(tb) or any(ta[n].data_ptr() != tb[n].data_ptr()
                                 for n in ta):
        return False
    if any(ta[n].shape[3] != m.plan.kv_per_rank for n in ("cross_k",
                                                          "cross_v")
           if n in ta for m in (base, shift)):
        return False
    return (kv_slots(base, rank) == kv_slots(shift, rank)
            and ssd_heads(base, rank) == ssd_heads(shift, rank)
            and rglru_channels(base, rank) == rglru_channels(shift, rank)
            and latent_chunk(base, rank) == latent_chunk(shift, rank))
