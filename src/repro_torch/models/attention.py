"""GQA attention under combined (SP, TP) (counterpart of
``repro.models.attention``): the QKV projection (TP column parallel), the
fused Ulysses all-to-all into head parallelism in the base config, the
per-head q/k norm and RoPE, the in-place KV write into the dense contiguous
cache or through the block table into the paged pool, the attention
kernels, the all-to-all back, and the O projection (row parallel) with its
TP psum.

Each rank holds its tp rank's weight columns and its own slice of the KV
pool, ``[num_blocks, bs, kv_per_rank, Dh]``: the kv slots of its model rank
in the base config (after the all-to-all) and of its tp rank in the shift
config, which are the same slots (``core.invariance``). The serialized and
dense paths run only the trivial layout (``Model`` refuses them above
world size 1).

Only global causal attention with RoPE and no logit soft cap is ported:
no config of the port has sliding windows, soft caps or rope-free layers
(local, gemma and whisper layers bring them later), so the dense paths
raise on them."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.ulysses import (expand_kv_for_send,
                                      ulysses_gather_heads,
                                      ulysses_scatter_heads)
from repro_torch.kernels import ops as K
from repro_torch.parallel import HeadPlan, Layout, Shard, plan_heads
from repro_torch.parallel.collectives import psum_if
from .layers import (apply_rope, dense_init, empty_param, rmsnorm_pair,
                     shard_of)


def get_plan(cfg, lay: Layout) -> HeadPlan:
    return plan_heads(cfg.num_heads, cfg.num_kv_heads, max(lay.G, 1),
                      max(lay.tp, 1))


def kv_exp_slots(plan: HeadPlan, lay: Layout) -> int:
    """KV head slots materialized in this layout's weights."""
    return max(plan.h_kv_pad, max(lay.tp, 1))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def _place(canon, slot_map):
    """Scatter canonical per-head tensors into the padded slot layout (axis
    -2 holds heads); pad slots (orig == -1) become zeros, as the
    reference's ``_place`` multiplies them by 0."""
    idx = torch.as_tensor([max(s, 0) for s in slot_map], device=canon.device)
    ok = torch.as_tensor([1.0 if s >= 0 else 0.0 for s in slot_map],
                         dtype=canon.dtype, device=canon.device)
    return canon.index_select(canon.dim() - 2, idx) * ok[:, None]


def attn_layout(name: str, canon, cfg, lay: Layout, tp_rank: int):
    """This tp rank's part of attention parameter ``name`` from its
    canonical tensor (``attn_init``'s draws, heads on axis -2: wq/wk/wv
    [d, h, dh], wo [h, dh·d], biases [h, dh]): placed into the padded head slots,
    the kv slots repeated into the layout's expanded slots, flattened to
    the parameter's [in, out] shape, and sliced to the rank's columns (rows
    for wo). On the trivial layout it is the canonical tensor, flattened."""
    plan = get_plan(cfg, lay)
    tp = max(lay.tp, 1)
    if name in ("wq", "bq", "wo"):
        t = _place(canon, plan.q_slot_to_orig)
    else:
        r = kv_exp_slots(plan, lay) // plan.h_kv_pad
        t = _place(canon, plan.kv_slot_to_orig).repeat_interleave(
            r, dim=canon.dim() - 2)
    if name == "wo":
        return shard_of(t.reshape(-1, cfg.d_model), 0, tp, tp_rank)
    if name.startswith("w"):
        return shard_of(t.reshape(t.shape[0], -1), 1, tp, tp_rank)
    return shard_of(t.reshape(-1), 0, tp, tp_rank)


class Attention(nn.Module):
    """Parameters of one attention layer, this tp rank's part of
    ``attn_init``'s: wq [d, h_q_pad/tp·dh], wk and wv [d, kexp/tp·dh] with
    ``kexp`` the layout's expanded kv slots (``h_kv_exp_base`` in the base
    config, ``kv_slots_total`` in the shift config), wo row-sharded
    [h_q_pad/tp·dh, d]. On the trivial layout the head plan has no pad
    slots and no KV replication, so the weights hold exactly the model's
    heads."""

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        super().__init__()
        self.cfg = cfg
        self.shard = shard or Shard(lay)
        self.plan = plan = get_plan(cfg, lay)
        tp = max(lay.tp, 1)
        d, dh = cfg.d_model, cfg.head_dim
        hq, hkv = plan.h_q_pad // tp, kv_exp_slots(plan, lay) // tp
        self.wq = empty_param((d, hq * dh), dtype, device)
        self.wk = empty_param((d, hkv * dh), dtype, device)
        self.wv = empty_param((d, hkv * dh), dtype, device)
        self.wo = empty_param((hq * dh, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = empty_param((hq * dh,), dtype, device)
            self.bk = empty_param((hkv * dh,), dtype, device)
            self.bv = empty_param((hkv * dh,), dtype, device)
        if cfg.qk_norm:
            self.q_norm = empty_param((dh,), dtype, device)
            self.k_norm = empty_param((dh,), dtype, device)
        # the q slots this rank attends after the exchange: their pad mask,
        # or None when none of them is a pad slot
        g = self.shard.model_rank
        local = plan.q_mask()[g * plan.q_per_rank:(g + 1) * plan.q_per_rank]
        self.q_mask = (None if local.all() else torch.as_tensor(
            local, dtype=dtype, device=device))

    def reset_parameters(self, generator):
        """``attn_init``'s draws: per-head canonical shapes set each scale
        (1/sqrt of the head count for q/k/v/o, as the reference's
        ``dense_init`` reads the fan-in from axis -2; 0.02 for biases),
        then this rank's part of each (``attn_layout``)."""
        cfg, lay, k = self.cfg, self.shard.lay, self.shard.tp_rank
        d, dh, f32 = cfg.d_model, cfg.head_dim, torch.float32
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        for name, shape in (("wq", (d, hq, dh)), ("wk", (d, hkv, dh)),
                            ("wv", (d, hkv, dh)), ("wo", (hq, dh * d))):
            canon = dense_init(shape, generator, f32)
            w = getattr(self, name)
            w.copy_(attn_layout(name, canon, cfg, lay, k).to(w.dtype))
        if cfg.qkv_bias:
            for name, h in (("bq", hq), ("bk", hkv), ("bv", hkv)):
                canon = dense_init((h, dh), generator, f32, scale=0.02)
                b = getattr(self, name)
                b.copy_(attn_layout(name, canon, cfg, lay, k).to(b.dtype))
        if cfg.qk_norm:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)


def cache_init(cfg, lay: Layout, batch: int, s_max: int):
    """Shape of one layer's dense K (and V) cache on a rank, ``[batch,
    s_max, kv_per_rank, Dh]``."""
    plan = get_plan(cfg, lay)
    return (batch, s_max, plan.kv_per_rank, cfg.head_dim)


def paged_cache_init(cfg, lay: Layout, num_blocks: int, block_size: int):
    """Shape of one layer's K (and V) block pool on a rank,
    ``[num_blocks, block_size, kv_per_rank, Dh]``; block 0 is the null
    block. The same in the base and shift configs."""
    plan = get_plan(cfg, lay)
    return (num_blocks, block_size, plan.kv_per_rank, cfg.head_dim)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------
def _project_exchange(p: Attention, x, cfg):
    """QKV projection (TP column parallel) and, in the base config, the
    KV replication into the send buffer and the fused Ulysses scatter.
    x: [B, S_loc, d] -> q [B, S, q_per_rank, dh], k, v [B, S, kv_per_rank,
    dh], S the whole chunk."""
    dh = cfg.head_dim
    B, S, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q, k, v = (q.reshape(B, S, -1, dh), k.reshape(B, S, -1, dh),
               v.reshape(B, S, -1, dh))
    sh = p.shard
    if sh.sp_group is not None:
        k = expand_kv_for_send(k, p.plan, sh.lay.sp, sh.tp_rank)
        v = expand_kv_for_send(v, p.plan, sh.lay.sp, sh.tp_rank)
        q, k, v = ulysses_scatter_heads([q, k, v], sh.sp_group)
    return q, k, v


def _finish(p: Attention, out):
    """Mask this rank's padded q slots, gather the heads back over SP, O
    projection and TP psum (paper Alg. 1 lines 6-8)."""
    if p.q_mask is not None:
        out = out * p.q_mask[None, None, :, None]
    (out,) = ulysses_gather_heads([out], p.shard.sp_group)
    B, S = out.shape[:2]
    return psum_if(out.reshape(B, S, -1) @ p.wo, p.shard.tp_group)


def _qk_post(p: Attention, q, k, positions, cfg, rope: bool = True):
    if cfg.qk_norm:
        q, k = rmsnorm_pair(q, p.q_norm, k, p.k_norm, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


# ---------------------------------------------------------------------------
# paged forward
# ---------------------------------------------------------------------------
def paged_attn_mixed(p: Attention, x, k_pool, v_pool, pos, offsets, q_lens,
                     block_tables, cfg):
    """Ragged mixed prefill+decode against the paged pool. x: [B, S_loc,
    d], this rank's columns of a chunk of S = S_loc·sp; row b carries
    ``q_lens[b]`` fresh tokens at cache positions ``pos[b] = offsets[b] +
    arange(S)`` ([B, S], the whole chunk, which the attention sees after
    the exchange). Writes their K/V into this rank's ``k_pool``/``v_pool``
    ([num_blocks, bs, kv_per_rank, Dh]) IN PLACE: the reference's
    functional ``.at[].set`` would copy a multi-GB pool per layer here,
    which the card cannot afford. Returns out [B, S_loc, d]."""
    q, k, v = _project_exchange(p, x, cfg)
    S = q.shape[1]
    q, k = _qk_post(p, q, k, pos, cfg)

    bs = k_pool.shape[1]
    nmax = block_tables.shape[1]
    # only the first q_lens[b] columns are real tokens; the rest, and any
    # padding that overhangs the table, are routed to the null block
    # explicitly (clipping the index would collide with live KV)
    cols = torch.arange(S, device=x.device)
    valid = (cols[None, :] < q_lens[:, None]) & (pos // bs < nmax)
    blk = torch.gather(block_tables.long(), 1, (pos // bs).clamp(max=nmax - 1))
    blk = torch.where(valid, blk, 0)
    k_pool[blk, pos % bs] = k
    v_pool[blk, pos % bs] = v
    out = K.paged_ragged_attend(q, k_pool, v_pool, block_tables, q_lens,
                                offsets + q_lens,
                                soft_cap=cfg.logits_soft_cap)
    return _finish(p, out)


def paged_attn_prefill(p: Attention, x, k_pool, v_pool, pos, offsets,
                       block_tables, cfg):
    """Chunked prefill against the paged pool: the degenerate mixed call
    with ``q_lens == S`` for every row. All S columns are written (rows
    outside the chunk batch carry all-null tables, so their writes land in
    the null block); the padding past a short chunk is causally masked and
    overwritten by the next chunk. x: [B, S, d] -> [B, S, d]."""
    q_lens = torch.full_like(offsets, x.shape[1])
    return paged_attn_mixed(p, x, k_pool, v_pool, pos, offsets, q_lens,
                            block_tables, cfg)


def paged_attn_decode(p: Attention, x, k_pool, v_pool, lens, block_tables,
                      cfg):
    """One-token decode against the paged pool, the ragged kernel at
    C == 1. x: [B, d]; lens: [B] write positions; block_tables [B, nmax]
    (all-null rows for inactive slots write into the null block). Writes
    the new K/V in place. Returns [B, d]."""
    q, k, v = _project_exchange(p, x[:, None], cfg)           # [B, 1, H, dh]
    pos = lens[:, None].long()
    q, k = _qk_post(p, q, k, pos, cfg)
    bs = k_pool.shape[1]
    rows = torch.arange(x.shape[0], device=x.device)
    ln = lens.long()
    blk = block_tables.long()[rows, ln // bs]
    k_pool[blk, ln % bs] = k[:, 0]
    v_pool[blk, ln % bs] = v[:, 0]
    out = K.paged_ragged_attend(q, k_pool, v_pool, block_tables,
                                torch.ones_like(lens), lens + 1,
                                soft_cap=cfg.logits_soft_cap)
    return _finish(p, out)[:, 0]


# ---------------------------------------------------------------------------
# dense contiguous cache
# ---------------------------------------------------------------------------
def _dense_only(cfg, window, rope):
    if window or not rope or cfg.logits_soft_cap:
        raise NotImplementedError(
            f"dense attention with window={window}, rope={rope}, "
            f"soft_cap={cfg.logits_soft_cap}: only global causal attention "
            "with RoPE and no soft cap is ported")


def attn_prefill(p: Attention, x, k_cache, v_cache, offsets, cfg, *,
                 window: int = 0, rope: bool = True):
    """Chunked prefill against the dense cache. x: [B, S, d]; row b's
    tokens sit at positions ``offsets[b] + arange(S)``. Writes their K/V
    into ``k_cache``/``v_cache`` ([B, s_max, kv_slots, Dh]) IN PLACE at
    ``offsets`` clamped so the chunk fits (the reference's
    ``dynamic_update_slice``), padding columns included, then attends the
    chunk against the whole cache row: the flash kernel's causal mask
    ``kpos <= offsets[b] + i`` is the reference's ``attend`` with
    ``kv_len = offsets + S``. Returns out [B, S, d]."""
    _dense_only(cfg, window, rope)
    q, k, v = _project_exchange(p, x, cfg)
    B, S = q.shape[:2]
    pos = offsets[:, None].long() + torch.arange(S, device=x.device)[None]
    q, k = _qk_post(p, q, k, pos, cfg)
    s_max = k_cache.shape[1]
    start = offsets.long().clamp(0, s_max - S)
    idx = start[:, None] + torch.arange(S, device=x.device)[None]   # [B, S]
    rows = torch.arange(B, device=x.device)[:, None]
    k_cache[rows, idx] = k
    v_cache[rows, idx] = v
    out = K.flash_attention(q, k_cache, v_cache, causal=True,
                            q_offsets=offsets)
    return _finish(p, out)


def attn_decode(p: Attention, x, k_cache, v_cache, lens, cfg, *,
                window: int = 0, rope: bool = True):
    """One-token decode against the dense cache. x: [B, d]; lens: [B]
    write positions (inactive slots pass 0 and write a garbage K/V at
    position 0 of their free row, as the reference does). Writes in place,
    then attends ``kpos < lens + 1`` with the decode kernel. Returns
    [B, d]."""
    _dense_only(cfg, window, rope)
    q, k, v = _project_exchange(p, x[:, None], cfg)           # [B, 1, H, dh]
    pos = lens[:, None].long()
    q, k = _qk_post(p, q, k, pos, cfg)
    rows = torch.arange(x.shape[0], device=x.device)
    k_cache[rows, lens.long()] = k[:, 0]
    v_cache[rows, lens.long()] = v[:, 0]
    out = K.decode_attention(q, k_cache, v_cache, lens + 1)
    return _finish(p, out)[:, 0]
