"""GQA attention (counterpart of ``repro.models.attention``) on the trivial
layout: the QKV projection, the per-head q/k norm and RoPE, the in-place KV
write into the dense contiguous cache or through the block table into the
paged pool, the attention kernels, and the O projection.

Only global causal attention with RoPE and no logit soft cap is ported:
no config of the port has sliding windows, soft caps or rope-free layers
(local, gemma and whisper layers bring them later), so the dense paths
raise on them."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops as K
from repro_torch.parallel import HeadPlan, Layout, plan_heads
from .layers import apply_rope, dense_init, empty_param, rmsnorm


def get_plan(cfg, lay: Layout) -> HeadPlan:
    return plan_heads(cfg.num_heads, cfg.num_kv_heads, max(lay.G, 1),
                      max(lay.tp, 1))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """Parameters of one attention layer, shaped as ``attn_init``'s. On the
    trivial layout the head plan has no pad slots and no KV replication, so
    the weights hold exactly the model's heads."""

    def __init__(self, cfg, lay: Layout, dtype, device):
        super().__init__()
        self.cfg = cfg
        plan = get_plan(cfg, lay)
        d, dh = cfg.d_model, cfg.head_dim
        hq, hkv = plan.h_q_pad, plan.kv_slots_total
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

    def reset_parameters(self, generator):
        """``attn_init``'s draws: per-head canonical shapes set each scale
        (1/sqrt of the head count for q/k/v/o, as the reference's
        ``dense_init`` reads the fan-in from axis -2; 0.02 for biases)."""
        cfg = self.cfg
        d, dh, dt = cfg.d_model, cfg.head_dim, self.wq.dtype
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        self.wq.copy_(dense_init((d, hq, dh), generator, dt).reshape(d, -1))
        self.wk.copy_(dense_init((d, hkv, dh), generator, dt).reshape(d, -1))
        self.wv.copy_(dense_init((d, hkv, dh), generator, dt).reshape(d, -1))
        self.wo.copy_(dense_init((hq, dh * d), generator, dt).reshape(-1, d))
        if cfg.qkv_bias:
            for b, h in ((self.bq, hq), (self.bk, hkv), (self.bv, hkv)):
                b.copy_(dense_init((h, dh), generator, dt,
                                   scale=0.02).reshape(-1))
        if cfg.qk_norm:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)


def cache_init(cfg, lay: Layout, batch: int, s_max: int):
    """Shape of one layer's dense K (and V) cache, ``[batch, s_max,
    kv_slots, Dh]``."""
    plan = get_plan(cfg, lay)
    return (batch, s_max, plan.kv_slots_total, cfg.head_dim)


def paged_cache_init(cfg, lay: Layout, num_blocks: int, block_size: int):
    """Shape of one layer's K (and V) block pool,
    ``[num_blocks, block_size, kv_slots, Dh]``; block 0 is the null block."""
    plan = get_plan(cfg, lay)
    return (num_blocks, block_size, plan.kv_slots_total, cfg.head_dim)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------
def _project_exchange(p: Attention, x, cfg):
    """QKV projection. On the trivial layout there is no Ulysses exchange.
    x: [B, S, d] -> q [B, S, Hq, dh], k, v [B, S, Hkv, dh]."""
    dh = cfg.head_dim
    B, S, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.reshape(B, S, -1, dh), k.reshape(B, S, -1, dh),
            v.reshape(B, S, -1, dh))


def _finish(p: Attention, out):
    """The O projection (no pad head slots to mask on the trivial layout)."""
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ p.wo


def _qk_post(p: Attention, q, k, positions, cfg, rope: bool = True):
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


# ---------------------------------------------------------------------------
# paged forward
# ---------------------------------------------------------------------------
def paged_attn_mixed(p: Attention, x, k_pool, v_pool, pos, offsets, q_lens,
                     block_tables, cfg):
    """Ragged mixed prefill+decode against the paged pool. x: [B, S, d],
    row b carrying ``q_lens[b]`` fresh tokens at cache positions
    ``pos[b] = offsets[b] + arange(S)``. Writes their K/V into ``k_pool``/``v_pool``
    ([num_blocks, bs, kv_slots, Dh]) IN PLACE: the reference's functional
    ``.at[].set`` would copy a multi-GB pool per layer here, which the card
    cannot afford. Returns out [B, S, d]."""
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
