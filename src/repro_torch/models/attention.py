"""GQA attention under combined (SP, TP) (counterpart of
``repro.models.attention``): the QKV projection (TP column parallel), the
fused Ulysses all-to-all into head parallelism in the base config, the
per-head q/k norm and RoPE, the in-place KV write into the dense contiguous
cache or through the block table into the paged pool, the attention
kernels, the all-to-all back, and the O projection (row parallel) with its
TP psum.

Each rank holds its tp rank's weight columns and its own slice of the KV
cache: the kv slots of its model rank in the base config (after the
all-to-all) and of its tp rank in the shift config, which are the same
slots (``core.invariance``). The paged pool is ``[num_blocks, bs,
kv_per_rank, Dh]``; the dense cache ``[B_row, s_max, kv_per_rank, Dh]``,
its dp row's slots. Every path runs on every layout: the mixed and the
chunked prefill steps see the whole chunk after the exchange, and a
decode step sends the rank's batch rows as the exchange's "sequence"
(``x[None]``, the reference's batch-as-sequence), so that each rank
attends every row of its dp row at its own heads.

Global causal attention with RoPE runs the kernels: flash for a dense
prefill step, the dense decode kernel for a dense decode step, the ragged
kernel on the paged pool. A sliding-window (``local``) layer keeps a ring
cache of ``min(s_max, window)`` rows per slot on the dense path: position
``p`` lives in row ``p mod rows``; a prefill chunk attends over the old
ring concatenated with its own keys and then writes its last ``min(S,
rows)`` keys, a decode step writes its key and attends the ring, both with
the window mask and the config's logit soft cap, through the plain
``models.attention_math`` (the reference's ring attention is jnp and
reaches no Pallas kernel). A window over a cache longer than it and a soft
cap on global attention are not ported: the dense paths raise on them.

Whisper's attention is rope-free: its decoder's self-attention takes the
dense paths with ``rope=False`` (flash in prefill, the decode kernel in
decode); its encoder attends the rank's whole frame sequence after the
exchange, non-causal, with no cache, through the flash kernel
(``enc_attn``); its cross attention projects the encoder's output into
the cross cache in every prefill step (``cross_kv_prefill``, through the
exchange in the base config), then attends all ``S_enc`` keys
non-causally: the flash kernel in prefill (``cross_attend``), the decode
kernel with every row's length ``S_enc`` in decode
(``cross_attend_decode``), the reference's unmasked ``attend``."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.ulysses import (expand_kv_for_send,
                                      ulysses_gather_heads,
                                      ulysses_scatter_heads)
from repro_torch.kernels import ops as K
from repro_torch.parallel import HeadPlan, Layout, Shard, plan_heads
from repro_torch.parallel.collectives import psum_if
from .attention_math import attend, attend_partial, finish_partial
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
# training forward (no cache)
# ---------------------------------------------------------------------------
def attn_train(p: Attention, x, pos, cfg):
    """The cache-free forward of training (the reference's ``attn_prefill``
    with ``cache is None``): x [B, S_loc, d], this rank's columns; after
    the exchange q and k are normed and rotated at the chunk's global
    positions ``pos`` [B, S] and the flash kernel attends the chunk's own
    keys, causal at zero offsets. Writes no cache; every step is
    differentiable (the exchange, the kernels, the TP psum). Returns [B,
    S_loc, d]."""
    q, k, v = _project_exchange(p, x, cfg)
    q, k = _qk_post(p, q, k, pos, cfg)
    return _finish(p, K.flash_attention(q, k, v, causal=True))


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
    which the card cannot afford. Returns out [B, S_loc, d]. A MoE model's
    padding columns are computed as the reference computes them (each over
    its row's keys): its router sees every column of the step."""
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
                                soft_cap=cfg.logits_soft_cap,
                                pad_cols=cfg.moe is not None)
    return _finish(p, out)


def paged_attn_prefill(p: Attention, x, k_pool, v_pool, pos, offsets,
                       block_tables, cfg):
    """Chunked prefill against the paged pool: the degenerate mixed call
    with ``q_lens == S`` for every row, S the whole chunk after the
    exchange. All S columns are written (rows outside the chunk batch
    carry all-null tables, so their writes land in the null block); the
    padding past a short chunk is causally masked and overwritten by the
    next chunk. x: [B, S_loc, d] -> [B, S_loc, d]."""
    q_lens = torch.full_like(offsets, pos.shape[1])
    return paged_attn_mixed(p, x, k_pool, v_pool, pos, offsets, q_lens,
                            block_tables, cfg)


def _decode_exchange(p: Attention, x, lens, cfg, rope: bool = True):
    """A decode step's projection and exchange: the rank's rows x [B_loc,
    d] travel as a sequence ``x[None]``, so after the exchange the rank
    holds every row of its dp row at its heads, q [B_row, 1, q_per_rank,
    dh] and k, v [B_row, 1, kv_per_rank, dh], normed and (with ``rope``)
    rotated at positions ``lens`` [B_row]."""
    q, k, v = (t.transpose(0, 1) for t in _project_exchange(p, x[None],
                                                            cfg))
    return (*_qk_post(p, q, k, lens[:, None].long(), cfg, rope), v)


def _decode_finish(p: Attention, out):
    """out [B_row, 1, q_per_rank, dh] back to the rank's rows, [B_loc,
    d]."""
    return _finish(p, out.transpose(0, 1))[0]


def paged_attn_decode(p: Attention, x, k_pool, v_pool, lens, block_tables,
                      cfg):
    """One-token decode against the paged pool, the ragged kernel at
    C == 1. x: [B_loc, d]; lens: [B_row] write positions; block_tables
    [B_row, nmax] (all-null rows for inactive slots write into the null
    block). Writes the new K/V in place. Returns [B_loc, d]."""
    q, k, v = _decode_exchange(p, x, lens, cfg)
    bs = k_pool.shape[1]
    rows = torch.arange(q.shape[0], device=x.device)
    ln = lens.long()
    blk = block_tables.long()[rows, ln // bs]
    k_pool[blk, ln % bs] = k[:, 0]
    v_pool[blk, ln % bs] = v[:, 0]
    out = K.paged_ragged_attend(q, k_pool, v_pool, block_tables,
                                torch.ones_like(lens), lens + 1,
                                soft_cap=cfg.logits_soft_cap)
    return _decode_finish(p, out)


# ---------------------------------------------------------------------------
# dense contiguous cache
# ---------------------------------------------------------------------------
def _ring(cfg, window, rows):
    """True for the ring path (a window over a cache of at most ``window``
    rows, as every ``local`` layer's); False for global attention. Raises
    on what is not ported."""
    if window and rows > window:
        raise NotImplementedError(
            f"a window of {window} over a cache of {rows} rows: a local "
            "layer's cache is its ring of min(s_max, window) rows "
            "(init_cache); a window over a longer cache is not ported")
    if not window and cfg.logits_soft_cap:
        raise NotImplementedError(
            f"soft cap {cfg.logits_soft_cap} on global attention: only the "
            "local layers' ring attention soft-caps")
    return bool(window)


def ring_positions(lens, rows: int):
    """The global position each row of a ring cache of ``rows`` rows holds
    after ``lens`` [B] tokens: row j holds ``last - ((last mod rows - j)
    mod rows)``, ``last = lens - 1``, and -1 (no key) where that is
    negative. [B, rows], int64."""
    last = lens.long()[:, None] - 1
    j = torch.arange(rows, device=lens.device)[None]
    pos = last - ((last % rows - j) % rows)
    return torch.where(pos >= 0, pos, -1)


def attn_prefill(p: Attention, x, k_cache, v_cache, offsets, cfg, *,
                 window: int = 0, rope: bool = True):
    """Chunked prefill against the dense cache. x: [B, S_loc, d], this
    rank's columns of a chunk of S; row b's tokens sit at positions
    ``offsets[b] + arange(S)``, which the rank sees whole after the
    exchange (rotated there unless ``rope`` is False). Global attention
    writes their K/V into ``k_cache``/
    ``v_cache`` ([B, s_max, kv_per_rank, Dh]) IN PLACE at ``offsets``
    clamped so the chunk fits (the reference's ``dynamic_update_slice``),
    padding columns included, then attends the chunk against the whole
    cache row: the flash kernel's causal mask ``kpos <= offsets[b] + i``
    is the reference's ``attend`` with ``kv_len = offsets + S``. A
    ``window`` layer's ring cache [B, rows, kv_per_rank, Dh] is attended
    concatenated with the chunk's keys (the window mask and soft cap),
    then the chunk's last ``min(S, rows)`` keys are written at their
    positions mod ``rows``. Returns out [B, S_loc, d]."""
    ring = _ring(cfg, window, k_cache.shape[1])
    q, k, v = _project_exchange(p, x, cfg)
    B, S = q.shape[:2]
    pos = offsets[:, None].long() + torch.arange(S, device=x.device)[None]
    q, k = _qk_post(p, q, k, pos, cfg, rope)
    rows = torch.arange(B, device=x.device)[:, None]
    if ring:
        n = k_cache.shape[1]
        kv_pos = torch.cat([ring_positions(offsets, n), pos], dim=1)
        k_all = torch.cat([k_cache, k], dim=1)
        v_all = torch.cat([v_cache, v], dim=1)
        m = min(S, n)
        k_cache[rows, pos[:, -m:] % n] = k[:, -m:]
        v_cache[rows, pos[:, -m:] % n] = v[:, -m:]
        out = attend(q, k_all, v_all, pos, kv_pos, window=window,
                     soft_cap=cfg.logits_soft_cap)
        return _finish(p, out)
    s_max = k_cache.shape[1]
    start = offsets.long().clamp(0, s_max - S)
    idx = start[:, None] + torch.arange(S, device=x.device)[None]   # [B, S]
    k_cache[rows, idx] = k
    v_cache[rows, idx] = v
    out = K.flash_attention(q, k_cache, v_cache, causal=True,
                            q_offsets=offsets)
    return _finish(p, out)


def attn_decode(p: Attention, x, k_cache, v_cache, lens, cfg, *,
                window: int = 0, rope: bool = True):
    """One-token decode against the dense cache. x: [B_loc, d], this
    rank's segment of its dp row's batch; lens: [B_row] write positions
    (inactive slots pass 0 and write a garbage K/V at position 0 of their
    free row, as the reference does); k_cache/v_cache [B_row, s_max,
    kv_per_rank, Dh]. Writes in place (q and k rotated at ``lens`` unless
    ``rope`` is False), then attends ``kpos < lens + 1`` with the decode
    kernel at the rank's heads; a ``window`` layer writes
    row ``lens mod rows`` of its ring and attends the ring with the
    window mask and soft cap. Returns [B_loc, d]."""
    ring = _ring(cfg, window, k_cache.shape[1])
    q, k, v = _decode_exchange(p, x, lens, cfg, rope)
    rows = torch.arange(q.shape[0], device=x.device)
    ln = lens.long()
    wp = ln % k_cache.shape[1] if ring else ln
    k_cache[rows, wp] = k[:, 0]
    v_cache[rows, wp] = v[:, 0]
    if ring:
        kv_pos = ring_positions(lens + 1, k_cache.shape[1])
        acc, l, m = attend_partial(q, k_cache, v_cache, ln[:, None], kv_pos,
                                   window=window,
                                   soft_cap=cfg.logits_soft_cap)
        out = finish_partial(acc, l, m).to(q.dtype)
    else:
        out = K.decode_attention(q, k_cache, v_cache, lens + 1)
    return _decode_finish(p, out)


# ---------------------------------------------------------------------------
# whisper: the encoder's attention and the decoder's cross attention
# ---------------------------------------------------------------------------
def enc_attn(p: Attention, x, cfg):
    """Encoder self-attention: x [B, S_loc, d], the rank's frames; after
    the exchange the rank attends the whole sequence at its heads,
    non-causal, rope-free, with no cache (the flash kernel at zero
    offsets). Returns [B, S_loc, d]."""
    q, k, v = _project_exchange(p, x, cfg)
    q, k = _qk_post(p, q, k, None, cfg, rope=False)
    return _finish(p, K.flash_attention(q, k, v, causal=False))


def cross_kv_prefill(p: Attention, enc_out, k_cross, v_cross, cfg):
    """Project the encoder's output [B, S_enc_loc, d] (the rank's frames)
    into the cross K/V and write them IN PLACE into ``k_cross``/``v_cross``
    [B, S_enc, kv_per_rank, Dh]: in the base config the kv slots are
    replicated into the send buffer and scattered over SP, as the
    self-attention's are, so each rank holds every frame at its slots."""
    dh = cfg.head_dim
    B, S, _ = enc_out.shape
    k = (enc_out @ p.wk).reshape(B, S, -1, dh)
    v = (enc_out @ p.wv).reshape(B, S, -1, dh)
    if cfg.qkv_bias:
        k, v = k + p.bk.reshape(-1, dh), v + p.bv.reshape(-1, dh)
    sh = p.shard
    if sh.sp_group is not None:
        k = expand_kv_for_send(k, p.plan, sh.lay.sp, sh.tp_rank)
        v = expand_kv_for_send(v, p.plan, sh.lay.sp, sh.tp_rank)
        k, v = ulysses_scatter_heads([k, v], sh.sp_group)
    k_cross.copy_(k)
    v_cross.copy_(v)


def _cross_q(p: Attention, x, cfg):
    """The cross attention's queries [B, S, d] -> [B, S_full, q_per_rank,
    dh] after the exchange (no norm, no rotation)."""
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = q.reshape(x.shape[0], x.shape[1], -1, cfg.head_dim)
    (q,) = ulysses_scatter_heads([q], p.shard.sp_group)
    return q


def cross_attend(p: Attention, x, k_cross, v_cross, cfg):
    """A prefill chunk's cross attention: x [B, S_loc, d] against every
    frame of the cross cache, non-causal (the flash kernel at zero
    offsets). Returns [B, S_loc, d]."""
    q = _cross_q(p, x, cfg)
    return _finish(p, K.flash_attention(q, k_cross, v_cross, causal=False))


def cross_attend_decode(p: Attention, x, k_cross, v_cross, cfg):
    """A decode step's cross attention: the rank's rows x [B_loc, d] travel
    as a sequence, as in ``attn_decode``; every row of the dp row attends
    all ``S_enc`` frames (the decode kernel with every length ``S_enc``).
    Returns [B_loc, d]."""
    q = _cross_q(p, x[None], cfg).transpose(0, 1)    # [B_row, 1, q_pr, dh]
    B, S_enc = k_cross.shape[:2]
    lens = torch.full((B,), S_enc, dtype=torch.int32, device=x.device)
    return _decode_finish(p, K.decode_attention(q, k_cross, v_cross, lens))
