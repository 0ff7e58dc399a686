"""Multi-head latent attention, DeepSeek-V2/V3 (counterpart of
``repro.models.mla``) under Shift Parallelism.

MLA's compressed latent cache has no head dimension, so it is sharded over
the sequence, not over heads: each rank holds the contiguous chunk
``[B_row, s_max/cache_sp, kv_lora + rope]`` of its grid's sp rank
(``Layout.cache_sp_axes``), the same chunk in the base and the shift
config, which is this layout's form of the cache invariance. The query
heads shard over ``mla_tp_axes``, the TP axes outside the cache's sequence
axes, so that every rank of an sp column holds the same heads: the grid's
tp in both configs. In the shift config the MLA projections therefore stay
at the base TP degree while the MLP, the experts and the embeddings widen
to the model group.

* prefill on the base config (activations sequence-sharded): the new
  latent is all-gathered over SP, each rank writes the positions of its
  cache chunk, the whole cache is all-gathered, and every rank attends its
  own columns against it;
* decode, and prefill on the shift config: every rank attends over its own
  cache chunk and the partial softmaxes are merged by log-sum-exp over the
  cache's sequence axes (distributed flash-decoding). A decode step on the
  base config gathers q and the new latent over SP by batch row and keeps
  its own rows of the output.

The attention is plain PyTorch (``models.attention_math``, copies of the
reference's ``repro.models.attention_math``, which is jnp and reaches no
Pallas kernel). The latent and q norms are RMSNorm, the kernel on the
card. Masked scores are the finite ``NEG_INF``, so a rank whose chunk
holds no live position adds exactly zero to the merge.

Training (``mla_train``) runs the same attention with no cache: the base
config gathers the latent over SP, the shift branch merges partials.

The cache writes are in place (a CUDA graph keeps the cache's address):
the reference writes every row of a prefill chunk at the positions of the
step's first row (``offsets[0]``, hence the engine's uniform offset rule
for MLA), and a decode step each row at ``lens[b]``; positions outside the
rank's chunk are dropped. The merged attention is cast to the model's type
before the O projection: the reference's shift path keeps it in fp32 and
lets the residual stream widen, which changes nothing in fp32.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.parallel import Layout, Shard
from repro_torch.parallel.collectives import (all_gather_axis, all_gather_if,
                                              psum_if)
from .attention_math import (NEG_INF, attend, attend_partial,  # noqa: F401
                             finish_partial, merge_partials)
from .layers import apply_rope, dense_init, empty_param, rmsnorm, shard_of


# ---------------------------------------------------------------------------
# head sharding
# ---------------------------------------------------------------------------
def mla_tp_axes(lay: Layout):
    """The TP axes outside the cache's sequence axes: the heads must not
    span ``cache_sp_axes``, whose ranks LSE-merge the same heads."""
    return tuple(a for a in lay.tp_axes if a not in lay.cache_sp_axes)


def _tp_deg(lay: Layout) -> int:
    return math.prod(lay.axis_sizes[a] for a in mla_tp_axes(lay))


def mla_heads_local(cfg, lay: Layout) -> int:
    return -(-cfg.num_heads // _tp_deg(lay))


def _h_pad(cfg, lay: Layout) -> int:
    return mla_heads_local(cfg, lay) * _tp_deg(lay)


# per-head leaves and the width of one head's slice of each
_PER_HEAD = {"wq_b": "qk", "wk_b": "nope", "wv_b": "vd", "wo": "vd"}


def _head_width(name, cfg) -> int:
    m = cfg.mla
    return {"qk": m.qk_nope_head_dim + m.qk_rope_head_dim,
            "nope": m.qk_nope_head_dim, "vd": m.v_head_dim}[_PER_HEAD[name]]


def mla_layout(name: str, t, cfg, lay: Layout, rank: int):
    """Process ``rank``'s part of MLA leaf ``name`` from the trivial
    layout's tensor (the reference's ``mla_init`` on ``Layout()``, whose
    heads are not padded): the up projections' columns and ``wo``'s rows,
    heads zero-padded to ``_h_pad`` and cut by the rank's index over
    ``mla_tp_axes`` (``mla_specs``); the down projections and the norms
    whole."""
    if name not in _PER_HEAD:
        return t
    h, hp, c = cfg.num_heads, _h_pad(cfg, lay), _head_width(name, cfg)
    k, n = lay.axes_index(mla_tp_axes(lay), rank), _tp_deg(lay)
    if name == "wo":
        w = t.reshape(h, c * cfg.d_model)
        w = torch.cat([w, w.new_zeros((hp - h, w.shape[1]))])
        return shard_of(w.reshape(hp * c, cfg.d_model), 0, n, k)
    r = t.shape[0]
    w = t.reshape(r, h, c)
    w = torch.cat([w, w.new_zeros((r, hp - h, c))], dim=1)
    return shard_of(w.reshape(r, hp * c), 1, n, k)


def mla_unlayout(name: str, parts, cfg, lay: Layout):
    """The inverse of ``mla_layout``: the trivial layout's leaf ``name``
    from ``parts``, one per index over ``mla_tp_axes`` (the grid's tp) in
    that order, or one per model rank in model-rank order (``g = j*sp +
    i``: the first of each tp index is taken; the sp ranks of one tp index
    hold the same part). A per-head leaf's parts are put side by side and
    its pad heads dropped; a whole leaf is the first part. Bitwise:
    ``mla_layout`` of the result gives each part back."""
    n = _tp_deg(lay)
    if len(parts) != n:
        if len(parts) != max(lay.G, 1):
            raise ValueError(f"{name}: {len(parts)} shards, want one per tp "
                             f"rank of the grid ({n}) or per model rank "
                             f"({lay.G})")
        parts = [parts[j * lay.grid[0]] for j in range(n)]
    if name not in _PER_HEAD:
        return parts[0]
    h, c = cfg.num_heads, _head_width(name, cfg)
    if name == "wo":
        w = torch.cat(list(parts), 0).reshape(-1, c * cfg.d_model)
        return w[:h].reshape(h * c, cfg.d_model)
    w = torch.cat(list(parts), 1)
    return w.reshape(w.shape[0], -1, c)[:, :h].reshape(w.shape[0], h * c)


class MLA(nn.Module):
    """One MLA layer's parameters, this rank's part of ``mla_init``'s:
    ``wq_a`` [d, q_lora], ``q_norm`` [q_lora], ``wq_b`` [q_lora,
    h_loc·(nope+rope)], ``wkv_a`` [d, kv_lora+rope], ``kv_norm`` [kv_lora],
    ``wk_b`` [kv_lora, h_loc·nope], ``wv_b`` [kv_lora, h_loc·v], ``wo``
    [h_loc·v, d], with ``h_loc = mla_heads_local``."""

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        super().__init__()
        self.cfg = cfg
        self.shard = shard = shard or Shard(lay)
        m, d = cfg.mla, cfg.d_model
        hl = mla_heads_local(cfg, lay)
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        self.wq_a = empty_param((d, m.q_lora_rank), dtype, device)
        self.q_norm = empty_param((m.q_lora_rank,), dtype, device)
        self.wq_b = empty_param((m.q_lora_rank, hl * qk), dtype, device)
        self.wkv_a = empty_param((d, m.kv_lora_rank + m.qk_rope_head_dim),
                                 dtype, device)
        self.kv_norm = empty_param((m.kv_lora_rank,), dtype, device)
        self.wk_b = empty_param((m.kv_lora_rank, hl * m.qk_nope_head_dim),
                                dtype, device)
        self.wv_b = empty_param((m.kv_lora_rank, hl * m.v_head_dim), dtype,
                                device)
        self.wo = empty_param((hl * m.v_head_dim, d), dtype, device)
        # the groups: heads over the grid's tp, the cache over its sp (in
        # both configs); the base config's SP group gathers activations
        self.tp_group = shard.axes_group(mla_tp_axes(lay))
        self.csp_group = shard.axes_group(lay.cache_sp_axes)
        self.csp_rank = lay.axes_index(lay.cache_sp_axes, shard.rank)

    def reset_parameters(self, generator):
        """``mla_init``'s draws at their canonical shapes (the per-head
        ones with the heads on axis -2, which sets their scale as the
        reference's ``dense_init`` reads it), then this rank's part."""
        cfg, m, d, h = self.cfg, self.cfg.mla, self.cfg.d_model, \
            self.cfg.num_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        for name, shape in (
                ("wq_a", (d, m.q_lora_rank)),
                ("wq_b", (m.q_lora_rank, h, qk)),
                ("wkv_a", (d, m.kv_lora_rank + m.qk_rope_head_dim)),
                ("wk_b", (m.kv_lora_rank, h, m.qk_nope_head_dim)),
                ("wv_b", (m.kv_lora_rank, h, m.v_head_dim)),
                ("wo", (h, m.v_head_dim * d))):
            canon = dense_init(shape, generator, torch.float32)
            flat = canon.reshape(shape[0], -1) if len(shape) == 3 else canon
            w = getattr(self, name)
            w.copy_(mla_layout(name, flat, cfg, self.shard.lay,
                               self.shard.rank).to(w.dtype))
        self.q_norm.fill_(1.0)
        self.kv_norm.fill_(1.0)


def mla_cache_shape(cfg, lay: Layout, batch: int, s_max: int):
    """Shape of one layer's latent cache on a rank, ``[batch, s_max /
    cache_sp, kv_lora + rope]`` (``mla_cache_specs``' ``P(dp, cache_sp,
    None)``, ``batch`` the dp row's)."""
    if s_max % lay.cache_sp:
        raise ValueError(f"s_max={s_max} does not split over the latent "
                         f"cache's sp={lay.cache_sp}")
    return (batch, s_max // lay.cache_sp, cfg.mla.cache_dim)


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------
def _latent(p: MLA, x, cfg, positions):
    """x [B, S, d] -> the latent [B, S, kv_lora + rope]: the normed
    compressed kv and the rotated shared rope key."""
    kl = cfg.mla.kv_lora_rank
    lat = x @ p.wkv_a
    ckv = rmsnorm(lat[..., :kl], p.kv_norm, cfg.norm_eps)
    kr = apply_rope(lat[..., kl:][:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0]
    return torch.cat([ckv, kr], dim=-1)


def _queries(p: MLA, x, cfg, positions):
    """x [B, S, d] -> q [B, S, h_loc, nope + rope], its rope part
    rotated."""
    m = cfg.mla
    q = rmsnorm(x @ p.wq_a, p.q_norm, cfg.norm_eps) @ p.wq_b
    B, S = q.shape[:2]
    q = q.reshape(B, S, -1, m.qk_nope_head_dim + m.qk_rope_head_dim)
    qn, qr = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return torch.cat([qn, apply_rope(qr, positions, cfg.rope_theta)], dim=-1)


def _kv_from_latent(p: MLA, lat, cfg):
    """lat [B, Sk, kv_lora + rope] -> k [B, Sk, h_loc, nope + rope] (the
    rope key shared by every head), v [B, Sk, h_loc, v]."""
    m = cfg.mla
    ckv, kr = lat[..., :m.kv_lora_rank], lat[..., m.kv_lora_rank:]
    B, Sk = lat.shape[:2]
    k_n = (ckv @ p.wk_b).reshape(B, Sk, -1, m.qk_nope_head_dim)
    v = (ckv @ p.wv_b).reshape(B, Sk, -1, m.v_head_dim)
    kr_b = kr[:, :, None, :].expand(*k_n.shape[:3], kr.shape[-1])
    return torch.cat([k_n, kr_b], dim=-1), v


def _local_kv_pos(p: MLA, cache):
    s_loc = cache.shape[1]
    return p.csp_rank * s_loc + torch.arange(s_loc, device=cache.device)


def _write_chunk(p: MLA, cache, lat, off0):
    """Every row's latent ``lat`` [B, S, C] written in place at positions
    ``off0 + arange(S)`` (``off0`` the step's first row's offset), those in
    this rank's chunk of the cache [B, s_loc, C]."""
    s_loc, S = cache.shape[1], lat.shape[1]
    j = _local_kv_pos(p, cache) - off0.long()        # chunk column per slot
    ok = (j >= 0) & (j < S)
    src = lat[:, j.clamp(0, S - 1)].to(cache.dtype)
    cache.copy_(torch.where(ok[None, :, None], src, cache))


def _finish(p: MLA, out, x):
    """[B, S, h_loc, v] -> the O projection, summed over the heads' TP
    group: [B, S, d] in x's type."""
    B, S = out.shape[:2]
    return psum_if(out.reshape(B, S, -1).to(x.dtype) @ p.wo, p.tp_group)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def mla_prefill(p: MLA, x, cache, offsets, cfg):
    """One layer's chunked prefill against this rank's latent cache chunk
    ``cache`` [B, s_loc, C] (updated in place). x: [B, S_loc, d], this sp
    rank's columns of the chunk on the base config, the whole chunk on the
    shift config. Returns [B, S_loc, d]."""
    sh = p.shard
    B, S_loc, _ = x.shape
    ar = torch.arange(S_loc, device=x.device)
    pos = offsets[:, None].long() + sh.sp_rank * S_loc + ar[None]
    lat = _latent(p, x, cfg, pos)
    q = _queries(p, x, cfg, pos)
    if sh.lay.sp > 1:
        # the whole chunk's latent, written where this rank's chunk of the
        # cache holds it; then the whole cache, attended by the own columns
        lat_full = all_gather_axis(lat, sh.sp_group, 1)
        _write_chunk(p, cache, lat_full, offsets[0])
        lat_all = all_gather_axis(cache, p.csp_group, 1)
        k, v = _kv_from_latent(p, lat_all, cfg)
        kv_pos = torch.arange(lat_all.shape[1], device=x.device)
        out = attend(q, k, v, pos, kv_pos, kv_len=offsets + lat_full.shape[1])
    else:
        _write_chunk(p, cache, lat, offsets[0])
        k, v = _kv_from_latent(p, cache, cfg)
        acc, l, m = attend_partial(q, k, v, pos, _local_kv_pos(p, cache),
                                   kv_len=offsets + S_loc)
        out = merge_partials(acc, l, m, p.csp_group).permute(0, 3, 1, 2, 4) \
            .reshape(B, S_loc, -1, cfg.mla.v_head_dim)
    return _finish(p, out, x)


def mla_train(p: MLA, x, cfg):
    """Training's forward of one layer (the reference's ``mla_prefill``
    with no cache, at zero offsets): nothing is written. x: [B, S_loc, d],
    this sp rank's columns. With sp > 1 the latent of the rank's columns is
    all-gathered over SP (differentiable: its backward is the
    reduce-scatter) and the rank's queries attend the whole sequence's;
    otherwise the rank attends its own columns and the partial results are
    merged over the cache's sequence axes (``merge_partials``: a ``psum``
    transposed to a ``psum``, a stabiliser with no gradient), as the
    reference's shift branch does. Returns [B, S_loc, d]."""
    sh = p.shard
    B, S_loc, _ = x.shape
    ar = torch.arange(S_loc, device=x.device)
    pos = (sh.sp_rank * S_loc + ar)[None].expand(B, S_loc)
    lat = _latent(p, x, cfg, pos)
    q = _queries(p, x, cfg, pos)
    if sh.lay.sp > 1:
        lat_full = all_gather_axis(lat, sh.sp_group, 1)
        k, v = _kv_from_latent(p, lat_full, cfg)
        kv_pos = torch.arange(lat_full.shape[1], device=x.device)
        out = attend(q, k, v, pos, kv_pos)
    else:
        k, v = _kv_from_latent(p, lat, cfg)
        acc, l, m = attend_partial(q, k, v, pos, pos[0])
        out = merge_partials(acc, l, m, p.csp_group).permute(0, 3, 1, 2, 4) \
            .reshape(B, S_loc, -1, cfg.mla.v_head_dim)
    return _finish(p, out, x)


def mla_decode(p: MLA, x, cache, lens, cfg):
    """One layer's decode step. x: [B_loc, d], this rank's segment of its
    dp row's B_row rows (all of them on the shift config); lens [B_row] the
    write positions; ``cache`` [B_row, s_loc, C] updated in place. Every
    rank attends all B_row rows over its own chunk, merged over the cache's
    sequence axes. Returns [B_loc, d]."""
    sh = p.shard
    B_loc = x.shape[0]
    pos_all = lens[:, None].long()                        # [B_row, 1]
    seg = slice(sh.sp_rank * B_loc, (sh.sp_rank + 1) * B_loc)
    pos_loc = pos_all[seg] if sh.lay.sp > 1 else pos_all
    lat = _latent(p, x[:, None], cfg, pos_loc)            # [B_loc, 1, C]
    q = _queries(p, x[:, None], cfg, pos_loc)
    if sh.lay.sp > 1:
        lat = all_gather_if(lat[:, 0], sh.sp_group)[:, None]
        q = all_gather_if(q[:, 0], sh.sp_group)[:, None]
    B, s_loc = q.shape[0], cache.shape[1]
    rows = torch.arange(B, device=x.device)
    local = lens.long() - p.csp_rank * s_loc
    ok = (local >= 0) & (local < s_loc)
    idx = local.clamp(0, s_loc - 1)
    cache[rows, idx] = torch.where(ok[:, None], lat[:, 0].to(cache.dtype),
                                   cache[rows, idx])
    k, v = _kv_from_latent(p, cache, cfg)
    acc, l, m = attend_partial(q, k, v, pos_all, _local_kv_pos(p, cache),
                               kv_len=lens + 1)
    out = merge_partials(acc, l, m, p.csp_group).permute(0, 3, 1, 2, 4) \
        .reshape(B, 1, -1, cfg.mla.v_head_dim)
    out = _finish(p, out, x)[:, 0]
    return out[seg] if sh.lay.sp > 1 else out
