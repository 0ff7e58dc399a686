"""Model assembly (counterpart of ``repro.models.transformer``): the layer
stack as per-layer modules built from the config's layer kinds, its paged
KV pools and dense contiguous cache, and the step bodies: the mixed
prefill+decode step and the serialized prefill and decode steps. The
reference's prefix layers, ``lax.scan`` over the stacked body layers and
suffix layers become one loop over the per-layer modules, in the order of
``cfg.layer_kinds`` (the prefix, the pattern repeated, the suffix), which
is the reference's order; a pattern of several kinds (Maverick's
``("attn", "moe")``) runs its kinds in turn."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch.parallel import Layout, Shard
from repro_torch.parallel.collectives import all_gather_if, psum_if
from . import blocks as BK
from .attention import cache_init
from .mla import mla_cache_shape
from .layers import (Embedding, LMHead, RMSNorm, distributed_argmax,
                     embed_apply, lmhead_apply, tied_lmhead_apply)
from .recurrent import RGLRUState, rglru_state_shapes
from .ssd import SSDState, ssd_state_shapes


class Transformer(nn.Module):
    """The parameters of a decoder whose layers follow ``cfg.layer_kinds``.
    State-dict names: ``embed.table`` [V, d], ``final_norm.scale``,
    ``lm_head.w`` [d, V] unless the embedding is tied, and
    ``layers.{i}.{ln1,attn,ln2,ffn}.*`` for an attention or MoE layer
    (a MoE layer's ``ffn.router``, ``ffn.wi``/``wg``/``wo`` and
    ``ffn.shared.*``; an MLA layer's ``attn.wq_a``, ``q_norm``, ``wq_b``,
    ``wkv_a``, ``kv_norm``, ``wk_b``, ``wv_b`` and ``wo``), the same for
    a local layer, ``layers.{i}.{ln1,mix,ln2,ffn}.*`` for an RG-LRU layer
    (``mix.wx``, ``wy``, ``conv``, ``gate_a``, ``gate_x``, ``lam``,
    ``wo``) or ``layers.{i}.{ln1,mix}.*`` for an SSD layer, with the
    reference's leaf names. Each holds this rank's shard (``shard``;
    the whole tensors on the trivial layout)."""

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        super().__init__()
        self.shard = shard = shard or Shard(lay)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype, device,
                               shard)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        if not cfg.tie_embeddings:
            self.lm_head = LMHead(cfg.d_model, cfg.vocab_size, dtype, device,
                                  shard)
        self.layers = nn.ModuleList(
            BK.BLOCKS[kind](cfg, lay, dtype, device, shard)
            for kind in cfg.layer_kinds)


def _logits(params: Transformer, x):
    """Final norm and LM head (the tied table when there is no lm_head):
    [..., d] -> this tp rank's vocabulary columns [..., v_blk] in fp32."""
    x = params.final_norm(x)
    if hasattr(params, "lm_head"):
        return lmhead_apply(params.lm_head, x)
    return tied_lmhead_apply(params.embed, x)


@torch.no_grad()
def init_params(params: Transformer, generator: torch.Generator):
    """Random init in place, on the generator's device, with the
    reference's scales (1/sqrt(fan_in) for matrices, 0.02 for the embedding
    and biases, ones for norm scales). The numbers differ from JAX's."""
    params.embed.reset_parameters(generator)
    params.final_norm.reset_parameters()
    if hasattr(params, "lm_head"):
        params.lm_head.reset_parameters(generator)
    for layer in params.layers:
        layer.reset_parameters(generator)


@dataclass
class PagedPool:
    """K and V block pools of every layer, ``[L, num_blocks, bs, kv_slots,
    Dh]``; ``k[i]`` is layer i's pool. Updated in place by each step."""
    k: torch.Tensor
    v: torch.Tensor

    def layer(self, i):
        return self.k[i], self.v[i]


def init_paged_cache(cfg, lay: Layout, num_blocks: int, block_size: int,
                     dtype, device) -> PagedPool:
    """Zeroed pools, one per layer, sharing one block-table indirection (a
    block maps the same token span in every layer). Raises for a config
    with a layer kind that does not page."""
    shapes = {BK.block_paged_cache_init(kind, cfg, lay, num_blocks,
                                        block_size)
              for kind in cfg.layer_kinds}
    shape = (cfg.num_layers,) + shapes.pop()
    return PagedPool(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))


# the kinds whose layers share one stacked cache, by the cache's group
CACHE_GROUP = {"attn": "attn", "moe": "attn", "local": "local",
               "ssd": "ssd", "rglru": "rglru"}


@dataclass
class DenseCache:
    """One rank's contiguous cache of every layer, stacked by kind and
    updated in place by each step: its dp row's ``B`` slots and its model
    rank's heads or channels (the reference's ``cache_specs`` shard,
    ``P(dp, None, h, None)``). Attention and MoE layers: K and V
    ``[n_attn, B, s_max, kv_per_rank, Dh]``, or with MLA the latent
    ``lat`` [n_attn, B, s_max/cache_sp, kv_lora + rope], the rank's
    sequence chunk (``mla_cache_specs``' ``P(dp, cache_sp, None)``).
    Local layers: the ring's ``ring_k`` and ``ring_v`` [n_local, B,
    min(s_max, window), kv_per_rank, Dh]. SSD layers: ``ssm`` [n_ssd, B,
    hpr, hd, ds] in fp32, ``conv_x`` [n_ssd, B, cw-1, hpr·hd] and
    ``conv_bc`` [n_ssd, B, cw-1, 2·ds]. RG-LRU layers: ``h`` [n_rglru, B,
    w/G] in fp32 and ``conv`` [n_rglru, B, cw-1, w/G]. A kind the config
    lacks has None. ``kinds[i]`` and ``index[i]`` give layer i's kind and
    its index among the layers of its cache (``CACHE_GROUP``: the
    attention and MoE layers together, the local, the SSD or the RG-LRU
    layers)."""
    kinds: tuple
    index: tuple
    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    lat: Optional[torch.Tensor] = None
    ring_k: Optional[torch.Tensor] = None
    ring_v: Optional[torch.Tensor] = None
    ssm: Optional[torch.Tensor] = None
    conv_x: Optional[torch.Tensor] = None
    conv_bc: Optional[torch.Tensor] = None
    h: Optional[torch.Tensor] = None
    conv: Optional[torch.Tensor] = None

    FIELDS = ("k", "v", "lat", "ring_k", "ring_v", "ssm", "conv_x",
              "conv_bc", "h", "conv")

    def tensors(self) -> dict:
        """The cache's tensors by field name, those of kinds the config
        lacks left out."""
        return {name: t for name in self.FIELDS
                if (t := getattr(self, name)) is not None}

    def layer(self, i):
        """Layer i's cache: (K, V) views (a local layer's of its ring), an
        MLA layer's latent view, an ``SSDState`` or an ``RGLRUState`` of
        views."""
        j, kind = self.index[i], self.kinds[i]
        if kind == "ssd":
            return SSDState(self.ssm[j], self.conv_x[j], self.conv_bc[j])
        if kind == "rglru":
            return RGLRUState(self.h[j], self.conv[j])
        if kind == "local":
            return self.ring_k[j], self.ring_v[j]
        if self.lat is not None:
            return self.lat[j]
        return self.k[j], self.v[j]


def init_cache(cfg, lay: Layout, batch: int, s_max: int, dtype,
               device) -> DenseCache:
    """Zeroed dense caches of every layer, one rank's: ``batch`` rows (its
    dp row's) at its heads or channels, or with MLA its chunk of the
    sequence; a local layer's ring holds ``min(s_max, local_window)``
    rows."""
    kinds = cfg.layer_kinds
    group = tuple(CACHE_GROUP[k] for k in kinds)
    index = tuple(group[:i].count(g) for i, g in enumerate(group))
    c = DenseCache(kinds=kinds, index=index)
    n = {g: group.count(g) for g in set(CACHE_GROUP.values())}

    def zeros(count, shape, dt=dtype):
        return torch.zeros((count,) + tuple(shape), dtype=dt, device=device)

    if n["attn"] and cfg.mla is not None:
        c.lat = zeros(n["attn"], mla_cache_shape(cfg, lay, batch, s_max))
    elif n["attn"]:
        shape = cache_init(cfg, lay, batch, s_max)
        c.k, c.v = zeros(n["attn"], shape), zeros(n["attn"], shape)
    if n["local"]:
        shape = cache_init(cfg, lay, batch, min(s_max, cfg.local_window))
        c.ring_k, c.ring_v = zeros(n["local"], shape), zeros(n["local"],
                                                             shape)
    if n["ssd"]:
        ssm, cx, cbc = ssd_state_shapes(cfg, lay, batch)
        c.ssm = zeros(n["ssd"], ssm, torch.float32)
        c.conv_x, c.conv_bc = zeros(n["ssd"], cx), zeros(n["ssd"], cbc)
    if n["rglru"]:
        h, conv = rglru_state_shapes(cfg, lay, batch)
        c.h = zeros(n["rglru"], h, torch.float32)
        c.conv = zeros(n["rglru"], conv)
    return c


def _embed_tokens(params: Transformer, tokens):
    """Token embedding (the reference's audio and vision frontends come
    with their model kinds)."""
    return embed_apply(params.embed, tokens)


def _positions_prefill(offsets, S: int):
    """Global cache positions of a chunk's S columns, [B, S]: the whole
    chunk, which every attention layer sees after its exchange (an sp
    rank's own columns start at ``sp_rank * S/sp``)."""
    return offsets[:, None].long() + torch.arange(S, device=offsets.device)[None]


@torch.no_grad()
def mixed_body(params: Transformer, pool: PagedPool, tokens, q_lens, offsets,
               block_tables, cfg, sample: bool = True, n_last: int = 1):
    """Unified mixed prefill+decode step against the paged pool.

    tokens: [B, S_loc], this sp rank's contiguous columns of a chunk of
    S_loc·sp (all of it without SP): row b carries ``q_lens[b]`` fresh
    tokens written at cache positions ``offsets[b] ..``; decode rows have
    q_len == 1 (plus up to k draft tokens when the engine verifies a
    speculation), chunked-prefill rows up to the chunk width, padding rows
    0. Returns the greedy next token [B] (or the newest token's logits,
    this tp rank's vocabulary columns [B, v_blk] in fp32, with
    ``sample=False``); the pool is updated in place. Padding rows give zero
    logits and token 0. Only for configs whose every layer pages.

    ``n_last`` (static) is the speculative verify width: with n_last > 1
    the extraction takes each row's last ``n_last`` global columns
    ``q_lens[b] - n_last .. q_lens[b] - 1`` and returns [B, n_last] tokens
    (or [B, n_last, v_blk] logits); columns before the row's start give
    zero logits and a token the engine ignores. n_last == 1 is the
    single-token path, unchanged."""
    if cfg.mla is not None or any(kind not in ("attn", "moe")
                                  for kind in cfg.layer_kinds):
        raise ValueError(f"{cfg.name}: the mixed step runs on the paged pool, "
                         "which only GQA attention layers have")
    sh = params.shard
    B, S_loc = tokens.shape
    x = _embed_tokens(params, tokens)
    # every attention layer sees the whole chunk after its exchange: its
    # positions are computed once per step, and each layer's RoPE and KV
    # scatter read them
    ctx = {"positions": _positions_prefill(offsets, S_loc * sh.lay.sp),
           "offsets": offsets, "q_lens": q_lens, "block_tables": block_tables}
    for i, layer in enumerate(params.layers):
        x = BK.block_prefill(layer, x, pool.layer(i), ctx, cfg)
    # ragged last-token extraction: row b's newest token sits at chunk
    # column q_lens[b]-1, which lives on exactly one sp rank; the others
    # give zeros and the SP sum collects it. RMSNorm is per row, so the
    # final norm runs on the extracted rows only.
    if n_last == 1:
        loc = q_lens.long() - 1 - sh.sp_rank * S_loc
        here = (loc >= 0) & (loc < S_loc)
        take = x[torch.arange(B, device=x.device), loc.clamp(0, S_loc - 1)]
        last = torch.where(here[:, None], take, torch.zeros_like(take))
    else:
        # the last n_last global columns of each row, each on exactly one
        # sp rank; columns before the row's start are masked too
        cols = (q_lens.long()[:, None] - n_last
                + torch.arange(n_last, device=x.device)[None])
        loc = cols - sh.sp_rank * S_loc                       # [B, n_last]
        here = (loc >= 0) & (loc < S_loc) & (cols >= 0)
        take = x[torch.arange(B, device=x.device)[:, None],
                 loc.clamp(0, S_loc - 1)]
        last = torch.where(here[..., None], take, torch.zeros_like(take))
    logits = _logits(params, psum_if(last, sh.sp_group))
    return distributed_argmax(logits, sh) if sample else logits


@torch.no_grad()
def prefill_body(params: Transformer, cache, tokens, offsets, cfg,
                 block_tables=None):
    """One chunked-prefill step. tokens: [B, S_loc], this sp rank's
    contiguous columns of a chunk of S_loc·sp at cache positions
    ``offsets[b] ..``; ``cache`` is the ``DenseCache``, or the
    ``PagedPool`` with ``block_tables`` [B, nmax]. Returns the chunk's
    last column's logits (this tp rank's vocabulary columns [B, v_blk] in
    fp32; ``x[:, -1]``, padding or not, as the reference takes it): the
    last sp rank holds that column, and the SP sum hands it to the others.
    The cache is updated in place."""
    sh = params.shard
    x = _embed_tokens(params, tokens)
    ctx = {"positions": _positions_prefill(offsets,
                                           tokens.shape[1] * sh.lay.sp),
           "offsets": offsets, "block_tables": block_tables}
    for i, layer in enumerate(params.layers):
        x = BK.block_prefill(layer, x, cache.layer(i), ctx, cfg)
    last = x[:, -1]
    if sh.sp_group is not None:
        last = (last.contiguous() if sh.sp_rank == sh.lay.sp - 1
                else last.new_zeros(last.shape))
    # RMSNorm is per row, so the final norm runs on the last column only
    return _logits(params, psum_if(last, sh.sp_group))


@torch.no_grad()
def decode_body(params: Transformer, cache, tokens, lens, cfg,
                block_tables=None):
    """One decode step. tokens: [B_loc], this sp rank's contiguous segment
    of its dp row's B_row rows; lens [B_row] (and ``block_tables`` [B_row,
    nmax]) the row's, row b written at position ``lens[b]``; ``cache`` as
    in ``prefill_body``. Returns the segment's logits (this tp rank's
    vocabulary columns, [B_loc, v_blk] in fp32); the cache is updated in
    place."""
    x = embed_apply(params.embed, tokens)
    ctx = {"lens": lens, "block_tables": block_tables}
    for i, layer in enumerate(params.layers):
        x = BK.block_decode(layer, x, cache.layer(i), ctx, cfg)
    return _logits(params, x)


def greedy_body(logits, shard: Shard):
    """Distributed greedy sampling of a decode step: [B_loc, v_blk] -> the
    dp row's [B_row] token ids, the argmax over TP and the segments
    all-gathered over SP."""
    return all_gather_if(distributed_argmax(logits, shard), shard.sp_group)
