"""Model assembly (counterpart of ``repro.models.transformer``): the layer
stack as per-layer modules built from the config's layer kinds, its paged
KV pools and dense contiguous cache, and the step bodies: the mixed
prefill+decode step and the serialized prefill and decode steps. The
reference's ``lax.scan`` over the stacked body layers becomes a loop over
the per-layer modules."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch.parallel import Layout, Shard
from repro_torch.parallel.collectives import psum_if
from . import blocks as BK
from .attention import cache_init
from .layers import (Embedding, LMHead, RMSNorm, distributed_argmax,
                     embed_apply, lmhead_apply, tied_lmhead_apply)
from .ssd import SSDState, ssd_state_shapes


class Transformer(nn.Module):
    """The parameters of a decoder whose layers follow ``cfg.layer_kinds``.
    State-dict names: ``embed.table`` [V, d], ``final_norm.scale``,
    ``lm_head.w`` [d, V] unless the embedding is tied, and
    ``layers.{i}.{ln1,attn,ln2,ffn}.*`` for an attention layer or
    ``layers.{i}.{ln1,mix}.*`` for an SSD layer, with the reference's leaf
    names. Each holds this rank's shard (``shard``; the whole tensors on
    the trivial layout)."""

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


@dataclass
class DenseCache:
    """The contiguous cache of every layer, stacked by kind and updated in
    place by each step. Attention layers: K and V ``[n_attn, B, s_max,
    kv_slots, Dh]``. SSD layers: ``ssm`` [n_ssd, B, H, hd, ds] in fp32,
    ``conv_x`` [n_ssd, B, cw-1, H·hd] and ``conv_bc`` [n_ssd, B, cw-1,
    2·ds]. A kind the config lacks has None. ``kinds[i]`` and ``index[i]``
    give layer i's kind and its index among the layers of that kind."""
    kinds: tuple
    index: tuple
    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    ssm: Optional[torch.Tensor] = None
    conv_x: Optional[torch.Tensor] = None
    conv_bc: Optional[torch.Tensor] = None

    def layer(self, i):
        """Layer i's cache: (K, V) views, or an ``SSDState`` of views."""
        j = self.index[i]
        if self.kinds[i] == "ssd":
            return SSDState(self.ssm[j], self.conv_x[j], self.conv_bc[j])
        return self.k[j], self.v[j]


def init_cache(cfg, lay: Layout, batch: int, s_max: int, dtype,
               device) -> DenseCache:
    """Zeroed dense caches of every layer."""
    kinds = cfg.layer_kinds
    index = tuple(kinds[:i].count(k) for i, k in enumerate(kinds))
    c = DenseCache(kinds=kinds, index=index)
    n_attn, n_ssd = kinds.count("attn"), kinds.count("ssd")
    if n_attn:
        shape = (n_attn,) + cache_init(cfg, lay, batch, s_max)
        c.k = torch.zeros(shape, dtype=dtype, device=device)
        c.v = torch.zeros(shape, dtype=dtype, device=device)
    if n_ssd:
        ssm, cx, cbc = ssd_state_shapes(cfg, lay, batch)
        c.ssm = torch.zeros((n_ssd,) + ssm, dtype=torch.float32,
                            device=device)
        c.conv_x = torch.zeros((n_ssd,) + cx, dtype=dtype, device=device)
        c.conv_bc = torch.zeros((n_ssd,) + cbc, dtype=dtype, device=device)
    return c


def _embed_tokens(params: Transformer, tokens):
    """Token embedding (the reference's audio and vision frontends come
    with their model kinds)."""
    return embed_apply(params.embed, tokens)


def _positions_prefill(offsets, S: int):
    """Global cache positions of a chunk's S columns, [B, S]."""
    return offsets[:, None].long() + torch.arange(S, device=offsets.device)[None]


@torch.no_grad()
def mixed_body(params: Transformer, pool: PagedPool, tokens, q_lens, offsets,
               block_tables, cfg, sample: bool = True):
    """Unified mixed prefill+decode step against the paged pool.

    tokens: [B, S_loc], this sp rank's contiguous columns of a chunk of
    S_loc·sp (all of it without SP): row b carries ``q_lens[b]`` fresh
    tokens written at cache positions ``offsets[b] ..``; decode rows have
    q_len == 1, chunked-prefill rows up to the chunk width, padding rows 0.
    Returns the greedy next token [B] (or the newest token's logits, this
    tp rank's vocabulary columns [B, v_blk] in fp32, with
    ``sample=False``); the pool is updated in place. Padding rows give zero
    logits and token 0. Only for configs whose every layer pages."""
    if any(kind != "attn" for kind in cfg.layer_kinds):
        raise ValueError(f"{cfg.name}: the mixed step runs on the paged pool, "
                         "which only attention layers have")
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
    loc = q_lens.long() - 1 - sh.sp_rank * S_loc
    here = (loc >= 0) & (loc < S_loc)
    take = x[torch.arange(B, device=x.device), loc.clamp(0, S_loc - 1)]
    last = torch.where(here[:, None], take, torch.zeros_like(take))
    logits = _logits(params, psum_if(last, sh.sp_group))
    return distributed_argmax(logits, sh) if sample else logits


@torch.no_grad()
def prefill_body(params: Transformer, cache, tokens, offsets, cfg,
                 block_tables=None):
    """One chunked-prefill step. tokens: [B, S] at cache positions
    ``offsets[b] ..``; ``cache`` is the ``DenseCache``, or the ``PagedPool``
    with ``block_tables`` [B, nmax]. Returns the last column's logits
    [B, V] in fp32 (``x[:, -1]``, padding or not, as the reference takes
    it); the cache is updated in place."""
    x = _embed_tokens(params, tokens)
    ctx = {"positions": _positions_prefill(offsets, tokens.shape[1]),
           "offsets": offsets, "block_tables": block_tables}
    for i, layer in enumerate(params.layers):
        x = BK.block_prefill(layer, x, cache.layer(i), ctx, cfg)
    # RMSNorm is per row, so the final norm runs on the last column only
    return _logits(params, x[:, -1])


@torch.no_grad()
def decode_body(params: Transformer, cache, tokens, lens, cfg,
                block_tables=None):
    """One decode step. tokens: [B], each written at position ``lens[b]``;
    ``cache`` as in ``prefill_body``. Returns logits [B, V] in fp32; the
    cache is updated in place."""
    x = embed_apply(params.embed, tokens)
    ctx = {"lens": lens, "block_tables": block_tables}
    for i, layer in enumerate(params.layers):
        x = BK.block_decode(layer, x, cache.layer(i), ctx, cfg)
    return _logits(params, x)


def greedy_body(logits):
    """Greedy sampling on the trivial layout: [B, V] -> [B] token ids."""
    return distributed_argmax(logits)
