"""Model assembly (counterpart of ``repro.models.transformer``): the layer
stack as per-layer modules, its paged KV pools and dense contiguous cache,
and the step bodies: the mixed prefill+decode step and the serialized
prefill and decode steps. The reference's ``lax.scan`` over the stacked
body layers becomes a loop over the per-layer modules."""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.parallel import Layout
from . import blocks as BK
from .attention import cache_init, paged_cache_init
from .layers import (Embedding, LMHead, RMSNorm, distributed_argmax,
                     embed_apply, lmhead_apply)


class Transformer(nn.Module):
    """The parameters of a dense GQA decoder. State-dict names:
    ``embed.table`` [V, d], ``final_norm.scale``, ``lm_head.w`` [d, V] and
    ``layers.{i}.{ln1,attn,ln2,ffn}.*`` with the reference's leaf names."""

    def __init__(self, cfg, lay: Layout, dtype, device):
        super().__init__()
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype, device)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        self.lm_head = LMHead(cfg.d_model, cfg.vocab_size, dtype, device)
        self.layers = nn.ModuleList(BK.Block(cfg, lay, dtype, device)
                                    for _ in range(cfg.num_layers))


@torch.no_grad()
def init_params(params: Transformer, generator: torch.Generator):
    """Random init in place, on the generator's device, with the
    reference's scales (1/sqrt(fan_in) for matrices, 0.02 for the embedding
    and biases, ones for norm scales). The numbers differ from JAX's."""
    params.embed.reset_parameters(generator)
    params.final_norm.reset_parameters()
    params.lm_head.reset_parameters(generator)
    for layer in params.layers:
        layer.reset_parameters(generator)


@dataclass
class PagedPool:
    """K and V block pools of every layer, ``[L, num_blocks, bs, kv_slots,
    Dh]``; ``k[i]`` is layer i's pool. Updated in place by each step."""
    k: torch.Tensor
    v: torch.Tensor


def init_paged_cache(cfg, lay: Layout, num_blocks: int, block_size: int,
                     dtype, device) -> PagedPool:
    """Zeroed pools, one per layer, sharing one block-table indirection (a
    block maps the same token span in every layer)."""
    shape = (cfg.num_layers,) + paged_cache_init(cfg, lay, num_blocks,
                                                 block_size)
    return PagedPool(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))


@dataclass
class DenseCache:
    """K and V caches of every layer, ``[L, B, s_max, kv_slots, Dh]``;
    ``k[i]`` is layer i's. Updated in place by each step."""
    k: torch.Tensor
    v: torch.Tensor


def init_cache(cfg, lay: Layout, batch: int, s_max: int, dtype,
               device) -> DenseCache:
    """Zeroed dense caches, one per layer."""
    shape = (cfg.num_layers,) + cache_init(cfg, lay, batch, s_max)
    return DenseCache(k=torch.zeros(shape, dtype=dtype, device=device),
                      v=torch.zeros(shape, dtype=dtype, device=device))


def _embed_tokens(params: Transformer, tokens):
    """Token embedding (the reference's audio and vision frontends come
    with their model kinds)."""
    return embed_apply(params.embed, tokens)


def _positions_prefill(tokens, offsets):
    """Global cache position of every column, [B, S]."""
    S = tokens.shape[1]
    return offsets[:, None].long() + torch.arange(S, device=tokens.device)[None]


@torch.no_grad()
def mixed_body(params: Transformer, pool: PagedPool, tokens, q_lens, offsets,
               block_tables, cfg, sample: bool = True):
    """Unified mixed prefill+decode step against the paged pool.

    tokens: [B, S]: row b carries ``q_lens[b]`` fresh tokens written at
    cache positions ``offsets[b] ..``; decode rows have q_len == 1,
    chunked-prefill rows up to the chunk width, padding rows 0. Returns the
    greedy next token [B] (or the newest token's logits [B, V] in fp32 with
    ``sample=False``); the pool is updated in place. Padding rows give zero
    logits and token 0."""
    x = _embed_tokens(params, tokens)
    # positions are computed once per step; every layer's RoPE and KV
    # scatter read them
    ctx = {"positions": _positions_prefill(tokens, offsets),
           "offsets": offsets, "q_lens": q_lens, "block_tables": block_tables}
    for i, layer in enumerate(params.layers):
        x = BK.block_prefill(layer, x, pool.k[i], pool.v[i], ctx, cfg)
    # ragged last-token extraction: row b's newest token sits at column
    # q_lens[b]-1. RMSNorm is per row, so the final norm runs on the
    # extracted rows only.
    B, S = x.shape[:2]
    loc = q_lens.long() - 1
    here = (loc >= 0) & (loc < S)
    take = x[torch.arange(B, device=x.device), loc.clamp(0, S - 1)]
    last = torch.where(here[:, None], take, torch.zeros_like(take))
    logits = lmhead_apply(params.lm_head, params.final_norm(last))
    return distributed_argmax(logits) if sample else logits


@torch.no_grad()
def prefill_body(params: Transformer, cache, tokens, offsets, cfg,
                 block_tables=None):
    """One chunked-prefill step. tokens: [B, S] at cache positions
    ``offsets[b] ..``; ``cache`` is the ``DenseCache``, or the ``PagedPool``
    with ``block_tables`` [B, nmax]. Returns the last column's logits
    [B, V] in fp32 (``x[:, -1]``, padding or not, as the reference takes
    it); the cache is updated in place."""
    x = _embed_tokens(params, tokens)
    ctx = {"positions": _positions_prefill(tokens, offsets),
           "offsets": offsets, "block_tables": block_tables}
    for i, layer in enumerate(params.layers):
        x = BK.block_prefill(layer, x, cache.k[i], cache.v[i], ctx, cfg)
    # RMSNorm is per row, so the final norm runs on the last column only
    return lmhead_apply(params.lm_head, params.final_norm(x[:, -1]))


@torch.no_grad()
def decode_body(params: Transformer, cache, tokens, lens, cfg,
                block_tables=None):
    """One decode step. tokens: [B], each written at position ``lens[b]``;
    ``cache`` as in ``prefill_body``. Returns logits [B, V] in fp32; the
    cache is updated in place."""
    x = embed_apply(params.embed, tokens)
    ctx = {"lens": lens, "block_tables": block_tables}
    for i, layer in enumerate(params.layers):
        x = BK.block_decode(layer, x, cache.k[i], cache.v[i], ctx, cfg)
    return lmhead_apply(params.lm_head, params.final_norm(x))


def greedy_body(logits):
    """Greedy sampling on the trivial layout: [B, V] -> [B] token ids."""
    return distributed_argmax(logits)
