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

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel import Layout, Shard
from repro_torch.parallel.collectives import all_gather_if, psum_if
from . import blocks as BK
from .attention import cache_init
from .mla import mla_cache_shape
from .layers import (Embedding, LMHead, dense_init, distributed_argmax,
                     distributed_xent, embed_apply, empty_param,
                     lmhead_apply, make_norm, tied_lmhead_apply)
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
    ``wo``), ``layers.{i}.{ln1,mix}.*`` for an SSD layer, or
    ``layers.{i}.{ln1,attn,lnx,cross,ln2,ffn}.*`` for a decoder layer,
    with the reference's leaf names; an encoder-decoder config also has
    ``encoder.{e}.{ln1,attn,ln2,ffn}.*`` and ``enc_norm.*``. A LayerNorm
    has ``scale`` and ``bias``, a plain GELU MLP no ``wg``. A config with
    ``mtp_depth`` also has ``mtp.{proj,block,norm}.*`` (``MTP``), which
    serving never reads. Each holds this rank's shard (``shard``; the
    whole tensors on the trivial layout)."""

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        super().__init__()
        self.shard = shard = shard or Shard(lay)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype, device,
                               shard)
        self.final_norm = make_norm(cfg, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = LMHead(cfg.d_model, cfg.vocab_size, dtype, device,
                                  shard)
        self.layers = nn.ModuleList(
            BK.BLOCKS[kind](cfg, lay, dtype, device, shard)
            for kind in cfg.layer_kinds)
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(
                BK.EncBlock(cfg, lay, dtype, device, shard)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = make_norm(cfg, dtype, device)
        if cfg.mtp_depth:
            self.mtp = MTP(cfg, lay, dtype, device, shard)


class MTP(nn.Module):
    """DeepSeek-V3's multi-token prediction head (the reference's
    ``params["mtp"]``): ``proj`` [2d, d] (replicated, ``P(None, None)``),
    ``block``, an ``attn`` block of the config (MLA with the dense MLP for
    deepseek) and ``norm``. Training alone reads it (``loss_body``)."""

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard):
        super().__init__()
        self.proj = empty_param((2 * cfg.d_model, cfg.d_model), dtype,
                                device)
        self.block = BK.Block(cfg, lay, dtype, device, shard)
        self.norm = make_norm(cfg, dtype, device)

    def reset_parameters(self, generator):
        self.proj.copy_(dense_init(tuple(self.proj.shape), generator,
                                   torch.float32).to(self.proj.dtype))
        self.block.reset_parameters(generator)
        self.norm.reset_parameters()


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
    and biases, ones for norm scales). The numbers differ from JAX's. The
    MTP head is drawn last, so that a seed's serving weights do not depend
    on it."""
    params.embed.reset_parameters(generator)
    params.final_norm.reset_parameters()
    if hasattr(params, "lm_head"):
        params.lm_head.reset_parameters(generator)
    for layer in params.layers:
        layer.reset_parameters(generator)
    if hasattr(params, "encoder"):
        for layer in params.encoder:
            layer.reset_parameters(generator)
        params.enc_norm.reset_parameters()
    if hasattr(params, "mtp"):
        params.mtp.reset_parameters(generator)


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
CACHE_GROUP = {"attn": "attn", "moe": "attn", "dec": "attn",
               "local": "local", "ssd": "ssd", "rglru": "rglru"}


@dataclass
class DenseCache:
    """One rank's contiguous cache of every layer, stacked by kind and
    updated in place by each step: its dp row's ``B`` slots and its model
    rank's heads or channels (the reference's ``cache_specs`` shard,
    ``P(dp, None, h, None)``). Attention and MoE layers: K and V
    ``[n_attn, B, s_max, kv_per_rank, Dh]``, or with MLA the latent
    ``lat`` [n_attn, B, s_max/cache_sp, kv_lora + rope], the rank's
    sequence chunk (``mla_cache_specs``' ``P(dp, cache_sp, None)``).
    Decoder layers: their self K and V among the attention layers', and
    the cross K and V ``cross_k``/``cross_v`` [n_dec, B, S_enc,
    kv_per_rank, Dh], the encoder's frames at the same kv slots. Local
    layers: the ring's ``ring_k`` and ``ring_v`` [n_local, B,
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
    cross_k: Optional[torch.Tensor] = None
    cross_v: Optional[torch.Tensor] = None

    FIELDS = ("k", "v", "lat", "ring_k", "ring_v", "ssm", "conv_x",
              "conv_bc", "h", "conv", "cross_k", "cross_v")

    def tensors(self) -> dict:
        """The cache's tensors by field name, those of kinds the config
        lacks left out."""
        return {name: t for name in self.FIELDS
                if (t := getattr(self, name)) is not None}

    def layer(self, i):
        """Layer i's cache: (K, V) views (a local layer's of its ring; a
        decoder layer's self and cross K, V), an MLA layer's latent view,
        an ``SSDState`` or an ``RGLRUState`` of views."""
        j, kind = self.index[i], self.kinds[i]
        if kind == "dec":
            c = self.kinds[:i].count("dec")
            return self.k[j], self.v[j], self.cross_k[c], self.cross_v[c]
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
    if n_dec := kinds.count("dec"):
        shape = cache_init(cfg, lay, batch, cfg.encoder_seq)
        c.cross_k, c.cross_v = zeros(n_dec, shape), zeros(n_dec, shape)
    return c


def _sin_pos(positions, d: int):
    """Sinusoidal position embedding [..., d] in fp32 (the whisper-style
    frontends): sines then cosines of ``positions · exp(-i·ln(1e4) /
    (d/2 - 1))``, i < d/2."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed_tokens(params: Transformer, tokens, offsets, cfg,
                  frontend_embeds=None):
    """Token embedding with the reference's frontends, on this sp rank's
    own columns [B, S_loc] at positions ``offsets + sp_rank·S_loc + j``
    (the embedding runs before the exchange): the audio family adds the
    sinusoid there; the vision stub replaces the embedding at positions
    below ``frontend_seq`` by that image embedding (``frontend_embeds``
    [B, frontend_seq, d], the rank's rows)."""
    x = embed_apply(params.embed, tokens)
    vision = frontend_embeds is not None and cfg.frontend == "vision_stub"
    if cfg.family != "audio" and not vision:
        return x
    S_loc = tokens.shape[1]
    pos = offsets[:, None].long() + params.shard.sp_rank * S_loc \
        + torch.arange(S_loc, device=tokens.device)[None]
    if cfg.family == "audio":
        x = x + _sin_pos(pos, cfg.d_model).to(x.dtype)
    if vision:
        fs = cfg.frontend_seq
        idx = pos.clamp(0, fs - 1)[..., None].expand(*pos.shape, cfg.d_model)
        img = torch.gather(frontend_embeds, 1, idx)
        x = torch.where((pos < fs)[..., None], img.to(x.dtype), x)
    return x


def _run_encoder(params: Transformer, frames, cfg):
    """The encoder over this sp rank's frames [B, S_enc_loc, d] (its
    contiguous part of the sequence, at positions ``sp_rank·S_loc + j``),
    then its final norm: the encoder's output, the rank's frames."""
    S_loc = frames.shape[1]
    pos = params.shard.sp_rank * S_loc + torch.arange(S_loc,
                                                      device=frames.device)
    x = frames + _sin_pos(pos, cfg.d_model).to(frames.dtype)
    for layer in params.encoder:
        x = BK.block_encode(layer, x, cfg)
    return params.enc_norm(x)


def _positions_prefill(offsets, S: int):
    """Global cache positions of a chunk's S columns, [B, S]: the whole
    chunk, which every attention layer sees after its exchange (an sp
    rank's own columns start at ``sp_rank * S/sp``)."""
    return offsets[:, None].long() + torch.arange(S, device=offsets.device)[None]


@torch.no_grad()
def mixed_body(params: Transformer, pool: PagedPool, tokens, q_lens, offsets,
               block_tables, cfg, sample: bool = True, n_last: int = 1,
               frontend_embeds=None):
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
    single-token path, unchanged. ``frontend_embeds`` [B, frontend_seq,
    d] (the vision stub's) replace the embedding of every column below
    ``frontend_seq``, decode rows' included, as the reference's mixed step
    does."""
    if cfg.mla is not None or any(kind not in ("attn", "moe")
                                  for kind in cfg.layer_kinds):
        raise ValueError(f"{cfg.name}: the mixed step runs on the paged pool, "
                         "which only GQA attention layers have")
    sh = params.shard
    B, S_loc = tokens.shape
    x = _embed_tokens(params, tokens, offsets, cfg, frontend_embeds)
    # every attention layer sees the whole chunk after its exchange: its
    # positions are computed once per step, and each layer's RoPE and KV
    # scatter read them
    ctx = {"positions": _positions_prefill(offsets, S_loc * sh.lay.sp),
           "offsets": offsets, "q_lens": q_lens, "block_tables": block_tables}
    for i, layer in enumerate(params.layers):
        x = BK.block_prefill(layer, x, pool.layer(i), ctx, cfg)
    # ragged last-token extraction: row b's newest token sits at chunk
    # column q_lens[b]-1, which lives on exactly one sp rank; the others
    # give zeros and the SP sum collects it. The norm is per row, so the
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
                 block_tables=None, frontend_embeds=None, enc_frames=None):
    """One chunked-prefill step. tokens: [B, S_loc], this sp rank's
    contiguous columns of a chunk of S_loc·sp at cache positions
    ``offsets[b] ..``; ``cache`` is the ``DenseCache``, or the
    ``PagedPool`` with ``block_tables`` [B, nmax]. Returns the chunk's
    last column's logits (this tp rank's vocabulary columns [B, v_blk] in
    fp32; ``x[:, -1]``, padding or not, as the reference takes it): the
    last sp rank holds that column, and the SP sum hands it to the others.
    The cache is updated in place. ``frontend_embeds`` [B, frontend_seq,
    d] are the vision stub's; an encoder-decoder config runs its encoder
    over ``enc_frames`` [B, S_enc_loc, d] (the rank's frames) in every
    prefill step and rewrites every row's cross cache from it, as the
    reference's ``init_cross`` does."""
    sh = params.shard
    S_loc = tokens.shape[1]
    x = _embed_tokens(params, tokens, offsets, cfg, frontend_embeds)
    ctx = {"positions": _positions_prefill(offsets, S_loc * sh.lay.sp),
           "offsets": offsets, "block_tables": block_tables}
    if cfg.encoder_layers:
        if enc_frames is None:
            raise ValueError(f"{cfg.name}: a prefill step runs the encoder "
                             "over enc_frames; none were given")
        ctx["enc_out"] = _run_encoder(params, enc_frames, cfg)
    for i, layer in enumerate(params.layers):
        x = BK.block_prefill(layer, x, cache.layer(i), ctx, cfg)
    last = x[:, -1]
    if sh.sp_group is not None:
        last = (last.contiguous() if sh.sp_rank == sh.lay.sp - 1
                else last.new_zeros(last.shape))
    # the norm is per row, so the final norm runs on the last column only
    return _logits(params, psum_if(last, sh.sp_group))


@torch.no_grad()
def decode_body(params: Transformer, cache, tokens, lens, cfg,
                block_tables=None):
    """One decode step. tokens: [B_loc], this sp rank's contiguous segment
    of its dp row's B_row rows; lens [B_row] (and ``block_tables`` [B_row,
    nmax]) the row's, row b written at position ``lens[b]``; ``cache`` as
    in ``prefill_body``. Returns the segment's logits (this tp rank's
    vocabulary columns, [B_loc, v_blk] in fp32); the cache is updated in
    place. The audio family adds the sinusoid at the segment's ``lens``;
    the vision stub is not applied (the reference's decode step has
    none)."""
    x = embed_apply(params.embed, tokens)
    if cfg.family == "audio":
        B_loc = tokens.shape[0]
        i = params.shard.sp_rank
        x = x + _sin_pos(lens[i * B_loc:(i + 1) * B_loc],
                         cfg.d_model).to(x.dtype)
    ctx = {"lens": lens, "block_tables": block_tables}
    for i, layer in enumerate(params.layers):
        x = BK.block_decode(layer, x, cache.layer(i), ctx, cfg)
    return _logits(params, x)


def greedy_body(logits, shard: Shard):
    """Distributed greedy sampling of a decode step: [B_loc, v_blk] -> the
    dp row's [B_row] token ids, the argmax over TP and the segments
    all-gathered over SP."""
    return all_gather_if(distributed_argmax(logits, shard), shard.sp_group)


def check_trainable(cfg):
    """Raise ``NotImplementedError`` for a config whose training is not
    ported, naming the sub-item of ROADMAP Queue 1 item 4 that ports it:
    GQA or MLA attention stacks train, with the dense FFN or MoE layers and
    DeepSeek-V3's MTP head, and so do SSD stacks (no RG-LRU, no local or
    soft-capped attention, no frontend, no encoder)."""
    kinds = set(cfg.layer_kinds)
    if kinds & {"rglru", "local"} or cfg.logits_soft_cap:
        why, item = "the RG-LRU and local or soft-capped attention", "4.4"
    elif cfg.encoder_layers or cfg.frontend != "none" \
            or kinds & {"enc", "dec"}:
        why, item = "the encoder and vision frontends", "4.5"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: training {why} is not ported (ROADMAP Queue 1 item "
        f"{item}; item 4 lists the training slices left)")


def _train_layer(remat, fn, *args):
    """``fn(*args)``, recomputed in the backward with ``remat``
    (``torch.utils.checkpoint`` without reentrancy)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _xent_sum(params: Transformer, x, labels, group):
    """The final norm, the head and the cross-entropy over the TP vocab
    shards of ``x`` [B, S_loc, d] against ``labels`` (< 0 not counted):
    (the nll sum, the count), each summed over ``group``."""
    nll = distributed_xent(_logits(params, x), labels, params.shard)
    valid = (labels >= 0).float()
    return psum_if((nll * valid).sum(), group), psum_if(valid.sum(), group)


def loss_body(params: Transformer, tokens, labels, cfg, remat: bool = True):
    """Training loss (the reference's ``loss_body``): the mean next-token
    nll over the global batch, DeepSeek-V3's MTP term and the MoE layers'
    aux loss. tokens/labels: [B_loc, S_loc], this rank's rows and columns
    (labels < 0 are not counted). Embedding, every layer
    (``blocks.block_train``; with ``remat`` each layer is recomputed in the
    backward, ``torch.utils.checkpoint`` without reentrancy, as the
    reference's ``jax.checkpoint`` per superblock; a MoE layer's recompute
    routes as its forward did, the sort being stable), the final norm, the
    LM head (the tied table when there is none) and the cross-entropy over
    the TP vocab shards; the loss sum and the token count are summed over
    (dp, sp). A config with an MTP head adds 0.3 times its mean nll: the
    head's ``proj`` of ``[norm(x), embed(max(labels, 0))]`` (x the last
    layer's output before the final norm), its ``attn`` block, the final
    norm and the head, against the labels shifted one to the left within
    the rank's segment with -1 appended (so each sp rank's last column is
    not counted, as the reference's local shift does), its sum and count
    summed over (dp, sp). The layers' aux losses are summed in layer order
    (the reference's prefix, body and suffix), then summed over (dp, sp)
    and divided by dp·sp; a stack without MoE layers adds none. Returns the
    loss, a 0-d fp32 tensor, the same on every rank (a MoE stack's: on the
    ranks of one tp index, once the tp ranks' copies of a router have
    drifted apart, as the reference's devices' do); its gradients are the
    reference's per-device gradients (``psum`` transposes to ``psum``:
    ROADMAP Queue 3). Its callers, ``Model.loss_fn`` and the ``Trainer``,
    refuse a config that does not train (``check_trainable``)."""
    sh = params.shard
    B, S_loc = tokens.shape
    x = embed_apply(params.embed, tokens)
    pos = _positions_prefill(torch.zeros((B,), dtype=torch.long,
                                         device=tokens.device),
                             S_loc * sh.lay.sp)
    aux = 0.0
    for layer in params.layers:
        x, a = _train_layer(remat, BK.block_train, layer, x, pos, cfg)
        aux = aux + a
    group = sh.axes_group(("data", "sp") if sh.lay.sp > 1 else ("data",))
    loss_sum, count = _xent_sum(params, x, labels, group)
    loss = loss_sum / count.clamp(min=1.0)
    if cfg.mtp_depth and hasattr(params, "mtp"):
        mp = params.mtp
        emb_next = embed_apply(params.embed, labels.clamp(min=0))
        hin = torch.cat([mp.norm(x), emb_next], dim=-1) @ mp.proj
        hm, _ = _train_layer(remat, BK.block_train, mp.block, hin, pos, cfg)
        lab2 = torch.cat([labels[:, 1:], labels.new_full((B, 1), -1)], 1)
        l2, c2 = _xent_sum(params, hm, lab2, group)
        loss = loss + 0.3 * l2 / c2.clamp(min=1.0)
    if isinstance(aux, torch.Tensor):
        loss = loss + psum_if(aux, group) / (sh.lay.dp * sh.lay.sp)
    return loss
