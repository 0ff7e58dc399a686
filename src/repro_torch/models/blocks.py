"""Pre-norm residual blocks (counterpart of ``repro.models.blocks``) for the
port's two layer kinds: ``"attn"`` (attention + SwiGLU MLP) and ``"ssd"``
(the Mamba-2 mixer alone, no ln2 and no FFN)."""
from __future__ import annotations

from torch import nn

from repro_torch.parallel import Layout, Shard
from . import attention as A
from . import ssd as S
from .layers import MLP, RMSNorm, mlp_apply


class Block(nn.Module):
    kind = "attn"

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        super().__init__()
        d = cfg.d_model
        shard = shard or Shard(lay)
        self.ln1 = RMSNorm(d, dtype, device, cfg.norm_eps)
        self.attn = A.Attention(cfg, lay, dtype, device, shard)
        self.ln2 = RMSNorm(d, dtype, device, cfg.norm_eps)
        self.ffn = MLP(d, cfg.d_ff, dtype, device, shard)

    def reset_parameters(self, generator):
        self.ln1.reset_parameters()
        self.attn.reset_parameters(generator)
        self.ln2.reset_parameters()
        self.ffn.reset_parameters(generator)


class SSDBlock(nn.Module):
    kind = "ssd"

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        # the SSD mixer runs only the trivial layout (``Model`` refuses an
        # SSD config above world size 1), so ``shard`` is that layout's
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        self.mix = S.SSD(cfg, lay, dtype, device)

    def reset_parameters(self, generator):
        self.ln1.reset_parameters()
        self.mix.reset_parameters(generator)


BLOCKS = {"attn": Block, "ssd": SSDBlock}


def block_paged_cache_init(kind, cfg, lay: Layout, num_blocks: int,
                           block_size: int):
    """Shape of one layer's K (and V) block pool. Only attention layers
    page; an SSD layer keeps per-sequence recurrent state, so a config with
    one keeps the contiguous cache."""
    if kind == "attn":
        return A.paged_cache_init(cfg, lay, num_blocks, block_size)
    raise ValueError(f"layer kind {kind!r} does not support a paged cache")


def block_prefill(p, x, cache, ctx, cfg):
    """x: [B, S, d]; ctx: dict(positions, offsets, q_lens, block_tables).
    One layer of a prefill-shaped step, dispatched by the layer's kind as
    the reference's ``block_prefill``. An attention layer's ``cache`` is its
    (K, V) pools or dense caches: ``q_lens`` -> the mixed paged step, block
    tables alone -> the paged chunked prefill, neither -> the dense cache.
    An SSD layer's is its ``SSDState``. The cache is updated in place."""
    h = p.ln1(x)
    if p.kind == "ssd":
        return x + S.ssd_prefill(p.mix, h, cache, cfg)
    k_cache, v_cache = cache
    if ctx.get("q_lens") is not None:
        a = A.paged_attn_mixed(p.attn, h, k_cache, v_cache, ctx["positions"],
                               ctx["offsets"], ctx["q_lens"],
                               ctx["block_tables"], cfg)
    elif ctx.get("block_tables") is not None:
        a = A.paged_attn_prefill(p.attn, h, k_cache, v_cache,
                                 ctx["positions"], ctx["offsets"],
                                 ctx["block_tables"], cfg)
    else:
        a = A.attn_prefill(p.attn, h, k_cache, v_cache, ctx["offsets"], cfg)
    x = x + a
    return x + mlp_apply(p.ffn, p.ln2(x))


def block_decode(p, x, cache, ctx, cfg):
    """x: [B, d]; ctx: dict(lens, block_tables). One layer of a decode
    step: an SSD layer steps its state; an attention layer attends through
    the block table when there is one, else against the dense cache."""
    h = p.ln1(x)
    if p.kind == "ssd":
        return x + S.ssd_decode(p.mix, h, cache, cfg)
    k_cache, v_cache = cache
    if ctx.get("block_tables") is not None:
        a = A.paged_attn_decode(p.attn, h, k_cache, v_cache, ctx["lens"],
                                ctx["block_tables"], cfg)
    else:
        a = A.attn_decode(p.attn, h, k_cache, v_cache, ctx["lens"], cfg)
    x = x + a
    return x + mlp_apply(p.ffn, p.ln2(x))
