"""The pre-norm residual attention block (counterpart of
``repro.models.blocks`` for the ``"attn"`` kind)."""
from __future__ import annotations

from torch import nn

from repro_torch.parallel import Layout
from . import attention as A
from .layers import MLP, RMSNorm, mlp_apply


class Block(nn.Module):
    def __init__(self, cfg, lay: Layout, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = RMSNorm(d, dtype, device, cfg.norm_eps)
        self.attn = A.Attention(cfg, lay, dtype, device)
        self.ln2 = RMSNorm(d, dtype, device, cfg.norm_eps)
        self.ffn = MLP(d, cfg.d_ff, dtype, device)

    def reset_parameters(self, generator):
        self.ln1.reset_parameters()
        self.attn.reset_parameters(generator)
        self.ln2.reset_parameters()
        self.ffn.reset_parameters(generator)


def block_prefill(p: Block, x, k_cache, v_cache, ctx, cfg):
    """x: [B, S, d]; ctx: dict(positions, offsets, q_lens, block_tables).
    One layer of a prefill-shaped step, dispatched as the reference's
    ``block_prefill``: ``q_lens`` -> the mixed paged step, block tables
    alone -> the paged chunked prefill, neither -> the dense cache. The
    layer's K/V land in ``k_cache``/``v_cache`` (its pools or its dense
    cache) in place."""
    h = p.ln1(x)
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


def block_decode(p: Block, x, k_cache, v_cache, ctx, cfg):
    """x: [B, d]; ctx: dict(lens, block_tables). One layer of a decode
    step: through the block table when there is one, else against the
    dense cache."""
    h = p.ln1(x)
    if ctx.get("block_tables") is not None:
        a = A.paged_attn_decode(p.attn, h, k_cache, v_cache, ctx["lens"],
                                ctx["block_tables"], cfg)
    else:
        a = A.attn_decode(p.attn, h, k_cache, v_cache, ctx["lens"], cfg)
    x = x + a
    return x + mlp_apply(p.ffn, p.ln2(x))
