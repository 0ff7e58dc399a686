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


def block_prefill(p: Block, x, k_pool, v_pool, ctx, cfg):
    """x: [B, S, d]; ctx: dict(positions, offsets, q_lens, block_tables).
    One layer of the mixed paged step; its K/V land in the pools in
    place."""
    h = p.ln1(x)
    a = A.paged_attn_mixed(p.attn, h, k_pool, v_pool, ctx["positions"],
                           ctx["offsets"], ctx["q_lens"], ctx["block_tables"],
                           cfg)
    x = x + a
    return x + mlp_apply(p.ffn, p.ln2(x))
