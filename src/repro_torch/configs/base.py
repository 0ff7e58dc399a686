"""Model configuration of the port's dense GQA decoders.

The port's own copy of the fields of ``repro.configs.base.ModelConfig`` that
a dense GQA decoder with SwiGLU and RMSNorm uses; ``reduced()`` cuts widths
and depth exactly as the reference's ``reduced()`` does for such a model.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # "dense": every layer is attention + MLP
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    qk_norm: bool = False         # RMSNorm over q and k per head (qwen3)
    qkv_bias: bool = False        # bias on the q/k/v projections (qwen2)
    rope_theta: float = 1e4
    logits_soft_cap: float = 0.0
    norm_eps: float = 1e-6
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    def num_params(self) -> int:
        """Parameter count: untied embedding and LM head, q/k/v/o, SwiGLU
        (three matrices) and the norm scales."""
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * dh * d
        if self.qkv_bias:
            attn += dh * (self.num_heads + 2 * self.num_kv_heads)
        if self.qk_norm:
            attn += 2 * dh
        layer = attn + 3 * d * self.d_ff + 2 * d
        return 2 * self.vocab_size * d + self.num_layers * layer + d

    def reduced(self) -> "ModelConfig":
        """The CPU-test size: 2 layers, d_model 64, 4 query heads, at most
        2 KV heads, head_dim 16, d_ff 128, vocab 256."""
        return replace(self, num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=min(self.num_kv_heads, 2), head_dim=16,
                       d_ff=128, vocab_size=256)
