"""Model configuration of the port's architectures.

The port's own copy of the fields of ``repro.configs.base.ModelConfig``
that its two layer kinds use: ``"attn"`` (GQA attention with SwiGLU and
RMSNorm) and ``"ssd"`` (the Mamba-2 SSD mixer, with ``SSMConfig``).
``reduced()`` cuts widths and depth exactly as the reference's ``reduced()``
does for such a model.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block parameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64               # intra-chunk SSD block length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # "dense" (attn layers) | "ssm" (ssd layers)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    layer_pattern: tuple = ("attn",)     # repeated; "attn" or "ssd"
    qk_norm: bool = False         # RMSNorm over q and k per head (qwen3)
    qkv_bias: bool = False        # bias on the q/k/v projections (qwen2)
    rope_theta: float = 1e4
    logits_soft_cap: float = 0.0
    ssm: Optional[SSMConfig] = None
    tie_embeddings: bool = False  # the LM head is the embedding table
    norm_eps: float = 1e-6
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    @property
    def pattern_repeats(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def layer_kinds(self) -> tuple:
        """Concrete kind of every layer, in execution order."""
        assert self.num_layers % len(self.layer_pattern) == 0, (
            f"{self.name}: {self.num_layers} layers do not tile with "
            f"pattern {self.layer_pattern}")
        return tuple(self.layer_pattern) * self.pattern_repeats

    def num_params(self) -> int:
        """Parameter count of the port's modules: the embedding, the LM head
        unless tied, the norm scales, and per layer q/k/v/o with SwiGLU
        (three matrices) or the SSD mixer (z/x/bc/dt projections, dt_bias,
        A_log, D, the two convolutions, the grouped norm and wo)."""
        d, dh = self.d_model, self.head_dim
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2) + d
        for kind in self.layer_kinds:
            if kind == "attn":
                attn = d * dh * (self.num_heads + 2 * self.num_kv_heads) \
                    + self.num_heads * dh * d
                if self.qkv_bias:
                    attn += dh * (self.num_heads + 2 * self.num_kv_heads)
                if self.qk_norm:
                    attn += 2 * dh
                n += attn + 3 * d * self.d_ff + 2 * d
            else:
                s = self.ssm
                di, nh, ds = s.d_inner(d), s.n_heads(d), s.d_state
                n += d * (2 * di + 2 * ds + nh) + 3 * nh \
                    + s.d_conv * (di + 2 * ds) + di + di * d + d
        return n

    def reduced(self) -> "ModelConfig":
        """The CPU-test size: one full pattern repetition of at least 2
        layers, d_model 64, 4 query heads, at most 2 KV heads, head_dim
        16, d_ff 128, vocab 256; an SSD mixer of d_state 16, head_dim 16
        and chunk 8."""
        pat = len(self.layer_pattern)
        kw = dict(num_layers=pat * max(1, 2 // pat), d_model=64, num_heads=4,
                  num_kv_heads=min(self.num_kv_heads, 2), head_dim=16,
                  d_ff=128, vocab_size=256)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2,
                                  head_dim=16, chunk=8)
        return replace(self, **kw)
