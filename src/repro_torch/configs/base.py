"""Model configuration of the port's architectures.

The port's own copy of the fields of ``repro.configs.base.ModelConfig``
that its five layer kinds use: ``"attn"`` (GQA attention, or multi-head
latent attention with ``MLAConfig``, with a gated MLP and RMSNorm),
``"local"`` (the same attention over a sliding window of
``local_window`` keys, a ring cache), ``"moe"`` (the attention with the
Mixture-of-Experts FFN, ``MoEConfig``), ``"rglru"`` (Griffin's RG-LRU
recurrent block with the MLP, ``RGLRUConfig``), ``"ssd"`` (the Mamba-2
SSD mixer, with ``SSMConfig``) and ``"dec"`` (whisper's decoder layer:
rope-free causal self-attention, cross attention over the encoder's
output, the MLP), with ``encoder_layers`` rope-free non-causal encoder
layers over ``encoder_seq`` frames ahead of the stack; the stub frontends
(``frontend``: ``"audio_stub"``, frames handed to the encoder, or
``"vision_stub"``, ``frontend_seq`` image embeddings in place of the
first token embeddings); the norm (``norm``: ``"rmsnorm"`` or
``"layernorm"``, scale and bias); the MLP's activation ``act``
(``"silu"``: SwiGLU, ``"geglu"``: GeGLU with tanh-approximated GELU,
``"gelu"``: a plain MLP through the tanh-approximated GELU, no gate); the
logit soft cap of the attention scores; the layer stack
(``prefix_layers``, the repeated ``layer_pattern``, ``suffix_layers``),
and ``mtp_depth`` (DeepSeek-V3's multi-token prediction head, which
serving does not read). ``reduced()`` cuts widths and depth exactly as the
reference's ``reduced()`` does for such a model.
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
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def cache_dim(self) -> int:
        # compressed latent + decoupled rope key, per token per layer
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclass(frozen=True)
class MoEConfig:
    """The reference's MoE fields (``repro.configs.base.MoEConfig``)."""

    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0          # per-expert intermediate size
    num_shared_experts: int = 0
    d_ff_shared: int = 0          # shared-expert intermediate (0 -> d_ff_expert)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001  # load-balance aux loss (training only)
    dispatch_dtype: str = "bf16"    # "int8" halves EP all-to-all traffic


@dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU (RecurrentGemma / Griffin) recurrent block."""

    lru_width: int = 0            # 0 -> d_model
    conv1d_width: int = 4

    def width(self, d_model: int) -> int:
        return self.lru_width or d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    layer_pattern: tuple = ("attn",)     # repeated: attn, local, moe, rglru,
    #                                      ssd or dec
    prefix_layers: tuple = ()            # run before the repeated pattern
    suffix_layers: tuple = ()            # run after the repeated pattern
    qk_norm: bool = False         # RMSNorm over q and k per head (qwen3)
    qkv_bias: bool = False        # bias on the q/k/v projections (qwen2)
    local_window: int = 0         # for "local" (sliding-window) layers
    rope_theta: float = 1e4
    logits_soft_cap: float = 0.0
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    act: str = "silu"             # silu (SwiGLU) | geglu | gelu (no gate)
    norm: str = "rmsnorm"         # rmsnorm | layernorm (scale and bias)
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder_layers: int = 0       # whisper-style encoder depth
    encoder_seq: int = 1500       # encoder frames (stub frontend)
    frontend: str = "none"        # none | vision_stub | audio_stub
    frontend_seq: int = 0         # image embeddings of the vision stub
    mtp_depth: int = 0            # DeepSeek-V3 multi-token prediction
    tie_embeddings: bool = False  # the LM head is the embedding table
    norm_eps: float = 1e-6
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    @property
    def pattern_repeats(self) -> int:
        body = self.num_layers - len(self.prefix_layers) \
            - len(self.suffix_layers)
        return body // len(self.layer_pattern)

    @property
    def layer_kinds(self) -> tuple:
        """Concrete kind of every layer, in execution order: the prefix,
        the pattern repeated, the suffix."""
        body = self.num_layers - len(self.prefix_layers) \
            - len(self.suffix_layers)
        assert body >= 0 and body % len(self.layer_pattern) == 0, (
            f"{self.name}: {self.num_layers} layers do not tile with "
            f"pattern {self.layer_pattern} + prefix {self.prefix_layers} "
            f"+ suffix {self.suffix_layers}")
        return (tuple(self.prefix_layers)
                + tuple(self.layer_pattern) * self.pattern_repeats
                + tuple(self.suffix_layers))

    def _attn_params(self) -> int:
        """One attention layer's projection matrices: q/k/v/o, or MLA's
        down and up projections and its O (the reference's count)."""
        d, dh = self.d_model, self.head_dim
        if self.mla is None:
            return d * dh * (self.num_heads + 2 * self.num_kv_heads) \
                + self.num_heads * dh * d
        m, h = self.mla, self.num_heads
        return (d * m.q_lora_rank
                + m.q_lora_rank * h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                + h * m.v_head_dim * d)

    def _mlp_params(self) -> int:
        """One MLP's matrices: three with a gate (SwiGLU, GeGLU), two for
        the plain GELU MLP."""
        return (3 if self.act in ("silu", "geglu") else 2) \
            * self.d_model * self.d_ff

    def num_params(self) -> int:
        """Parameter count of the port's modules: the embedding, the LM head
        unless tied, the norms (a scale, and a bias for LayerNorm), and per
        layer q/k/v/o (or MLA's projections and its two latent norms) with
        the MLP or the MoE FFN (the router, every expert's three matrices
        and the shared experts'), a decoder layer's cross attention and its
        norm besides, the RG-LRU mixer (the x, y and out projections, the
        conv, the two block-diagonal gates over 16 channel blocks and Λ)
        with the MLP, or the SSD mixer (z/x/bc/dt projections, dt_bias,
        A_log, D, the two convolutions, the grouped norm and wo); the
        encoder's layers (attention, MLP, two norms) and its final norm;
        the multi-token prediction head (``proj`` [2d, d], an ``attn``
        layer's parameters, a norm), which only training reads."""
        d, dh = self.d_model, self.head_dim
        nd = 2 * d if self.norm == "layernorm" else d
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2) + nd
        mlp = self._mlp_params()
        kinds = self.layer_kinds + ("enc",) * self.encoder_layers \
            + ("attn",) * min(self.mtp_depth, 1)
        if self.encoder_layers:
            n += nd
        if self.mtp_depth:
            n += 2 * d * d + nd
        for kind in kinds:
            if kind in ("attn", "local", "moe", "dec", "enc"):
                attn = self._attn_params()
                if self.mla is not None:
                    attn += self.mla.q_lora_rank + self.mla.kv_lora_rank
                if self.qkv_bias:
                    attn += dh * (self.num_heads + 2 * self.num_kv_heads)
                if self.qk_norm:
                    attn += 2 * dh
                n += attn + 2 * nd
                if kind == "dec":
                    n += self._attn_params() + nd
                    if self.qkv_bias:
                        n += dh * (self.num_heads + 2 * self.num_kv_heads)
                if kind != "moe":
                    n += mlp
                else:
                    mo = self.moe
                    n += d * mo.num_experts + mo.num_experts * 3 * d \
                        * mo.d_ff_expert + mo.num_shared_experts * 3 * d \
                        * (mo.d_ff_shared or mo.d_ff_expert)
            elif kind == "rglru":
                r = self.rglru
                w = r.width(d)
                n += 3 * d * w + r.conv1d_width * w + 2 * w * (w // 16) \
                    + w + 2 * nd + mlp
            else:
                s = self.ssm
                di, nh, ds = s.d_inner(d), s.n_heads(d), s.d_state
                n += d * (2 * di + 2 * ds + nh) + 3 * nh \
                    + s.d_conv * (di + 2 * ds) + di + di * d + nd
        return n

    def active_params(self) -> int:
        """Parameters one token's forward pass multiplies by, as the
        reference counts them (``repro.configs.base.ModelConfig``'s
        ``num_params`` and ``active_params``): the embedding, the LM head
        unless tied, per layer the attention (or MLA) projections and the
        MLP's matrices (of a MoE layer only the routed top-k experts, the
        shared experts and the router; a decoder layer's cross attention
        besides), or the SSD projections and convolutions. It leaves out
        the norm scales, biases and the SSD's per-head vectors that
        ``num_params`` counts, and the encoder's layers, so that the cost
        model prices the reference's numbers."""
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds:
            if kind in ("attn", "local", "moe", "dec"):
                n += self._attn_params()
            if kind == "dec":
                n += self._attn_params()
            if kind == "moe":
                mo = self.moe
                n += mo.top_k * 3 * d * mo.d_ff_expert
                n += mo.num_shared_experts * 3 * d * (mo.d_ff_shared
                                                      or mo.d_ff_expert)
                n += d * mo.num_experts                       # router
            elif kind in ("attn", "local", "dec"):
                n += self._mlp_params()
            elif kind == "ssd":
                s = self.ssm
                di = s.d_inner(d)
                n += d * (2 * di + 2 * s.d_state + s.n_heads(d))
                n += di * d + s.d_conv * (di + 2 * s.d_state)
            elif kind == "rglru":
                r = self.rglru
                w = r.width(d)
                n += 2 * d * w + w * d + r.conv1d_width * w + 2 * w
                n += 2 * w * w // 8
        return n

    def reduced(self) -> "ModelConfig":
        """The CPU-test size: one full pattern repetition of at least 2
        layers, plus the first prefix and the first suffix layer, d_model
        64, 4 query heads, at most 2 KV heads, head_dim 16, d_ff 128,
        vocab 256, ``mtp_depth`` at most 1, at most 2 encoder layers over
        16 frames, at most 8 image embeddings; an SSD mixer of d_state 16,
        head_dim 16 and chunk 8; an RG-LRU of width 64; MLA, MoE and a
        local window (8) cut as the reference cuts them."""
        pat = len(self.layer_pattern)
        kw = dict(num_layers=pat * max(1, 2 // pat)
                  + len(self.prefix_layers[:1]) + len(self.suffix_layers[:1]),
                  prefix_layers=self.prefix_layers[:1],
                  suffix_layers=self.suffix_layers[:1], d_model=64,
                  num_heads=4, num_kv_heads=min(self.num_kv_heads, 2),
                  head_dim=16, d_ff=128, vocab_size=256,
                  encoder_layers=min(self.encoder_layers, 2), encoder_seq=16,
                  frontend_seq=min(self.frontend_seq, 8),
                  mtp_depth=min(self.mtp_depth, 1))
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16)
        if self.moe is not None:
            kw["moe"] = replace(self.moe, num_experts=4,
                                top_k=min(self.moe.top_k, 2), d_ff_expert=32,
                                d_ff_shared=32)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2,
                                  head_dim=16, chunk=8)
        if self.rglru is not None:
            kw["rglru"] = RGLRUConfig(lru_width=64, conv1d_width=4)
        if self.local_window:
            kw["local_window"] = 8
        return replace(self, **kw)
