"""The architectures the port serves (same numbers as
``repro.configs.archs``): four dense GQA decoders, mamba2 and the hybrid
recurrentgemma-9b (RG-LRU recurrent blocks and local attention), the
vision-language internvl2-2b (a stub vision frontend ahead of a GQA
decoder) and the encoder-decoder whisper-small (a stub audio frontend,
cross attention), the MoE
DeepSeek-V3 (multi-head latent attention, three dense prefix layers ahead
of 58 MoE layers of 256 experts) and Llama-4 Maverick (dense and MoE
layers interleaved), plus the paper's evaluation models (Table 4): the
dense qwen-32b and the MoE qwen-30b-a3b, which fit one card in bf16
(65.52 GB and 61.06 GB of weights), and llama-70b and the MoE
llama4-17b-16e (215.5 GB), which the cost model and the simulator price
and the CPU tests hold at reduced size. deepseek-v3-671b and
llama4-maverick-400b-a17b run at reduced size, or at full width with
their depth cut (``dataclasses.replace(cfg, num_layers=...)``).
"""
from __future__ import annotations

from .base import MLAConfig, ModelConfig, MoEConfig, RGLRUConfig, SSMConfig

QWEN3_8B = ModelConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)

INTERNLM2_1_8B = ModelConfig(
    name="internlm2-1.8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92544, rope_theta=1e6,
    source="arXiv:2403.17297",
)

QWEN2_7B = ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    source="arXiv:2407.10671",
)

QWEN2_1_5B = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
    source="arXiv:2407.10671",
)

MAMBA2_1_3B = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=1, num_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280,
    layer_pattern=("ssd",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=64),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)

# RecurrentGemma / Griffin: repeating (RG-LRU, RG-LRU, local attention); 38
# layers = 12 x pattern + 2 trailing recurrent blocks. MQA (1 KV head),
# window 2048, attention scores soft-capped at 30, GeGLU MLP.
RECURRENTGEMMA_9B = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    layer_pattern=("rglru", "rglru", "local"), suffix_layers=("rglru", "rglru"),
    local_window=2048, rglru=RGLRUConfig(lru_width=4096, conv1d_width=4),
    logits_soft_cap=30.0, act="geglu",
    source="arXiv:2402.19427",
)

DEEPSEEK_V3_671B = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128, head_dim=192,
    d_ff=18432,            # dense layers (first 3)
    vocab_size=129280,
    prefix_layers=("attn", "attn", "attn"), layer_pattern=("moe",),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, d_ff_shared=2048),
    mtp_depth=1,
    source="arXiv:2412.19437",
)

LLAMA4_MAVERICK_400B = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=16384,            # dense (non-MoE) layers
    vocab_size=202048,
    layer_pattern=("attn", "moe"),   # MoE interleaved every 2nd layer
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                  num_shared_experts=1, d_ff_shared=8192),
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family)",
)

LLAMA_70B = ModelConfig(
    name="llama-70b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, rope_theta=5e5,
    source="paper Table 4 / hf:meta-llama/Llama-3.3-70B",
)

QWEN_32B = ModelConfig(
    name="qwen-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    source="paper Table 4 / hf:Qwen/Qwen3-32B",
)

LLAMA4_17B_16E = ModelConfig(
    name="llama4-17b-16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=202048,
    layer_pattern=("moe",),
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192,
                  num_shared_experts=1, d_ff_shared=8192),
    source="paper Table 4 / hf:meta-llama/Llama-4-Scout-17B-16E",
)

QWEN_30B_A3B = ModelConfig(
    name="qwen-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=6144, vocab_size=151936, qk_norm=True,
    layer_pattern=("moe",),
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    source="paper Table 4 / hf:Qwen/Qwen3-30B-A3B",
)

# InternVL2-2B: the InternViT frontend is a stub (the caller hands over
# ``frontend_seq`` precomputed patch embeddings, which replace the token
# embeddings at positions below it) ahead of the InternLM2-1.8B backbone.
INTERNVL2_2B = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92553, rope_theta=1e6,
    frontend="vision_stub", frontend_seq=256,
    source="arXiv:2404.16821",
)

# Whisper-small: encoder-decoder; the conv frontend is a stub (the caller
# hands over the encoder's frame embeddings, 1500 mel frames padded to
# 1536, the SP tile). No RoPE: sinusoidal positions on both sides.
WHISPER_SMALL = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    layer_pattern=("dec",), encoder_layers=12, encoder_seq=1536,
    frontend="audio_stub", act="gelu", norm="layernorm",
    source="arXiv:2212.04356",
)

DENSE_GQA = (QWEN3_8B, QWEN2_7B, QWEN2_1_5B, INTERNLM2_1_8B)
PAPER_MODELS = (LLAMA_70B, QWEN_32B, LLAMA4_17B_16E, QWEN_30B_A3B)
ARCHS = DENSE_GQA + (MAMBA2_1_3B, RECURRENTGEMMA_9B, DEEPSEEK_V3_671B,
                     LLAMA4_MAVERICK_400B, INTERNVL2_2B,
                     WHISPER_SMALL) + PAPER_MODELS
