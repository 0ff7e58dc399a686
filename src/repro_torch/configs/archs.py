"""The architectures the port serves (same numbers as
``repro.configs.archs``): four dense GQA decoders and mamba2."""
from __future__ import annotations

from .base import ModelConfig, SSMConfig

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

DENSE_GQA = (QWEN3_8B, QWEN2_7B, QWEN2_1_5B, INTERNLM2_1_8B)
ARCHS = DENSE_GQA + (MAMBA2_1_3B,)
