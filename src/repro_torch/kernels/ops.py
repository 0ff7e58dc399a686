"""The model's entry points to the kernels (counterpart of
``repro.kernels.ops``).

The device of the tensors decides the dispatch: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the hand-written kernel,
which raises if it cannot build or launch. There is no backend switch and
no fallback: a run on the card either went through the kernels or failed.
"""
from __future__ import annotations

from . import paged_ragged_attention as PRA
from . import rmsnorm as RMS


def _on_cuda(t) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors on {t.device}: the port runs on cuda or cpu")
    return t.is_cuda


def paged_ragged_attend(q, k_pool, v_pool, block_tables, q_lens, ctx_lens, *,
                        window=0, soft_cap=0.0):
    """Work-proportional paged attention in the model's head-minor layout.

    q: [B, C, Hq, D], C ragged query columns (columns >= q_lens[b] are
    padding); k_pool/v_pool: [num_blocks, bs, Hkv, D]; block_tables:
    [B, nmax] int32; q_lens/ctx_lens: [B] int32 -> [B, C, Hq, D]."""
    B, C, Hq, D = q.shape
    Hkv = k_pool.shape[2]
    g = Hq // Hkv
    qf = q.transpose(1, 2).reshape(B, Hkv, g, C, D)
    fn = (PRA.paged_ragged_attention_cuda if _on_cuda(q)
          else PRA.paged_ragged_attention_plain)
    out = fn(qf.contiguous(), k_pool, v_pool, block_tables, q_lens, ctx_lens,
             window=window, soft_cap=soft_cap)
    return out.reshape(B, Hq, C, D).transpose(1, 2)


def rmsnorm(x, scale, eps=1e-6):
    """RMSNorm over the last axis of x ([..., D]) with scale [D]."""
    fn = RMS.rmsnorm_cuda if _on_cuda(x) else RMS.rmsnorm_plain
    return fn(x, scale, eps)
