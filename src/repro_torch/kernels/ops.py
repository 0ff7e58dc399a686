"""The model's entry points to the kernels (counterpart of
``repro.kernels.ops``).

The device of the tensors decides the dispatch: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the hand-written kernel,
which raises if it cannot build or launch. There is no backend switch and
no fallback: a run on the card either went through the kernels or failed.
"""
from __future__ import annotations

import torch

from . import decode_attention as DA
from . import flash_attention as FA
from . import paged_decode_attention as PDA
from . import paged_ragged_attention as PRA
from . import rmsnorm as RMS
from . import ssd_scan as SSD


def _on_cuda(t) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors on {t.device}: the port runs on cuda or cpu")
    return t.is_cuda


def flash_attention(q, k, v, *, causal=True, q_offsets=None):
    """Flash attention in the reference's public layout: q [B, Sq, Hq, D],
    k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D]. ``q_offsets`` [B] int32 places
    row b's first query at that global position (default 0, the TPU
    kernel's alignment); the causal mask is ``kpos <= q_offsets[b] + i``.
    Nothing is transposed or copied: the kernel reads the strides."""
    if q_offsets is None:
        q_offsets = torch.zeros((q.shape[0],), dtype=torch.int32,
                                device=q.device)
    fn = FA.flash_attention_cuda if _on_cuda(q) else FA.flash_attention_plain
    return fn(q, k, v, q_offsets, causal=causal)


def decode_attention(q, k, v, lens):
    """Decode against a contiguous cache: q [B, 1, Hq, D], k/v [B, S, Hkv,
    D] read in place, lens [B] int32 >= 1 (valid length including the new
    token) -> [B, 1, Hq, D]."""
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q.reshape(B, Hkv, Hq // Hkv, D).contiguous()
    fn = DA.decode_attention_cuda if _on_cuda(q) else DA.decode_attention_plain
    return fn(qf, k, v, lens).reshape(B, 1, Hq, D)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lens):
    """Padded paged decode (every table block walked, masked by lens): q
    [B, 1, Hq, D], pools [num_blocks, bs, Hkv, D], block_tables [B, nmax]
    int32, lens [B] int32 >= 1 -> [B, 1, Hq, D]."""
    B, _, Hq, D = q.shape
    Hkv = k_pool.shape[2]
    qf = q.reshape(B, Hkv, Hq // Hkv, D).contiguous()
    fn = (PDA.paged_decode_attention_cuda if _on_cuda(q)
          else PDA.paged_decode_attention_plain)
    return fn(qf, k_pool, v_pool, block_tables, lens).reshape(B, 1, Hq, D)


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
    """RMSNorm over the last axis of x ([..., D]) with scale [D], or
    grouped: x [..., H, D] with one scale row per head, [H, D]."""
    fn = RMS.rmsnorm_cuda if _on_cuda(x) else RMS.rmsnorm_plain
    return fn(x, scale, eps)


def rmsnorm_pair(q, q_scale, k, k_scale, eps=1e-6):
    """A layer's q_norm and k_norm: RMSNorm over the last axis of q and of
    k (one D), each with its own [D] scale, in one kernel launch on the
    card. Returns (q', k')."""
    fn = RMS.rmsnorm_pair_cuda if _on_cuda(q) else RMS.rmsnorm_pair_plain
    return fn(q, q_scale, k, k_scale, eps)


def ssd_chunk(x, b, c, dt, cum, chunk):
    """The SSD intra-chunk step: x [B, S, H, hd] and b/c [B, S, H, ds] read
    in place (b and c may share one group across heads with a head stride
    of 0), dt/cum [B, S, H] fp32 with ``cum`` the within-chunk cumulative
    log decay, S a multiple of ``chunk``. Returns fp32 ``(y_intra [B, S, H,
    hd], state contribution [B, S/chunk, H, hd, ds], exp(cum) [B, S, H])``."""
    fn = SSD.ssd_chunk_cuda if _on_cuda(x) else SSD.ssd_chunk_plain
    return fn(x, b, c, dt, cum, chunk)
