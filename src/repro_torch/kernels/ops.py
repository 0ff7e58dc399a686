"""The model's entry points to the kernels (counterpart of
``repro.kernels.ops``).

The device of the tensors decides the dispatch: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the hand-written kernel,
which raises if it cannot build or launch. There is no backend switch and
no fallback: a run on the card either went through the kernels or failed.

Training differentiates through flash attention, RMSNorm and the SSD
chunk: while autograd records (an input requires grad) ``flash_attention``,
``rmsnorm``, ``rmsnorm_pair`` and ``ssd_chunk`` run as
``torch.autograd.Function``s (``FlashAttention``, ``RMSNorm``,
``RMSNormPair``, ``SSDChunk``) whose forward is the kernel (or the plain
version on the CPU) and whose backward is the backward kernel (or its
plain version), dispatched by device as the forward is. The serving path
runs under ``no_grad`` and calls the forward kernels directly.
"""
from __future__ import annotations

import torch

from ..parallel.collectives import recording
from . import decode_attention as DA
from . import flash_attention as FA
from . import flash_attention_bwd as FAB
from . import paged_decode_attention as PDA
from . import paged_ragged_attention as PRA
from . import rmsnorm as RMS
from . import rmsnorm_bwd as RMSB
from . import ssd_chunk_bwd as SSDB
from . import ssd_scan as SSD

# every kernel's module, by the name its launch counter is reported under
KERNELS = {"paged_ragged_attention": PRA, "flash_attention": FA,
           "decode_attention": DA, "paged_decode_attention": PDA,
           "rmsnorm": RMS, "ssd_chunk": SSD, "flash_attention_bwd": FAB,
           "rmsnorm_bwd": RMSB, "ssd_chunk_bwd": SSDB}


def launch_counts() -> dict:
    """Every kernel's launch counter, by kernel name."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts():
    for mod in KERNELS.values():
        mod.launches = 0


def add_launch_counts(delta: dict):
    """Add ``delta`` (kernel name -> launches) to the counters: the launches
    of a replayed CUDA graph, whose wrappers do not run."""
    for name, n in delta.items():
        KERNELS[name].launches += n


def _on_cuda(t) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors on {t.device}: the port runs on cuda or cpu")
    return t.is_cuda


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel's training
    instance saves each row's log-sum-exp, the backward kernel reads it."""

    @staticmethod
    def forward(ctx, q, k, v, q_offsets, causal):
        fn = (FA.flash_attention_cuda if _on_cuda(q)
              else FA.flash_attention_plain)
        out, lse = fn(q, k, v, q_offsets, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_offsets)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_offsets = ctx.saved_tensors
        fn = (FAB.flash_attention_bwd_cuda if _on_cuda(q)
              else FAB.flash_attention_bwd_plain)
        dq, dk, dv = fn(q, k, v, out, lse, dout, q_offsets, causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, q_offsets=None):
    """Flash attention in the reference's public layout: q [B, Sq, Hq, D],
    k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D]. ``q_offsets`` [B] int32 places
    row b's first query at that global position (default 0, the TPU
    kernel's alignment); the causal mask is ``kpos <= q_offsets[b] + i``.
    Nothing is transposed or copied: the kernel reads the strides. While
    autograd records, ``FlashAttention`` carries the gradient."""
    if q_offsets is None:
        q_offsets = torch.zeros((q.shape[0],), dtype=torch.int32,
                                device=q.device)
    if recording(q, k, v):
        return FlashAttention.apply(q, k, v, q_offsets, causal)
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
                        window=0, soft_cap=0.0, pad_cols=False):
    """Work-proportional paged attention in the model's head-minor layout.

    q: [B, C, Hq, D], C ragged query columns (columns >= q_lens[b] are
    padding); k_pool/v_pool: [num_blocks, bs, Hkv, D]; block_tables:
    [B, nmax] int32; q_lens/ctx_lens: [B] int32 -> [B, C, Hq, D].
    ``pad_cols=True`` has the kernel compute the padding columns as the
    plain version does (a MoE model's); without it they come back as zeros
    on the card."""
    B, C, Hq, D = q.shape
    Hkv = k_pool.shape[2]
    g = Hq // Hkv
    qf = q.transpose(1, 2).reshape(B, Hkv, g, C, D)
    fn = (PRA.paged_ragged_attention_cuda if _on_cuda(q)
          else PRA.paged_ragged_attention_plain)
    out = fn(qf.contiguous(), k_pool, v_pool, block_tables, q_lens, ctx_lens,
             window=window, soft_cap=soft_cap, pad_cols=pad_cols)
    return out.reshape(B, Hq, C, D).transpose(1, 2)


class RMSNorm(torch.autograd.Function):
    """RMSNorm with its gradient (dx and dscale)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        fn = RMS.rmsnorm_cuda if _on_cuda(x) else RMS.rmsnorm_plain
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return fn(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        fn = RMSB.rmsnorm_bwd_cuda if _on_cuda(x) else RMSB.rmsnorm_bwd_plain
        dx, dscale = fn(x, scale, dy, ctx.eps)
        return dx, dscale, None


class RMSNormPair(torch.autograd.Function):
    """A layer's q_norm and k_norm with their gradients: one backward call
    over both, as the forward is one launch."""

    @staticmethod
    def forward(ctx, q, q_scale, k, k_scale, eps):
        fn = RMS.rmsnorm_pair_cuda if _on_cuda(q) else RMS.rmsnorm_pair_plain
        ctx.save_for_backward(q, q_scale, k, k_scale)
        ctx.eps = eps
        return fn(q, q_scale, k, k_scale, eps)

    @staticmethod
    def backward(ctx, dq, dk):
        q, q_scale, k, k_scale = ctx.saved_tensors
        fn = (RMSB.rmsnorm_pair_bwd_cuda if _on_cuda(q)
              else RMSB.rmsnorm_pair_bwd_plain)
        return (*fn(q, q_scale, dq, k, k_scale, dk, ctx.eps), None)


def rmsnorm(x, scale, eps=1e-6):
    """RMSNorm over the last axis of x ([..., D]) with scale [D], or
    grouped: x [..., H, D] with one scale row per head, [H, D].
    Differentiable (``RMSNorm``) while autograd records."""
    if recording(x, scale):
        return RMSNorm.apply(x, scale, eps)
    fn = RMS.rmsnorm_cuda if _on_cuda(x) else RMS.rmsnorm_plain
    return fn(x, scale, eps)


def rmsnorm_pair(q, q_scale, k, k_scale, eps=1e-6):
    """A layer's q_norm and k_norm: RMSNorm over the last axis of q and of
    k (one D), each with its own [D] scale, in one kernel launch on the
    card. Returns (q', k'). Differentiable (``RMSNormPair``) while
    autograd records."""
    if recording(q, q_scale, k, k_scale):
        return RMSNormPair.apply(q, q_scale, k, k_scale, eps)
    fn = RMS.rmsnorm_pair_cuda if _on_cuda(q) else RMS.rmsnorm_pair_plain
    return fn(q, q_scale, k, k_scale, eps)


class SSDChunk(torch.autograd.Function):
    """The SSD intra-chunk step with its gradient. b and c are the one
    group every head shares, [B, S, ds]; the forward kernel reads them
    with a head stride of 0, and the backward returns their gradients in
    that shape, summed over the heads. The forward saves its inputs, not
    the [L, L] products: the backward forms them again."""

    @staticmethod
    def forward(ctx, x, b, c, dt, cum, chunk):
        fn = SSD.ssd_chunk_cuda if _on_cuda(x) else SSD.ssd_chunk_plain
        ctx.save_for_backward(x, b, c, dt, cum)
        ctx.chunk = chunk
        return fn(x, *_per_head(x, b, c), dt, cum, chunk)

    @staticmethod
    def backward(ctx, dy, dst, ddec):
        x, b, c, dt, cum = ctx.saved_tensors
        fn = (SSDB.ssd_chunk_bwd_cuda if _on_cuda(x)
              else SSDB.ssd_chunk_bwd_plain)
        dx, db, dc, ddt, dcum = fn(x, b, c, dt, cum, dy, dst, ddec, ctx.chunk)
        return (dx.to(x.dtype), db.to(b.dtype), dc.to(c.dtype), ddt, dcum,
                None)


def _per_head(x, b, c):
    """b and c of one group [B, S, ds] seen as [B, S, H, ds] with a head
    stride of 0 (no copy)."""
    B, S, H, _ = x.shape
    return (b[:, :, None].expand(B, S, H, b.shape[-1]),
            c[:, :, None].expand(B, S, H, c.shape[-1]))


def ssd_chunk(x, b, c, dt, cum, chunk):
    """The SSD intra-chunk step: x [B, S, H, hd] and b/c read in place,
    either one group [B, S, ds] that every head shares or [B, S, H, ds]
    (a head stride of 0 shares one group), dt/cum [B, S, H] fp32 with
    ``cum`` the within-chunk cumulative log decay, S a multiple of
    ``chunk``. Returns fp32 ``(y_intra [B, S, H, hd], state contribution
    [B, S/chunk, H, hd, ds], exp(cum) [B, S, H])``. While autograd records
    (one group only), ``SSDChunk`` carries the gradient."""
    if recording(x, b, c, dt, cum):
        if b.dim() != 3:
            raise ValueError("the differentiable SSD chunk takes b and c as "
                             f"one group [B, S, ds], got {tuple(b.shape)}")
        return SSDChunk.apply(x, b, c, dt, cum, chunk)
    if b.dim() == 3:
        b, c = _per_head(x, b, c)
    fn = SSD.ssd_chunk_cuda if _on_cuda(x) else SSD.ssd_chunk_plain
    return fn(x, b, c, dt, cum, chunk)
