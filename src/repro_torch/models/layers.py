"""Shared layers (counterpart of ``repro.models.layers``). Weights keep the
reference's ``[in, out]`` layout and apply as ``x @ w``. Each module holds
this rank's shard of its weights (``Shard``; the trivial layout's shard is
the whole tensor) and sums or gathers over its TP group as the reference
does: the MLP is column- then row-parallel with a TP psum, and the
embedding table and the LM head are vocab-sharded over TP only, each tp
rank holding ``G/tp`` contiguous shards of ``ceil(V/G)`` rows, zero-padded
past V.

Sharded parameters are drawn as the reference's canonical tensors, one at
a time, and only this rank's part is kept, so a sharded model holds exactly
the trivial model's weights from the same generator."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as K
from repro_torch.parallel.collectives import all_gather_if, pmax_sg, psum_if
from repro_torch.parallel.layout import Shard


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init(shape, generator: torch.Generator, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal init with the reference's scale rule: 1/sqrt(shape[-2]) for
    a matrix (or 1/sqrt(shape[-1]) for a vector) unless ``scale`` is
    given. Drawn on the generator's device, and scaled in place, so that a
    full-width draw (the embedding's 2.5 GB in fp32) is held once."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32).mul_(s).to(dtype)


def shard_of(full, dim: int, n: int, k: int):
    """Part ``k`` of ``n`` equal contiguous parts of ``full`` along
    ``dim``."""
    size = full.shape[dim] // n
    if size * n != full.shape[dim]:
        raise ValueError(f"axis {dim} of {tuple(full.shape)} does not split "
                         f"{n} ways")
    return full.narrow(dim, k * size, size)


def vocab_rows(vocab: int, lay) -> int:
    """Vocabulary rows a tp rank holds: ``G/tp`` shards of ``ceil(V/G)``."""
    G = max(lay.G, 1)
    return (G // max(lay.tp, 1)) * -(-vocab // G)


def vocab_shard(full, dim: int, lay, tp_rank: int):
    """A tp rank's rows (``dim`` 0) or columns (``dim`` 1) of a [V, d] table
    or a [d, V] head, zero-padded past V to ``G·ceil(V/G)``."""
    G = max(lay.G, 1)
    pad = G * -(-full.shape[dim] // G) - full.shape[dim]
    if pad:
        shape = list(full.shape)
        shape[dim] = pad
        full = torch.cat([full, full.new_zeros(shape)], dim=dim)
    return shard_of(full, dim, max(lay.tp, 1), tp_rank)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps: float = 1e-6):
    """``(x·rsqrt(mean(x²)+eps))`` in fp32, cast to x's type, times scale:
    the RMSNorm kernel on the card, its plain version on the CPU."""
    return K.rmsnorm(x, scale, eps)


def rmsnorm_pair(q, q_scale, k, k_scale, eps: float = 1e-6):
    """``rmsnorm`` of q and of k, each with its own scale: one kernel
    launch on the card, two plain calls on the CPU."""
    return K.rmsnorm_pair(q, q_scale, k, k_scale, eps)


class RMSNorm(nn.Module):
    def __init__(self, d, dtype, device, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = empty_param((d,), dtype, device)

    def reset_parameters(self, generator=None):
        self.scale.fill_(1.0)

    def forward(self, x):
        return rmsnorm(x, self.scale, self.eps)


def layernorm(x, scale, bias, eps: float = 1e-6):
    """``(x - mean)·rsqrt(var + eps)`` in fp32, cast to x's type, times
    scale plus bias (the reference's ``layernorm``). No TPU kernel computes
    it, so it stays plain PyTorch."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


class LayerNorm(nn.Module):
    def __init__(self, d, dtype, device, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = empty_param((d,), dtype, device)
        self.bias = empty_param((d,), dtype, device)

    def reset_parameters(self, generator=None):
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return layernorm(x, self.scale, self.bias, self.eps)


def make_norm(cfg, dtype, device):
    """The config's norm over d_model (``cfg.norm``): RMSNorm or
    LayerNorm, the reference's ``norm_init``."""
    cls = LayerNorm if cfg.norm == "layernorm" else RMSNorm
    return cls(cfg.d_model, dtype, device, cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """Half-split rotary embedding in fp32. x: [..., S, H, Dh];
    positions: [..., S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # [dh/2]
    ang = positions[..., :, None, None].float() * freqs          # [..., S, 1, dh/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU, GeGLU, plain GELU)
# ---------------------------------------------------------------------------
ACTS = ("silu", "geglu", "gelu")


class MLP(nn.Module):
    """An MLP, ``wi``/``wg`` column-sharded and ``wo`` row-sharded over TP:
    SwiGLU with ``act="silu"``, GeGLU (the gate through the
    tanh-approximated GELU, ``jax.nn.gelu``'s default) with
    ``act="geglu"``, and with ``act="gelu"`` the plain MLP ``gelu(x @ wi)
    @ wo``, which has no ``wg``."""

    def __init__(self, d, d_ff, dtype, device, shard: Shard = None,
                 act: str = "silu"):
        super().__init__()
        if act not in ACTS:
            raise NotImplementedError(f"MLP activation {act!r}: the port has "
                                      f"{ACTS}")
        self.shard = shard or Shard()
        self.act = act
        self.d, self.d_ff = d, d_ff
        ff = d_ff // max(self.shard.lay.tp, 1)
        self.wi = empty_param((d, ff), dtype, device)
        if act != "gelu":
            self.wg = empty_param((d, ff), dtype, device)
        self.wo = empty_param((ff, d), dtype, device)

    def reset_parameters(self, generator):
        tp, k = max(self.shard.lay.tp, 1), self.shard.tp_rank
        for name, shape, dim in (("wi", (self.d, self.d_ff), 1),
                                 ("wo", (self.d_ff, self.d), 0),
                                 ("wg", (self.d, self.d_ff), 1)):
            if not hasattr(self, name):
                continue
            w = getattr(self, name)
            full = dense_init(shape, generator, torch.float32)
            w.copy_(shard_of(full, dim, tp, k).to(w.dtype))


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(p: MLP, x):
    if p.act == "gelu":
        h = gelu(x @ p.wi)
    else:
        gate = F.silu if p.act == "silu" else gelu
        h = gate(x @ p.wg) * (x @ p.wi)
    return psum_if(h @ p.wo, p.shard.tp_group)


# ---------------------------------------------------------------------------
# vocab-sharded embedding + LM head
# ---------------------------------------------------------------------------
class Embedding(nn.Module):
    """This tp rank's contiguous vocabulary rows of the table, [v_blk, d]
    (the whole [V, d] table on the trivial layout)."""

    def __init__(self, vocab, d, dtype, device, shard: Shard = None):
        super().__init__()
        self.shard = shard or Shard()
        self.vocab, self.d = vocab, d
        self.table = empty_param((vocab_rows(vocab, self.shard.lay), d),
                                 dtype, device)

    def reset_parameters(self, generator):
        full = dense_init((self.vocab, self.d), generator, torch.float32,
                          scale=0.02)
        self.table.copy_(vocab_shard(full, 0, self.shard.lay,
                                     self.shard.tp_rank).to(self.table.dtype))


def embed_apply(p: Embedding, ids):
    """Distributed lookup over the vocab-sharded table, summed over TP: ids
    outside this rank's rows (and outside the vocabulary) give zero rows.
    Differentiable while autograd records: the TP sum's backward is a TP
    sum, as in the reference."""
    v_blk = p.table.shape[0]
    local = ids - p.shard.tp_rank * v_blk
    ok = (local >= 0) & (local < v_blk)
    emb = p.table[local.clamp(0, v_blk - 1)]
    emb = torch.where(ok[..., None], emb, torch.zeros_like(emb))
    return psum_if(emb, p.shard.tp_group)


class LMHead(nn.Module):
    """This tp rank's vocabulary columns of the head, [d, v_blk]."""

    def __init__(self, d, vocab, dtype, device, shard: Shard = None):
        super().__init__()
        self.shard = shard or Shard()
        self.vocab, self.d = vocab, d
        self.w = empty_param((d, vocab_rows(vocab, self.shard.lay)), dtype,
                             device)

    def reset_parameters(self, generator):
        full = dense_init((self.d, self.vocab), generator, torch.float32)
        self.w.copy_(vocab_shard(full, 1, self.shard.lay,
                                 self.shard.tp_rank).to(self.w.dtype))


def lmhead_apply(p: LMHead, x):
    """This tp rank's vocabulary columns of the logits, [..., v_blk] in
    fp32."""
    return (x @ p.w).float()


def tied_lmhead_apply(embed: Embedding, x):
    """The LM head of a tied model, the embedding table itself: logits
    ``x @ table.T`` [..., v_blk] in fp32."""
    return (x @ embed.table.T).float()


def distributed_xent(logits, labels, shard: Shard):
    """Per-token cross-entropy over TP vocab shards (the reference's
    ``distributed_xent``): logits [..., v_blk] fp32, this tp rank's
    columns; labels [...] global ids. The max is ``pmax_sg`` (no
    gradient); the denominator and the label's logit are summed over TP
    (``psum_if``, whose backward is a TP sum). Returns [...] nll."""
    v_blk = logits.shape[-1]
    off = shard.tp_rank * v_blk
    mx = pmax_sg(logits.amax(dim=-1), shard.tp_group)
    z = torch.exp(logits - mx[..., None])
    denom = psum_if(z.sum(dim=-1), shard.tp_group)
    local = labels.long() - off
    ok = (local >= 0) & (local < v_blk)
    picked = torch.gather(logits, -1, local.clamp(0, v_blk - 1)[..., None])[..., 0]
    picked = torch.where(ok, picked, torch.zeros_like(picked))
    label_logit = psum_if(picked, shard.tp_group)
    return torch.log(denom) + mx - label_logit


# ---------------------------------------------------------------------------
# causal depthwise convolution (the SSD and RG-LRU mixers' short conv)
# ---------------------------------------------------------------------------
def causal_depthwise_conv(x, w, state):
    """Causal depthwise 1-D conv. x: [B, S, C], w: [cw, C], state: [B, cw-1,
    C], the tail of the previous segment. Returns (y [B, S, C], new state
    [B, cw-1, C]). The taps are summed in the reference's order (a Python
    ``sum`` of the cw products), each product and partial sum rounded to
    x's type, so bf16 agrees bit for bit."""
    cw = w.shape[0]
    S = x.shape[1]
    xp = torch.cat([state, x], dim=1)                 # [B, S+cw-1, C]
    y = sum(xp[:, i:i + S] * w[i] for i in range(cw))
    new_state = xp[:, -(cw - 1):] if cw > 1 else state
    return y, new_state


def conv_step(x, w, state):
    """One decode step of the causal conv. x: [B, C]; state [B, cw-1, C].
    The products are rounded to x's type and summed in fp32, then rounded
    once, as the reference's reduction does."""
    xp = torch.cat([state, x[:, None]], dim=1)        # [B, cw, C]
    y = (xp * w[None]).float().sum(1).to(x.dtype)
    return y, xp[:, 1:]


def distributed_argmax(logits, shard: Shard = None):
    """Greedy token id from TP-vocab-sharded logits [..., v_blk]: each tp
    rank's best value and global index, all-gathered over TP. Ties go to
    the lowest global index, as ``argmax`` over the whole vocabulary
    does."""
    shard = shard or Shard()
    idx = torch.argmax(logits, dim=-1)
    if shard.tp_group is None:
        return idx
    val = torch.gather(logits, -1, idx[..., None])[..., 0]
    vals = all_gather_if(val[None], shard.tp_group)            # [tp, ...]
    idxs = all_gather_if((idx + shard.tp_rank * logits.shape[-1])[None],
                         shard.tp_group)
    best = vals.max(dim=0, keepdim=True).values
    return torch.where(vals == best, idxs,
                       torch.iinfo(idxs.dtype).max).min(dim=0).values
