"""Shared layers (counterpart of ``repro.models.layers``) on the trivial
layout. Weights keep the reference's ``[in, out]`` layout and apply as
``x @ w``; the embedding table and LM head hold the whole vocabulary."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as K


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
    given. Drawn on the generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * s).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps: float = 1e-6):
    """``(x·rsqrt(mean(x²)+eps))`` in fp32, cast to x's type, times scale:
    the RMSNorm kernel on the card, its plain version on the CPU."""
    return K.rmsnorm(x, scale, eps)


class RMSNorm(nn.Module):
    def __init__(self, d, dtype, device, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = empty_param((d,), dtype, device)

    def reset_parameters(self, generator=None):
        self.scale.fill_(1.0)

    def forward(self, x):
        return rmsnorm(x, self.scale, self.eps)


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
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, d, d_ff, dtype, device):
        super().__init__()
        self.wi = empty_param((d, d_ff), dtype, device)
        self.wg = empty_param((d, d_ff), dtype, device)
        self.wo = empty_param((d_ff, d), dtype, device)

    def reset_parameters(self, generator):
        for w in (self.wi, self.wo, self.wg):
            w.copy_(dense_init(w.shape, generator, w.dtype))


def mlp_apply(p: MLP, x):
    h = F.silu(x @ p.wg) * (x @ p.wi)
    return h @ p.wo


# ---------------------------------------------------------------------------
# embedding + LM head (whole vocabulary on the trivial layout)
# ---------------------------------------------------------------------------
class Embedding(nn.Module):
    def __init__(self, vocab, d, dtype, device):
        super().__init__()
        self.table = empty_param((vocab, d), dtype, device)

    def reset_parameters(self, generator):
        self.table.copy_(dense_init(self.table.shape, generator,
                                    self.table.dtype, scale=0.02))


def embed_apply(p: Embedding, ids):
    """Lookup; ids outside the table give zero rows, as the reference's
    vocab-sharded lookup does."""
    v = p.table.shape[0]
    ok = (ids >= 0) & (ids < v)
    emb = p.table[ids.clamp(0, v - 1)]
    return torch.where(ok[..., None], emb, torch.zeros_like(emb))


class LMHead(nn.Module):
    def __init__(self, d, vocab, dtype, device):
        super().__init__()
        self.w = empty_param((d, vocab), dtype, device)

    def reset_parameters(self, generator):
        self.w.copy_(dense_init(self.w.shape, generator, self.w.dtype))


def lmhead_apply(p: LMHead, x):
    """Logits [..., vocab] in fp32."""
    return (x @ p.w).float()


def tied_lmhead_apply(embed: Embedding, x):
    """The LM head of a tied model, the embedding table itself: logits
    ``x @ table.T`` [..., vocab] in fp32."""
    return (x @ embed.table.T).float()


# ---------------------------------------------------------------------------
# causal depthwise convolution (the SSD mixer's short conv)
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


def distributed_argmax(logits):
    """Greedy token id on the trivial layout; ties go to the first index."""
    return torch.argmax(logits, dim=-1)
