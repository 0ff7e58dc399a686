"""Attention cores in plain PyTorch (copies of
``repro.models.attention_math``, which is jnp and reaches no Pallas
kernel): the chunked online-softmax ``attend``, ``attend_partial``'s
un-normalised result for a log-sum-exp merge across ranks
(``merge_partials``) and ``finish_partial``. MLA's attention and the
sliding-window (``local``) layers' ring attention run them, on the card
too; global GQA attention runs the flash and decode kernels.

GQA convention: q [B, Sq, Hq, Dh] and kv [B, Skv, Hkv, Dh] are already
head-aligned by the planner (``Hq % Hkv == 0``; q head ``s`` uses kv head
``s // (Hq // Hkv)``). Positions are global (-1 marks an invalid key).
The mask keeps a key at ``kv_pos`` for a query at ``q_pos`` when it is
valid, below ``kv_len`` (when given), causal (``kv_pos <= q_pos``) and,
with a ``window``, inside it (``kv_pos > q_pos - window``). A ``soft_cap``
caps the scaled scores as ``soft_cap * tanh(s / soft_cap)`` before the
mask. Masked scores are the finite ``NEG_INF``, so a set of keys with no
live one adds exactly zero to a merge (``exp(NEG_INF - m)`` underflows to
0)."""
from __future__ import annotations

import torch

from repro_torch.parallel.collectives import (pmax_if, pmax_sg, psum_if,
                                              recording)

NEG_INF = -1e30


def _mask(q_pos, kv_pos, kv_len=None, window: int = 0):
    """Causal mask [B, Sq, Skv] of global positions (kv_pos -1 = invalid),
    limited to ``kv_len`` [B] when given and to the last ``window``
    positions with a window."""
    m = kv_pos[:, None, :] >= 0
    if kv_len is not None:
        m = m & (kv_pos[:, None, :] < kv_len[:, None, None])
    m = m & (kv_pos[:, None, :] <= q_pos[..., :, None])
    if window:
        m = m & (kv_pos[:, None, :] > q_pos[..., :, None] - window)
    return m


def _scaled_q(q, Hkv):
    B, Sq, Hq, Dh = q.shape
    return (q * Dh ** -0.5).float().reshape(B, Sq, Hkv, Hq // Hkv, Dh)


def _scores(qf, k, q_pos, kv_pos, kv_len, window, soft_cap):
    """Masked fp32 scores [B, Hkv, g, Sq, Skv] of the scaled queries
    against ``k``."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if soft_cap:
        s = soft_cap * torch.tanh(s / soft_cap)
    msk = _mask(q_pos, kv_pos, kv_len, window)
    return torch.where(msk[:, None, None], s, NEG_INF)


def attend(q, k, v, q_pos, kv_pos, kv_len=None, *, window: int = 0,
           soft_cap: float = 0.0, chunk: int = 1024):
    """Online-softmax causal attention over key chunks of ``chunk``.
    q [B, Sq, Hq, Dh], k [B, Skv, Hkv, Dh], v [B, Skv, Hkv, Dv], q_pos [B,
    Sq], kv_pos [Skv] or [B, Skv], kv_len [B] or None. Returns [B, Sq, Hq,
    Dv] in q's type."""
    B, Sq, Hq, _ = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    g = Hq // Hkv
    qf = _scaled_q(q, Hkv)
    kv_pos = torch.broadcast_to(torch.atleast_2d(kv_pos), (B, Skv))
    m = q.new_full((B, Hkv, g, Sq), NEG_INF, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, g, Sq, Dv), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, max(Skv, 1), chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = _scores(qf, kc, q_pos, kv_pos[:, c0:c0 + chunk], kv_len, window,
                    soft_cap)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dv).to(q.dtype)


def attend_partial(q, k, v, q_pos, kv_pos, kv_len=None, *, window: int = 0,
                   soft_cap: float = 0.0):
    """``attend``'s un-normalised partial result over the given keys, for a
    log-sum-exp merge across ranks: ``(acc [B, Hkv, g, Sq, Dv], l [B, Hkv,
    g, Sq], m [B, Hkv, g, Sq])`` in fp32."""
    B = q.shape[0]
    Hkv = k.shape[2]
    qf = _scaled_q(q, Hkv)
    kv_pos = torch.broadcast_to(torch.atleast_2d(kv_pos), (B, k.shape[1]))
    s = _scores(qf, k, q_pos, kv_pos, kv_len, window, soft_cap)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    return torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()), p.sum(-1), m


def merge_partials(acc, l, m, group):
    """The LSE merge of ``attend_partial`` results over ``group`` (one
    max, two sums), normalised: [B, Hkv, g, Sq, Dv] in fp32. Without a
    group, the local result normalised. Differentiable while autograd
    records: the sums are ``psum``s (transposed to ``psum``), the max
    carries no gradient."""
    if group is None:
        return acc / l.clamp(min=1e-30)[..., None]
    # the stabiliser cancels out; while autograd records it is the
    # reference's ``pmax_sg`` (no gradient), else one in-place max
    m_glob = (pmax_sg(m, group) if recording(m)
              else pmax_if(m.clone(), group))
    corr = torch.exp(m - m_glob)
    l_glob = psum_if(l * corr, group)
    acc_glob = psum_if(acc * corr[..., None], group)
    return acc_glob / l_glob.clamp(min=1e-30)[..., None]


def finish_partial(acc, l, m):
    """One rank's partial result normalised and laid out [B, Sq, Hq,
    Dv]."""
    B, Hkv, g, Sq, Dv = acc.shape
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hkv * g, Dv)
