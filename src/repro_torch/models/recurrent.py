"""RG-LRU recurrent block (counterpart of ``repro.models.recurrent``;
Griffin / RecurrentGemma, arXiv:2402.19427) under combined (SP, TP).

The x and y branches are projections column-sharded over TP (``wx``,
``wy``), the output projection ``wo`` row-sharded with its TP psum. The
recurrence is diagonal (channel-independent), so Ulysses SP maps onto it
as channel parallelism: in the base config the fused all-to-all trades the
sequence for channel blocks (the 16 blocks of ``lru_width`` play the role
of heads), each rank scans its channels over the whole sequence, and the
all-to-all back returns the rank's columns. After the exchange rank ``(i,
j)`` holds the contiguous channels of its model rank ``g = j*sp + i``, the
same channels its tp rank ``g`` holds in the shift config, so the
recurrent state ``h`` [B, w/G] (fp32) and the conv tail [B, cw-1, w/G]
are the same tensors in base and shift (state invariance). The conv, the
block-diagonal gates ``gate_a``/``gate_x`` [16, bs, bs] and ``Λ`` (``lam``,
fp32 whatever the model's type) are cut over the model group in that
order, so the gates stay rank-local.

Per step: the causal depthwise conv of the x branch, the gates ``r`` and
``i`` (sigmoid of the block-diagonal products), ``a = exp(-8 softplus(Λ)
r)``, the input ``sqrt(1 - a²) (i x)``, the scan ``h_t = a_t h_{t-1} +
b_t`` in fp32, and the output ``h · gelu(y)`` (tanh GELU). A prefill
chunk's scan is a log-depth doubling scan with the combine of the
reference's ``jax.lax.associative_scan``: ceil(log2 S) elementwise
passes, whose number depends on the shape alone (a CUDA graph captures
it). The block is plain PyTorch: the reference's is jnp and reaches no
Pallas kernel. The state lives in the dense cache and is updated in
place."""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.ulysses import ulysses_gather_heads, ulysses_scatter_heads
from repro_torch.parallel import Layout, Shard
from repro_torch.parallel.collectives import psum_if
from .layers import (causal_depthwise_conv, conv_step, dense_init,
                     empty_param, gelu, shard_of)

N_BLOCKS = 16
RGLRU_C = 8.0

# the leaves cut over the TP axes (``P(None, tp)``, ``P(tp, None)``) and
# those cut over the model group in model-rank order (``P(h)``, ``P(None,
# h)``, ``P(h, None, None)``), each with its cut dimension
TP_LEAVES = {"wx": 1, "wy": 1, "wo": 0}
GROUP_LEAVES = {"conv": 1, "gate_a": 0, "gate_x": 0, "lam": 0}


def _width(cfg) -> int:
    return cfg.rglru.width(cfg.d_model)


def _blocks(n: int, what: str) -> int:
    """Channel blocks per rank over ``n`` ranks (``N_BLOCKS // n``)."""
    if N_BLOCKS % n:
        raise ValueError(f"{N_BLOCKS} channel blocks do not split over "
                         f"{what}={n}")
    return N_BLOCKS // n


def rglru_layout(name: str, canon, cfg, lay: Layout, rank: int):
    """Process ``rank``'s part of RG-LRU parameter ``name`` from its
    trivial form (``rglru_init``'s shapes), as ``rglru_specs`` place it:
    wx/wy columns and wo rows over TP, the conv's channels, the gates'
    blocks and Λ over the model group in model-rank order."""
    if name in TP_LEAVES:
        return shard_of(canon, TP_LEAVES[name], max(lay.tp, 1),
                        lay.tp_rank(rank))
    return shard_of(canon, GROUP_LEAVES[name], max(lay.G, 1),
                    lay.model_rank(rank))


def rglru_unlayout(name: str, parts):
    """The inverse of ``rglru_layout``: every tp rank's part in tp rank
    order for a TP leaf, every model rank's in model-rank order for the
    others."""
    dim = TP_LEAVES[name] if name in TP_LEAVES else GROUP_LEAVES[name]
    return torch.cat(list(parts), dim)


class RGLRU(nn.Module):
    """Parameters of one RG-LRU mixer, this rank's part of ``rglru_init``'s
    (``rglru_layout``), ``w`` the LRU width: ``wx``, ``wy`` [d, w/tp],
    ``conv`` [cw, w/G], ``gate_a``, ``gate_x`` [16/G, bs, bs] (``bs =
    w/16``), ``lam`` [w/G] in fp32, ``wo`` [w/tp, d]."""

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        super().__init__()
        d, w, cw = cfg.d_model, _width(cfg), cfg.rglru.conv1d_width
        tp, G = max(lay.tp, 1), max(lay.G, 1)
        self.cfg = cfg
        self.shard = shard or Shard(lay)
        self.nb = nb = _blocks(G, "the model group")      # blocks per rank
        bs = w // N_BLOCKS
        self.wx = empty_param((d, w // tp), dtype, device)
        self.wy = empty_param((d, w // tp), dtype, device)
        self.conv = empty_param((cw, nb * bs), dtype, device)
        self.gate_a = empty_param((nb, bs, bs), dtype, device)
        self.gate_x = empty_param((nb, bs, bs), dtype, device)
        self.lam = empty_param((nb * bs,), torch.float32, device)
        self.wo = empty_param((w // tp, d), dtype, device)

    def reset_parameters(self, generator):
        """``rglru_init``'s scales, drawn at the trivial layout's shapes and
        cut for this rank: 1/sqrt(fan-in) for the projections and the
        gates (fan-in ``bs``), 0.5 for the conv; ``Λ = log(expm1(-log(u) /
        8))``, u ~ U(0.9, 0.999), so that ``a`` starts in U(0.9, 0.999)^8
        at r = 1 (Griffin's appendix)."""
        cfg, lay, rank = self.cfg, self.shard.lay, self.shard.rank
        d, w, cw = cfg.d_model, _width(cfg), cfg.rglru.conv1d_width
        bs, f32 = w // N_BLOCKS, torch.float32

        def put(name, canon):
            t = getattr(self, name)
            t.copy_(rglru_layout(name, canon, cfg, lay, rank).to(t.dtype))

        u = torch.rand((w,), generator=generator, device=generator.device,
                       dtype=f32) * (0.999 - 0.9) + 0.9
        put("lam", torch.log(torch.expm1(-torch.log(u) / RGLRU_C)))
        put("wx", dense_init((d, w), generator, f32))
        put("wy", dense_init((d, w), generator, f32))
        put("conv", dense_init((cw, w), generator, f32, scale=0.5))
        put("gate_a", dense_init((N_BLOCKS, bs, bs), generator, f32))
        put("gate_x", dense_init((N_BLOCKS, bs, bs), generator, f32))
        put("wo", dense_init((w, d), generator, f32))


@dataclass
class RGLRUState:
    """One layer's recurrent state, views into the dense cache updated in
    place: ``h`` [B, w/G] in fp32 and ``conv`` [B, cw-1, w/G] in the
    model's type (this rank's rows and channels)."""
    h: torch.Tensor
    conv: torch.Tensor


def rglru_state_shapes(cfg, lay: Layout, batch: int):
    """Shapes of one rank's ``rglru_state_init`` leaves (h, conv) for
    ``batch`` rows: its channels (``rglru_state_specs`` shard them over
    the model group, as the KV cache's slots)."""
    w_loc = _width(cfg) // max(lay.G, 1)
    return (batch, w_loc), (batch, cfg.rglru.conv1d_width - 1, w_loc)


def _gates(p: RGLRU, xb):
    """The recurrence and input gates of xb [B, S, w_loc]: the sigmoid of
    the block-diagonal products, in xb's type, then fp32."""
    B, S, _ = xb.shape
    xr = xb.reshape(B, S, p.nb, -1)
    r = torch.sigmoid(torch.einsum("bsnc,ncf->bsnf", xr, p.gate_a))
    i = torch.sigmoid(torch.einsum("bsnc,ncf->bsnf", xr, p.gate_x))
    return r.reshape(B, S, -1).float(), i.reshape(B, S, -1).float()


def scan(a, bx, h0):
    """``h_t = a_t h_{t-1} + bx_t`` from ``h0`` [B, W]; a, bx [B, S, W] in
    fp32. The doubling (Hillis-Steele) form of the associative scan with
    the reference's combine ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``:
    after the pass of stride d every position holds the combine of its
    last 2d inputs, so ceil(log2 S) passes give every prefix. Returns h
    [B, S, W]."""
    S = a.shape[1]
    d = 1
    while d < S:
        b_new = bx[:, :-d] * a[:, d:] + bx[:, d:]
        a_new = a[:, :-d] * a[:, d:]
        bx = torch.cat([bx[:, :d], b_new], dim=1)
        a = torch.cat([a[:, :d], a_new], dim=1)
        d *= 2
    return a * h0[:, None, :] + bx


def _recur(p: RGLRU, xb):
    """The gated input and the decay of xb [B, S, w_loc] (after the conv):
    (a, b) in fp32, ``b = sqrt(max(1 - a², 1e-6)) · i · x``."""
    r, i = _gates(p, xb)
    a = torch.exp(-RGLRU_C * F.softplus(p.lam) * r)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-6)) * (i * xb.float())
    return a, b


def _scatter(p: RGLRU, xb, yb):
    """The base config's exchange of the two branches [B, S_loc, w/tp]
    into every column at the rank's channel blocks [B, S, w/G], in the
    reference's block order (``N_BLOCKS/tp`` blocks of the tp rank, the
    sp rank's contiguous share of them). A no-op in the shift config."""
    sh = p.shard
    if sh.sp_group is None:
        return xb, yb
    B, S_loc, w_t = xb.shape
    nb_t = _blocks(max(sh.lay.tp, 1), "tp")
    xb4, yb4 = ulysses_scatter_heads(
        [xb.reshape(B, S_loc, nb_t, -1), yb.reshape(B, S_loc, nb_t, -1)],
        sh.sp_group)
    S = xb4.shape[1]
    return xb4.reshape(B, S, -1), yb4.reshape(B, S, -1)


def _out(p: RGLRU, out_r):
    """The exchange back (base config) and the out projection with its
    TP psum: [B, S, w/G] -> [B, S_loc, d]."""
    sh = p.shard
    if sh.sp_group is not None:
        B, S, _ = out_r.shape
        (o4,) = ulysses_gather_heads([out_r.reshape(B, S, p.nb, -1)],
                                     sh.sp_group)
        out_r = o4.reshape(B, o4.shape[1], -1)
    return psum_if(out_r @ p.wo, sh.tp_group)


def rglru_prefill(p: RGLRU, x, state: RGLRUState, cfg):
    """One layer's chunked prefill. x: [B, S_loc, d], this rank's columns
    of the chunk on the base config (the whole chunk on the shift config);
    the state (this rank's channels, every row) continues from its
    contents and is updated in place. Returns [B, S_loc, d]."""
    xb, yb = _scatter(p, x @ p.wx, x @ p.wy)
    xb, conv_new = causal_depthwise_conv(xb, p.conv, state.conv)
    a, b = _recur(p, xb)
    h = scan(a, b, state.h)
    out_r = h.to(x.dtype) * gelu(yb)
    state.h.copy_(h[:, -1])
    state.conv.copy_(conv_new)
    return _out(p, out_r)


def rglru_decode(p: RGLRU, x, state: RGLRUState, cfg):
    """One layer's decode step. x: [B_loc, d], this rank's segment of its
    dp row's rows, which travel as the exchange's sequence (``x[None]``):
    after it the rank steps every row of its dp row at its channels.
    Updates the state in place. Returns [B_loc, d]."""
    xb, yb = _scatter(p, (x @ p.wx)[None], (x @ p.wy)[None])
    xb, yb = xb[0], yb[0]                                  # [B_row, w_loc]
    xb, conv_new = conv_step(xb, p.conv, state.conv)
    a, b = _recur(p, xb[:, None])
    h = a[:, 0] * state.h + b[:, 0]
    out_r = h.to(x.dtype) * gelu(yb)
    state.h.copy_(h)
    state.conv.copy_(conv_new)
    return _out(p, out_r[None])[0]
