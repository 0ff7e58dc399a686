"""Mamba-2 SSD mixer (counterpart of ``repro.models.ssd``, arXiv:2405.21060)
under combined (SP, TP): the z/x/bc/dt projections (TP column parallel),
the fused Ulysses all-to-all into head parallelism in the base config, the
causal depthwise conv, the chunked scan, the D skip, the z gate, the
grouped per-head RMSNorm, the all-to-all back and the out projection (row
parallel) with its TP psum.

SSD heads are independent given the one shared (B, C) group: the GQA
structure with one kv head, so the attention's exchange applies (the
reference's "Ulysses for state-space heads"). The bc group is replicated
``kexp = max(h_kv_pad, tp)`` times in the weights and into the send
buffer (``expand_kv_for_send``), so that after the exchange every rank
holds it once. A rank's ``hpr`` heads are those of its model rank ``g =
j*sp + i`` in both configs (the per-head leaves are cut in the reference's
``head_spec_entry()`` order), so the recurrent state ``[B_row, hpr, hd,
ds]`` is the same tensor in base and shift: the SSM analogue of KV-cache
invariance. A decode step sends the rank's batch rows as the exchange's
"sequence" (``x[None]``), as the attention's decode does.

The chunked scan's intra-chunk step (c·bᵀ masked and decayed, times x; each
chunk's state contribution; exp of the cumulative decay) is the SSD chunk
kernel (``kernels.ops.ssd_chunk``); the inter-chunk recurrence stays a loop
over chunks in fp32 here. Decode is plain PyTorch, as the reference's is
plain jnp. The recurrent state lives in the dense cache and is updated in
place. Training (``ssd_train``) starts from a zero state and writes nothing
in place; its intra-chunk step is differentiable (``ops.SSDChunk``, whose
backward is the chunk's backward kernel on the card).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.ulysses import (expand_kv_for_send,
                                      ulysses_gather_heads,
                                      ulysses_scatter_heads)
from repro_torch.kernels import ops as K
from repro_torch.parallel import HeadPlan, Layout, Shard, plan_heads
from repro_torch.parallel.collectives import psum_if
from .layers import (causal_depthwise_conv, conv_step, dense_init,
                     empty_param, rmsnorm, shard_of)


def ssd_plan(cfg, lay: Layout) -> HeadPlan:
    nh = cfg.ssm.n_heads(cfg.d_model)
    return plan_heads(nh, 1, max(lay.G, 1), max(lay.tp, 1))


# the leaves cut over the model group in head order (``P(h)``, ``P(None,
# h)``), and those cut over the TP axes (``P(None, tp)``, ``P(tp, None)``)
HEAD_LEAVES = ("dt_bias", "A_log", "D", "conv_x", "norm")
TP_LEAVES = ("wz", "wx", "wdt", "wo")


def _pad_heads(t, dim: int, plan: HeadPlan, hd: int):
    """``t`` with its ``dim`` (heads times ``hd``) placed into the plan's
    padded head slots: the real heads first, zeros for the pad slots (a
    zero head's output is zero through the gate, the norm and wo, so the
    padded mixer computes the trivial one's function)."""
    pad = (plan.h_q_pad - plan.h_q) * hd
    if not pad:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def ssd_layout(name: str, canon, cfg, lay: Layout, rank: int):
    """Process ``rank``'s part of SSD parameter ``name`` from its trivial
    form ``canon`` (``ssd_init``'s shapes with the real heads, wbc the one
    group [d, 2·ds]), as the reference's ``ssd_specs`` place it: the
    projections' columns and wo's rows over the TP axes after padding the
    heads, the per-head leaves over the model group in model-rank order,
    wbc (``kexp`` copies of the group, cut over TP: one per rank) and
    conv_bc whole."""
    plan = ssd_plan(cfg, lay)
    hd = cfg.ssm.head_dim
    if name in TP_LEAVES:
        dim = 0 if name == "wo" else 1
        t = _pad_heads(canon, dim, plan, 1 if name == "wdt" else hd)
        return shard_of(t, dim, max(lay.tp, 1), lay.tp_rank(rank))
    if name in HEAD_LEAVES:
        dim = 1 if name == "conv_x" else 0
        t = _pad_heads(canon, dim, plan, hd if name in ("conv_x", "norm")
                       else 1)
        return shard_of(t, dim, max(lay.G, 1), lay.model_rank(rank))
    return canon


def ssd_unlayout(name: str, parts, cfg, lay: Layout):
    """The inverse of ``ssd_layout``: the trivial form of ``name`` from
    ``parts``, every tp rank's part in tp rank order for a TP leaf, every
    model rank's in model-rank order for a head leaf (one for a whole
    leaf); the pad heads go."""
    plan = ssd_plan(cfg, lay)
    hd = cfg.ssm.head_dim
    if name in TP_LEAVES:
        dim, unit = (0, hd) if name == "wo" else (1, 1 if name == "wdt"
                                                   else hd)
    elif name in HEAD_LEAVES:
        dim = 1 if name == "conv_x" else 0
        unit = hd if name in ("conv_x", "norm") else 1
    else:
        return parts[0]
    return torch.cat(list(parts), dim).narrow(dim, 0, plan.h_q * unit)


class SSD(nn.Module):
    """Parameters of one SSD mixer, this rank's part of ``ssd_init``'s
    (``ssd_layout``): with ``H`` the padded heads (``h_q_pad``), ``wz`` and
    ``wx`` [d, H/tp·hd], ``wbc`` [d, 2·ds] (the rank's copy of the one
    group), ``wdt`` [d, H/tp], ``dt_bias``, ``A_log``, ``D`` [hpr] in fp32
    whatever the model's type, ``conv_x`` [cw, hpr·hd], ``conv_bc`` [cw,
    2·ds], ``norm`` [hpr·hd] and ``wo`` [H/tp·hd, d], ``hpr = H/G`` the
    rank's heads after the exchange. On the trivial layout they are the
    whole tensors."""

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        super().__init__()
        s = cfg.ssm
        d, hd, ds, cw = cfg.d_model, s.head_dim, s.d_state, s.d_conv
        self.cfg = cfg
        self.shard = shard or Shard(lay)
        plan = ssd_plan(cfg, lay)
        nt = plan.h_q_pad // max(lay.tp, 1)        # heads per tp rank
        self.hpr = hpr = plan.h_q_pad // max(lay.G, 1)
        self.plan = plan
        self.wz = empty_param((d, nt * hd), dtype, device)
        self.wx = empty_param((d, nt * hd), dtype, device)
        self.wbc = empty_param((d, 2 * ds), dtype, device)
        self.wdt = empty_param((d, nt), dtype, device)
        self.dt_bias = empty_param((hpr,), torch.float32, device)
        self.A_log = empty_param((hpr,), torch.float32, device)
        self.D = empty_param((hpr,), torch.float32, device)
        self.conv_x = empty_param((cw, hpr * hd), dtype, device)
        self.conv_bc = empty_param((cw, 2 * ds), dtype, device)
        self.norm = empty_param((hpr * hd,), dtype, device)
        self.wo = empty_param((nt * hd, d), dtype, device)

    def reset_parameters(self, generator):
        """``ssd_init``'s scales, drawn at the trivial layout's shapes and
        cut for this rank (``ssd_layout``): 1/sqrt(fan-in) for the
        projections (wbc is drawn as [d, 1, 2·ds], so its fan-in is 1), 0.5
        for the convs; zero dt_bias and A_log, unit D and norm."""
        cfg, lay, rank = self.cfg, self.shard.lay, self.shard.rank
        s = cfg.ssm
        d, hd, nh = cfg.d_model, s.head_dim, self.plan.h_q

        def put(name, canon):
            w = getattr(self, name)
            w.copy_(ssd_layout(name, canon, cfg, lay, rank).to(w.dtype))

        f32 = torch.float32
        for name, shape in (("wz", (d, nh * hd)), ("wx", (d, nh * hd)),
                            ("wdt", (d, nh)), ("wo", (nh * hd, d))):
            put(name, dense_init(shape, generator, f32))
        put("wbc", dense_init((d, 1, 2 * s.d_state), generator,
                              f32).reshape(d, -1))
        put("conv_x", dense_init((s.d_conv, nh * hd), generator, f32,
                                 scale=0.5))
        put("conv_bc", dense_init((s.d_conv, 2 * s.d_state), generator, f32,
                                  scale=0.5))
        self.dt_bias.zero_()
        self.A_log.zero_()
        self.D.fill_(1.0)
        self.norm.fill_(1.0)


@dataclass
class SSDState:
    """One layer's recurrent state, views into the dense cache updated in
    place: ``ssm`` [B, hpr, hd, ds] fp32, ``conv_x`` [B, cw-1, hpr·hd] and
    ``conv_bc`` [B, cw-1, 2·ds] in the model's type (this rank's rows and
    heads)."""
    ssm: torch.Tensor
    conv_x: torch.Tensor
    conv_bc: torch.Tensor


def ssd_state_shapes(cfg, lay: Layout, batch: int):
    """Shapes of one rank's ``ssd_state_init`` leaves (ssm, conv_x,
    conv_bc) for ``batch`` rows: its ``hpr`` heads (``ssd_state_specs``
    shard them over the model group, as the KV cache's slots)."""
    s = cfg.ssm
    hpr = ssd_plan(cfg, lay).h_q_pad // max(lay.G, 1)
    return ((batch, hpr, s.head_dim, s.d_state),
            (batch, s.d_conv - 1, hpr * s.head_dim),
            (batch, s.d_conv - 1, 2 * s.d_state))


def _project_exchange(p: SSD, x, cfg):
    """x: [B, S_loc, d] -> z, xin [B, S, hpr, hd], bc [B, S, 2·ds] (the one
    group), dt [B, S, hpr], S the whole sequence: in the base config the
    bc group is replicated into the send buffer and the four go through
    one fused all-to-all."""
    s = cfg.ssm
    hd, ds = s.head_dim, s.d_state
    B, S, _ = x.shape
    z = (x @ p.wz).reshape(B, S, -1, hd)
    xin = (x @ p.wx).reshape(B, S, -1, hd)
    bc = (x @ p.wbc).reshape(B, S, -1, 2 * ds)
    dt = (x @ p.wdt).reshape(B, S, -1, 1)
    sh = p.shard
    if sh.sp_group is not None:
        bc = expand_kv_for_send(bc, p.plan, sh.lay.sp, sh.tp_rank)
        z, xin, bc, dt = ulysses_scatter_heads([z, xin, bc, dt], sh.sp_group)
    return z, xin, bc[:, :, 0], dt[..., 0]


def _ssd_chunks(xin, b, c, dt, A, h, chunk):
    """Chunked SSD. xin: [B, S, H, hd]; b, c: [B, S, ds] (one group); dt:
    [B, S, H] fp32 (post-softplus); A: [H] (> 0); h: [B, H, hd, ds] fp32,
    the state before the segment. Returns (y [B, S, H, hd] in fp32, the
    state after the segment); nothing is written in place, so autograd
    can record it. S is a multiple of ``chunk``, or below it (one chunk of
    length S)."""
    B, S, H, hd = xin.shape
    ds = b.shape[-1]
    assert S % chunk == 0 or S < chunk, (S, chunk)
    if S < chunk:
        chunk = S
    nc = S // chunk
    la = -dt * A                                       # log decay per step
    cum = la.reshape(B, nc, chunk, H).cumsum(2).reshape(B, S, H)
    # b and c are the one group every head shares
    y_in, st, dec = K.ssd_chunk(xin, b, c, dt, cum, chunk)
    # the state before each chunk, the recurrence's elementwise steps in
    # chunk order; then every chunk's cross-chunk term at once:
    # y_t += (c_t . h) exp(cum_t)
    dec = dec.reshape(B, nc, chunk, H)
    last = dec[:, :, -1][..., None, None].unbind(1)
    hs, hc = [], h
    for i, st_i in enumerate(st.unbind(1)):
        hs.append(hc)
        hc = hc * last[i] + st_i
    y_cr = torch.einsum("bctd,bchpd->bcthp", c.float().reshape(
        B, nc, chunk, ds), torch.stack(hs, 1)) * dec[..., None]
    return (y_in.reshape(B, nc, chunk, H, hd) + y_cr).reshape(B, S, H, hd), hc


def _ssd_scan(xin, b, c, dt, A, h, chunk):
    """``_ssd_chunks`` for serving: h, the state before the segment, is
    overwritten with the state after it. Returns y [B, S, H, hd] in
    fp32."""
    y, hc = _ssd_chunks(xin, b, c, dt, A, h, chunk)
    h.copy_(hc)
    return y


def _gate_norm(p: SSD, y, xin, z, dtype):
    """The D skip, the z gate and the grouped (per-head) RMSNorm of the
    rank's heads (invariant under head sharding, as Mamba-2's TP norm).
    y, xin, z: [..., hpr, hd] -> [..., hpr, hd] in ``dtype``."""
    H, hd = xin.shape[-2:]
    y = y + p.D[:, None] * xin.float()
    y = (y * F.silu(z.float())).to(dtype)
    return rmsnorm(y, p.norm.reshape(H, hd))


def _gather_out(p: SSD, y):
    """The heads gathered back over SP, then wo and its TP psum.
    y: [B, S, hpr, hd] -> [B, S_loc, d]."""
    (y,) = ulysses_gather_heads([y], p.shard.sp_group)
    B, S = y.shape[:2]
    return psum_if(y.reshape(B, S, -1) @ p.wo, p.shard.tp_group)


def ssd_prefill(p: SSD, x, state: SSDState, cfg):
    """x: [B, S_loc, d], this rank's columns of the sequence, with
    ``state`` the state before it (updated in place). After the exchange
    the causal conv runs over the whole sequence of the rank's heads'
    channels and the bc group, and the scan at its ``hpr`` heads. Returns
    out [B, S_loc, d]."""
    ds = cfg.ssm.d_state
    z, xin, bc, dt = _project_exchange(p, x, cfg)
    B, S, H, hd = xin.shape
    xc = torch.cat([xin.reshape(B, S, H * hd), bc], dim=-1)
    cw = torch.cat([p.conv_x, p.conv_bc], dim=-1)
    conv_state = torch.cat([state.conv_x, state.conv_bc], dim=-1)
    xc, conv_state = causal_depthwise_conv(xc, cw, conv_state)
    xc = F.silu(xc)
    xin = xc[..., :H * hd].reshape(B, S, H, hd)
    b_, c_ = xc[..., H * hd:H * hd + ds], xc[..., H * hd + ds:]
    A = torch.exp(p.A_log)
    dtv = F.softplus(dt.float() + p.dt_bias)
    y = _ssd_scan(xin, b_, c_, dtv, A, state.ssm, cfg.ssm.chunk)
    out = _gather_out(p, _gate_norm(p, y, xin, z, x.dtype))
    state.conv_x.copy_(conv_state[..., :H * hd])
    state.conv_bc.copy_(conv_state[..., H * hd:])
    return out


def ssd_train(p: SSD, x, cfg):
    """Training's forward of one mixer (the reference's ``ssd_prefill``
    with no state): ``ssd_prefill``'s arithmetic from a zero state, the
    conv with no tail, nothing written in place. The intra-chunk step is
    ``ops.SSDChunk`` (the chunk kernel and its backward kernel on the
    card); the inter-chunk recurrence stays plain PyTorch, as in the
    reference. x: [B, S_loc, d] -> out [B, S_loc, d]."""
    s = cfg.ssm
    ds = s.d_state
    z, xin, bc, dt = _project_exchange(p, x, cfg)
    B, S, H, hd = xin.shape
    xc = torch.cat([xin.reshape(B, S, H * hd), bc], dim=-1)
    cw = torch.cat([p.conv_x, p.conv_bc], dim=-1)
    xc, _ = causal_depthwise_conv(xc, cw, xc.new_zeros(
        (B, s.d_conv - 1, xc.shape[-1])))
    xc = F.silu(xc)
    xin = xc[..., :H * hd].reshape(B, S, H, hd)
    b_, c_ = xc[..., H * hd:H * hd + ds], xc[..., H * hd + ds:]
    A = torch.exp(p.A_log)
    dtv = F.softplus(dt.float() + p.dt_bias)
    h0 = torch.zeros((B, H, hd, ds), dtype=torch.float32, device=x.device)
    y, _ = _ssd_chunks(xin, b_, c_, dtv, A, h0, s.chunk)
    return _gather_out(p, _gate_norm(p, y, xin, z, x.dtype))


def ssd_decode(p: SSD, x, state: SSDState, cfg):
    """x: [B_loc, d], one new token per row (this rank's segment of its dp
    row's batch), with ``state`` the row's state before it (updated in
    place). The rows travel as the exchange's sequence: the rank steps its
    heads of every row of its dp row. Returns out [B_loc, d]."""
    ds = cfg.ssm.d_state
    z, xin, bc, dt = (t[0] for t in _project_exchange(p, x[None], cfg))
    B, H, hd = xin.shape
    xc = torch.cat([xin.reshape(B, H * hd), bc], dim=-1)
    cw = torch.cat([p.conv_x, p.conv_bc], dim=-1)
    cst = torch.cat([state.conv_x, state.conv_bc], dim=-1)
    xc, conv_state = conv_step(xc, cw, cst)
    xc = F.silu(xc)
    xin = xc[..., :H * hd].reshape(B, H, hd).float()
    b_, c_ = xc[..., H * hd:].float().split(ds, dim=-1)
    A = torch.exp(p.A_log)
    dtv = F.softplus(dt.float() + p.dt_bias)           # [B, H]
    a = torch.exp(-dtv * A[None, :])
    # h = h·a + dt·x⊗b, in place (the same roundings as out of place)
    h = state.ssm
    h.mul_(a[..., None, None]).add_(
        (dtv[..., None] * xin)[..., None] * b_[:, None, None, :])
    y = torch.einsum("bd,bhpd->bhp", c_, h)
    out = _gather_out(p, _gate_norm(p, y, xin, z, x.dtype)[None])[0]
    state.conv_x.copy_(conv_state[..., :H * hd])
    state.conv_bc.copy_(conv_state[..., H * hd:])
    return out
