"""Mamba-2 SSD mixer (counterpart of ``repro.models.ssd``, arXiv:2405.21060)
on the trivial layout: the z/x/bc/dt projections, the causal depthwise
conv, the chunked scan, the D skip, the z gate, the grouped per-head
RMSNorm and the out projection.

The chunked scan's intra-chunk step (c·bᵀ masked and decayed, times x; each
chunk's state contribution; exp of the cumulative decay) is the SSD chunk
kernel (``kernels.ops.ssd_chunk``); the inter-chunk recurrence stays a loop
over chunks in fp32 here. Decode is plain PyTorch, as the reference's is
plain jnp. The recurrent state lives in the dense cache and is updated in
place.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as K
from repro_torch.parallel import HeadPlan, Layout, plan_heads
from .layers import (causal_depthwise_conv, conv_step, dense_init,
                     empty_param, rmsnorm)


def ssd_plan(cfg, lay: Layout) -> HeadPlan:
    nh = cfg.ssm.n_heads(cfg.d_model)
    return plan_heads(nh, 1, max(lay.G, 1), max(lay.tp, 1))


class SSD(nn.Module):
    """Parameters of one SSD mixer, shaped as ``ssd_init``'s: ``wz``, ``wx``
    [d, H·hd], ``wbc`` [d, 2·ds] (one group; on the trivial layout it is
    not replicated), ``wdt`` [d, H], ``dt_bias``, ``A_log``, ``D`` [H] in
    fp32 whatever the model's type, ``conv_x`` [cw, H·hd], ``conv_bc`` [cw,
    2·ds], ``norm`` [H·hd] and ``wo`` [H·hd, d]."""

    def __init__(self, cfg, lay: Layout, dtype, device):
        super().__init__()
        s = cfg.ssm
        d, hd, ds, cw = cfg.d_model, s.head_dim, s.d_state, s.d_conv
        nh = ssd_plan(cfg, lay).h_q_pad
        self.cfg = cfg
        self.wz = empty_param((d, nh * hd), dtype, device)
        self.wx = empty_param((d, nh * hd), dtype, device)
        self.wbc = empty_param((d, 2 * ds), dtype, device)
        self.wdt = empty_param((d, nh), dtype, device)
        self.dt_bias = empty_param((nh,), torch.float32, device)
        self.A_log = empty_param((nh,), torch.float32, device)
        self.D = empty_param((nh,), torch.float32, device)
        self.conv_x = empty_param((cw, nh * hd), dtype, device)
        self.conv_bc = empty_param((cw, 2 * ds), dtype, device)
        self.norm = empty_param((nh * hd,), dtype, device)
        self.wo = empty_param((nh * hd, d), dtype, device)

    def reset_parameters(self, generator):
        """``ssd_init``'s scales: 1/sqrt(fan-in) for the projections (wbc is
        drawn as [d, 1, 2·ds], so its fan-in is 1), 0.5 for the convs; zero
        dt_bias and A_log, unit D and norm."""
        d = self.cfg.d_model
        for w in (self.wz, self.wx, self.wdt, self.wo):
            w.copy_(dense_init(w.shape, generator, w.dtype))
        self.wbc.copy_(dense_init((d, 1, self.wbc.shape[1]), generator,
                                  self.wbc.dtype).reshape(d, -1))
        for w in (self.conv_x, self.conv_bc):
            w.copy_(dense_init(w.shape, generator, w.dtype, scale=0.5))
        self.dt_bias.zero_()
        self.A_log.zero_()
        self.D.fill_(1.0)
        self.norm.fill_(1.0)


@dataclass
class SSDState:
    """One layer's recurrent state, views into the dense cache updated in
    place: ``ssm`` [B, H, hd, ds] fp32, ``conv_x`` [B, cw-1, H·hd] and
    ``conv_bc`` [B, cw-1, 2·ds] in the model's type."""
    ssm: torch.Tensor
    conv_x: torch.Tensor
    conv_bc: torch.Tensor


def ssd_state_shapes(cfg, lay: Layout, batch: int):
    """Shapes of ``ssd_state_init``'s leaves (ssm, conv_x, conv_bc)."""
    s = cfg.ssm
    nh = ssd_plan(cfg, lay).h_q_pad
    return ((batch, nh, s.head_dim, s.d_state),
            (batch, s.d_conv - 1, nh * s.head_dim),
            (batch, s.d_conv - 1, 2 * s.d_state))


def _project(p: SSD, x, cfg):
    """x: [B, S, d] -> z, xin [B, S, H, hd], bc [B, S, 2·ds], dt [B, S, H].
    On the trivial layout there is no Ulysses exchange."""
    hd = cfg.ssm.head_dim
    B, S, _ = x.shape
    return ((x @ p.wz).reshape(B, S, -1, hd), (x @ p.wx).reshape(B, S, -1, hd),
            x @ p.wbc, x @ p.wdt)


def _ssd_scan(xin, b, c, dt, A, h, chunk):
    """Chunked SSD. xin: [B, S, H, hd]; b, c: [B, S, ds] (one group); dt:
    [B, S, H] fp32 (post-softplus); A: [H] (> 0); h: [B, H, hd, ds] fp32,
    the state before the segment, overwritten with the state after it.
    Returns y [B, S, H, hd] in fp32. S is a multiple of ``chunk``, or below
    it (one chunk of length S)."""
    B, S, H, hd = xin.shape
    ds = b.shape[-1]
    assert S % chunk == 0 or S < chunk, (S, chunk)
    if S < chunk:
        chunk = S
    nc = S // chunk
    la = -dt * A                                       # log decay per step
    cum = la.reshape(B, nc, chunk, H).cumsum(2).reshape(B, S, H)
    # b and c are shared by every head: a head stride of 0, no copy
    y_in, st, dec = K.ssd_chunk(xin, b[:, :, None].expand(B, S, H, ds),
                                c[:, :, None].expand(B, S, H, ds), dt, cum,
                                chunk)
    cf = c.float().reshape(B, nc, chunk, ds)
    dec = dec.reshape(B, nc, chunk, H)
    y_in = y_in.reshape(B, nc, chunk, H, hd)
    hc = h
    ys = []
    for i in range(nc):
        # cross-chunk: y_t += (c_t . h) exp(cum_t); then the state update
        y_cr = torch.einsum("btd,bhpd->bthp", cf[:, i], hc) \
            * dec[:, i, :, :, None]
        ys.append(y_in[:, i] + y_cr)
        hc = hc * dec[:, i, -1][:, :, None, None] + st[:, i]
    h.copy_(hc)
    return ys[0].reshape(B, S, H, hd) if nc == 1 \
        else torch.stack(ys, 1).reshape(B, S, H, hd)


def _gate_norm_out(p: SSD, y, xin, z, dtype):
    """The D skip, the z gate, the grouped (per-head) RMSNorm and wo.
    y, xin, z: [..., H, hd] -> [..., d]."""
    H, hd = xin.shape[-2:]
    y = y + p.D[:, None] * xin.float()
    y = (y * F.silu(z.float())).to(dtype)
    y = rmsnorm(y, p.norm.reshape(H, hd))
    return y.reshape(*y.shape[:-2], H * hd) @ p.wo


def ssd_prefill(p: SSD, x, state: SSDState, cfg):
    """x: [B, S, d] with ``state`` the state before it (updated in place).
    Returns out [B, S, d]."""
    hd, ds = cfg.ssm.head_dim, cfg.ssm.d_state
    z, xin, bc, dt = _project(p, x, cfg)
    B, S, H, _ = xin.shape
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
    out = _gate_norm_out(p, y, xin, z, x.dtype)
    state.conv_x.copy_(conv_state[..., :H * hd])
    state.conv_bc.copy_(conv_state[..., H * hd:])
    return out


def ssd_decode(p: SSD, x, state: SSDState, cfg):
    """x: [B, d], one new token per row, with ``state`` the state before it
    (updated in place). Returns out [B, d]."""
    hd, ds = cfg.ssm.head_dim, cfg.ssm.d_state
    z, xin, bc, dt = (t[:, 0] for t in _project(p, x[:, None], cfg))
    B, H, _ = xin.shape
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
    out = _gate_norm_out(p, y, xin, z, x.dtype)
    state.conv_x.copy_(conv_state[..., :H * hd])
    state.conv_bc.copy_(conv_state[..., H * hd:])
    return out
