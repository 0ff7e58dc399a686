"""Mixture-of-Experts FFN with expert parallelism (counterpart of
``repro.models.moe``).

Two dispatch paths, chosen by whether tokens are sharded or replicated over
the EP group, as the reference chooses them:

* **a2a path** (base config): tokens are sequence-sharded over the EP axes;
  the capacity-bucketed dispatch buffer is exchanged with one tiled
  all-to-all per direction (``collectives.all_to_all_tiled``), each rank
  runs its local experts, and the results return by the inverse exchange.
  ``dispatch_dtype="int8"`` sends the buffer as int8 with a per-row scale.
* **replicated path** (shift config): tokens are replicated over the EP
  group; each rank slices its local experts from the dispatch buffer and
  the combine is a psum over the model group.

Expert FF dims are further sharded over the TP axes outside the EP group
(``P(ep_axes, None, tp_rest)``). A pod-scale config's EP group may take the
``"data"`` axis (``ep_group``): on ``(2, 2, 2)`` its experts spread over
``("data", "sp")`` in the base config and over ``("data",)`` in the shift
config, and the tiled all-to-all runs over a group that spans dp rows, so
every dp row enters every MoE layer's exchange on every step (the model's
steps run on every rank with the whole batch, a row with nothing to run
included). Everything is static-shaped: the capacity ``C`` follows from
the rank's own token count in the step alone, as the reference's does,
dropped assignments go to a spare trash row of the buffer (torch has no
``mode="drop"``), and no value reaches the host, so a bucket's step
captures as one CUDA graph. The expert
products are batched matrix products (``torch.bmm``), as the reference
computes them outside any Pallas kernel.

``moe_apply`` is differentiable, for training (``train=True`` adds the
load-balance aux loss). Its gradient reaches what ``jax.grad`` of the
reference reaches: the tokens through the scatter into the dispatch buffer
and the gather back, the combine weights through ``top_k``'s values to
the router's probabilities and the router, the experts through the three
``bmm``s, and the shared experts; the routing, the capacity assignment,
the kept mask and the aux loss's expert counts carry none. The int8
dispatch passes no gradient through ``round`` and the cast to int8, as
JAX's does not: the tokens' gradient through that exchange flows only
through the per-row scale. The exchanges differentiate through
``collectives.all_to_all_tiled`` (the reverse exchange) and the combines
through ``psum_if`` (a psum). The serving path runs without autograd (its
steps under ``no_grad``, the parameters without ``requires_grad``), so
its operations are the same as before.
"""
from __future__ import annotations

import itertools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel import Layout, Shard
from repro_torch.parallel.collectives import all_to_all_tiled, psum_if
from .layers import dense_init, empty_param, shard_of

# the reference's ``repro.models.model.POD_SCALE_ARCHS``: their EP group may
# take the dp axes too
POD_SCALE_ARCHS = {"deepseek-v3-671b", "llama4-maverick-400b-a17b",
                   "llama4-17b-16e"}


def ep_group(lay: Layout, num_experts: int,
             pod_scale: bool) -> Tuple[Tuple[str, ...], bool]:
    """(ep_axes, tokens_replicated) for this layout, as the reference picks
    them: the largest subset of the sharded-token axes (sp, and dp when
    ``pod_scale``) whose size divides E; else the largest such subset of
    the model axes, with replicated tokens; else no EP."""
    sizes = lay.axis_sizes

    def best_subset(axes):
        best, best_deg = (), 1
        for n in range(1, len(axes) + 1):
            for sub in itertools.combinations(axes, n):
                deg = 1
                for a in sub:
                    deg *= sizes[a]
                if num_experts % deg == 0 and deg > best_deg:
                    best, best_deg = sub, deg
        return best, best_deg

    cand = (lay.dp_axes + lay.sp_axes) if pod_scale else lay.sp_axes
    ep, deg = best_subset(cand)
    if deg > 1:
        return ep, False
    ep, deg = best_subset(lay.model_axes)
    return (ep, True) if deg > 1 else ((), False)


def moe_tp_axes(lay: Layout, ep_axes) -> Tuple[str, ...]:
    """The TP axes outside the EP group, over which expert FF dims shard."""
    return tuple(a for a in lay.tp_axes if a not in ep_axes)


def _degree(lay: Layout, axes) -> int:
    n = 1
    for a in axes:
        n *= lay.axis_sizes[a]
    return n


def expert_axes(cfg, lay: Layout) -> Tuple[str, ...]:
    """The EP axes of ``cfg``'s MoE layers on ``lay``."""
    return ep_group(lay, cfg.moe.num_experts,
                    cfg.name in POD_SCALE_ARCHS)[0]


def expert_grid(cfg, lay: Layout, rank: int) -> Tuple[int, int, int, int]:
    """(ep, ep index, tpr, tpr index) of process ``rank`` on ``lay``: the
    degrees of the EP axes and of the TP axes outside them, and the rank's
    joint index over each (the reference's ``P(ep_axes, None, tpr)``)."""
    ep_axes = expert_axes(cfg, lay)
    tpr = moe_tp_axes(lay, ep_axes)
    return (_degree(lay, ep_axes), lay.axes_index(ep_axes, rank),
            _degree(lay, tpr), lay.axes_index(tpr, rank))


def expert_shard(full, ff_dim: int, cfg, lay: Layout, rank: int):
    """Process ``rank``'s block of a canonical [E, ., .] expert stack:
    experts over the EP axes, the FF dim (``ff_dim``: 2 for wi/wg, 1 for
    wo) over the TP axes outside them."""
    ep, e, tpr, t = expert_grid(cfg, lay, rank)
    return shard_of(shard_of(full, 0, ep, e), ff_dim, tpr, t)


class SharedExperts(nn.Module):
    """The shared experts' SwiGLU, ``wi``/``wg`` column-sharded and ``wo``
    row-sharded over the layout's TP axes."""

    def __init__(self, d, ffs, tp, dtype, device):
        super().__init__()
        self.wi = empty_param((d, ffs // tp), dtype, device)
        self.wg = empty_param((d, ffs // tp), dtype, device)
        self.wo = empty_param((ffs // tp, d), dtype, device)


class MoE(nn.Module):
    """One MoE FFN: ``router`` [d, E] in fp32, this rank's experts ``wi``/
    ``wg`` [E_loc, d, ff_loc] and ``wo`` [E_loc, ff_loc, d] (E_loc = E/ep
    over the EP axes, ff_loc = ff/tpr over the TP axes outside them) and the
    optional ``shared`` SwiGLU. An EP or FF group of more than one rank
    needs the grid's ``Groups`` (``shard``)."""

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        super().__init__()
        self.cfg = cfg
        self.shard = shard = shard or Shard(lay)
        mo = cfg.moe
        self.pod_scale = cfg.name in POD_SCALE_ARCHS
        self.ep_axes, self.replicated = ep_group(lay, mo.num_experts,
                                                 self.pod_scale)
        self.tpr = moe_tp_axes(lay, self.ep_axes)
        self.ep, self.ep_index, tpr, _ = expert_grid(cfg, lay, shard.rank)
        if shard.groups is None and self.ep * tpr > 1:
            raise ValueError(
                f"{cfg.name} on {lay.describe()}: experts over "
                f"{self.ep_axes} and FF over {self.tpr} need the grid's "
                "Groups")
        self.E_loc = mo.num_experts // self.ep
        d, ff = cfg.d_model, mo.d_ff_expert
        self.router = empty_param((d, mo.num_experts), torch.float32, device)
        self.wi = empty_param((self.E_loc, d, ff // tpr), dtype, device)
        self.wg = empty_param((self.E_loc, d, ff // tpr), dtype, device)
        self.wo = empty_param((self.E_loc, ff // tpr, d), dtype, device)
        if mo.num_shared_experts:
            self.shared = SharedExperts(
                d, (mo.d_ff_shared or ff) * mo.num_shared_experts,
                max(lay.tp, 1), dtype, device)
        # the groups of the exchange and of the two combines (the
        # replicated path's, over the model axes alone)
        self.ep_group = shard.axes_group(self.ep_axes)
        self.tpr_group = shard.axes_group(self.tpr)
        self.combine_group = (shard.axes_group(self.ep_axes + self.tpr)
                              if self.replicated else None)

    def reset_parameters(self, generator):
        """``moe_init``'s draws at their canonical shapes, then this rank's
        part of each (``moe_specs``)."""
        mo, d = self.cfg.moe, self.cfg.d_model
        E, ff = mo.num_experts, mo.d_ff_expert
        f32 = torch.float32
        self.router.copy_(dense_init((d, E), generator, f32))
        for w, shape, ff_dim in ((self.wi, (E, d, ff), 2),
                                 (self.wg, (E, d, ff), 2),
                                 (self.wo, (E, ff, d), 1)):
            w.copy_(expert_shard(dense_init(shape, generator, f32), ff_dim,
                                 self.cfg, self.shard.lay,
                                 self.shard.rank).to(w.dtype))
        if mo.num_shared_experts:
            ffs = (mo.d_ff_shared or ff) * mo.num_shared_experts
            tp, k = max(self.shard.lay.tp, 1), self.shard.tp_rank
            for w, shape, dim in ((self.shared.wi, (d, ffs), 1),
                                  (self.shared.wg, (d, ffs), 1),
                                  (self.shared.wo, (ffs, d), 0)):
                full = dense_init(shape, generator, f32)
                w.copy_(shard_of(full, dim, tp, k).to(w.dtype))



def top_k(probs, k: int):
    """``lax.top_k`` over the last axis: the k largest values, ties broken
    toward the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch_indices(sel, C: int):
    """Sort-based capacity assignment (the reference's
    ``_dispatch_indices``). sel: [T, k] expert ids. Returns (slot, keep,
    flat_e), each [T*k] in token order: an assignment's rank among those of
    its expert (in token order) keeps it when below C, at slot
    ``e*C + min(rank, C-1)``."""
    flat_e = sel.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    n = flat_e.shape[0]
    seg_pos = torch.arange(n, device=sel.device) \
        - torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks = torch.empty_like(flat_e)
    ranks[order] = seg_pos
    keep = ranks < C
    slot = flat_e * C + ranks.clamp(max=C - 1)
    return slot, keep, flat_e


def capacity(T: int, cfg) -> int:
    """Slots per expert for a step of T tokens."""
    mo = cfg.moe
    return max(1, int(T * mo.top_k * mo.capacity_factor) // mo.num_experts)


def route(p: MoE, xt):
    """Router probabilities (fp32 softmax of the logits, the router cast to
    the activations' type for the product), the top-k selection and its
    renormalised weights, and the capacity assignment. xt: [T, d]."""
    mo = p.cfg.moe
    logits = (xt @ p.router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    w, sel = top_k(probs, mo.top_k)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    C = capacity(xt.shape[0], p.cfg)
    slot, keep, flat_e = dispatch_indices(sel, C)
    return probs, w, sel, C, slot, keep, flat_e


def _int8_exchange(buf, group):
    """The a2a dispatch of ``buf`` [ep, E_loc, C, d] as int8 with one fp32
    scale per row (``jnp.round`` and ``torch.round`` both round half to
    even), dequantised to buf's type: [E_loc, ep*C, d]."""
    amax = buf.abs().amax(-1, keepdim=True)
    scale = amax.float().clamp(min=1e-8) / 127.0
    q8 = torch.clamp(torch.round(buf.float() / scale), -127, 127) \
        .to(torch.int8)
    q8 = all_to_all_tiled(q8, group, 0, 2)[0]
    sc = all_to_all_tiled(scale, group, 0, 2)[0]
    return (q8.float() * sc).to(buf.dtype)


def moe_apply(p: MoE, x, train: bool = False):
    """x: [B, S_loc, d]. Returns (out [B, S_loc, d], aux): the routed
    experts' weighted outputs plus the shared experts', and under
    ``train=True`` the load-balance loss, a 0-d fp32 tensor (0.0
    otherwise). Differentiable while autograd records (the module
    docstring says where the gradient flows)."""
    mo = p.cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = mo.num_experts, mo.top_k
    xt = x.reshape(T, d)
    probs, w, sel, C, slot, keep, flat_e = route(p, xt)

    # scatter into [E*C] slots plus the trash row E*C for dropped ones
    buf = xt.new_zeros((E * C + 1, d))
    buf[torch.where(keep, slot, E * C)] = xt.repeat_interleave(k, dim=0)
    buf = buf[:E * C].reshape(E, C, d)

    E_loc, r = p.E_loc, p.ep_index
    if p.replicated and p.ep_axes:
        toks = buf[r * E_loc:(r + 1) * E_loc]                 # [E_loc, C, d]
    elif p.ep_axes:
        send = buf.reshape(p.ep, E_loc, C, d)
        toks = (_int8_exchange(send, p.ep_group) if mo.dispatch_dtype
                == "int8" else all_to_all_tiled(send, p.ep_group, 0, 2)[0])
    else:
        toks = buf                                             # one device

    h = torch.bmm(toks, p.wi)
    g = torch.bmm(toks, p.wg)
    y = torch.bmm(F.silu(g) * h, p.wo)                         # [E_loc, ., d]

    wk = w[..., None]
    if p.replicated and p.ep_axes:
        # gather this rank's experts' rows (zeros for remote experts),
        # combine, then one psum over the EP and FF-shard axes
        n_loc = E_loc * C
        loc = slot - r * n_loc
        ok = keep & (loc >= 0) & (loc < n_loc)
        rows = torch.cat([y.reshape(n_loc, d), y.new_zeros((1, d))])
        gathered = rows[torch.where(ok, loc, n_loc)]
        out = (gathered.reshape(T, k, d) * wk.to(gathered.dtype)).sum(1)
        out = psum_if(out, p.combine_group)
    else:
        if p.ep_axes:
            out_buf = all_to_all_tiled(y.reshape(E_loc, p.ep, C, d),
                                       p.ep_group, 1, 0).reshape(E, C, d)
        else:
            out_buf = y
        gathered = out_buf.reshape(E * C, d)[slot]
        gathered = torch.where(keep[:, None], gathered,
                               gathered.new_zeros(()))
        out = (gathered.reshape(T, k, d) * wk.to(gathered.dtype)).sum(1)
        out = psum_if(out, p.tpr_group)

    if mo.num_shared_experts:
        sh = p.shared
        hh = F.silu(xt @ sh.wg) * (xt @ sh.wi)
        out = out + psum_if(hh @ sh.wo, p.shard.tp_group)

    aux = 0.0
    if train:
        me = probs.mean(0)
        ce = torch.zeros((E,), device=x.device).index_add_(
            0, flat_e, keep.float())
        ce = ce / ce.sum().clamp(min=1.0)
        aux = mo.router_aux_coef * E * torch.sum(me * ce)
    return out.reshape(B, S, d), aux
