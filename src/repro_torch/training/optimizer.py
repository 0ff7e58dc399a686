"""AdamW with ZeRO-1 optimizer-state sharding (counterpart of
``repro.training.optimizer``).

The moments are sharded over the data-parallel rows on top of each
parameter's own TP sharding, at the reference's place: per leaf of the
reference's tree, the first dimension whose spec entry is free and
divisible by dp (``_zero1_dim``). The reference stacks the layers of its
body over a leading axis, so with as many repeats as dp divides that axis
comes first, and dp row d holds the moments of whole layers (its
``reps/dp`` consecutive repeats); otherwise a dim of the leaf is cut. The
port keeps a record of which dims of a parameter the reference's spec
shards (``tp_dims``, the same record ``convert.shard_tensor`` cuts by) and
of the reference's local view of the embedding and the LM head
(``ref_view``), so each rank holds exactly the moment slice of its device
in the reference. A leaf that already shards over a dp axis gets no ZeRO
dim, as in the reference: a pod-scale config's expert stacks, whose EP
group takes ``"data"`` (``convert.spans_dp``). Each rank updates its slice
and all-gathers the delta over dp (classic ZeRO-1): a cut dim by one
all-gather, a whole layer by a broadcast from the row that holds it."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.convert import is_expert_leaf, spans_dp
from repro_torch.models.moe import expert_axes, moe_tp_axes
from repro_torch.parallel.collectives import psum_if


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: torch.dtype = torch.float32   # bf16 halves optimizer memory


# ---------------------------------------------------------------------------
# the reference's view of a parameter
# ---------------------------------------------------------------------------
_TP_DIMS = {"wq": (1,), "wk": (1,), "wv": (1,), "wi": (1,), "wg": (1,),
            "wo": (0,), "bq": (0,), "bk": (0,), "bv": (0,)}
# MLA (``mla_specs``): the up projections' columns and wo's rows over
# ``mla_tp_axes``; wq_a, wkv_a and the two norms whole
_MLA_DIMS = {"wq_b": (1,), "wk_b": (1,), "wv_b": (1,), "wo": (0,)}
# the SSD mixer (``ssd_specs``): the projections' columns (wbc's too) and
# wo's rows over tp, the per-head leaves over the model group
# (``head_spec_entry``), conv_bc whole
_SSD_DIMS = {"wz": (1,), "wx": (1,), "wbc": (1,), "wdt": (1,), "wo": (0,),
             "dt_bias": (0,), "A_log": (0,), "D": (0,), "norm": (0,),
             "conv_x": (1,)}


def tp_dims(name: str, cfg, lay) -> tuple:
    """Dims of the reference's per-layer local view of parameter ``name``
    whose spec names mesh axes (whatever their size): the embedding's and
    the LM head's leading ``G/tp`` shards, the attention's, the MLP's and
    the shared experts' column-sharded q/k/v, ``wi``, ``wg`` (and biases)
    and row-sharded ``wo``; of a MoE layer's expert stack [E_loc, ., .]
    the experts' dim over the EP axes and the FF dim over the TP axes
    outside them, where those are not empty (``P(ep, None, tpr)``); an MLA
    layer's up projections and O over ``mla_tp_axes`` (the MTP head's
    block as a layer's); an SSD mixer's projections over tp and its
    per-head leaves over the model group; none for the router, the MTP
    head's proj, conv_bc and the norms' scales."""
    if is_expert_leaf(name, cfg):
        ep_axes = expert_axes(cfg, lay)
        ff = 1 if name.endswith(".wo") else 2
        return tuple(i for i, axes in ((0, ep_axes),
                                       (ff, moe_tp_axes(lay, ep_axes)))
                     if axes)
    if name in ("embed.table", "lm_head.w"):
        return (0,)
    parts = name.split(".")
    if parts[-2] == "attn" and cfg.mla is not None:
        return _MLA_DIMS.get(parts[-1], ())
    if parts[-2] in ("attn", "ffn", "shared"):
        return _TP_DIMS.get(parts[-1], ())
    if parts[-2] == "mix" and cfg.layer_kinds[int(parts[1])] == "ssd":
        return _SSD_DIMS.get(parts[-1], ())
    return ()


def ref_view(name: str, t: torch.Tensor, lay) -> torch.Tensor:
    """Parameter ``t`` (this rank's shard) in the reference's local layout:
    the table [G/tp, v_loc, d] (the port holds [v_blk, d]), the head [G/tp,
    d, v_loc] (the port holds [d, v_blk]); every other parameter as it
    is."""
    n = max(lay.G, 1) // max(lay.tp, 1)
    if name == "embed.table":
        return t.view(n, -1, t.shape[-1])
    if name == "lm_head.w":
        return t.view(t.shape[0], n, -1).permute(1, 0, 2)
    return t


def ref_unview(name: str, v: torch.Tensor, shape) -> torch.Tensor:
    """The inverse of ``ref_view``: a tensor in the reference's local
    layout back in the port's parameter ``shape``."""
    if name == "lm_head.w":
        v = v.permute(1, 0, 2)
    return v.reshape(shape)


def stack_index(name: str, cfg) -> Optional[int]:
    """The repeat index of a layer of the reference's stacked body (its
    ``body.s{k}`` leaves, stacked over ``cfg.pattern_repeats``), or None for
    a parameter outside it (prefix and suffix layers, embedding, head,
    final norm)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return None
    i = int(parts[1]) - len(cfg.prefix_layers)
    reps = cfg.pattern_repeats
    if not 0 <= i < reps * len(cfg.layer_pattern):
        return None
    return i // len(cfg.layer_pattern)


def _zero1_dim(sharded: Sequence[bool], shape, dp: int) -> Optional[int]:
    """Index of the dim to additionally shard over dp (or None): the first
    one that the spec leaves free, divisible by dp and at least dp."""
    if dp <= 1:
        return None
    for i, (sh, s) in enumerate(zip(sharded, shape)):
        if not sh and s % dp == 0 and s >= dp:
            return i
    return None


@dataclass(frozen=True)
class ZeroSlice:
    """Where one parameter's moments live on a rank: ``"whole"`` (no ZeRO
    dim: the moment has the parameter's shape), ``"layer"`` (the stacked
    layers are cut: dp row ``owner`` holds the layer's whole moment,
    the others nothing) or ``"dim"`` (dim ``dim`` of the reference view is
    cut into blocks of ``blk``, dp row d holding block d)."""
    kind: str
    owner: int = 0
    dim: int = 0
    blk: int = 0


def zero1_slice(name: str, shape, cfg, lay) -> ZeroSlice:
    """The ZeRO-1 slice of parameter ``name`` (this rank's ``shape``) on
    ``lay``: the reference's ``_zero1_dim`` of the reference's leaf (with
    the stacked body's leading repeats axis); ``"whole"`` for an expert
    stack sharded over a dp axis."""
    dp = lay.dp
    if spans_dp(name, cfg, lay):
        return ZeroSlice("whole")
    view = tuple(ref_view(name, torch.empty(shape, device="meta"),
                          lay).shape)
    sharded = [i in tp_dims(name, cfg, lay) for i in range(len(view))]
    r = stack_index(name, cfg)
    if r is not None:
        reps = cfg.pattern_repeats
        z = _zero1_dim([False] + sharded, (reps,) + view, dp)
        if z == 0:
            return ZeroSlice("layer", owner=r // (reps // dp))
        if z is None:
            return ZeroSlice("whole")
        return ZeroSlice("dim", dim=z - 1, blk=view[z - 1] // dp)
    z = _zero1_dim(sharded, view, dp)
    if z is None:
        return ZeroSlice("whole")
    return ZeroSlice("dim", dim=z, blk=view[z] // dp)


def moment_slice(name: str, t: torch.Tensor, zs: ZeroSlice, lay,
                 dp_rank: int) -> Optional[torch.Tensor]:
    """This dp row's part of a parameter-shaped tensor ``t`` under ``zs``
    (None where the row holds none of it)."""
    if zs.kind == "whole":
        return t
    if zs.kind == "layer":
        return t if zs.owner == dp_rank else None
    return ref_view(name, t, lay).narrow(zs.dim, dp_rank * zs.blk, zs.blk)


def gather_moment(name: str, part: Optional[torch.Tensor], zs: ZeroSlice,
                  shape, lay, dp_group, device, dtype) -> torch.Tensor:
    """The inverse of ``moment_slice`` over the DP group: every row's part
    put together, a tensor of the parameter's ``shape`` (every rank of the
    group must call it; a row that holds none passes None)."""
    if zs.kind == "whole" or dp_group is None:
        return part
    if zs.kind == "layer":
        buf = (part.contiguous() if part is not None
               else torch.empty(shape, dtype=dtype, device=device))
        return _broadcast(buf, zs.owner, dp_group)
    parts = [torch.empty_like(part) for _ in range(dp_group.size)]
    dp_group.count("all_gather", part)
    dist.all_gather(parts, part.contiguous(), group=dp_group.pg)
    return ref_unview(name, torch.cat(parts, dim=zs.dim), shape)


def _broadcast(t: torch.Tensor, owner: int, group) -> torch.Tensor:
    """``t`` of dp row ``owner`` on every rank of ``group`` (in place on
    the others)."""
    group.count("broadcast", t)
    dist.broadcast(t, src=dist.get_global_rank(group.pg, owner),
                   group=group.pg)
    return t


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(model, cfg: AdamWConfig) -> dict:
    """Zero moments of every parameter of ``model``, this rank's ZeRO-1
    slices (None where its dp row holds none), and step 0."""
    lay, d = model.lay, model.shard.dp_rank
    m, v = {}, {}
    for name, p in model.params.named_parameters():
        zs = zero1_slice(name, p.shape, model.cfg, lay)
        part = moment_slice(name, p.detach(), zs, lay, d)
        m[name] = (None if part is None else
                   torch.zeros(part.shape, dtype=cfg.state_dtype,
                               device=p.device))
        v[name] = None if part is None else torch.zeros_like(m[name])
    return {"m": m, "v": v, "step": 0}


def _global_norm(grads: Dict[str, torch.Tensor], group) -> torch.Tensor:
    """sqrt of the sum of squares of every local gradient, summed over
    ``group`` (the TP group: the shards are disjoint there; the reference
    sums the replicated leaves once per tp rank too)."""
    sq = sum(g.float().square().sum() for g in grads.values())
    return torch.sqrt(psum_if(sq, group))


@torch.no_grad()
def adamw_update(model, grads: Dict[str, torch.Tensor], opt_state: dict,
                 cfg: AdamWConfig) -> dict:
    """One AdamW step on this rank's shard, in place: the parameters of
    ``model`` and the moments of ``opt_state`` (this rank's ZeRO slices)
    are updated, the new state returned. ``grads`` are this rank's fp32
    gradients after the (dp, sp) reduction; they are scaled in place. Per
    leaf: the gradient clipped by the global norm (summed over TP), the dp
    row's slice of it and of the parameter, the moments updated, and the
    delta all-gathered over dp, in the reference's fp32 arithmetic (the
    in-place forms keep one leaf's temporaries to two of its size)."""
    sh, lay = model.shard, model.lay
    dp_group, d = sh.dp_group, sh.dp_rank
    step = opt_state["step"] + 1
    f32 = torch.float32
    dev = next(iter(grads.values())).device
    stepf = torch.tensor(float(step), dtype=f32, device=dev)
    c1 = 1.0 - torch.tensor(cfg.b1, dtype=f32, device=dev) ** stepf
    c2 = 1.0 - torch.tensor(cfg.b2, dtype=f32, device=dev) ** stepf
    gn = _global_norm(grads, sh.tp_group)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    m, v = dict(opt_state["m"]), dict(opt_state["v"])
    for name, p in model.params.named_parameters():
        zs = zero1_slice(name, p.shape, model.cfg, lay)
        g = grads[name]
        g = g.mul_(scale) if g.dtype == f32 else g.float() * scale
        gs = moment_slice(name, g, zs, lay, d)
        if gs is None:
            delta = torch.empty(p.shape, dtype=f32, device=p.device)
        else:
            ps = moment_slice(name, p, zs, lay, d)
            mf, vf = m[name].float(), v[name].float()
            mf.mul_(cfg.b1).add_(gs, alpha=1 - cfg.b1)
            vf.mul_(cfg.b2).addcmul_(gs, gs, value=1 - cfg.b2)
            denom = (vf / c2).sqrt_().add_(cfg.eps)
            delta = (mf / c1).div_(denom).add_(ps, alpha=cfg.weight_decay)
            del denom
            if m[name].dtype != mf.dtype:       # a bf16 state
                m[name], v[name] = mf.to(cfg.state_dtype), vf.to(
                    cfg.state_dtype)
        if zs.kind == "dim" and dp_group is not None:
            parts = [torch.empty_like(delta) for _ in range(dp_group.size)]
            dp_group.count("all_gather", delta)
            dist.all_gather(parts, delta.contiguous(), group=dp_group.pg)
            delta = ref_unview(name, torch.cat(parts, dim=zs.dim), p.shape)
        elif zs.kind == "layer" and dp_group is not None:
            delta = _broadcast(delta.contiguous(), zs.owner, dp_group)
        p.copy_(delta.mul_(-cfg.lr).add_(p))
    return {**opt_state, "m": m, "v": v, "step": step}
