"""Elastic rescaling (counterpart of ``repro.ft.elastic``): the layout of a
world of ranks under another (sp, tp) factorisation, and live weights moved
from one layout's model to another's.

The reference re-places global arrays between meshes of any size in one
process. The port's ranks are processes and each holds only its shard, so
``reshard_params`` runs on every rank of one world: it gathers each
parameter over the old model's TP group into the trivial layout's form
(``convert.unshard_tensor``) and cuts the new rank's shard from it
(``convert.shard_tensor``). A leaf whose shape the layouts' KV replication
changes (wk/wv between the base and the shift config) is thereby derived
from the gathered weights themselves. The reference re-draws such a leaf
from ``init_params(key(0))`` instead: the two agree for key-0 weights and
differ for weights of any other source (ROADMAP Queue 3). An expert stack
whose EP group spans dp rows is gathered over the whole world. An MLA
layer's per-head leaves are gathered over the TP group too: their heads
follow the grid's tp in both configs (``models.mla.mla_unlayout``)."""
from __future__ import annotations

import torch

from repro_torch.convert import (is_model_group_leaf, shard_tensor,
                                 spans_dp, unshard_tensor)
from repro_torch.parallel import Layout
from repro_torch.parallel.collectives import all_gather_if


def rebuild_layout(world: int, sp: int, tp: int) -> Layout:
    """The layout of ``world`` ranks as ``world // (sp*tp)`` dp rows of an
    (sp, tp) grid (the reference reads the degrees off a surviving mesh;
    here the world size is the processes')."""
    if sp < 1 or tp < 1 or world % (sp * tp):
        raise ValueError(f"a world of {world} ranks does not hold rows of "
                         f"sp={sp} x tp={tp}")
    return Layout(dp=world // (sp * tp), sp=sp, tp=tp)


def _tp_members(lay: Layout, rank: int):
    """The process ranks of ``rank``'s TP group on ``lay``, ascending (the
    order ``dist.all_gather`` returns their parts in)."""
    if lay.tp == 1:
        return [rank]
    G = lay.G
    row = lay.dp_rank(rank) * G
    if lay.sp > 1:                       # the grid's TP group of its sp rank
        i = (rank % G) // lay.grid[1]
        return [row + i * lay.tp + j for j in range(lay.tp)]
    return [row + m for m in range(G)]   # the whole model group


@torch.no_grad()
def reshard_params(old_model, new_model):
    """Copy ``old_model``'s weights into ``new_model`` (the same config,
    device and ranks, another layout): every parameter is all-gathered over
    the old model's TP group (a MoE layer's expert stacks and an SSD
    mixer's per-head leaves over its whole model group, in model-rank
    order, and a pod-scale config's expert stacks that span dp rows over
    the whole world; traffic kind ``reshard_weights``),
    put back into its trivial form and cut for the new model's rank, one
    parameter at a time. Bitwise for every leaf. Every rank of the world
    calls it, in the same order. Returns ``new_model``."""
    old, new = old_model.lay, new_model.lay
    if old.world != new.world or old_model.cfg != new_model.cfg:
        raise ValueError(f"reshard_params: {old.describe()} on {old.world} "
                         f"ranks -> {new.describe()} on {new.world}: the "
                         "config and the world size must be the same")
    cfg = old_model.cfg
    members = _tp_members(old, old_model.shard.rank)
    order = sorted(range(len(members)),
                   key=lambda m: old.tp_rank(members[m]))
    group = old_model.shard.tp_group
    # a model-group leaf's: the row's model group, ascending process rank
    row = old.dp_rank(old_model.shard.rank) * old.G
    by_model = sorted(range(old.G), key=lambda m: old.model_rank(row + m))
    model_group = old_model.shard.axes_group(("sp", "tp"))
    dst = new_model.params.state_dict()
    world = (old_model.shard.groups.all_ranks()
             if old_model.shard.groups is not None else None)
    for name, t in old_model.params.state_dict().items():
        if spans_dp(name, cfg, old):
            # every rank's block, in process-rank order
            parts = list(all_gather_if(t, world, "reshard_weights").chunk(
                old.world))
        elif is_model_group_leaf(name, cfg):
            parts = all_gather_if(t, model_group, "reshard_weights").chunk(
                old.G)
            parts = [parts[m] for m in by_model]
        else:
            parts = all_gather_if(t, group, "reshard_weights").chunk(
                len(members))
            parts = [parts[m] for m in order]
        full = unshard_tensor(name, parts, cfg, old)
        dst[name].copy_(shard_tensor(name, full, cfg, new,
                                     new_model.shard.rank))
    return new_model
