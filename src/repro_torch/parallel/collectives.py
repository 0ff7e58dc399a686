"""Collectives of the port's layouts on ``torch.distributed`` (counterpart of
``psum_if``, ``all_gather_if`` and ``joint_axis_index`` in
``repro.parallel.layout``, which run over named mesh axes inside
``shard_map``).

The port runs one process per rank, as ``shard_map`` runs one program per
device. ``Groups`` builds a grid's process groups once, in the same order
on every rank: one SP group per tp rank ``j`` (the ranks ``i*tp + j``), one
TP group per sp rank ``i`` (the ranks ``i*tp + j``), and the whole world,
which is the shift config's TP group. A group of one is ``None``, and the
collectives below are no-ops on it, as the reference's are on empty axes.

The backend is whatever ``init_process_group`` was given (``launch.mesh``
passes it explicitly). Each ``Group`` counts the payload bytes this rank
hands to its collectives, by kind, in the ``Groups``' ``traffic``.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Optional, Sequence, TYPE_CHECKING

import torch
import torch.distributed as dist

if TYPE_CHECKING:
    from .layout import Layout


def joint_axis_index(indices: Sequence[int], sizes: Sequence[int]) -> int:
    """Joint rank within a tuple of axes, major to minor in listed order."""
    idx = 0
    for i, n in zip(indices, sizes):
        idx = idx * n + i
    return idx


@dataclass
class Group:
    """One process group of more than one rank, with this process's rank in
    it (ranks are numbered in ascending process rank, as
    ``dist.new_group`` numbers them) and the traffic counter it adds to."""
    pg: object
    size: int
    rank: int
    traffic: Counter

    def count(self, kind: str, t: torch.Tensor):
        self.traffic[kind + "_bytes"] += t.numel() * t.element_size()
        self.traffic[kind + "_calls"] += 1


class Groups:
    """The process groups of an (sp, tp) grid, for the calling rank. Every
    rank of the world must build them, in the same order."""

    def __init__(self, sp: int, tp: int):
        self.sp, self.tp = sp, tp
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        if sp * tp != self.world:
            raise ValueError(f"grid sp={sp} x tp={tp} on a world of "
                             f"{self.world}")
        self.backend = dist.get_backend()
        self.traffic: Counter = Counter()
        i, j = divmod(self.rank, tp)
        self.sp_group = self.tp_group = None
        for jj in range(tp):
            g = self._new([ii * tp + jj for ii in range(sp)])
            if jj == j:
                self.sp_group = g
        for ii in range(sp):
            g = self._new([ii * tp + jj for jj in range(tp)])
            if ii == i:
                self.tp_group = g
        self.world_group = (Group(dist.group.WORLD, self.world, self.rank,
                                  self.traffic) if self.world > 1 else None)

    def _new(self, ranks) -> Optional[Group]:
        if len(ranks) == 1:
            return None
        pg = dist.new_group(ranks)
        return (Group(pg, len(ranks), ranks.index(self.rank), self.traffic)
                if self.rank in ranks else None)

    def _check(self, lay: "Layout"):
        if lay.grid != (self.sp, self.tp):
            raise ValueError(f"layout on grid {lay.grid}, groups of grid "
                             f"{(self.sp, self.tp)}")

    def sp_of(self, lay: "Layout") -> Optional[Group]:
        """The layout's SP group for this rank (None without an SP axis)."""
        self._check(lay)
        return self.sp_group if lay.sp > 1 else None

    def tp_of(self, lay: "Layout") -> Optional[Group]:
        """The layout's TP group for this rank: the grid's TP group in the
        base config, the whole world in the shift config."""
        self._check(lay)
        if lay.tp == 1:
            return None
        return self.tp_group if lay.sp > 1 else self.world_group


def psum_if(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Sum of ``x`` over ``group``, in place; ``x`` itself for no group."""
    if group is None:
        return x
    group.count("all_reduce", x)
    dist.all_reduce(x, group=group.pg)
    return x


def all_gather_if(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along axis 0 in the
    group's rank order (tiled); ``x`` itself for no group."""
    if group is None:
        return x
    group.count("all_gather", x)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x, group=group.pg)
    return torch.cat(parts)


def all_to_all(send: torch.Tensor, group: Group) -> torch.Tensor:
    """One ``all_to_all_single``: ``send`` [n, ...] (contiguous) sends its
    chunk k to group rank k; the result [n, ...] holds in chunk k what rank
    k sent."""
    group.count("all_to_all", send)
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group.pg)
    return out
