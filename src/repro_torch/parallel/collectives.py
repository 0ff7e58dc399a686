"""Collectives of the port's layouts on ``torch.distributed`` (counterpart of
``psum_if``, ``all_gather_if`` and ``joint_axis_index`` in
``repro.parallel.layout``, which run over named mesh axes inside
``shard_map``).

The port runs one process per rank, as ``shard_map`` runs one program per
device. ``Groups`` builds the process groups of ``dp`` rows of an (sp, tp)
grid once, in the same order on every rank (``dist.new_group`` must be
called by every rank for every group): for each row ``d``, one SP group
per tp rank ``j`` (the ranks ``d*G + i*tp + j`` over ``i``), one TP group
per sp rank ``i`` (over ``j``) and the row's model group, which is the
shift config's TP group; then one DP group per grid position ``(i, j)``
(the ranks ``d*G + i*tp + j`` over ``d``); then, with dp rows and an SP
axis, one group over ``("data", "sp")`` per tp rank ``j`` (the ranks
``d*G + i*tp + j`` over ``(d, i)``), the expert-parallel group of a
pod-scale MoE layer in the base config. A group of one is ``None``, and
the collectives below are no-ops on it, as the reference's are on empty
axes.

The backend is whatever ``init_process_group`` was given (``launch.mesh``
passes it explicitly). Each ``Group`` counts the payload bytes this rank
hands to its collectives, by kind, in the ``Groups``' ``traffic``.

Training differentiates through ``psum_if``, ``all_to_all`` (and so
``all_to_all_tiled`` and the Ulysses exchange) and ``all_gather_axis``:
while autograd records, each runs out of place as a
``torch.autograd.Function`` whose backward is JAX's transpose rule in a
``shard_map`` without replication checks: ``psum`` -> ``psum``,
``all_to_all`` -> the reverse ``all_to_all``, a tiled ``all_gather`` -> a
reduce-scatter; ``pmax_sg`` carries no gradient. So a rank's gradients are
the reference's per-device gradients, not the single-device ones (ROADMAP
Queue 3). The serving path runs under ``no_grad`` and keeps its in-place
calls; a backward's collectives are counted in ``traffic`` too.
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
    """The process groups of ``dp`` rows of an (sp, tp) grid, for the
    calling rank. Every rank of the world must build them, in the same
    order. ``world_group`` is the calling rank's row (its model group)."""

    def __init__(self, sp: int, tp: int, *, dp: int = 1):
        self.sp, self.tp, self.dp = sp, tp, dp
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        if dp * sp * tp != self.world:
            raise ValueError(f"dp={dp} rows of grid sp={sp} x tp={tp} on a "
                             f"world of {self.world}")
        self.backend = dist.get_backend()
        self.traffic: Counter = Counter()
        G = sp * tp
        d = self.rank // G
        i, j = divmod(self.rank % G, tp)
        self.sp_group = self.tp_group = self.world_group = None
        for dd in range(dp):
            row = dd * G
            for jj in range(tp):
                g = self._new([row + ii * tp + jj for ii in range(sp)])
                if (dd, jj) == (d, j):
                    self.sp_group = g
            for ii in range(sp):
                g = self._new([row + ii * tp + jj for jj in range(tp)])
                if (dd, ii) == (d, i):
                    self.tp_group = g
            if dp == 1:
                # one row: the model group is the world itself
                self.world_group = (Group(dist.group.WORLD, G, self.rank,
                                          self.traffic) if G > 1 else None)
            else:
                g = self._new(list(range(row, row + G)))
                if dd == d:
                    self.world_group = g
        self.dp_group = None
        for ii in range(sp):
            for jj in range(tp):
                g = self._new([dd * G + ii * tp + jj for dd in range(dp)])
                if (ii, jj) == (i, j):
                    self.dp_group = g
        # ascending process rank over (d, i) is the joint index over
        # ("data", "sp"), data-major
        self.dp_sp_group = self.sp_group if dp == 1 else self.dp_group
        if dp > 1 and sp > 1:
            for jj in range(tp):
                g = self._new([dd * G + ii * tp + jj for dd in range(dp)
                               for ii in range(sp)])
                if jj == j:
                    self.dp_sp_group = g

    def all_ranks(self) -> Optional[Group]:
        """Every rank of the world as one group, counting into this
        ``Groups``' traffic (None for a world of one): a reshard's re-pour
        gathers over it."""
        if self.world == 1:
            return None
        return Group(dist.group.WORLD, self.world, self.rank, self.traffic)

    def _new(self, ranks) -> Optional[Group]:
        if len(ranks) == 1:
            return None
        pg = dist.new_group(ranks)
        return (Group(pg, len(ranks), ranks.index(self.rank), self.traffic)
                if self.rank in ranks else None)

    def _check(self, lay: "Layout"):
        if lay.grid != (self.sp, self.tp) or lay.dp != self.dp:
            raise ValueError(f"layout of dp={lay.dp} on grid {lay.grid}, "
                             f"groups of dp={self.dp} on grid "
                             f"{(self.sp, self.tp)}")

    def sp_of(self, lay: "Layout") -> Optional[Group]:
        """The layout's SP group for this rank (None without an SP axis)."""
        self._check(lay)
        return self.sp_group if lay.sp > 1 else None

    def tp_of(self, lay: "Layout") -> Optional[Group]:
        """The layout's TP group for this rank: the grid's TP group in the
        base config, the rank's whole row in the shift config."""
        self._check(lay)
        if lay.tp == 1:
            return None
        return self.tp_group if lay.sp > 1 else self.world_group

    def dp_of(self, lay: "Layout") -> Optional[Group]:
        """The layout's DP group for this rank (None for one row)."""
        self._check(lay)
        return self.dp_group

    def axes_group(self, axes) -> Optional[Group]:
        """The group over a set of the named axes: ``"sp"`` is the grid's
        SP group, ``"tp"`` its TP group, both the row's model group (each
        within this rank's dp row); ``"data"`` is the DP group and
        ``"data"`` with ``"sp"`` the group over both (a pod-scale MoE
        layer's EP group, across dp rows); no axes, or axes of one rank,
        give None. A group's ranks are numbered in ascending process rank,
        which is the joint index over ``("sp",)``, ``("tp",)``,
        ``("sp", "tp")``, ``("data",)`` and ``("data", "sp")`` (not over
        ``("tp", "sp")``). Other sets with ``"data"`` have no group here
        and raise."""
        names = set(axes)
        groups = {frozenset(): None,
                  frozenset({"sp"}): self.sp_group,
                  frozenset({"tp"}): self.tp_group,
                  frozenset({"sp", "tp"}): self.world_group,
                  frozenset({"data"}): self.dp_group,
                  frozenset({"data", "sp"}): self.dp_sp_group}
        if frozenset(names) not in groups:
            raise ValueError(
                f"a group over {sorted(names)}: the groups across dp rows "
                "are over ('data',) and ('data', 'sp') alone")
        return groups[frozenset(names)]


def recording(*ts: torch.Tensor) -> bool:
    """True while autograd records an operation on any of ``ts``: the
    differentiable collectives and kernels (``kernels.ops``) of training
    run then, the serving path's in-place collectives and forward kernels
    otherwise."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _PSum(torch.autograd.Function):
    """``psum`` out of place; its backward is ``psum`` of the cotangent,
    JAX's transpose of ``psum`` in a ``shard_map`` without replication
    checks (``check_vma=False``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        group.count("all_reduce", y)
        dist.all_reduce(y, group=group.pg)
        return y

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.group), None


def psum_if(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Sum of ``x`` over ``group``, in place; ``x`` itself for no group.
    While autograd records (``x`` requires grad) the sum is out of place
    and differentiable (``_PSum``)."""
    if group is None:
        return x
    if recording(x):
        return _PSum.apply(x, group)
    group.count("all_reduce", x)
    dist.all_reduce(x, group=group.pg)
    return x


def pmax_if(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Maximum of ``x`` over ``group``, in place; ``x`` itself for no
    group."""
    if group is None:
        return x
    group.count("all_reduce", x)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group.pg)
    return x


def all_gather_if(x: torch.Tensor, group: Optional[Group],
                  kind: str = "all_gather") -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along axis 0 in the
    group's rank order (tiled); ``x`` itself for no group. ``kind`` names
    the call in the traffic counter (``"dp_all_gather"`` for the DP
    group's token gather)."""
    if group is None:
        return x
    group.count(kind, x)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x, group=group.pg)
    return torch.cat(parts)


class _AllGatherAxis(torch.autograd.Function):
    """The tiled all-gather along ``axis``; its backward is the
    reduce-scatter of the cotangent (``psum_scatter``, JAX's transpose of a
    tiled ``all_gather``): summed over the group, each rank keeping its own
    part along ``axis``."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        ctx.size = x.shape[axis]
        return torch.cat(all_gather_if(x[None], group).unbind(0), dim=axis)

    @staticmethod
    def backward(ctx, g):
        total = _PSum.apply(g.contiguous(), ctx.group)
        return (total.narrow(ctx.axis, ctx.group.rank * ctx.size, ctx.size),
                None, None)


def all_gather_axis(x: torch.Tensor, group: Optional[Group],
                    axis: int) -> torch.Tensor:
    """``all_gather_if`` concatenating along ``axis`` (the reference's
    ``all_gather(x, axes, axis=axis, tiled=True)``), differentiable while
    autograd records."""
    if group is None:
        return x
    if recording(x):
        return _AllGatherAxis.apply(x, group, axis)
    return torch.cat(all_gather_if(x[None], group).unbind(0), dim=axis)


def pmax_sg(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """The reference's ``layers.pmax_sg``: the maximum over ``group`` of
    the stop-gradient'd ``x``, taken over an all-gather (a softmax
    stabilizer, where the max cancels); no gradient flows through it."""
    x = x.detach()
    if group is None:
        return x
    return all_gather_if(x[None], group).amax(dim=0)


def _all_to_all(send: torch.Tensor, group: Group) -> torch.Tensor:
    group.count("all_to_all", send)
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group.pg)
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks; its backward sends the
    cotangent's chunk k back to rank k, which is the same exchange (JAX's
    transpose of ``all_to_all`` swaps the split and concat axes)."""

    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        return _all_to_all(send, group)

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g.contiguous(), ctx.group), None


def all_to_all(send: torch.Tensor, group: Group) -> torch.Tensor:
    """One ``all_to_all_single``: ``send`` [n, ...] (contiguous) sends its
    chunk k to group rank k; the result [n, ...] holds in chunk k what rank
    k sent. Differentiable while autograd records."""
    if recording(send):
        return _AllToAll.apply(send, group)
    return _all_to_all(send, group)


def all_to_all_tiled(x: torch.Tensor, group: Optional[Group], split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axes, split_axis, concat_axis, tiled=True)``
    over ``group``: ``x`` cut into ``group.size`` equal chunks along
    ``split_axis``, chunk k sent to group rank k, and the chunks received
    concatenated along ``concat_axis`` in source rank order; ``x`` itself
    for no group. Differentiable while autograd records (its backward is
    the reverse exchange)."""
    if group is None:
        return x
    send = torch.stack(x.chunk(group.size, dim=split_axis)).contiguous()
    return torch.cat(all_to_all(send, group).unbind(0), dim=concat_axis)
