"""Parallel layout of the port (counterpart of ``repro.parallel.layout``).

A ``Layout`` gives the degrees of the data (dp), Ulysses sequence (sp),
tensor (tp) and expert (ep) axes, and the (sp, tp) grid of processes it
runs on. Process rank ``r = i*tp + j`` sits at sp rank ``i`` and tp rank
``j`` of the grid: the position of device ``mesh.devices[0, i, j]`` in the
reference's ``make_mesh((1, sp, tp), ("data", "sp", "tp"))``. The model
group is tp-major (the paper's SP_TP order, §3.3.1): rank ``r`` owns head
sub-block ``g = j*sp + i`` in the base config, and in the shift config
``to_shift()`` (sp 1, tp = SP·TP on the same grid) its tp rank is that same
``g``, so it holds the same KV head slots in both configs.

Data and expert parallelism are not ported: dp and ep above 1 raise.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from .collectives import Group, Groups, joint_axis_index


@dataclass(frozen=True)
class Layout:
    dp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1
    # (sp, tp) of the process grid; None = (sp, tp). ``to_shift`` keeps it,
    # as the reference's shift layout keeps its mesh's axes
    grid: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        for axis in ("dp", "ep"):
            if getattr(self, axis) != 1:
                raise NotImplementedError(
                    f"{axis}={getattr(self, axis)}: the port's layouts run "
                    "dp = ep = 1 (per-row pools with dp, ROADMAP Queue 1 "
                    "item 3)")
        if self.sp < 1 or self.tp < 1:
            raise ValueError(f"sp={self.sp}, tp={self.tp}: degrees are >= 1")
        grid = self.grid or (self.sp, self.tp)
        object.__setattr__(self, "grid", tuple(grid))
        if grid != (self.sp, self.tp) and not (
                self.sp == 1 and self.tp == grid[0] * grid[1]):
            raise ValueError(
                f"sp={self.sp}, tp={self.tp} on a grid {grid}: a layout is "
                "its grid's base config or that grid's shift config")

    @property
    def G(self) -> int:
        """Model-group degree SP·TP."""
        return self.sp * self.tp

    @property
    def world(self) -> int:
        """Processes the layout runs on (one per model rank)."""
        return self.G

    def to_shift(self) -> "Layout":
        """The paper's shift configuration, Algorithm 1[1, SP×TP]: the SP
        degree folds into TP on the same grid, so the model group, and with
        it the KV pool's sharding, is unchanged."""
        return replace(self, sp=1, tp=self.G)

    # ------------------------------------------------------------ ranks
    def _coords(self, rank: int) -> Tuple[int, int]:
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a world of {self.world}")
        return divmod(rank, self.grid[1])

    def model_rank(self, rank: int) -> int:
        """Head sub-block of process ``rank``, ``j*sp + i`` on the grid;
        the same in the base and shift configs."""
        i, j = self._coords(rank)
        return joint_axis_index((j, i), (self.grid[1], self.grid[0]))

    def sp_rank(self, rank: int) -> int:
        """Position of ``rank`` along this layout's SP axis (0 without
        one)."""
        return self._coords(rank)[0] if self.sp > 1 else 0

    def tp_rank(self, rank: int) -> int:
        """Position of ``rank`` along this layout's TP axis: the grid's tp
        rank in the base config, the model rank in the shift config."""
        return self._coords(rank)[1] if self.sp > 1 else self.model_rank(rank)

    # ------------------------------------------------------------ identity
    @property
    def signature(self) -> Tuple[int, int, int, int]:
        """Degree tuple ``(dp, sp, tp, ep)``, the reference's reshard-relevant
        identity of a layout."""
        return (self.dp, self.sp, self.tp, self.ep)

    def describe(self) -> str:
        s = f"dp{self.dp}·sp{self.sp}·tp{self.tp}"
        return s + (f"·ep{self.ep}" if self.ep > 1 else "")


@dataclass(frozen=True, eq=False)
class Shard:
    """Where one model runs in this process: its layout, the process rank,
    and the layout's SP and TP groups for that rank (None for a group of
    one). The default is the trivial layout's single rank."""
    lay: Layout = field(default_factory=Layout)
    rank: int = 0
    sp_group: Optional[Group] = None
    tp_group: Optional[Group] = None

    @classmethod
    def of(cls, lay: Layout, groups: Optional[Groups]) -> "Shard":
        """This process's shard of ``lay``; ``groups`` (the grid's process
        groups) is required above world size 1."""
        if groups is None:
            if lay.world > 1:
                raise ValueError(f"{lay.describe()} runs on {lay.world} "
                                 "ranks: pass the grid's Groups")
            return cls(lay)
        return cls(lay, groups.rank, groups.sp_of(lay), groups.tp_of(lay))

    @property
    def sp_rank(self) -> int:
        return self.lay.sp_rank(self.rank)

    @property
    def tp_rank(self) -> int:
        return self.lay.tp_rank(self.rank)

    @property
    def model_rank(self) -> int:
        return self.lay.model_rank(self.rank)
