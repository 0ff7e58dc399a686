"""Parallel layout of the port (counterpart of ``repro.parallel.layout``).

A ``Layout`` gives the degrees of the data (dp), Ulysses sequence (sp),
tensor (tp) and expert (ep) axes, and the (sp, tp) grid of one model
group. The world is ``dp`` such grids, one per data-parallel row: process
rank ``r = d*(sp*tp) + i*tp + j`` sits in dp row ``d`` at sp rank ``i``
and tp rank ``j`` of its row's grid, the position of device
``mesh.devices[d, i, j]`` in the reference's ``make_mesh((dp, sp, tp),
("data", "sp", "tp"))``. Every row holds the same shards: the reference
replicates the parameters over ``"data"``. The model group is tp-major (the paper's SP_TP order, §3.3.1): rank ``r`` owns head
sub-block ``g = j*sp + i`` in the base config, and in the shift config
``to_shift()`` (sp 1, tp = SP·TP on the same grid) its tp rank is that same
``g``, so it holds the same KV head slots in both configs.

The reference names its mesh axes; ``axis_sizes``, ``dp_axes``,
``sp_axes``, ``tp_axes`` and ``model_axes`` give the port's layouts the
names and sizes of ``Layout.from_mesh(mesh, dp=("data",), sp=("sp",),
tp=("tp",))`` on a ``(dp, sp, tp)`` mesh (and of its ``to_shift()``), and
``axis_coords`` a rank's index along each. Expert parallelism reads them:
the ``ep`` degree stays 1, as the reference's ``ep_axes`` (read by nothing
there) stay empty, and a MoE layer's EP group is
``repro_torch.models.moe.ep_group`` of the layout, which for a pod-scale
config may take the ``"data"`` axis and so span dp rows.

The sequence-sharded caches (MLA's latent) live on ``cache_sp_axes``, the
grid's ``"sp"`` (``cache_sp`` ranks): fixed by the grid and kept by
``to_shift``, as the reference's ``Layout.from_mesh`` fixes them and its
``to_shift`` keeps them, so that the latent cache is sharded the same way
in the base and the shift config.
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
        if self.ep != 1:
            raise ValueError(
                f"ep={self.ep}: the layout's ep degree stays 1; a MoE "
                "layer's expert parallelism follows models.moe.ep_group over "
                "the layout's named axes (dp rows included for a pod-scale "
                "config)")
        if self.dp < 1 or self.sp < 1 or self.tp < 1:
            raise ValueError(f"dp={self.dp}, sp={self.sp}, tp={self.tp}: "
                             "degrees are >= 1")
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
        """Processes the layout runs on: one per model rank of each dp
        row."""
        return self.dp * self.G

    def to_shift(self) -> "Layout":
        """The paper's shift configuration, Algorithm 1[1, SP×TP]: the SP
        degree folds into TP on the same grid, so the model group, and with
        it the KV pool's sharding, is unchanged; dp is kept, as the
        reference's ``to_shift`` keeps its ``dp_axes``."""
        return replace(self, sp=1, tp=self.G)

    # ------------------------------------------------------------ axes
    @property
    def is_shift(self) -> bool:
        """True for a grid's shift config (its SP axis folded into TP)."""
        return self.grid != (self.sp, self.tp)

    @property
    def axis_sizes(self) -> dict:
        """Size of every named axis: ``"data"`` (dp), and the grid's
        ``"sp"`` and ``"tp"``, in the base and the shift config alike."""
        return {"data": self.dp, "sp": self.grid[0], "tp": self.grid[1]}

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return ("data",)

    @property
    def sp_axes(self) -> Tuple[str, ...]:
        return () if self.is_shift else ("sp",)

    @property
    def tp_axes(self) -> Tuple[str, ...]:
        """The TP axes: the grid's ``"tp"``, and in the shift config its
        ``"sp"`` appended (tp-major, the reference's ``to_shift``)."""
        return ("tp", "sp") if self.is_shift else ("tp",)

    @property
    def model_axes(self) -> Tuple[str, ...]:
        """The model group's axes, tp-major, as the reference's."""
        return self.tp_axes + self.sp_axes

    @property
    def cache_sp_axes(self) -> Tuple[str, ...]:
        """The axes a sequence-sharded cache lives on: the grid's
        ``"sp"``, in the base and the shift config alike."""
        return ("sp",)

    @property
    def cache_sp(self) -> int:
        """The number of sequence chunks of such a cache: the grid's sp."""
        return self.grid[0]

    def axis_coords(self, rank: int) -> dict:
        """Index of ``rank`` along every named axis."""
        i, j = self._coords(rank)
        return {"data": self.dp_rank(rank), "sp": i, "tp": j}

    def axes_index(self, axes, rank: int) -> int:
        """Joint index of ``rank`` over ``axes``, major to minor in listed
        order (the reference's ``joint_axis_index``)."""
        at, sizes = self.axis_coords(rank), self.axis_sizes
        return joint_axis_index([at[a] for a in axes],
                                [sizes[a] for a in axes])

    # ------------------------------------------------------------ ranks
    def _check_rank(self, rank: int):
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a world of {self.world}")

    def _coords(self, rank: int) -> Tuple[int, int]:
        """(sp rank, tp rank) of ``rank`` on its row's grid."""
        self._check_rank(rank)
        return divmod(rank % self.G, self.grid[1])

    def dp_rank(self, rank: int) -> int:
        """The data-parallel row of process ``rank``."""
        self._check_rank(rank)
        return rank // self.G

    def model_rank(self, rank: int) -> int:
        """Head sub-block of process ``rank``, ``j*sp + i`` on its row's
        grid; the same in the base and shift configs and in every row."""
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
    the layout's SP and TP groups for that rank, and its DP group, the
    ``dp`` ranks at the same grid position of every row (each None for a
    group of one). The default is the trivial layout's single rank."""
    lay: Layout = field(default_factory=Layout)
    rank: int = 0
    sp_group: Optional[Group] = None
    tp_group: Optional[Group] = None
    dp_group: Optional[Group] = None
    groups: Optional[Groups] = None     # the grid's groups (None: one rank)

    @classmethod
    def of(cls, lay: Layout, groups: Optional[Groups]) -> "Shard":
        """This process's shard of ``lay``; ``groups`` (the grid's process
        groups) is required above world size 1."""
        if groups is None:
            if lay.world > 1:
                raise ValueError(f"{lay.describe()} runs on {lay.world} "
                                 "ranks: pass the grid's Groups")
            return cls(lay)
        return cls(lay, groups.rank, groups.sp_of(lay), groups.tp_of(lay),
                   groups.dp_of(lay), groups)

    def axes_group(self, axes) -> Optional[Group]:
        """The process group over the named ``axes`` (``Groups.axes_group``:
        within this rank's dp row unless ``"data"`` is one of them); None
        for axes of one rank."""
        if self.groups is None:
            return None
        return self.groups.axes_group(axes)

    @property
    def dp_rank(self) -> int:
        return self.lay.dp_rank(self.rank)

    @property
    def sp_rank(self) -> int:
        return self.lay.sp_rank(self.rank)

    @property
    def tp_rank(self) -> int:
        return self.lay.tp_rank(self.rank)

    @property
    def model_rank(self) -> int:
        return self.lay.model_rank(self.rank)


# ---------------------------------------------------------------------------
# Layout diffing: what changes when a deployment reshards old -> new.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayoutDelta:
    """Typed diff between two layouts' signatures.

    ``kind`` classifies the dp-row transition the paged pool must survive:

    * ``"same"``    — identical signatures; reshard is a no-op.
    * ``"grow"``    — fewer dp rows (replica merge -> wider model group):
                      low-traffic latency mode.
    * ``"shrink"``  — more dp rows (replica split): high-traffic
                      throughput mode.
    * ``"reshape"`` — same dp but a different sp/tp/ep factorisation.
    """

    old: Tuple[int, int, int, int]
    new: Tuple[int, int, int, int]
    kind: str

    @property
    def dp_change(self) -> bool:
        return self.old[0] != self.new[0]


def layout_delta(old: Layout, new: Layout) -> LayoutDelta:
    a, b = old.signature, new.signature
    if a == b:
        kind = "same"
    elif b[0] < a[0]:
        kind = "grow"
    elif b[0] > a[0]:
        kind = "shrink"
    else:
        kind = "reshape"
    return LayoutDelta(old=a, new=b, kind=kind)
