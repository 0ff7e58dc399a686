"""Parallel layout of the port. One card runs only the trivial layout
(dp = sp = tp = ep = 1): the base (SP×TP) and shift (pure TP) configs then
run the same program. Any axis above 1 raises until the collectives are
ported."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Layout:
    dp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    def __post_init__(self):
        for axis in ("dp", "sp", "tp", "ep"):
            if getattr(self, axis) != 1:
                raise NotImplementedError(
                    f"{axis}={getattr(self, axis)}: the port runs only the "
                    "trivial layout dp = sp = tp = ep = 1 (no collectives "
                    "yet)")

    @property
    def G(self) -> int:
        """Model-group degree SP·TP."""
        return self.sp * self.tp

    @property
    def signature(self) -> Tuple[int, int, int, int]:
        """Degree tuple ``(dp, sp, tp, ep)``, the reference's reshard-relevant
        identity of a layout."""
        return (self.dp, self.sp, self.tp, self.ep)

    def describe(self) -> str:
        s = f"dp{self.dp}·sp{self.sp}·tp{self.tp}"
        return s + (f"·ep{self.ep}" if self.ep > 1 else "")
