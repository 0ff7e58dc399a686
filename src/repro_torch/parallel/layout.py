"""Parallel layout of the port. One card runs only the trivial layout
(dp = sp = tp = 1): the base (SP×TP) and shift (pure TP) configs then run
the same program. Any axis above 1 raises until the collectives are
ported."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Layout:
    dp: int = 1
    sp: int = 1
    tp: int = 1

    def __post_init__(self):
        for axis in ("dp", "sp", "tp"):
            if getattr(self, axis) != 1:
                raise NotImplementedError(
                    f"{axis}={getattr(self, axis)}: the port runs only the "
                    "trivial layout dp = sp = tp = 1 (no collectives yet)")

    @property
    def G(self) -> int:
        """Model-group degree SP·TP."""
        return self.sp * self.tp
