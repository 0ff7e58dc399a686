"""Straggler detection: per-step wall-time watchdog.

On a real fleet this feeds the control plane (demote slow hosts, re-route
DP traffic, trigger elastic reshard). Here it is the local building block:
flag steps slower than ``factor``× the rolling median."""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class StragglerWatchdog:
    window: int = 16
    factor: float = 2.5
    _hist: deque = field(default_factory=deque)
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        hist = sorted(self._hist)
        slow = bool(hist) and dt > self.factor * hist[len(hist) // 2]
        self._hist.append(dt)
        if len(self._hist) > self.window:
            self._hist.popleft()
        if slow:
            self.flagged += 1
        return slow
