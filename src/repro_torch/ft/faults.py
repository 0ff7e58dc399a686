"""Deterministic fault injection for the serving engine (the port's copy
of ``repro.ft.faults``, pure Python).

A :class:`FaultPlan` schedules failures at the named seams the engine
already exposes, keyed by the engine's monotone step index:

- ``alloc``    — the next ``ensure``/``copy_on_write`` attempt of that step
                 behaves as a ``BlockOOM`` (exercises admission rollback,
                 LRU preemption, and requeue under pressure that the free
                 list alone would never produce on cue);
- ``forward``  — the forward pass of that step is poisoned: ``kind="nan"``
                 models NaN logits (the launch runs, its sampled tokens are
                 discarded), ``kind="raise"`` models a launch failure (the
                 forward never runs). Either way the step produces no
                 tokens and every batched request enters recompute-retry;
- ``route``    — the fault's dp ``row`` fails for that step: its active
                 requests are preempted back to the queue (recompute) with
                 step-counted backoff;
- ``snapshot`` — the snapshot captured at that step is corrupted in place
                 (``validate_snapshot`` rejects it at recovery time, so
                 ``recover()`` must fall back to an older retained one);
- ``crash``    — consumed by the *harness* (serve loop / chaos bench /
                 tests), not the engine: drop the live engine at that step
                 and recover a fresh one from the retained snapshots.

Lookups are PURE (``at`` never consumes the fault), so a run restored from
a snapshot taken before step ``s`` re-injects the step-``s`` fault exactly
like the original run did — replays are bit-identical by construction.
``random_plan`` derives a storm from a seed through ``random.Random``, so
a (seed, rates) pair names one reproducible fault schedule.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.schema import SEAMS


class SnapshotError(Exception):
    """A snapshot dict is malformed (truncated, corrupted, or from an
    incompatible engine). Raised by validation BEFORE any engine state is
    mutated, so a failed ``restore``/``recover`` leaves the engine as it
    was."""


class InjectedFault(Exception):
    """Raised in place of the forward launch for ``kind="raise"`` forward
    faults (the modeled hardware/launch failure)."""


@dataclass(frozen=True)
class Fault:
    step: int                 # engine step index the fault fires at
    seam: str                 # one of repro_torch.obs.schema.SEAMS
    kind: str = ""            # seam-specific: forward -> "nan" | "raise";
    #                           others default to the seam's only mode
    row: int = 0              # dp row, for route faults

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown fault seam {self.seam!r} "
                             f"(schema: {SEAMS})")
        if self.seam == "forward" and self.kind not in ("nan", "raise"):
            raise ValueError(
                f"forward fault kind must be 'nan' or 'raise', "
                f"got {self.kind!r}")


@dataclass
class FaultPlan:
    """A deterministic schedule of :class:`Fault`\\ s, at most one per
    (step, seam). ``at`` is a pure lookup — restoring a snapshot and
    replaying past the same step re-fires the same fault — and ``fired``
    is an append-only log of every lookup that hit (a replay may therefore
    log one fault more than once; the log is diagnostics, not state)."""
    faults: List[Fault] = field(default_factory=list)
    seed: Optional[int] = None        # provenance only (set by random_plan)

    def __post_init__(self):
        self._by_key: Dict[Tuple[int, str], Fault] = {}
        for f in self.faults:
            key = (f.step, f.seam)
            if key in self._by_key:
                raise ValueError(f"duplicate fault at step {f.step} "
                                 f"seam {f.seam!r}")
            self._by_key[key] = f
        self.fired: List[Fault] = []

    def __len__(self) -> int:
        return len(self.faults)

    def at(self, step: int, seam: str) -> Optional[Fault]:
        """The fault scheduled at (step, seam), or None. Pure — replays
        observe the identical schedule."""
        f = self._by_key.get((step, seam))
        if f is not None:
            self.fired.append(f)
        return f

    def max_step(self) -> int:
        """Last scheduled step (-1 when empty) — harness loops run at
        least this far so no scheduled fault is silently skipped."""
        return max((f.step for f in self.faults), default=-1)


def random_plan(seed: int, n_steps: int, *, p_alloc: float = 0.0,
                p_forward: float = 0.0, p_route: float = 0.0,
                p_snapshot: float = 0.0, dp: int = 1) -> FaultPlan:
    """Seeded fault storm: at every step < ``n_steps`` each seam fires
    independently with its probability. Same (seed, args) -> same plan,
    bit-for-bit; the plan is data, so it can also be logged or shipped to
    a simulator for an engine-vs-sim A/B under the identical storm."""
    rng = random.Random(seed)
    faults: List[Fault] = []
    for step in range(n_steps):
        # one rng draw per (step, seam) in a fixed order, so adding a new
        # seam probability later cannot reshuffle existing schedules
        r_alloc, r_fwd, r_route, r_snap = (rng.random() for _ in range(4))
        kind_fwd = rng.choice(("nan", "raise"))
        row = rng.randrange(dp)
        if r_alloc < p_alloc:
            faults.append(Fault(step, "alloc"))
        if r_fwd < p_forward:
            faults.append(Fault(step, "forward", kind=kind_fwd))
        if r_route < p_route:
            faults.append(Fault(step, "route", row=row))
        if r_snap < p_snapshot:
            faults.append(Fault(step, "snapshot"))
    plan = FaultPlan(faults)
    plan.seed = seed
    return plan


def corrupt_snapshot(snap: dict, step: int) -> dict:
    """Deterministically corrupt a snapshot in place (the ``snapshot``
    seam's effect): drop a required key and truncate the request list, the
    two malformations ``validate_snapshot`` must catch at recovery time.
    The step index picks which required key goes missing, so different
    scheduled corruptions exercise different validation branches."""
    keys = [k for k in ("lens", "cache", "step_count") if k in snap]
    if keys:
        snap.pop(keys[step % len(keys)])
    if snap.get("requests"):
        snap["requests"] = [dict(rd) for rd in snap["requests"]]
        snap["requests"][-1].pop("prompt", None)
    snap["corrupted"] = True          # marker for tests/diagnostics only
    return snap
