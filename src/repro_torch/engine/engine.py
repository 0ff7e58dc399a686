"""Shift-parallelism serving engine (counterpart of
``repro.engine.engine.ShiftEngine``).

Two iterations, as in the reference. The **mixed** one (the default with
the paged cache) packs up to ``prefill_chunk`` prompt tokens per
prefilling row plus every ready decode row into ONE forward pass. The
**serialized** one (``mixed=False``) runs a chunked-prefill step over the
full ``max_slots`` batch while any row still swallows its prompt, and a
decode step otherwise. The shift policy picks the config of each step from
its batched token count (paper Algorithm 2), and that config's entry of
the ``Deployment``'s step table runs the step: on the card a CUDA graph
captured once per bucketed shape and replayed, on the CPU (and above world
size 1) the eager step. On the trivial layout both configs share one
program, but the engine still makes and counts the choice, as the
reference does. Given a ``shift`` model (the base model's layout
``to_shift()``), the configs are two programs over one paged pool: the
shift model adopts the base model's pool.

Above world size 1 the engine is SPMD: every rank runs the same engine on
the same requests, one process per rank, and the greedy token is
all-gathered over TP and then over DP, so every rank sees the whole
batch's tokens and takes the same routing, admission and scheduling
decisions. Above a model group of one (sp·tp > 1) the engine runs the
mixed paged iteration only; with dp rows alone it also runs the
serialized one on the paged pool. The dense cache runs only the trivial
layout.

Data parallelism pages per row, as in the reference: the slots partition
into ``dp`` contiguous ranges, each row owns a private block pool of
``num_blocks`` blocks and its own prefix index, and each rank holds only
its row's pool and steps only its row's segment of the batch. A queued
request is routed once to the row that minimises its routed-but-unadmitted
demand less its allocatable blocks (ties to the lowest row) and keeps that
row across preemptions; admission is FCFS within a row, and block
exhaustion preempts only requests of the same row, so pressure in one row
never preempts or evicts another row's work. With ``max_slots`` not
divisible by dp a forced ``paged=True`` raises; the reference's automatic
fallback to the dense cache raises ``NotImplementedError`` here, since the
dense cache on a layout is not ported.

KV lives in one of two caches. The paged pool (``paged``, the default
for configs whose layers all page)
maps sequences to fixed-size blocks through a block table
(``repro_torch.cache``): admission holds a request in the queue until its
prompt fits in the free blocks, and block exhaustion preempts the
least-recently scheduled request back to the queue (recompute), which
bounds memory while guaranteeing progress. The dense contiguous cache
(``paged=False``, and the automatic fallback for mamba2, whose SSD layers
keep recurrent state per slot) gives each slot a ``[s_max]`` row; it
serves only the serialized iteration and admits FCFS by free slot.

As in the reference, a serialized step always runs all ``max_slots``
rows, and nothing resets a slot's SSD state on admission: the dummy rows
of slots outside the step (zero tokens) and the zero padding after a
short last chunk advance that state. Streams of an SSD model therefore
depend on what else is in flight; the port copies this behaviour so that
its streams equal the reference's.

With ``EngineConfig(prefix=PrefixConfig(enabled=True))`` the paged pool
gains automatic prefix reuse, as in the reference: prefill indexes every
full block of token ids by chained hash (``repro_torch.cache.PrefixIndex``)
as it completes, and admission maps the longest indexed prefix of a new
prompt into the request's block table, so prefill starts at the first
uncached token and the policy prices only the uncached work. Cached blocks
are pinned by the index's own reference; a write into a shared block goes
through copy-on-write (the manager remaps the block, and the engine copies
it in the pool, in place, before the forward pass). A request whose next
prompt block another request is writing waits in the queue for that commit
(the in-flight registry).

With ``EngineConfig(spec=SpecConfig(k=K))`` the mixed paged iteration
verifies up to K draft tokens per decode row in the same forward pass
(``repro_torch.spec.SuffixDrafter``: n-grams of the request's own tokens):
a row becomes ``[last token] + draft``, the step returns its last
``n_last = pow2(1 + max draft)`` columns' greedy tokens, the longest
matching prefix is accepted and the rejected tail's blocks are unmapped
(``truncate``). Streams equal those without speculation. The serialized
iteration decodes one token per pass: there speculation is off, with its
reason in ``spec_disabled_reason``.

Every step leaves one audit record and the engine's counters, gauges,
histograms and lifecycle events in ``self.obs`` (``repro_torch.obs``,
``EngineConfig(obs=ObsConfig(...))``), at the reference's points and with
the reference's clock calls, so that under one injected clock (``now=``)
the dump equals the reference's; ``step_log``, ``config_counts`` and the
other views read it. With ``ObsConfig(enabled=False)`` a ``NullObs``
records nothing and the views read empty. On the card a serialized prefill
step reads nothing back, so the step waits for the device before its
duration is taken: otherwise the next step would book its device time.

Every request ends with one typed ``FinishReason``: OK, or TIMEOUT (its
``deadline`` passed, checked at the start of every step), CANCELLED
(``cancel``), SHED (the bounded queue's shed policy, or ``drain``) or
FAILED (``quarantine_after`` failed steps). A straggler watchdog flags
steps slower than ``straggler_factor`` times the rolling median.

Faults are injected from a deterministic ``FaultPlan``
(``repro_torch.ft``) at the reference's seams: an ``alloc`` fault fails
the step's first block allocation like an OOM (admission rolls back, a
reserve preempts), a ``forward`` fault poisons the step's tokens
(``"nan"``: the step runs, its tokens are dropped) or skips the step
(``"raise"``), a ``route`` fault fails one dp row (its requests are
preempted for recompute), and a ``snapshot`` fault corrupts a capture.
Every request of a failed step backs off ``retry_backoff`` steps per
failure, and ends FAILED after ``quarantine_after`` failures. Above world
size 1 every rank holds the same plan and consults it at the same step,
so a skipped step is skipped on every rank and the collectives stay
matched.

``snapshot()`` captures the engine's state: the cache (this rank's shard,
copied to the host, with the rank beside it), the slot lengths, the step
index, the layout's signature, the observability state, every unfinished
request and, on the paged pool, the block tables, allocators and prefix
indexes. ``restore()`` validates first (a snapshot that does not fit
leaves the engine untouched) and then copies the cache back in place, so
that the captured CUDA graphs keep their addresses; ``recover()`` restores
the newest valid snapshot of the ``auto_snapshot_every`` ring. Not in
this slice: reshard.
"""
from __future__ import annotations

import inspect
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.cache import (PagedKVCache, PrefixIndex, blocks_for_tokens,
                               pow2_bucket)
from repro_torch.core.policy import DEFAULT_SHIFT_THRESHOLD, ThresholdPolicy
from repro_torch.ft import (FaultPlan, SnapshotError, StragglerWatchdog,
                            corrupt_snapshot)
from repro_torch.models.model import Model
from repro_torch.obs import NullObs, Observability
from repro_torch.spec import SpecConfig, SuffixDrafter
from .api import (BlockLedger, EngineStats, FaultConfig, ObsConfig,
                  PrefixConfig, PrefixStats)
from .deployment import Deployment
from .request import FinishReason, Request

_EMPTY_STEP = {"prefill_tokens": 0, "decode_tokens": 0, "ready_decodes": 0,
               "attn_ctx_tokens": 0}


class EngineConfig:
    def __init__(self, max_slots: int = 8, s_max: int = 256,
                 prefill_chunk: int = 64,
                 threshold: int = DEFAULT_SHIFT_THRESHOLD,
                 eos_id: int = -1, block_size: int = 16,
                 # physical blocks incl. the null block; 0 = auto-size so
                 # max_slots x s_max fits
                 num_blocks: int = 0,
                 # None = auto: paged when every layer pages, and mixed
                 # when paged
                 paged: Optional[bool] = None,
                 mixed: Optional[bool] = None,
                 # nested groups, as in the reference (None = defaults)
                 prefix: Optional[PrefixConfig] = None,
                 fault: Optional[FaultConfig] = None,
                 obs: Optional[ObsConfig] = None,
                 # speculative decoding: k == 0 disables
                 spec: Optional[SpecConfig] = None):
        self.max_slots = max_slots
        self.s_max = s_max
        self.prefill_chunk = prefill_chunk
        self.threshold = threshold
        self.eos_id = eos_id
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.paged = paged
        self.mixed = mixed
        if isinstance(obs, bool):
            raise TypeError("obs=bool was removed with the flat-kwarg "
                            "shim — pass obs=ObsConfig(enabled=...)")
        self.prefix = prefix if prefix is not None else PrefixConfig()
        self.fault = fault if fault is not None else FaultConfig()
        self.obs = obs if obs is not None else ObsConfig()
        self.spec = spec if spec is not None else SpecConfig()

    # flat read properties, as the reference's
    @property
    def spec_k(self) -> int:
        return self.spec.k

    @property
    def prefix_cache(self) -> bool:
        return self.prefix.enabled

    @property
    def max_queue(self) -> int:
        return self.fault.max_queue

    @property
    def shed_policy(self) -> str:
        return self.fault.shed_policy

    @property
    def deadline_s(self) -> Optional[float]:
        return self.fault.deadline_s

    @property
    def quarantine_after(self) -> int:
        return self.fault.quarantine_after

    @property
    def retry_backoff(self) -> int:
        return self.fault.retry_backoff

    @property
    def auto_snapshot_every(self) -> int:
        return self.fault.auto_snapshot_every

    @property
    def snapshot_keep(self) -> int:
        return self.fault.snapshot_keep

    @property
    def straggler_factor(self) -> float:
        return self.fault.straggler_factor


class ShiftEngine:
    def __init__(self, model: Model, cfg: Optional[EngineConfig] = None,
                 shift: Optional[Model] = None, policy=None,
                 now=time.monotonic, faults: Optional[FaultPlan] = None):
        cfg = cfg or EngineConfig()
        if cfg.shed_policy not in ("reject-newest", "evict-longest-queued"):
            raise ValueError(f"unknown shed_policy {cfg.shed_policy!r}")
        self.model = model
        self.mcfg = model.cfg
        self.cfg = cfg
        self.policy = policy or ThresholdPolicy(cfg.threshold)
        self.now = now
        # which of the per-iteration context facts the policy's use_base
        # accepts, found once: a two-argument policy gets none, a partial
        # signature exactly what it declares (a per-call try/except
        # TypeError would swallow a TypeError raised inside the policy)
        facts = ("ctx_tokens", "n_rows", "ctx_max", "spec_tokens")
        try:
            params = inspect.signature(self.policy.use_base).parameters
            if any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in params.values()):
                self._policy_ctx_kwargs = facts
            else:
                self._policy_ctx_kwargs = tuple(k for k in facts
                                                if k in params)
        except (TypeError, ValueError):      # callables without a signature
            self._policy_ctx_kwargs = ()
        # paging needs every layer to page (an SSD layer keeps recurrent
        # state per sequence) and the slots to split into the dp rows. Auto
        # falls back to the dense cache, a forced paged=True raises; the
        # reason is kept, as the reference keeps it, because the dense
        # cache also rules out the mixed iteration and the prefix cache
        lay = model.lay
        dp = lay.dp
        reason = None
        if not model.supports_paged:
            reason = (f"architecture {self.mcfg.name} has non-pageable layer "
                      "kinds (MLA latents / ring buffers / recurrent state "
                      "keep the contiguous cache)")
        elif cfg.max_slots % dp:
            reason = (f"max_slots={cfg.max_slots} not divisible by dp={dp}: "
                      "slots partition into dp rows")
        if cfg.paged and reason is not None:
            raise ValueError(f"config {self.mcfg.name} cannot use a paged KV "
                             f"cache: {reason}")
        self.paged = reason is None if cfg.paged is None else cfg.paged
        if not self.paged and reason is None:
            reason = "paged=False in EngineConfig"
        if not self.paged and lay.world > 1:
            raise NotImplementedError(
                f"{lay.describe()}: the dense cache runs only the trivial "
                f"layout (ROADMAP Queue 1 item 2), and paging is off: "
                f"{reason}")
        self.paged_disabled_reason = None if self.paged else reason
        self.mixed = self.paged if cfg.mixed is None else cfg.mixed
        if self.mixed and not self.paged:
            raise ValueError(
                "mixed-batch stepping requires the paged KV cache (ragged "
                "rows scatter through the block table's null block)")
        if cfg.prefix.enabled and not self.paged:
            raise ValueError(
                "prefix caching requires the paged KV cache (cached blocks "
                "are shared through ref-counted block tables)")
        if lay.G > 1 and not self.mixed:
            raise NotImplementedError(
                f"{lay.describe()}: above a model group of one the engine "
                "runs the mixed paged iteration only (ROADMAP Queue 1 item "
                "2)")
        # speculation rides the mixed paged iteration (verify rows are
        # ragged 1+k rows through the paged attention); elsewhere it is
        # off, and says why
        self.spec = cfg.spec
        self.spec_disabled_reason = None
        if self.spec.k and not (self.paged and self.mixed):
            self.spec_disabled_reason = (
                "speculative decoding requires the paged mixed-batch path "
                f"(paged={self.paged}, mixed={self.mixed})")
        self._spec_on = bool(self.spec.k) and self.spec_disabled_reason is None
        self.drafter = SuffixDrafter(self.spec)
        self.prefix_rows: Optional[List[PrefixIndex]] = None
        self.slots_per_row = cfg.max_slots // dp if self.paged \
            else cfg.max_slots
        if self.paged:
            nmax = blocks_for_tokens(cfg.s_max, cfg.block_size)
            # cfg.num_blocks is per dp row: each row owns a private pool
            # (and null block), and this rank holds its own row's
            row_blocks = cfg.num_blocks or self.slots_per_row * nmax + 1
            self.kv = PagedKVCache(row_blocks, cfg.block_size, cfg.max_slots,
                                   nmax, dp=dp)
            # the cache this engine steps, kept for its snapshots (a later
            # engine on the same model initialises another)
            self._cache = model.init_paged_cache(row_blocks, cfg.block_size)
            if shift is not None:
                shift.adopt_paged_cache(model)
            # persistent host mirror of the block tables; only rows the
            # PagedKVCache marks dirty are re-copied
            self._bt_host = np.zeros((cfg.max_slots, nmax), np.int32)
            if cfg.prefix.enabled:
                # one index per row: blocks never cross rows, so neither do
                # cached prefixes
                self.prefix_rows = [
                    PrefixIndex(cfg.block_size, self.kv.allocators[r])
                    for r in range(dp)]
                self.kv.prefix_indices = list(self.prefix_rows)
            # in-flight prefix registry per row: chain hash of every full
            # prompt block an admitted request will write -> its rid
            self._inflight: List[Dict[int, int]] = [{} for _ in range(dp)]
            # pending (row, src, dst) row-local block copies from
            # copy-on-write; each rank applies its own row's in one gather
            # and one scatter before the next forward pass
            self._step_copies: List[tuple] = []
        else:
            self.kv = None
            self._cache = model.init_cache(cfg.max_slots, cfg.s_max)
        # per-slot cache length: positions already written
        self.lens = np.zeros((cfg.max_slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * cfg.max_slots
        # every unfinished request, admitted or not, in arrival order
        self.queue: List[Request] = []
        self.step_count = 0
        self.preemptions = 0
        # every submitted request by rid, so that stream(rid) and
        # request(rid) resolve after it ends
        self._requests: Dict[int, Request] = {}
        # replica id under a cluster router (None standalone), stamped on
        # every record and event through the obs surface
        self.replica: Optional[int] = None
        # fault tolerance: the optional fault schedule, the straggler
        # watchdog and the retained snapshots (newest last)
        self.faults = faults
        self.watchdog = StragglerWatchdog(factor=cfg.straggler_factor)
        self._snap_ring: List[dict] = []
        self._alloc_fault_armed = False
        self._step_fail_flag = False
        self.draining = False           # drain(): no fresh admissions
        # the one observability surface: metrics registry, lifecycle event
        # log and the rolling per-step audit records the views read
        self.obs = (Observability("engine", window=cfg.obs.window, now=now,
                                  event_cap=cfg.obs.event_cap)
                    if cfg.obs.enabled else NullObs(now=now))
        self._attach_prefix_observers()
        # the composition and shift audit of the step in flight, stashed by
        # _log_step and _choose and folded into one record in step()
        self._step_stats: Optional[dict] = None
        self._step_audit: Optional[dict] = None
        # the base and shift views and their step tables, built over the
        # caches initialised above
        self.deploy = Deployment.build(model, shift or model,
                                       mixed=self.mixed, paged=self.paged)

    # ------------------------------------------- deployment (read-through)
    @property
    def base(self) -> Model:
        return self.deploy.base

    @property
    def shift(self) -> Model:
        return self.deploy.shift

    @property
    def dp(self) -> int:
        return self.deploy.dp

    @property
    def prefix(self) -> Optional[PrefixIndex]:
        """Row 0's prefix index, the only one at dp 1; under dp > 1 use
        ``prefix_rows``."""
        return self.prefix_rows[0] if self.prefix_rows else None

    # ---------------------------------------------------- observability
    def _attach_prefix_observers(self):
        for r, idx in enumerate(self.prefix_rows or []):
            idx.on_evict = self._make_evict_observer(r)

    def _make_evict_observer(self, row: int):
        def observer(n_blocks: int):
            self.obs.inc("prefix_evictions_total", n_blocks)
            self.obs.emit("prefix_evict", step=self.step_count,
                          blocks=n_blocks, row=row)
        return observer

    # views of the one rolling store of per-step records (each carries its
    # step index and duration, so any two views join on "step") and of the
    # registry's totals; under NullObs they read empty
    @property
    def step_log(self) -> List[dict]:
        return list(self.obs.step_records)

    @property
    def step_times(self) -> List[float]:
        return [r["dur_s"] for r in self.obs.step_records]

    @property
    def config_trace(self) -> List[str]:
        return [r["config"] for r in self.obs.step_records
                if r["config"] is not None]

    @property
    def config_counts(self) -> dict:
        reg = self.obs.registry
        return {"base": int(reg.counter_value("steps_total", config="base")),
                "shift": int(reg.counter_value("steps_total",
                                               config="shift"))}

    @property
    def total_step_time(self) -> float:
        return self.obs.registry.histogram_sum("step_seconds")

    @property
    def trace_window(self) -> int:
        return self.obs.window

    @trace_window.setter
    def trace_window(self, window: int):
        self.obs.window = window
        if len(self.obs.step_records) > window:
            del self.obs.step_records[:len(self.obs.step_records) - window]

    # ---------------------------------------------------------------- admin
    def add_request(self, req: Request):
        """Queue ``req``; raises if it can never be served (its worst case
        must fit in one row's pool). The engine's default deadline applies
        to a request without one; a draining engine sheds it at once, and
        the bounded queue may shed it or an older waiter."""
        worst = len(req.prompt) + req.max_new_tokens
        if worst > self.cfg.s_max:
            raise ValueError(f"request {req.rid} exceeds s_max={self.cfg.s_max}")
        need = blocks_for_tokens(worst, self.cfg.block_size)
        if self.paged and need > self.kv.num_blocks_per_row - 1:
            raise ValueError(
                f"request {req.rid} can never fit: needs {need} blocks, each "
                f"dp row's pool has {self.kv.num_blocks_per_row - 1}")
        if req.deadline is None and self.cfg.deadline_s is not None:
            req.deadline = req.arrival + self.cfg.deadline_s
        self.queue.append(req)
        self._requests[req.rid] = req
        self.obs.inc("requests_arrived_total")
        self.obs.emit("queued", step=self.step_count, rid=req.rid,
                      prompt_tokens=len(req.prompt),
                      max_new_tokens=req.max_new_tokens,
                      arrival=req.arrival)
        if self.draining:
            self._retire(req, FinishReason.SHED)
            return
        self._enforce_queue_bound(req)

    def submit(self, req: Request) -> int:
        """``add_request``; returns the rid."""
        self.add_request(req)
        return req.rid

    def stream(self, rid: int) -> List[int]:
        """Tokens generated so far for ``rid`` (empty for an unknown
        rid)."""
        req = self._requests.get(rid)
        return list(req.generated) if req is not None else []

    def request(self, rid: int) -> Optional[Request]:
        return self._requests.get(rid)

    def _enforce_queue_bound(self, newest: Request):
        """Bounded admission queue: while more than ``max_queue`` requests
        wait for a slot, the shed policy picks who ends SHED (the newest,
        or the longest queued)."""
        if not self.cfg.max_queue:
            return
        waiting = [q for q in self.queue if q.slot is None]
        while len(waiting) > self.cfg.max_queue:
            if self.cfg.shed_policy == "reject-newest":
                victim = newest
            else:                      # evict-longest-queued
                victim = min(waiting, key=lambda q: (q.arrival, q.rid))
            self._retire(victim, FinishReason.SHED)
            waiting.remove(victim)
            if victim is newest:
                break

    @property
    def active(self) -> List[Request]:
        return [r for r in self.slot_req if r is not None]

    # ------------------------------------------------------ typed outcomes
    _REASON_EVENT = {FinishReason.TIMEOUT: "timeout",
                     FinishReason.CANCELLED: "cancelled",
                     FinishReason.SHED: "shed",
                     FinishReason.FAILED: "quarantined"}
    _REASON_COUNTER = {FinishReason.TIMEOUT: "requests_timeout_total",
                       FinishReason.CANCELLED: "requests_cancelled_total",
                       FinishReason.SHED: "requests_shed_total",
                       FinishReason.FAILED: "requests_failed_total"}

    def _release_slot(self, req: Request):
        """Return ``req``'s slot and blocks (shared ones decremented, the
        index's pins kept) without touching its tokens."""
        self._unregister_inflight(req)
        if self.paged:
            self.kv.free_seq(req.slot)
        self.slot_req[req.slot] = None
        self.lens[req.slot] = 0
        req.slot = None

    def _retire(self, req: Request, reason: FinishReason,
                t: Optional[float] = None):
        """End ``req`` with a reason other than OK (OK goes through
        ``_finish_token``)."""
        assert reason is not FinishReason.OK
        t = self.now() if t is None else t
        if req.slot is not None:
            self._release_slot(req)
        self.queue = [q for q in self.queue if q.rid != req.rid]
        req.finish_time = t
        req.finish_reason = reason
        self.drafter.drop(req.rid)
        self.obs.inc(self._REASON_COUNTER[reason])
        self.obs.emit(self._REASON_EVENT[reason], step=self.step_count,
                      ts=t, rid=req.rid, row=req.row,
                      n_out=len(req.generated), fail_count=req.fail_count)

    def cancel(self, rid: int) -> bool:
        """End a queued or running request CANCELLED, freeing its slot and
        blocks; False when ``rid`` is not live."""
        req = next((q for q in self.queue if q.rid == rid), None)
        if req is None:
            return False
        self._retire(req, FinishReason.CANCELLED)
        return True

    def _expire_deadlines(self):
        """End every request whose deadline has passed TIMEOUT, queued or
        running (checked at the start of every step)."""
        t = self.now()
        for req in list(self.queue):
            if req.deadline is not None and t > req.deadline:
                self._retire(req, FinishReason.TIMEOUT, t=t)

    # ---------------------------------------------------- fault injection
    def _fault_fired(self, fault):
        self.obs.inc("faults_injected_total", seam=fault.seam)
        self.obs.emit("fault_injected", step=self.step_count,
                      seam=fault.seam, fault_kind=fault.kind, row=fault.row)

    def _arm_step_faults(self):
        """Consult the fault plan once per step for the seams injected at
        step granularity: an ``alloc`` fault makes the step's first
        ensure/COW attempt fail like an OOM; a ``route`` fault fails one dp
        row, whose active requests are preempted back to the queue
        (recompute) and back off. Every rank does this at the same step."""
        self._alloc_fault_armed = False
        if self.faults is None:
            return
        f = self.faults.at(self.step_count, "alloc")
        if f is not None:
            self._alloc_fault_armed = True
            self._fault_fired(f)
        f = self.faults.at(self.step_count, "route")
        if f is not None:
            self._fault_fired(f)
            victims = [r for r in self.active
                       if self.kv.row_of(r.slot) == f.row] if self.paged \
                else list(self.active)
            # recompute exists on the paged pool only (preemption frees
            # blocks); the dense cache backs off in place
            self._fail_requests(victims, preempt=self.paged)

    def _take_alloc_fault(self) -> bool:
        """True exactly once per armed step: the injected OOM."""
        if self._alloc_fault_armed:
            self._alloc_fault_armed = False
            return True
        return False

    def _fail_requests(self, reqs, preempt: bool = False):
        """Charge each request one failed step. At ``quarantine_after``
        failures it ends FAILED; below, it backs off ``retry_backoff *
        fail_count`` steps before it may be batched or admitted again,
        losing its slot with ``preempt`` (recompute for a failed dp
        row)."""
        for r in reqs:
            r.fail_count += 1
            if r.fail_count >= self.cfg.quarantine_after:
                self._retire(r, FinishReason.FAILED)
                continue
            r.retry_at = self.step_count + 1 \
                + self.cfg.retry_backoff * r.fail_count
            if preempt and r.slot is not None:
                self._preempt(r)
            self.obs.inc("retries_total")
            self.obs.emit("retry", step=self.step_count, rid=r.rid,
                          fail_count=r.fail_count, retry_at=r.retry_at,
                          recompute=preempt)

    def _fail_step(self, reqs, n_ready: int, attn_ctx: int):
        """One failed forward step: its requests retry or quarantine, and
        its record carries ``failed`` with no tokens (``attn_ctx`` stays
        for a poisoned step that ran: its attention did read)."""
        self._step_fail_flag = True
        self._fail_requests(reqs)
        self._log_step(0, 0, n_ready, attn_ctx)

    def _forward_fault(self):
        """The plan's ``forward`` fault of this step, or None."""
        fault = (self.faults.at(self.step_count, "forward")
                 if self.faults is not None else None)
        if fault is not None:
            self._fault_fired(fault)
        return fault

    def _retryable(self, r: Request) -> bool:
        """False while a failed request serves its backoff."""
        return r.retry_at <= self.step_count

    def _admissible(self, r: Request) -> bool:
        """The backoff holds admission too, and a draining engine
        re-admits only requests that held a slot before (preempted work
        finishes; fresh work is shed)."""
        if not self._retryable(r):
            return False
        return not (self.draining and r.num_preemptions == 0
                    and not r.generated)

    # ----------------------------------------------------------- dp routing
    def _route(self, req: Request):
        """Assign a queued request to a dp row: the row that minimises its
        routed-but-unadmitted demand less its allocatable blocks (free plus
        the row's prefix ``reclaimable()``), ties to the lowest row. A
        whole burst is routed before any admission changes the free lists,
        so pending demand is part of the score: on free blocks alone the
        burst would all go to one row. Sticky: a preempted request keeps
        its row, whose pool holds its committed prefix blocks."""
        if req.row is not None:
            return
        pend = [0] * self.kv.dp
        for q in self.queue:
            if q.slot is None and q.row is not None:
                pend[q.row] += blocks_for_tokens(q.total_tokens + 1,
                                                 self.cfg.block_size)

        def score(row):
            free = self.kv.allocators[row].num_free
            idx = self.kv.prefix_indices[row]
            if idx is not None:
                free += idx.reclaimable()
            return (pend[row] - free, row)

        req.row = min(range(self.kv.dp), key=score)
        self.obs.emit("routed", step=self.step_count, rid=req.rid,
                      row=req.row)

    # ------------------------------------------------ in-flight prefixes
    def _register_inflight(self, req: Request, row: int, n_matched: int):
        """Publish the chain hash of every full prompt block this admission
        will write (depths past its prefix match), so that a same-prefix
        request admitted behind it waits for the commit instead of
        prefilling the span again."""
        bs = self.cfg.block_size
        keys = []
        for i, key in enumerate(PrefixIndex.chain_keys(
                req.all_tokens(), bs, (req.total_tokens - 1) // bs)):
            if i >= n_matched:
                self._inflight[row][key] = req.rid
                keys.append(key)
        req.inflight_keys = keys

    def _unregister_inflight(self, req: Request):
        if req.row is None or not req.inflight_keys:
            return
        m = self._inflight[req.row]
        for k in req.inflight_keys:
            if m.get(k) == req.rid:
                del m[k]
        req.inflight_keys = []

    def _wait_for_inflight(self, req: Request, row: int, matched) -> bool:
        """True when another active request of ``row`` is mid-prefill over
        the next full block of ``req``'s prompt: that block's chain hash is
        in the row's in-flight registry and its writer has not written it
        yet. ``req`` stays queued; once the block commits, the match maps
        it."""
        if self.prefix_rows is None:
            return False
        bs = self.cfg.block_size
        i = len(matched)
        if (i + 1) * bs > req.total_tokens - 1:
            return False                 # no further full block to share
        *_, key = PrefixIndex.chain_keys(req.all_tokens(), bs, i + 1)
        wrid = self._inflight[row].get(key)
        if wrid is None:
            return False
        w = next((a for a in self.active if a.rid == wrid), None)
        if w is None or w is req or w.done:
            self._inflight[row].pop(key, None)     # stale entry
            return False
        # the writer wrote the block but the match did not extend (its
        # commit stopped at a hash collision): do not wait for it
        return w.prefilled < (i + 1) * bs

    def _admit(self):
        """Assign free slots FCFS per dp row. Dense: FCFS by free slot.
        Paged: every unrouted request is first routed (``_route``); the
        slots of row r are the range [r*slots_per_row, (r+1)*slots_per_row),
        and a request is admitted only when its whole (re)prompt plus one
        decode token fits in its row's free blocks, counting the blocks a
        prefix match covers and those the row's prefix index could
        reclaim. On admission the longest indexed prefix of the (re)prompt
        is mapped into the slot's table, so prefill starts at the first
        uncached token. One exception to FCFS: a request waiting for an
        in-flight same-prefix prefill is skipped, not blocking (its wait is
        bounded by the writer's progress)."""
        if not self.paged:
            for req in list(self.queue):
                if req.slot is not None or not self._admissible(req):
                    continue
                slot = next((s for s, owner in enumerate(self.slot_req)
                             if owner is None), None)
                if slot is None:
                    break                   # FCFS
                req.slot = slot
                self.slot_req[slot] = req
                self.lens[slot] = req.prefilled
                self._on_admit(req)
            return
        for req in self.queue:
            if req.slot is None:
                self._route(req)
        spr = self.slots_per_row
        for row in range(self.kv.dp):
            for req in list(self.queue):
                if req.slot is not None or req.row != row \
                        or not self._admissible(req):
                    continue
                slot = next((s for s in range(row * spr, (row + 1) * spr)
                             if self.slot_req[s] is None), None)
                if slot is None:
                    break                   # FCFS within the row
                idx = self.kv.prefix_indices[row]
                matched = []
                if idx is not None:
                    # probe without the LRU bump (a queue head that fails
                    # admission must not refresh its entries' recency),
                    # capped at total-1: the last known token always runs
                    # through the forward pass
                    matched = idx.match(req.all_tokens(),
                                        max_tokens=req.total_tokens - 1,
                                        bump=False)
                    if self._wait_for_inflight(req, row, matched):
                        continue
                if not self.kv.can_allocate(req.total_tokens + 1,
                                            cached_blocks=matched, row=row):
                    break                   # FCFS within the row
                req.slot = slot
                self.slot_req[slot] = req
                if idx is not None:
                    idx.record(len(matched))
                    self.obs.inc("prefix_hits_total" if matched
                                 else "prefix_misses_total")
                    if matched:
                        idx.bump(req.all_tokens(), len(matched))
                        self.kv.assign_prefix(slot, matched)
                        req.prefilled = len(matched) * self.cfg.block_size
                        req.cached_tokens = req.prefilled
                        self.obs.inc("prefix_tokens_saved_total",
                                     req.prefilled)
                        self.obs.emit("prefix_hit", step=self.step_count,
                                      rid=req.rid, row=row,
                                      blocks=len(matched),
                                      tokens=req.prefilled)
                    self._register_inflight(req, row, len(matched))
                if self._take_alloc_fault() \
                        or not self.kv.ensure(slot, req.total_tokens + 1):
                    # an injected OOM, or eviction reclaimed less than the
                    # probe reckoned: roll the admission back
                    # (assign_prefix's refs go with free_seq) and keep the
                    # request queued
                    self._unregister_inflight(req)
                    if self.kv.n_mapped[slot]:
                        self.kv.free_seq(slot)
                    self.slot_req[slot] = None
                    req.slot = None
                    req.prefilled = 0
                    req.cached_tokens = 0
                    break
                self.lens[slot] = req.prefilled
                self._on_admit(req)

    def _on_admit(self, req: Request):
        """One (re)admission: its counter, queue time and event (a
        re-admission after a preemption counts again)."""
        self.obs.inc("requests_admitted_total")
        ts = self.now()
        queue_s = max(ts - req.arrival, 0.0)
        self.obs.observe("queue_seconds", queue_s)
        self.obs.emit("admitted", step=self.step_count, ts=ts, rid=req.rid,
                      row=req.row, slot=req.slot, queue_s=queue_s,
                      cached_tokens=req.cached_tokens,
                      preemptions=req.num_preemptions)

    # ---------------------------------------------------------------- stats
    @property
    def prefix_stats(self) -> PrefixStats:
        """Prefix-cache counters summed over the dp rows (zeros when
        caching is off), the COW copy count (the registry's, 0 under
        NullObs) and the reason paging is off (None when paged)."""
        s = {"entries": 0, "hits": 0, "misses": 0, "tokens_saved": 0,
             "evictions": 0}
        for idx in self.prefix_rows or []:
            for k, v in idx.stats().items():
                s[k] += v
        cow = int(self.obs.registry.counter_value("cow_copies_total"))
        return PrefixStats(cow_copies=cow,
                           paged_disabled_reason=self.paged_disabled_reason,
                           **s)

    def block_accounting(self) -> BlockLedger:
        """Paged-block ledger for leak checks, summed over the dp rows:
        ``used`` counts every held block (sequence mappings and prefix
        pins), ``pinned`` the indexes' pins, ``free_per_row`` each row's
        free blocks. With nothing in flight, ``used == pinned``."""
        if not self.paged:
            return BlockLedger()
        return BlockLedger(
            used=self.kv.num_used_blocks,
            pinned=sum(len(idx.blocks()) for idx in self.prefix_rows or []),
            free=self.kv.num_free_blocks,
            free_per_row=tuple(self.kv.row_free_blocks(r)
                               for r in range(self.kv.dp)))

    # ----------------------------------------------------- memory pressure
    def _preempt(self, victim: Request):
        """Evict a running request back to the queue, freeing its blocks
        (shared ones are decremented). Recompute-style: its prompt +
        generated re-prefills on re-admission into the same dp row (``row``
        is sticky), where it re-matches its own committed prefix."""
        row, slot = self.kv.row_of(victim.slot), victim.slot
        self._release_slot(victim)
        victim.prefilled = 0
        victim.cached_tokens = 0
        victim.pc_blocks, victim.pc_parent = 0, None   # recommit from root
        victim.num_preemptions += 1
        self.preemptions += 1
        self.obs.inc("requests_preempted_total")
        self.obs.emit("preempted", step=self.step_count, rid=victim.rid,
                      row=row, slot=slot,
                      tokens_generated=len(victim.generated))

    def _reserve(self, req: Request, n_tokens: int, protect,
                 write_from: Optional[int] = None) -> bool:
        """Grow req's block table to cover n_tokens and, with
        ``write_from``, copy-on-write every shared block in the write range
        ``[write_from, n_tokens)``, LRU-preempting other active requests of
        the same dp row outside ``protect`` while the row's free list (and
        its prefix index's eviction) runs dry: blocks never cross rows, so
        pressure in one row never preempts another row's requests. Returns
        False when nothing can be evicted. COW copies are queued for
        ``_apply_copies``."""
        row = self.kv.row_of(req.slot)
        while True:
            # an armed alloc fault fails this step's first ensure/COW like
            # an OOM: the preemption below is the path under test
            if not self._take_alloc_fault() \
                    and self.kv.ensure(req.slot, n_tokens):
                if write_from is None:
                    return True
                ok, copies = self.kv.copy_on_write(req.slot, write_from,
                                                   n_tokens)
                if ok:
                    self._step_copies.extend((row, s, d) for s, d in copies)
                    return True
            victims = [a for a in self.active
                       if a is not req and a not in protect
                       and self.kv.row_of(a.slot) == row]
            if not victims:
                return False
            self._preempt(min(victims,
                              key=lambda a: (a.last_used, -a.arrival)))

    def _apply_copies(self):
        """Make the queued COW copies in the pool (one gather of every
        source, then one scatter, in place) before the forward pass that
        writes the copied blocks. Each rank copies its own row's blocks,
        in row-local ids, in its row's pool (every rank of a row holds its
        own kv slots of the same blocks)."""
        if not self._step_copies:
            return
        copies, self._step_copies = self._step_copies, []
        self.obs.inc("cow_copies_total", len(copies))
        self.obs.emit("cow_flush", step=self.step_count, copies=len(copies))
        mine = self.model.shard.dp_rank
        pairs = [(s, d) for row, s, d in copies if row == mine]
        if pairs:
            self.model.copy_blocks([s for s, _ in pairs],
                                   [d for _, d in pairs])

    def _commit_prefix(self, req: Request):
        """Index every fully written block of ``req`` (positions
        ``0..prefilled-1`` are in the cache), incrementally from the
        request's ``(pc_blocks, pc_parent)`` cursor. Called before a finish
        could free the slot."""
        if self.prefix_rows is None or req.slot is None:
            return
        idx = self.prefix_rows[self.kv.row_of(req.slot)]
        full = min(req.prefilled // self.cfg.block_size,
                   int(self.kv.n_mapped[req.slot]))
        if full > req.pc_blocks:
            req.pc_blocks, req.pc_parent, _ = idx.commit_incremental(
                req.all_tokens(), req.pc_blocks, full, req.pc_parent,
                self.kv.seq_blocks(req.slot))

    # ---------------------------------------------------------------- steps
    def _choose(self, n_tokens: int, n_prefill: int, ctx_tokens: int = 0,
                n_rows: int = 0, ctx_max: int = 0,
                spec_tokens: int = 0) -> str:
        """The config of this iteration (Algorithm 2). The policy gets the
        context facts its ``use_base`` declares: ``ctx_tokens`` (the rows'
        summed context), ``n_rows``, ``ctx_max`` and ``spec_tokens`` (the
        draft queries inside ``n_tokens``)."""
        facts = {"ctx_tokens": ctx_tokens, "n_rows": n_rows,
                 "ctx_max": ctx_max, "spec_tokens": spec_tokens}
        use_base = self.policy.use_base(
            n_tokens, n_prefill,
            **{k: facts[k] for k in self._policy_ctx_kwargs})
        name = "base" if use_base else "shift"
        # the shift audit: the chosen config and exactly the facts the
        # policy saw, folded into this step's record by step()
        self._step_audit = {"config": name, "n_tokens": n_tokens,
                            "ctx_tokens": ctx_tokens, "n_rows": n_rows,
                            "ctx_max": ctx_max,
                            "threshold": getattr(self.policy, "threshold",
                                                 None)}
        if spec_tokens:
            self._step_audit["spec_tokens"] = spec_tokens
        return name

    def _log_step(self, n_prefill: int, n_decode: int, n_ready: int,
                  attn_ctx: int = 0):
        """Stash this step's composition for its record: ``n_decode``
        counts the tokens delivered, ``attn_ctx`` the context the forward
        really attended."""
        self._step_stats = {"prefill_tokens": n_prefill,
                            "decode_tokens": n_decode,
                            "ready_decodes": n_ready,
                            "attn_ctx_tokens": attn_ctx}

    def _prefill_done(self, r: Request) -> bool:
        return r.prefilled >= r.pos

    def _finish_token(self, r: Request, tok: int, t: float):
        """Append a sampled token and retire the request if it is done."""
        r.generated.append(tok)
        # the forward wrote this step's input tokens through position
        # r.pos-1, so the cache covers everything before the new last token
        r.prefilled = r.pos
        if r.first_token_time is None:
            r.first_token_time = t
            ttft = max(t - r.arrival, 0.0)
            self.obs.observe("ttft_seconds", ttft)
            self.obs.emit("first_token", step=self.step_count, ts=t,
                          rid=r.rid, ttft_s=ttft)
        self.lens[r.slot] = r.pos
        if r.done or (self.cfg.eos_id >= 0
                      and r.generated[-1] == self.cfg.eos_id):
            r.finish_time = t
            r.finish_reason = FinishReason.OK
            self.drafter.drop(r.rid)
            if self.paged:
                self._unregister_inflight(r)
                self.kv.free_seq(r.slot)
            self.slot_req[r.slot] = None
            self.queue = [q for q in self.queue if q is not r]
            n_out = len(r.generated)
            e2e = max(t - r.arrival, 0.0)
            tpot = ((t - r.first_token_time) / (n_out - 1)
                    if n_out > 1 else None)
            self.obs.inc("requests_finished_total")
            self.obs.observe("e2e_seconds", e2e)
            if tpot is not None:
                self.obs.observe("tpot_seconds", tpot)
            self.obs.emit("finish", step=self.step_count, ts=t, rid=r.rid,
                          row=r.row, n_out=n_out, n_prompt=len(r.prompt),
                          ttft_s=max(r.first_token_time - r.arrival, 0.0),
                          tpot_s=tpot, e2e_s=e2e,
                          cached_tokens=r.cached_tokens,
                          preemptions=r.num_preemptions)

    def _refresh_block_tables(self):
        for s in self.kv.take_dirty():
            self._bt_host[s] = self.kv.table[s]

    def _block_tables(self, rows: List[Request]) -> np.ndarray:
        """Block-table batch of the serialized path: all ``max_slots`` rows
        at the full ``nmax``; rows outside this batch stay all-null so their
        (garbage) writes land in the null block."""
        self._refresh_block_tables()
        bt = np.zeros((self.cfg.max_slots, self.kv.max_blocks_per_seq),
                      np.int32)
        idx = [r.slot for r in rows]
        bt[idx] = self._bt_host[idx]
        return bt

    def _run_mixed(self) -> bool:
        """One fused iteration: every ready decode row (with its draft, when
        speculating) PLUS a prefill chunk for every row still swallowing
        its (re)prompt, in a single forward pass. Decode rows reserve
        blocks first, so a prompt burst can shrink the prefill side but
        never starve in-flight decodes. A prefill row whose chunk reaches
        its last known token samples its next token in the same pass."""
        C = self.cfg.prefill_chunk
        ready = [r for r in self.active if self._prefill_done(r)
                 and not r.done and self._retryable(r)]
        n_ready = len(ready)
        rows = []                          # (req, off, q_len, produces)
        drafts: Dict[int, List[int]] = {}  # rid -> draft tokens
        decode_rows = set()
        protect = set()
        for r in ready:
            if r.slot is None:
                continue                   # preempted by an earlier reserve
            # coverage for the token written this step (position r.pos)
            if self._reserve(r, r.total_tokens, protect, write_from=r.pos):
                d: List[int] = []
                if self._spec_on:
                    # at most the tokens the request may still emit beyond
                    # the one it samples anyway
                    d = self.drafter.propose(
                        r.rid, r.all_tokens(),
                        r.max_new_tokens - len(r.generated) - 1)
                    # the draft's blocks never preempt anyone or evict a
                    # cached prefix: shrink it until the free list covers it
                    while d and not self.kv.ensure(r.slot,
                                                   r.total_tokens + len(d)):
                        d.pop()
                if d:
                    drafts[r.rid] = d
                rows.append((r, r.pos, 1 + len(d), True))
                decode_rows.add(r)
                protect.add(r)
        n_decode = len(decode_rows)
        n_spec = sum(len(d) for d in drafts.values())
        n_prefill_tok = 0
        for r in list(self.active):
            if r.slot is None or r.done or self._prefill_done(r) \
                    or not self._retryable(r):
                continue
            off = r.prefilled
            end = min(off + C, r.total_tokens)
            if end <= off or not self._reserve(r, end, protect,
                                               write_from=off):
                continue
            rows.append((r, off, end - off, end == r.total_tokens))
            protect.add(r)
            n_prefill_tok += end - off
            self.obs.emit("prefill_chunk", step=self.step_count, rid=r.rid,
                          off=off, tokens=end - off)
        if not rows:
            self._log_step(0, 0, n_ready)
            return False

        attn_ctx = sum(off + ql for _, off, ql, _ in rows)
        mode = self._choose(n_prefill_tok + n_decode + n_spec, n_prefill_tok,
                            attn_ctx, len(rows),
                            max(off + ql for _, off, ql, _ in rows),
                            spec_tokens=n_spec)
        # compact to active rows and bucket every axis to a power of two,
        # as the reference does for its compiled-shape reuse; the chunk
        # axis splits over the chosen config's SP degree (a decode-only
        # batch on the base config is [R, sp]). Each dp row's requests
        # land in that row's contiguous segment (the whole batch at dp 1),
        # every segment of the same width (a row without work gives an
        # all-padding segment whose writes land in its null block), and
        # each rank steps its own. Every width is computed over the whole batch, so all ranks
        # step the same shapes and their collectives line up.
        per = [[] for _ in range(self.kv.dp)]
        for e in rows:
            per[self.kv.row_of(e[0].slot)].append(e)
        seg = pow2_bucket(max(len(p) for p in per))
        placed = [(ri * seg + j, e) for ri, p in enumerate(per)
                  for j, e in enumerate(p)]
        Rb = self.kv.dp * seg
        Cb = max(pow2_bucket(max(ql for _, _, ql, _ in rows)),
                 (self.base if mode == "base" else self.shift).lay.sp)
        self._refresh_block_tables()
        # slice the table batch to the occupied prefix: attention work
        # scales with actual cache occupancy, not s_max
        nb = max(int(max(self.kv.n_mapped[r.slot] for r, _, _, _ in rows)), 1)
        nbb = min(pow2_bucket(nb), self.kv.max_blocks_per_seq)
        toks = np.zeros((Rb, Cb), np.int32)
        qlen = np.zeros((Rb,), np.int32)
        offs = np.zeros((Rb,), np.int32)
        bt = np.zeros((Rb, nbb), np.int32)
        for i, (r, off, ql, _) in placed:
            if off == r.pos:                   # decode row: the last token
                toks[i, 0] = r.generated[-1] if r.generated else r.prompt[-1]
                toks[i, 1:ql] = drafts.get(r.rid, [])
            else:
                toks[i, :ql] = r.all_tokens()[off:off + ql]
            qlen[i] = ql
            offs[i] = off
            bt[i] = self._bt_host[r.slot, :nbb]
        self._apply_copies()               # COW copies land before the write
        # the verify width: each row's last n_last columns come back; with
        # no draft, n_last == 1 is the plain step
        n_last = (pow2_bucket(1 + max(len(d) for d in drafts.values()))
                  if drafts else 1)
        fwd = self.deploy.forward_at(mode, n_last)
        fault = self._forward_fault()
        if fault is None or fault.kind == "nan":
            # "nan": the step runs (and writes the KV bytes a retry writes
            # again), but its tokens are garbage
            nxt = fwd(toks, qlen, offs, bt).cpu().numpy()
        if fault is not None:
            # no token is applied: every batched request retries or
            # quarantines, and a retry recomputes the same chunk. The
            # drafts' blocks are unmapped, so the ledger reads as after a
            # failure without drafts
            for r in decode_rows:
                if r.rid in drafts and r.slot is not None:
                    self.kv.truncate(r.slot, r.total_tokens)
            self._fail_step([e[0] for _, e in placed], n_ready,
                            attn_ctx if fault.kind == "nan" else 0)
            return True
        t = self.now()
        n_dec_emit = 0                     # decode-side tokens delivered
        n_accepted = 0
        rollback = 0
        for i, (r, off, ql, produces) in placed:
            r.last_used = self.step_count
            d = drafts.get(r.rid) if r in decode_rows else None
            if d is None:
                r.prefilled = off + ql
                self.lens[r.slot] = r.prefilled
                self._commit_prefix(r)     # before a finish frees the slot
                if produces:
                    self._finish_token(r, int(nxt[i, n_last - 1] if n_last > 1
                                              else nxt[i]), t)
                    if r in decode_rows:
                        n_dec_emit += 1
                continue
            # the verify row's outputs o_0..o_m sit in its last m+1
            # columns; accept the longest prefix where draft j matched
            # output j-1 and emit o_0..o_accepted, exactly the tokens
            # sequential greedy decoding would give
            m = len(d)
            out = [int(nxt[i, n_last - 1 - m + j]) for j in range(m + 1)]
            n_acc = 0
            while n_acc < m and d[n_acc] == out[n_acc]:
                n_acc += 1
            emitted = out[:n_acc + 1]
            # unmap the rejected tail's blocks while the slot is alive
            rollback += self.kv.truncate(r.slot, off + len(emitted))
            delivered = 0
            for j, tok in enumerate(emitted):
                # commit before each append with the coverage a sequential
                # step would have had (the index hashes no draft)
                r.prefilled = off + j + 1
                self.lens[r.slot] = r.prefilled
                self._commit_prefix(r)
                self._finish_token(r, tok, t)
                delivered = j + 1
                if r.finish_reason is not None:
                    break                  # finished mid-accept
            n_dec_emit += delivered
            n_accepted += delivered - 1
            self.obs.observe("spec_accepted_per_row", delivered - 1)
        self._log_step(n_prefill_tok, n_dec_emit, n_ready, attn_ctx)
        if n_spec:
            self._step_stats["spec_proposed"] = n_spec
            self._step_stats["spec_accepted"] = n_accepted
            self.obs.inc("spec_proposed_total", n_spec)
            if n_accepted:
                self.obs.inc("spec_accepted_total", n_accepted)
            if rollback:
                self.obs.inc("spec_rollback_blocks_total", rollback)
        return True

    # --------------------------------------------------- serialized stepping
    def _run_prefill(self) -> bool:
        """One chunked-prefill step over the slots that still need their
        (re)prompt, batched at the full ``max_slots`` (under dp each rank
        steps its row's slot range); the last known token of each row is
        left for the decode step. Dummy rows sit at offset
        ``s_max - C`` on the dense cache (their writes must not land on
        live positions) and at 0 on the paged pool (their all-null tables
        route the writes to the null block, and a zero context keeps the
        ragged kernel from walking null blocks)."""
        C = self.cfg.prefill_chunk
        todo = [r for r in self.active
                if not self._prefill_done(r) and self._retryable(r)]
        if not todo:
            return False
        toks = np.zeros((self.cfg.max_slots, C), np.int32)
        offs = np.full((self.cfg.max_slots,),
                       0 if self.paged else max(self.cfg.s_max - C, 0),
                       np.int32)
        rows = []                          # (req, chunk length)
        for r in todo:
            if r.slot is None:
                continue                   # preempted by an earlier reserve
            off = r.prefilled
            seq = r.all_tokens()
            chunk = seq[off:min(off + C, len(seq) - 1)]
            if not chunk:
                continue
            if self.paged and not self._reserve(
                    r, off + len(chunk), protect={rr for rr, _ in rows},
                    write_from=off):
                continue
            toks[r.slot, :len(chunk)] = chunk
            offs[r.slot] = off
            rows.append((r, len(chunk)))
            self.obs.emit("prefill_chunk", step=self.step_count, rid=r.rid,
                          off=off, tokens=len(chunk))
        if not rows:
            return False
        n_tok = sum(n for _, n in rows)
        # what the attention reads: on the paged pool every batch row
        # attends offset + C (padding columns and dummy rows included)
        if self.paged:
            ctx = sum(r.prefilled + C for r, _ in rows) \
                + (self.cfg.max_slots - len(rows)) * C
            ctx_max = max(r.prefilled + C for r, _ in rows)
        else:
            ctx = sum(r.prefilled + n for r, n in rows)
            ctx_max = max(r.prefilled + n for r, n in rows)
        mode = self._choose(n_tok, n_tok, ctx, len(rows), ctx_max)
        bt = None
        if self.paged:
            bt = self._block_tables([r for r, _ in rows])
            self._apply_copies()
        fault = self._forward_fault()
        if fault is None or fault.kind == "nan":
            self.deploy.prefill[mode](toks, offs, bt)
            self._wait_for_device()
        if fault is not None:
            self._fail_step([r for r, _ in rows],
                            sum(1 for r in self.active
                                if self._prefill_done(r) and not r.done),
                            ctx if fault.kind == "nan" else 0)
            return True
        for r, n in rows:
            r.prefilled += n
            r.last_used = self.step_count
            self.lens[r.slot] = r.prefilled
            self._commit_prefix(r)
        self._log_step(n_tok, 0,
                       sum(1 for r in self.active
                           if self._prefill_done(r) and not r.done), ctx)
        return True

    def _wait_for_device(self):
        """A serialized prefill step reads nothing back: on the card, wait
        for the device, so that the step's duration holds its device time
        (the next step's read-back would book it otherwise)."""
        if self.model.device.type == "cuda":
            torch.cuda.current_stream(self.model.device).synchronize()

    def _run_decode(self) -> bool:
        """One decode step over every ready row, batched at the full
        ``max_slots`` (under dp each rank steps its row's slot range and
        the tokens are gathered over DP); each writes its last known token
        at ``r.pos``."""
        ready = [r for r in self.active
                 if self._prefill_done(r) and not r.done
                 and self._retryable(r)]
        n_ready = len(ready)
        if self.paged:
            kept = []
            for r in ready:
                if r.slot is None:
                    continue               # preempted by an earlier reserve
                # coverage for the token written this step (position r.pos)
                if self._reserve(r, r.total_tokens, protect=set(kept),
                                 write_from=r.pos):
                    kept.append(r)
            ready = kept
        if not ready:
            return False
        # inactive slots of the paged batch each read one null position
        ctx = sum(r.pos + 1 for r in ready) \
            + (self.cfg.max_slots - len(ready) if self.paged else 0)
        mode = self._choose(len(ready), 0, ctx, len(ready),
                            max(r.pos + 1 for r in ready))
        toks = np.zeros((self.cfg.max_slots,), np.int32)
        lens = np.zeros((self.cfg.max_slots,), np.int32)
        for r in ready:
            toks[r.slot] = r.generated[-1] if r.generated else r.prompt[-1]
            lens[r.slot] = r.pos           # write position of this token
        bt = None
        if self.paged:
            bt = self._block_tables(ready)
            self._apply_copies()
        fault = self._forward_fault()
        if fault is None or fault.kind == "nan":
            nxt = self.deploy.decode[mode](toks, lens, bt).cpu().numpy()
        if fault is not None:
            self._fail_step(list(ready), n_ready,
                            ctx if fault.kind == "nan" else 0)
            return True
        t = self.now()
        for r in ready:
            r.last_used = self.step_count
            r.prefilled = r.pos + 1        # this step wrote position r.pos
            self._commit_prefix(r)
            self._finish_token(r, int(nxt[r.slot]), t)
        self._log_step(0, len(ready), n_ready, ctx)
        return True

    def step(self) -> bool:
        """One engine iteration: deadlines first (an expired request must
        not take this step's batch space), admission, the iteration, then
        one audit record, the watchdog and the gauges. Returns False when
        idle."""
        t0 = self.now()
        self._step_stats = None
        self._step_audit = None
        self._step_fail_flag = False
        # deadlines first, then this step's scheduled faults (a route
        # fault preempts before admission refills the failed row's slots)
        self._expire_deadlines()
        self._arm_step_faults()
        self._admit()
        if self.mixed:
            # fused prefill+decode batch: no iteration-granularity
            # interference between a prompt burst and in-flight decodes
            progressed = self._run_mixed()
        else:
            # prefill first, chunk by chunk; decode otherwise
            progressed = self._run_prefill() or self._run_decode()
        dt = self.now() - t0
        # one record per iteration: step index, duration, composition and
        # the shift audit (config None for a step that launched nothing)
        rec = {"step": self.step_count, "t_start": t0, "dur_s": dt,
               "config": None, **(self._step_stats or _EMPTY_STEP)}
        if self._step_audit is not None:
            rec.update(self._step_audit)
        if self._step_fail_flag:
            rec["failed"] = True
            self.obs.inc("failed_steps_total")
        if self.paged_disabled_reason is not None:
            rec["paged_disabled_reason"] = self.paged_disabled_reason
        self.obs.record_step(rec)
        if self.watchdog.observe(dt):
            self.obs.inc("straggler_steps_total")
            self.obs.emit("straggler", step=self.step_count, dur_s=dt,
                          flagged=self.watchdog.flagged)
        self.obs.set_gauge("queue_depth",
                           sum(1 for q in self.queue if q.slot is None))
        self.obs.set_gauge("active_requests", len(self.active))
        if self.paged:
            self.obs.set_gauge("free_blocks", self.kv.num_free_blocks)
        self.step_count += 1
        if self.cfg.auto_snapshot_every \
                and self.step_count % self.cfg.auto_snapshot_every == 0:
            self._auto_snapshot()
        return progressed

    def run_until_idle(self, max_steps: int = 10000):
        for _ in range(max_steps):
            if not self.step():
                if not self.queue and not self.active:
                    break
        return self

    # ------------------------------------------------------ fault tolerance
    def _cache_tensors(self) -> Dict[str, torch.Tensor]:
        """The cache this engine initialised on its rank, by name: the
        paged pool's ``k`` and ``v``, or the dense cache's tensors (``k``,
        ``v``, ``ssm``, ``conv_x``, ``conv_bc``; those of kinds the config
        lacks are absent). The shift model adopts the base model's pool,
        so these are all there is."""
        names = ("k", "v") if self.paged \
            else ("k", "v", "ssm", "conv_x", "conv_bc")
        return {name: t for name in names
                if (t := getattr(self._cache, name)) is not None}

    def snapshot(self) -> dict:
        """The engine's state for a restart (the weights are static): the
        cache of this rank, copied to the host as tensors (one synchronous
        copy on the stream that ran the steps), and its rank; the slot
        lengths, the step index, the layout's signature, the observability
        state and every unfinished request; on the paged pool the block
        tables and allocators and each row's prefix index. The control
        plane is host state, the same on every rank, so a snapshot needs
        no collective. The ``snapshot`` event is emitted first, so it is
        part of the capture. A ``snapshot`` fault of the plan corrupts the
        capture, which ``validate_snapshot`` then refuses."""
        self.obs.emit("snapshot", step=self.step_count)
        self.obs.inc("snapshots_total")
        snap = {
            "cache": {name: t.detach().to("cpu", copy=True)
                      for name, t in self._cache_tensors().items()},
            "rank": self.model.shard.rank,
            "lens": self.lens.copy(),
            "step_count": self.step_count,
            # a snapshot restores only into a deployment of the same
            # (dp, sp, tp, ep) signature
            "layout": tuple(self.deploy.layout.signature),
            "obs": self.obs.state_dict(),
            "requests": [
                {"rid": r.rid, "prompt": list(r.prompt), "slot": r.slot,
                 "row": r.row,
                 "prefilled": r.prefilled, "generated": list(r.generated),
                 "max_new_tokens": r.max_new_tokens, "arrival": r.arrival,
                 "deadline": r.deadline,
                 "first_token_time": r.first_token_time,
                 "finish_time": r.finish_time, "last_used": r.last_used,
                 "cached_tokens": r.cached_tokens,
                 "num_preemptions": r.num_preemptions,
                 "fail_count": r.fail_count, "retry_at": r.retry_at}
                for r in self.queue + [x for x in self.slot_req
                                       if x is not None
                                       and x not in self.queue]],
        }
        if self.paged:
            snap["kv"] = self.kv.state_dict()
            if self.prefix_rows is not None:
                # the allocators' states hold the indexes' pins: every
                # row's index must come back with them
                snap["prefix"] = [idx.state_dict()
                                  for idx in self.prefix_rows]
        if self.faults is not None:
            f = self.faults.at(self.step_count, "snapshot")
            if f is not None:
                self._fault_fired(f)
                corrupt_snapshot(snap, self.step_count)
        return snap

    def _auto_snapshot(self):
        """A periodic snapshot into the ring that ``recover`` restores
        from, which keeps the newest ``snapshot_keep``."""
        self._snap_ring.append(self.snapshot())
        del self._snap_ring[:-self.cfg.snapshot_keep]

    def retained_snapshots(self) -> List[dict]:
        """The auto-snapshot ring, newest last: what ``recover()``
        restores from."""
        return list(self._snap_ring)

    def validate_snapshot(self, snap) -> None:
        """Raise ``SnapshotError`` if this engine cannot restore ``snap``:
        the reference's checks (required keys, the slot lengths' shape, the
        request entries and their slots, the layout's signature, the paged
        state and the prefix indexes), and the cache: the same tensors, of
        the shapes and types of this engine's cache, taken on this rank.
        ``restore`` calls it before it changes anything."""
        if not isinstance(snap, dict):
            raise SnapshotError(f"snapshot is {type(snap).__name__}, "
                                "not a dict")
        for key in ("cache", "lens", "requests"):
            if key not in snap:
                raise SnapshotError(f"snapshot missing required key {key!r}")
        lens = snap["lens"]
        if getattr(lens, "shape", None) != (self.cfg.max_slots,):
            raise SnapshotError(
                f"snapshot lens shape {getattr(lens, 'shape', None)} != "
                f"engine max_slots ({self.cfg.max_slots},)")
        seen_slots = set()
        for rd in snap["requests"]:
            if not isinstance(rd, dict):
                raise SnapshotError("request entry is not a dict")
            for key in ("rid", "prompt", "slot", "prefilled", "generated",
                        "max_new_tokens"):
                if key not in rd:
                    raise SnapshotError(
                        f"request entry missing required key {key!r}")
            slot = rd["slot"]
            if slot is not None:
                if not (0 <= slot < self.cfg.max_slots):
                    raise SnapshotError(f"request slot {slot} out of range "
                                        f"[0, {self.cfg.max_slots})")
                if slot in seen_slots:
                    raise SnapshotError(f"duplicate request slot {slot}")
                seen_slots.add(slot)
        if "layout" in snap:
            sig = tuple(self.deploy.layout.signature)
            if tuple(snap["layout"]) != sig:
                raise SnapshotError(
                    f"snapshot was captured under layout signature "
                    f"{tuple(snap['layout'])} (dp, sp, tp, ep); this "
                    f"engine's deployment is {sig}: restore into a "
                    "matching deployment")
        if self.paged:
            if "kv" not in snap:
                raise SnapshotError("paged engine restoring a snapshot "
                                    "without the paged-KV state")
            if snap["kv"].get("dp", 1) != self.dp:
                raise SnapshotError(
                    f"snapshot has dp={snap['kv'].get('dp', 1)}, "
                    f"engine has dp={self.dp}")
            if self.prefix_rows is not None:
                if "prefix" not in snap:
                    raise SnapshotError(
                        "prefix-caching engine restoring a snapshot without "
                        "the indexes (their allocator pins would leak)")
                if len(snap["prefix"]) != self.dp:
                    raise SnapshotError(
                        f"snapshot has {len(snap['prefix'])} prefix indexes, "
                        f"engine has dp={self.dp}")
            elif "prefix" in snap:
                raise SnapshotError(
                    "snapshot carries prefix indexes but this engine has "
                    "prefix_cache=False (their allocator pins would leak)")
        rank = self.model.shard.rank
        if snap.get("rank", rank) != rank:
            raise SnapshotError(f"snapshot holds rank {snap['rank']}'s "
                                f"cache shard, this engine is rank {rank}")
        cache, want = snap["cache"], self._cache_tensors()
        if not isinstance(cache, dict) or set(cache) != set(want):
            held = sorted(cache) if isinstance(cache, dict) \
                else type(cache).__name__
            raise SnapshotError(f"snapshot cache holds {held}, this "
                                f"engine's cache {sorted(want)}")
        for name, t in want.items():
            got = cache[name]
            if not isinstance(got, torch.Tensor) or got.shape != t.shape \
                    or got.dtype != t.dtype:
                raise SnapshotError(
                    f"snapshot cache {name!r}: "
                    f"{getattr(got, 'dtype', type(got).__name__)} "
                    f"{tuple(getattr(got, 'shape', ()))}, this engine's "
                    f"{t.dtype} {tuple(t.shape)}")

    def recover(self, snapshots=None):
        """Crash recovery: restore the newest snapshot that validates,
        falling back through older ones (a ``snapshot`` fault corrupts a
        capture; the ring absorbs it). Raises ``SnapshotError`` when none
        is left."""
        ring = self._snap_ring if snapshots is None else list(snapshots)
        for snap in reversed(ring):
            try:
                self.validate_snapshot(snap)
            except SnapshotError:
                continue
            self.restore(snap)
            self.obs.inc("recoveries_total")
            self.obs.emit("recovered", step=self.step_count,
                          n_requests=len(self.queue))
            return self
        raise SnapshotError("no valid snapshot to recover from")

    @torch.no_grad()
    def restore(self, snap):
        """Rebuild the engine's state from ``snapshot()``. Validates first
        and raises ``SnapshotError`` without touching the engine. The cache
        is copied into this engine's tensors in place, so that the step
        tables' CUDA graphs, which hold its addresses, replay on. As in the
        reference, the in-flight prefill registry is not restored and the
        drafter starts empty; the pending COW copies and the stashed step
        facts go too. Raises ``RuntimeError`` if a later engine on the same
        model has initialised the model's cache anew (this engine's steps
        would no longer run on the cache it restores)."""
        if self._cache is not (self.model.pool if self.paged
                               else self.model.cache):
            raise RuntimeError("the model's cache was re-initialised by "
                               "another engine; restore into that engine")
        self.validate_snapshot(snap)
        for name, t in self._cache_tensors().items():
            t.copy_(snap["cache"][name])
        self.lens = snap["lens"].copy()
        # observability resumes where the snapshot left off: counters stay
        # monotone, the spans of in-flight requests keep their history, and
        # the step index continues
        self.step_count = snap.get("step_count", 0)
        if snap.get("obs") is not None and self.obs.enabled:
            self.obs.load_state(snap["obs"])
        if self.paged:
            self.kv = PagedKVCache.from_state(snap["kv"])
            if self.prefix_rows is not None:
                self.prefix_rows = [
                    PrefixIndex.from_state(s, self.kv.allocators[r])
                    for r, s in enumerate(snap["prefix"])]
                self.kv.prefix_indices = list(self.prefix_rows)
                self._attach_prefix_observers()
            self._inflight = [{} for _ in range(self.kv.dp)]
            self._step_copies = []
            self._refresh_block_tables()   # from_state marks every slot
        self._step_stats = None
        self._step_audit = None
        self.slot_req = [None] * self.cfg.max_slots
        self.queue = []
        self._requests = {}
        self.drafter.reset()
        for rd in snap["requests"]:
            r = Request(rd["rid"], rd["prompt"], rd["max_new_tokens"],
                        arrival=rd.get("arrival", 0.0))
            r.slot = rd["slot"]
            r.row = rd.get("row")
            r.prefilled = rd["prefilled"]
            r.generated = list(rd["generated"])
            r.deadline = rd.get("deadline")
            r.first_token_time = rd.get("first_token_time")
            r.finish_time = rd.get("finish_time")
            r.last_used = rd.get("last_used", 0)
            r.cached_tokens = rd.get("cached_tokens", 0)
            r.num_preemptions = rd.get("num_preemptions", 0)
            r.fail_count = rd.get("fail_count", 0)
            r.retry_at = rd.get("retry_at", 0)
            if r.slot is not None:
                self.slot_req[r.slot] = r
            self.queue.append(r)
            self._requests[r.rid] = r
        self.obs.emit("restore", step=self.step_count)
        return self

    # ------------------------------------------------------- client surface
    def set_replica(self, replica: Optional[int]):
        """Stamp this engine as replica ``replica`` of a cluster: the id
        rides on every step record and event from now on."""
        self.replica = replica
        self.obs.replica = replica

    def prefix_probe(self, tokens: List[int]) -> int:
        """Longest indexed prefix of ``tokens`` over the dp rows, in
        tokens, without the LRU bump; 0 when prefix caching is off."""
        if self.prefix_rows is None or len(tokens) < 2:
            return 0
        best = 0
        for idx in self.prefix_rows:
            m = idx.match(tokens, max_tokens=len(tokens) - 1, bump=False)
            best = max(best, len(m))
        return best * self.cfg.block_size

    def _queued_block_demand(self) -> int:
        """Blocks the unadmitted queue will need (``_route``'s pricing)."""
        return sum(blocks_for_tokens(q.total_tokens + 1, self.cfg.block_size)
                   for q in self.queue if q.slot is None)

    def stats(self) -> EngineStats:
        """The ``ServingClient`` summary of the engine's serving state,
        frozen at a step boundary."""
        return EngineStats(
            steps=self.step_count,
            queue_depth=sum(1 for q in self.queue if q.slot is None),
            active=len(self.active),
            preemptions=self.preemptions,
            config_counts=self.config_counts,
            paged=self.paged,
            paged_disabled_reason=self.paged_disabled_reason,
            dp=self.dp,
            block_size=self.cfg.block_size,
            blocks_per_row=self.kv.num_blocks_per_row if self.paged else 0,
            free_blocks=self.kv.num_free_blocks if self.paged else 0,
            queued_block_demand=self._queued_block_demand(),
            prefix=self.prefix_stats,
            blocks=self.block_accounting(),
            replica=self.replica)

    def drain(self, max_steps: int = 10000, release_cache: bool = True):
        """Graceful shutdown: shed the requests that never held a slot,
        finish the in-flight ones, accept nothing new (a later request is
        shed at once), and shed whatever the step budget leaves queued.
        With ``release_cache`` the prefix pins go too, so afterwards
        ``block_accounting()`` reads ``used == pinned == 0``."""
        self.draining = True
        for r in [q for q in self.queue if q.slot is None
                  and q.num_preemptions == 0 and not q.generated]:
            self._retire(r, FinishReason.SHED)
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        for r in list(self.queue):
            self._retire(r, FinishReason.SHED)
        if release_cache and self.prefix_rows is not None:
            for idx in self.prefix_rows:
                idx.evict(len(idx))
        return self
