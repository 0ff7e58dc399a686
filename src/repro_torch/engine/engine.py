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
(``cancel``), SHED (the bounded queue's shed policy, or ``drain``). A
straggler watchdog flags steps slower than ``straggler_factor`` times the
rolling median.

Not in this slice: fault injection (FAILED, retries), snapshots and
reshard.
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
from repro_torch.ft import StragglerWatchdog
from repro_torch.models.model import Model
from repro_torch.obs import NullObs, Observability
from repro_torch.spec import SpecConfig, SuffixDrafter
from .api import (BlockLedger, FaultConfig, ObsConfig, PrefixConfig,
                  PrefixStats)
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
    def max_queue(self) -> int:
        return self.fault.max_queue

    @property
    def shed_policy(self) -> str:
        return self.fault.shed_policy

    @property
    def deadline_s(self) -> Optional[float]:
        return self.fault.deadline_s

    @property
    def straggler_factor(self) -> float:
        return self.fault.straggler_factor


class ShiftEngine:
    def __init__(self, model: Model, cfg: Optional[EngineConfig] = None,
                 shift: Optional[Model] = None, policy=None,
                 now=time.monotonic):
        cfg = cfg or EngineConfig()
        if cfg.shed_policy not in ("reject-newest", "evict-longest-queued"):
            raise ValueError(f"unknown shed_policy {cfg.shed_policy!r}")
        if cfg.fault.auto_snapshot_every:
            raise NotImplementedError(
                "auto_snapshot_every: snapshots are not ported yet (ROADMAP "
                "Queue 1 item 3)")
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
            model.init_paged_cache(row_blocks, cfg.block_size)
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
            model.init_cache(cfg.max_slots, cfg.s_max)
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
        self.watchdog = StragglerWatchdog(factor=cfg.straggler_factor)
        self.draining = False           # drain(): no fresh admissions
        # the one observability surface: metrics registry, lifecycle event
        # log and the rolling per-step audit records the views read
        self.obs = (Observability("engine", window=cfg.obs.window, now=now,
                                  event_cap=cfg.obs.event_cap)
                    if cfg.obs.enabled else NullObs(now=now))
        for r, idx in enumerate(self.prefix_rows or []):
            idx.on_evict = self._make_evict_observer(r)
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

    def _admissible(self, r: Request) -> bool:
        """A draining engine re-admits only requests that held a slot
        before (preempted work finishes; fresh work is shed)."""
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
                if not self.kv.ensure(slot, req.total_tokens + 1):
                    # eviction reclaimed less than the probe reckoned: roll
                    # the admission back (assign_prefix's refs go with
                    # free_seq) and keep the request queued
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
            if self.kv.ensure(req.slot, n_tokens):
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
                 and not r.done]
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
            if r.slot is None or r.done or self._prefill_done(r):
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
        nxt = self.deploy.forward_at(mode, n_last)(toks, qlen, offs,
                                                   bt).cpu().numpy()
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
        todo = [r for r in self.active if not self._prefill_done(r)]
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
        self.deploy.prefill[mode](toks, offs, bt)
        self._wait_for_device()
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
                 if self._prefill_done(r) and not r.done]
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
        nxt = self.deploy.decode[mode](toks, lens, bt).cpu().numpy()
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
        self._expire_deadlines()
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
        return progressed

    def run_until_idle(self, max_steps: int = 10000):
        for _ in range(max_steps):
            if not self.step():
                if not self.queue and not self.active:
                    break
        return self

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
