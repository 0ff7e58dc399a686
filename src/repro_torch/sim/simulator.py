"""Event-driven serving simulator (the port's copy of
``repro.sim.simulator``).

Replays a request trace against an engine model (continuous batching +
chunked prefill, mixed prefill+decode iterations by default — matching
``ShiftEngine``'s paged path — or serialized prefill-OR-decode with
``mixed=False``; ``prefix_cache=True`` additionally models hash-indexed
prefix reuse: annotated shared prompt spans prefill once per replica,
their blocks are charged once, and later requests start at the first
uncached token) whose per-iteration latency comes from the roofline
CostModel. Reproduces the paper's latency/throughput experiments (Figs
7/9/10/12/13/14/17, Table 5) without GPUs: the *mechanism* (scheduling,
padding, config switching) is simulated exactly; only iteration wall time
is modeled.

DP runs n independent single-chip-group replicas with free-block-aware
routing (least outstanding block demand, matching the engine's per-dp-row
request routing); TP/SP/Shift run one group over all chips.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.cache import blocks_for_tokens
from repro_torch.ft.faults import FaultPlan
from repro_torch.obs import Observability
from repro_torch.roofline.terms import H100
from repro_torch.spec import SpecConfig, SuffixDrafter
from .costmodel import CostModel, Strategy

# ``best_config`` names its winner in roofline terms ("sp" | "tp"); the
# engine's compiled configs call the same two points "base" (SP,TP) and
# "shift" (pure TP). Dumps from both emitters use the engine vocabulary so
# reports and traces line up.
_SHIFT_CONFIG = {"sp": "base", "tp": "shift"}


@dataclass
class SimRequest:
    rid: int
    arrival: float
    n_in: int
    n_out: int
    # shared-prefix annotation: the first ``prefix_len`` prompt tokens are
    # identical across every request with the same ``prefix_id`` (e.g. a
    # shared system prompt). With ``ServeSim(prefix_cache=True)`` those
    # tokens prefill once per replica and later requests skip them.
    prefix_id: int = -1
    prefix_len: int = 0
    # speculative decoding: the request's output TOKEN VALUES, drafted
    # against by the same SuffixDrafter the engine runs (deterministic
    # acceptance for A/B). Empty -> ServeSim synthesizes a periodic
    # stream from the rid when spec_k > 0; ignored when spec is off.
    out_stream: tuple = ()
    # outcome
    start: float = -1.0
    first_token: float = -1.0
    finish: float = -1.0
    finish_reason: str = ""           # engine FinishReason vocabulary:
    #                                   ok|timeout|cancelled|shed|failed
    prefilled: int = 0
    decoded: int = 0
    shared_blocks: int = 0            # KV blocks this request maps shared
    # fault-tolerance state, mirroring the engine's recompute-retry
    fail_count: int = 0
    retry_at: int = 0

    @property
    def ttft(self):
        return self.first_token - self.arrival

    @property
    def tpot(self):
        if self.n_out <= 1 or self.finish < 0:
            return 0.0
        return (self.finish - self.first_token) / max(self.n_out - 1, 1)

    @property
    def completion(self):
        return self.finish - self.arrival


@dataclass
class ReplicaState:
    active: List[SimRequest] = field(default_factory=list)
    queue: List[SimRequest] = field(default_factory=list)
    t: float = 0.0
    busy_tokens: float = 0.0
    idx: int = 0                      # replica index (dp row analogue)
    # prefix_id -> resident shared KV blocks (counted once, like the
    # engine's index-pinned blocks); populated when a seeding request
    # finishes prefilling the shared span
    resident: dict = field(default_factory=dict)


class ServeSim:
    def __init__(self, cost: CostModel, strategy: str, n_chips: int = 8,
                 max_concurrent: int = 64, prefill_chunk: int = 2048,
                 kv_capacity_tokens: Optional[int] = None,
                 kv_block_size: int = 16, mixed: bool = True,
                 prefix_cache: bool = False,
                 faults: Optional[FaultPlan] = None,
                 deadline_s: Optional[float] = None, max_queue: int = 0,
                 shed_policy: str = "reject-newest",
                 quarantine_after: int = 3, retry_backoff: int = 2,
                 replicas: Optional[int] = None,
                 routing: str = "least-loaded",
                 spec_k: int = 0, spec_ngram: int = 3):
        self.cost = cost
        self.strategy = strategy
        self.n = n_chips
        # multi-replica serving mirror of the cluster Router: ``replicas``
        # overrides the strategy-derived replica count (each replica is an
        # independent serving group) and ``routing`` selects the Router's
        # policy A/B — "affinity" (hard preference for the replica that
        # already holds the prefix), "round-robin", or the default
        # "least-loaded" (block-demand signal with soft prefix credit,
        # the pre-cluster behavior).
        if routing not in ("least-loaded", "affinity", "round-robin"):
            raise ValueError(f"unknown routing policy {routing!r}")
        self.routing = routing
        self.chunk = prefill_chunk
        self.max_conc = max_concurrent
        self.block_size = kv_block_size
        # fault-tolerance knobs, same vocabulary (and defaults) as the
        # engine's EngineConfig: a FaultPlan keyed by the sim's global step
        # index, per-request deadlines, a bounded queue with a shed policy,
        # and recompute-retry with quarantine. A (plan, trace) pair can be
        # replayed against engine and sim for a like-for-like fault A/B.
        if shed_policy not in ("reject-newest", "evict-longest-queued"):
            raise ValueError(f"unknown shed_policy {shed_policy!r}")
        self.faults = faults
        self.deadline_s = deadline_s
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.quarantine_after = quarantine_after
        self.retry_backoff = retry_backoff
        # prefix_cache=True models the engine's hash-indexed prefix reuse:
        # requests annotated with (prefix_id, prefix_len) skip the shared
        # span's prefill after a seeding request has written it, and the
        # shared blocks are charged ONCE per replica (block-granular, like
        # the index pins) instead of per request. Unreferenced resident
        # prefixes are evicted when admission runs out of blocks.
        self.prefix_cache = prefix_cache
        # mixed=True (default, matching ShiftEngine's paged path): prefill
        # chunks and decode tokens share one iteration, costed as a single
        # pass by the roofline model. mixed=False replays the serialized
        # prefill-OR-decode engine: an iteration that takes prefill tokens
        # makes no decode progress (the TPOT interference being measured).
        self.mixed = mixed
        # speculative decoding mirror: decode rows carry up to spec_k
        # verified draft queries from the SAME self-drafting suffix model
        # the engine runs (repro_torch.spec.SuffixDrafter over each request's
        # out_stream), so acceptance — and therefore the A/B against a
        # non-speculative run — is deterministic. Draft queries are priced
        # via the cost model's n_spec (they share their row's KV read).
        if spec_k and not mixed:
            raise ValueError("spec_k > 0 requires mixed batching (verify "
                             "rides the mixed iteration, as in the engine)")
        self.spec = SpecConfig(k=spec_k, ngram_max=spec_ngram)
        self.drafter = SuffixDrafter(self.spec)
        n_rep = (replicas if replicas is not None
                 else (n_chips if strategy == "dp" else 1))
        if n_rep < 1:
            raise ValueError("replicas must be >= 1")
        self.reps = [ReplicaState(idx=i) for i in range(n_rep)]
        # the same observability surface the live engine drives: one metric
        # schema, the same step-record and event shapes. Timestamps are the
        # sim's virtual clock (``rep.t``), passed explicitly at every emit.
        self.obs = Observability("sim", now=lambda: 0.0)
        self.step_count = 0       # monotone across replicas (run in turn)
        if kv_capacity_tokens is None:
            hbm = self.cost.hw.hbm_bytes
            shard = 1 if strategy == "dp" else n_chips
            w = self.cost._weight_bytes() / shard
            per_block = self.cost.kv_bytes_per_block(kv_block_size) / shard
            kv_capacity_tokens = kv_block_size * int(
                max(hbm * 0.85 - w, hbm * 0.05) / per_block)
        # KV memory is committed at block granularity (matching the paged
        # engine): a sequence occupies ceil(len/bs) blocks, so the tail
        # slots of its last block are the fragmentation the sim charges.
        self.kv_cap_blocks = max(kv_capacity_tokens // kv_block_size, 1)
        self.kv_cap = self.kv_cap_blocks * kv_block_size
        self.trace_tokens: List = []   # (t, tokens_processed) for throughput

    # Legacy counter views, derived from the registry (single source of
    # truth — the sim no longer maintains parallel ad-hoc attributes).
    @property
    def iterations(self) -> int:
        return int(self.obs.registry.counter_total("steps_total"))

    @property
    def starved_steps(self) -> int:
        return int(self.obs.registry.counter_total(
            "decode_starved_steps_total"))

    @property
    def prefill_tokens_saved(self) -> int:
        return int(self.obs.registry.counter_total(
            "prefix_tokens_saved_total"))

    @property
    def prefix_evictions(self) -> int:
        return int(self.obs.registry.counter_total("prefix_evictions_total"))

    @property
    def shared_blocks_peak(self) -> int:
        return int(self.obs.registry.gauge_value("shared_blocks_peak"))

    def _used_blocks(self, rep: ReplicaState) -> int:
        """Blocks committed on a replica: per-request private blocks plus
        each resident shared prefix charged once (the engine's index pins)."""
        private = sum(
            blocks_for_tokens(r.prefilled + r.decoded, self.block_size)
            - r.shared_blocks for r in rep.active)
        return private + sum(rep.resident.values())

    def _matched_blocks(self, r: SimRequest) -> int:
        """Full blocks of ``r``'s shared span (capped at n_in - 1: the last
        prompt token always runs through the forward pass)."""
        if not self.prefix_cache or r.prefix_id < 0:
            return 0
        return min(r.prefix_len, r.n_in - 1) // self.block_size

    _REASON_COUNTER = {"timeout": "requests_timeout_total",
                       "cancelled": "requests_cancelled_total",
                       "shed": "requests_shed_total",
                       "failed": "requests_failed_total"}
    _REASON_EVENT = {"timeout": "timeout", "cancelled": "cancelled",
                     "shed": "shed", "failed": "quarantined"}

    def _terminal(self, r: SimRequest, reason: str, rep: ReplicaState):
        """Retire ``r`` with a non-OK terminal outcome (same counter/event
        vocabulary as the engine)."""
        r.finish = rep.t
        r.finish_reason = reason
        self.obs.inc(self._REASON_COUNTER[reason])
        self.obs.emit(self._REASON_EVENT[reason], step=self.step_count,
                      ts=rep.t, rid=r.rid, row=rep.idx, n_out=r.decoded,
                      fail_count=r.fail_count)

    def _fault_fired(self, fault, rep: ReplicaState):
        self.obs.inc("faults_injected_total", seam=fault.seam)
        self.obs.emit("fault_injected", step=self.step_count, ts=rep.t,
                      seam=fault.seam, fault_kind=fault.kind, row=fault.row)

    def _fail(self, r: SimRequest, rep: ReplicaState, requeue: bool = False):
        """Recompute-retry a request that was part of a failed step:
        cumulative fail count, quarantine at the limit, step-counted
        backoff otherwise; ``requeue`` additionally preempts it back to the
        queue with its prefill discarded (the route-fault path)."""
        r.fail_count += 1
        if r.fail_count >= self.quarantine_after:
            if r in rep.active:
                rep.active.remove(r)
            if r in rep.queue:
                rep.queue.remove(r)
            self._terminal(r, "failed", rep)
            return
        r.retry_at = self.step_count + 1 + self.retry_backoff * r.fail_count
        self.obs.inc("retries_total")
        self.obs.emit("retry", step=self.step_count, ts=rep.t, rid=r.rid,
                      fail_count=r.fail_count, retry_at=r.retry_at)
        if requeue and r in rep.active:
            rep.active.remove(r)
            r.prefilled = 0
            r.shared_blocks = 0
            rep.queue.append(r)

    def _expire_deadlines(self, rep: ReplicaState):
        if self.deadline_s is None:
            return
        for pool in (rep.active, rep.queue):
            for r in [x for x in pool
                      if rep.t > x.arrival + self.deadline_s]:
                pool.remove(r)
                self._terminal(r, "timeout", rep)

    def _enforce_queue_bound(self, rep: ReplicaState):
        while self.max_queue and len(rep.queue) > self.max_queue:
            if self.shed_policy == "reject-newest":
                victim = rep.queue.pop()
            else:                          # evict-longest-queued
                victim = min(rep.queue, key=lambda x: x.arrival)
                rep.queue.remove(victim)
            self._terminal(victim, "shed", rep)

    def _spec_stream(self, r: SimRequest) -> tuple:
        """The deterministic output stream a spec run drafts from and
        verifies against. Callers may pin ``out_stream`` on the request;
        otherwise a periodic stream is synthesized from the rid — mildly
        repetitive, like the agentic traces the paper targets, so the
        suffix drafter finds real matches without guaranteeing them."""
        if not r.out_stream:
            period = 3 + r.rid % 4
            r.out_stream = tuple(2 + (j % period) for j in range(r.n_out))
        return r.out_stream

    def _iteration(self, rep: ReplicaState):
        """Run one engine iteration on a replica; returns elapsed time."""
        self._expire_deadlines(rep)
        fault_alloc = fault_fwd = fault_route = None
        if self.faults is not None:
            fault_alloc = self.faults.at(self.step_count, "alloc")
            fault_fwd = self.faults.at(self.step_count, "forward")
            f = self.faults.at(self.step_count, "route")
            if f is not None and f.row == rep.idx:
                fault_route = f
        if fault_route is not None:
            # the replica "fails" for this step: every active request is
            # preempted back to the queue for recompute-retry
            self._fault_fired(fault_route, rep)
            for r in list(rep.active):
                self._fail(r, rep, requeue=True)
        if fault_alloc is not None:
            # the step's allocation attempt behaves as an OOM: no
            # admission this iteration
            self._fault_fired(fault_alloc, rep)
        # admit (block-granular, like the engine's admission control)
        kv_used = self._used_blocks(rep)
        for q in [] if fault_alloc is not None else list(rep.queue):
            if q.retry_at > self.step_count:
                continue
            matched = (self._matched_blocks(q)
                       if q.prefix_id in rep.resident else 0)
            need = blocks_for_tokens(q.n_in + 1, self.block_size) - matched
            if len(rep.active) >= self.max_conc:
                continue
            if kv_used + need > self.kv_cap_blocks:
                # reclaim resident prefixes no active request maps (the
                # engine's LRU eviction of unpinned index blocks)
                in_use = {r.prefix_id for r in rep.active
                          if r.shared_blocks > 0}
                for pid in list(rep.resident):
                    if kv_used + need <= self.kv_cap_blocks:
                        break
                    if pid not in in_use and pid != q.prefix_id:
                        freed = rep.resident.pop(pid)
                        kv_used -= freed
                        self.obs.inc("prefix_evictions_total")
                        self.obs.emit("prefix_evict", step=self.step_count,
                                      ts=rep.t, blocks=freed, row=rep.idx)
                if kv_used + need > self.kv_cap_blocks:
                    continue
            rep.active.append(q)
            rep.queue.remove(q)
            q.start = rep.t
            queue_s = max(rep.t - q.arrival, 0.0)
            self.obs.inc("requests_admitted_total")
            self.obs.observe("queue_seconds", queue_s)
            if matched:
                q.prefilled = matched * self.block_size
                q.shared_blocks = matched
                self.obs.inc("prefix_hits_total")
                self.obs.inc("prefix_tokens_saved_total", q.prefilled)
                self.obs.emit("prefix_hit", step=self.step_count, ts=rep.t,
                              rid=q.rid, row=rep.idx, blocks=matched,
                              tokens=q.prefilled)
            elif self.prefix_cache:
                self.obs.inc("prefix_misses_total")
            self.obs.emit("admitted", step=self.step_count, ts=rep.t,
                          rid=q.rid, row=rep.idx, queue_s=queue_s,
                          cached_tokens=q.prefilled)
            kv_used += need
        if not rep.active:
            if any(q.retry_at > self.step_count for q in rep.queue):
                # everything queued is inside a retry-backoff window: idle
                # tick instead of reporting an (apparently) drained replica
                rep.t += 1e-4
                self.step_count += 1
                return 1e-4
            return 0.0
        # chunked prefill + decode batch composition (requests inside a
        # retry-backoff window are not batched)
        batchable = [r for r in rep.active if r.retry_at <= self.step_count]
        n_ready = sum(1 for r in batchable
                      if r.prefilled >= r.n_in and r.decoded < r.n_out)
        n_prefill = 0
        takes = []                    # (req, tokens) — reverted on a fault
        for r in batchable:
            if r.prefilled < r.n_in:
                take = min(self.chunk - n_prefill, r.n_in - r.prefilled)
                if take <= 0:
                    break
                r.prefilled += take
                n_prefill += take
                takes.append((r, take))
        if self.prefix_cache:
            # a request that has prefilled past its shared span seeds the
            # prefix for later arrivals; its own blocks become the shared
            # copy (charged once via `resident`, not per request)
            for r in rep.active:
                mb = self._matched_blocks(r)
                if (mb and r.prefix_id not in rep.resident
                        and r.prefilled >= mb * self.block_size):
                    rep.resident[r.prefix_id] = mb
                    r.shared_blocks = mb
            self.obs.set_gauge_max("shared_blocks_peak",
                                   sum(rep.resident.values()))
        if not self.mixed and n_prefill:
            deco = []                  # serialized: prefill-priority step
        else:
            deco = [r for r in batchable if r.prefilled >= r.n_in
                    and r.decoded < r.n_out]
        n_decode = len(deco)
        if n_prefill == 0 and n_decode == 0:
            # every active request is inside its retry-backoff window:
            # idle tick so the virtual clock and step index advance past
            # the window instead of deadlocking the run loop
            rep.t += 1e-4
            self.step_count += 1
            return 1e-4
        # speculative mirror: draft from each decode row's own emitted
        # stream (the engine's self-drafting proposer, deterministically
        # reproduced over ``out_stream``), verify against what the row
        # WILL emit, and deliver 1 + accepted tokens this iteration. The
        # draft queries ride the same iteration (verify-in-one-pass), so
        # they are priced into the cost model via ``n_spec``.
        drafts: dict = {}
        accepted: dict = {}
        if self.spec.k and deco:
            for r in deco:
                budget = r.n_out - r.decoded - 1
                stream = self._spec_stream(r)
                d = self.drafter.propose(r.rid, list(stream[:r.decoded]),
                                         budget)
                if not d:
                    continue
                drafts[r.rid] = d
                ref = stream[r.decoded:r.decoded + len(d)]
                n_acc = 0
                for got, want in zip(d, ref):
                    if got != want:
                        break
                    n_acc += 1
                accepted[r.rid] = n_acc
        n_spec = sum(len(d) for d in drafts.values())
        n_accepted = sum(accepted.values())
        # the ACTUAL per-row contexts of this iteration — the
        # work-proportional kernel prices these, not s_max or a bucket
        ctxs = [r.prefilled + r.decoded for r in rep.active] or [1]
        ctx = int(np.mean(ctxs))

        if self.strategy == "shift":
            winner, dt = self.cost.best_config(n_prefill, n_decode + n_spec,
                                               ctx, self.n, ctx_lens=ctxs,
                                               n_spec=n_spec)
            cfgname = _SHIFT_CONFIG[winner]
        elif self.strategy == "dp":
            dt = self.cost.iteration_time(n_prefill, n_decode + n_spec, ctx,
                                          Strategy("dp", self.n),
                                          ctx_lens=ctxs, n_spec=n_spec)
            cfgname = "dp"
        else:
            dt = self.cost.iteration_time(n_prefill, n_decode + n_spec, ctx,
                                          Strategy(self.strategy, self.n),
                                          ctx_lens=ctxs, n_spec=n_spec)
            cfgname = self.strategy
        t0 = rep.t
        rep.t += dt
        if fault_fwd is not None:
            # poisoned forward: the iteration's time is spent (the launch
            # ran or failed — either way the step is lost) but it yields
            # no tokens; every batched request enters recompute-retry
            self._fault_fired(fault_fwd, rep)
            for r, take in takes:
                r.prefilled -= take
            self.obs.record_step({
                "step": self.step_count, "t_start": t0, "dur_s": dt,
                "config": cfgname, "prefill_tokens": 0, "decode_tokens": 0,
                "ready_decodes": n_ready, "failed": True,
                "attn_ctx_tokens": 0, "n_tokens": 0, "ctx_tokens": 0,
                "replica": rep.idx})
            self.obs.inc("failed_steps_total")
            self.step_count += 1
            batched = [x for x, _ in takes]
            batched += [r for r in deco if r not in batched]
            for r in batched:
                self._fail(r, rep)
            return dt
        self.trace_tokens.append((rep.t, n_prefill + n_decode + n_spec))
        rec = {
            "step": self.step_count, "t_start": t0, "dur_s": dt,
            "config": cfgname, "prefill_tokens": n_prefill,
            "decode_tokens": n_decode + n_accepted, "ready_decodes": n_ready,
            "attn_ctx_tokens": int(sum(ctxs)) if rep.active else 0,
            "n_tokens": n_prefill + n_decode + n_spec,
            "ctx_tokens": int(sum(ctxs)), "replica": rep.idx}
        if n_spec:
            rec["spec_tokens"] = n_spec
            rec["spec_proposed"] = n_spec
            rec["spec_accepted"] = n_accepted
            self.obs.inc("spec_proposed_total", n_spec)
            self.obs.inc("spec_accepted_total", n_accepted)
            for r in deco:
                if r.rid in drafts:
                    self.obs.observe("spec_accepted_per_row",
                                     accepted.get(r.rid, 0))
        self.obs.record_step(rec)
        self.step_count += 1
        for r in deco:
            r.decoded += 1 + accepted.get(r.rid, 0)
            if r.first_token < 0:
                r.first_token = rep.t
                ttft = r.first_token - r.arrival
                self.obs.observe("ttft_seconds", ttft)
                self.obs.emit("first_token", step=self.step_count, ts=rep.t,
                              rid=r.rid, ttft_s=ttft)
            if r.decoded >= r.n_out:
                self.drafter.drop(r.rid)
                r.finish = rep.t
                r.finish_reason = "ok"
                e2e = r.finish - r.arrival
                tpot = r.tpot if r.n_out > 1 else None
                self.obs.inc("requests_finished_total")
                self.obs.observe("e2e_seconds", e2e)
                if tpot is not None:
                    self.obs.observe("tpot_seconds", tpot)
                self.obs.emit(
                    "finish", step=self.step_count, ts=rep.t, rid=r.rid,
                    row=rep.idx, n_out=r.decoded, n_prompt=r.n_in,
                    ttft_s=r.first_token - r.arrival, tpot_s=tpot,
                    e2e_s=e2e, cached_tokens=r.shared_blocks
                    * self.block_size)
        rep.active = [r for r in rep.active if r.finish < 0]
        self.obs.set_gauge("queue_depth", len(rep.queue))
        self.obs.set_gauge("active_requests", len(rep.active))
        return dt

    def _route(self, reqs: List[SimRequest]) -> List[List[SimRequest]]:
        """Free-block-aware routing to replicas, mirroring the engine's
        per-dp-row admission (the row with the most allocatable blocks
        wins, ties to the lowest row). Replicas simulate independently, so
        the load signal is the block demand routed so far; with prefix
        caching a request whose shared span is already routed to a replica
        charges only its private blocks there — the sim analogue of the
        engine's ``can_allocate(cached_blocks=...)`` credit. Uniform
        traces degenerate to round-robin, so dp throughput is unchanged
        there; skewed traces now pile onto the emptiest replica exactly
        like the engine routes onto the emptiest row."""
        assign: List[List[SimRequest]] = [[] for _ in self.reps]
        load = [0] * len(self.reps)
        seen: List[set] = [set() for _ in self.reps]
        rr = 0
        for r in reqs:
            need = blocks_for_tokens(r.n_in + r.n_out + 1, self.block_size)

            def demand(i):
                if self.prefix_cache and r.prefix_id in seen[i]:
                    return need - self._matched_blocks(r)
                return need

            if self.routing == "round-robin":
                best = rr % len(self.reps)
                rr += 1
            elif (self.routing == "affinity" and self.prefix_cache
                    and r.prefix_id >= 0
                    and any(r.prefix_id in s for s in seen)):
                # hard affinity (the Router's policy): the request goes
                # where its prefix already lives, load be damned — ties
                # (prefix resident on several replicas) break by load
                owners = [i for i, s in enumerate(seen)
                          if r.prefix_id in s]
                best = min(owners, key=lambda i: (load[i], i))
            else:
                best = min(range(len(self.reps)),
                           key=lambda i: (load[i] + demand(i), i))
            assign[best].append(r)
            load[best] += demand(best)
            self.obs.emit("routed", step=self.step_count, ts=r.arrival,
                          rid=r.rid, row=best)
            if self.prefix_cache and r.prefix_id >= 0:
                seen[best].add(r.prefix_id)
        return assign

    def run(self, requests: List[SimRequest], t_end: Optional[float] = None):
        reqs = sorted(requests, key=lambda r: r.arrival)
        assign = self._route(reqs)
        for rep, rs in zip(self.reps, assign):
            pending = list(rs)
            while pending or rep.active or rep.queue:
                # move arrived requests into the queue
                while pending and pending[0].arrival <= rep.t:
                    q = pending.pop(0)
                    rep.queue.append(q)
                    self.obs.inc("requests_arrived_total")
                    self.obs.emit("queued", step=self.step_count,
                                  ts=q.arrival, rid=q.rid,
                                  prompt_tokens=q.n_in,
                                  max_new_tokens=q.n_out, arrival=q.arrival)
                    self._enforce_queue_bound(rep)
                if not rep.active and not rep.queue:
                    if pending:
                        rep.t = max(rep.t, pending[0].arrival)
                        continue
                    break
                if self._iteration(rep) == 0.0 and not pending:
                    break
                if t_end is not None and rep.t > t_end:
                    break
        return reqs


def _pct(xs, p):
    return float(np.percentile(xs, p)) if len(xs) else float("nan")


def simulate(cfg, trace, strategy: str, hw=None, n_chips: int = 8,
             **kw) -> dict:
    """Replay ``trace`` ((t, n_in, n_out[, prefix_id, prefix_len]) per
    request) under ``strategy`` ("dp", "tp", "sp" or "shift") on
    ``n_chips``, priced at ``hw`` (``H100`` when None); ``kw`` goes to
    ``ServeSim``. Returns the outcome, latency and throughput metrics."""
    cost = CostModel(cfg, hw=hw or H100)
    sim = ServeSim(cost, strategy, n_chips=n_chips, **kw)
    reqs = []
    for i, tr in enumerate(trace):
        t, ni, no = tr[:3]
        # optional shared-prefix annotation: (t, n_in, n_out, pid, plen)
        pid, plen = (int(tr[3]), int(tr[4])) if len(tr) > 3 else (-1, 0)
        reqs.append(SimRequest(i, t, ni, no, prefix_id=pid, prefix_len=plen))
    reqs = sim.run(reqs)
    done = [r for r in reqs if r.finish >= 0
            and r.finish_reason in ("", "ok")]
    outcomes = {}
    for r in reqs:
        key = r.finish_reason or ("ok" if r.finish >= 0 else "unfinished")
        outcomes[key] = outcomes.get(key, 0) + 1
    ttfts = [r.ttft for r in done if r.first_token >= 0]
    tpots = [r.tpot for r in done if r.n_out > 1]
    comps = [r.completion for r in done]
    # peak throughput: max tokens/s over 1s windows
    toks = sorted(sim.trace_tokens)
    peak, window, acc = 0.0, [], 0.0
    for t, n in toks:
        window.append((t, n))
        acc += n
        while window and window[0][0] < t - 1.0:
            acc -= window.pop(0)[1]
        peak = max(peak, acc)
    total_tokens = sum(r.n_in + r.decoded for r in done)
    makespan = max((r.finish for r in done), default=1e-9)
    return {
        "strategy": strategy, "n_done": len(done),
        "outcomes": outcomes,
        "iterations": sim.iterations,
        "starved_steps": sim.starved_steps,
        "prefill_tokens_saved": sim.prefill_tokens_saved,
        "shared_blocks_peak": sim.shared_blocks_peak,
        "prefix_evictions": sim.prefix_evictions,
        "ttft_p50_ms": 1e3 * _pct(ttfts, 50),
        "ttft_p99_ms": 1e3 * _pct(ttfts, 99),
        "tpot_p50_ms": 1e3 * _pct(tpots, 50),
        "completion_p50_s": _pct(comps, 50),
        "completion_p99_s": _pct(comps, 99),
        "peak_tput_tok_s": peak,
        "avg_tput_tok_s": total_tokens / makespan,
    }
