"""``Router``: N ``ShiftEngine`` replicas behind one typed serving API (the
port's copy of ``repro.cluster.router``).

The replicas are engines built on one ``Model`` (``launch.serve.
build_cluster``): each steps a pool of its own over the shared weights and
has its own step tables (on the card, its own CUDA graph pool). They run
in one process, each at world size 1, stepped one after the other.

The Router owns the replicas and implements the same
:class:`repro_torch.engine.api.ServingClient` protocol an engine does, so a
caller cannot tell one replica from eight (N=1 is a drop-in wrapper and
is tested bit-identical to a bare engine). Everything goes through the
engine *facade* — ``submit``/``cancel``/``step``/``stream``/``stats``
plus the migration surface — never through engine private state.

Routing policies (``routing=``):

* ``"affinity"`` (default) — probe each replica's prefix index with the
  non-bumping ``prefix_probe`` and send the request where the longest
  prefix already lives (ties broken by load). Requests whose prefix is
  not committed anywhere yet are memoized by their first chain key, so a
  burst of same-prefix arrivals sticks to one replica *before* the first
  prefill commits — that is what makes a shared prefix prefill once
  cluster-wide instead of once per replica.
* ``"round-robin"`` — strict modulo assignment (the A/B baseline).
* ``"least-loaded"`` — the engine's dp-row routing signal lifted to
  replicas: queued block demand minus free blocks (queue depth + active
  for dense engines), lowest index wins ties.

Rebalancing: every ``rebalance_every`` steps the Router compares replica
loads and, when the spread reaches ``rebalance_skew`` requests, migrates the
coldest migratable request from the most- to the least-loaded replica as a
typed block-granular plan (:mod:`repro_torch.cluster.migration`): extract
on the source (read-only; the payload is a copy of the request's blocks on
the card), admit on the destination, write the payload in place, release on
the source (decrement-not-free). The source is only touched after the
destination holds the data, so a failed admit aborts with nothing lost.
Exactly-once delivery across the move is enforced by the Router's
:class:`~repro_torch.ft.recovery.DeliveryLog` — ``poll`` raises
``ReplayDivergence`` if a migrated request's stream ever disagrees with what
was already delivered.
"""
from __future__ import annotations

import json
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from ..cache.prefix_index import PrefixIndex
from ..engine.api import ClusterStats
from ..ft.recovery import DeliveryLog
from ..obs import MetricsRegistry, merge_snapshots, schema
from .migration import TransferOp, build_transfer_plan

ROUTING_POLICIES = ("affinity", "round-robin", "least-loaded")


class Router:
    def __init__(self, engines: Sequence, routing: str = "affinity",
                 rebalance_every: int = 8, rebalance_skew: int = 2,
                 affinity_cap: int = 1024):
        if not engines:
            raise ValueError("Router needs at least one engine")
        if routing not in ROUTING_POLICIES:
            raise ValueError(
                f"unknown routing policy {routing!r} (one of "
                f"{ROUTING_POLICIES})")
        if affinity_cap < 1:
            raise ValueError("affinity_cap must be >= 1")
        self.engines = list(engines)
        self.routing = routing
        self.rebalance_every = rebalance_every
        self.rebalance_skew = rebalance_skew
        for i, eng in enumerate(self.engines):
            eng.set_replica(i)
        self._owner: Dict[int, int] = {}      # rid -> replica index
        self._rr = 0                          # round-robin cursor
        # first-chain-key -> replica: affinity for prefixes submitted but
        # not yet committed to any replica's index (see module docstring).
        # LRU-bounded at ``affinity_cap`` entries: adversarial prefix
        # churn evicts the coldest memo instead of growing without bound
        # (a lost memo only costs one extra cross-replica prefill).
        self.affinity_cap = affinity_cap
        self.affinity_evictions = 0
        self._affinity: "OrderedDict[int, int]" = OrderedDict()
        self._delivery = DeliveryLog()
        self.steps = 0
        self.migrations = 0
        self.migrated_blocks = 0
        self.transfer_log: List[Tuple[TransferOp, ...]] = []

    # ----------------------------------------------------------- routing
    def _load(self, i: int) -> float:
        st = self.engines[i].stats()
        if st.paged:
            return st.queued_block_demand - st.free_blocks
        return st.queue_depth + st.active

    def _least_loaded(self) -> int:
        return min(range(len(self.engines)),
                   key=lambda i: (self._load(i), i))

    def _prefix_key(self, prompt: Sequence[int]) -> Optional[int]:
        bs = self.engines[0].cfg.block_size
        if len(prompt) < bs:
            return None
        return next(PrefixIndex.chain_keys(prompt, bs, 1))

    def _route(self, req) -> int:
        n = len(self.engines)
        if n == 1:
            return 0
        if self.routing == "round-robin":
            i = self._rr % n
            self._rr += 1
            return i
        if self.routing == "affinity":
            probes = [eng.prefix_probe(req.prompt) for eng in self.engines]
            best = max(probes)
            if best > 0:
                cands = [i for i, p in enumerate(probes) if p == best]
                return min(cands, key=lambda i: (self._load(i), i))
            key = self._prefix_key(req.prompt)
            if key is not None and key in self._affinity:
                self._affinity.move_to_end(key)       # LRU bump
                return self._affinity[key]
            i = self._least_loaded()
            if key is not None:
                self._affinity[key] = i
                while len(self._affinity) > self.affinity_cap:
                    self._affinity.popitem(last=False)
                    self.affinity_evictions += 1
            return i
        return self._least_loaded()

    # ------------------------------------------------------ ServingClient
    def submit(self, req) -> int:
        if req.rid in self._owner:
            raise ValueError(f"rid {req.rid} already submitted")
        i = self._route(req)
        self._owner[req.rid] = i
        return self.engines[i].submit(req)

    def cancel(self, rid: int) -> bool:
        i = self._owner.get(rid)
        if i is None:
            return False
        return self.engines[i].cancel(rid)

    def step(self) -> bool:
        """One cluster iteration: every replica steps (no short-circuit —
        replica k's idleness must not starve replica k+1), then the
        periodic skew check may migrate one request."""
        progressed = [eng.step() for eng in self.engines]
        self.steps += 1
        if (self.rebalance_every and len(self.engines) > 1
                and self.steps % self.rebalance_every == 0):
            self.rebalance()
        return any(progressed)

    def stream(self, rid: int) -> List[int]:
        i = self._owner.get(rid)
        return self.engines[i].stream(rid) if i is not None else []

    def request(self, rid: int):
        """The LIVE request object, wherever it currently runs. After a
        migration the submitter's original object is stale (the request
        lives on in the destination engine's copy) — read state through
        this, ``stream``, or ``delivered``, never a kept reference."""
        i = self._owner.get(rid)
        return self.engines[i].request(rid) if i is not None else None

    def stats(self) -> ClusterStats:
        return ClusterStats(
            replicas=tuple(eng.stats() for eng in self.engines),
            routing=self.routing, steps=self.steps,
            migrations=self.migrations,
            migrated_blocks=self.migrated_blocks,
            affinity_evictions=self.affinity_evictions)

    # ------------------------------------------------- delivery (exactly-once)
    def poll(self) -> Dict[int, List[int]]:
        """Release each request's undelivered token suffix. The log spans
        migrations — a request polls under the same rid wherever it lives,
        and any disagreement with already-delivered tokens raises
        ``ReplayDivergence`` (the bit-identical guarantee)."""
        reqs = [self.engines[i].request(rid)
                for rid, i in self._owner.items()]
        return self._delivery.poll([r for r in reqs if r is not None])

    def delivered(self, rid: int) -> List[int]:
        return self._delivery.delivered(rid)

    def run_until_idle(self, max_steps: int = 10000) -> None:
        """Step the cluster until every replica is idle (or ``max_steps``),
        polling delivery each iteration so replay checks run while work
        is still in flight."""
        for _ in range(max_steps):
            self.poll()
            self.step()
            if all(st.queue_depth == 0 and st.active == 0
                   for st in (eng.stats() for eng in self.engines)):
                break
        self.poll()

    def drain(self, max_steps: int = 10000, release_cache: bool = True):
        """Graceful shutdown: every replica finishes its in-flight decodes
        and sheds its queue (the engines' typed terminal outcomes), then
        the final token suffixes are delivered."""
        for eng in self.engines:
            eng.drain(max_steps=max_steps, release_cache=release_cache)
        self.poll()

    # --------------------------------------------------------- migration
    def owner(self, rid: int) -> Optional[int]:
        return self._owner.get(rid)

    def migrate(self, rid: int,
                dst_replica: int) -> Optional[Tuple[TransferOp, ...]]:
        """Move one live request to ``dst_replica``. Returns the applied
        transfer plan, or None when the request is not migratable or the
        destination cannot take it (either way the source is untouched)."""
        src_i = self._owner.get(rid)
        if src_i is None or src_i == dst_replica:
            return None
        src = self.engines[src_i]
        dst = self.engines[dst_replica]
        export = src.extract_request(rid)
        if export is None:
            return None
        dst_blocks = dst.admit_migrated(export["state"], export["n_blocks"])
        if dst_blocks is None:
            return None                      # abort: source never touched
        ops = build_transfer_plan(export, dst_blocks, src_i, dst_replica)
        dst.write_blocks(dst_blocks, export["payload"])
        src.release_migrated(rid)
        self._owner[rid] = dst_replica
        self.migrations += 1
        self.migrated_blocks += export["n_blocks"]
        self.transfer_log.append(ops)
        return ops

    def rebalance(self) -> Optional[Tuple[TransferOp, ...]]:
        """Migrate the coldest migratable request from the most- to the
        least-loaded replica when the load spread (queued + active
        requests) reaches ``rebalance_skew``. At most one move per call —
        rebalancing is a nudge, not a reshuffle."""
        if len(self.engines) < 2:
            return None
        sts = [eng.stats() for eng in self.engines]
        loads = [st.queue_depth + st.active for st in sts]
        src_i = max(range(len(loads)), key=lambda i: (loads[i], -i))
        dst_i = min(range(len(loads)), key=lambda i: (loads[i], i))
        if loads[src_i] - loads[dst_i] < self.rebalance_skew:
            return None
        for rid in self.engines[src_i].migratable():
            ops = self.migrate(rid, dst_i)
            if ops is not None:
                return ops
        return None

    # ----------------------------------------------- elastic resharding
    # Router-driven merge/split: drain a replica's requests onto a peer
    # (mid-decode streams move with their KV through the migration data
    # plane; queued and mid-prefill requests resubmit and recompute), then
    # reshard the emptied/widened replica onto its new layout. Everything
    # goes through the engine facade — the same surface migrate() uses.
    def reshard_replica(self, i: int, layout, groups=None):
        """Reshard replica ``i`` onto ``layout`` between iterations (the
        engine's validate-then-mutate protocol; raises
        :class:`~repro_torch.engine.ReshardError` with the replica
        untouched when the new geometry cannot hold its live requests).
        ``groups``: the new grid's process groups, in place of the
        reference's ``mesh`` (the port's reshard keeps the world size)."""
        return self.engines[i].reshard(layout, groups=groups)

    def move_request(self, rid: int, dst_replica: int) -> bool:
        """Move one live request to ``dst_replica`` by whatever means its
        state allows: block-granular KV migration for mid-decode requests,
        release-and-resubmit (recompute on the destination, same stream —
        the preemption path's determinism) for queued or mid-prefill
        ones. False when the request is unknown, terminal, or already
        there."""
        if self.migrate(rid, dst_replica) is not None:
            return True
        src_i = self._owner.get(rid)
        if src_i is None or src_i == dst_replica:
            return False
        src = self.engines[src_i]
        req = src.request(rid)
        if req is None or req.finish_reason is not None:
            return False
        src.release_migrated(rid)
        # recompute-style reset (what preemption does): the destination
        # re-prefills prompt+generated and continues the stream
        req.row = None
        req.slot = None
        req.prefilled = 0
        req.cached_tokens = 0
        req.pc_blocks, req.pc_parent = 0, None
        req.inflight_keys = []
        self.engines[dst_replica].submit(req)
        self._owner[rid] = dst_replica
        return True

    def merge_replicas(self, dst: int, src: int) -> int:
        """Drain every live request off replica ``src`` onto ``dst`` (the
        low-traffic half of an elastic merge: empty one replica so its
        chips can join the other's mesh). Returns how many requests
        moved; ``src`` stays in the cluster and keeps serving anything
        that could not move."""
        if src == dst:
            raise ValueError("merge needs two distinct replicas")
        moved = 0
        for rid in sorted(r for r, i in self._owner.items() if i == src):
            req = self.engines[src].request(rid)
            if req is None or req.finish_reason is not None:
                continue
            if self.move_request(rid, dst):
                moved += 1
        return moved

    def split_replica(self, src: int, dst: int,
                      fraction: float = 0.5) -> int:
        """Move ``fraction`` of replica ``src``'s live requests to ``dst``
        (the high-traffic half of an elastic split: populate a freshly
        narrowed replica). Deterministic: highest rids move first.
        Returns how many requests moved."""
        if src == dst:
            raise ValueError("split needs two distinct replicas")
        live = sorted(
            rid for rid, i in self._owner.items()
            if i == src
            and (req := self.engines[src].request(rid)) is not None
            and req.finish_reason is None)
        take = live[len(live) - int(len(live) * fraction):]
        return sum(1 for rid in reversed(take)
                   if self.move_request(rid, dst))

    # ----------------------------------------------------- observability
    def counter_total(self, name: str) -> float:
        """Cluster-wide counter total (summed over replicas)."""
        return sum(eng.obs.registry.counter_total(name)
                   for eng in self.engines)

    def merged_registry(self) -> MetricsRegistry:
        merged = merge_snapshots(
            [eng.obs.registry.snapshot() for eng in self.engines])
        return MetricsRegistry().load_state(merged)

    def dump(self) -> dict:
        """One obs dump for the whole cluster: merged metrics, and the
        replicas' events/steps interleaved in time order — every record
        already carries its ``replica`` stamp, so consumers
        (``repro.obs.report``, the trace exporter) need no translation."""
        events = [dict(ev) for eng in self.engines
                  for ev in eng.obs.events.events]
        events.sort(key=lambda ev: (ev.get("ts", 0.0),
                                    ev.get("replica", -1)))
        steps = [dict(rec) for eng in self.engines
                 for rec in eng.obs.step_records]
        steps.sort(key=lambda rec: (rec.get("t_start", 0.0),
                                    rec.get("replica", -1)))
        return {"schema_version": schema.SCHEMA_VERSION,
                "source": "cluster",
                "metrics": merge_snapshots(
                    [eng.obs.registry.snapshot() for eng in self.engines]),
                "events": events,
                "events_dropped": sum(eng.obs.events.dropped
                                      for eng in self.engines),
                "steps": steps}

    def write_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.dump(), f, indent=1, sort_keys=True)

    def write_prometheus(self, path: str):
        with open(path, "w") as f:
            f.write(self.merged_registry().to_prometheus())
