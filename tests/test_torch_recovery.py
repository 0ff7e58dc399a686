"""Snapshots, restore and crash recovery in the port against the
reference.

* The reference's ``tests/test_ft_recovery.py`` on the port: the crash
  drill with a ``DeliveryLog`` (beside the reference's own drill: equal
  streams, delivered tokens and counters), the fallback past a corrupted
  snapshot, validation that leaves the engine untouched, and the request
  state a snapshot carries. The port's cache checks: a cache of another
  shape, type or rank is refused before anything changes, and a restore
  copies into the engine's own cache tensors.
* The observability state across a snapshot (``tests/test_obs.py``), on
  the mixed and the serialized iterations: the port's dumps equal the
  reference's under one injected clock.
* The prefix index across a snapshot (``tests/test_prefix_cache.py``).
* The control plane's state pairs (``tests/test_paged_cache.py``,
  ``tests/test_paged_dp.py``): state dicts equal to the reference's after
  the same operations, and equal again after a round trip through JSON.
* A snapshot the reference took restores into the port
  (``convert.from_jax_cache`` for the cache): the port's continuation
  equals the reference's, streams and whole dump.

Reduced qwen3-8b at fp32, the reference's weights through
``from_jax_params``; each engine has its own copy of one injected clock.
"""
import itertools
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro import cache as jcache  # noqa: E402
from repro import engine as jeng  # noqa: E402
from repro import ft as jft  # noqa: E402
from repro.core.policy import ThresholdPolicy as JaxPolicy  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import cache as pcache  # noqa: E402
from repro_torch import engine as peng  # noqa: E402
from repro_torch import ft as pft  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_cache, from_jax_params  # noqa: E402
from repro_torch.core.policy import ThresholdPolicy  # noqa: E402
from repro_torch.engine import FinishReason  # noqa: E402
from repro_torch.ft import (DeliveryLog, SnapshotError,  # noqa: E402
                            corrupt_snapshot)
from repro_torch.models import Model  # noqa: E402

SIDES = ("reference", "port")


class Always:
    def __init__(self, b):
        self.b = b

    def use_base(self, n, p=0):
        return self.b


class Clock:
    """An injected clock: ``start + calls`` milliseconds."""

    def __init__(self, start=0):
        self.calls = itertools.count(start)
        self.n = start

    def __call__(self):
        self.n = next(self.calls)
        return self.n * 1e-3


@pytest.fixture(scope="module")
def weights():
    jm = build_model(reduced_cfg("qwen3-8b"), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    cfg = get_config("qwen3-8b").reduced()
    model = Model(cfg, device="cpu", dtype=torch.float32)
    model.load_params(from_jax_params(tree, cfg))
    return jm, jax.tree.map(jnp.asarray, tree), model


class Side:
    """One package's engine types; engines of 4 slots, s_max 64, chunk 8."""

    def __init__(self, side, weights):
        self.side, self.weights = side, weights
        self.pkg = jeng if side == "reference" else peng
        self.ft = jft if side == "reference" else pft
        self.Request = self.pkg.Request

    def engine(self, now=None, faults=None, policy=None, block_size=16,
               prefix_cache=False, mixed=None, paged=None, threshold=None,
               **fault_kw):
        jm, params, model = self.weights
        kw = {} if threshold is None else {"threshold": threshold}
        cfg = self.pkg.EngineConfig(
            max_slots=4, s_max=64, prefill_chunk=8, block_size=block_size,
            mixed=mixed, paged=paged,
            prefix=self.pkg.PrefixConfig(enabled=prefix_cache),
            fault=self.pkg.FaultConfig(**fault_kw), **kw)
        now = now or Clock()
        if policy is None:
            policy = Always(True)
        elif isinstance(policy, int):
            policy = (JaxPolicy if self.side == "reference"
                      else ThresholdPolicy)(policy)
        if self.side == "reference":
            return jeng.ShiftEngine(jm, jm, params, params, cfg,
                                    policy=policy, now=now, faults=faults)
        return peng.ShiftEngine(model, cfg, policy=policy, now=now,
                                faults=faults)

    def reqs(self, n=2, n_new=6):
        return [self.Request(i, list(range(1, 10 + i)), max_new_tokens=n_new)
                for i in range(n)]


def _dump(eng):
    return json.dumps(eng.obs.dump(), sort_keys=True)


def _clean_streams(s):
    eng = s.engine()
    reqs = s.reqs()
    for r in reqs:
        eng.add_request(r)
    eng.run_until_idle()
    assert all(r.finish_reason == "ok" for r in reqs)
    return {r.rid: list(r.generated) for r in reqs}


# ---------------------------------------------------------------------------
# the reference's recovery cases, each a function of one side
# ---------------------------------------------------------------------------
def crash_drill(s):
    ref = _clean_streams(s)
    eng = s.engine(auto_snapshot_every=3)
    log = DeliveryLog()                 # the frontend: owns the cursors
    reqs = s.reqs()
    for r in reqs:
        eng.add_request(r)
    live = {r.rid: r for r in reqs}
    for _ in range(7):                  # snapshots at steps 3 and 6
        eng.step()
        log.poll(live.values())
    assert len(eng.retained_snapshots()) == 2
    pre_crash = {rid: log.delivered(rid) for rid in live}
    assert any(pre_crash.values())      # tokens were delivered pre-crash
    # the crash: only the ring and the delivery log survive
    ring = eng.retained_snapshots()
    del eng
    eng2 = s.engine(auto_snapshot_every=3)
    eng2.recover(ring)
    assert eng2.obs.registry.counter_total("recoveries_total") == 1
    live2 = {r.rid: r for r in eng2.queue}
    assert set(live2) == set(live)      # no request lost in the crash
    while eng2.queue or eng2.active:
        eng2.step()
        log.poll(live2.values())        # raises ReplayDivergence
    for rid, r in live2.items():
        assert r.finish_reason == "ok"
        assert log.delivered(rid) == ref[rid]
        assert list(r.generated) == ref[rid]
    return {"pre_crash": pre_crash,
            "delivered": {rid: log.delivered(rid) for rid in live},
            "dump": _dump(eng2)}


def corrupt_fallback(s):
    ref = _clean_streams(s)
    plan = s.ft.FaultPlan([s.ft.Fault(6, "snapshot")])
    eng = s.engine(auto_snapshot_every=3)
    eng.faults = plan
    reqs = s.reqs()
    for r in reqs:
        eng.add_request(r)
    for _ in range(7):
        eng.step()
    ring = eng.retained_snapshots()
    assert ring[-1].get("corrupted")
    assert plan.fired
    eng2 = s.engine()
    eng2.recover(ring)
    assert eng2.step_count == 3         # fell back to the older capture
    live = {r.rid: r for r in eng2.queue}
    eng2.run_until_idle()
    streams = {rid: list(r.generated) for rid, r in live.items()}
    assert streams == ref
    return {"streams": streams, "dump": _dump(eng2)}


@pytest.mark.parametrize("drill", [crash_drill, corrupt_fallback],
                         ids=["crash", "corrupt_fallback"])
def test_recovery_drill_matches_reference(weights, drill):
    want, got = (drill(Side(side, weights)) for side in SIDES)
    for key in want:
        assert got[key] == want[key], key


def test_recover_with_nothing_valid_raises(weights):
    eng = Side("port", weights).engine()
    with pytest.raises(SnapshotError, match="no valid snapshot"):
        eng.recover([])
    with pytest.raises(SnapshotError, match="no valid snapshot"):
        eng.recover([{"not": "a snapshot"}, 42])


def _fingerprint(eng):
    return (eng.step_count, eng.lens.copy().tolist(),
            [r.rid for r in eng.queue],
            [None if r is None else r.rid for r in eng.slot_req],
            eng.kv.state_dict()["allocators"],
            [t.clone() for t in eng._cache_tensors().values()])


def _same(a, b):
    return a[:5] == b[:5] and all(torch.equal(x, y)
                                  for x, y in zip(a[5], b[5]))


def _stepped(s, n=3):
    eng = s.engine()
    reqs = s.reqs()
    for r in reqs:
        eng.add_request(r)
    for _ in range(n):
        eng.step()
    return eng, reqs


def _other_rank(snap):
    return {**snap, "rank": 1}


def _shape(snap):
    return {**snap, "cache": {k: v[:, :-1] for k, v in snap["cache"].items()}}


def _dtype(snap):
    return {**snap, "cache": {k: v.double() for k, v in snap["cache"].items()}}


def _missing_tensor(snap):
    return {**snap, "cache": {"k": snap["cache"]["k"]}}


@pytest.mark.parametrize("mangle", [
    lambda s: "not a dict",
    lambda s: {k: v for k, v in s.items() if k != "cache"},
    lambda s: {k: v for k, v in s.items() if k != "lens"},
    lambda s: {k: v for k, v in s.items() if k != "requests"},
    lambda s: corrupt_snapshot(dict(s), 0),
    lambda s: {**s, "requests": [{"rid": 0}]},            # truncated entry
    lambda s: {**s, "requests": s["requests"]
               + [{**s["requests"][0], "slot": 999}]},    # slot out of range
    # the port's cache checks: another rank's shard, shape or type
    _other_rank, _shape, _dtype, _missing_tensor,
])
def test_restore_rejects_malformed_snapshot_unmodified(weights, mangle):
    eng, reqs = _stepped(Side("port", weights))
    snap = eng.snapshot()
    # move the cache on, so that a half-applied restore would show
    eng.step()
    before = _fingerprint(eng)
    with pytest.raises(SnapshotError):
        eng.restore(mangle(snap))
    assert _same(_fingerprint(eng), before)   # untouched by the failure
    eng.run_until_idle()
    assert all(r.finish_reason is FinishReason.OK for r in reqs)


def test_restore_rejects_duplicate_slots(weights):
    eng, _ = _stepped(Side("port", weights), 1)
    snap = eng.snapshot()
    admitted = [rd for rd in snap["requests"] if rd["slot"] is not None]
    assert len(admitted) >= 2
    admitted[1]["slot"] = admitted[0]["slot"]
    with pytest.raises(SnapshotError, match="duplicate"):
        eng.restore(snap)


def test_restore_rejects_dp_mismatch(weights):
    eng = Side("port", weights).engine()
    snap = eng.snapshot()
    snap["kv"] = dict(snap["kv"], dp=2)
    with pytest.raises(SnapshotError, match="dp"):
        eng.restore(snap)


def test_snapshot_roundtrips_ft_request_state(weights):
    s = Side("port", weights)
    eng = s.engine(now=time.monotonic, deadline_s=500.0)
    reqs = s.reqs()
    for r in reqs:
        r.arrival = time.monotonic()
        eng.add_request(r)
    eng.step()
    reqs[0].fail_count = 2
    reqs[0].retry_at = 9
    eng2 = s.engine(now=time.monotonic)
    eng2.restore(eng.snapshot())
    got = {r.rid: r for r in eng2.queue}
    assert got[0].fail_count == 2 and got[0].retry_at == 9
    assert got[0].deadline == reqs[0].deadline is not None


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_restore_copies_into_the_engines_cache(weights, paged):
    """A restore copies the snapshot into the engine's own cache tensors
    (the addresses a step table's CUDA graphs hold), and the snapshot is
    a copy: stepping on does not change it."""
    s = Side("port", weights)
    kw = {} if paged else {"paged": False, "mixed": False}
    eng = s.engine(**kw)
    for r in s.reqs():
        eng.add_request(r)
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    saved = {k: v.clone() for k, v in snap["cache"].items()}
    tensors = eng._cache_tensors()
    ptrs = {k: t.data_ptr() for k, t in tensors.items()}
    eng.run_until_idle()
    assert all(torch.equal(snap["cache"][k], saved[k]) for k in saved)
    assert any(not torch.equal(tensors[k], saved[k]) for k in saved)
    captures = eng.deploy.captures
    eng.restore(snap)
    now = eng._cache_tensors()
    assert all(now[k] is tensors[k] and now[k].data_ptr() == ptrs[k]
               for k in tensors)
    assert all(torch.equal(now[k], saved[k]) for k in saved)
    assert eng.deploy.captures == captures
    assert set(snap["cache"]) == ({"k", "v"} if paged else set(tensors))
    assert snap["rank"] == 0


# ---------------------------------------------------------------------------
# the observability state across a snapshot (tests/test_obs.py)
# ---------------------------------------------------------------------------
def obs_across_snapshot(s, mixed):
    eng = s.engine(prefix_cache=True, mixed=mixed, policy=4, threshold=4)
    for i in range(3):
        eng.add_request(s.Request(i, list(range(1, 14 + 2 * i)),
                                  max_new_tokens=6))
    for _ in range(4):
        eng.step()
    arrived = eng.obs.registry.counter_total("requests_arrived_total")
    steps_before = eng.obs.registry.counter_total("steps_total")
    snap = eng.snapshot()
    eng2 = s.engine(prefix_cache=True, mixed=mixed, policy=4, threshold=4)
    eng2.restore(snap)
    assert eng2.step_count == eng.step_count
    eng2.run_until_idle()
    reg = eng2.obs.registry
    assert reg.counter_total("requests_arrived_total") == arrived == 3
    assert reg.counter_total("steps_total") >= steps_before
    assert reg.counter_total("requests_finished_total") == 3
    ev = eng2.obs.events
    for rid in range(3):
        kinds = [e["kind"] for e in ev.for_request(rid)]
        assert "queued" in kinds and "finish" in kinds
    kinds_all = [e["kind"] for e in ev.events]
    assert "snapshot" in kinds_all and "restore" in kinds_all
    steps = [r["step"] for r in eng2.step_log]
    assert steps == sorted(steps) and len(set(steps)) == len(steps)
    return {"streams": {rid: eng2.stream(rid) for rid in range(3)},
            "dump": _dump(eng2)}


@pytest.mark.parametrize("mixed", [None, False], ids=["mixed", "serialized"])
def test_snapshot_restore_carries_obs_state(weights, mixed):
    want, got = (obs_across_snapshot(Side(side, weights), mixed)
                 for side in SIDES)
    assert got == want


def serialized_resume(s):
    def fresh():
        eng = s.engine(mixed=False, policy=4, threshold=4)
        for i in range(2):
            eng.add_request(s.Request(i, list(range(1, 16)),
                                      max_new_tokens=5))
        return eng

    ref = fresh()
    ref.run_until_idle()
    want = {r: ref.stream(r) for r in range(2)}
    eng = fresh()
    for _ in range(3):
        eng.step()
    eng2 = s.engine(mixed=False, policy=4, threshold=4)
    eng2.restore(eng.snapshot())
    eng2.run_until_idle()
    got = {r: eng2.stream(r) for r in range(2)}
    assert got == want
    assert eng2.obs.registry.counter_total("requests_finished_total") == 2
    return {"streams": got, "dump": _dump(eng2)}


def test_serialized_snapshot_after_restore_resumes_stream(weights):
    want, got = (serialized_resume(Side(side, weights)) for side in SIDES)
    assert got == want


# ---------------------------------------------------------------------------
# the prefix index across a snapshot (tests/test_prefix_cache.py)
# ---------------------------------------------------------------------------
def prefix_across_snapshot(s):
    def mk():
        return s.engine(block_size=8, prefix_cache=True, policy=4,
                        threshold=4)

    def run_one(eng, rid, prompt):
        r = s.Request(rid, prompt, max_new_tokens=6)
        eng.add_request(r)
        eng.run_until_idle(max_steps=2000)
        return r

    shared = list(range(1, 17))
    eng = mk()
    run_one(eng, 0, shared + [40])
    snap = eng.snapshot()
    eng2 = mk()
    eng2.restore(snap)
    r = run_one(eng2, 1, shared + [41, 42])
    assert r.cached_tokens == 16              # hits survive the round trip
    assert eng2.prefix_stats["entries"] == eng.prefix_stats["entries"]
    return {"stream": list(r.generated),
            "stats": eng2.prefix_stats.as_dict(),
            "ledger": eng2.block_accounting().as_dict(),
            "dump": _dump(eng2)}


def test_engine_snapshot_restores_prefix_index(weights):
    want, got = (prefix_across_snapshot(Side(side, weights))
                 for side in SIDES)
    assert got == want


# ---------------------------------------------------------------------------
# the control plane's state pairs
# ---------------------------------------------------------------------------
def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def _json_trip(state):
    return json.loads(json.dumps(_jsonable(state)))


def _cache_ops(mod, dp):
    """One sequence of operations on a cache with a prefix index per row:
    allocation in every row, a commit, a shared prefix, a fork, a free."""
    kv = mod.PagedKVCache(9, 4, 2 * dp, 4, dp=dp)
    idx = [mod.PrefixIndex(4, kv.allocators[r]) for r in range(dp)]
    kv.prefix_indices = list(idx)
    toks = list(range(1, 13))
    kv.ensure(0, 7)
    idx[0].commit(toks, 1, kv.seq_blocks(0))
    kv.assign_prefix(1, idx[0].match(toks, max_tokens=4))
    if dp > 1:
        kv.ensure(3, 13)
        idx[1].commit(toks, 3, kv.seq_blocks(3))
    kv.free_seq(1)
    kv.fork(0, 1)
    return kv, idx


@pytest.mark.parametrize("dp", [1, 2])
def test_state_pairs_equal_reference(dp):
    kv, idx = _cache_ops(pcache, dp)
    jkv, jidx = _cache_ops(jcache, dp)
    mine, ref = kv.state_dict(), jkv.state_dict()
    assert _jsonable(mine) == _jsonable(ref)
    assert [i.state_dict() for i in idx] == [i.state_dict() for i in jidx]
    for a, b in zip(kv.allocators, jkv.allocators):
        assert a.state_dict() == b.state_dict()
    # a JSON round trip of every state gives an equal object
    kv2 = pcache.PagedKVCache.from_state(_json_trip(mine))
    assert _jsonable(kv2.state_dict()) == _jsonable(mine)
    assert kv2.table.dtype == kv.table.dtype == np.int32
    for r in range(dp):
        a2 = pcache.BlockAllocator.from_state(
            _json_trip(kv.allocators[r].state_dict()))
        assert a2.state_dict() == kv.allocators[r].state_dict()
        i2 = pcache.PrefixIndex.from_state(
            _json_trip(idx[r].state_dict()), kv2.allocators[r])
        assert i2.state_dict() == idx[r].state_dict()
        assert len(i2) == len(idx[r])
        assert [e.children for e in i2._entries.values()] == \
            [e.children for e in idx[r]._entries.values()]
    # the restored manager is usable, and rebuilds the engine's mirror
    assert kv2.take_dirty() == set(range(2 * dp))
    assert kv2.ensure(2 * dp - 1, 4)


def test_state_roundtrip():
    kv = pcache.PagedKVCache(num_blocks=9, block_size=4, max_seqs=2,
                             max_blocks_per_seq=4)
    kv.ensure(0, 7)
    kv2 = pcache.PagedKVCache.from_state(kv.state_dict())
    assert kv2.seq_blocks(0) == kv.seq_blocks(0)
    assert kv2.num_free_blocks == kv.num_free_blocks
    assert kv2.ensure(1, 4)                   # allocator state usable


def test_dp_kv_state_roundtrip():
    kv = pcache.PagedKVCache(num_blocks=9, block_size=4, max_seqs=4,
                             max_blocks_per_seq=4, dp=2)
    kv.ensure(0, 7)                            # row 0: 2 blocks
    kv.ensure(3, 13)                           # row 1: 4 blocks
    kv2 = pcache.PagedKVCache.from_state(kv.state_dict())
    assert kv2.dp == 2 and kv2.slots_per_row == 2
    assert kv2.seq_blocks(0) == kv.seq_blocks(0)
    assert kv2.seq_blocks(3) == kv.seq_blocks(3)
    for r in (0, 1):
        assert kv2.allocators[r].num_free == kv.allocators[r].num_free
    assert kv2.ensure(1, 4) and kv2.ensure(2, 4)
    assert kv2.row_of(1) == 0 and kv2.row_of(2) == 1
    assert kv2.table3.shape == (2, 2, 4)


# ---------------------------------------------------------------------------
# a snapshot of the reference restores into the port
# ---------------------------------------------------------------------------
CROSS = {"mixed_prefix": dict(prefix_cache=True, block_size=8),
         "serialized_paged": dict(mixed=False),
         "serialized_dense": dict(paged=False, mixed=False)}


@pytest.mark.parametrize("case", sorted(CROSS))
def test_reference_snapshot_restores_into_port(weights, case):
    """The reference engine runs 4 steps and snapshots; its snapshot, the
    cache converted by ``from_jax_cache``, restores into a port engine
    and into a fresh reference engine, each with a clock that continues
    where the snapshotting engine's stopped. Both run to idle: equal
    streams and dumps, and the streams of an uninterrupted run."""
    kw = CROSS[case]
    ref_side, port_side = (Side(side, weights) for side in SIDES)
    prompts = [list(range(1, 19)), list(range(1, 17)) + [40, 41],
               list(range(60, 71))]

    def reqs(s):
        return [s.Request(i, p, max_new_tokens=6)
                for i, p in enumerate(prompts)]

    clean = ref_side.engine(**kw)
    for r in reqs(ref_side):
        clean.add_request(r)
    clean.run_until_idle()
    want = {rid: clean.stream(rid) for rid in range(len(prompts))}

    clock = Clock()
    eng = ref_side.engine(now=clock, **kw)
    for r in reqs(ref_side):
        eng.add_request(r)
    for _ in range(4):
        eng.step()
    snap = eng.snapshot()
    cfg = get_config("qwen3-8b").reduced()
    cache = jax.tree.map(np.asarray, snap["cache"])
    converted = dict(snap, cache=from_jax_cache(cache, cfg,
                                                paged=kw.get("paged", True)))
    out = []
    for side, s in ((ref_side, snap), (port_side, converted)):
        e = side.engine(now=Clock(clock.n + 1), **kw)
        e.restore(s)
        e.run_until_idle()
        out.append(({rid: e.stream(rid) for rid in range(len(prompts))},
                    e.block_accounting().as_dict(), _dump(e)))
    assert out[1] == out[0]
    assert out[1][0] == want


def test_restore_refuses_a_stale_engine(weights):
    """An engine whose model's cache a later engine initialised anew
    refuses to restore (its steps would run on the other cache), and the
    later engine restores the first one's snapshot."""
    s = Side("port", weights)
    eng, reqs = _stepped(s)
    snap = eng.snapshot()
    other = s.engine()
    with pytest.raises(RuntimeError, match="re-initialised"):
        eng.restore(snap)
    other.restore(snap)
    other.run_until_idle()
    assert [other.stream(r.rid) for r in reqs] == \
        list(_clean_streams(s).values())
