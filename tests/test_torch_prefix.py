"""The port's prefix cache and copy-on-write on the CPU, held to the
reference.

* The control plane: the index and manager cases of
  ``tests/test_prefix_cache.py`` with the same asserts, run on the port's
  ``BlockAllocator``/``PagedKVCache``/``PrefixIndex`` and, as a check of
  the mirror itself, on the reference's.
* The COW data plane: ``Model.copy_blocks`` against the reference's
  ``ShiftEngine._cow_body`` on the same random pool, bitwise, with one
  pair's destination another pair's source; then the fork + COW case: a
  12-token sequence forked, its half-full tail block copied for the fork,
  and both rows decoding different continuations in one pool, each stream
  equal to its own cold run and to the reference's.
* The engine: the reference's ``ShiftEngine`` and the port's with
  ``PrefixConfig(enabled=True)`` on the workloads of
  ``tests/test_prefix_cache.py`` (shared 16-token prefix; hits shorter and
  longer than a block; a preempted request re-matching its own prefix; an
  oversubscribed pool; the serialized paged iteration): equal streams,
  ``cached_tokens``, prefix stats, preemptions, config counts and block
  ledgers, no block held by a sequence at exit, and the warm streams equal
  to cold ones.

Reduced qwen3-8b at fp32 on the weights of ``tests/test_torch_engine.py``
(the reference's init with random norm scales, converted).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro import cache as jax_cache  # noqa: E402
from repro.core.policy import ThresholdPolicy as JaxPolicy  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import PrefixConfig as JaxPrefixConfig  # noqa: E402
from repro.engine import Request as JaxRequest  # noqa: E402
from repro.engine import ShiftEngine as JaxEngine  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import cache as port_cache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.engine.api import PrefixConfig  # noqa: E402
from repro_torch.models import Model  # noqa: E402

IMPLS = {"port": port_cache, "reference": jax_cache}


# ---------------------------------------------------------------------------
# the control plane: tests/test_prefix_cache.py's unit cases
# ---------------------------------------------------------------------------
def _kv_idx(C, num_blocks=16, bs=4, seqs=4, nmax=8):
    kv = C.PagedKVCache(num_blocks, bs, seqs, nmax)
    idx = C.PrefixIndex(bs, kv.allocator)
    kv.prefix_index = idx
    return kv, idx


def _chained_match_and_cap(C):
    kv, idx = _kv_idx(C)
    toks = list(range(100, 120))              # 20 tokens, bs=4 -> 5 blocks
    kv.ensure(0, 20)
    idx.commit(toks, 4, kv.seq_blocks(0))     # first 4 full blocks
    assert len(idx) == 4
    assert idx.match(toks) == kv.seq_blocks(0)[:4]
    assert idx.match(toks, max_tokens=11) == kv.seq_blocks(0)[:2]
    assert idx.match(toks[:3]) == []
    other = [999] * 4 + toks[4:]              # same chunks, other first block
    assert idx.match(other) == []


def _commit_is_idempotent_and_pins(C):
    kv, idx = _kv_idx(C)
    toks = list(range(8))
    kv.ensure(0, 8)
    b = kv.seq_blocks(0)
    assert idx.commit(toks, 2, b) == 2
    assert idx.commit(toks, 2, b) == 0        # re-commit: LRU bump only
    assert kv.allocator.ref_count(b[0]) == 2  # seq + index pin
    kv.free_seq(0)                            # decrement-not-free
    assert kv.allocator.ref_count(b[0]) == 1
    assert kv.num_used_blocks == 2
    assert idx.reclaimable() == 2
    assert idx.evict(8) == 2                  # leaf-first peeling
    assert kv.num_used_blocks == 0


def _eviction_is_leaf_first_lru(C):
    kv, idx = _kv_idx(C)
    a = list(range(12))                       # chain a0 -> a1 -> a2
    kv.ensure(0, 12)
    idx.commit(a, 3, kv.seq_blocks(0))
    b = list(range(50, 58))                   # 2 blocks, separate chain
    kv.ensure(1, 8)
    idx.commit(b, 2, kv.seq_blocks(1))
    kv.free_seq(0)
    kv.free_seq(1)
    idx.match(b)                              # bump chain b: a is now LRU
    assert idx.evict(1) == 1                  # evicts a's leaf a2, not a0
    assert len(idx.match(a)) == 2
    assert len(idx.match(b)) == 2


def _fork_then_free_decrements(C):
    kv, _ = _kv_idx(C)
    kv.ensure(0, 10)                          # 3 blocks (tail half-full)
    src_blocks = kv.seq_blocks(0)
    kv.fork(0, 1)
    assert kv.seq_blocks(1) == src_blocks
    assert all(kv.allocator.ref_count(b) == 2 for b in src_blocks)
    used = kv.num_used_blocks
    kv.free_seq(1)                            # preemption path: decrement
    assert kv.num_used_blocks == used
    assert all(kv.allocator.ref_count(b) == 1 for b in src_blocks)
    kv.free_seq(0)
    assert kv.num_used_blocks == 0


def _cow_on_append_to_shared_tail(C):
    kv, _ = _kv_idx(C)
    kv.ensure(0, 10)
    kv.fork(0, 1)
    t0 = kv.seq_blocks(0)
    ok, copies = kv.copy_on_write(1, 10, 11)  # token 10: the shared tail
    assert ok and len(copies) == 1
    src, dst = copies[0]
    assert src == t0[2] and dst not in t0
    assert kv.seq_blocks(1)[:2] == t0[:2]     # full blocks still shared
    assert kv.seq_blocks(1)[2] == dst
    assert kv.allocator.ref_count(src) == 1 == kv.allocator.ref_count(dst)
    ok, copies = kv.copy_on_write(1, 10, 12)  # now exclusive: a no-op
    assert ok and copies == []


def _cow_oom_leaves_state_unchanged(C):
    kv = C.PagedKVCache(num_blocks=4, block_size=4, max_seqs=2,
                        max_blocks_per_seq=3)
    kv.ensure(0, 12)                          # all 3 usable blocks
    kv.fork(0, 1)
    table_before = kv.table.copy()
    ok, copies = kv.copy_on_write(1, 8, 9)
    assert not ok and copies == []
    np.testing.assert_array_equal(kv.table, table_before)


def _can_allocate_no_double_count(C):
    kv = C.PagedKVCache(num_blocks=4, block_size=4, max_seqs=2,
                        max_blocks_per_seq=4)
    idx = C.PrefixIndex(4, kv.allocator)
    kv.prefix_index = idx
    toks = list(range(12))
    kv.ensure(0, 12)
    idx.commit(toks, 3, kv.seq_blocks(0))
    kv.free_seq(0)                            # 3 index-only entries, free 0
    matched = idx.match(toks, max_tokens=8)   # 2 blocks
    assert not kv.can_allocate(13, cached_blocks=matched)
    assert kv.can_allocate(12, cached_blocks=())
    assert not kv.can_allocate(13, cached_blocks=())


def _failed_alloc_does_not_drain(C):
    kv = C.PagedKVCache(num_blocks=4, block_size=4, max_seqs=2,
                        max_blocks_per_seq=4)
    idx = C.PrefixIndex(4, kv.allocator)
    kv.prefix_index = idx
    kv.ensure(0, 12)
    idx.commit(list(range(12)), 1, kv.seq_blocks(0))
    kv.free_seq(0)                            # 1 evictable entry, free 2
    assert not kv.ensure(1, 16)               # 4 > 2 free + 1 evictable
    assert len(idx) == 1 and idx.evictions == 0
    assert kv.ensure(1, 12)                   # 3 blocks: evicts the entry
    assert len(idx) == 0 and idx.evictions == 1


def _refcount_invariant_guards(C):
    kv, _ = _kv_idx(C)
    a = kv.allocator
    with pytest.raises(AssertionError):
        a.incref(C.BlockAllocator.NULL_BLOCK)
    blocks = a.alloc(1)
    a.free(blocks)
    with pytest.raises(AssertionError):
        a.decref(blocks[0])                   # double free
    kv.ensure(0, 4)
    kv.table[1, 2] = 7                        # stale id past n_mapped
    with pytest.raises(AssertionError):
        kv.fork(0, 1)


UNIT_CASES = [_chained_match_and_cap, _commit_is_idempotent_and_pins,
              _eviction_is_leaf_first_lru, _fork_then_free_decrements,
              _cow_on_append_to_shared_tail, _cow_oom_leaves_state_unchanged,
              _can_allocate_no_double_count, _failed_alloc_does_not_drain,
              _refcount_invariant_guards]


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("case", UNIT_CASES,
                         ids=[c.__name__.strip("_") for c in UNIT_CASES])
def test_cache_unit_cases(case, impl):
    case(IMPLS[impl])


# ---------------------------------------------------------------------------
# weights and engines
# ---------------------------------------------------------------------------
def _randomize_norms(tree, rng):
    return {k: (_randomize_norms(v, rng) if isinstance(v, dict)
                else rng.standard_normal(v.shape).astype(v.dtype)
                if k in ("scale", "q_norm", "k_norm") else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def weights():
    jm = build_model(reduced_cfg("qwen3-8b"), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    tree = _randomize_norms(tree, np.random.default_rng(0))
    return jm, jax.tree.map(jnp.asarray, tree), from_jax_params(
        tree, get_config("qwen3-8b").reduced())


@pytest.fixture(scope="module")
def port_model(weights):
    model = Model(get_config("qwen3-8b").reduced(), device="cpu",
                  dtype=torch.float32)
    model.load_params(weights[2])
    return model


def _ecfg(prefix, **kw):
    """``tests/test_prefix_cache.py``'s ``_mk_engine`` settings."""
    return {**dict(max_slots=4, s_max=64, prefill_chunk=8, threshold=4,
                   block_size=8), **kw}, prefix


def _serve(side, weights, port_model, script, prefix=True, **kw):
    """Run ``script`` (a list of batches of (rid, prompt, max_new); each
    batch is submitted, then the engine runs to idle) on one engine of
    ``side`` ("reference" or "port"). Returns per-request (generated,
    cached_tokens), the engine's facts and the engine."""
    ekw, prefix = _ecfg(prefix, **kw)
    if side == "reference":
        jm, params, _ = weights
        eng = JaxEngine(jm, jm, params, params,
                        JaxEngineConfig(prefix=JaxPrefixConfig(prefix), **ekw),
                        policy=JaxPolicy(4))
        make = JaxRequest
    else:
        eng = ShiftEngine(port_model, EngineConfig(
            prefix=PrefixConfig(prefix), **ekw))
        make = Request
    reqs = []
    for batch in script:
        new = [make(rid, list(p), max_new_tokens=n) for rid, p, n in batch]
        for r in new:
            eng.submit(r)
        eng.run_until_idle(max_steps=5000)
        reqs += new
    assert all(len(r.generated) == r.max_new_tokens for r in reqs)
    facts = {"stats": eng.prefix_stats.as_dict(),
             "ledger": eng.block_accounting().as_dict(),
             "preemptions": eng.preemptions,
             "configs": dict(eng.config_counts), "steps": eng.step_count}
    return ({r.rid: (tuple(r.generated), r.cached_tokens) for r in reqs},
            facts, eng)


SHARED = list(range(1, 17))                   # 2 full blocks of 8
BASE = list(range(1, 21))
SCRIPTS = {
    "shared-prefix": [[(0, SHARED + [99, 98], 6)],
                      [(1, SHARED + [77, 76, 75], 6)]],
    "hits-shorter-and-longer-than-a-block": [
        [(0, BASE, 6)], [(1, BASE[:4] + [200, 201, 202, 203, 204], 6)],
        [(2, BASE + [300, 301], 6)], [(3, BASE[:17], 6)]],
    # pairwise distinct prompts (a shared one would wait for the in-flight
    # writer and relieve the pressure); 7 usable blocks
    "preempted-rematches-own-prefix": [
        [(i, list(range(100 * i + 1, 100 * i + 10 + i)), 6)
         for i in range(6)]],
    "oversubscribed": [[(i, list(range(1, 13 + i % 5)), 6)
                        for i in range(32)]],
    "serialized": [[(0, SHARED + [9], 6)], [(1, SHARED + [5, 6], 6)]],
}
ENGINE_KW = {"preempted-rematches-own-prefix": {"num_blocks": 8},
             "oversubscribed": {"max_slots": 16, "num_blocks": 25},
             "serialized": {"mixed": False}}


@pytest.fixture(scope="module")
def runs(weights, port_model):
    """Every script on the reference's and the port's prefix-cache engines
    and on the port's cold (prefix-off) engine; one engine per run."""
    out = {}
    for name, script in SCRIPTS.items():
        kw = ENGINE_KW.get(name, {})
        out[name] = {side: _serve(side, weights, port_model, script, **kw)
                     for side in ("reference", "port")}
        out[name]["cold"] = _serve("port", weights, port_model, script,
                                   prefix=False, **kw)
    return out


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_engine_prefix_cache_matches_reference(runs, name):
    """Equal streams, cached tokens, prefix stats (hits, misses, tokens
    saved, evictions, COW copies, entries), preemptions, config counts,
    steps and block ledgers; at exit no block is held by a sequence (used
    == pinned), and evicting every entry frees the whole pool."""
    ref, port = runs[name]["reference"], runs[name]["port"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    eng = port[2]
    led = eng.block_accounting()
    assert led.used == led.pinned == port[1]["stats"]["entries"]
    assert all(eng.kv.allocator.ref_count(b) == 1 for b in eng.prefix.blocks())
    assert eng.prefix.reclaimable() == led.pinned
    assert eng.prefix.evict(led.pinned) == led.pinned
    assert eng.block_accounting().used == 0
    assert eng.kv.num_free_blocks == eng.kv.num_blocks - 1
    assert not any(eng._inflight)         # every row's registry


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_engine_warm_streams_equal_cold(runs, name):
    warm, cold = runs[name]["port"], runs[name]["cold"]
    assert {r: g for r, (g, _) in warm[0].items()} == \
        {r: g for r, (g, _) in cold[0].items()}
    assert all(c == 0 for _, c in cold[0].values())
    assert cold[1]["stats"]["hits"] == cold[1]["stats"]["entries"] == 0


def test_engine_shared_prefix_prefills_only_uncached_tokens(runs):
    """The second request maps the 2 shared blocks (16 cached tokens),
    allocates only its private blocks, and its prefill steps carry only
    its 3 uncached prompt tokens (what the policy prices)."""
    res, facts, eng = runs["shared-prefix"]["port"]
    assert res[1][1] == 16 and res[0][1] == 0
    assert facts["stats"]["hits"] == 1
    assert facts["stats"]["tokens_saved"] == 16
    cold_steps = runs["shared-prefix"]["cold"][1]["steps"]
    assert facts["steps"] < cold_steps
    pre = [r["prefill_tokens"] for r in eng.step_log if r["prefill_tokens"]]
    assert pre[-1] <= 3


def test_engine_hits_capped_below_the_last_token(runs):
    res = runs["hits-shorter-and-longer-than-a-block"]["port"][0]
    assert res[1][1] == 0                     # 4 shared tokens: < 1 block
    assert res[2][1] == 16                    # 20 shared: 2 full blocks
    assert res[3][1] == 16                    # 17-token prompt: cap len-1


def test_engine_pressure_evicts_and_rehits(runs):
    """Under pressure pins are reclaimed (not leaked) and re-prefills hit
    the index; the tight pool preempts."""
    assert runs["preempted-rematches-own-prefix"]["port"][1]["preemptions"] > 0
    for name in ("preempted-rematches-own-prefix", "oversubscribed"):
        stats = runs[name]["port"][1]["stats"]
        assert stats["evictions"] > 0 and stats["hits"] > 0


def test_serialized_engine_prefix_parity(runs):
    """The serialized iteration on the paged pool takes the prefix path:
    the second request's 16 shared tokens come from the cache, and its
    stream equals the cold one and the reference's."""
    res = runs["serialized"]["port"]
    assert not res[2].mixed
    assert res[0][1][1] == 16


# ---------------------------------------------------------------------------
# the COW data plane
# ---------------------------------------------------------------------------
def test_copy_blocks_matches_reference_cow_body():
    """``Model.copy_blocks`` against the reference's ``_cow_body`` on one
    random pool, bitwise: pairs (3 -> 5), (5 -> 6), (1 -> 2), where block
    5 is one pair's destination and another's source, so it must give
    block 6 its bytes from before the copy."""
    cfg = get_config("qwen3-8b").reduced()
    model = Model(cfg, device="cpu", dtype=torch.float32)
    pool = model.init_paged_cache(8, 8)
    rng = np.random.default_rng(3)
    k = rng.standard_normal(tuple(pool.k.shape)).astype(np.float32)
    v = rng.standard_normal(tuple(pool.v.shape)).astype(np.float32)
    pool.k.copy_(torch.from_numpy(k))
    pool.v.copy_(torch.from_numpy(v))
    addr = (pool.k.data_ptr(), pool.v.data_ptr())
    src, dst = [3, 5, 1], [5, 6, 2]
    model.copy_blocks(src, dst)
    want = JaxEngine._cow_body({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                               jnp.asarray(src, jnp.int32),
                               jnp.asarray(dst, jnp.int32))
    assert (pool.k.data_ptr(), pool.v.data_ptr()) == addr    # in place
    for got, w in ((pool.k, want["k"]), (pool.v, want["v"])):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))
    np.testing.assert_array_equal(pool.k[:, 6].numpy(), k[:, 5])
    np.testing.assert_array_equal(pool.k[:, 5].numpy(), k[:, 3])


def _fork_cow_streams(model, kv_cls, prompt, conts, steps=3):
    """Prefill ``prompt`` into slot 0 (bs 8, tail block half-full), fork
    it into slot 1, copy-on-write the tail for slot 1, then decode
    ``conts`` on both rows in one pool. Returns the two streams."""
    bs, nmax, n = 8, 4, len(prompt)
    model.init_paged_cache(8, bs)
    kv = kv_cls(8, bs, 2, nmax)
    kv.ensure(0, n)
    bt = np.zeros((2, nmax), np.int32)
    bt[0, :2] = kv.seq_blocks(0)
    toks = np.zeros((2, n), np.int32)
    toks[0] = prompt
    model.prefill(toks, [0, 0], bt)
    kv.fork(0, 1)
    ok, copies = kv.copy_on_write(1, n, n + 1)
    assert ok and len(copies) == 1
    model.copy_blocks(*zip(*copies))
    bt[1, :2] = kv.seq_blocks(1)
    t, lens = np.asarray(conts, np.int32), np.full((2,), n, np.int32)
    streams = [[], []]
    for _ in range(steps):
        t, _ = model.decode(t, lens, bt)
        t = t.numpy().astype(np.int32)
        for r in (0, 1):
            streams[r].append(int(t[r]))
        lens = lens + 1
    return streams


def _cold_stream(model, prompt, first, steps=3):
    bs, nmax, n = 8, 4, len(prompt)
    model.init_paged_cache(8, bs)
    bt = np.zeros((1, nmax), np.int32)
    bt[0, :2] = (1, 2)
    model.prefill(np.asarray(prompt, np.int32)[None], [0], bt)
    t, lens, out = np.asarray([first], np.int32), np.full((1,), n, np.int32), []
    for _ in range(steps):
        t, _ = model.decode(t, lens, bt)
        t = t.numpy().astype(np.int32)
        out.append(int(t[0]))
        lens = lens + 1
    return out


def _reference_cold_stream(jm, params, prompt, first, steps=3):
    bs, nmax, n = 8, 4, len(prompt)
    pool = jm.init_paged_cache(8, bs)
    bt = np.zeros((1, nmax), np.int32)
    bt[0, :2] = (1, 2)
    _, pool = jm.prefill_fn(paged=True)(
        params, pool, jnp.asarray(prompt, jnp.int32)[None],
        jnp.zeros((1,), jnp.int32), jnp.asarray(bt))
    dec = jm.decode_fn(paged=True)
    t, lens, out = jnp.asarray([first], jnp.int32), \
        jnp.full((1,), n, jnp.int32), []
    for _ in range(steps):
        t, pool = dec(params, pool, t, lens, jnp.asarray(bt))
        t = t.astype(jnp.int32)
        out.append(int(t[0]))
        lens = lens + 1
    return out


def test_fork_cow_streams_independent(weights, port_model):
    """The fork's writes never reach the original's tail block: each
    row's stream equals its own cold run, the port's and the
    reference's."""
    jm, params, _ = weights
    prompt = np.random.default_rng(1).integers(
        1, port_model.cfg.vocab_size, 12).tolist()
    conts = (7, 11)
    got = _fork_cow_streams(port_model, port_cache.PagedKVCache, prompt,
                            conts)
    for stream, first in zip(got, conts):
        assert stream == _cold_stream(port_model, prompt, first)
        assert stream == _reference_cold_stream(jm, params, prompt, first)
    assert got[0] != got[1]


def test_prefix_cache_needs_the_paged_pool(port_model):
    with pytest.raises(ValueError, match="prefix caching requires"):
        ShiftEngine(port_model, EngineConfig(
            paged=False, mixed=False, prefix=PrefixConfig(enabled=True)))
