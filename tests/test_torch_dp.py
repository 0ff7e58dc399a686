"""The port's data parallelism on ``Layout(dp=2)``: per-row paged pools,
free-block-aware sticky routing and the DP token gather, held to the
reference's dp=2 engine on ``make_mesh((2, 1, 1))`` and to two routed dp=1
engines of the port.

The control plane runs in this process: ``PagedKVCache(dp=2)`` against the
reference's on one sequence of operations, the row isolation of prefix
eviction, and ``Layout``'s rank maps against the reference's mesh. One
two-rank job (``launch.mesh.run_ranks`` over gloo, a module-scoped
fixture) runs every engine scenario and returns numpy results:

* the mixed iteration with the prefix cache and the serialized paged
  iteration (the reference's ``test_dp2_engine_matches_routed_dp1_engines``):
  streams and rows equal the reference's dp=2 engine and two port dp=1
  engines fed the routed split; prefix stats and block ledgers equal the
  reference's;
* row isolation under pressure (``test_dp_row_preemption_isolation``);
* spec-on equals spec-off (``test_spec_bitwise_identical_dp2``);
* routing of a burst and after a preemption, against the reference's rows;
* one mixed step's logits (each rank its rows') within 1e-4 of the
  reference's;
* the dense cache at dp=2: reduced qwen3-8b with ``paged=False``, and
  reduced mamba2-1.3b on its automatic fallback, against the reference's
  dp=2 engine;
* ``max_slots`` not divisible by dp, forced and automatic;
* the serve CLI's report of one rank of ``--dp 2``, with rank 0's metrics
  and trace files;
* under one fake clock (each engine its own), every rank's observability
  dump, report and Chrome trace JSON-equal to the reference's dp=2
  engine's.

Weights: the reference's ``init_params(key(0))`` with random norm scales,
converted and cut per rank, as in ``tests/test_torch_layout.py``. JAX is
imported only in this process, inside fixtures and tests.
"""
import argparse
import contextlib
import io
import itertools
import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import cache as C  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params, shard_state  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.engine.api import PrefixConfig  # noqa: E402
from repro_torch.launch import mesh, serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402

DP = 2
KW = dict(max_slots=4, s_max=64, prefill_chunk=8, threshold=4, block_size=8)
# the isolation case: 4 usable blocks per row, 12-token prompts
TIGHT = dict(KW, num_blocks=5)
# routing: a burst of unequal prompts on a tight pool, then a preemption
ROUTE_PROMPTS = [list(range(1, 1 + n)) for n in (20, 9, 12, 26, 7)]
ROUTE_LATE = [list(range(200, 200 + n)) for n in (15, 5)]
# one mixed step: prefill chunks in both rows' segments, one padding row
STEP_TOKS = np.random.default_rng(3).integers(1, 500, (4, 8)).astype(np.int32)
STEP = ([8, 5, 8, 0], [0, 0, 0, 0])
STEP_BT = np.array([[1, 2], [3, 4], [1, 2], [0, 0]], np.int32)


def _cfg(arch="qwen3-8b"):
    return get_config(arch).reduced()


def _mixed_reqs(make=Request, mixed=True):
    n = 6 if mixed else 4
    return [make(i, list(range(1, 12 + i)), max_new_tokens=6)
            for i in range(n)]


def _isolation_reqs(make=Request):
    # distinct prompts of equal length: routing alternates rows; row 0's
    # requests grow to 3 blocks and squeeze each other, row 1's stay at 2
    return [make(i, list(range(100 * i + 1, 100 * i + 13)),
                 max_new_tokens=12 if i % 2 == 0 else 2) for i in range(4)]


# the engine scenarios the reference runs too: name -> (kw, requests)
CASES = {"mixed": (dict(KW, prefix=PrefixConfig(True)), _mixed_reqs),
         "serialized": (dict(KW, mixed=False),
                        lambda make=Request: _mixed_reqs(make, mixed=False)),
         "isolation": (TIGHT, _isolation_reqs)}
# and on the dense cache, which places requests by slot, not by routed row
DENSE_CASES = {
    "dense": (dict(KW, paged=False),
              lambda make=Request: _mixed_reqs(make, mixed=False)),
    "mamba": (KW, lambda make=Request: _mixed_reqs(make, mixed=False))}
# the scenarios on another architecture than reduced qwen3-8b (mamba2's
# engine takes its automatic dense fallback)
ARCH = {"mamba": "mamba2-1.3b"}


def _spec_reqs(make=Request):
    return [make(i, ([2, 3, 4] * 4)[:9 + i], max_new_tokens=10)
            for i in range(4)]


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return [r.generated for r in reqs]


def _fake_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


# ---------------------------------------------------------------------------
# the port's side: one job on two ranks
# ---------------------------------------------------------------------------
def _model(state, groups, rank, arch="qwen3-8b"):
    cfg = _cfg(arch)
    lay = Layout(dp=DP)
    m = Model(cfg, device="cpu", dtype=torch.float32, lay=lay, groups=groups)
    m.load_params(shard_state(state, cfg, lay, rank))
    return m


def _engine_case(m, kw, reqs):
    eng = ShiftEngine(m, EngineConfig(**kw), now=_fake_clock())
    streams = _run(eng, reqs)
    return {"streams": streams, "rows": [r.row for r in reqs],
            "counts": dict(eng.config_counts), "preempt": eng.preemptions,
            "req_preempt": [r.num_preemptions for r in reqs],
            "stats": eng.prefix_stats.as_dict(),
            "ledger": eng.block_accounting().as_dict(),
            "inflight": [dict(reg) for reg in eng._inflight] if eng.paged
            else None,
            "spec": (eng.obs.registry.counter_total("spec_proposed_total"),
                     eng.obs.registry.counter_total("spec_accepted_total")),
            "paged": eng.paged, "mixed": eng.mixed,
            "reason": eng.paged_disabled_reason,
            "dump": eng.obs.dump()}


def _route_case(m):
    """Route a burst (then admit: no forward), preempt row 0's first
    request, submit two more and admit again."""
    eng = ShiftEngine(m, EngineConfig(**TIGHT))
    reqs = [Request(i, p, max_new_tokens=4) for i, p in enumerate(ROUTE_PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng._admit()
    burst = [r.row for r in reqs]
    slots = [r.slot for r in reqs]
    victim = next(r for r in reqs if r.row == 0 and r.slot is not None)
    eng._preempt(victim)
    late = [Request(10 + i, p, max_new_tokens=4)
            for i, p in enumerate(ROUTE_LATE)]
    for r in late:
        eng.submit(r)
    eng._admit()
    return {"burst": burst, "slots": slots, "victim": victim.rid,
            "after": [r.row for r in reqs + late],
            "after_slots": [r.slot for r in reqs + late],
            "free": [eng.kv.row_free_blocks(r) for r in range(DP)]}


def _indivisible(m):
    """``max_slots`` 3 over 2 dp rows: forced paging raises; the automatic
    choice falls back to the dense cache with its reason, and its steps
    raise, as the reference's ``shard_map`` refuses the 3 rows."""
    out = {}
    try:
        ShiftEngine(m, EngineConfig(**dict(KW, max_slots=3, paged=True)))
    except ValueError as e:
        out["forced"] = str(e)
    eng = ShiftEngine(m, EngineConfig(**dict(KW, max_slots=3)))
    out["auto"] = {"paged": eng.paged, "mixed": eng.mixed,
                   "reason": eng.paged_disabled_reason,
                   "stats_reason": eng.prefix_stats.paged_disabled_reason}
    eng.submit(Request(0, list(range(1, 10)), max_new_tokens=2))
    try:
        eng.step()
    except ValueError as e:
        out["step"] = str(e)
    return out


def _serve_report(rank, groups, out_dir):
    args = argparse.Namespace(
        arch="qwen3-8b", reduced=True, device="cpu", dtype="fp32",
        adaptive=False, block_size=16, num_blocks=0, prefix_cache=False,
        spec_k=0,
        spec_ngram=3, dp=DP, requests=4, max_new=4, shared_prefix=0,
        deadline_s=None, max_queue=0, shed_policy="reject-newest",
        auto_snapshot_every=0, fault_seed=None, fault_steps=64,
        p_fault=0.05, metrics_refresh_s=0.0,
        metrics_out=str(Path(out_dir) / "m.json"),
        trace_out=str(Path(out_dir) / "t.json"))
    return serve.serve_rank(rank, groups, args)


def _job(rank, groups, state, out_dir, mamba_state):
    m = _model(state, groups, rank)
    mamba = _model(mamba_state, groups, rank, "mamba2-1.3b")
    out = {"rank": rank, "dp_rank": m.shard.dp_rank}
    m.init_paged_cache(5, 8)
    out["logits"] = m.forward_mixed(STEP_TOKS, *STEP, STEP_BT,
                                    sample=False)[0].numpy()
    out["tokens"] = m.forward_mixed(STEP_TOKS, *STEP, STEP_BT)[0].numpy()
    groups.traffic.clear()
    for name, (kw, reqs) in {**CASES, **DENSE_CASES}.items():
        out[name] = _engine_case(mamba if name in ARCH else m, kw, reqs())
        if name == "mixed":
            out["traffic"] = dict(groups.traffic)
    out["spec_off"] = _engine_case(m, KW, _spec_reqs())
    out["spec_on"] = _engine_case(m, dict(KW, spec=SpecConfig(k=4)),
                                  _spec_reqs())
    out["route"] = _route_case(m)
    out["indivisible"] = _indivisible(m)
    out["serve"] = _serve_report(rank, groups, out_dir)
    return out


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
def _randomize_norms(tree, rng):
    return {k: (_randomize_norms(v, rng) if isinstance(v, dict)
                else rng.standard_normal(v.shape).astype(v.dtype)
                if k in ("scale", "q_norm", "k_norm") else v)
            for k, v in tree.items()}


def _ref_params(model):
    import jax
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.key(0)))
    return _randomize_norms(tree, np.random.default_rng(0))


class Reference:
    """The reference's base and shift models on ``make_mesh((2, 1, 1))``
    with their params (norms randomized as in the port's state)."""

    def __init__(self):
        import jax.numpy as jnp
        from conftest import make_mesh, reduced_cfg
        from repro.models.model import Model as JaxModel
        from repro.parallel import Layout as JaxLayout
        self.mesh = make_mesh((DP, 1, 1))
        self.lay = JaxLayout.from_mesh(self.mesh, dp=("data",), sp=("sp",),
                                       tp=("tp",))
        self.models = {}
        for arch in ("qwen3-8b", "mamba2-1.3b"):
            cfg = reduced_cfg(arch)
            mb = JaxModel(cfg=cfg, lay=self.lay, mesh=self.mesh,
                          dtype=jnp.float32)
            ms = JaxModel(cfg=cfg, lay=self.lay.to_shift(), mesh=self.mesh,
                          dtype=jnp.float32)
            self.models[arch] = mb, ms, _ref_params(mb), _ref_params(ms)
        self.mb, self.ms, self.pb, self.ps = self.models["qwen3-8b"]
        self._cases = {}

    def engine(self, kw, now=None, arch="qwen3-8b"):
        import jax
        import jax.numpy as jnp
        from repro.core.policy import ThresholdPolicy as JaxPolicy
        from repro.engine import EngineConfig as JaxEngineConfig
        from repro.engine import PrefixConfig as JaxPrefixConfig
        kw = dict(kw)
        threshold = kw.pop("threshold")
        if "prefix" in kw:
            kw["prefix"] = JaxPrefixConfig(enabled=kw["prefix"].enabled)
        from repro.engine import ShiftEngine as JaxEngine
        mb, ms, pb, ps = self.models[arch]
        return JaxEngine(mb, ms, jax.tree.map(jnp.asarray, pb),
                         jax.tree.map(jnp.asarray, ps),
                         JaxEngineConfig(threshold=threshold, **kw),
                         policy=JaxPolicy(threshold),
                         **({"now": now} if now is not None else {}))

    def case(self, name):
        """The scenario ``name`` of ``CASES`` under a fake clock, run once
        and kept."""
        if name not in self._cases:
            self._cases[name] = self._case(*{**CASES, **DENSE_CASES}[name],
                                           ARCH.get(name, "qwen3-8b"))
        return self._cases[name]

    def _case(self, kw, reqs_fn, arch):
        from repro.engine import Request as JaxRequest
        eng = self.engine(kw, now=_fake_clock(), arch=arch)
        reqs = reqs_fn(JaxRequest)
        streams = _run(eng, reqs)
        return {"streams": streams, "rows": [r.row for r in reqs],
                "counts": dict(eng.config_counts), "preempt": eng.preemptions,
                "req_preempt": [r.num_preemptions for r in reqs],
                "stats": eng.prefix_stats.as_dict(),
                "ledger": eng.block_accounting().as_dict(),
                "paged": eng.paged, "mixed": eng.mixed,
                "reason": eng.paged_disabled_reason,
                "dump": eng.obs.dump()}


@pytest.fixture(scope="module")
def state():
    return _state("qwen3-8b")


@pytest.fixture(scope="module")
def mamba_state():
    return _state("mamba2-1.3b")


def _state(arch):
    from conftest import reduced_cfg
    from repro.models import build_model
    import jax.numpy as jnp
    jm = build_model(reduced_cfg(arch), dtype=jnp.float32)
    return from_jax_params(_ref_params(jm), _cfg(arch))


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    """Where rank 0 of the serve CLI writes its metrics and trace."""
    return tmp_path_factory.mktemp("dp_serve")


@pytest.fixture(scope="module")
def ranks(state, out_dir, mamba_state):
    """The one two-rank job of this module."""
    return mesh.run_ranks(_job, 1, 1, dp=DP, device="cpu", backend="gloo",
                          timeout_s=300,
                          args=(state, str(out_dir), mamba_state))


@pytest.fixture(scope="module")
def ref():
    return Reference()


def _one_row_engines(state, kw, reqs, rows):
    """Two dp=1 port engines (max_slots halved), each fed the requests
    routed to its row; their streams by rid."""
    model = Model(_cfg(), device="cpu", dtype=torch.float32)
    model.load_params(state)
    out = {}
    for row in range(DP):
        sub = [Request(r.rid, list(r.prompt), max_new_tokens=r.max_new_tokens)
               for r, rr in zip(reqs, rows) if rr == row]
        eng = ShiftEngine(model, EngineConfig(**dict(
            kw, max_slots=kw["max_slots"] // DP)))
        for r, s in zip(sub, _run(eng, sub)):
            out[r.rid] = s
    return [out[r.rid] for r in reqs]


# ---------------------------------------------------------------------------
# the control plane, in this process
# ---------------------------------------------------------------------------
def _cache_script(cache_mod, with_index):
    """One sequence of operations on a dp=2 cache (num_blocks 6 per row,
    4 slots, blocks of 4): allocation in both rows, a prefix pin and a
    shared block copied on write, a truncate, a fork and frees. Returns
    the observations after each operation and the COW copies."""
    kv = cache_mod.PagedKVCache(6, 4, 4, 8, dp=2)
    if with_index:
        kv.prefix_indices = [cache_mod.PrefixIndex(4, kv.allocators[r])
                             for r in range(2)]
    seen, copies = [], []

    def look():
        seen.append((kv.table.copy(), kv.n_mapped.copy(), kv.table3.copy(),
                     [kv.row_free_blocks(r) for r in range(2)],
                     kv.num_free_blocks, kv.num_used_blocks))

    assert kv.ensure(0, 7) and kv.ensure(3, 9)
    look()
    assert kv.ensure(2, 5) and kv.ensure(1, 4)
    look()
    kv.free_seq(3)
    kv.fork(2, 3)                            # row 1: slot 3 shares slot 2's
    look()
    copies.append(kv.copy_on_write(3, 4, 8))    # its second block is shared
    look()
    assert kv.ensure(3, 16)
    look()
    kv.truncate(3, 6)
    look()
    if with_index:
        idx = kv.prefix_indices[0]
        idx.commit(list(range(1, 9)), 2, kv.seq_blocks(0))
        kv.free_seq(0)
        look()
        assert kv.ensure(0, 16)              # evicts row 0's entries only
        look()
        seen.append((len(kv.prefix_indices[0]), kv.prefix_indices[0].evictions,
                     len(kv.prefix_indices[1])))
    for s in range(4):
        kv.free_seq(s)
    look()
    return kv, seen, copies


@pytest.mark.parametrize("with_index", [False, True],
                         ids=["plain", "prefix-index"])
def test_paged_cache_dp_matches_reference(with_index):
    from repro import cache as RC
    kv, mine, my_copies = _cache_script(C, with_index)
    ref, theirs, ref_copies = _cache_script(RC, with_index)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # the port returns row-local copies, the reference pool-global ones
    row = kv.row_of(3)
    assert row == ref.row_of(3) == 1
    assert [(ok, [(kv.global_block(row, s), kv.global_block(row, d))
                  for s, d in cp]) for ok, cp in my_copies] == ref_copies
    assert my_copies[0][1] and my_copies[0][1][0][1] < kv.num_blocks_per_row
    for r in range(2):
        for b in range(kv.num_blocks_per_row):
            assert kv.global_block(r, b) == ref.global_block(r, b)
    assert [kv.row_of(s) for s in range(4)] == [0, 0, 1, 1]
    assert kv.slots_per_row == 2 and kv.table3.shape == (2, 2, 8)
    assert kv.num_free_blocks == 2 * 5


def test_dp_row_prefix_eviction_isolation():
    """Allocation pressure in row 0 evicts only row 0's prefix entries."""
    kv = C.PagedKVCache(num_blocks=6, block_size=4, max_seqs=4,
                        max_blocks_per_seq=8, dp=2)      # 5 usable per row
    idx0 = C.PrefixIndex(4, kv.allocators[0])
    idx1 = C.PrefixIndex(4, kv.allocators[1])
    kv.prefix_indices = [idx0, idx1]
    toks = list(range(1, 9))
    kv.ensure(0, 8)
    idx0.commit(toks, 2, kv.seq_blocks(0))
    kv.free_seq(0)                             # pinned only by idx0 now
    kv.ensure(2, 8)
    idx1.commit(toks, 2, kv.seq_blocks(2))
    kv.free_seq(2)
    assert len(idx0) == 2 and len(idx1) == 2
    assert kv.row_free_blocks(0) == 3 and kv.row_free_blocks(1) == 3
    assert kv.ensure(1, 20)                    # 5 blocks > 3 free
    assert len(idx0) == 0 and idx0.evictions == 2
    assert len(idx1) == 2 and idx1.evictions == 0
    assert kv.row_free_blocks(1) == 3
    assert len(idx1.match(toks)) == 2
    # the dp=1 conveniences refuse to pick a row
    with pytest.raises(AssertionError):
        kv.allocator
    with pytest.raises(AssertionError):
        kv.prefix_index


@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 2)],
                         ids=["dp2", "dp2-sp2-tp2"])
def test_layout_dp_rank_maps_match_reference(shape):
    from conftest import make_mesh
    from repro.parallel import Layout as JaxLayout
    m = make_mesh(shape)
    ref = JaxLayout.from_mesh(m, dp=("data",), sp=("sp",), tp=("tp",))
    dp, sp, tp = shape
    lay = Layout(dp=dp, sp=sp, tp=tp)
    for mine, theirs in ((lay, ref), (lay.to_shift(), ref.to_shift())):
        assert mine.signature == theirs.signature
        assert mine.describe() == theirs.describe()
        assert mine.G == theirs.G and mine.world == m.devices.size
    assert lay.to_shift().dp == dp
    ids = {int(m.devices[d, i, j].id): (d, i, j) for d in range(dp)
           for i in range(sp) for j in range(tp)}
    for r in range(lay.world):
        d, i, j = ids[r]                       # rank r is devices[d, i, j]
        assert (lay.dp_rank(r), lay.sp_rank(r) if sp > 1 else 0) == (d, i)
        assert lay.tp_rank(r) == (j if sp > 1 else lay.model_rank(r))
        assert lay.model_rank(r) == j * sp + i
        assert lay.to_shift().tp_rank(r) == j * sp + i
        assert lay.to_shift().dp_rank(r) == d
    with pytest.raises(ValueError):
        lay.dp_rank(lay.world)
    with pytest.raises(ValueError, match="ep=2"):
        Layout(dp=2, ep=2)
    with pytest.raises(ValueError):
        Layout(dp=0)


def test_serve_cli_dp_needs_a_backend(capsys):
    """``--dp 2`` without ``--backend`` stops before it spawns anything."""
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--dtype", "fp32",
                    "--dp", "2"])
    assert "--backend" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the two-rank job against the reference and the routed dp=1 engines
# ---------------------------------------------------------------------------
def test_ranks_agree_and_gather_over_dp(ranks):
    assert [r["dp_rank"] for r in ranks] == [0, 1]
    for key in ("mixed", "serialized", "isolation", "dense", "mamba",
                "spec_off", "spec_on", "route", "indivisible"):
        assert ranks[0][key] == ranks[1][key], key
    np.testing.assert_array_equal(ranks[0]["tokens"], ranks[1]["tokens"])
    tr = ranks[0]["traffic"]
    assert tr["dp_all_gather_calls"] > 0 and tr["dp_all_gather_bytes"] > 0
    assert set(k.rsplit("_", 1)[0] for k in tr) == {"dp_all_gather"}


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "serialized"])
def test_dp2_engine_matches_reference_and_routed_dp1(ranks, ref, state,
                                                     mixed):
    name = "mixed" if mixed else "serialized"
    kw = CASES[name][0]
    got = ranks[0][name]
    want = ref.case(name)
    assert got["streams"] == want["streams"]
    assert got["rows"] == want["rows"]
    assert got["counts"] == want["counts"]
    assert set(got["rows"]) == {0, 1}
    assert all(len(s) == 6 for s in got["streams"])
    reqs = _mixed_reqs(mixed=mixed)
    assert got["streams"] == _one_row_engines(state, kw, reqs, got["rows"])
    if mixed:
        assert got["stats"] == want["stats"] and got["stats"]["entries"] > 0
        assert got["ledger"] == want["ledger"]
        led = got["ledger"]
        assert led["used"] == led["pinned"] == got["stats"]["entries"]
        assert len(led["free_per_row"]) == DP
        assert not any(got["inflight"])
    else:
        assert got["ledger"]["used"] == 0
        assert got["ledger"]["free_per_row"] == want["ledger"]["free_per_row"]


@pytest.mark.parametrize("name", ["dense", "mamba"])
def test_dp2_dense_engine_matches_reference(ranks, ref, name):
    """The dense cache at dp=2: reduced qwen3-8b with ``paged=False`` and
    reduced mamba2-1.3b on its automatic fallback (the CLI's ``--dp 2
    --arch mamba2-1.3b``), each rank's row of slots. Streams, rows, config
    counts (both used), preemptions, the fallback's reason and the
    observability dump (under one fake clock) equal the reference's dp=2
    engine's."""
    want = ref.case(name)
    assert (want["paged"], want["mixed"]) == (False, False)
    for r in ranks:
        got = r[name]
        for key in ("streams", "rows", "counts", "preempt", "req_preempt"):
            assert got[key] == want[key], (r["rank"], key)
        assert (got["paged"], got["mixed"], got["reason"]) == (
            False, False, want["reason"])
        assert json.dumps(got["dump"], sort_keys=True) == \
            json.dumps(want["dump"], sort_keys=True), (r["rank"], name)
    assert want["counts"]["base"] > 0 and want["counts"]["shift"] > 0
    assert all(len(s) == 6 for s in want["streams"])


def test_dp_row_preemption_isolation(ranks, ref):
    got = ranks[0]["isolation"]
    want = ref.case("isolation")
    assert got["rows"] == want["rows"] == [0, 1, 0, 1]
    assert got["preempt"] == want["preempt"] > 0
    assert got["req_preempt"] == want["req_preempt"]
    assert all(n == 0 for n, row in zip(got["req_preempt"], got["rows"])
               if row == 1)
    assert got["streams"] == want["streams"]
    assert [len(s) for s in got["streams"]] == [12, 2, 12, 2]


def test_spec_bitwise_identical_dp2(ranks):
    on, off = ranks[0]["spec_on"], ranks[0]["spec_off"]
    assert on["streams"] == off["streams"]
    assert on["spec"][0] > 0 and off["spec"] == (0, 0)
    assert on["ledger"]["used"] == 0 and on["ledger"]["pinned"] == 0
    assert set(on["rows"]) == {0, 1}


def test_route_burst_and_after_preemption_match_reference(ranks, ref):
    from repro.engine import Request as JaxRequest
    eng = ref.engine(TIGHT)
    reqs = [JaxRequest(i, p, max_new_tokens=4)
            for i, p in enumerate(ROUTE_PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng._admit()
    burst, slots = [r.row for r in reqs], [r.slot for r in reqs]
    victim = next(r for r in reqs if r.row == 0 and r.slot is not None)
    eng._preempt(victim)
    late = [JaxRequest(10 + i, p, max_new_tokens=4)
            for i, p in enumerate(ROUTE_LATE)]
    for r in late:
        eng.submit(r)
    eng._admit()
    got = ranks[0]["route"]
    assert got["burst"] == burst and got["slots"] == slots
    assert got["victim"] == victim.rid
    assert got["after"] == [r.row for r in reqs + late]
    assert got["after_slots"] == [r.slot for r in reqs + late]
    assert got["free"] == [eng.kv.row_free_blocks(r) for r in range(DP)]
    # both rows took part of the burst; the victim kept its row
    assert set(burst) == {0, 1}
    assert got["after"][victim.rid] == 0


def test_dp_mixed_logits_match_reference(ranks, ref):
    """One mixed step on a fresh pool: each rank returns its segment's
    logits; put together they equal the reference's within 1e-4, and the
    gathered tokens are their argmax on every rank."""
    import jax
    import jax.numpy as jnp
    pool = ref.mb.init_paged_cache(5, 8)
    fwd = jax.jit(ref.mb.forward_fn(sample=False))
    want, _ = fwd(jax.tree.map(jnp.asarray, ref.pb), pool,
                  jnp.asarray(STEP_TOKS), jnp.asarray(STEP[0], jnp.int32),
                  jnp.asarray(STEP[1], jnp.int32), jnp.asarray(STEP_BT))
    want = np.asarray(want)
    got = np.concatenate([r["logits"] for r in ranks])
    assert [r["logits"].shape[0] for r in ranks] == [2, 2]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.abs(want[:3]).max() > 0.1
    live = np.asarray(STEP[0]) > 0
    np.testing.assert_array_equal(ranks[0]["tokens"][live],
                                  want.argmax(-1)[live])


def test_indivisible_slots_raise(ranks, ref):
    """As ``tests/test_paged_dp.py::test_paged_dp_indivisible_slots_reason_
    and_raise``: the automatic choice falls back to the dense cache with
    the reference engine's reason, and a forced ``paged=True`` raises; a
    step then raises on the rows that do not split, as the reference's."""
    got = ranks[0]["indivisible"]
    assert "divisible" in got["forced"]
    want = ref.engine(dict(KW, max_slots=3))
    assert not want.paged
    assert got["auto"] == {"paged": False, "mixed": False,
                           "reason": want.paged_disabled_reason,
                           "stats_reason": want.paged_disabled_reason}
    assert "divisible" in got["auto"]["reason"]
    assert "does not split over dp=2" in got["step"]


def test_serve_dp_report(ranks, state):
    """One rank of ``serve --reduced --device cpu --dtype fp32 --dp 2
    --backend gloo``: both rows' paged-cache line, each request's row, and
    streams equal to dp=1 engines fed the routed split (the CLI's own
    random weights)."""
    rep = [r["serve"] for r in ranks]
    assert rep[0]["streams"] == rep[1]["streams"]
    text = rep[0]["report"]
    assert "paged cache: 2 dp row(s) x " in text
    assert "  row 0: " in text and "  row 1: " in text
    for rid, row in enumerate(rep[0]["rows"]):
        assert re.search(rf"^req {rid}: 4 tokens, .* row={row}, ", text,
                         re.MULTILINE)
    assert set(rep[0]["rows"]) == {0, 1}
    eng = serve.build_engine(reduced=True, device="cpu", dtype=torch.float32)
    model = eng.model
    want = {}
    for row in range(DP):
        sub = [r for r, rr in zip(serve.workload(4, 4), rep[0]["rows"])
               if rr == row]
        e1 = ShiftEngine(model, EngineConfig(max_slots=4))
        for r, s in zip(sub, _run(e1, sub)):
            want[r.rid] = s
    assert rep[0]["streams"] == [want[i] for i in range(4)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.print_summary(eng)
    assert "paged cache: 1 dp row(s)" in out.getvalue()


@pytest.mark.parametrize("name", list(CASES))
def test_dp2_dump_matches_reference(ranks, ref, name):
    """Under one fake clock every rank's dump, report and Chrome trace equal
    the reference's dp=2 engine's, string for string; ``routed`` events
    and ``finish`` events carry each request's row."""
    from repro import obs as jobs
    from repro_torch.obs import build_report, chrome_trace
    want = ref.case(name)["dump"]
    for r in ranks:
        got = r[name]["dump"]
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True), (r["rank"], name)
        assert json.dumps(build_report(got), sort_keys=True) == \
            json.dumps(jobs.build_report(want), sort_keys=True)
        assert json.dumps(chrome_trace(got), sort_keys=True) == \
            json.dumps(jobs.chrome_trace(want), sort_keys=True)
    rows = {e["rid"]: e["row"] for e in want["events"]
            if e["kind"] == "routed"}
    assert set(rows.values()) == {0, 1}
    assert rows == dict(enumerate(ranks[0][name]["rows"]))


def test_serve_dp_writes_rank0_metrics(ranks, out_dir):
    """``--dp 2`` with ``--metrics-out``/``--trace-out``: rank 0 writes the
    dump, the Prometheus text and the trace; every rank prints the
    report."""
    from repro_torch.obs import build_report, format_report
    dump = json.loads((out_dir / "m.json").read_text())
    assert "repro_requests_finished_total 4" in \
        (out_dir / "m.prom").read_text()
    trace = json.loads((out_dir / "t.json").read_text())
    assert sum(e["ph"] == "X" for e in trace["traceEvents"]) == \
        len(dump["steps"])
    assert format_report(build_report(dump)) in ranks[0]["serve"]["report"]
    for r in ranks:
        assert "== observability report (engine) ==" in r["serve"]["report"]
