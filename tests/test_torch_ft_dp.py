"""Fault injection, snapshots and crash recovery on ``Layout(dp=2)``, held
to the reference's dp=2 engine on ``make_mesh((2, 1, 1))``.

One two-rank job (``launch.mesh.run_ranks`` over gloo, a module-scoped
fixture) runs every case on both ranks, each engine under its own fake
clock, and returns numpy results:

* faults: a ``route`` fault on dp row 1, then a ``forward`` fault, on the
  mixed paged iteration (every rank consults the same plan at the same
  step, so the skipped step is skipped on both and the DP gather stays
  matched): streams, rows, ``fail_count``, per-row ledgers and the whole
  observability dump equal the reference's, and the streams equal the
  clean run's;
* the per-row snapshot of the reference's
  ``tests/test_paged_dp.py::test_dp_engine_snapshot_restores_per_row_state``
  (admission only, no forward): rows, slots, block tables, the allocators
  and prefix indexes of both rows survive a restore into a fresh engine;
* a crash drill: auto-snapshots every 3 steps, the engine dropped after 7,
  a fresh engine on each rank ``recover``s from its own ring and runs to
  idle under a ``DeliveryLog``: no divergence, the streams of the clean
  run, and streams, rows, ledgers and dump equal the reference's drill.

Each rank snapshots its own shard of the cache (its row's pool) with its
rank beside it; the control plane is the same on both ranks.
"""
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params, shard_state  # noqa: E402
from repro_torch.engine import (EngineConfig, FaultConfig,  # noqa: E402
                                PrefixConfig, Request, ShiftEngine)
from repro_torch.ft import DeliveryLog, Fault, FaultPlan  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402

DP = 2
KW = dict(max_slots=4, s_max=64, prefill_chunk=8, threshold=4, block_size=8)
# (step, seam, kind, row): row 1 fails at step 2, the forward at 5 and 9
FAULTS = [(2, "route", "", 1), (5, "forward", "raise", 0),
          (9, "forward", "nan", 0)]


def _cfg():
    return get_config("qwen3-8b").reduced()


def _reqs(make=Request):
    return [make(i, list(range(1, 12 + i)), max_new_tokens=6)
            for i in range(6)]


def _fake_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


def _result(eng, reqs):
    return {"streams": [eng.stream(r.rid) for r in reqs],
            "rows": [r.row for r in reqs],
            "reasons": [str(eng.request(r.rid).finish_reason) for r in reqs],
            "fail": [eng.request(r.rid).fail_count for r in reqs],
            "preempt": eng.preemptions,
            "ledger": eng.block_accounting().as_dict(),
            "dump": json.dumps(eng.obs.dump(), sort_keys=True)}


# the cases, each written once over an engine factory and the
# package's request, fault and plan types
def case_clean(engine, make, F, P):
    eng = engine(KW)
    reqs = _reqs(make)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return _result(eng, reqs)


def case_faults(engine, make, F, P):
    eng = engine(KW, faults=P([F(s, seam, kind=k, row=row)
                               for s, seam, k, row in FAULTS]))
    reqs = _reqs(make)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return _result(eng, reqs)


def case_snapshot(engine, make, F, P):
    kw = dict(KW, prefix=True)
    eng = engine(kw)
    reqs = [make(i, list(range(1, 14 + i)), max_new_tokens=4)
            for i in range(4)]
    for r in reqs:
        eng.add_request(r)
    eng._admit()                       # routes and maps, no forward
    snap = eng.snapshot()
    del eng
    eng2 = engine(kw)
    eng2.restore(snap)
    by_rid = {r.rid: r for r in eng2.queue}
    return {"rows": [r.row for r in reqs], "slots": [r.slot for r in reqs],
            "rows2": [by_rid[r.rid].row for r in reqs],
            "slots2": [by_rid[r.rid].slot for r in reqs],
            "table": eng2.kv.table.copy(), "table0": snap["kv"]["table"],
            "alloc": [eng2.kv.allocators[r].state_dict() for r in range(DP)],
            "alloc0": list(snap["kv"]["allocators"]),
            "index_len": [len(idx) for idx in eng2.prefix_rows],
            "index": [idx.state_dict() for idx in eng2.prefix_rows],
            "dp": eng2.kv.dp}


def case_crash(engine, make, F, P):
    kw = dict(KW, auto_snapshot_every=3)
    eng = engine(kw)
    log = DeliveryLog()
    reqs = _reqs(make)
    for r in reqs:
        eng.submit(r)
    for _ in range(7):
        eng.step()
        log.poll(reqs)
    ring = eng.retained_snapshots()
    delivered = {r.rid: log.delivered(r.rid) for r in reqs}
    del eng
    eng2 = engine(kw)
    eng2.recover(ring)
    live = list(eng2.queue)
    while eng2.queue or eng2.active:
        eng2.step()
        log.poll(live)                 # raises ReplayDivergence
    out = _result(eng2, reqs)
    out.update(ring=[s["step_count"] for s in ring],
               delivered_pre=delivered,
               delivered={r.rid: log.delivered(r.rid) for r in reqs})
    return out


CASES = {"clean": case_clean, "faults": case_faults,
         "snapshot": case_snapshot, "crash": case_crash}


# ---------------------------------------------------------------------------
# the port's side: one job on two ranks
# ---------------------------------------------------------------------------
def _port_engine(m):
    def engine(kw, faults=None):
        kw = dict(kw)
        fault = FaultConfig(auto_snapshot_every=kw.pop("auto_snapshot_every",
                                                       0))
        prefix = PrefixConfig(enabled=kw.pop("prefix", False))
        return ShiftEngine(m, EngineConfig(fault=fault, prefix=prefix, **kw),
                           now=_fake_clock(), faults=faults)
    return engine


def _job(rank, groups, state):
    cfg = _cfg()
    lay = Layout(dp=DP)
    m = Model(cfg, device="cpu", dtype=torch.float32, lay=lay, groups=groups)
    m.load_params(shard_state(state, cfg, lay, rank))
    out = {"rank": rank, "dp_rank": m.shard.dp_rank}
    for name, case in CASES.items():
        out[name] = case(_port_engine(m), Request, Fault, FaultPlan)
    # a snapshot holds this rank's shard and refuses the other rank's
    eng = _port_engine(m)(KW)
    snap = eng.snapshot()
    out["snap_rank"] = snap["rank"]
    out["snap_pool"] = tuple(snap["cache"]["k"].shape)
    try:
        eng.restore(dict(snap, rank=1 - rank))
        out["other_rank"] = None
    except Exception as e:            # noqa: BLE001 (reported, then checked)
        out["other_rank"] = f"{type(e).__name__}: {e}"
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


@pytest.fixture(scope="module")
def state():
    from conftest import reduced_cfg
    from repro.models import build_model
    import jax.numpy as jnp
    jm = build_model(reduced_cfg("qwen3-8b"), dtype=jnp.float32)
    return from_jax_params(_ref_params(jm), _cfg())


@pytest.fixture(scope="module")
def ranks(state):
    """The one two-rank job of this module."""
    return mesh.run_ranks(_job, 1, 1, dp=DP, device="cpu", backend="gloo",
                          timeout_s=300, args=(state,))


@pytest.fixture(scope="module")
def ref():
    """Each case on the reference's dp=2 engine (base and shift models on
    ``make_mesh((2, 1, 1))``, norms randomized as in the port's state)."""
    import jax
    import jax.numpy as jnp
    from conftest import make_mesh, reduced_cfg
    from repro import engine as jeng
    from repro import ft as jft
    from repro.core.policy import ThresholdPolicy as JaxPolicy
    from repro.models.model import Model as JaxModel
    from repro.parallel import Layout as JaxLayout
    msh = make_mesh((DP, 1, 1))
    lay = JaxLayout.from_mesh(msh, dp=("data",), sp=("sp",), tp=("tp",))
    cfg = reduced_cfg("qwen3-8b")
    mb = JaxModel(cfg=cfg, lay=lay, mesh=msh, dtype=jnp.float32)
    ms = JaxModel(cfg=cfg, lay=lay.to_shift(), mesh=msh, dtype=jnp.float32)
    pb = jax.tree.map(jnp.asarray, _ref_params(mb))
    ps = jax.tree.map(jnp.asarray, _ref_params(ms))

    def engine(kw, faults=None):
        kw = dict(kw)
        threshold = kw.pop("threshold")
        fault = jeng.FaultConfig(
            auto_snapshot_every=kw.pop("auto_snapshot_every", 0))
        prefix = jeng.PrefixConfig(enabled=kw.pop("prefix", False))
        return jeng.ShiftEngine(
            mb, ms, pb, ps, jeng.EngineConfig(threshold=threshold,
                                              fault=fault, prefix=prefix,
                                              **kw),
            policy=JaxPolicy(threshold), now=_fake_clock(), faults=faults)

    return {name: case(engine, jeng.Request, jft.Fault, jft.FaultPlan)
            for name, case in CASES.items()}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_equal_reference(ranks, ref, name):
    """Every rank's results of the case equal the reference's dp=2
    engine's, dumps string for string."""
    assert [r["dp_rank"] for r in ranks] == [0, 1]
    for r in ranks:
        for key, want in ref[name].items():
            assert _equal(r[name][key], want), (r["rank"], name, key)


def test_faults_keep_the_clean_streams(ranks, ref):
    faults, clean = ranks[0]["faults"], ranks[0]["clean"]
    assert faults["streams"] == clean["streams"]
    assert set(faults["rows"]) == {0, 1}
    assert set(faults["reasons"]) == {"ok"}
    # the route fault preempted row 1's requests; every batched request
    # of the two forward faults failed a step
    assert faults["preempt"] > 0 and sum(faults["fail"]) > 0
    dump = json.loads(faults["dump"])
    fired = [e for e in dump["events"] if e["kind"] == "fault_injected"]
    assert [(e["step"], e["seam"], e["row"]) for e in fired] == \
        [(s, seam, row) for s, seam, _, row in FAULTS]
    assert sum(1 for s in dump["steps"] if s.get("failed")) == 2
    led = faults["ledger"]
    assert led["used"] == 0 and led["free_per_row"] == \
        clean["ledger"]["free_per_row"]


def test_per_row_snapshot_restores(ranks):
    for r in ranks:
        s = r["snapshot"]
        assert sorted(s["rows"]) == [0, 0, 1, 1]
        assert s["rows2"] == s["rows"] and s["slots2"] == s["slots"]
        assert np.array_equal(s["table"], s["table0"])
        assert s["alloc"] == s["alloc0"] and s["dp"] == DP
        assert s["index_len"] == [0, 0]


def test_crash_recovers_on_both_ranks(ranks):
    for r in ranks:
        c = r["crash"]
        assert c["ring"] == [3, 6]
        assert c["streams"] == r["clean"]["streams"]
        assert c["delivered"] == dict(enumerate(c["streams"]))
        assert any(c["delivered_pre"].values())
        assert c["ledger"]["used"] == 0
        dump = json.loads(c["dump"])
        kinds = [e["kind"] for e in dump["events"]]
        assert kinds.count("restore") == 1 and kinds.count("recovered") == 1


def test_snapshot_is_the_ranks_shard(ranks):
    """Each rank's snapshot holds its own row's pool and its rank, and a
    restore refuses a snapshot that names the other rank."""
    for r in ranks:
        assert r["snap_rank"] == r["rank"]
        assert r["snap_pool"][1] == 17       # 2 slots x 8 blocks + null
        assert r["other_rank"].startswith("SnapshotError")
        assert f"rank {1 - r['rank']}" in r["other_rank"]
