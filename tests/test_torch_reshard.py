"""Elastic runtime resharding on the port, held to the reference: the
counterparts of ``tests/test_elastic_reshard.py``, of the scheduled
reshards of ``tests/test_spec_decode.py``, a serialized paged engine
(``mixed=False``) resharded to a model group of two and back mid-stream,
and the port's own refusal of a layout of another world size.

The port's ranks are processes, so a reshard keeps the world size: on two
ranks (2, 1, 1) <-> (1, 1, 2). One two-rank job (``launch.mesh.run_ranks``
over gloo, a module-scoped fixture) runs every case on both ranks, each
engine under its own fake clock, every rank building the two grids'
``Groups`` first, in the same order; the reference runs the same cases on
``make_mesh((2, 1, 1))`` and ``make_mesh((1, 1, 2))`` in this process.
Every rank's streams, deliveries, ``ReshardReport`` (delta, counts, the
TransferOp plan field by field, paused steps), block ledgers and whole
observability dump must equal the reference's. Weights: the reference's
``init_params(key(0))`` with random norm scales, converted and cut per
rank (``shard_state``).
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params, shard_state  # noqa: E402
from repro_torch.core.policy import ThresholdPolicy  # noqa: E402
from repro_torch.engine import (Deployment, EngineConfig,  # noqa: E402
                                Request, ReshardError, ReshardReport,
                                ShiftEngine)
from repro_torch.ft import SnapshotError  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import (Groups, Layout, LayoutDelta,  # noqa: E402
                                  layout_delta)
from repro_torch.spec import SpecConfig  # noqa: E402

SHAPES = {"dp2": (2, 1, 1), "tp2": (1, 1, 2)}


def _cfg():
    return get_config("qwen3-8b").reduced()


def _fake_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


def _js(x):
    return json.dumps(x, sort_keys=True, default=str)


def _report(rep):
    return None if rep is None else {
        "delta": dataclasses.asdict(rep.delta), "noop": rep.noop,
        "moved": rep.moved_requests, "blocks": rep.blocks_moved,
        "dropped": rep.dropped_prefix_blocks,
        "plan": [[dataclasses.asdict(op) for op in ops] for ops in rep.plan],
        "paused": rep.admission_paused_steps}


def _error(fn):
    """The class name and message of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:            # noqa: BLE001 (reported, then checked)
        return [type(e).__name__, str(e)]
    return None


# ---------------------------------------------------------------------------
# the cases, each written once over a side (the port's on one rank, or the
# reference's)
# ---------------------------------------------------------------------------
def _reqs(s, n=4, prompt_len=12, max_new=6):
    # equal-length prompts: placement symmetry makes the round trip's
    # ledger exactly reproducible
    return [s.Request(i, [i + 1] + list(range(2, prompt_len + 1)),
                      max_new_tokens=max_new) for i in range(n)]


def _spec_reqs(s, n=4, n_new=10):
    return [s.Request(i, ([2, 3, 4] * 4)[:9 + i], max_new_tokens=n_new)
            for i in range(n)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return [list(r.generated) for r in reqs]


def _ledger(eng):
    return dataclasses.asdict(eng.stats().blocks)


def case_delegates(s):
    eng = s.engine("dp2")
    return {"deploy": type(eng.deploy).__name__,
            "base": eng.base is eng.deploy.base,
            "shift": eng.shift is eng.deploy.shift,
            "p_base": eng.p_base is eng.deploy.p_base, "dp": eng.dp,
            "signature": list(eng.deploy.signature), "mixed": eng.mixed,
            "forward": sorted(eng.deploy.forward),
            "serialized": [eng.deploy.prefill, eng.deploy.decode]}


def case_noop(s):
    eng = s.engine("dp2")
    old = eng.deploy
    rep = s.reshard(eng, "dp2")
    return {"report": _report(rep), "same": eng.deploy is old,
            "reshards": eng.obs.registry.counter_total("reshards_total")}


def case_indivisible(s):
    eng = s.engine("tp2", max_slots=3)
    err = _error(lambda: s.reshard(eng, "dp2"))
    return {"error": err[0], "dp": eng.dp}


def case_capacity(s):
    eng = s.engine("dp2")
    reqs = _reqs(s, n=2, max_new=4)
    for r in reqs:
        eng.add_request(r)
    # a one-usable-block row cannot hold any queued request's worst case
    err = _error(lambda: s.reshard(eng, "tp2", row_blocks=2))
    dp = eng.dp
    eng.run_until_idle()
    return {"error": err[0], "dp": dp,
            "streams": [list(r.generated) for r in reqs],
            "dump": eng.obs.dump()}


def case_grow_shrink(s):
    expect = _serve(s.engine("dp2"), _reqs(s))
    eng = s.engine("dp2")
    router = s.Router([eng], rebalance_every=0)
    reqs = _reqs(s)
    for r in reqs:
        router.submit(r)
    for _ in range(4):
        router.poll()
        router.step()
    led0 = _ledger(eng)
    reps = [s.reshard_replica(router, "tp2"), s.reshard_replica(router, "dp2")]
    led1 = _ledger(eng)
    reps.append(s.reshard_replica(router, "tp2"))
    for _ in range(3):
        router.poll()
        router.step()
    reps.append(s.reshard_replica(router, "dp2"))
    router.run_until_idle()
    out = {"expect": expect, "led0": led0, "led1": led1,
           "reports": [_report(r) for r in reps],
           "streams": [list(r.generated) for r in reqs],
           "delivered": [router.delivered(r.rid) for r in reqs],
           "counters": [eng.obs.registry.counter_total(n) for n in (
               "reshards_total", "reshard_blocks_moved_total")],
           "dump": eng.obs.dump()}
    router.drain()
    out["drained"] = _ledger(eng)
    return out


def case_snapshot(s):
    eng = s.engine("dp2")
    reqs = _reqs(s, n=2, max_new=4)
    for r in reqs:
        eng.add_request(r)
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    s.reshard(eng, "tp2")
    step0, lens0 = eng.step_count, eng.lens.copy()
    err = _error(lambda: eng.restore(snap))
    same = eng.step_count == step0 and bool((eng.lens == lens0).all())
    eng.run_until_idle()
    return {"layout": list(snap["layout"]), "error": err, "same": same,
            "streams": [list(r.generated) for r in reqs]}


def case_spec_scheduled(s):
    expect = _serve(s.engine("dp2"), _spec_reqs(s))
    eng = s.engine("dp2", spec_k=4)
    reqs = _spec_reqs(s)
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    s.schedule(eng, "tp2", lead_steps=1)
    eng.run_until_idle()
    return {"expect": expect, "streams": [list(r.generated) for r in reqs],
            "report": _report(eng.last_reshard_report),
            "ledger": dataclasses.asdict(eng.block_accounting()),
            "dump": eng.obs.dump()}


def case_pauses(s):
    eng = s.engine("dp2")
    reqs = _spec_reqs(s, n=6, n_new=8)
    for r in reqs[:4]:
        eng.submit(r)
    eng.step()
    for r in reqs[4:]:
        eng.submit(r)
    s.schedule(eng, "tp2", lead_steps=2)
    reg = eng.obs.registry
    admitted = [reg.counter_total("requests_admitted_total")]
    eng.step()                             # paused lead step 1
    eng.step()                             # paused lead step 2
    admitted.append(reg.counter_total("requests_admitted_total"))
    eng.step()                             # the swap, admissions resume
    rep = _report(eng.last_reshard_report)
    sig = list(eng.deploy.signature)
    eng.run_until_idle()
    return {"admitted": admitted, "report": rep, "signature": sig,
            "streams": [list(r.generated) for r in reqs],
            "scheduled": any(e["kind"] == "reshard_scheduled"
                             for e in eng.obs.dump()["events"])}


def case_serialized(s):
    """A serialized paged engine (``mixed=False``) resharded mid-stream,
    dp2 -> tp2 (a model group of two) -> dp2, against the same requests
    served without a reshard."""
    expect = _serve(s.engine("dp2", mixed=False), _reqs(s))
    eng = s.engine("dp2", mixed=False)
    reqs = _reqs(s)
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    reps = [s.reshard(eng, "tp2")]
    for _ in range(3):
        eng.step()
    reps.append(s.reshard(eng, "dp2"))
    eng.run_until_idle()
    return {"expect": expect, "mixed": eng.mixed,
            "reports": [_report(r) for r in reps],
            "streams": [list(r.generated) for r in reqs],
            "counts": dict(eng.config_counts),
            "ledger": dataclasses.asdict(eng.block_accounting()),
            "dump": eng.obs.dump()}


CASES = {"delegates": case_delegates, "noop": case_noop,
         "indivisible": case_indivisible, "capacity": case_capacity,
         "grow-shrink": case_grow_shrink, "snapshot": case_snapshot,
         "spec-scheduled": case_spec_scheduled, "pauses": case_pauses,
         "serialized": case_serialized}


# ---------------------------------------------------------------------------
# the port's side: one job on two ranks
# ---------------------------------------------------------------------------
class PortSide:
    """This rank's engines: the dp2 and tp2 models (weights cut by
    ``shard_state``), each engine a view of one of them."""

    Request = Request

    def __init__(self, rank, groups, state):
        from repro_torch.cluster import Router
        self.Router = Router
        cfg = _cfg()
        self.lays = {"dp2": Layout(dp=2), "tp2": Layout(tp=2)}
        # both grids' groups, built in the same order on every rank
        self.groups = {"dp2": groups, "tp2": Groups(1, 2)}
        self.models = {}
        for key, lay in self.lays.items():
            m = Model(cfg, device="cpu", dtype=torch.float32, lay=lay,
                      groups=self.groups[key])
            m.load_params(shard_state(state, cfg, lay, rank))
            self.models[key] = m

    def engine(self, key, max_slots=4, spec_k=0, mixed=None):
        return ShiftEngine(self.models[key], EngineConfig(
            max_slots=max_slots, s_max=64, prefill_chunk=8, block_size=8,
            spec=SpecConfig(k=spec_k), mixed=mixed),
            policy=ThresholdPolicy(4), now=_fake_clock())

    def reshard(self, eng, key, **kw):
        return eng.reshard(self.lays[key], groups=self.groups[key], **kw)

    def reshard_replica(self, router, key):
        return router.reshard_replica(0, self.lays[key],
                                      groups=self.groups[key])

    def schedule(self, eng, key, lead_steps):
        eng.schedule_reshard(self.lays[key], groups=self.groups[key],
                             lead_steps=lead_steps)


def _world_refusal(s):
    """The port's own rule: a layout of another world size raises before
    anything changes, and the engine serves on."""
    eng = s.engine("dp2")
    reqs = _reqs(s, n=2, max_new=4)
    for r in reqs:
        eng.submit(r)
    eng.step()
    errs = [_error(lambda: eng.reshard(lay, groups=g)) for lay, g in (
        (Layout(tp=4), None), (Layout(), None),
        (Layout(tp=2), s.groups["dp2"]), (Layout(tp=2), None))]
    dp, deploy = eng.dp, type(eng.deploy).__name__
    eng.run_until_idle()
    return {"errors": errs, "dp": dp, "deploy": deploy,
            "streams": [list(r.generated) for r in reqs],
            "expect": _serve(s.engine("dp2"), _reqs(s, n=2, max_new=4))}


def _pool_sharing(s):
    """After a grow the base and shift views share the new pool, the old
    deployment's models are gone from the engine, and the reshard gather
    was counted on the new grid's groups."""
    eng = s.engine("dp2")
    reqs = _reqs(s, n=2, max_new=4)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    before = dict(s.groups["tp2"].traffic)
    s.reshard(eng, "tp2")
    after = dict(s.groups["tp2"].traffic)
    return {"shared": eng.base.pool is eng.shift.pool,
            "pool": list(eng.base.pool.k.shape),
            "lay": eng.base.lay.describe(),
            "gather": {k: after.get(k, 0) - before.get(k, 0)
                       for k in ("reshard_gather_bytes",
                                 "reshard_gather_calls",
                                 "reshard_weights_calls")}}


def _job(rank, groups, state):
    s = PortSide(rank, groups, state)
    out = {name: case(s) for name, case in CASES.items()}
    out["world"] = _world_refusal(s)
    out["pool"] = _pool_sharing(s)
    out["rank"] = rank
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


class RefSide:
    def __init__(self):
        import jax
        import jax.numpy as jnp
        from conftest import make_mesh, reduced_cfg
        from repro import engine as jeng
        from repro.cluster import Router as JaxRouter
        from repro.models.model import Model as JaxModel
        from repro.parallel import Layout as JaxLayout
        self.jeng, self.Request, self.Router = jeng, jeng.Request, JaxRouter
        cfg = reduced_cfg("qwen3-8b")
        self.meshes, self.lays, self.models = {}, {}, {}
        for key, shape in SHAPES.items():
            msh = make_mesh(shape)
            lay = JaxLayout.from_mesh(msh, dp=("data",), sp=("sp",),
                                      tp=("tp",))
            mb = JaxModel(cfg=cfg, lay=lay, mesh=msh, dtype=jnp.float32)
            ms = JaxModel(cfg=cfg, lay=lay.to_shift(), mesh=msh,
                          dtype=jnp.float32)
            self.meshes[key], self.lays[key] = msh, lay
            self.models[key] = (mb, ms,
                                jax.tree.map(jnp.asarray, _ref_params(mb)),
                                jax.tree.map(jnp.asarray, _ref_params(ms)))

    def engine(self, key, max_slots=4, spec_k=0, mixed=None):
        from repro.core.policy import ThresholdPolicy as JaxPolicy
        from repro.spec import SpecConfig as JaxSpecConfig
        mb, ms, pb, ps = self.models[key]
        return self.jeng.ShiftEngine(mb, ms, pb, ps, self.jeng.EngineConfig(
            max_slots=max_slots, s_max=64, prefill_chunk=8, block_size=8,
            spec=JaxSpecConfig(k=spec_k), mixed=mixed), policy=JaxPolicy(4),
            now=_fake_clock())

    def reshard(self, eng, key, **kw):
        return eng.reshard(self.lays[key], mesh=self.meshes[key], **kw)

    def reshard_replica(self, router, key):
        return router.reshard_replica(0, self.lays[key],
                                      mesh=self.meshes[key])

    def schedule(self, eng, key, lead_steps):
        eng.schedule_reshard(self.lays[key], mesh=self.meshes[key],
                             lead_steps=lead_steps)


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
    return mesh.run_ranks(_job, 1, 1, dp=2, device="cpu", backend="gloo",
                          timeout_s=300, args=(state,))


@pytest.fixture(scope="module")
def ref():
    s = RefSide()
    return {name: case(s) for name, case in CASES.items()}


def _port(ranks, ref, case):
    """Rank 0's result of ``case``, after checking every rank's equal to
    the reference's, key by key."""
    for r in ranks:
        got, want = r[case], ref[case]
        assert got.keys() == want.keys()
        for key in want:
            assert _js(got[key]) == _js(want[key]), (r["rank"], case, key)
    return ranks[0][case]


# ---------------------------------------------------------------------------
# layout diffing (no model)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lay", [
    Layout(), Layout(tp=2), Layout(dp=2), Layout(sp=2, tp=2),
    Layout(sp=2, tp=2).to_shift(), Layout(tp=4), Layout(sp=4)],
    ids=lambda lay: f"{lay.describe()}-grid{lay.grid[0]}x{lay.grid[1]}")
@pytest.mark.parametrize("heads", [4, 6], ids=["heads4", "padded6"])
def test_unshard_state_inverts_shard_state(lay, heads):
    """``unshard_state`` of the tp ranks' ``shard_state`` gives the
    trivial state back bitwise, with pad slots (6 q heads on G 4: 8
    slots) and KV replication (2 kv heads on tp 4) dropped."""
    from repro_torch.convert import unshard_state
    cfg = dataclasses.replace(_cfg(), num_heads=heads)
    m = Model(cfg, device="cpu", dtype=torch.float32)
    m.init_params(torch.Generator().manual_seed(1))
    state = {k: v.numpy() for k, v in m.params.state_dict().items()}
    by_tp = {}
    for rank in range(lay.world):
        by_tp.setdefault(lay.tp_rank(rank),
                         shard_state(state, cfg, lay, rank))
    back = unshard_state([by_tp[k] for k in range(lay.tp)], cfg, lay)
    assert set(back) == set(state)
    for k, v in state.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k


def test_layout_signature_and_describe():
    from conftest import make_mesh
    from repro.parallel import Layout as JaxLayout
    for shape in ((2, 1, 1), (1, 1, 2)):
        theirs = JaxLayout.from_mesh(make_mesh(shape), dp=("data",),
                                     sp=("sp",), tp=("tp",))
        mine = Layout(*shape)
        assert mine.signature == theirs.signature
        assert mine.describe() == theirs.describe()
    assert Layout(dp=2).signature == (2, 1, 1, 1)
    assert Layout(dp=2).describe() == "dp2·sp1·tp1"
    assert Layout(tp=2).describe() == "dp1·sp1·tp2"


def test_layout_delta_kinds():
    from repro.parallel import layout_delta as jax_delta
    dp2, tp2, wide = Layout(dp=2), Layout(tp=2), Layout(dp=2, tp=2)
    same = layout_delta(dp2, Layout(dp=2))
    assert isinstance(same, LayoutDelta) and same.kind == "same"
    grow = layout_delta(dp2, tp2)
    assert grow.kind == "grow" and grow.old == (2, 1, 1, 1)
    assert layout_delta(tp2, dp2).kind == "shrink"
    assert layout_delta(dp2, wide).kind == "reshape"
    for a, b in ((dp2, tp2), (tp2, dp2), (dp2, wide), (dp2, dp2)):
        mine = layout_delta(a, b)
        theirs = jax_delta(_jax_layout(a), _jax_layout(b))
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def _jax_layout(lay):
    """The reference's layout of the same degrees, from a mesh of that
    shape."""
    from conftest import make_mesh
    from repro.parallel import Layout as JaxLayout
    return JaxLayout.from_mesh(make_mesh((lay.dp, lay.sp, lay.tp)),
                               dp=("data",), sp=("sp",), tp=("tp",))


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------
def test_engine_delegates_to_deployment(ranks, ref):
    got = _port(ranks, ref, "delegates")
    assert got["deploy"] == "Deployment"
    assert got["base"] and got["shift"] and got["p_base"]
    assert got["dp"] == 2 and got["signature"] == [2, 1, 1, 1]
    assert got["mixed"] and got["forward"] == ["base", "shift"]
    assert got["serialized"] == [None, None]


def test_reshard_same_layout_is_noop(ranks, ref):
    got = _port(ranks, ref, "noop")
    assert got["report"]["noop"] and got["report"]["moved"] == 0
    assert got["report"]["blocks"] == 0
    assert got["same"] and got["reshards"] == 0


def test_reshard_requires_paged():
    """The reference's first refusal, at world size 1: a dense engine
    cannot reshard."""
    model = Model(_cfg(), device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    eng = ShiftEngine(model, EngineConfig(max_slots=2, s_max=64,
                                          prefill_chunk=8, paged=False),
                      policy=ThresholdPolicy(4))
    with pytest.raises(ReshardError, match="paged"):
        eng.reshard(Layout())
    assert issubclass(ReshardError, RuntimeError)


def test_reshard_rejects_indivisible_slots(ranks, ref):
    got = _port(ranks, ref, "indivisible")
    assert got == {"error": "ReshardError", "dp": 1}


def test_reshard_capacity_error_leaves_engine_serving(ranks, ref):
    got = _port(ranks, ref, "capacity")
    assert got["error"] == "ReshardError" and got["dp"] == 2
    assert all(len(s) == 4 for s in got["streams"])


def test_grow_shrink_mid_decode_bit_identical_and_leak_free(ranks, ref):
    got = _port(ranks, ref, "grow-shrink")
    g, sh = got["reports"][0], got["reports"][1]
    assert g["delta"]["kind"] == "grow" and sh["delta"]["kind"] == "shrink"
    assert g["moved"] == 4 and g["blocks"] > 0
    ops = [op for plan in g["plan"] for op in plan]
    assert all(op["src_replica"] == op["dst_replica"] == 0 for op in ops)
    assert sum(1 for op in ops if op["kind"] == "kv_block") == g["blocks"]
    assert got["led1"] == got["led0"]          # round trip restores it
    assert got["streams"] == got["expect"]     # across four swaps
    assert got["delivered"] == got["expect"]   # exactly-once
    assert got["counters"][0] == 4 and got["counters"][1] > 0
    assert got["drained"]["used"] == 0 and got["drained"]["pinned"] == 0


def test_serialized_paged_reshard_mid_stream(ranks, ref):
    """The serialized steps over the paged pool through a grow to a model
    group of two and back: the reference's reports, streams, configs,
    ledger and dump, and the streams of the run without a reshard."""
    got = _port(ranks, ref, "serialized")
    assert got["mixed"] is False
    kinds = [r["delta"]["kind"] for r in got["reports"]]
    assert kinds == ["grow", "shrink"]
    assert got["streams"] == got["expect"]
    assert got["counts"]["base"] > 0 and got["counts"]["shift"] > 0
    assert got["ledger"]["used"] == 0 and got["ledger"]["pinned"] == 0


def test_restore_layout_mismatch_raises_before_mutation(ranks, ref):
    got = _port(ranks, ref, "snapshot")
    assert got["layout"] == [2, 1, 1, 1]
    assert got["error"][0] == "SnapshotError"
    assert "layout signature" in got["error"][1]
    assert got["same"]
    assert all(len(s) == 4 for s in got["streams"])
    assert issubclass(SnapshotError, Exception)


def test_spec_bitwise_identical_across_scheduled_reshard(ranks, ref):
    got = _port(ranks, ref, "spec-scheduled")
    assert got["report"] is not None and got["report"]["paused"] == 1
    assert got["streams"] == got["expect"]
    assert got["ledger"]["used"] == 0 and got["ledger"]["pinned"] == 0
    dump = json.loads(_js(got["dump"]))
    counters = {c["name"]: c["value"] for c in dump["metrics"]["counters"]}
    assert counters["spec_proposed_total"] > 0


def test_scheduled_reshard_pauses_admissions(ranks, ref):
    got = _port(ranks, ref, "pauses")
    assert got["admitted"][0] == got["admitted"][1]
    assert got["report"]["paused"] == 2
    assert got["signature"] == [1, 1, 2, 1]
    assert all(len(s) == 8 for s in got["streams"])
    assert got["scheduled"]


def test_reshard_keeps_the_world_size(ranks):
    """A layout of another world size (or without the new grid's groups)
    raises ``ReshardError`` before any mutation; the engine serves on and
    its streams are the static run's."""
    for r in ranks:
        w = r["world"]
        kinds = [e[0] for e in w["errors"]]
        assert kinds == ["ReshardError"] * 4
        assert "world size" in w["errors"][0][1]
        assert "world size" in w["errors"][1][1]
        assert w["dp"] == 2 and w["deploy"] == "Deployment"
        assert w["streams"] == w["expect"]


def test_reshard_repours_through_one_gather(ranks):
    """After a grow the two views share the new pool ((1, 1, 2): one kv
    head per rank, twice the blocks of a row), and the re-pour's one
    all-gather is counted on the new grid's groups under its own kind."""
    for r in ranks:
        p = r["pool"]
        assert p["shared"] and p["lay"] == "dp1·sp1·tp2"
        assert p["pool"][3] == 1               # kv heads per rank
        assert p["gather"]["reshard_gather_calls"] == 1
        assert p["gather"]["reshard_gather_bytes"] > 0
    assert ranks[0]["pool"]["pool"][1] == 2 * 16 + 1
    assert isinstance(ReshardReport, type) and Deployment is not None
