"""Cluster serving on the port (``repro_torch.cluster``), held to the
reference's ``repro.cluster`` case by case: the counterparts of
``tests/test_cluster.py``.

Each case is written once over a ``Side`` (the package's engine, request
and router types) and runs on the reference's engines (jax, CPU) and on
the port's (torch, CPU), every engine under its own fake clock
(``lambda: next(c) * 1e-3``) over the same weights (the reference's
``init_params(key(0))`` with random norm scales, converted by
``from_jax_params``). The port's replicas are engines built on ONE
``Model``: they share its parameters and each steps a pool of its own.
The streams, deliveries, owners, ``transfer_log`` (TransferOps field for
field), ``ClusterStats`` and the merged dump must be JSON-equal to the
reference Router's; the reference test's own assertions then run on the
port's results.
"""
import dataclasses
import itertools
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro import cluster as jcluster  # noqa: E402
from repro import engine as jeng  # noqa: E402
from repro.core.policy import ThresholdPolicy as JaxPolicy  # noqa: E402
from repro.ft.recovery import ReplayDivergence as JaxDivergence  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.obs import MetricsRegistry as JaxRegistry  # noqa: E402
from repro.obs import merge_snapshots as jax_merge  # noqa: E402
from repro_torch import engine as peng  # noqa: E402
from repro_torch.cluster import (ROUTING_POLICIES, Router,  # noqa: E402
                                 TransferOp, build_transfer_plan)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.policy import ThresholdPolicy  # noqa: E402
from repro_torch.engine import ServingClient  # noqa: E402
from repro_torch.ft import ReplayDivergence  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs import MetricsRegistry, merge_snapshots  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _js(x):
    return json.dumps(x, sort_keys=True, default=str)


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
    cfg = get_config("qwen3-8b").reduced()
    model = Model(cfg, device="cpu", dtype=torch.float32)
    model.load_params(from_jax_params(tree, cfg))
    return jm, jax.tree.map(jnp.asarray, tree), model


def _fake_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


class Side:
    """One package's engine, request and router types; engines of
    ``tests/test_cluster.py``'s ``_engine`` (4 slots, s_max 64, chunk 8,
    blocks of 8, threshold 4), each with its own fake clock."""

    def __init__(self, name, weights):
        self.name, self.weights = name, weights
        ref = name == "reference"
        self.pkg = jeng if ref else peng
        self.Request = self.pkg.Request
        self.Router = jcluster.Router if ref else Router
        self.Divergence = JaxDivergence if ref else ReplayDivergence

    def engine(self, prefix=True, **kw):
        jm, params, model = self.weights
        ecfg = self.pkg.EngineConfig(
            max_slots=4, s_max=64, prefill_chunk=8, threshold=4,
            block_size=8, prefix=self.pkg.PrefixConfig(enabled=prefix), **kw)
        if self.name == "reference":
            return jeng.ShiftEngine(jm, jm, params, params, ecfg,
                                    policy=JaxPolicy(4), now=_fake_clock())
        return peng.ShiftEngine(model, ecfg, policy=ThresholdPolicy(4),
                                now=_fake_clock())

    def reqs(self, n=3, max_new=6, shared=()):
        return [self.Request(i, list(shared) + list(range(1, 14 + 3 * i)),
                             max_new_tokens=max_new) for i in range(n)]


def _cluster(router, rids):
    """What a case returns: per rid the stream, the delivered tokens and
    the owner; the transfer log field by field; the ClusterStats; the
    merged dump."""
    return {"streams": {r: router.stream(r) for r in rids},
            "delivered": {r: router.delivered(r) for r in rids},
            "owners": {r: router.owner(r) for r in rids},
            "transfers": [[dataclasses.asdict(op) for op in ops]
                          for ops in router.transfer_log],
            "stats": dataclasses.asdict(router.stats()),
            "dump": router.dump()}


# ---------------------------------------------------------------------------
# the cases, each written once over a Side
# ---------------------------------------------------------------------------
def case_parity(s, mixed):
    bare = s.engine(mixed=mixed)
    ref = s.reqs()
    for r in ref:
        bare.add_request(r)
    bare.run_until_idle(max_steps=2000)
    router = s.Router([s.engine(mixed=mixed)], routing="affinity")
    reqs = s.reqs()
    submitted = [router.submit(r) for r in reqs]
    router.run_until_idle()
    out = _cluster(router, [r.rid for r in reqs])
    out.update(bare=[list(r.generated) for r in ref],
               gen=[list(r.generated) for r in reqs], submitted=submitted,
               bare_counts=dict(bare.stats().config_counts),
               cancel=router.cancel(999),
               is_client=isinstance(router, s.pkg.ServingClient))
    return out


def _shared_prefix_run(s, routing, base=200, tail=300):
    shared = list(range(base, base + 24))       # 24 tokens = 3 blocks of 8
    router = s.Router([s.engine(), s.engine()], routing=routing,
                      rebalance_every=0)
    reqs = [s.Request(i, shared + [tail + 2 * i, tail + 1 + 2 * i],
                      max_new_tokens=4) for i in range(4)]
    for r in reqs:
        router.submit(r)
    owners0 = [router.owner(r.rid) for r in reqs]
    router.run_until_idle()
    out = _cluster(router, [r.rid for r in reqs])
    out.update(owners0=owners0,
               saved=router.counter_total("prefix_tokens_saved_total"),
               prefill=[e.obs.registry.counter_total("tokens_prefill_total")
                        for e in router.engines])
    return out


def case_affinity(s):
    return _shared_prefix_run(s, "affinity")


def case_round_robin(s):
    return _shared_prefix_run(s, "round-robin")


def _decode_until(router, rid, n):
    for _ in range(200):
        router.step()
        router.poll()
        if len(router.stream(rid)) >= n:
            break


def case_migration(s):
    prompt = list(range(1, 17))
    bare = s.engine()
    ref = s.Request(0, prompt, max_new_tokens=8)
    bare.add_request(ref)
    bare.run_until_idle(max_steps=2000)
    router = s.Router([s.engine(), s.engine()], routing="least-loaded",
                      rebalance_every=0)
    req = s.Request(0, prompt, max_new_tokens=8)
    router.submit(req)
    _decode_until(router, 0, 3)
    src = router.owner(0)
    mid = {"n": len(router.stream(0)), "done": req.done,
           "migratable": 0 in router.engines[src].migratable(),
           "pre": list(router.delivered(0))}
    ops = router.migrate(0, 1 - src)
    moved = {"owner": router.owner(0),
             "logged": router.transfer_log[-1] is ops,
             "src_knows": router.engines[src].request(0) is not None,
             "dst_knows": router.engines[1 - src].request(0) is not None}
    router.run_until_idle()
    out = _cluster(router, [0])
    events = {kind: [e["replica"] for eng in router.engines
                     for e in eng.obs.events.events if e["kind"] == kind]
              for kind in ("migrate_out", "migrate_in")}
    router.drain()
    out.update(src=src, mid=mid, moved=moved, events=events,
               bare=list(ref.generated),
               ledgers=[dataclasses.asdict(e.block_accounting())
                        for e in router.engines])
    return out


def case_divergence(s):
    router = s.Router([s.engine(), s.engine()], routing="least-loaded",
                      rebalance_every=0)
    router.submit(s.Request(0, list(range(1, 17)), max_new_tokens=8))
    _decode_until(router, 0, 2)
    src = router.owner(0)
    ok = router.migrate(0, 1 - src) is not None
    router.engines[1 - src].request(0).generated[0] += 1
    try:
        router.poll()
        raised = False
    except s.Divergence:
        raised = True
    return {"migrated": ok, "raised": raised, **_cluster(router, [0])}


def case_rebalance(s):
    shared = list(range(400, 424))
    router = s.Router([s.engine(), s.engine()], routing="affinity",
                      rebalance_every=2, rebalance_skew=2)
    reqs = [s.Request(i, shared + [500 + 2 * i, 501 + 2 * i],
                      max_new_tokens=8) for i in range(4)]
    bare = s.engine()
    ref = [s.Request(i, list(r.prompt), max_new_tokens=8)
           for i, r in enumerate(reqs)]
    for r in ref:
        bare.add_request(r)
    bare.run_until_idle(max_steps=2000)
    for r in reqs:
        router.submit(r)
    owners0 = {router.owner(r.rid) for r in reqs}
    router.run_until_idle()
    out = _cluster(router, [r.rid for r in reqs])
    out.update(owners0=sorted(owners0), migrations=router.migrations,
               bare=[list(r.generated) for r in ref])
    return out


def case_aborts(s):
    router = s.Router([s.engine(), s.engine()], routing="least-loaded",
                      rebalance_every=0)
    req = s.Request(0, list(range(1, 17)), max_new_tokens=4)
    router.submit(req)
    src = router.owner(0)
    router.step()
    early = None
    if 0 not in router.engines[src].migratable():
        early = {"plan": router.migrate(0, 1 - src),
                 "owner": router.owner(0),
                 "same": router.engines[src].request(0) is req}
    router.run_until_idle()
    late = router.migrate(0, 1 - src)
    out = _cluster(router, [0])
    out.update(src=src, early=early, late=late, gen=list(req.generated))
    return out


def case_dump(s):
    router = s.Router([s.engine(), s.engine()], routing="round-robin",
                      rebalance_every=0)
    for r in s.reqs(4, max_new=4):
        router.submit(r)
    router.run_until_idle()
    out = _cluster(router, list(range(4)))
    out.update(per=sum(e.obs.registry.counter_total(
        "requests_finished_total") for e in router.engines),
        prom=router.merged_registry().to_prometheus())
    return out


CASES = {"parity-mixed": lambda s: case_parity(s, True),
         "parity-serialized": lambda s: case_parity(s, False),
         "affinity": case_affinity, "round-robin": case_round_robin,
         "migration": case_migration, "divergence": case_divergence,
         "rebalance": case_rebalance, "aborts": case_aborts,
         "dump": case_dump}


@pytest.fixture(scope="module")
def runs(weights):
    """Every case on both sides: {case: {side: result}}."""
    sides = {name: Side(name, weights) for name in ("reference", "port")}
    return {case: {name: fn(s) for name, s in sides.items()}
            for case, fn in CASES.items()}


def _port(runs, case):
    """The port's result of ``case``, after checking it JSON-equal to the
    reference's."""
    want, got = runs[case]["reference"], runs[case]["port"]
    assert got.keys() == want.keys()
    for key in want:
        assert _js(got[key]) == _js(want[key]), (case, key)
    return got


# ---------------------------------------------------------------------------
# TransferOp units (model-free)
# ---------------------------------------------------------------------------
def test_transfer_op_validation():
    with pytest.raises(ValueError):
        TransferOp("teleport", 0, 0, 1)
    with pytest.raises(ValueError):
        TransferOp("kv_block", 0, 0, 1)       # missing block ids
    op = TransferOp("kv_block", 0, 0, 1, src_block=3, dst_block=7,
                    logical=0, tokens=8)
    with pytest.raises(Exception):            # frozen
        op.tokens = 9
    ref = jcluster.TransferOp("kv_block", 0, 0, 1, src_block=3, dst_block=7,
                              logical=0, tokens=8)
    assert dataclasses.asdict(op) == dataclasses.asdict(ref)


def test_build_transfer_plan_shapes():
    export = {"state": {"rid": 5, "prefilled": 19},
              "src_blocks": [3, 4, 9], "block_size": 8}
    ops = build_transfer_plan(export, [1, 2, 6], 0, 1)
    assert [dataclasses.asdict(o) for o in ops] == [
        dataclasses.asdict(o)
        for o in jcluster.build_transfer_plan(export, [1, 2, 6], 0, 1)]
    assert [o.kind for o in ops] == ["state"] + ["kv_block"] * 3
    assert all(o.rid == 5 and o.src_replica == 0 and o.dst_replica == 1
               for o in ops)
    assert [(o.src_block, o.dst_block, o.logical) for o in ops[1:]] \
        == [(3, 1, 0), (4, 2, 1), (9, 6, 2)]
    assert [o.tokens for o in ops[1:]] == [8, 8, 3]
    with pytest.raises(ValueError):
        build_transfer_plan(export, [1, 2], 0, 1)   # count mismatch


def test_router_rejects_unknown_policy_and_empty():
    with pytest.raises(ValueError):
        Router([], routing="affinity")
    with pytest.raises(ValueError):
        Router([object()], routing="teleport")
    assert ROUTING_POLICIES == jcluster.ROUTING_POLICIES
    assert "affinity" in ROUTING_POLICIES


# ---------------------------------------------------------------------------
# N=1 parity: the Router is a drop-in ServingClient over one engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "serialized"])
def test_single_replica_router_parity(runs, mixed):
    got = _port(runs, "parity-mixed" if mixed else "parity-serialized")
    assert got["is_client"] and got["submitted"] == [0, 1, 2]
    assert got["gen"] == got["bare"]                  # bit-identical
    for rid, stream in enumerate(got["bare"]):
        assert got["streams"][rid] == stream == got["delivered"][rid]
    assert got["stats"]["replicas"][0]["config_counts"] == \
        got["bare_counts"]
    assert got["cancel"] is False


# ---------------------------------------------------------------------------
# affinity: a shared prefix prefills ONCE cluster-wide
# ---------------------------------------------------------------------------
def test_affinity_prefills_shared_prefix_once_cluster_wide(runs):
    got = _port(runs, "affinity")
    assert len(set(got["owners0"])) == 1        # all stuck to one replica
    assert got["saved"] == 3 * 24
    idle = 1 - got["owners0"][0]
    assert got["prefill"][idle] == 0


def test_round_robin_scatters_and_wastes_prefills(runs):
    got = _port(runs, "round-robin")
    assert set(got["owners0"]) == {0, 1}
    assert got["saved"] == 2 * 24               # once per replica


# ---------------------------------------------------------------------------
# live migration: exactly-once, bit-identical
# ---------------------------------------------------------------------------
def test_mid_stream_migration_is_exactly_once_bit_identical(runs):
    got = _port(runs, "migration")
    src, mid, moved = got["src"], got["mid"], got["moved"]
    assert mid["n"] >= 3 and not mid["done"] and mid["migratable"]
    assert moved == {"owner": 1 - src, "logged": True, "src_knows": False,
                     "dst_knows": True}
    ops = got["transfers"][0]
    assert ops[0]["kind"] == "state"
    assert all(o["kind"] == "kv_block" for o in ops[1:])
    assert sum(o["tokens"] for o in ops[1:]) >= 16
    final = got["delivered"][0]
    assert final[:len(mid["pre"])] == mid["pre"]   # exactly-once
    assert final == got["bare"]                    # bit-identical
    assert got["stats"]["migrations"] == 1
    assert got["stats"]["migrated_blocks"] == len(ops) - 1
    assert got["events"] == {"migrate_out": [src], "migrate_in": [1 - src]}
    for led in got["ledgers"]:
        assert led["used"] == 0 and led["pinned"] == 0


def test_delivery_log_catches_divergence_after_migration(runs):
    got = _port(runs, "divergence")
    assert got["migrated"] and got["raised"]


def test_rebalance_migrates_under_skew(runs):
    got = _port(runs, "rebalance")
    assert len(got["owners0"]) == 1
    assert got["migrations"] >= 1
    for rid, stream in enumerate(got["bare"]):
        assert got["delivered"][rid] == stream


def test_migration_aborts_leave_source_intact(runs):
    got = _port(runs, "aborts")
    if got["early"] is not None:
        assert got["early"] == {"plan": None, "owner": got["src"],
                                "same": True}
    assert got["late"] is None
    assert got["delivered"][0] == got["gen"]


# ---------------------------------------------------------------------------
# merged observability
# ---------------------------------------------------------------------------
def test_cluster_dump_is_one_schema_valid_view(runs, weights, tmp_path):
    got = _port(runs, "dump")
    dump = got["dump"]
    assert dump["source"] == "cluster"
    assert {rec["replica"] for rec in dump["steps"]} == {0, 1}
    assert all("replica" in e for e in dump["events"])
    starts = [rec["t_start"] for rec in dump["steps"]]
    assert starts == sorted(starts)
    merged = {c["name"]: c["value"] for c in dump["metrics"]["counters"]}
    assert merged["requests_finished_total"] == got["per"] == 4
    assert "repro_requests_finished_total 4" in got["prom"]
    # the files, on a fresh port cluster
    s = Side("port", weights)
    router = Router([s.engine(), s.engine()], routing="round-robin",
                    rebalance_every=0)
    for r in s.reqs(4, max_new=4):
        router.submit(r)
    router.run_until_idle()
    router.write_prometheus(str(tmp_path / "cluster.prom"))
    router.write_json(str(tmp_path / "cluster.json"))
    assert "repro_requests_finished_total 4" in \
        (tmp_path / "cluster.prom").read_text()
    assert json.loads((tmp_path / "cluster.json").read_text())["source"] \
        == "cluster"


def test_merge_snapshots_sums_counters_maxes_peaks():
    snaps = []
    for Reg in (MetricsRegistry, JaxRegistry):
        a, b = Reg(), Reg()
        a.counter("requests_arrived_total").inc(3)
        b.counter("requests_arrived_total").inc(4)
        a.gauge("free_blocks").set(5)
        b.gauge("free_blocks").set(7)
        a.gauge("shared_blocks_peak").set_max(9)
        b.gauge("shared_blocks_peak").set_max(2)
        a.histogram("step_seconds").observe(0.01)
        b.histogram("step_seconds").observe(0.02)
        snaps.append((a.snapshot(), b.snapshot()))
    merged = MetricsRegistry().load_state(merge_snapshots(list(snaps[0])))
    assert _js(merge_snapshots(list(snaps[0]))) == \
        _js(jax_merge(list(snaps[1])))
    assert merged.counter_total("requests_arrived_total") == 7
    assert merged.gauge_value("free_blocks") == 12          # cluster total
    assert merged.gauge_value("shared_blocks_peak") == 9    # max, not sum
    h = merged.histogram("step_seconds")
    assert h.count == 2 and abs(h.sum - 0.03) < 1e-12


# ---------------------------------------------------------------------------
# ServeSim mirror
# ---------------------------------------------------------------------------
def test_sim_multi_replica_routing_ab():
    """The port's ServeSim routing mirror against the reference's, priced
    at the same hardware numbers: equal reuse under each policy."""
    from repro.configs import get_config as jax_config
    from repro.roofline.terms import H200 as JaxH200
    from repro.sim.costmodel import CostModel as JaxCostModel
    from repro.sim.simulator import ServeSim as JaxServeSim
    from repro.sim.simulator import SimRequest as JaxSimRequest
    from repro_torch.roofline import Hardware
    from repro_torch.sim.costmodel import CostModel
    from repro_torch.sim.simulator import ServeSim, SimRequest

    hw = Hardware(**dataclasses.asdict(JaxH200))

    def run(routing, port):
        Sim, CM, Req = ((ServeSim, CostModel, SimRequest) if port else
                        (JaxServeSim, JaxCostModel, JaxSimRequest))
        cfg = (get_config if port else jax_config)("qwen3-8b")
        sim = Sim(CM(cfg, hw=hw if port else JaxH200), "shift", n_chips=8,
                  prefill_chunk=512, prefix_cache=True, replicas=2,
                  routing=routing)
        sim.run([Req(i, 0.05 * i, 256 + 64, 16, prefix_id=0,
                     prefix_len=256) for i in range(8)])
        return sim

    saved = {}
    for routing in ROUTING_POLICIES:
        port, ref = run(routing, True), run(routing, False)
        assert port.prefill_tokens_saved == ref.prefill_tokens_saved
        assert len(port.reps) == len(ref.reps) == 2
        saved[routing] = port.prefill_tokens_saved
    assert saved["affinity"] == 7 * 256 and saved["round-robin"] == 6 * 256
    assert saved["least-loaded"] >= saved["round-robin"]


# ---------------------------------------------------------------------------
# facade enforcement: nobody outside the engine touches its privates
# ---------------------------------------------------------------------------
def test_no_engine_private_state_outside_engine():
    """Grep-enforced API boundary of the port: engine internals (private
    attributes, the slot table, the raw KV object) are reachable only from
    inside ``src/repro_torch/engine/`` (and ``cache/``, which owns the kv
    objects). The cluster, launch, sim and the rest go through the
    ServingClient facade."""
    forbidden = [r"\._snap_ring", r"\._bt_host", r"\._step_copies",
                 r"\._inflight", r"\._prefill_done", r"\._release_slot",
                 r"\._apply_copies\(", r"\.slot_req", r"\._retryable",
                 r"\.kv\."]
    pat = re.compile("|".join(forbidden))
    base = os.path.join(ROOT, "src", "repro_torch")
    offenders, seen = [], 0
    for dirpath, _, names in os.walk(base):
        rel = os.path.relpath(dirpath, base)
        if rel.split(os.sep)[0] in ("engine", "cache"):
            continue
        for name in names:
            if not name.endswith(".py"):
                continue
            seen += 1
            path = os.path.join(dirpath, name)
            with open(path) as f:
                for ln, line in enumerate(f, 1):
                    if pat.search(line):
                        offenders.append(f"{os.path.relpath(path, ROOT)}:"
                                         f"{ln}: {line.strip()}")
    assert seen > 20
    assert not offenders, \
        "engine private state accessed outside src/repro_torch/engine/:\n" \
        + "\n".join(offenders)


# ---------------------------------------------------------------------------
# the repair: engines on one Model share its weights, not its caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "serialized"])
def test_two_engines_on_one_model_own_their_pools(weights, mixed):
    """Two engines built on one ``Model``, stepped in turns, each over its
    own pool (the parameters are the model's own tensors): their streams
    equal two lone engines' on their own models, and the model itself
    holds no cache."""
    _, _, model = weights
    ecfg = dict(max_slots=4, s_max=64, prefill_chunk=8, block_size=8,
                mixed=mixed)
    prompts = [[list(range(1, 12 + 3 * i)) for i in range(3)],
               [list(range(40, 50 + 2 * i)) for i in range(3)]]

    def reqs(k):
        return [peng.Request(i, p, max_new_tokens=6)
                for i, p in enumerate(prompts[k])]

    a, b = (peng.ShiftEngine(model, peng.EngineConfig(**ecfg))
            for _ in range(2))
    assert a.base.pool is not b.base.pool and model.pool is None
    assert a.base.params is b.base.params is model.params
    ra, rb = reqs(0), reqs(1)
    for r in ra:
        a.submit(r)
    for r in rb:
        b.submit(r)
    while a.queue or b.queue:                 # interleaved
        a.step()
        b.step()
    want = []
    for k in range(2):
        lone = Model(model.cfg, device="cpu", dtype=torch.float32)
        lone.load_params(model.params.state_dict())
        eng = peng.ShiftEngine(lone, peng.EngineConfig(**ecfg))
        rs = reqs(k)
        for r in rs:
            eng.submit(r)
        eng.run_until_idle()
        want.append([r.generated for r in rs])
    assert [[r.generated for r in ra], [r.generated for r in rb]] == want
    assert all(len(s) == 6 for s in want[0] + want[1])


# ---------------------------------------------------------------------------
# the serve CLI's cluster and reshard demo
# ---------------------------------------------------------------------------
def test_cli_replicas_and_reshard_demo(capsys, tmp_path):
    """``--replicas 2 --routing affinity`` serves the workload through the
    Router (the reference's cluster summary, the merged dump under
    ``--metrics-out``), and ``--reshard-demo --backend gloo`` reshards a
    (2, 1, 1) engine to (1, 1, 2) and back on two ranks and exits 0 with
    ``PASS``."""
    from repro_torch.launch import serve
    base = ["--reduced", "--device", "cpu", "--dtype", "fp32",
            "--requests", "4", "--max-new", "6"]
    out = tmp_path / "m.json"
    serve.main(base + ["--replicas", "2", "--routing", "affinity",
                       "--prefix-cache", "--shared-prefix", "16",
                       "--metrics-out", str(out)])
    text = capsys.readouterr().out
    assert "cluster: 2 replicas, routing=affinity" in text
    assert "[replica 0] configs used" in text and "[replica 1]" in text
    assert re.search(r"^cluster: \d+ migrations \(\d+ KV blocks moved\), "
                     r"routing=affinity, \d+ router steps$", text,
                     re.MULTILINE)
    assert len(re.findall(r"^req \d: 6 tokens, reason=ok", text,
                          re.MULTILINE)) == 4
    dump = json.loads(out.read_text())
    assert dump["source"] == "cluster"
    with pytest.raises(SystemExit) as e:        # requests live past both
        serve.main(base[:-1] + ["12", "--reshard-demo", "--backend", "gloo"])
    text = capsys.readouterr().out
    assert e.value.code == 0
    assert "grow: 4 requests" in text and "shrink: 4 requests" in text
    assert "PASS: streams bit-identical across grow+shrink" in text
