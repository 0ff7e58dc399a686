"""The port's typed serving API against the reference's: the nested
``EngineConfig`` groups, the frozen results (``PrefixStats``,
``BlockLedger``, ``EngineStats``, ``ClusterStats``) with their dict
surface, and the ``ServingClient`` protocol (the cases of the reference's
``tests/test_api.py`` on the port's types); ``ShiftEngine`` as a
``ServingClient``, its ``stats()`` and ``prefix_probe`` equal to the
reference's after the same run; ``serve_loop`` under an injected clock;
the serve CLI with the fault and snapshot flags on the CPU, at one rank
and at ``--dp 2``; and the reference's end-to-end serve case
(``tests/test_system.py``) through the port's ``build_engine``.
"""
import itertools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.engine import (BlockLedger, ClusterStats,  # noqa: E402
                                EngineConfig, EngineStats, FaultConfig,
                                ObsConfig, PrefixConfig, PrefixStats,
                                Request, ServingClient, ShiftEngine)
from repro_torch.launch import serve  # noqa: E402


# ---------------------------------------------------------------------------
# nested config groups; flat write kwargs removed
# ---------------------------------------------------------------------------
def test_nested_groups_construct():
    cfg = EngineConfig(prefix=PrefixConfig(enabled=True),
                       fault=FaultConfig(max_queue=4, deadline_s=1.5),
                       obs=ObsConfig(window=64, event_cap=128))
    assert cfg.prefix.enabled
    assert cfg.fault.max_queue == 4 and cfg.fault.deadline_s == 1.5
    assert cfg.obs.window == 64 and cfg.obs.event_cap == 128


def test_flat_write_kwargs_removed():
    for bad in (dict(prefix_cache=True), dict(max_queue=7),
                dict(shed_policy="evict-longest-queued"),
                dict(deadline_s=2.0), dict(auto_snapshot_every=3)):
        with pytest.raises(TypeError):
            EngineConfig(**bad)


def test_obs_bool_removed():
    with pytest.raises(TypeError):
        EngineConfig(obs=True)
    with pytest.raises(TypeError):
        EngineConfig(obs=False)
    off = EngineConfig(obs=ObsConfig(enabled=False))
    assert isinstance(off.obs, ObsConfig) and not bool(off.obs)
    assert bool(EngineConfig().obs)      # default stays enabled


def test_back_compat_read_properties():
    cfg = EngineConfig(prefix=PrefixConfig(enabled=True),
                       fault=FaultConfig(max_queue=9, straggler_factor=4.0,
                                         quarantine_after=5, retry_backoff=1,
                                         auto_snapshot_every=4,
                                         snapshot_keep=3))
    assert cfg.prefix_cache is True
    assert cfg.max_queue == 9
    assert cfg.straggler_factor == 4.0
    assert cfg.shed_policy == FaultConfig().shed_policy
    assert (cfg.quarantine_after, cfg.retry_backoff, cfg.auto_snapshot_every,
            cfg.snapshot_keep, cfg.spec_k) == (5, 1, 4, 3, 0)


def test_unknown_kwarg_raises():
    with pytest.raises(TypeError):
        EngineConfig(definitely_not_a_knob=1)


# ---------------------------------------------------------------------------
# typed stats records: frozen, dict-compatible
# ---------------------------------------------------------------------------
def test_prefix_stats_mapping_compat():
    s = PrefixStats(entries=3, hits=2, misses=1, tokens_saved=16,
                    evictions=0, cow_copies=4, paged_disabled_reason=None)
    assert s["hits"] == 2 and s["tokens_saved"] == 16
    assert "entries" in s and "nope" not in s
    with pytest.raises(KeyError):
        s["nope"]
    d = s.as_dict()
    assert d["cow_copies"] == 4 and s == d
    with pytest.raises(Exception):       # frozen
        s.hits = 5


def test_block_ledger_mapping_compat():
    led = BlockLedger(used=2, pinned=1, free=5, free_per_row=(5,))
    assert led["used"] == 2 and led["pinned"] == 1
    assert led == {"used": 2, "pinned": 1, "free": 5, "free_per_row": (5,)}
    assert led != {"used": 0, "pinned": 0}   # strict, not subset
    empty = BlockLedger()
    assert empty.used == 0 and empty.pinned == 0


def test_cluster_stats_sums_over_replicas():
    def mk(queue, active):
        return EngineStats(
            steps=1, queue_depth=queue, active=active, preemptions=0,
            config_counts={"base": 1, "shift": 0}, paged=True,
            paged_disabled_reason=None, dp=1, block_size=16,
            blocks_per_row=8, free_blocks=8, queued_block_demand=0,
            prefix=PrefixStats(0, 0, 0, 0, 0, 0, None),
            blocks=BlockLedger(), replica=0)
    cs = ClusterStats(replicas=(mk(2, 1), mk(0, 3)), routing="affinity",
                      steps=5, migrations=1, migrated_blocks=3)
    assert cs.queue_depth == 2 and cs.active == 4
    assert cs.migrations == 1 and cs.routing == "affinity"


def test_serving_client_is_runtime_checkable():
    class Stub:
        def submit(self, req):
            return 0

        def cancel(self, rid):
            return False

        def step(self):
            return False

        def stream(self, rid):
            return []

        def stats(self):
            return None

    assert isinstance(Stub(), ServingClient)

    class NotAClient:
        pass

    assert not isinstance(NotAClient(), ServingClient)


def test_types_match_reference():
    """Every field of the port's records and groups, with its default,
    is the reference's."""
    import dataclasses
    from repro.engine import api as japi
    from repro_torch.engine import api as papi
    for name in ("PrefixConfig", "FaultConfig", "ObsConfig", "PrefixStats",
                 "BlockLedger", "EngineStats", "ClusterStats"):
        mine, ref = getattr(papi, name), getattr(japi, name)
        assert [f.name for f in dataclasses.fields(mine)] == \
            [f.name for f in dataclasses.fields(ref)], name
        if name not in ("EngineStats", "ClusterStats"):
            assert dataclasses.asdict(mine()) == dataclasses.asdict(ref()), \
                name


# ---------------------------------------------------------------------------
# the engine as a ServingClient, against the reference's
# ---------------------------------------------------------------------------
def _fake_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


@pytest.fixture(scope="module")
def engines():
    """Factories of the reference's and the port's engine (reduced
    qwen3-8b at fp32, the reference's weights; 4 slots, s_max 64, chunk
    8, blocks of 8, the prefix cache on, threshold 4), each with its own
    fake clock."""
    import jax
    import jax.numpy as jnp
    from conftest import reduced_cfg
    from repro import engine as jeng
    from repro.core.policy import ThresholdPolicy as JaxPolicy
    from repro.models import build_model
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_params
    from repro_torch.models import Model
    jm = build_model(reduced_cfg("qwen3-8b"), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    params = jax.tree.map(jnp.asarray, tree)
    cfg = get_config("qwen3-8b").reduced()
    model = Model(cfg, device="cpu", dtype=torch.float32)
    model.load_params(from_jax_params(tree, cfg))
    kw = dict(max_slots=4, s_max=64, prefill_chunk=8, threshold=4,
              block_size=8)

    def reference():
        return jeng.ShiftEngine(
            jm, jm, params, params,
            jeng.EngineConfig(prefix=jeng.PrefixConfig(enabled=True), **kw),
            policy=JaxPolicy(4), now=_fake_clock()), jeng.Request

    def port():
        return ShiftEngine(model, EngineConfig(
            prefix=PrefixConfig(enabled=True), **kw),
            now=_fake_clock()), Request

    return reference, port


def _drive(make):
    eng, Req = make()
    shared = list(range(1, 17))
    for i in range(4):
        eng.submit(Req(i, shared + list(range(30 + 5 * i, 34 + 6 * i)),
                       max_new_tokens=5))
    mid = None
    for n in range(200):
        if not eng.step() and not eng.queue:
            break
        if n == 2:
            mid = eng.stats().as_dict()
    probes = [eng.prefix_probe(t) for t in (
        shared + [99], shared[:9], [1], list(range(50, 70)),
        shared + list(range(30, 34)) + [7])]
    return eng, mid, eng.stats().as_dict(), probes


def test_engine_is_a_serving_client(engines):
    eng, Req = engines[1]()
    assert isinstance(eng, ServingClient)
    rid = eng.submit(Req(7, list(range(1, 12)), max_new_tokens=3))
    assert rid == 7
    while eng.step():
        pass
    assert eng.stream(7) == eng.request(7).generated and len(eng.stream(7)) == 3
    assert not eng.cancel(7)
    st = eng.stats()
    assert isinstance(st, EngineStats) and st.steps == eng.step_count
    assert st.queue_depth == st.active == 0
    assert st.blocks.used == st.blocks.pinned == st.prefix.entries
    assert st["paged"] is True and st.replica is None


def test_stats_and_prefix_probe_match_reference(engines):
    (_, rmid, rend, rprobe), (eng, mid, end, probe) = (
        _drive(make) for make in engines)
    assert mid == rmid and mid["queue_depth"] + mid["active"] == 4
    assert end == rend
    assert probe == rprobe and max(probe) == 16 and probe[1] == 8
    assert end["prefix"]["hits"] > 0
    eng.set_replica(3)
    assert eng.stats().replica == 3 and eng.obs.replica == 3


def test_serve_loop_refreshes_prometheus(engines, tmp_path):
    """``serve_loop`` under an injected refresh clock: the same number of
    refreshes as the reference's ``serve_loop`` and the same final
    ``.prom`` text (both engines under fake clocks)."""
    from repro.launch.serve import serve_loop as jax_serve_loop
    out = []
    for (make, loop) in zip(engines, (jax_serve_loop, serve.serve_loop)):
        eng, Req = make()
        for i in range(3):
            eng.submit(Req(i, list(range(1, 12 + i)), max_new_tokens=4))
        prom = tmp_path / f"{len(out)}.prom"
        ticks = itertools.count()
        n = loop(eng, refresh_s=2.5, prom_path=str(prom),
                 now=lambda: float(next(ticks)))
        out.append((n, prom.read_text(), eng.step_count))
    assert out[1] == out[0]
    n, text, steps = out[1]
    assert n == steps // 3 + 1 and n > 2
    assert "requests_finished_total 3" in text
    # without a refresh it runs to idle and writes nothing
    eng, Req = engines[1]()
    eng.submit(Req(0, [1, 2, 3], max_new_tokens=2))
    assert serve.serve_loop(eng, prom_path=str(tmp_path / "x.prom")) == 0
    assert not (tmp_path / "x.prom").exists() and not eng.queue


# ---------------------------------------------------------------------------
# the serve CLI and build_engine on the CPU
# ---------------------------------------------------------------------------
CPU = ["--reduced", "--device", "cpu", "--dtype", "fp32"]


def test_cli_with_faults_and_snapshots(capsys, tmp_path):
    serve.main(CPU)
    clean = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("req ")]
    m = tmp_path / "m.json"
    serve.main(CPU + ["--fault-seed", "3", "--auto-snapshot-every", "4",
                      "--metrics-out", str(m), "--metrics-refresh-s",
                      "1e-9"])
    out = capsys.readouterr().out
    assert "fault plan: seed=3 13 faults over 64 steps" in out
    faulted = [ln for ln in out.splitlines() if ln.startswith("req ")]
    # the same tokens and outcomes; TTFTs move with the retries
    strip = [ln.split(", ttft=")[0] + ln.split("ms")[1] for ln in clean]
    assert [ln.split(", ttft=")[0] + ln.split("ms")[1]
            for ln in faulted] == strip
    assert "reason=ok" in faulted[0]
    line = next(ln for ln in out.splitlines()
                if ln.startswith("fault tolerance:"))
    assert "13 faults planned" in line and "2 snapshots retained" in line
    assert "live metrics:" in out and Path(str(m)[:-5] + ".prom").exists()
    with pytest.raises(SystemExit):
        serve.main(CPU + ["--metrics-refresh-s", "1"])


def test_cli_faults_at_dp2(capsys):
    serve.main(CPU + ["--dp", "2", "--backend", "gloo", "--requests", "4",
                      "--max-new", "6", "--fault-seed", "5", "--p-fault",
                      "0.1", "--auto-snapshot-every", "3"])
    out = capsys.readouterr().out
    assert "fault plan: seed=5" in out
    assert "every rank's streams are equal" in out
    reqs = [ln for ln in out.splitlines() if ln.startswith("req ")]
    assert len(reqs) == 4 and {ln.split("row=")[1][0] for ln in reqs} == \
        {"0", "1"}
    line = next(ln for ln in out.splitlines()
                if ln.startswith("fault tolerance:"))
    assert "snapshots retained (every 3 steps)" in line


def test_serve_end_to_end():
    eng = serve.build_engine("qwen3-8b", reduced=True, device="cpu",
                             dtype=torch.float32, slots=4, s_max=64, chunk=8,
                             threshold=4)
    reqs = [Request(i, list(range(1, 10 + i)), max_new_tokens=5)
            for i in range(4)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_idle()
    assert all(len(r.generated) == 5 for r in reqs)
    assert "base" in eng.config_trace and "shift" in eng.config_trace
    assert (eng.cfg.max_slots, eng.cfg.s_max, eng.cfg.prefill_chunk,
            eng.policy.threshold) == (4, 64, 8, 4)
