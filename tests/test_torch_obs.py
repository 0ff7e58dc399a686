"""The port's observability (``repro_torch.obs``) against the reference's
``repro.obs``, and the engine's dump against the reference engine's.

* The schema's tables equal the reference's, table by table.
* The registry and the event log, fed the same calls (made from a numpy
  seed), give the reference's ``snapshot()``, ``to_prometheus()`` text,
  ``state_dict`` round trip, merged snapshot and event state, string for
  string; the port's copies of the reference's own checks
  (``tests/test_obs.py``) hold.
* Under one fake clock (``lambda: next(c) * 1e-3``, each engine its own),
  on reduced qwen3-8b at fp32 with the reference's weights, the port's
  ``obs.dump()``, ``build_report`` and ``chrome_trace`` are JSON-equal to
  the reference's: the mixed paged, serialized paged and serialized dense
  iterations, the prefix cache with k=4 speculation, a tight pool that
  preempts, and an ``eos_id`` hit mid-stream. Tolerance: exact (host
  integers and fake-clock floats computed by the same arithmetic).
* The views: ``NullObs`` changes no stream, the rolling window stays
  bounded while the totals count, the starvation audit of
  ``tests/test_mixed.py``, lifecycle events and a valid Chrome trace.
* The serve CLI's ``--metrics-out``/``--trace-out`` files and
  ``python -m repro_torch.obs``.
"""
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core.policy import ThresholdPolicy as JaxPolicy  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import ObsConfig as JaxObsConfig  # noqa: E402
from repro.engine import PrefixConfig as JaxPrefixConfig  # noqa: E402
from repro.engine import Request as JaxRequest  # noqa: E402
from repro.engine import ShiftEngine as JaxEngine  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.obs.events import EventLog as JaxEventLog  # noqa: E402
from repro.obs.report import percentile as jax_percentile  # noqa: E402
from repro.spec import SpecConfig as JaxSpecConfig  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.policy import ThresholdPolicy  # noqa: E402
from repro_torch.engine import (EngineConfig, ObsConfig,  # noqa: E402
                                PrefixConfig, Request, ShiftEngine)
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs import (MetricsRegistry, build_report,  # noqa: E402
                             chrome_trace, schema)
from repro_torch.obs.events import EventLog  # noqa: E402
from repro_torch.obs.report import percentile  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _js(x):
    return json.dumps(x, sort_keys=True)


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------
TABLES = ("SCHEMA_VERSION", "PROM_PREFIX", "CONFIGS", "COUNTERS", "SEAMS",
          "GAUGES", "LATENCY_BOUNDS", "TOKEN_BOUNDS", "HISTOGRAMS", "EVENTS",
          "STEP_REQUIRED", "STEP_OPTIONAL", "CORE_COUNTERS")


@pytest.mark.parametrize("table", TABLES)
def test_schema_table_equals_reference(table):
    assert getattr(schema, table) == getattr(jobs.schema, table)


@pytest.mark.parametrize("rec", [
    {"step": 0, "t_start": 0.0, "dur_s": 0.0, "config": None,
     "prefill_tokens": 0, "decode_tokens": 0, "ready_decodes": 0,
     "attn_ctx_tokens": 0},
    {"step": 0, "t_start": 0.0, "dur_s": 0.0, "config": "base"},
    {"step": 0, "t_start": 0.0, "dur_s": 0.0, "config": "bogus",
     "prefill_tokens": 0, "decode_tokens": 0, "ready_decodes": 0,
     "attn_ctx_tokens": 0},
    {"step": 0, "t_start": 0.0, "dur_s": 0.0, "config": "shift",
     "prefill_tokens": 0, "decode_tokens": 0, "ready_decodes": 0,
     "attn_ctx_tokens": 0, "made_up": 1}],
    ids=["ok", "missing", "bad-config", "undeclared"])
def test_step_record_check_matches_reference(rec):
    def outcome(check):
        try:
            check(dict(rec))
        except ValueError as e:
            return str(e)
        return None
    assert outcome(schema.check_step_record) == \
        outcome(jobs.schema.check_step_record)


# ---------------------------------------------------------------------------
# registry, events and report against the reference
# ---------------------------------------------------------------------------
def _calls(seed, n=300):
    """A seeded sequence of registry calls over the whole schema:
    (kind, name, labels, value)."""
    rng = np.random.default_rng(seed)
    counters, gauges = sorted(schema.COUNTERS), sorted(schema.GAUGES)
    hists = sorted(schema.HISTOGRAMS)
    out = []
    for _ in range(n):
        kind = ("inc", "set", "set_max", "observe")[rng.integers(4)]
        if kind == "inc":
            name = counters[rng.integers(len(counters))]
            value = float(rng.integers(0, 5)) if rng.random() < 0.7 \
                else float(rng.random() * 3)
        elif kind == "observe":
            name = hists[rng.integers(len(hists))]
            value = float(rng.lognormal(-4, 3)) if name.endswith("seconds") \
                else float(rng.integers(0, 5000))
        else:
            name = gauges[rng.integers(len(gauges))]
            value = float(rng.integers(0, 100)) if rng.random() < 0.5 \
                else float(rng.random() * 100)
        labels = {}
        table = {"inc": schema.COUNTERS, "observe": schema.HISTOGRAMS}.get(
            kind, schema.GAUGES)
        for key in table[name][1]:
            vals = schema.CONFIGS if key == "config" else schema.SEAMS
            labels[key] = vals[rng.integers(len(vals))]
        out.append((kind, name, labels, value))
    return out


def _apply(reg, calls):
    for kind, name, labels, value in calls:
        if kind == "inc":
            reg.counter(name, **labels).inc(value)
        elif kind == "observe":
            reg.histogram(name, **labels).observe(value)
        elif kind == "set":
            reg.gauge(name, **labels).set(value)
        else:
            reg.gauge(name, **labels).set_max(value)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_matches_reference(seed):
    mine = _apply(MetricsRegistry(), _calls(seed))
    ref = _apply(jobs.MetricsRegistry(), _calls(seed))
    assert _js(mine.snapshot()) == _js(ref.snapshot())
    assert mine.to_prometheus() == ref.to_prometheus()
    assert mine.emitted_names() == ref.emitted_names()
    for name in schema.COUNTERS:
        assert mine.counter_total(name) == ref.counter_total(name)
    back = MetricsRegistry().load_state(json.loads(_js(mine.state_dict())))
    ref_back = jobs.MetricsRegistry().load_state(ref.state_dict())
    assert _js(back.snapshot()) == _js(ref_back.snapshot()) \
        == _js(mine.snapshot())
    assert back.to_prometheus() == ref_back.to_prometheus()
    other = _apply(MetricsRegistry(), _calls(seed + 10)).snapshot()
    ref_other = _apply(jobs.MetricsRegistry(), _calls(seed + 10)).snapshot()
    assert _js(obs.merge_snapshots([mine.snapshot(), other])) == \
        _js(jobs.merge_snapshots([ref.snapshot(), ref_other]))


@pytest.mark.parametrize("seed", [0, 1])
def test_event_log_matches_reference(seed):
    rng = np.random.default_rng(seed)
    mine, ref = EventLog(cap=16), JaxEventLog(cap=16)
    for i in range(40):
        kind = schema.EVENTS[rng.integers(len(schema.EVENTS))]
        rid = None if rng.random() < 0.3 else int(rng.integers(8))
        attrs = {"row": int(rng.integers(2)), "tokens": int(rng.integers(64))}
        for log in (mine, ref):
            log.emit(kind, step=i, ts=i * 1e-3, rid=rid, **attrs)
    assert _js(mine.state_dict()) == _js(ref.state_dict())
    assert mine.dropped == ref.dropped == 24
    assert _js(mine.for_request(3)) == _js(ref.for_request(3))
    assert _js(EventLog().load_state(ref.state_dict()).state_dict()) == \
        _js(ref.state_dict())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentile_matches_reference(seed):
    xs = list(np.random.default_rng(seed).lognormal(0, 2, 17 + seed))
    for p in (0, 10, 50, 90, 99, 100):
        assert percentile(xs, p) == jax_percentile(xs, p)


# the port's copies of the reference's own checks (tests/test_obs.py)
def test_counter_is_monotone():
    reg = MetricsRegistry()
    c = reg.counter("requests_arrived_total")
    c.inc()
    c.inc(2.0)
    assert c.value == 3.0
    with pytest.raises(ValueError):
        c.inc(-1.0)


@pytest.mark.parametrize("call", [
    lambda reg: reg.counter("made_up_total"),
    lambda reg: reg.counter("requests_arrived_total", config="base"),
    lambda reg: reg.counter("steps_total"),
    lambda reg: reg.counter("steps_total", config="bogus"),
    lambda reg: reg.counter("faults_injected_total", seam="bogus"),
    lambda reg: reg.gauge("made_up_depth"),
    lambda reg: reg.histogram("made_up_seconds")],
    ids=["undeclared", "extra-label", "missing-label", "bad-config",
         "bad-seam", "gauge", "histogram"])
def test_registry_is_schema_strict(call):
    with pytest.raises(ValueError):
        call(MetricsRegistry())


def test_histogram_buckets_and_prometheus():
    reg = MetricsRegistry()
    h = reg.histogram("ttft_seconds")
    for v in (0.0001, 0.003, 0.003, 0.7, 500.0):
        h.observe(v)
    assert h.count == 5 and h.sum == pytest.approx(500.7062)
    assert h.buckets[-1] == 1                     # 500s > last bound
    reg.counter("steps_total", config="base").inc(3)
    reg.gauge("queue_depth").set(2)
    text = reg.to_prometheus()
    assert "# TYPE repro_ttft_seconds histogram" in text
    assert 'repro_steps_total{config="base"} 3' in text
    assert "repro_queue_depth 2" in text
    assert 'repro_ttft_seconds_bucket{le="+Inf"} 5' in text
    assert "repro_ttft_seconds_count 5" in text
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
              if ln.startswith("repro_ttft_seconds_bucket")]
    assert counts == sorted(counts)               # cumulative


def test_gauge_set_max():
    g = MetricsRegistry().gauge("shared_blocks_peak")
    g.set_max(4)
    g.set_max(2)
    assert g.value == 4.0


def test_event_log_schema_and_cap():
    log = EventLog(cap=4)
    with pytest.raises(ValueError):
        log.emit("made_up_kind", step=0, ts=0.0)
    for i in range(6):
        log.emit("queued", step=i, ts=float(i), rid=i)
    assert len(log.events) == 4 and log.dropped == 2
    assert log.events[0]["step"] == 2             # oldest dropped
    assert [e["seq"] for e in log.events] == [2, 3, 4, 5]


def test_percentile_linear_interpolation():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    for p in (0, 25, 50, 90, 99, 100):
        assert percentile(xs, p) == pytest.approx(np.percentile(xs, p))
    assert percentile([], 50) != percentile([], 50)          # NaN
    assert percentile([7.0], 99) == 7.0


def test_report_tables_match_reference():
    rng = np.random.default_rng(4)
    reps = []
    for label in ("a", "b"):
        dump = {"source": "engine", "metrics": {"counters": [
            {"name": "tokens_prefill_total", "labels": {}, "value": 40.0},
            {"name": "tokens_decode_total", "labels": {}, "value": 9.0}]},
            "steps": [{"step": i, "t_start": i * 0.01, "dur_s": 0.01,
                       "config": ("base", "shift", None)[i % 3],
                       "prefill_tokens": 4, "decode_tokens": 1,
                       "ready_decodes": 1, "attn_ctx_tokens": 9}
                      for i in range(9)],
            "events": [{"kind": k, "rid": i, "ts": float(rng.random()),
                        "ttft_s": float(rng.random()),
                        "tpot_s": float(rng.random()),
                        "e2e_s": float(rng.random()),
                        "queue_s": float(rng.random())}
                       for i in range(5)
                       for k in ("first_token", "finish", "admitted")]}
        reps.append((label, dump))
    mine = [(lab, build_report(d)) for lab, d in reps]
    ref = [(lab, jobs.build_report(d)) for lab, d in reps]
    assert _js(mine) == _js(ref)
    assert obs.format_report(mine[0][1]) == jobs.format_report(ref[0][1])
    assert obs.latency_throughput_table(mine) == \
        jobs.latency_throughput_table(ref)
    from repro.obs.report import format_table as jax_format_table
    from repro_torch.obs.report import format_table
    assert format_table(obs.latency_throughput_table(mine)) == \
        jax_format_table(jobs.latency_throughput_table(ref))


# ---------------------------------------------------------------------------
# the engine's dump against the reference's
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
    cfg = get_config("qwen3-8b").reduced()
    model = Model(cfg, device="cpu", dtype=torch.float32)
    model.load_params(from_jax_params(tree, cfg))
    return jm, jax.tree.map(jnp.asarray, tree), model


def _fake_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


BASE = dict(max_slots=4, s_max=64, prefill_chunk=8)
PROMPTS = [list(range(1, 12 + 3 * i)) for i in range(5)]
# the prefix + spec workload: a 16-token shared prefix before repetitive
# prompts, blocks of 8
PS_PROMPTS = [list(range(1000, 1016)) + ([2, 3, 4] * 4)[:9 + i]
              for i in range(4)]
CASES = {
    "mixed": (BASE, PROMPTS, 6),
    "serialized-paged": (dict(BASE, mixed=False), PROMPTS, 6),
    "serialized-dense": (dict(BASE, paged=False, mixed=False), PROMPTS, 6),
    "prefix-spec-k4": (dict(BASE, block_size=8, prefix=True, spec=4),
                       PS_PROMPTS, 10),
    "tight-pool": (dict(BASE, block_size=8, num_blocks=7), PROMPTS, 8),
    "eos": (dict(BASE, eos_id="from-reference"), PROMPTS, 6),
}


def _engine(side, weights, kw, now=None, obs_on=True):
    jm, params, model = weights
    kw = dict(kw)
    prefix, spec = kw.pop("prefix", False), kw.pop("spec", 0)
    now = now or _fake_clock()
    if side == "reference":
        return JaxEngine(jm, jm, params, params, JaxEngineConfig(
            prefix=JaxPrefixConfig(enabled=prefix),
            spec=JaxSpecConfig(k=spec), obs=JaxObsConfig(enabled=obs_on),
            **kw), policy=JaxPolicy(4), now=now), JaxRequest
    return ShiftEngine(model, EngineConfig(
        prefix=PrefixConfig(enabled=prefix), spec=SpecConfig(k=spec),
        obs=ObsConfig(enabled=obs_on), **kw), policy=ThresholdPolicy(4),
        now=now), Request


def _serve(side, weights, kw, prompts, n_new, **engine_kw):
    eng, make = _engine(side, weights, kw, **engine_kw)
    reqs = [make(i, list(p), max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_idle()
    return eng, reqs


@pytest.fixture(scope="module")
def case_runs(weights):
    out = {}
    for name, (kw, prompts, n_new) in CASES.items():
        if kw.get("eos_id") == "from-reference":
            # the token request 3 samples fifth: requests end early, at
            # different points of their streams
            _, reqs = _serve("reference", weights, BASE, prompts, n_new)
            kw = dict(kw, eos_id=reqs[3].generated[4])
        out[name] = {side: _serve(side, weights, kw, prompts, n_new)
                     for side in ("reference", "port")}
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_engine_dump_matches_reference(case_runs, case):
    (ref, rreqs), (eng, reqs) = (case_runs[case]["reference"],
                                 case_runs[case]["port"])
    assert [r.generated for r in reqs] == [r.generated for r in rreqs]
    want, got = ref.obs.dump(), eng.obs.dump()
    assert _js(got) == _js(want)
    assert _js(build_report(got)) == _js(jobs.build_report(want))
    assert obs.format_report(build_report(got)) == \
        jobs.format_report(jobs.build_report(want))
    assert _js(chrome_trace(got)) == _js(jobs.chrome_trace(want))
    assert eng.config_counts == ref.config_counts
    assert eng.step_log == ref.step_log
    assert eng.total_step_time == ref.total_step_time


def test_engine_cases_exercise_their_paths(case_runs):
    """Each case reaches what it is for."""
    def reg(case):
        return case_runs[case]["port"][0].obs.registry
    for case in CASES:
        assert reg(case).counter_value("steps_total", config="base") > 0
        assert reg(case).counter_value("steps_total", config="shift") > 0
    assert reg("tight-pool").counter_total("requests_preempted_total") > 0
    assert reg("prefix-spec-k4").counter_total("prefix_hits_total") > 0
    assert reg("prefix-spec-k4").counter_total("spec_accepted_total") > 0
    eos = case_runs["eos"]["port"][1]
    assert any(0 < len(r.generated) < 6 for r in eos)
    dense = case_runs["serialized-dense"]["port"][0]
    assert all(r["paged_disabled_reason"] for r in dense.step_log)
    assert not any("paged_disabled_reason" in r
                   for r in case_runs["mixed"]["port"][0].step_log)


def test_engine_stays_within_schema(case_runs):
    eng = case_runs["prefix-spec-k4"]["port"][0]
    names = eng.obs.registry.emitted_names()
    assert names["counters"] <= set(schema.COUNTERS)
    assert names["gauges"] <= set(schema.GAUGES)
    assert names["histograms"] <= set(schema.HISTOGRAMS)
    assert set(schema.CORE_COUNTERS) <= names["counters"]
    for r in eng.obs.step_records:
        schema.check_step_record(r)


def test_engine_lifecycle_events(case_runs):
    eng = case_runs["prefix-spec-k4"]["port"][0]
    ev = eng.obs.events
    for rid in range(4):
        kinds = [e["kind"] for e in ev.for_request(rid)]
        for k in ("queued", "routed", "admitted", "prefill_chunk",
                  "first_token", "finish"):
            assert k in kinds, (rid, k, kinds)
        assert kinds.index("queued") < kinds.index("admitted") \
            < kinds.index("first_token") < kinds.index("finish")
    fin = ev.for_request(0)[-1]
    assert fin["kind"] == "finish" and fin["n_out"] == 10
    assert fin["e2e_s"] > fin["ttft_s"]
    assert any(e["kind"] == "prefix_hit" for e in ev.events)


def test_chrome_trace_is_valid(case_runs):
    tr = chrome_trace(case_runs["mixed"]["port"][0].obs.dump())
    evs = tr["traceEvents"]
    for e in evs:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        if e["ph"] != "M":
            assert e["ts"] >= 0
    opens = {}
    for e in evs:
        if e["ph"] == "b":
            opens[e["id"]] = opens.get(e["id"], 0) + 1
        elif e["ph"] == "e":
            opens[e["id"]] -= 1
    assert opens and all(v == 0 for v in opens.values())
    steps = [e for e in evs if e["ph"] == "X"]
    assert len(steps) == len(case_runs["mixed"]["port"][0].step_log)
    json.dumps(tr)


# ---------------------------------------------------------------------------
# the views
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mixed", [None, False], ids=["mixed", "serialized"])
def test_nullobs_engine_matches_instrumented(weights, mixed):
    """ObsConfig(enabled=False) changes no scheduling, only recording."""
    kw = dict(BASE, mixed=mixed)
    on, on_reqs = _serve("port", weights, kw, PROMPTS, 6)
    off, off_reqs = _serve("port", weights, kw, PROMPTS, 6, obs_on=False)
    assert [r.generated for r in on_reqs] == [r.generated for r in off_reqs]
    assert on.step_count == off.step_count
    assert off.step_log == [] and off.obs.enabled is False
    assert off.obs.state_dict() is None
    assert off.config_counts == {"base": 0, "shift": 0}
    assert sum(on.config_counts.values()) > 0


def test_step_records_carry_index_and_duration(weights):
    kw, prompts, n_new = CASES["tight-pool"]
    eng, _ = _serve("port", weights, kw, prompts, n_new)
    total = eng.total_step_time
    eng.trace_window = 4                          # trim retroactively
    assert len(eng.step_log) == 4
    steps = [r["step"] for r in eng.step_log]
    assert steps == sorted(steps) and steps[-1] == eng.step_count - 1
    assert eng.step_times == [r["dur_s"] for r in eng.step_log]
    assert eng.total_step_time == total >= sum(eng.step_times)


def test_trace_windows_are_bounded(weights):
    """``tests/test_mixed.py``'s window check: the views stop growing past
    the window while the totals keep counting."""
    eng, make = _engine("port", weights, dict(BASE, max_slots=2))
    eng.trace_window = 8
    eng.add_request(make(0, list(range(1, 10)), max_new_tokens=20))
    eng.run_until_idle()
    assert eng.step_count > 8
    assert len(eng.config_trace) <= 8
    assert len(eng.step_times) <= 8
    assert len(eng.step_log) <= 8
    assert sum(eng.config_counts.values()) > 8
    assert eng.total_step_time >= sum(eng.step_times)


def test_starvation_audit(weights):
    """``tests/test_mixed.py``'s audit on the port: with a prompt burst in
    flight the mixed engine never runs a step with ready decodes and no
    decode progress, the serialized engine does, and the mixed engine fuses
    prefill and decode in one pass."""
    prompts = [list(range(1, 12 + i)) for i in range(3)] + [list(range(2, 40))]
    burst = [list(range(3, 30)), list(range(5, 26))]
    logs = {}
    for mixed in (True, False):
        eng, make = _engine("port", weights, dict(BASE, mixed=mixed))
        reqs = [make(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.add_request(r)
        while not any(r.generated for r in reqs):
            eng.step()
        for i, p in enumerate(burst):
            eng.add_request(make(100 + i, p, max_new_tokens=6))
        eng.run_until_idle()
        logs[mixed] = eng.step_log
    assert not [s for s in logs[True]
                if s["ready_decodes"] and not s["decode_tokens"]]
    assert any(s["ready_decodes"] and not s["decode_tokens"]
               for s in logs[False])
    assert any(s["prefill_tokens"] and s["decode_tokens"] for s in logs[True])


def test_obs_bool_raises():
    with pytest.raises(TypeError, match="ObsConfig"):
        EngineConfig(obs=True)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_serve_cli_writes_metrics_and_trace(tmp_path, capsys):
    from repro_torch.launch import serve
    metrics, trace = tmp_path / "m.json", tmp_path / "t.json"
    serve.main(["--reduced", "--device", "cpu", "--dtype", "fp32",
                "--requests", "6", "--max-new", "4",
                "--metrics-out", str(metrics), "--trace-out", str(trace),
                "--max-queue", "2"])
    out = capsys.readouterr().out
    dump = json.loads(metrics.read_text())
    prom = (tmp_path / "m.prom").read_text()
    tr = json.loads(trace.read_text())
    assert dump["source"] == "engine" and dump["steps"]
    assert "# TYPE repro_steps_total counter" in prom
    assert "repro_requests_shed_total 4" in prom
    assert sum(e["ph"] == "X" for e in tr["traceEvents"]) == \
        len(dump["steps"])
    report = obs.format_report(build_report(dump))
    assert report in out
    assert out.count("reason=shed") == 4 and out.count("reason=ok") == 2
    assert "requests: 6 arrived, 2 admitted, 2 finished" in report
    # python -m repro_torch.obs prints the same report
    res = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                          str(metrics)], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout == f"--- {metrics}\n{report}\n"
    res = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                          str(metrics), "--json"], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert _js(json.loads(res.stdout)[str(metrics)]) == \
        _js(build_report(dump))
