"""Fault injection in the port against the reference: the fault plan and
the delivery log (``repro_torch.ft``), and the engine's four seams with
retries and quarantine.

The plan and the log are pure Python: the reference's cases of
``tests/test_ft_faults.py`` (those that need no simulator) run on the
port's copies, and ``random_plan`` must name the same plan as the
reference's for one seed. The engine's fault cases of the reference's
``tests/test_ft_engine.py`` (alloc, forward ``nan`` and ``raise``, route,
quarantine, the seeded storm with the prefix cache under ``drain``) run on
both engines under one plan, each with its own copy of one injected clock,
over the same weights (reduced qwen3-8b at fp32, the reference's init
converted): finish reasons, streams, ``fail_count``/``retry_at``, every
counter, event and step record (the whole observability dump) and the
block ledgers must be equal. The forward faults also run on the
serialized paged and the serialized dense iterations, and with ``k=4``
speculation on the mixed one.
"""
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro import engine as jeng  # noqa: E402
from repro import ft as jft  # noqa: E402
from repro import spec as jspec  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import engine as peng  # noqa: E402
from repro_torch import ft as pft  # noqa: E402
from repro_torch import spec as pspec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.engine import FinishReason  # noqa: E402
from repro_torch.ft import (DeliveryLog, Fault, FaultPlan,  # noqa: E402
                            ReplayDivergence, corrupt_snapshot, random_plan)
from repro_torch.models import Model  # noqa: E402

SIDES = ("reference", "port")


# ---------------------------------------------------------------------------
# the plan and the delivery log: the reference's cases on the port's copies
# ---------------------------------------------------------------------------
def test_random_plan_is_deterministic():
    kw = dict(p_alloc=0.2, p_forward=0.2, p_route=0.1, p_snapshot=0.1, dp=2)
    a = random_plan(123, 50, **kw)
    b = random_plan(123, 50, **kw)
    assert a.faults == b.faults and len(a) > 0
    assert a.seed == 123
    c = random_plan(124, 50, **kw)
    assert c.faults != a.faults


def test_at_is_pure_lookup():
    plan = FaultPlan([Fault(3, "forward", kind="nan")])
    f1 = plan.at(3, "forward")
    f2 = plan.at(3, "forward")          # replay sees the same schedule
    assert f1 is f2 is plan.faults[0]
    assert plan.at(3, "alloc") is None
    assert plan.at(4, "forward") is None
    assert plan.fired == [f1, f1]       # diagnostics log, append-only
    assert plan.max_step() == 3


def test_duplicate_step_seam_rejected():
    with pytest.raises(ValueError, match="duplicate"):
        FaultPlan([Fault(1, "alloc"), Fault(1, "alloc")])


def test_fault_validation():
    with pytest.raises(ValueError, match="seam"):
        Fault(0, "gpu-on-fire")
    with pytest.raises(ValueError, match="kind"):
        Fault(0, "forward", kind="segfault")
    Fault(0, "forward", kind="raise")   # ok
    Fault(0, "route", row=3)            # ok


def test_corrupt_snapshot_drops_required_keys():
    def snap():
        return {"lens": [0], "cache": {}, "step_count": 5,
                "requests": [{"rid": 0, "prompt": [1, 2]}]}
    s0 = corrupt_snapshot(snap(), 0)
    s1 = corrupt_snapshot(snap(), 1)
    assert s0["corrupted"] and s1["corrupted"]
    # different step -> different validation branch exercised
    assert set(snap()) - set(s0) != set(snap()) - set(s1)
    assert "prompt" not in s0["requests"][-1]


class _Req:
    def __init__(self, rid, generated):
        self.rid = rid
        self.generated = generated


def test_delivery_log_releases_only_new_suffix():
    log = DeliveryLog()
    r = _Req(1, [10, 11])
    assert log.poll([r]) == {1: [10, 11]}
    assert log.poll([r]) == {}                      # nothing new
    r.generated = [10, 11, 12]
    assert log.poll([r]) == {1: [12]}               # suffix only
    # recompute-preemption: engine temporarily holds fewer tokens
    r.generated = [10]
    assert log.poll([r]) == {}
    assert log.delivered(1) == [10, 11, 12]


def test_delivery_log_detects_divergent_replay():
    log = DeliveryLog()
    log.poll([_Req(1, [10, 11])])
    with pytest.raises(ReplayDivergence):
        log.poll([_Req(1, [10, 99])])


@pytest.mark.parametrize("seed,n,rates,dp", [
    (0, 64, (0.05, 0.05, 0.05, 0.0), 1),
    (3, 64, (0.05, 0.05, 0.05, 0.0), 2),
    (11, 40, (0.15, 0.15, 0.1, 0.0), 1),
    (123, 50, (0.2, 0.2, 0.1, 0.1), 2),
    (7, 200, (0.5, 0.3, 0.4, 0.2), 4),
])
def test_random_plan_equals_reference(seed, n, rates, dp):
    """One (seed, rates) names one plan in both packages: the same faults
    in the same order, and the same fired log for the same lookups."""
    kw = dict(zip(("p_alloc", "p_forward", "p_route", "p_snapshot"), rates),
              dp=dp)
    mine, ref = random_plan(seed, n, **kw), jft.random_plan(seed, n, **kw)
    assert [(f.step, f.seam, f.kind, f.row) for f in mine.faults] == \
        [(f.step, f.seam, f.kind, f.row) for f in ref.faults]
    assert len(mine) > 0 and mine.seed == ref.seed == seed
    assert mine.max_step() == ref.max_step()
    for step in range(n):
        for seam in ("alloc", "forward", "route", "snapshot"):
            a, b = mine.at(step, seam), ref.at(step, seam)
            assert (a is None) == (b is None)
    assert len(mine.fired) == len(ref.fired) == len(mine)


# ---------------------------------------------------------------------------
# the engine's seams on both engines
# ---------------------------------------------------------------------------
class Always:
    def __init__(self, b):
        self.b = b

    def use_base(self, n, p=0):
        return self.b


@pytest.fixture(scope="module")
def weights():
    jm = build_model(reduced_cfg("qwen3-8b"), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    cfg = get_config("qwen3-8b").reduced()
    model = Model(cfg, device="cpu", dtype=torch.float32)
    model.load_params(from_jax_params(tree, cfg))
    return jm, jax.tree.map(jnp.asarray, tree), model


def _fake_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


class Side:
    """One package's engine, request and plan types, built the reference
    test's way: 4 slots, s_max 64, chunk 8, the policy always base."""

    def __init__(self, side, weights):
        self.side, self.weights = side, weights
        self.pkg = jeng if side == "reference" else peng
        self.ft = jft if side == "reference" else pft
        self.Request = self.pkg.Request

    def plan(self, faults):
        """A plan of (step, seam, kind, row) tuples."""
        return self.ft.FaultPlan([self.ft.Fault(s, seam, kind=k, row=row)
                                  for s, seam, k, row in faults])

    def engine(self, faults=None, num_blocks=0, prefix_cache=False,
               paged=None, mixed=None, spec_k=0, **fault_kw):
        jm, params, model = self.weights
        spec = (jspec if self.side == "reference" else pspec).SpecConfig(
            k=spec_k)
        cfg = self.pkg.EngineConfig(
            max_slots=4, s_max=64, prefill_chunk=8, num_blocks=num_blocks,
            paged=paged, mixed=mixed, spec=spec,
            prefix=self.pkg.PrefixConfig(enabled=prefix_cache),
            fault=self.pkg.FaultConfig(**fault_kw))
        if self.side == "reference":
            return jeng.ShiftEngine(jm, jm, params, params, cfg,
                                    policy=Always(True), now=_fake_clock(),
                                    faults=faults)
        return peng.ShiftEngine(model, cfg, policy=Always(True),
                                now=_fake_clock(), faults=faults)

    def reqs(self, n=2, n_new=4, start=1):
        return [self.Request(i, list(range(start, start + 9 + i)),
                             max_new_tokens=n_new) for i in range(n)]


def _seen(eng, reqs):
    """Everything the comparison holds equal."""
    return {"reasons": [str(r.finish_reason) for r in reqs],
            "streams": [list(r.generated) for r in reqs],
            "fail": [(r.fail_count, r.retry_at) for r in reqs],
            "preemptions": eng.preemptions,
            "ledger": eng.block_accounting().as_dict(),
            "dump": json.dumps(eng.obs.dump(), sort_keys=True)}


def _run(eng, reqs, max_steps=400):
    for r in reqs:
        eng.add_request(r)
    eng.run_until_idle(max_steps=max_steps)
    return {r.rid: tuple(r.generated) for r in reqs}


def case_alloc(s):
    ref = _run(s.engine(num_blocks=32), s.reqs())
    plan = s.plan([(0, "alloc", "", 0), (2, "alloc", "", 0)])
    eng = s.engine(faults=plan, num_blocks=32)
    reqs = s.reqs()
    assert _run(eng, reqs) == ref
    assert len(plan.fired) >= 2
    assert eng.obs.registry.counter_total("faults_injected_total") == 2
    return _seen(eng, reqs)


def _forward(s, kind, engine_kw=None, reqs=None, steps=(1, 5),
             clobbered=()):
    """Forward faults at ``steps``; the streams equal the clean run's
    but for the rids in ``clobbered`` (``case_forward_nan_serialized_dense``
    says why)."""
    engine_kw = engine_kw or {}
    make = reqs or s.reqs
    ref = _run(s.engine(**engine_kw), make())
    # step 1 fails -> backoff until step 4; step 5's forward fails again
    plan = s.plan([(step, "forward", kind, 0) for step in steps])
    eng = s.engine(faults=plan, **engine_kw)
    got_reqs = make()
    got = _run(eng, got_reqs)
    for rid in ref:                     # recompute-retry is deterministic
        assert (got[rid] == ref[rid]) == (rid not in clobbered), rid
    assert all(r.finish_reason is not None and r.finish_reason == "ok"
               for r in got_reqs)
    reg = eng.obs.registry
    assert reg.counter_total("failed_steps_total") == len(steps)
    assert reg.counter_total("retries_total") > 0
    failed = [rec for rec in eng.step_log if rec.get("failed")]
    assert len(failed) == len(steps)
    assert all(rec["decode_tokens"] == 0 and rec["prefill_tokens"] == 0
               for rec in failed)
    return _seen(eng, got_reqs)


def case_forward_nan(s):
    return _forward(s, "nan")


def case_forward_raise(s):
    return _forward(s, "raise")


def case_forward_nan_serialized_paged(s):
    return _forward(s, "nan", {"mixed": False})


def case_forward_raise_serialized_paged(s):
    return _forward(s, "raise", {"mixed": False}, steps=(1, 6))


def case_forward_nan_serialized_dense(s):
    """A behaviour of the reference that the port copies: request 1's last
    prompt chunk fails at step 1 and backs off while request 0 decodes.
    A dense decode step runs all ``max_slots`` rows, and a row outside the
    step writes its zero token at position 0 of its slot, so the decode
    steps of the backoff overwrite request 1's cached position 0, which
    its retry (from its prefilled offset) does not write again. Its stream
    then differs from the clean run's, in both packages alike."""
    return _forward(s, "nan", {"paged": False, "mixed": False},
                    clobbered=(1,))


def case_forward_raise_serialized_dense(s):
    return _forward(s, "raise", {"paged": False, "mixed": False},
                    steps=(2, 6))


def _spec_reqs(s):
    return lambda: [s.Request(i, ([2, 3, 4] * 4)[:9 + i], max_new_tokens=10)
                    for i in range(3)]


def case_forward_nan_spec(s):
    return _forward(s, "nan", {"spec_k": 4}, reqs=_spec_reqs(s),
                    steps=(2, 6))


def case_forward_raise_spec(s):
    return _forward(s, "raise", {"spec_k": 4}, reqs=_spec_reqs(s),
                    steps=(2, 6))


def case_route(s):
    ref = _run(s.engine(), s.reqs())
    eng = s.engine(faults=s.plan([(2, "route", "", 0)]))
    reqs = s.reqs()
    assert _run(eng, reqs) == ref
    assert eng.preemptions > 0          # the row's requests were recomputed
    assert all(r.finish_reason == "ok" for r in reqs)
    return _seen(eng, reqs)


def case_quarantine(s):
    plan = s.plan([(step, "forward", "raise", 0) for step in range(400)])
    eng = s.engine(faults=plan, quarantine_after=3)
    reqs = s.reqs(1)
    _run(eng, reqs)
    assert reqs[0].finish_reason == "failed"
    assert reqs[0].fail_count == 3
    assert eng.obs.registry.counter_total("requests_failed_total") == 1
    assert not eng.queue                # terminal, not stuck
    return _seen(eng, reqs)


def case_storm(s):
    """A seeded storm across every seam, with the prefix cache, under
    drain: every request ends, the ledger drains to zero."""
    plan = s.ft.random_plan(11, 40, p_alloc=0.15, p_forward=0.15,
                            p_route=0.1)
    eng = s.engine(faults=plan, num_blocks=32, prefix_cache=True)
    reqs = s.reqs(4)
    for r in reqs:
        eng.add_request(r)
    eng.drain(max_steps=400)
    assert all(r.finish_reason is not None for r in reqs)
    acct = eng.block_accounting()
    assert acct.used == 0 and acct.pinned == 0
    return _seen(eng, reqs)


CASES = [case_alloc, case_forward_nan, case_forward_raise, case_route,
         case_quarantine, case_storm, case_forward_nan_serialized_paged,
         case_forward_raise_serialized_paged,
         case_forward_nan_serialized_dense,
         case_forward_raise_serialized_dense, case_forward_nan_spec,
         case_forward_raise_spec]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_fault_case_matches_reference(weights, case):
    want, got = (case(Side(side, weights)) for side in SIDES)
    for key in want:
        assert got[key] == want[key], key


def test_failed_reason_and_counters(weights):
    """A quarantined request ends with the typed FAILED reason, counted
    once, with its ``quarantined`` event; its retries are counted before
    it."""
    s = Side("port", weights)
    plan = s.plan([(step, "forward", "raise", 0) for step in range(400)])
    eng = s.engine(faults=plan, quarantine_after=2, retry_backoff=1)
    reqs = s.reqs(2)
    _run(eng, reqs)
    assert all(r.finish_reason is FinishReason.FAILED for r in reqs)
    assert all(r.fail_count == 2 for r in reqs)
    reg = eng.obs.registry
    assert reg.counter_total("requests_failed_total") == 2
    assert reg.counter_total("retries_total") == 2
    kinds = [e["kind"] for e in eng.obs.events.events]
    assert kinds.count("quarantined") == 2 and kinds.count("retry") == 2
    led = eng.block_accounting()
    assert led.used == led.pinned == 0


def test_raise_skips_the_forward(weights):
    """A ``raise`` fault runs no step: the deployment's entry is not
    called, where a ``nan`` fault runs it once."""
    s = Side("port", weights)
    calls = {}
    for kind in ("nan", "raise"):
        eng = s.engine(faults=s.plan([(0, "forward", kind, 0)]))
        entry = eng.deploy.forward["base"]
        n = [0]

        def counted(*a, entry=entry, n=n):
            n[0] += 1
            return entry(*a)

        eng.deploy.forward["base"] = counted
        for r in s.reqs():
            eng.add_request(r)
        eng.step()
        calls[kind] = n[0]
        assert eng.step_log[0]["failed"]
        assert (eng.step_log[0]["attn_ctx_tokens"] > 0) == (kind == "nan")
    assert calls == {"nan": 1, "raise": 0}
