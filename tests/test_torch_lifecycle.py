"""The request lifecycle of the port's engine against the reference's:
typed outcomes (OK, TIMEOUT, CANCELLED, SHED), deadlines, ``cancel``, the
bounded queue and both shed policies, ``drain``, and the straggler
watchdog's wiring.

The cases of the reference's ``tests/test_ft_engine.py`` (its lifecycle
and watchdog cases) run on both engines over the same weights (reduced
qwen3-8b at fp32, the reference's init converted), each with its own copy
of the same injected clock. Finish reasons, streams, every counter, the
block ledgers and the whole observability dump must be equal. Then the
chip run's lifecycle drill at CPU size: six requests into four slots on a
cut pool, a deadline moved into the past and a cancel after step 3, then
``drain``, under both shed policies.
"""
import dataclasses
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
from repro.ft import StragglerWatchdog as JaxWatchdog  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import engine as peng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.engine import FinishReason  # noqa: E402
from repro_torch.ft import StragglerWatchdog  # noqa: E402
from repro_torch.models import Model  # noqa: E402

SIDES = ("reference", "port")


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
    """One package's engine and request type, built the reference test's
    way: 4 slots, s_max 64, chunk 8, the policy always base."""

    def __init__(self, side, weights):
        self.side, self.weights = side, weights
        self.pkg = jeng if side == "reference" else peng
        self.Request = self.pkg.Request

    def engine(self, now=None, max_slots=4, num_blocks=0,
               prefix_cache=False, block_size=16, **fault_kw):
        jm, params, model = self.weights
        cfg = self.pkg.EngineConfig(
            max_slots=max_slots, s_max=64, prefill_chunk=8,
            num_blocks=num_blocks, block_size=block_size,
            prefix=self.pkg.PrefixConfig(enabled=prefix_cache),
            fault=self.pkg.FaultConfig(**fault_kw))
        now = now or _fake_clock()
        if self.side == "reference":
            return jeng.ShiftEngine(jm, jm, params, params, cfg,
                                    policy=Always(True), now=now)
        return peng.ShiftEngine(model, cfg, policy=Always(True), now=now)

    def reqs(self, n=2, n_new=4, start=1):
        return [self.Request(i, list(range(start, start + 9 + i)),
                             max_new_tokens=n_new) for i in range(n)]


def _seen(eng, reqs):
    """Everything the comparison holds equal."""
    return {"reasons": [str(r.finish_reason) for r in reqs],
            "streams": [list(r.generated) for r in reqs],
            "finish_times": [r.finish_time for r in reqs],
            "ledger": eng.block_accounting().as_dict(),
            "dump": json.dumps(eng.obs.dump(), sort_keys=True)}


# ---------------------------------------------------------------------------
# the reference's lifecycle cases, each a function of one side
# ---------------------------------------------------------------------------
def case_ok(s):
    eng = s.engine()
    reqs = s.reqs()
    for r in reqs:
        eng.add_request(r)
    eng.run_until_idle(max_steps=400)
    assert all(r.finish_reason == "ok" for r in reqs)
    assert all(r.finish_time is not None for r in reqs)
    return _seen(eng, reqs)


def case_deadline(s):
    clock = {"t": 0.0}
    eng = s.engine(now=lambda: clock["t"], deadline_s=10.0)
    slow = s.Request(0, list(range(1, 10)), max_new_tokens=4, arrival=0.0)
    eng.add_request(slow)
    assert slow.deadline == 10.0        # engine default applied
    eng.step()
    clock["t"] = 11.0                   # past the deadline mid-flight
    eng.run_until_idle()
    assert slow.finish_reason == "timeout"
    assert eng.obs.registry.counter_total("requests_timeout_total") == 1
    assert slow.slot is None            # blocks freed on retirement
    return _seen(eng, [slow])


def case_cancel(s):
    eng = s.engine()
    reqs = s.reqs()
    for r in reqs:
        eng.add_request(r)
    eng.step()                          # admit + start prefilling
    assert eng.cancel(reqs[0].rid)
    assert reqs[0].finish_reason == "cancelled"
    assert not eng.cancel(reqs[0].rid)  # already terminal
    assert not eng.cancel(999)          # never submitted
    eng.run_until_idle()
    assert reqs[1].finish_reason == "ok"
    eng.drain()
    led = eng.block_accounting()
    assert led.used == 0 and led.pinned == 0
    return _seen(eng, reqs)


def _shed(s, policy, shed_rids):
    # one slot: one request is admitted, the rest contend for the single
    # queue seat (max_queue=1)
    eng = s.engine(max_slots=1, max_queue=1, shed_policy=policy)
    reqs = s.reqs(5)
    eng.add_request(reqs[0])
    eng.step()                          # rid 0 admitted (slot taken)
    for r in reqs[1:]:
        eng.add_request(r)              # queue bound of 1 -> 3 shed
    assert {r.rid for r in reqs if r.finish_reason == "shed"} == shed_rids
    eng.run_until_idle()
    assert {r.rid for r in reqs if r.finish_reason == "ok"} == \
        {0, 1, 2, 3, 4} - shed_rids
    assert all(r.finish_reason is not None for r in reqs)
    return _seen(eng, reqs)


def case_shed_reject_newest(s):
    return _shed(s, "reject-newest", {2, 3, 4})


def case_shed_evict_longest_queued(s):
    return _shed(s, "evict-longest-queued", {1, 2, 3})


def case_drain(s):
    eng = s.engine(max_slots=1)
    reqs = s.reqs(3)
    for r in reqs:
        eng.add_request(r)
    eng.step()                          # rid 0 admitted, 1-2 still queued
    assert reqs[0].slot is not None
    eng.drain()
    assert reqs[0].finish_reason == "ok"        # in-flight completes
    assert {str(r.finish_reason) for r in reqs[1:]} == {"shed"}
    led = eng.block_accounting()
    assert led.used == 0 and led.pinned == 0
    late = s.Request(9, list(range(1, 8)), max_new_tokens=2)
    eng.add_request(late)               # after shutdown: shed at once
    assert late.finish_reason == "shed"
    return _seen(eng, reqs + [late])


def case_drain_prefix_cache(s):
    """Drain releases the prefix index's pins too: zero blocks held."""
    eng = s.engine(max_slots=2, prefix_cache=True, block_size=8)
    reqs = [s.Request(i, list(range(100, 116)) + [i + 1, i + 2],
                      max_new_tokens=4) for i in range(4)]
    for r in reqs:
        eng.add_request(r)
    for _ in range(6):
        eng.step()
    eng.drain()
    led = eng.block_accounting()
    assert led.used == 0 and led.pinned == 0
    assert eng.obs.registry.counter_total("prefix_evictions_total") > 0
    return _seen(eng, reqs)


CASES = [case_ok, case_deadline, case_cancel, case_shed_reject_newest,
         case_shed_evict_longest_queued, case_drain, case_drain_prefix_cache]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_lifecycle_matches_reference(weights, case):
    want, got = (case(Side(side, weights)) for side in SIDES)
    for key in want:
        assert got[key] == want[key], key


def test_unknown_shed_policy_rejected(weights):
    for side in SIDES:
        with pytest.raises(ValueError, match="shed_policy"):
            Side(side, weights).engine(shed_policy="coin-flip")


# ---------------------------------------------------------------------------
# the chip run's drill at CPU size
# ---------------------------------------------------------------------------
def lifecycle_drill(s, policy):
    """Two requests into four slots on a pool cut to 11 usable blocks of 8,
    one step, then four more, which wait for blocks: the bound of 2
    waiting sheds two of them by the policy. After step 3 a running
    request's deadline is set in the past and another running request is
    cancelled; two more steps, then drain, and one request after it."""
    eng = s.engine(num_blocks=12, block_size=8, max_queue=2,
                   shed_policy=policy)
    reqs = [s.Request(i, list(range(1, 20 + 3 * i)), max_new_tokens=8)
            for i in range(6)]
    for r in reqs[:2]:
        eng.submit(r)
    eng.step()
    for r in reqs[2:]:
        eng.submit(r)
    eng.step()
    eng.step()
    running = [r for r in reqs if r.slot is not None]
    assert len(running) >= 2
    running[0].deadline = eng.now() - 1.0
    assert eng.cancel(running[1].rid)
    eng.step()
    eng.step()
    eng.drain()
    assert eng.submit(s.Request(99, [1, 2, 3], max_new_tokens=2)) == 99
    reqs.append(eng.request(99))
    return reqs, _seen(eng, reqs), eng


@pytest.mark.parametrize("policy", ["reject-newest", "evict-longest-queued"])
def test_lifecycle_drill_matches_reference(weights, policy):
    (rreqs, want, _), (reqs, got, eng) = (
        lifecycle_drill(Side(side, weights), policy) for side in SIDES)
    for key in want:
        assert got[key] == want[key], key
    reasons = [r.finish_reason for r in reqs]
    assert all(isinstance(x, FinishReason) for x in reasons)
    assert {"timeout", "cancelled", "shed", "ok"} <= set(reasons)
    assert reasons[-1] == "shed"
    reg = eng.obs.registry
    for reason, name in (("timeout", "requests_timeout_total"),
                         ("cancelled", "requests_cancelled_total"),
                         ("shed", "requests_shed_total"),
                         ("ok", "requests_finished_total")):
        assert reg.counter_total(name) == reasons.count(reason), reason
    led = eng.block_accounting()
    assert led.used == led.pinned == 0
    assert eng.stream(reqs[0].rid) == reqs[0].generated
    assert eng.stream(12345) == [] and eng.request(12345) is None


# ---------------------------------------------------------------------------
# the straggler watchdog
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cls", [StragglerWatchdog, JaxWatchdog],
                         ids=SIDES[::-1])
def test_watchdog_flags_outlier_steps(cls):
    wd = cls(window=8, factor=2.0)
    assert not any(wd.observe(1.0) for _ in range(4))
    assert wd.observe(5.0)              # > 2x rolling median
    assert not wd.observe(1.0)
    assert wd.flagged == 1


def _watchdog_run(s):
    clock = {"t": 0.0, "dt": 1.0}

    def now():
        # the clock advances by dt over the calls of one step (the start,
        # the deadline check, the sampled tokens' time and the end)
        clock["t"] += clock["dt"] / 4
        return clock["t"]

    eng = s.engine(now=now, straggler_factor=2.0)
    assert eng.watchdog.factor == 2.0   # config knob reaches the watchdog
    reqs = s.reqs(1, n_new=8)
    for r in reqs:
        eng.add_request(r)
    for _ in range(4):
        eng.step()
    clock["dt"] = 50.0                  # one pathologically slow step
    eng.step()
    clock["dt"] = 1.0
    eng.run_until_idle()
    return eng, _seen(eng, reqs)


def test_watchdog_wired_into_step_loop(weights):
    (ref, want), (eng, got) = (_watchdog_run(Side(side, weights))
                               for side in SIDES)
    assert got == want
    reg = eng.obs.registry
    assert reg.counter_total("straggler_steps_total") >= 1
    flagged = [e for e in eng.obs.events.events if e["kind"] == "straggler"]
    assert flagged and flagged[0]["step"] == 4
    assert flagged[0]["dur_s"] > 2.0 * sorted(eng.step_times[:4])[2]


def test_engine_config_fault_group(weights):
    cfg = peng.EngineConfig(fault=peng.FaultConfig(
        max_queue=3, shed_policy="evict-longest-queued", deadline_s=2.5,
        straggler_factor=4.0))
    assert (cfg.max_queue, cfg.shed_policy, cfg.deadline_s,
            cfg.straggler_factor) == (3, "evict-longest-queued", 2.5, 4.0)
    for group in ("FaultConfig", "ObsConfig"):
        assert dataclasses.asdict(getattr(peng, group)()) == \
            dataclasses.asdict(getattr(jeng, group)()), group
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        Side("port", weights).engine(auto_snapshot_every=4)
