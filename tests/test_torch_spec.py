"""The port's speculative verify on the CPU, held to the reference.

* ``SuffixDrafter`` and ``SpecConfig``: the drafter cases of
  ``tests/test_spec_decode.py`` with the same asserts, on the port's
  classes and, as a check of the mirror, on the reference's; and
  ``PagedKVCache.truncate``, the rollback.
* The verify step: ``mixed_step(n_last=4, sample=False)`` against the
  reference's ``forward_fn(n_last=4, sample=False)`` within 1e-4 over two
  steps (prefill chunks, then verify-sized rows of 1 to 3 columns, so that
  columns before a row's start are masked), and ``n_last=1`` bitwise the
  plain step.
* The engine at ``SpecConfig(k=4)`` on the reference's repetitive prompts:
  streams equal to the reference's spec-on engine and to the port's
  spec-off engine, equal proposed and accepted counts (proposals > 0, some
  rejected), fewer steps than spec-off, no block used or pinned at exit, a
  policy that sees ``spec_tokens``, and the serialized iteration turning
  speculation off with its reason and unchanged streams.

Reduced qwen3-8b at fp32 on the weights of ``tests/test_torch_engine.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro import spec as jax_spec  # noqa: E402
from repro.core.policy import ThresholdPolicy as JaxPolicy  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import Request as JaxRequest  # noqa: E402
from repro.engine import ShiftEngine as JaxEngine  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import spec as port_spec  # noqa: E402
from repro_torch.cache import PagedKVCache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.policy import ThresholdPolicy  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.models import Model  # noqa: E402

IMPLS = {"port": port_spec, "reference": jax_spec}


# ---------------------------------------------------------------------------
# the drafter: tests/test_spec_decode.py's unit cases
# ---------------------------------------------------------------------------
def _drafter(S, k=4, ngram_max=3, ngram_min=1):
    return S.SuffixDrafter(S.SpecConfig(k=k, ngram_max=ngram_max,
                                        ngram_min=ngram_min))


def _config_validation(S):
    assert not S.SpecConfig()
    assert S.SpecConfig(k=2)
    for kw in ({"k": -1}, {"k": 2, "ngram_min": 0},
               {"k": 2, "ngram_min": 4, "ngram_max": 3}):
        with pytest.raises(ValueError):
            S.SpecConfig(**kw)


def _suffix_match_proposes_continuation(S):
    d = _drafter(S, k=3)
    assert d.propose(0, [1, 5, 6, 7, 8, 9, 5, 6], budget=8) == [7, 8, 9]


def _miss_and_cold_start(S):
    d = _drafter(S)
    assert d.propose(0, [], budget=8) == []
    assert d.propose(0, [1], budget=8) == []
    assert d.propose(0, [1, 2, 3, 4], budget=8) == []


def _budget_caps_draft_len(S):
    d = _drafter(S, k=4)
    toks = [7, 1, 2, 3, 4, 5, 7]
    assert d.propose(0, toks, budget=2) == [1, 2]
    assert d.propose(0, toks, budget=0) == []
    assert d.propose(0, toks, budget=-1) == []


def _incremental_equals_rebuild(S):
    toks = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 1, 4, 1, 5, 9, 2]
    inc, fresh = _drafter(S), _drafter(S)
    for n in range(1, len(toks) + 1):
        assert inc.propose(42, toks[:n], budget=8) == \
            fresh.propose(n, toks[:n], budget=8), n


def _most_recent_occurrence_wins(S):
    d = _drafter(S, k=2, ngram_max=1)
    assert d.propose(0, [5, 1, 2, 5, 9, 8, 5], budget=8) == [9, 8]


def _drop_forgets_request(S):
    d = _drafter(S)
    assert d.propose(0, [5, 1, 2, 5], budget=8) == [1, 2, 5]
    d.drop(0)
    assert d.propose(0, [5], budget=8) == []


DRAFTER_CASES = [_config_validation, _suffix_match_proposes_continuation,
                 _miss_and_cold_start, _budget_caps_draft_len,
                 _incremental_equals_rebuild, _most_recent_occurrence_wins,
                 _drop_forgets_request]


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("case", DRAFTER_CASES,
                         ids=[c.__name__.strip("_") for c in DRAFTER_CASES])
def test_drafter_cases(case, impl):
    case(IMPLS[impl])


def test_paged_truncate_frees_tail_blocks():
    kv = PagedKVCache(num_blocks=16, block_size=4, max_seqs=2,
                      max_blocks_per_seq=8)
    kv.ensure(0, 10)                       # 3 blocks
    free0 = kv.num_free_blocks
    assert kv.truncate(0, 5) == 1          # back to 2 blocks
    assert kv.num_free_blocks == free0 + 1
    assert kv.truncate(0, 5) == 0          # idempotent at the same length
    assert kv.truncate(0, 8) == 0          # growth is ensure's job
    kv.free_seq(0)
    assert kv.num_free_blocks == 15        # all but the null block


# ---------------------------------------------------------------------------
# weights
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


# ---------------------------------------------------------------------------
# the verify step's logits
# ---------------------------------------------------------------------------
STEP_BT = np.arange(1, 17, dtype=np.int32).reshape(4, 4)
STEPS = [([8, 5, 8, 0], [0, 0, 0, 0]), ([1, 3, 2, 0], [8, 5, 8, 0])]


def _step_tokens(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(1, vocab, (4, 8)).astype(np.int32) for _ in STEPS]


def _port_logits(model, toks, n_last):
    model.init_paged_cache(17, 4)
    return [model.forward_mixed(t, ql, off, STEP_BT, sample=False,
                                n_last=n_last)[0].numpy()
            for t, (ql, off) in zip(toks, STEPS)]


def test_verify_logits_match_reference(weights, port_model):
    jm, params, _ = weights
    toks = _step_tokens(port_model.cfg.vocab_size)
    got = _port_logits(port_model, toks, 4)
    fwd = jax.jit(jm.forward_fn(sample=False, n_last=4))
    pool = jm.init_paged_cache(17, 4)
    for g, t, (ql, off) in zip(got, toks, STEPS):
        want, pool = fwd(params, pool, jnp.asarray(t),
                         jnp.asarray(ql, jnp.int32),
                         jnp.asarray(off, jnp.int32), jnp.asarray(STEP_BT))
        want = np.asarray(want)
        assert g.shape == want.shape == (4, 4, port_model.cfg.vocab_size)
        np.testing.assert_allclose(g, want, atol=1e-4, rtol=1e-4)
        # columns before a row's start and padding rows give zero logits
        for b, q in enumerate(ql):
            pad = max(4 - q, 0)
            assert not g[b, :pad].any()
            assert q == 0 or np.abs(g[b, pad:]).max(axis=-1).min() > 0


def test_verify_width_one_is_the_plain_step(port_model):
    """``n_last=1`` is the plain step bitwise, and a wider verify's last
    column carries the same logits (to rounding) and tokens."""
    toks = _step_tokens(port_model.cfg.vocab_size)
    plain = []
    port_model.init_paged_cache(17, 4)
    for t, (ql, off) in zip(toks, STEPS):
        plain.append(port_model.forward_mixed(t, ql, off, STEP_BT,
                                              sample=False)[0].numpy())
    one = _port_logits(port_model, toks, 1)
    wide = _port_logits(port_model, toks, 4)
    for p, o, w in zip(plain, one, wide):
        np.testing.assert_array_equal(p.view(np.uint32), o.view(np.uint32))
        np.testing.assert_allclose(w[:, -1], p, atol=1e-5, rtol=1e-5)
    port_model.init_paged_cache(17, 4)
    for t, (ql, off) in zip(toks, STEPS):
        tok, _ = port_model.forward_mixed(t, ql, off, STEP_BT, n_last=4)
        assert tuple(tok.shape) == (4, 4)
        np.testing.assert_array_equal(tok[:, -1].numpy(),
                                      plain.pop(0).argmax(-1))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _prompts(n=3):
    # mildly repetitive prompts (the workload speculation targets)
    return [([2, 3, 4] * 4)[: 9 + i] for i in range(n)]


class _Recorder(ThresholdPolicy):
    """A threshold policy that records the spec_tokens fact it is fed."""

    def __init__(self, threshold):
        super().__init__(threshold)
        object.__setattr__(self, "seen", [])

    def use_base(self, n_tokens, n_prefill_tokens=0, ctx_tokens=0,
                 n_rows=0, ctx_max=0, spec_tokens=0):
        self.seen.append(spec_tokens)
        return super().use_base(n_tokens, n_prefill_tokens)


def _run(side, weights, port_model, spec_k, mixed=None, policy=None):
    """``tests/test_spec_decode.py``'s ``_run``: 4 slots, s_max 64, chunk
    8, threshold 4, 16 new tokens."""
    kw = dict(max_slots=4, s_max=64, prefill_chunk=8, mixed=mixed)
    if side == "reference":
        jm, params, _ = weights
        eng = JaxEngine(jm, jm, params, params, JaxEngineConfig(
            spec=jax_spec.SpecConfig(k=spec_k), **kw),
            policy=JaxPolicy(4))
        make = JaxRequest
    else:
        eng = ShiftEngine(port_model, EngineConfig(
            spec=port_spec.SpecConfig(k=spec_k), **kw),
            policy=policy or ThresholdPolicy(4))
        make = Request
    reqs = [make(i, p, max_new_tokens=16) for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert all(len(r.generated) == 16 for r in reqs)
    return {r.rid: tuple(r.generated) for r in reqs}, eng


def _count(eng, name):
    """A counter's total in ``eng``'s obs registry."""
    return eng.obs.registry.counter_total(name)


@pytest.fixture(scope="module")
def engines(weights, port_model):
    pol = _Recorder(4)
    return {"ref4": _run("reference", weights, port_model, 4),
            "port4": _run("port", weights, port_model, 4, policy=pol),
            "port0": _run("port", weights, port_model, 0),
            "policy": pol,
            "ser4": _run("port", weights, port_model, 4, mixed=False),
            "ser0": _run("port", weights, port_model, 0, mixed=False)}


def test_spec_engine_matches_reference(engines):
    ref, reng = engines["ref4"]
    got, eng = engines["port4"]
    assert got == ref
    assert eng.spec_disabled_reason is None
    reg = reng.obs.registry
    for name in ("spec_proposed_total", "spec_accepted_total",
                 "spec_rollback_blocks_total"):
        assert _count(eng, name) == reg.counter_total(name), name
    assert _count(eng, "spec_proposed_total") > 0
    assert 0 < _count(eng, "spec_accepted_total") \
        < _count(eng, "spec_proposed_total")
    assert eng.step_count == reng.step_count
    assert dict(eng.config_counts) == reng.config_counts


def test_spec_streams_equal_spec_off(engines):
    got, eng = engines["port4"]
    off, eng0 = engines["port0"]
    assert got == off
    assert _count(eng0, "spec_proposed_total") == 0
    # each accepted draft saves a decode step
    assert eng.step_count < eng0.step_count
    led = eng.block_accounting()
    assert led.used == 0 and led.pinned == 0
    assert eng.kv.num_free_blocks == eng.kv.num_blocks - 1
    # the verify widths ran through the deployment's lazy table
    assert {n for _, n in eng.deploy.spec_forward} <= {2, 4, 8}
    assert eng.deploy.spec_forward


def test_policy_receives_spec_token_fact(engines):
    pol = engines["policy"]
    eng = engines["port4"][1]
    assert any(s > 0 for s in pol.seen)
    assert max(pol.seen) <= 4 * eng.cfg.max_slots
    assert sum(pol.seen) == _count(eng, "spec_proposed_total")


def test_spec_serialized_fallback_disables_loudly(engines):
    got, eng = engines["ser4"]
    assert got == engines["ser0"][0] == engines["port0"][0]
    assert "mixed" in eng.spec_disabled_reason
    assert _count(eng, "spec_proposed_total") == 0 and not eng._spec_on
