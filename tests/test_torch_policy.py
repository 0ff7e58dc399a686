"""The port's shift policies and the paper's Table 4 configs against the
reference's.

* ``AdaptivePolicy.use_base`` equals the reference's on a grid of
  iteration facts (tokens, prefill tokens, summed and largest context,
  rows, draft tokens), with and without context, for reduced qwen3-8b,
  qwen-32b and llama-70b at three (sp, tp) grids, priced at the H100's
  and the V5E's numbers.
* The one-rank engine under ``AdaptivePolicy(CostModel(cfg), 2, 2)`` on
  reduced qwen3-8b at fp32 with the reference's weights (``convert.
  from_jax_params``): streams, config counts, step records and the
  observability dump equal the reference engine's under one fake clock,
  on the mixed, serialized paged and serialized dense iterations, with
  the prefix cache and k=4 drafts, and under pool pressure; both configs
  occur in each.
* qwen-32b and llama-70b: ``active_params()`` and ``reduced()`` equal the
  reference's; ``num_params()`` counts the port's modules (the reference's
  count plus the norm scales), and the reduced qwen-32b engine gives the
  reference's streams.
* The serve CLI's ``--adaptive`` and ``--arch qwen-32b`` on the CPU.
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

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.policy import AdaptivePolicy as JaxAdaptive  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import PrefixConfig as JaxPrefixConfig  # noqa: E402
from repro.engine import Request as JaxRequest  # noqa: E402
from repro.engine import ShiftEngine as JaxEngine  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.roofline import terms as jterms  # noqa: E402
from repro.sim import costmodel as jcm  # noqa: E402
from repro.spec import SpecConfig as JaxSpecConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import AdaptivePolicy, ThresholdPolicy  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.engine.api import PrefixConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.roofline.terms import H100, Hardware  # noqa: E402
from repro_torch.sim import CostModel  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402


def _js(x):
    return json.dumps(x, sort_keys=True)


def _cfgs(name, reduced=False):
    p, j = get_config(name), jax_get_config(name)
    return (p.reduced(), j.reduced()) if reduced else (p, j)


def _policies(name, reduced, sp, tp, hw):
    (pc, jc) = _cfgs(name, reduced)
    if hw == "h100":
        ph, jh = H100, jterms.Hardware(**dataclasses.asdict(H100))
    else:
        ph, jh = Hardware(**dataclasses.asdict(jterms.V5E)), jterms.V5E
    return (AdaptivePolicy(CostModel(pc, hw=ph), sp, tp),
            JaxAdaptive(jcm.CostModel(jc, hw=jh), sp, tp))


# (n_tokens, n_prefill, ctx_tokens, n_rows, ctx_max, spec_tokens)
FACTS = [
    (1, 0, 0, 0, 0, 0), (6, 0, 0, 0, 0, 0), (134, 134, 0, 0, 0, 0),
    (6, 0, 6 * 40, 6, 0, 0), (6, 0, 6 * 40, 6, 57, 0),
    (4, 0, 4 * 16, 4, 16, 0), (4, 0, 4 * 32768, 4, 32768, 0),
    (70, 64, 2048 + 5 * 300, 6, 2048, 0), (512, 512, 512, 8, 64, 0),
    (30, 0, 6 * 900, 6, 1500, 24), (11, 0, 3 * 50, 3, 60, 8),
    (8, 8, 8, 1, 8, 0), (64, 0, 64 * 4096, 64, 4096, 0), (33, 1, 32, 33, 1, 0),
]


@pytest.mark.parametrize("hw", ["h100", "v5e"])
@pytest.mark.parametrize("sp,tp", [(2, 2), (8, 1), (1, 4)])
@pytest.mark.parametrize("name,reduced", [("qwen3-8b", True),
                                          ("qwen-32b", False),
                                          ("llama-70b", False)])
def test_adaptive_use_base_matches_reference(name, reduced, sp, tp, hw):
    port, ref = _policies(name, reduced, sp, tp, hw)
    got, want = [], []
    for n, npf, ctx, rows, cmax, spec in FACTS:
        got.append(port.use_base(n, npf))
        want.append(ref.use_base(n, npf))
        got.append(port.use_base(n, npf, ctx_tokens=ctx, n_rows=rows,
                                 ctx_max=cmax, spec_tokens=spec))
        want.append(ref.use_base(n, npf, ctx_tokens=ctx, n_rows=rows,
                                 ctx_max=cmax, spec_tokens=spec))
    assert got == want
    assert all(isinstance(b, bool) for b in got)


def test_adaptive_flips_between_configs():
    """The pricing really decides: reduced qwen3-8b over (2, 2) picks base
    for a 134-token prefill and shift for 6 decode tokens, at the V5E's
    numbers as at the H100's; a tie goes to base."""
    for hw in ("h100", "v5e"):
        pol, _ = _policies("qwen3-8b", True, 2, 2, hw)
        assert pol.use_base(134, 134)
        assert not pol.use_base(6, 0, ctx_tokens=6 * 40, n_rows=6)

    class Flat:
        def iteration_time(self, *a, **kw):
            return 1.0
    assert AdaptivePolicy(Flat(), 2, 2).use_base(6, 0)


def test_adaptive_policy_prices_actual_context():
    """``tests/test_workprop_attention.py``'s check: real contexts feed
    the decision, and the policy answers without them too."""
    pol = AdaptivePolicy(CostModel(get_config("llama-70b")), sp=8, tp=1)
    lo = pol.use_base(4, 0, ctx_tokens=4 * 16, n_rows=4)
    hi = pol.use_base(4, 0, ctx_tokens=4 * 32768, n_rows=4)
    assert isinstance(lo, bool) and isinstance(hi, bool)
    assert isinstance(pol.use_base(4, 0), bool)


# ---------------------------------------------------------------------------
# the Table 4 configs
# ---------------------------------------------------------------------------
def _norm_scales(cfg):
    """What ``num_params`` counts beyond the reference's count: the norm
    scales (ln1, ln2, q/k norms per layer, the final norm)."""
    per = 2 * cfg.d_model + (2 * cfg.head_dim if cfg.qk_norm else 0)
    return cfg.num_layers * per + cfg.d_model


@pytest.mark.parametrize("name", ["qwen-32b", "llama-70b"])
def test_table4_configs_match_reference(name):
    for reduced in (False, True):
        p, j = _cfgs(name, reduced)
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(j, f.name), f.name
        assert p.active_params() == j.active_params() == j.num_params()
        assert p.num_params() == j.num_params() + _norm_scales(p)
        from repro_torch.models import transformer as T
        from repro_torch.parallel import Layout
        params = T.Transformer(p, Layout(), torch.float32,
                               "cpu" if reduced else "meta")
        assert p.num_params() == sum(x.numel() for x in params.parameters())
    if name == "qwen-32b":
        assert get_config(name).active_params() == 32_761_446_400
        assert get_config(name).source == "paper Table 4 / hf:Qwen/Qwen3-32B"
    else:
        assert get_config(name).active_params() == 70_552_387_584


# ---------------------------------------------------------------------------
# the engine under the adaptive policy, against the reference's
# ---------------------------------------------------------------------------
def _randomize_norms(tree, rng):
    return {k: (_randomize_norms(v, rng) if isinstance(v, dict)
                else rng.standard_normal(v.shape).astype(v.dtype)
                if k in ("scale", "q_norm", "k_norm") else v)
            for k, v in tree.items()}


def _weights(name):
    pc, jc = _cfgs(name, reduced=True)
    jm = build_model(jc, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    tree = _randomize_norms(tree, np.random.default_rng(0))
    model = Model(pc, device="cpu", dtype=torch.float32)
    model.load_params(from_jax_params(tree, pc))
    return jm, jax.tree.map(jnp.asarray, tree), model


@pytest.fixture(scope="module")
def weights():
    return _weights("qwen3-8b")


def _fake_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


BASE = dict(max_slots=8, s_max=256, prefill_chunk=64)
PROMPTS = [list(range(1, 20 + 3 * i)) for i in range(6)]
# a 16-token shared prefix before repetitive prompts long enough that the
# first request's prefill step prices as base
PS_PROMPTS = [list(range(1000, 1016)) + ([2, 3, 4] * 10)[:20 + i]
              for i in range(4)]
CASES = {
    "mixed": (BASE, PROMPTS, 8),
    "serialized-paged": (dict(BASE, mixed=False), PROMPTS, 8),
    "serialized-dense": (dict(BASE, paged=False, mixed=False), PROMPTS, 8),
    "prefix-spec-k4": (dict(max_slots=4, s_max=64, prefill_chunk=64,
                            block_size=8, prefix=True, spec=4),
                       PS_PROMPTS, 10),
    "tight-pool": (dict(BASE, block_size=8, num_blocks=9), PROMPTS, 8),
}


def _serve_case(side, weights, kw, prompts, n_new, name="qwen3-8b"):
    jm, params, model = weights
    kw = dict(kw)
    prefix, spec = kw.pop("prefix", False), kw.pop("spec", 0)
    port_pol, ref_pol = _policies(name, True, 2, 2, "h100")
    if side == "reference":
        eng = JaxEngine(jm, jm, params, params, JaxEngineConfig(
            prefix=JaxPrefixConfig(enabled=prefix),
            spec=JaxSpecConfig(k=spec), **kw), policy=ref_pol,
            now=_fake_clock())
        make = JaxRequest
    else:
        eng = ShiftEngine(model, EngineConfig(
            prefix=PrefixConfig(enabled=prefix), spec=SpecConfig(k=spec),
            **kw), policy=port_pol, now=_fake_clock())
        make = Request
    reqs = [make(i, list(p), max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return eng, reqs


@pytest.mark.parametrize("case", list(CASES))
def test_adaptive_engine_matches_reference(weights, case):
    kw, prompts, n_new = CASES[case]
    ref, rreqs = _serve_case("reference", weights, kw, prompts, n_new)
    eng, reqs = _serve_case("port", weights, kw, prompts, n_new)
    assert [r.generated for r in reqs] == [r.generated for r in rreqs]
    assert all(r.finish_reason == "ok" and len(r.generated) == n_new
               for r in reqs)
    assert eng.config_counts == ref.config_counts
    assert eng.config_counts["base"] > 0 and eng.config_counts["shift"] > 0
    assert [r["config"] for r in eng.step_log] == \
        [r["config"] for r in ref.step_log]
    assert _js(eng.obs.dump()) == _js(ref.obs.dump())
    assert eng.preemptions == ref.preemptions
    if "num_blocks" in kw:
        assert eng.preemptions > 0
    if kw.get("spec"):
        reg = eng.obs.registry
        assert reg.counter_total("spec_accepted_total") > 0
        assert reg.counter_total("prefix_hits_total") > 0


def test_adaptive_step_configs_follow_the_recorded_facts(weights):
    """Each step's config is what the policy gives for the facts the step
    record holds (the shift audit)."""
    eng, _ = _serve_case("port", weights, *CASES["mixed"])
    pol = eng.policy
    assert isinstance(pol, AdaptivePolicy)
    n_prefill = [r["prefill_tokens"] for r in eng.step_log]
    for rec, npf in zip(eng.step_log, n_prefill):
        if rec["config"] is None:
            continue
        want = pol.use_base(rec["n_tokens"], npf,
                            ctx_tokens=rec["ctx_tokens"],
                            n_rows=rec["n_rows"], ctx_max=rec["ctx_max"],
                            spec_tokens=rec.get("spec_tokens", 0))
        assert rec["config"] == ("base" if want else "shift")


def test_reduced_qwen32b_engine_matches_reference():
    """The reduced qwen-32b (its own name, rope and qk_norm at the test
    size) through the mixed engine under both policies."""
    w = _weights("qwen-32b")
    jm, params, model = w
    for pol_port, pol_ref in ((ThresholdPolicy(32), None),
                              _policies("qwen-32b", True, 2, 2, "h100")):
        from repro.core.policy import ThresholdPolicy as JaxThreshold
        ref = JaxEngine(jm, jm, params, params, JaxEngineConfig(**BASE),
                        policy=pol_ref or JaxThreshold(32))
        eng = ShiftEngine(model, EngineConfig(**BASE), policy=pol_port)
        streams = []
        for e, make in ((ref, JaxRequest), (eng, Request)):
            reqs = [make(i, list(p), max_new_tokens=8)
                    for i, p in enumerate(PROMPTS)]
            for r in reqs:
                e.submit(r)
            e.run_until_idle()
            streams.append([r.generated for r in reqs])
        assert streams[0] == streams[1]
        assert eng.config_counts == ref.config_counts


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
def test_build_engine_prices_the_layout():
    """``adaptive=True``: the cost model of the served config, at (2, 2)
    for one rank; ``adaptive_policy`` takes a layout's (sp, tp) as is."""
    eng = serve.build_engine(reduced=True, device="cpu", dtype=torch.float32,
                             adaptive=True)
    pol = eng.policy
    assert isinstance(pol, AdaptivePolicy) and (pol.sp, pol.tp) == (2, 2)
    assert pol.cost_model.cfg == get_config("qwen3-8b").reduced()
    assert pol.cost_model.hw == H100
    p = serve.adaptive_policy(get_config("qwen-32b"), 4, 2)
    assert (p.sp, p.tp) == (4, 2)
    assert isinstance(serve.build_engine(reduced=True, device="cpu",
                                         dtype=torch.float32).policy,
                      ThresholdPolicy)


def test_cli_adaptive_prints_steps_by_config(capsys):
    serve.main(["--reduced", "--device", "cpu", "--dtype", "fp32",
                "--adaptive", "--requests", "4", "--max-new", "6"])
    out = capsys.readouterr().out
    assert "shift policy: AdaptivePolicy" in out and "h100" in out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("configs used:"))
    counts = dict(kv.split("=") for kv in line.split(": ")[1].split())
    assert int(counts["base"]) > 0 and int(counts["shift"]) > 0
    assert "steps by config" in out


def test_cli_serves_qwen32b_reduced(capsys):
    serve.main(["--arch", "qwen-32b", "--reduced", "--device", "cpu",
                "--requests", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "8 tokens in" in out
    assert "shift policy: ThresholdPolicy(threshold=32)" in out
    assert "reason=ok" in out
