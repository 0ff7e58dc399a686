"""The port's ``ShiftEngine`` on the CPU against the reference's.

Both serve reduced qwen3-8b at fp32 from the same weights (the reference's
init with random norm scales, converted) with ``ThresholdPolicy`` and the
serve CLI's workload: 6 requests, prompt i = ``range(1, 20 + 3i)``, 8 new
tokens. Greedy streams, config counts and preemptions must be equal, and
every block but the null block must be free at exit, with and without pool
pressure.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.core.policy import ThresholdPolicy as JaxPolicy  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import Request as JaxRequest  # noqa: E402
from repro.engine import ShiftEngine as JaxEngine  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.models import Model  # noqa: E402

N_REQ, MAX_NEW = 6, 8


def _randomize_norms(tree, rng):
    return {k: (_randomize_norms(v, rng) if isinstance(v, dict)
                else rng.standard_normal(v.shape).astype(v.dtype)
                if k in ("scale", "q_norm", "k_norm") else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def weights():
    jm = build_model(reduced_cfg("qwen3-8b"), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    return jm, _randomize_norms(tree, np.random.default_rng(0))


def _prompts():
    return [list(range(1, 20 + 3 * i)) for i in range(N_REQ)]


def _run_reference(jm, tree, **kw):
    params = jax.tree.map(jnp.asarray, tree)
    eng = JaxEngine(jm, jm, params, params, JaxEngineConfig(**kw),
                    policy=JaxPolicy(32))
    reqs = [JaxRequest(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return ([r.generated for r in reqs], eng.config_counts, eng.preemptions,
            eng.kv.num_free_blocks, eng.kv.num_blocks_per_row)


def _run_port(tree, **kw):
    cfg = get_config("qwen3-8b").reduced()
    model = Model(cfg, device="cpu", dtype=torch.float32)
    model.load_params(from_jax_params(tree, cfg))
    eng = ShiftEngine(model, EngineConfig(**kw))
    reqs = [Request(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert all(r.finish_reason == "ok" for r in reqs)
    return ([r.generated for r in reqs], eng.config_counts, eng.preemptions,
            eng.kv.num_free_blocks, eng.kv.num_blocks)


@pytest.mark.parametrize("kw", [{}, {"num_blocks": 9, "block_size": 8}],
                         ids=["no-pressure", "tight-pool"])
def test_engine_matches_reference(weights, kw):
    jm, tree = weights
    want = _run_reference(jm, tree, **kw)
    got = _run_port(tree, **kw)
    streams, counts, preempt, free, total = got
    assert streams == want[0]
    assert counts == want[1]
    assert preempt == want[2]
    assert free == want[3] == total - 1
    assert all(len(s) == MAX_NEW for s in streams)
    if kw:
        assert preempt > 0          # the tight pool really preempts
    assert counts["base"] > 0 and counts["shift"] > 0
