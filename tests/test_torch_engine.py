"""The port's ``ShiftEngine`` on the CPU against the reference's.

Both serve reduced qwen3-8b at fp32 from the same weights (the reference's
init with random norm scales, converted) with ``ThresholdPolicy`` and the
serve CLI's workload: 6 requests, prompt i = ``range(1, 20 + 3i)``, 8 new
tokens. Greedy streams, config counts and preemptions must be equal, and
every block but the null block must be free at exit, with and without pool
pressure, for the mixed iteration, the serialized one on the paged pool
(``mixed=False``) and the serialized one on the dense cache
(``paged=False, mixed=False``). Then the port's own invariant, as the
reference's ``tests/test_mixed.py`` states it: the mixed engine's streams
equal the serialized engine's, with a mid-run prompt burst and under
memory pressure.
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
    kv = eng.kv
    return ([r.generated for r in reqs], eng.config_counts, eng.preemptions,
            kv and kv.num_free_blocks, kv and kv.num_blocks_per_row)


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
    kv = eng.kv
    return ([r.generated for r in reqs], eng.config_counts, eng.preemptions,
            kv and kv.num_free_blocks, kv and kv.num_blocks)


TIGHT = {"num_blocks": 9, "block_size": 8}


@pytest.mark.parametrize("kw", [
    {}, TIGHT, {"mixed": False}, {"mixed": False, **TIGHT},
    {"paged": False, "mixed": False}],
    ids=["no-pressure", "tight-pool", "serialized", "serialized-tight-pool",
         "dense"])
def test_engine_matches_reference(weights, kw):
    jm, tree = weights
    want = _run_reference(jm, tree, **kw)
    got = _run_port(tree, **kw)
    streams, counts, preempt, free, total = got
    assert streams == want[0]
    assert counts == want[1]
    assert preempt == want[2]
    if kw.get("paged", True):
        assert free == want[3] == total - 1
    else:
        assert free is None and want[3] is None
    assert all(len(s) == MAX_NEW for s in streams)
    if "num_blocks" in kw:
        assert preempt > 0          # the tight pool really preempts
    assert counts["base"] > 0 and counts["shift"] > 0


def _port_engine_run(name, mixed, prompts, n_new=6, burst=None, **kw):
    """``tests/test_mixed.py``'s ``_run_engine`` on the port: 4 slots,
    s_max 64, chunk 8, threshold 4, weights from ``torch.Generator(0)``; a
    prompt burst arrives once the first token is out."""
    model = Model(get_config(name).reduced(), device="cpu",
                  dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    eng = ShiftEngine(model, EngineConfig(max_slots=4, s_max=64,
                                          prefill_chunk=8, threshold=4,
                                          mixed=mixed, **kw))
    reqs = [Request(i, p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    if burst:
        for _ in range(200):
            eng.step()
            if any(r.generated for r in reqs):
                break
        for p in burst:
            nr = Request(100 + len(reqs), p, max_new_tokens=n_new)
            eng.submit(nr)
            reqs.append(nr)
    eng.run_until_idle()
    assert all(len(r.generated) == n_new for r in reqs)
    return {r.rid: tuple(r.generated) for r in reqs}, eng


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen2-7b"])
def test_mixed_matches_serialized(name):
    """Streams equal, and the mixed engine takes fewer iterations."""
    prompts = [list(range(1, 12 + i)) for i in range(3)] + [list(range(2, 40))]
    burst = [list(range(3, 30)), list(range(5, 26))]
    g_mix, e_mix = _port_engine_run(name, True, prompts, burst=list(burst))
    g_ser, e_ser = _port_engine_run(name, False, prompts, burst=list(burst))
    assert e_mix.mixed and not e_ser.mixed
    assert g_mix == g_ser
    assert e_mix.step_count < e_ser.step_count


def test_mixed_matches_serialized_under_memory_pressure():
    """Preemption and re-prefill through the fused path keep the streams
    of the serialized engine on a tight pool, with no block leaked."""
    prompts = [list(range(1, 10 + i)) for i in range(6)]
    kw = dict(block_size=8, num_blocks=7)        # 6 usable blocks ~ 2 seqs
    g_mix, e_mix = _port_engine_run("qwen3-8b", True, prompts, **kw)
    g_ser, e_ser = _port_engine_run("qwen3-8b", False, prompts, **kw)
    assert g_mix == g_ser
    assert e_mix.preemptions > 0
    for eng in (e_mix, e_ser):
        assert eng.kv.num_free_blocks == eng.kv.num_blocks - 1


def test_dense_engine_config_rules():
    """The reference's rules: mixed needs the paged cache; the dense
    cache is reported, and holds no block pool."""
    model = Model(get_config("qwen3-8b").reduced(), device="cpu",
                  dtype=torch.float32)
    with pytest.raises(ValueError, match="paged"):
        ShiftEngine(model, EngineConfig(paged=False, mixed=True))
    eng = ShiftEngine(model, EngineConfig(paged=False))
    assert not eng.paged and not eng.mixed and eng.kv is None
    assert eng.paged_disabled_reason == "paged=False in EngineConfig"
    assert tuple(eng.base.cache.k.shape) == (2, 8, 256, 2, 16)
    assert model.cache is None                  # the engine's own view
    eng = ShiftEngine(model, EngineConfig(mixed=False))
    assert eng.paged and not eng.mixed and eng.paged_disabled_reason is None
