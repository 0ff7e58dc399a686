"""Multi-head latent attention and the prefix/pattern/suffix layer stack on
one rank (``models.mla``, ``models.transformer``, ``convert``), held to the
reference in fp32.

* Reduced deepseek-v3-671b (one dense MLA prefix layer, two MLA+MoE
  layers) and reduced llama4-maverick-400b-a17b (its ``("attn", "moe")``
  pattern once) at ``tests/test_arch_smoke.py``'s shapes (B 2, S 16, a
  dense cache of 32): prefill logits within 3e-4 of the reference's, equal
  next tokens, and deepseek's latent cache within 3e-4 of the reference's.
  The weights are the reference's ``init_params(key(0))`` with random
  norm scales (``ln1``/``ln2``/the final norm and MLA's ``q_norm`` and
  ``kv_norm``), converted by ``from_jax_params``.
* The serialized dense engine against the reference's ``ShiftEngine``:
  deepseek falls back to it by itself (MLA does not page; the reason is
  the reference's), Maverick is asked for it; equal streams and config
  counts. deepseek's requests arrive while the first is mid-prefill, so
  that prefill steps meet rows at two offsets: the uniform offset rule
  (the reference's) holds the later row back a step.
* The converter: the prefix, the stacked body (each kind of the pattern
  its own ``s{k}``) and the suffix land on the layers of
  ``cfg.layer_kinds`` in order; ``mtp.*`` keeps its names; an unknown leaf, a
  missing one or a stack of another depth raises.

Six test functions, as ``tests/test_torch_pod_ep.py`` explains.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.policy import ThresholdPolicy as JaxPolicy  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import Request as JaxRequest  # noqa: E402
from repro.engine import ShiftEngine as JaxEngine  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402

ARCHS = ("deepseek-v3-671b", "llama4-maverick-400b-a17b")
B, S, S_MAX = 2, 16, 32
NORMS = ("scale", "q_norm", "kv_norm")


def _randomize_norms(tree, rng):
    return {k: (_randomize_norms(v, rng) if isinstance(v, dict)
                else rng.standard_normal(v.shape).astype(v.dtype)
                if k in NORMS else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def refs():
    """Per arch: the reference's model, its weights and its smoke run."""
    out = {}
    for arch in ARCHS:
        jm = build_model(jax_config(arch).reduced(), dtype=jnp.float32)
        tree = _randomize_norms(
            jax.tree.map(np.asarray, jm.init_params(jax.random.key(0))),
            np.random.default_rng(0))
        params = jax.tree.map(jnp.asarray, tree)
        toks = jax.random.randint(jax.random.key(1), (B, S), 0,
                                  jm.cfg.vocab_size)
        cache = jm.init_cache(B, S_MAX)
        logits, cache = jm.prefill_fn()(params, cache, toks,
                                        jnp.zeros((B,), jnp.int32))
        nxt, cache = jm.decode_fn()(params, cache, jnp.zeros((B,), jnp.int32),
                                    jnp.full((B,), S, jnp.int32))
        out[arch] = {"jm": jm, "tree": tree, "params": params,
                     "toks": np.asarray(toks), "logits": np.asarray(logits),
                     "next": np.asarray(nxt),
                     "cache": jax.tree.map(np.asarray, cache)}
    return out


def _port(arch, tree, **kw):
    cfg = get_config(arch).reduced()
    m = Model(cfg, device="cpu", dtype=torch.float32, **kw)
    m.load_params(from_jax_params(tree, cfg))
    return m


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(refs, arch):
    ref = refs[arch]
    m = _port(arch, ref["tree"])
    m.init_cache(B, S_MAX)
    logits, _ = m.prefill(ref["toks"], np.zeros((B,), np.int32))
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=3e-4,
                               atol=3e-4)
    assert np.abs(ref["logits"]).max() > 0.1
    nxt, cache = m.decode(np.zeros((B,), np.int32), np.full((B,), S))
    np.testing.assert_array_equal(nxt.numpy(), ref["next"])
    if m.cfg.mla is not None:
        c = ref["cache"]
        want = np.concatenate([c["prefix"]["0"]["lat"][None],
                               c["body"]["s0"]["lat"]])
        assert cache.lat.shape == want.shape and cache.k is None
        np.testing.assert_allclose(cache.lat.numpy(), want, rtol=3e-4,
                                   atol=3e-4)
        # positions 0..S written, the rest untouched
        assert np.abs(want[:, :, :S + 1]).sum(-1).min() > 0
        assert not want[:, :, S + 1:].any()


def _serve(make_engine, make_request, prompts, n_new, stagger=()):
    """Serve ``prompts``; ``stagger`` gives the steps to run before each
    later request is submitted (the first goes in at once)."""
    eng = make_engine()
    reqs = [make_request(i, p, n_new) for i, p in enumerate(prompts)]
    eng.submit(reqs[0])
    for r, wait in zip(reqs[1:], list(stagger) + [0] * len(reqs)):
        for _ in range(wait):
            eng.step()
        eng.submit(r)
    eng.run_until_idle()
    return [list(r.generated) for r in reqs], dict(eng.config_counts), eng


PROMPTS = [list(range(3, 14)), list(range(40, 60)), list(range(7, 40)),
           list(range(90, 97))]
# (arch, engine settings, steps before each later submission): deepseek
# with requests submitted while the first is mid-prefill, so that a
# prefill step meets rows at two offsets (the uniform offset rule)
ENGINES = [("deepseek-v3-671b", {}, (1, 1, 0)),
           ("llama4-maverick-400b-a17b", {"paged": False, "mixed": False},
            ())]


@pytest.mark.parametrize("arch,kw,stagger", ENGINES,
                         ids=["deepseek", "maverick"])
def test_dense_engine_matches_reference(refs, arch, kw, stagger):
    ref = refs[arch]
    kw = dict(kw, max_slots=2, s_max=64, prefill_chunk=8)
    want, want_counts, jeng = _serve(
        lambda: JaxEngine(ref["jm"], ref["jm"], ref["params"], ref["params"],
                          JaxEngineConfig(**kw), policy=JaxPolicy(32)),
        lambda i, p, n: JaxRequest(i, p, max_new_tokens=n), PROMPTS, 6,
        stagger)
    got, counts, eng = _serve(
        lambda: ShiftEngine(_port(arch, ref["tree"]), EngineConfig(**kw)),
        lambda i, p, n: Request(i, p, max_new_tokens=n), PROMPTS, 6,
        stagger)
    assert got == want
    assert counts == want_counts
    assert (eng.paged, eng.mixed) == (jeng.paged, jeng.mixed) == (False,
                                                                 False)
    assert eng.paged_disabled_reason == jeng.paged_disabled_reason
    if arch == "deepseek-v3-671b":
        # MLA does not page: the engine refuses paged=True, the model the pool
        assert "MLA" in eng.paged_disabled_reason
        with pytest.raises(ValueError, match="cannot use a paged KV cache"):
            ShiftEngine(_port(arch, ref["tree"]), EngineConfig(paged=True))
        m = _port(arch, ref["tree"])
        assert not m.supports_paged
        with pytest.raises(ValueError, match="MLA"):
            m.init_paged_cache(9, 8)


def test_converter_maps_stacks_and_refuses_unknown_leaves(refs):
    """deepseek: prefix.0 -> layers.0, body.s0[r] -> layers.1 + r;
    Maverick: body.s0 (attn) -> layers.0, body.s1 (moe) -> layers.1; a
    suffix layer goes after the body. ``mtp.*`` keeps its names (the MTP
    head trains; serving does not read it). An unknown leaf,
    a missing one or a stack of another depth raises."""
    tree = refs["deepseek-v3-671b"]["tree"]
    cfg = get_config("deepseek-v3-671b").reduced()
    assert cfg.layer_kinds == ("attn", "moe", "moe") and "mtp" in tree
    st = from_jax_params(tree, cfg)
    np.testing.assert_array_equal(st["mtp.proj"], tree["mtp"]["proj"])
    np.testing.assert_array_equal(st["mtp.block.attn.wkv_a"],
                                  tree["mtp"]["block"]["attn"]["wkv_a"])
    np.testing.assert_array_equal(st["layers.0.attn.wq_a"],
                                  tree["prefix"]["0"]["attn"]["wq_a"])
    np.testing.assert_array_equal(st["layers.0.ffn.wi"],
                                  tree["prefix"]["0"]["ffn"]["wi"])
    for r in range(2):
        np.testing.assert_array_equal(st[f"layers.{1 + r}.ffn.wo"],
                                      tree["body"]["s0"]["ffn"]["wo"][r])
    mav = refs["llama4-maverick-400b-a17b"]["tree"]
    mcfg = get_config("llama4-maverick-400b-a17b").reduced()
    mst = from_jax_params(mav, mcfg)
    np.testing.assert_array_equal(mst["layers.0.ffn.wi"],
                                  mav["body"]["s0"]["ffn"]["wi"][0])
    np.testing.assert_array_equal(mst["layers.1.ffn.router"],
                                  mav["body"]["s1"]["ffn"]["router"][0])
    # a suffix layer: the prefix layer's leaves again, as suffix.0
    scfg = dataclasses.replace(cfg, num_layers=4, suffix_layers=("attn",))
    stree = dict(tree, suffix={"0": tree["prefix"]["0"]})
    sst = from_jax_params(stree, scfg)
    assert scfg.layer_kinds == ("attn", "moe", "moe", "attn")
    np.testing.assert_array_equal(sst["layers.3.attn.wkv_a"],
                                  tree["prefix"]["0"]["attn"]["wkv_a"])
    body = tree["body"]["s0"]
    bad = dict(tree, body={"s0": dict(body, attn=dict(
        body["attn"], bogus=np.zeros((2, 3), np.float32)))})
    with pytest.raises(ValueError, match="bogus"):
        from_jax_params(bad, cfg)
    with pytest.raises(ValueError, match="no parameter"):
        from_jax_params(dict(tree, extra={"w": np.zeros(3)}), cfg)
    no_prefix = {k: v for k, v in tree.items() if k != "prefix"}
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(no_prefix, cfg)
    short = dict(tree, body={"s0": jax.tree.map(lambda a: a[:1], body)})
    with pytest.raises(ValueError, match="stacked layers"):
        from_jax_params(short, cfg)


def test_attention_math_matches_reference():
    """The copies of ``attention_math``: ``attend`` over several key chunks,
    and ``attend_partial`` on two halves of the keys merged by LSE (a
    half with no live key adds exactly nothing), against the reference's
    ``attend`` on all keys."""
    from repro.models import attention_math as AM
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 5, 4, 24)).astype(np.float32)
    k = rng.standard_normal((2, 40, 4, 24)).astype(np.float32)
    v = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    qp = np.array([[10, 11, 12, 13, 14], [3, 4, 5, 6, 7]])
    kv_len = np.array([15, 8])
    want = np.asarray(AM.attend(q, k, v, qp, np.arange(40), kv_len=kv_len,
                                chunk=16))
    t = torch.from_numpy
    got = TMLA.attend(t(q), t(k), t(v), t(qp), torch.arange(40),
                      kv_len=t(kv_len), chunk=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    parts = [TMLA.attend_partial(t(q), t(k[:, a:a + 20]), t(v[:, a:a + 20]),
                                 t(qp), torch.arange(a, a + 20),
                                 kv_len=t(kv_len)) for a in (0, 20)]
    acc, l, m = (torch.stack(x) for x in zip(*parts))
    assert (parts[1][2][1] == TMLA.NEG_INF).all()    # row 1: no live key
    corr = torch.exp(m - m.amax(0))
    merged = (acc * corr[..., None]).sum(0) / (l * corr).sum(0)[..., None]
    B, Hkv, g, Sq, Dv = merged.shape
    np.testing.assert_allclose(
        merged.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hkv * g, Dv).numpy(),
        want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TMLA.finish_partial(*parts[0]).numpy()[1], want[1], rtol=1e-5,
        atol=1e-5)
