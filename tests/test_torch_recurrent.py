"""recurrentgemma-9b on one rank (``models.recurrent``, the local layers'
ring attention in ``models.attention``, ``models.attention_math``), held
to the reference in fp32 at reduced size: the layers ``("rglru", "rglru",
"local", "rglru")``, d_model 64, 4 query heads and one KV head of 16, an
LRU width of 64 in 16 channel blocks, a window of 8 and soft-capped
scores. The weights are the reference's ``init_params(key(0))`` with
random norm scales, converted by ``from_jax_params``.

* ``tests/test_equivalence.py``'s inputs (B 8, S 16, a dense cache of 32
  rows, so the local layer's ring holds 8 rows and wraps): prefill logits
  within 3e-4 of the reference's single-device run, equal next tokens, and
  the caches (the ring's K/V, the RG-LRU ``h`` and conv tail) within 3e-4
  after the decode step.
* The plain pieces against the reference's: the doubling scan against
  ``repro.models.recurrent._scan``, and the windowed, soft-capped
  ``attend``/``attend_partial`` against ``repro.models.attention_math``.
* The serialized dense engine (the automatic fallback: local and RG-LRU
  layers do not page) against the reference's ``ShiftEngine`` on
  staggered arrivals over two slots: equal streams, config counts,
  preemptions and final caches. A later request reuses a freed slot, whose
  RG-LRU state it inherits (the reference resets nothing on admit), and
  the idle slot's state is advanced by the dummy rows of the steps it sits
  out; every request decodes past the window.
* The configuration's counts and the converter: ``active_params`` is the
  reference's ``num_params`` (which leaves the RG-LRU layers' MLPs out),
  ``num_params`` counts the port's modules; the ``mix.*`` leaves shard
  over TP and the model group and come back bitwise.

Four test functions, so that ``--dist loadfile`` runs the file beside
``tests/test_equivalence.py``.
"""
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
from repro_torch.convert import (from_jax_params, shard_state,  # noqa: E402
                                 unshard_state)
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention_math as TAM  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402

ARCH = "recurrentgemma-9b"
B, S, S_MAX = 8, 16, 32
# the reference's cache leaves of each kind -> the port's DenseCache fields
FIELDS = {"rglru": {"h": "h", "conv": "conv"},
          "local": {"k": "ring_k", "v": "ring_v"}}


def _randomize_norms(tree, rng):
    return {k: (_randomize_norms(v, rng) if isinstance(v, dict)
                else rng.standard_normal(v.shape).astype(v.dtype)
                if k == "scale" else v)
            for k, v in tree.items()}


def ref_cache(tree, cfg):
    """The reference's dense cache tree (``body.s{k}`` stacked over the
    pattern's repeats, ``suffix.{i}``) as the port's ``DenseCache`` fields,
    each layer's leaves stacked in ``cfg.layer_kinds`` order within its
    kind."""
    pat, npat = cfg.layer_pattern, len(cfg.layer_pattern)
    layers = []
    for r in range(cfg.pattern_repeats):
        for k in range(npat):
            leaves = tree["body"][f"s{k}"]
            layers.append((pat[k], {n: a[r] for n, a in leaves.items()}))
    for i, kind in enumerate(cfg.suffix_layers):
        layers.append((kind, tree["suffix"][str(i)]))
    out = {}
    for kind, leaves in layers:
        for name, a in leaves.items():
            out.setdefault(FIELDS[kind][name], []).append(np.asarray(a))
    return {name: np.stack(parts) for name, parts in out.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's model, weights and its single-device run."""
    jm = build_model(jax_config(ARCH).reduced(), dtype=jnp.float32)
    tree = _randomize_norms(
        jax.tree.map(np.asarray, jm.init_params(jax.random.key(0))),
        np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, tree)
    toks = jax.random.randint(jax.random.key(1), (B, S), 0,
                              jm.cfg.vocab_size)
    cache = jm.init_cache(B, S_MAX)
    logits, cache = jm.prefill_fn()(params, cache, toks,
                                    jnp.zeros((B,), jnp.int32))
    nxt, cache = jm.decode_fn()(
        params, cache, jnp.arange(B, dtype=jnp.int32) % jm.cfg.vocab_size,
        jnp.full((B,), S, jnp.int32))
    return {"jm": jm, "tree": tree, "params": params,
            "toks": np.asarray(toks), "logits": np.asarray(logits),
            "next": np.asarray(nxt),
            "cache": jax.tree.map(np.asarray, cache)}


def _port(tree):
    cfg = get_config(ARCH).reduced()
    m = Model(cfg, device="cpu", dtype=torch.float32)
    m.load_params(from_jax_params(tree, cfg))
    return m


def test_prefill_decode_and_caches_match_reference(ref):
    m = _port(ref["tree"])
    cfg = m.cfg
    assert cfg.layer_kinds == ("rglru", "rglru", "local", "rglru")
    assert (cfg.local_window, cfg.logits_soft_cap, cfg.num_kv_heads,
            cfg.act) == (8, 30.0, 1, "geglu")
    m.init_cache(B, S_MAX)
    logits, _ = m.prefill(ref["toks"], np.zeros((B,), np.int32))
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=3e-4,
                               atol=3e-4)
    assert np.abs(ref["logits"]).max() > 0.1
    nxt, cache = m.decode(np.arange(B) % cfg.vocab_size, np.full((B,), S))
    np.testing.assert_array_equal(nxt.numpy(), ref["next"])
    want = ref_cache(ref["cache"], cfg)
    got = cache.tensors()
    assert set(got) == set(want) == {"ring_k", "ring_v", "h", "conv"}
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=3e-4,
                                   atol=3e-4, err_msg=name)
        assert np.abs(w).max() > 0, name
    # the ring holds 8 rows (the window) of a 32-row cache: the decode
    # step's position 16 landed in row 0, over position 8
    assert got["ring_k"].shape[2] == cfg.local_window
    assert got["h"].dtype == torch.float32


def test_scan_and_windowed_attention_match_reference():
    """The doubling scan against ``jax.lax.associative_scan``'s (lengths
    that are and are not powers of two), and the windowed, soft-capped
    attention of ragged key positions (a ring's invalid rows are -1)."""
    from repro.models import attention_math as AM
    from repro.models import recurrent as R
    rng = np.random.default_rng(5)
    t = torch.from_numpy
    for S_ in (1, 7, 16):
        a = rng.uniform(0.5, 1.0, (2, S_, 12)).astype(np.float32)
        bx = rng.standard_normal((2, S_, 12)).astype(np.float32)
        h0 = rng.standard_normal((2, 12)).astype(np.float32)
        want = np.asarray(R._scan(jnp.asarray(a), jnp.asarray(bx),
                                  jnp.asarray(h0)))
        np.testing.assert_allclose(TR.scan(t(a), t(bx), t(h0)).numpy(),
                                   want, rtol=1e-5, atol=1e-5)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32) * 4
    k = rng.standard_normal((2, 13, 1, 16)).astype(np.float32) * 4
    v = rng.standard_normal((2, 13, 1, 16)).astype(np.float32)
    qp = np.array([[20, 21, 22, 23, 24], [3, 4, 5, 6, 7]])
    kvp = np.stack([np.arange(12, 25), np.r_[-1, -1, -1, -1, -1, -1,
                                             np.arange(7)]])
    for window, cap in ((8, 30.0), (0, 5.0), (8, 0.0)):
        kw = dict(causal=True, window=window, soft_cap=cap)
        want = np.asarray(AM.attend(q, k, v, qp, kvp, chunk=4, **kw))
        got = TAM.attend(t(q), t(k), t(v), t(qp), t(kvp), window=window,
                         soft_cap=cap, chunk=4)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        wa = AM.finish_partial(*AM.attend_partial(q, k, v, qp, kvp, **kw))
        ga = TAM.finish_partial(*TAM.attend_partial(
            t(q), t(k), t(v), t(qp), t(kvp), window=window, soft_cap=cap))
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-5,
                                   atol=1e-5)
    # the soft cap bites: scores of magnitude well above 30 are capped
    raw = TAM.attend(t(q * 10), t(k), t(v), t(qp), t(kvp), window=8)
    capped = TAM.attend(t(q * 10), t(k), t(v), t(qp), t(kvp), window=8,
                        soft_cap=30.0)
    assert (raw - capped).abs().max() > 1e-2


PROMPTS = [list(range(3, 14)), list(range(40, 60)), list(range(7, 40)),
           list(range(90, 99))]
# steps before each later submission: request 1 joins while request 0 is
# mid-prefill; requests 2 and 3 queue for a slot and reuse a freed one
STAGGER = (1, 2, 0)
NEW = 12                           # every stream decodes past the window
KW = dict(max_slots=2, s_max=64, prefill_chunk=8)


def _serve(make_engine, make_request, after_step=None):
    eng = make_engine()
    reqs = [make_request(i, p, NEW) for i, p in enumerate(PROMPTS)]
    eng.submit(reqs[0])
    for r, wait in zip(reqs[1:], STAGGER):
        for _ in range(wait):
            eng.step()
        eng.submit(r)
    for _ in range(1000):
        progressed = eng.step()
        if after_step is not None:
            after_step(eng)
        if not progressed and not eng.queue and not eng.active:
            break
    return [list(r.generated) for r in reqs], eng


def test_dense_engine_matches_reference(ref):
    want, jeng = _serve(
        lambda: JaxEngine(ref["jm"], ref["jm"], ref["params"], ref["params"],
                          JaxEngineConfig(**KW), policy=JaxPolicy(32)),
        lambda i, p, n: JaxRequest(i, p, max_new_tokens=n))
    idle_advanced = []

    def watch(eng):
        # a slot outside a step keeps no request, and its state moves
        # all the same (the dummy rows)
        busy = {r.slot for r in eng.active}
        for s in range(KW["max_slots"]):
            if s not in busy:
                idle_advanced.append(bool(eng._cache.h[:, s].abs().sum()
                                          > 0))

    got, eng = _serve(lambda: ShiftEngine(_port(ref["tree"]),
                                          EngineConfig(**KW)),
                      lambda i, p, n: Request(i, p, max_new_tokens=n), watch)
    assert got == want
    assert all(len(s) == NEW for s in got)
    assert dict(eng.config_counts) == dict(jeng.config_counts)
    assert eng.preemptions == jeng.preemptions
    assert (eng.paged, eng.mixed) == (jeng.paged, jeng.mixed) == (False,
                                                                 False)
    assert eng.paged_disabled_reason == jeng.paged_disabled_reason
    assert idle_advanced and all(idle_advanced)
    # four requests on two slots: two of them reused a slot
    want_cache = ref_cache(jax.tree.map(np.asarray, jeng.cache), eng.mcfg)
    for name, w in want_cache.items():
        np.testing.assert_allclose(eng._cache.tensors()[name].numpy(), w,
                                   rtol=3e-4, atol=3e-4, err_msg=name)
    with pytest.raises(ValueError, match="cannot use a paged KV cache"):
        ShiftEngine(_port(ref["tree"]), EngineConfig(paged=True))
    m = _port(ref["tree"])
    assert not m.supports_paged
    with pytest.raises(ValueError, match="only GQA attention layers page"):
        m.init_paged_cache(9, 8)


def test_counts_and_converter(ref):
    """``active_params`` is the reference's count at full width and
    reduced; ``num_params`` adds the RG-LRU layers' MLPs and the norm
    scales and equals the modules' size. The converter puts ``body.s{k}``
    and ``suffix.0`` on layers 0-3; the ``mix.*`` and attention leaves cut
    over (2, 2) and its shift config come back bitwise."""
    full = get_config(ARCH)
    assert full.active_params() == jax_config(ARCH).num_params()
    small = get_config(ARCH).reduced()
    assert small.active_params() == jax_config(ARCH).reduced().num_params()
    m = _port(ref["tree"])
    assert small.num_params() == sum(p.numel()
                                     for p in m.params.parameters())
    d, ff, w = full.d_model, full.d_ff, full.rglru.lru_width
    n_rg = full.layer_kinds.count("rglru")
    assert n_rg == 26 and full.layer_kinds.count("local") == 12
    # the port counts each RG-LRU layer's MLP (and its exact gates), the
    # reference approximates the gates and leaves the MLP out
    rg_exact = 3 * d * w + 4 * w + 2 * w * (w // 16) + w + 3 * d * ff
    rg_ref = 3 * d * w + 4 * w + 2 * w + 2 * w * w // 8
    assert full.num_params() - full.active_params() == n_rg * (
        rg_exact - rg_ref + 2 * d) + 12 * 2 * d + d
    tree = ref["tree"]
    st = from_jax_params(tree, small)
    np.testing.assert_array_equal(st["layers.1.mix.gate_a"],
                                  tree["body"]["s1"]["mix"]["gate_a"][0])
    np.testing.assert_array_equal(st["layers.2.attn.wk"],
                                  tree["body"]["s2"]["attn"]["wk"][0])
    np.testing.assert_array_equal(st["layers.3.mix.lam"],
                                  tree["suffix"]["0"]["mix"]["lam"])
    lay = Layout(sp=2, tp=2)
    for la in (lay, lay.to_shift()):
        shards = [shard_state(st, small, la, r) for r in range(4)]
        # the model group's leaves take model-rank order
        by_model = sorted(range(4), key=la.model_rank)
        back = unshard_state([shards[r] for r in by_model], small, la)
        for name, a in st.items():
            np.testing.assert_array_equal(back[name], a, err_msg=name)
        g1 = by_model[1]
        np.testing.assert_array_equal(shards[g1]["layers.0.mix.lam"],
                                      st["layers.0.mix.lam"][16:32])
        np.testing.assert_array_equal(shards[g1]["layers.0.mix.gate_x"],
                                      st["layers.0.mix.gate_x"][4:8])
