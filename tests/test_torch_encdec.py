"""whisper-small and internvl2-2b on one rank, held to the reference in
fp32 at reduced size, on the reference's ``init_params(key(0))`` converted
by ``from_jax_params`` with random norm scales and LayerNorm biases.

* whisper-small (2 encoder and 2 decoder layers over 16 frames, d_model 64,
  4 query heads over 2 KV heads of 16, LayerNorm, the plain GELU MLP)
  through ``prefill_step`` and ``decode_step`` with
  ``tests/test_equivalence.py``'s inputs (B 8, S 16, frames of 0.01, a
  dense cache of 32): prefill logits within 1e-5 of the reference's
  ``prefill_fn``, equal next tokens from ``decode_fn``, a second decode
  step's logits (at other positions in each row) within 1e-5, and the self
  and
  cross caches within 1e-5 of their largest magnitude (the random norm
  scales put cache values near 11, where fp32 matmuls of another order
  differ by ~1e-5).
* The plain pieces against the reference's functions: ``layernorm``, the
  GELU MLP, ``_sin_pos``, and the rope-free causal and the non-causal
  attention (the flash and decode kernels' plain versions against
  ``attend``).
* The dense whisper engine (the automatic fallback: an encoder-decoder
  stack does not page) against the reference's on staggered arrivals over
  two slots, later requests reusing freed slots: streams, config counts,
  preemptions and ``paged_disabled_reason``.
* internvl2-2b's prefill and decode with seeded random image embeddings
  (the vision stub over positions below ``frontend_seq`` 8) against the
  reference.
* internvl2-2b's mixed, serialized paged and serialized dense engines at
  ``frontend_seq`` 32, each against the reference's same path: the
  reference's mixed step applies the stub to decode rows and its decode
  step does not, so mixed and serialized streams differ, in both packages.
* The counts and the converter.

Six test functions, so that ``--dist loadfile`` runs the file beside
``tests/test_equivalence.py``.
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
from repro_torch.convert import (from_jax_cache, from_jax_params,  # noqa: E402
                                 shard_state, unshard_state)
from repro_torch.core.policy import ThresholdPolicy  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402

WHISPER, VLM = "whisper-small", "internvl2-2b"
B, S, S_MAX = 8, 16, 32
# a second decode step's positions, another one for each row of a segment,
# so that a decode step's per-row positions (whisper's sinusoid) show
LENS2 = (S + 1 + np.arange(B) % 4).astype(np.int32)
TOL = 1e-5


def randomize_norms(tree, rng):
    """Random norm scales and LayerNorm biases (the reference draws ones
    and zeros), so that a norm applied in the wrong place shows."""
    return {k: (randomize_norms(v, rng) if isinstance(v, dict)
                else rng.standard_normal(v.shape).astype(v.dtype)
                if k in ("scale", "bias") else v)
            for k, v in tree.items()}


def ref_model(arch, cfg=None, seed=0):
    """The reference's model on one device and its randomized weights."""
    jm = build_model(cfg or jax_config(arch).reduced(), dtype=jnp.float32)
    tree = randomize_norms(
        jax.tree.map(np.asarray, jm.init_params(jax.random.key(0))),
        np.random.default_rng(seed))
    return jm, tree


def port_model(tree, cfg):
    m = Model(cfg, device="cpu", dtype=torch.float32)
    m.load_params(from_jax_params(tree, cfg))
    return m


def extras(cfg, rng=None):
    """``test_equivalence``'s frontend inputs (0.01 everywhere), or seeded
    random image embeddings with ``rng``."""
    fe = ef = None
    if cfg.frontend == "vision_stub":
        fe = (np.full((B, cfg.frontend_seq, cfg.d_model), 0.01, np.float32)
              if rng is None else rng.standard_normal(
                  (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32))
    if cfg.encoder_layers:
        ef = np.full((B, cfg.encoder_seq, cfg.d_model), 0.01, np.float32)
    return fe, ef


def ref_run(jm, tree, fe, ef):
    """The reference's single-device prefill and decode (``_run``)."""
    params = jax.tree.map(jnp.asarray, tree)
    toks = jax.random.randint(jax.random.key(1), (B, S), 0,
                              jm.cfg.vocab_size)
    cache = jm.init_cache(B, S_MAX)
    ex = [jnp.asarray(a) for a in (fe, ef) if a is not None]
    logits, cache = jm.prefill_fn()(params, cache, toks,
                                    jnp.zeros((B,), jnp.int32), *ex)
    nxt, cache = jm.decode_fn()(
        params, cache, jnp.arange(B, dtype=jnp.int32) % jm.cfg.vocab_size,
        jnp.full((B,), S, jnp.int32))
    out = {"cache": jax.tree.map(np.asarray, cache)}
    logits2, _ = jm.decode_fn(sample=False)(params, cache, nxt,
                                            jnp.asarray(LENS2))
    return {"toks": np.asarray(toks), "logits": np.asarray(logits),
            "next": np.asarray(nxt), "logits2": np.asarray(logits2), **out}


def port_run(m, toks, fe, ef):
    cfg = m.cfg
    m.init_cache(B, S_MAX)
    logits, _ = m.prefill(toks, np.zeros((B,), np.int32), frontend_embeds=fe,
                          enc_frames=ef)
    nxt, cache = m.decode(np.arange(B) % cfg.vocab_size, np.full((B,), S))
    snap = {n: t.clone() for n, t in cache.tensors().items()}
    logits2, _ = m.decode(nxt, LENS2, sample=False)
    return logits.numpy(), nxt.numpy(), logits2.numpy(), snap


@pytest.fixture(scope="module")
def whisper():
    jm, tree = ref_model(WHISPER)
    fe, ef = extras(jm.cfg)
    return {"jm": jm, "tree": tree, "ef": ef, **ref_run(jm, tree, fe, ef)}


def test_whisper_prefill_decode_and_caches_match_reference(whisper):
    cfg = get_config(WHISPER).reduced()
    assert (cfg.layer_kinds, cfg.encoder_layers, cfg.encoder_seq, cfg.norm,
            cfg.act, cfg.num_heads, cfg.num_kv_heads) == (
        ("dec", "dec"), 2, 16, "layernorm", "gelu", 4, 2)
    m = port_model(whisper["tree"], cfg)
    logits, nxt, logits2, got = port_run(m, whisper["toks"], None,
                                         whisper["ef"])
    np.testing.assert_allclose(logits, whisper["logits"], rtol=TOL, atol=TOL)
    assert np.abs(whisper["logits"]).max() > 0.1
    np.testing.assert_array_equal(nxt, whisper["next"])
    np.testing.assert_allclose(logits2, whisper["logits2"], rtol=TOL,
                               atol=TOL)
    want = from_jax_cache(whisper["cache"], cfg, paged=False)
    assert set(got) == set(want) == {"k", "v", "cross_k", "cross_v"}
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        scale = float(w.abs().max())
        assert scale > 1, name
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=TOL,
                                   atol=TOL * scale, err_msg=name)
    assert got["cross_k"].shape == (2, B, cfg.encoder_seq, 2, 16)
    # the frames matter: random frames give other logits (constant frames
    # do not: every LayerNorm takes the constant out)
    m.init_cache(B, S_MAX)
    frames = np.random.default_rng(2).standard_normal(
        whisper["ef"].shape).astype(np.float32)
    other, _ = m.prefill(whisper["toks"], np.zeros((B,), np.int32),
                         enc_frames=frames)
    assert np.abs(other.numpy() - logits).max() > 1e-3


def test_plain_pieces_match_reference():
    """``layernorm``, the plain GELU MLP, ``_sin_pos``, and the attention
    the kernels' plain versions compute on whisper's paths (rope-free
    causal prefill against a cache with offsets, non-causal over all keys,
    decode over all ``S_enc`` keys) against the reference's functions."""
    from repro.models import attention_math as AM
    from repro.models import layers as JL
    from repro.models import transformer as JT
    from repro_torch.kernels import ops as K
    from repro_torch.models import layers as TL
    from repro_torch.models import transformer as TT
    rng = np.random.default_rng(3)
    t = torch.from_numpy
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    sc, bi = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    want = np.asarray(JL.layernorm({"scale": sc, "bias": bi}, x))
    np.testing.assert_allclose(TL.layernorm(t(x), t(sc), t(bi)).numpy(),
                               want, rtol=1e-5, atol=1e-5)
    w = {n: rng.standard_normal(s).astype(np.float32) * 0.2
         for n, s in (("wi", (64, 128)), ("wo", (128, 64)))}
    mlp = TL.MLP(64, 128, torch.float32, "cpu", act="gelu")
    assert not hasattr(mlp, "wg")
    mlp.wi.copy_(t(w["wi"]))
    mlp.wo.copy_(t(w["wo"]))
    np.testing.assert_allclose(
        TL.mlp_apply(mlp, t(x)).numpy(),
        np.asarray(JL.mlp_apply(w, x, "gelu", Layout_ref())), rtol=1e-5,
        atol=1e-5)
    pos = np.array([[0, 1, 7, 63], [15, 16, 3, 2]])
    np.testing.assert_allclose(TT._sin_pos(t(pos), 64).numpy(),
                               np.asarray(JT._sin_pos(pos, 64)), rtol=1e-5,
                               atol=1e-5)
    # at full width's frame positions (up to 1535) an ulp of a frequency
    # (XLA's and PyTorch's fp32 exp differ by one in 3 of 32) moves the
    # angle by up to 1535 · 2^-23: within 4e-4
    far = np.array([[300, 1000, 1535]])
    np.testing.assert_allclose(TT._sin_pos(t(far), 64).numpy(),
                               np.asarray(JT._sin_pos(far, 64)), atol=4e-4)
    # rope-free causal prefill: a chunk of 5 at offsets 3 and 9 against a
    # cache of 16 rows (the reference's kv_len = offsets + S)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    off = np.array([3, 9], np.int32)
    qp = off[:, None] + np.arange(5)
    want = np.asarray(AM.attend(q, k, v, qp, np.arange(16), causal=True,
                                kv_len=off + 5))
    got = K.flash_attention(t(q), t(k), t(v), causal=True,
                            q_offsets=t(off))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # non-causal over every key (encoder and cross prefill)
    zero = np.zeros((2, 5), np.int32)
    want = np.asarray(AM.attend(q, k, v, zero, np.arange(16), causal=False))
    got = K.flash_attention(t(q), t(k), t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # cross decode: one query per row over all S_enc keys
    want = np.asarray(AM.attend(q[:, :1], k, v, zero[:, :1], np.arange(16),
                                causal=False))
    got = K.decode_attention(t(q[:, :1]), t(k), t(v),
                             torch.full((2,), 16, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def Layout_ref():
    from repro.parallel import Layout as JaxLayout
    return JaxLayout()


PROMPTS = [list(range(3, 14)), list(range(40, 60)), list(range(7, 40)),
           list(range(90, 99))]
# steps before each later submission: request 1 joins while request 0 is
# mid-prefill; requests 2 and 3 queue for a slot and reuse a freed one
STAGGER = (1, 2, 0)
NEW = 8
KW = dict(max_slots=2, s_max=64, prefill_chunk=8)


def _serve(make_engine, make_request, prompts=PROMPTS, stagger=STAGGER,
           new=NEW):
    eng = make_engine()
    reqs = [make_request(i, p, new) for i, p in enumerate(prompts)]
    eng.submit(reqs[0])
    for r, wait in zip(reqs[1:], stagger):
        for _ in range(wait):
            eng.step()
        eng.submit(r)
    for _ in range(1000):
        progressed = eng.step()
        if not progressed and not eng.queue and not eng.active:
            break
    return [list(r.generated) for r in reqs], eng


def _engines(jm, tree, cfg, threshold, **kw):
    """(the reference's engine, the port's) on one weight set."""
    params = jax.tree.map(jnp.asarray, tree)
    ref = _serve(lambda: JaxEngine(jm, jm, params, params,
                                   JaxEngineConfig(**kw),
                                   policy=JaxPolicy(threshold)),
                 lambda i, p, n: JaxRequest(i, p, max_new_tokens=n))
    port = _serve(lambda: ShiftEngine(port_model(tree, cfg),
                                      EngineConfig(**kw),
                                      policy=ThresholdPolicy(threshold)),
                  lambda i, p, n: Request(i, p, max_new_tokens=n))
    return ref, port


def test_whisper_dense_engine_matches_reference(whisper):
    cfg = get_config(WHISPER).reduced()
    (want, jeng), (got, eng) = _engines(whisper["jm"], whisper["tree"], cfg,
                                        12, **KW)
    assert got == want
    assert all(len(s) == NEW for s in got)
    assert dict(eng.config_counts) == dict(jeng.config_counts)
    assert eng.config_counts["base"] and eng.config_counts["shift"]
    assert eng.preemptions == jeng.preemptions
    assert (eng.paged, eng.mixed) == (jeng.paged, jeng.mixed) == (False,
                                                                 False)
    assert eng.paged_disabled_reason == jeng.paged_disabled_reason
    assert "non-pageable" in eng.paged_disabled_reason
    m = port_model(whisper["tree"], cfg)
    assert not m.supports_paged
    with pytest.raises(ValueError, match="cannot use a paged KV cache"):
        ShiftEngine(m, EngineConfig(paged=True))
    with pytest.raises(ValueError, match="enc_frames"):
        m.init_cache(2, 16)
        m.prefill(np.zeros((2, 4)), np.zeros(2))


def test_internvl2_frontend_embeds_match_reference():
    """Random image embeddings over the first 8 positions of a 16-token
    prefill: the logits and the decode step's tokens equal the
    reference's; without the stub they differ."""
    jm, tree = ref_model(VLM)
    fe, _ = extras(jm.cfg, np.random.default_rng(7))
    want = ref_run(jm, tree, fe, None)
    cfg = get_config(VLM).reduced()
    assert (cfg.frontend, cfg.frontend_seq, cfg.family) == ("vision_stub", 8,
                                                            "vlm")
    m = port_model(tree, cfg)
    logits, nxt, logits2, cache = port_run(m, want["toks"], fe, None)
    np.testing.assert_allclose(logits, want["logits"], rtol=3e-4, atol=3e-4)
    np.testing.assert_array_equal(nxt, want["next"])
    np.testing.assert_allclose(logits2, want["logits2"], rtol=3e-4,
                               atol=3e-4)
    ref_cache = from_jax_cache(want["cache"], cfg, paged=False)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   ref_cache[name].numpy(), rtol=3e-4,
                                   atol=3e-4, err_msg=name)
    plain = port_run(m, want["toks"], None, None)[0]
    assert np.abs(plain - logits).max() > 1e-2


def test_internvl2_engines_match_reference_on_each_path():
    """At ``frontend_seq`` 32 the serve workload's prompts lie under the
    stub: the reference's mixed engine embeds decode rows through the zero
    image embeddings and its serialized engines do not. Each of the port's
    three engines gives its reference path's streams, config counts and
    preemptions; the mixed streams differ from the serialized ones in both
    packages, which agree with each other."""
    jcfg = dataclasses.replace(jax_config(VLM).reduced(), frontend_seq=32)
    cfg = dataclasses.replace(get_config(VLM).reduced(), frontend_seq=32)
    jm, tree = ref_model(VLM, jcfg)
    out = {}
    for path, kw in (("mixed", {}), ("serial_paged", {"mixed": False}),
                     ("serial_dense", {"paged": False, "mixed": False})):
        (want, jeng), (got, eng) = _engines(jm, tree, cfg, 12, **KW, **kw)
        assert got == want, path
        assert all(len(s) == NEW for s in got), path
        assert dict(eng.config_counts) == dict(jeng.config_counts), path
        assert eng.preemptions == jeng.preemptions, path
        assert (eng.paged, eng.mixed) == (jeng.paged, jeng.mixed), path
        out[path] = got
    assert out["serial_paged"] == out["serial_dense"]
    assert out["mixed"] != out["serial_paged"]


def test_counts_and_converter(whisper):
    """``active_params`` is the reference's count, full and reduced;
    ``num_params`` adds the norms, the biases and the encoder and equals
    the modules' size. The converter unstacks the encoder and maps the
    decoder's ``cross`` and ``lnx``; the attention and cross leaves cut
    over (2, 2) and its shift config come back bitwise."""
    for arch in (WHISPER, VLM):
        full, small = get_config(arch), get_config(arch).reduced()
        assert full.active_params() == jax_config(arch).num_params()
        assert small.active_params() == jax_config(arch).reduced() \
            .num_params()
    full = get_config(WHISPER)
    d, ff = full.d_model, full.d_ff
    attn = 4 * d * d
    enc_layer = attn + 2 * d * ff + 4 * d
    assert full.num_params() - full.active_params() == \
        12 * enc_layer + 2 * d + 12 * 6 * d + 2 * d
    assert 0.27e9 < full.num_params() < 0.28e9
    assert 1.88e9 < get_config(VLM).num_params() < 1.9e9
    small = get_config(WHISPER).reduced()
    tree = whisper["tree"]
    st = from_jax_params(tree, small)
    m = port_model(tree, small)
    assert small.num_params() == sum(p.numel()
                                     for p in m.params.parameters())
    np.testing.assert_array_equal(st["encoder.1.attn.wq"],
                                  tree["encoder"]["attn"]["wq"][1])
    np.testing.assert_array_equal(st["layers.1.cross.wk"],
                                  tree["body"]["s0"]["cross"]["wk"][1])
    np.testing.assert_array_equal(st["layers.0.lnx.bias"],
                                  tree["body"]["s0"]["lnx"]["bias"][0])
    np.testing.assert_array_equal(st["enc_norm.bias"],
                                  tree["enc_norm"]["bias"])
    assert "layers.0.ffn.wg" not in st
    lay = Layout(sp=2, tp=2)
    for la in (lay, lay.to_shift()):
        shards = [shard_state(st, small, la, r) for r in range(4)]
        by_model = sorted(range(4), key=la.model_rank)
        back = unshard_state([shards[r] for r in by_model], small, la)
        for name, a in st.items():
            np.testing.assert_array_equal(back[name], a, err_msg=name)
        # the cross projections follow the self-attention's head plan
        for sh in shards:
            for w in ("wq", "wk", "wv", "wo"):
                assert sh[f"layers.0.cross.{w}"].shape == \
                    sh[f"layers.0.attn.{w}"].shape, (la, w)
    bad = dict(tree, encoder=jax.tree.map(lambda a: a[:1], tree["encoder"]))
    with pytest.raises(ValueError, match="encoder layers"):
        from_jax_params(bad, small)
