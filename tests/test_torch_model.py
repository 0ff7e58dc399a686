"""The port's model on the CPU against the reference's (``repro.models``).

Both packages build the reduced config at fp32 on the trivial layout; the
reference's parameters, with every norm scale replaced by random values
(the reference initialises them to ones, which would hide a wrong scale),
go through ``convert.from_jax_params`` into the port. Then both run the
same mixed paged steps: a prefill row, a decode row, a padding row and a
chunk whose padding overhangs the block table; and the same serialized
prefill and decode steps on the dense contiguous cache and on the paged
pool.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.parallel import Layout  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ARCHS = ["qwen3-8b", "qwen2-7b", "qwen2-1.5b", "internlm2-1.8b"]
# norm scales, and the SSD mixer's per-head leaves that the reference
# initialises to constants (dt_bias 0, A_log 0, D 1, norm ones), which would
# hide a sign or scale error
NORM_LEAVES = ("scale", "q_norm", "k_norm", "norm", "A_log", "dt_bias", "D")


def randomize_norms(tree, rng):
    """Replace every norm scale leaf and every constant-initialised SSD
    leaf of a numpy param tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize_norms(v, rng)
        elif k in NORM_LEAVES:
            out[k] = rng.standard_normal(v.shape).astype(v.dtype)
        else:
            out[k] = v
    return out


def build_pair(name, seed=0):
    """(reference model, its params with random norms, the port's model on
    the CPU holding the same weights)."""
    cfg_t = get_config(name).reduced()
    jm = build_model(reduced_cfg(name), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed)))
    tree = randomize_norms(tree, np.random.default_rng(seed))
    tm = Model(cfg_t, device="cpu", dtype=torch.float32)
    tm.load_params(from_jax_params(tree, cfg_t))
    return jm, jax.tree.map(jnp.asarray, tree), tm


@pytest.mark.parametrize("name", ARCHS)
def test_reduced_config_matches_reference(name):
    ref = reduced_cfg(name)
    cfg = get_config(name).reduced()
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "qk_norm", "qkv_bias", "rope_theta",
              "logits_soft_cap", "norm_eps"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert ref.act == "silu" and ref.norm == "rmsnorm"
    assert ref.layer_kinds == ("attn",) * ref.num_layers


# two steps over a 9-block pool with bs 4 and a 3-block table (12
# positions); C = 8 columns. Row 0: prefill 8, then decode at 8. Row 1:
# prefill 6, then 4 tokens at 6 whose padding columns 10..13 overhang the
# table. Row 2: padding throughout. Row 3: padding, then a fresh prefill.
BS, NB = 4, 9
BT = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0], [7, 8, 0]], np.int32)
STEPS = [  # (q_lens, offsets)
    ([8, 6, 0, 0], [0, 0, 0, 0]),
    ([1, 4, 0, 5], [8, 6, 0, 0]),
]


@pytest.mark.parametrize("name", ARCHS)
def test_mixed_step_matches_reference(name):
    """Logits at fp32 within 1e-4, greedy tokens equal, and the pools'
    live blocks within 1e-4 after each step (K and V are matrix products
    summed in another order)."""
    jm, params, tm = build_pair(name)
    fwd_logits = jax.jit(jm.forward_fn(paged=True, sample=False))
    fwd_tokens = jax.jit(jm.forward_fn(paged=True, sample=True))
    pool = jm.init_paged_cache(NB, BS)
    tm.init_paged_cache(NB, BS)
    rng = np.random.default_rng(1)
    for ql, off in STEPS:
        ql, off = np.array(ql, np.int32), np.array(off, np.int32)
        toks = rng.integers(1, 256, (4, 8)).astype(np.int32)
        args = (toks, ql, off, BT)
        want, new_pool = fwd_logits(params, pool, *map(jnp.asarray, args))
        want_tok, _ = fwd_tokens(params, pool, *map(jnp.asarray, args))
        pool = new_pool
        got, _ = tm.forward_mixed(*args, sample=False)
        got_tok, tpool = tm.forward_mixed(*args)     # rewrites the same KV
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
        assert not got[2].any()                      # padding row: zeros
        for side, jp in (("k", tpool.k), ("v", tpool.v)):
            np.testing.assert_allclose(
                jp[:, 1:].numpy(), np.asarray(pool["body"]["s0"][side])[:, 1:],
                atol=1e-4, rtol=1e-4)


# serialized steps at s_max 32 (bs 8, nmax 4) with chunk C = 8. Rows 0 and
# 1 prefill two chunks, row 2 one chunk and then sits out, row 3 sits out
# throughout (dummy rows: offset s_max - C on the dense cache, 0 with an
# all-null table on the paged pool); then three decode steps, row 3
# inactive (token 0 at lens 0, an all-null table).
S_MAX, C, SBS = 32, 8, 8
SER_BT = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [0, 0, 0, 0]],
                  np.int32)
SER_PREFILL = [([0, 0, 0, None], [0, 1, 2]), ([8, 8, None, None], [0, 1])]
SER_LENS = [16, 16, 8, 0]


def _serialized_steps(paged):
    """(tokens, offsets, block tables) of each prefill step, then the
    decode lens and block tables, for the dense or the paged cache."""
    rng = np.random.default_rng(2)
    dummy = 0 if paged else S_MAX - C
    steps = []
    for offs, live in SER_PREFILL:
        toks = rng.integers(1, 256, (4, C)).astype(np.int32)
        off = np.array([dummy if o is None else o for o in offs], np.int32)
        bt = np.zeros_like(SER_BT)
        bt[live] = SER_BT[live]
        steps.append((toks, off, bt if paged else None))
    dec_bt = SER_BT.copy() if paged else None
    return steps, dec_bt


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("name", ARCHS)
def test_serialized_steps_match_reference(name, paged):
    """``Model.prefill``/``decode`` against the reference's ``prefill_fn``/
    ``decode_fn`` (``paged=True`` for the pool): last-column prefill logits
    and decode logits at fp32 within 1e-4, and the greedy tokens of three
    decode steps equal."""
    jm, params, tm = build_pair(name)
    pre = jax.jit(jm.prefill_fn(paged=paged))
    dec = jax.jit(jm.decode_fn(sample=False, paged=paged))
    if paged:
        cache = jm.init_paged_cache(4 * (S_MAX // SBS) + 1, SBS)
        tm.init_paged_cache(4 * (S_MAX // SBS) + 1, SBS)
    else:
        cache = jm.init_cache(4, S_MAX)
        tm.init_cache(4, S_MAX)
    steps, dec_bt = _serialized_steps(paged)
    for toks, off, bt in steps:
        extra = (jnp.asarray(bt),) if paged else ()
        want, cache = pre(params, cache, jnp.asarray(toks), jnp.asarray(off),
                          *extra)
        got, _ = tm.prefill(toks, off, block_tables=bt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
    tok = np.array([5, 6, 7, 0], np.int32)
    lens = np.array(SER_LENS, np.int32)
    for _ in range(3):
        extra = (jnp.asarray(dec_bt),) if paged else ()
        want, cache = dec(params, cache, jnp.asarray(tok), jnp.asarray(lens),
                          *extra)
        got, _ = tm.decode(tok, lens, block_tables=dec_bt, sample=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        want_tok = np.argmax(np.asarray(want), -1).astype(np.int32)
        np.testing.assert_array_equal(TL.distributed_argmax(got).numpy(),
                                      want_tok)
        tok = want_tok * (lens > 0)
        lens = lens + (lens > 0)


def test_dense_matches_paged():
    """The port's dense cache against its paged pool on reduced qwen3-8b
    (the reference's ``test_paged_model_matches_dense_single_device``):
    prefill logits within 1e-5, then three decode steps with equal greedy
    tokens."""
    _, _, tm = build_pair("qwen3-8b")
    B, bs, nmax = 4, 8, 8
    tm.init_cache(B, bs * nmax)
    tm.init_paged_cache(B * nmax + 1, bs)
    bt = 1 + np.arange(B * nmax, dtype=np.int32).reshape(B, nmax)
    toks = np.random.default_rng(1).integers(0, 256, (B, 16)).astype(np.int32)
    offs = np.zeros((B,), np.int32)
    ld, _ = tm.prefill(toks, offs)
    lp, _ = tm.prefill(toks, offs, block_tables=bt)
    np.testing.assert_allclose(ld.numpy(), lp.numpy(), atol=1e-5)
    t = TL.distributed_argmax(ld).int().numpy()
    lens = np.full((B,), 16, np.int32)
    for _ in range(3):
        nd, _ = tm.decode(t, lens)
        np_, _ = tm.decode(t, lens, block_tables=bt)
        np.testing.assert_array_equal(nd.numpy(), np_.numpy())
        t, lens = nd.int().numpy(), lens + 1


def test_dense_attention_refuses_what_is_not_ported():
    """Windows, rope-free layers and logit soft caps raise on the dense
    path instead of computing something else."""
    from repro_torch.models import attention as TA
    cfg = get_config("qwen3-8b").reduced()
    tm = Model(cfg, device="cpu", dtype=torch.float32)
    tm.init_params(torch.Generator().manual_seed(0))
    tm.init_cache(1, 8)
    p = tm.params.layers[0].attn
    x = torch.zeros((1, 2, cfg.d_model))
    off = torch.zeros((1,), dtype=torch.int32)
    for kw in ({"window": 4}, {"rope": False}):
        with pytest.raises(NotImplementedError):
            TA.attn_prefill(p, x, tm.cache.k[0], tm.cache.v[0], off, cfg, **kw)
        with pytest.raises(NotImplementedError):
            TA.attn_decode(p, x[:, 0], tm.cache.k[0], tm.cache.v[0], off,
                           cfg, **kw)
    import dataclasses
    capped = dataclasses.replace(cfg, logits_soft_cap=30.0)
    with pytest.raises(NotImplementedError):
        TA.attn_prefill(p, x, tm.cache.k[0], tm.cache.v[0], off, capped)


@pytest.mark.parametrize("name", ARCHS)
def test_param_shapes_match_reference(name):
    """The port's own init (torch.Generator) gives the tree the reference's
    abstract params convert to: same names, same shapes."""
    cfg = get_config(name).reduced()
    jm = build_model(reduced_cfg(name), dtype=jnp.float32)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                         jm.abstract_params())
    want = from_jax_params(zeros, cfg)
    tm = Model(cfg, device="cpu", dtype=torch.float32)
    tm.init_params(torch.Generator().manual_seed(0))
    got = tm.params.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert torch.isfinite(got[k]).all(), k
    # the reference's scales: 0.02 for the embedding, ones for norms
    assert abs(got["embed.table"].std().item() - 0.02) < 0.002
    assert (got["final_norm.scale"] == 1).all()


def test_layers_match_reference():
    """RoPE, SwiGLU, embedding (ids outside the table give zeros), the LM
    head and greedy argmax (ties go to the first index) at fp32."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=1e-5, rtol=1e-5)

    d, ff, V = 8, 12, 10
    w = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in (("wi", (d, ff)), ("wg", (d, ff)), ("wo", (ff, d)))}
    mlp = TL.MLP(d, ff, torch.float32, "cpu")
    for k, v in w.items():
        getattr(mlp, k).data.copy_(torch.from_numpy(v))
    h = rng.standard_normal((4, d)).astype(np.float32)
    np.testing.assert_allclose(
        TL.mlp_apply(mlp, torch.from_numpy(h)).numpy(),
        np.asarray(JL.mlp_apply({k: jnp.asarray(v) for k, v in w.items()},
                                jnp.asarray(h), "silu", Layout())),
        atol=1e-5, rtol=1e-5)

    table = rng.standard_normal((V, d)).astype(np.float32)
    emb = TL.Embedding(V, d, torch.float32, "cpu")
    emb.table.data.copy_(torch.from_numpy(table))
    ids = np.array([[0, 3, V - 1, V, -1]], np.int32)
    got = TL.embed_apply(emb, torch.from_numpy(ids)).numpy()
    want = JL.embed_apply({"table": jnp.asarray(table)[None]},
                          jnp.asarray(ids), Layout())
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not got[0, 3:].any()

    logits = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]], np.float32)
    np.testing.assert_array_equal(
        TL.distributed_argmax(torch.from_numpy(logits)).numpy(),
        np.asarray(JL.distributed_argmax(jnp.asarray(logits), Layout())))
    assert TL.distributed_argmax(torch.from_numpy(logits)).tolist() == [1, 0]
