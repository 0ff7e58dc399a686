"""The port's mamba2 slice on the CPU against the reference (``repro``).

Inputs come from numpy with a seed and go through both packages at fp32
unless noted:

* the SSD chunk kernel's plain version against the Pallas kernel in
  interpret mode and its oracle, at the TPU contract's shapes and with b
  and c shared across heads through a head stride of 0;
* the rounding of the CUDA kernel's bf16 (tensor-core) instance, emulated
  here, against the Pallas kernel and the plain version;
* the chunked scan, the causal conv (bit for bit in bf16), the grouped
  RMSNorm, and one SSD layer's prefill then decode with its state carried;
* reduced mamba2's prefill and decode logits, with every norm scale and
  the SSD leaves the reference initialises to constants (A_log, dt_bias,
  D) randomised;
* the dense serialized engine's streams and config counts against the
  reference ``ShiftEngine``'s, including two requests in flight on two
  slots, where the dummy rows advance the idle slot's SSD state (a
  behaviour of the reference that the port copies);
* the engine's rules for a config that does not page.
"""
import dataclasses

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
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssd as JS  # noqa: E402
from repro.parallel import Layout as JaxLayout  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssd as TS  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402
from test_torch_model import build_pair  # noqa: E402

ARCH = "mamba2-1.3b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _chunk_inputs(N, L, hd, ds, seed=0):
    """``tests/test_kernels.py::test_ssd_chunk``'s recipe from numpy:
    x, b, c [N, L, *], dt = softplus(normal) and cum = cumsum(-dt/2)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, L, hd), dtype=np.float32)
    b = rng.standard_normal((N, L, ds), dtype=np.float32) * 0.3
    c = rng.standard_normal((N, L, ds), dtype=np.float32) * 0.3
    dt = np.log1p(np.exp(rng.standard_normal((N, L, 1), dtype=np.float32)))
    cum = np.cumsum(-dt * 0.5, axis=1, dtype=np.float32)
    return x, b, c, dt, cum


# ---------------------------------------------------------------------------
# the chunk kernel's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N,L,hd,ds", [(6, 64, 32, 16), (2, 128, 64, 32)])
def test_plain_ssd_chunk_matches_pallas(N, L, hd, ds):
    """At the TPU contract (x [N, L, hd] per head and chunk, the case B = N,
    S = L, H = 1 of the port's layout) against ``ops.ssd_chunk`` (Pallas,
    interpret mode) and ``ref.ssd_chunk_ref``, at the reference test's
    1e-4."""
    x, b, c, dt, cum = _chunk_inputs(N, L, hd, ds)
    y, st, dec = SSD.ssd_chunk_plain(_t(x)[:, :, None], _t(b)[:, :, None],
                                     _t(c)[:, :, None], _t(dt), _t(cum), L)
    got = (y[:, :, 0].numpy(), st[:, 0, 0].numpy(), dec.numpy())
    args = tuple(map(jnp.asarray, (x, b, c, dt, cum)))
    for want in (rops.ssd_chunk(*args), R.ssd_chunk_ref(*args)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,S,H,hd,ds,L", [(2, 32, 3, 16, 8, 8),
                                           (1, 20, 4, 8, 16, 20)])
def test_plain_ssd_chunk_shared_bc(B, S, H, hd, ds, L):
    """The model's layout: x [B, S, H, hd] and b, c [B, S, ds] shared by the
    heads through a head stride of 0, against the oracle over the per-(head,
    chunk) copies of the TPU contract."""
    rng = np.random.default_rng(B * S + H)
    x = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    b = rng.standard_normal((B, S, ds), dtype=np.float32) * 0.3
    c = rng.standard_normal((B, S, ds), dtype=np.float32) * 0.3
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32)))
    nc = S // L
    cum = np.cumsum((-dt * 0.7).reshape(B, nc, L, H), axis=2,
                    dtype=np.float32).reshape(B, S, H)
    bh = _t(b)[:, :, None].expand(B, S, H, ds)
    assert bh.stride(2) == 0
    y, st, dec = ops.ssd_chunk(_t(x), bh, _t(c)[:, :, None].expand(B, S, H, ds),
                               _t(dt), _t(cum), L)

    def per_head_chunk(a):      # [B, S, H, k] -> [B*nc*H, L, k]
        return a.reshape(B, nc, L, H, -1).transpose(0, 1, 3, 2, 4) \
            .reshape(B * nc * H, L, -1)

    b4 = np.broadcast_to(b[:, :, None], (B, S, H, ds))
    c4 = np.broadcast_to(c[:, :, None], (B, S, H, ds))
    wy, wst, wdec = R.ssd_chunk_ref(*(jnp.asarray(per_head_chunk(a)) for a in (
        x, b4, c4, dt[..., None], cum[..., None])))
    np.testing.assert_allclose(per_head_chunk(y.numpy()), np.asarray(wy),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.numpy().reshape(B * nc * H, hd, ds),
                               np.asarray(wst), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(per_head_chunk(dec.numpy()[..., None]),
                               np.asarray(wdec), atol=1e-5, rtol=1e-5)


def _bf16_parts(a, parts):
    """fp32 ``a`` as ``parts`` bf16 values (as fp32) whose sum is ``a`` up to
    2^-9 of the last: each part is the rest, rounded to bf16."""
    out = []
    for _ in range(parts):
        out.append(a.to(torch.bfloat16).float())
        a = a - out[-1]
    return out


def _tensor_core_chunk(x, b, c, dt, cum, parts=3):
    """The arithmetic of ``csrc/ssd_chunk.cu``'s bf16 instance at the TPU
    contract (x [N, L, hd], b, c [N, L, ds] holding bf16 values; dt, cum
    [N, L, 1]), in fp32: c·bᵀ of bf16 values (exact products); sc = c·bᵀ ·
    exp(cum_t − cum_s) · dt_s on s ≤ t and x·w, each split into ``parts``
    bf16 parts that multiply the bf16 operand separately, the products
    summed in fp32."""
    L = x.shape[1]
    tri = torch.ones((L, L), dtype=torch.bool).tril()
    cb = c @ b.transpose(1, 2)
    dec = torch.where(tri, cum - cum.transpose(1, 2), 0.0)
    sc = torch.where(tri, cb * torch.exp(dec) * dt.transpose(1, 2), 0.0)
    y = sum(p @ x for p in _bf16_parts(sc, parts))
    w = torch.exp(cum[:, -1:] - cum) * dt
    st = sum(p.transpose(1, 2) @ b for p in _bf16_parts(x * w, parts))
    return y, st


def _bf16_inputs(N, L, hd, ds, scale=1.0):
    """``_chunk_inputs`` with x, b and c times ``scale`` and rounded to
    bf16 (kept as fp32 numpy arrays)."""
    x, b, c, dt, cum = _chunk_inputs(N, L, hd, ds)
    x, b, c = (_t(a * scale).to(torch.bfloat16).float().numpy()
               for a in (x, b, c))
    return x, b, c, dt, cum


@pytest.mark.parametrize("N,L,hd,ds", [(4, 8, 16, 16), (6, 64, 32, 16),
                                       (2, 64, 64, 128)],
                         ids=["reduced", "tpu-test", "serving-head"])
def test_tensor_core_rounding_matches_pallas_and_plain(N, L, hd, ds):
    """The bf16 instance's rounding (three bf16 parts of each fp32
    operand, fp32 sums) against the Pallas kernel in interpret mode and the
    plain version on the same bf16 inputs, at 1e-4: on the reduced model's
    chunk, the reference test's shapes and one serving-width head of
    mamba2-1.3b (chunk 64, hd 64, d_state 128)."""
    x, b, c, dt, cum = _bf16_inputs(N, L, hd, ds)
    got = _tensor_core_chunk(*map(_t, (x, b, c, dt, cum)))
    y, st, _ = SSD.ssd_chunk_plain(*(_t(a)[:, :, None] for a in (x, b, c)),
                                   _t(dt), _t(cum), L)
    want = rops.ssd_chunk(*map(jnp.asarray, (x, b, c, dt, cum)))
    for g, w, p in zip(got, want, (y[:, :, 0], st[:, 0, 0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-4,
                                   rtol=1e-4)


def test_two_bf16_parts_miss_what_three_hold():
    """Why the bf16 instance splits its fp32 operands in three: with inputs
    at 8x their scale, two parts (up to 2^-18 of each operand left over)
    take y_intra past 1e-4 of the plain version, three (up to 2^-27) keep
    it."""
    x, b, c, dt, cum = _bf16_inputs(16, 8, 16, 16, scale=8.0)
    y, _, _ = SSD.ssd_chunk_plain(*(_t(a)[:, :, None] for a in (x, b, c)),
                                  _t(dt), _t(cum), 8)
    args = tuple(map(_t, (x, b, c, dt, cum)))
    two, _ = _tensor_core_chunk(*args, parts=2)
    three, _ = _tensor_core_chunk(*args, parts=3)
    assert not torch.allclose(two, y[:, :, 0], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(three, y[:, :, 0], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the scan, the conv, the grouped norm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,chunk", [(32, 8), (5, 8), (8, 8)],
                         ids=["4-chunks", "short", "one-chunk"])
def test_ssd_scan_matches_reference(S, chunk):
    """``_ssd_scan`` against the reference's (jnp, its own intra-chunk
    step), from a nonzero state, at 1e-4; the port overwrites its state
    tensor with the final state."""
    B, H, hd, ds = 2, 4, 16, 16
    rng = np.random.default_rng(S)
    xin = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    b = rng.standard_normal((B, S, ds), dtype=np.float32) * 0.5
    c = rng.standard_normal((B, S, ds), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32)))
    A = np.exp(rng.standard_normal((H,), dtype=np.float32))
    h0 = rng.standard_normal((B, H, hd, ds), dtype=np.float32)
    wy, wh = JS._ssd_scan(*map(jnp.asarray, (xin, b, c, dt, A, h0)), chunk)
    h = _t(h0.copy())
    y = TS._ssd_scan(_t(xin), _t(b), _t(c), _t(dt), _t(A), h, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_matches_reference(dtype):
    """``causal_depthwise_conv`` and ``conv_step`` against the reference's,
    run op by op as the reference's layers are: within 1e-6 in fp32, and
    bit for bit in bf16 (the taps are summed in the same order, each
    product and partial sum rounded alike; the step's reduction runs in
    fp32 on both sides and is rounded once)."""
    rng = np.random.default_rng(7)
    B, S, C, cw = 2, 9, 24, 4
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x, w, st, x1 = (rng.standard_normal(s, dtype=np.float32) for s in (
        (B, S, C), (cw, C), (B, cw - 1, C), (B, C)))

    def both(a):
        return jnp.asarray(a).astype(jd), _t(a).to(td)

    (xj, xt), (wj, wt), (sj, stt), (x1j, x1t) = map(both, (x, w, st, x1))
    got = [*TL.causal_depthwise_conv(xt, wt, stt), *TL.conv_step(x1t, wt, stt)]
    want = [*JL.causal_depthwise_conv(xj, wj, sj), *JL.conv_step(x1j, wj, sj)]
    for g, v in zip(got, want):
        assert g.dtype == td
        v = np.asarray(v.astype(jnp.float32))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(g.float().numpy(), v)
        else:
            np.testing.assert_allclose(g.numpy(), v, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_rmsnorm_matches_reference(dtype):
    """The SSD mixer's per-head norm: x [B, S, H, hd] with scale [H, hd]
    against the reference's ``rmsnorm``; fp32 within 1e-6, bf16 within one
    ulp (the reasoning of ``test_plain_rmsnorm_matches_reference_bf16``)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 8, 16), dtype=np.float32) * 3
    s = rng.standard_normal((8, 16), dtype=np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = ops.rmsnorm(_t(x).to(td), _t(s).to(td)).float().numpy()
    want = np.asarray(JL.rmsnorm({"scale": jnp.asarray(s).astype(jd)},
                                 jnp.asarray(x).astype(jd)).astype(jnp.float32))
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# one SSD layer, the model
# ---------------------------------------------------------------------------
def test_ssd_prefill_then_decode_match_reference():
    """One reduced mamba2 layer (random A_log, dt_bias, D and norm): a
    prefill of two chunks, a short prefill (S < chunk) and two decode
    steps, the state carried through all four, against the reference's
    ``ssd_prefill``/``ssd_decode``: outputs and state within 1e-4."""
    cfg_j = reduced_cfg(ARCH)
    cfg = get_config(ARCH).reduced()
    rng = np.random.default_rng(5)
    p = jax.tree.map(np.asarray, JS.ssd_init(jax.random.key(3), cfg_j,
                                             JaxLayout(), jnp.float32))
    for k in ("A_log", "dt_bias", "D", "norm"):
        p[k] = rng.standard_normal(p[k].shape).astype(np.float32)
    mod = TS.SSD(cfg, Layout(), torch.float32, "cpu")
    mod.load_state_dict({k: _t(v) for k, v in p.items()})
    B = 3
    shapes = TS.ssd_state_shapes(cfg, Layout(), B)
    state = TS.SSDState(*(torch.zeros(s) for s in shapes))
    jstate = JS.ssd_state_init(cfg_j, JaxLayout(), B, jnp.float32)
    pj = jax.tree.map(jnp.asarray, p)
    prefill = jax.jit(JS.ssd_prefill, static_argnums=(3, 4))
    decode = jax.jit(JS.ssd_decode, static_argnums=(3, 4))
    for S in (16, 5, None, None):
        shape = (B, cfg.d_model) if S is None else (B, S, cfg.d_model)
        x = rng.standard_normal(shape, dtype=np.float32)
        if S is None:
            want, jstate = decode(pj, jnp.asarray(x), jstate, cfg_j,
                                  JaxLayout())
            got = TS.ssd_decode(mod, _t(x), state, cfg)
        else:
            want, jstate = prefill(pj, jnp.asarray(x), jstate, cfg_j,
                                   JaxLayout())
            got = TS.ssd_prefill(mod, _t(x), state, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        for name in ("ssm", "conv_x", "conv_bc"):
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       np.asarray(jstate[name]), atol=1e-4,
                                       rtol=1e-4)


def test_reduced_logits_match_reference():
    """Reduced mamba2's dense ``prefill_fn``/``decode_fn`` against the
    port's ``Model.prefill``/``decode`` on the same weights: two prefill
    chunks (rows at offsets 0 and 8, and a dummy row at s_max - C) and three
    decode steps, logits within 1e-4 and greedy tokens equal."""
    jm, params, tm = build_pair(ARCH)
    pre = jax.jit(jm.prefill_fn())
    dec = jax.jit(jm.decode_fn(sample=False))
    B, s_max, C = 3, 32, 8
    cache = jm.init_cache(B, s_max)
    tm.init_cache(B, s_max)
    rng = np.random.default_rng(2)
    for offs in ([0, 0, s_max - C], [8, 8, s_max - C]):
        toks = rng.integers(1, 256, (B, C)).astype(np.int32)
        want, cache = pre(params, cache, jnp.asarray(toks),
                          jnp.asarray(np.array(offs, np.int32)))
        got, _ = tm.prefill(toks, offs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
    tok = np.argmax(np.asarray(want), -1).astype(np.int32)
    lens = np.array([16, 16, 0], np.int32)
    for _ in range(3):
        want, cache = dec(params, cache, jnp.asarray(tok), jnp.asarray(lens))
        got, _ = tm.decode(tok, lens, sample=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)
        np.testing.assert_array_equal(TL.distributed_argmax(got).numpy(), tok)
        lens = lens + (lens > 0)
    for i, name in enumerate(("ssm", "conv_x", "conv_bc")):
        np.testing.assert_allclose(
            getattr(tm.cache, name).numpy(),
            np.asarray(cache["body"]["s0"][name]), atol=1e-4, rtol=1e-4)


def test_reduced_config_and_params_match_reference():
    """The reduced config, and the tree the port's own init builds: the
    reference's abstract params convert to the same names and shapes (a
    tied tree has no LM head), with the reference's constants."""
    ref, cfg = reduced_cfg(ARCH), get_config(ARCH).reduced()
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "layer_pattern", "layer_kinds",
              "tie_embeddings", "norm_eps", "family", "source"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(ref.ssm)
    jm = build_model(ref, dtype=jnp.float32)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                         jm.abstract_params())
    want = from_jax_params(zeros, cfg)
    tm = Model(cfg, device="cpu", dtype=torch.float32)
    tm.init_params(torch.Generator().manual_seed(0))
    got = tm.params.state_dict()
    assert set(got) == set(want) and "lm_head.w" not in got
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert torch.isfinite(got[k]).all(), k
    mix = tm.params.layers[0].mix
    assert mix.A_log.dtype == mix.D.dtype == torch.float32
    assert not mix.A_log.any() and not mix.dt_bias.any()
    assert (mix.D == 1).all() and (mix.norm == 1).all()
    # the reference draws wbc as [d, 1, 2*ds]: fan-in 1, unit scale
    assert 0.8 < mix.wbc.std().item() < 1.2
    bad = dict(zeros, body={"s0": dict(zeros["body"]["s0"])})
    bad["body"]["s0"]["mix"] = dict(bad["body"]["s0"]["mix"],
                                    wbc=np.zeros((2, 64, 64), np.float32))
    with pytest.raises(ValueError, match="trivial layout"):
        from_jax_params(bad, cfg)


@pytest.mark.parametrize("name", [c.name for c in ARCHS])
def test_num_params_counts_the_modules(name):
    """``num_params`` equals the elements of the port's parameters, reduced
    and (counted on the meta device) at full width; mamba2-1.3b has about
    1.34 B."""
    for cfg in (get_config(name).reduced(), get_config(name)):
        dev = "cpu" if cfg.d_model == 64 else "meta"
        from repro_torch.models import transformer as T
        params = T.Transformer(cfg, Layout(), torch.float32, dev)
        assert cfg.num_params() == sum(p.numel() for p in params.parameters())
    if name == ARCH:
        assert 1.3e9 < get_config(name).num_params() < 1.4e9


# ---------------------------------------------------------------------------
# the dense serialized engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    jm = build_model(reduced_cfg(ARCH), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    from test_torch_model import randomize_norms
    return jm, randomize_norms(tree, np.random.default_rng(0))


def _serve(make_engine, make_request, prompts, n_new):
    eng = make_engine()
    reqs = [make_request(i, p, n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return [list(r.generated) for r in reqs], dict(eng.config_counts), eng


def _both(weights, prompts, n_new=6, **kw):
    jm, tree = weights
    params = jax.tree.map(jnp.asarray, tree)
    want = _serve(lambda: JaxEngine(jm, jm, params, params,
                                    JaxEngineConfig(**kw),
                                    policy=JaxPolicy(32)),
                  lambda i, p, n: JaxRequest(i, p, max_new_tokens=n),
                  prompts, n_new)
    cfg = get_config(ARCH).reduced()
    model = Model(cfg, device="cpu", dtype=torch.float32)
    model.load_params(from_jax_params(tree, cfg))
    got = _serve(lambda: ShiftEngine(model, EngineConfig(**kw)),
                 lambda i, p, n: Request(i, p, max_new_tokens=n),
                 prompts, n_new)
    return got, want


A_PROMPT, B_PROMPT = list(range(3, 14)), list(range(40, 60))


@pytest.mark.parametrize("slots,prompts,chunk", [
    (1, [A_PROMPT], 8),
    (2, [A_PROMPT, B_PROMPT], 8),
    (2, [list(range(1, 10 + 3 * i)) for i in range(5)], 8),
    (2, [A_PROMPT, B_PROMPT, list(range(7, 40))], 16),
], ids=["one-slot", "two-in-flight", "more-than-slots", "chunk-16"])
def test_dense_engine_matches_reference(weights, slots, prompts, chunk):
    """Greedy streams and config counts equal to the reference engine's on
    the dense fallback (s_max 64). Two requests in flight on two slots
    give A another stream than A alone: each serialized step runs every
    slot, and a slot outside the step is a dummy row whose zero tokens
    advance its SSD state (the reference's behaviour, copied). Chunk 16
    runs two SSD chunks of 8 inside each prefill step."""
    kw = dict(max_slots=slots, s_max=64, prefill_chunk=chunk)
    (got, counts, eng), (want, want_counts, jeng) = _both(weights, prompts,
                                                          **kw)
    assert got == want
    assert counts == want_counts
    assert not eng.paged and not jeng.paged
    if len(prompts) == 2:
        (alone, _, _), _ = _both(weights, [A_PROMPT], **kw)
        assert alone[0] != got[0]


def test_engine_rules_for_a_config_that_does_not_page(weights):
    """Auto falls back to the dense cache with the reference's reason;
    ``paged=True`` raises; ``mixed=True`` raises (it needs the pool); the
    model refuses the paged pool and the mixed step."""
    jm, tree = weights
    params = jax.tree.map(jnp.asarray, tree)
    jeng = JaxEngine(jm, jm, params, params, JaxEngineConfig())
    model = Model(get_config(ARCH).reduced(), device="cpu",
                  dtype=torch.float32)
    eng = ShiftEngine(model, EngineConfig())
    assert not eng.paged and not eng.mixed and eng.kv is None
    assert eng.paged_disabled_reason == jeng.paged_disabled_reason
    assert "non-pageable" in eng.paged_disabled_reason
    with pytest.raises(ValueError, match="cannot use a paged KV cache"):
        ShiftEngine(model, EngineConfig(paged=True))
    with pytest.raises(ValueError, match="paged"):
        ShiftEngine(model, EngineConfig(mixed=True))
    with pytest.raises(ValueError, match="page"):
        model.init_paged_cache(9, 8)
    with pytest.raises(ValueError, match="page"):
        model.forward_mixed(np.zeros((1, 4)), [4], [0], np.zeros((1, 2)))
    cache = eng.base.cache
    assert cache.k is None and cache.ssm.dtype == torch.float32
    assert tuple(cache.ssm.shape) == (2, 8, 8, 16, 16)
