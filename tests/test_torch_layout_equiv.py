"""The reference's core correctness property on the port
(``tests/test_equivalence.py``): one logical model gives the same outputs
on a single device, as base (SP×TP) and shift (pure TP) on (2, 2, 2), and
as base on (1, 4, 2), and the base and shift caches agree as global
arrays.

One eight-rank job (``launch.mesh.run_ranks`` over gloo, a module-scoped
fixture) runs the three layouts for qwen3-8b, qwen2-1.5b and mamba2-1.3b
(reduced, fp32): the reference's ``_run`` inputs (tokens of
``jax.random.key(1)``, B 8, S 16, a dense cache of 8 x 32) go through the
port's ``prefill_step`` and ``decode_step`` on the dense cache, every rank
its shard of the reference's ``init_params(key(0))`` (``shard_state``).
The tests hold, for every layout:

* the prefill logits, put together from the ranks' rows and vocabulary
  columns, within 3e-4 of the reference's single-device run, and equal
  next tokens;
* the ranks' dense caches, put together (``convert.gather_dense_cache``),
  equal to the reference's global cache within 3e-4, and the base cache
  equal to the shift cache on (2, 2, 2). The reference's global cache of
  a layout is its single-device cache with each kv head in the slots its
  head plan replicates it to (``_placed``); for two cases (qwen3-8b base
  on (1, 4, 2), every kv head in four slots, and mamba2-1.3b shift on
  (2, 2, 2)) the reference's own run on the mesh is the comparison, and
  it also holds ``_placed`` to that run. Running it for every case would
  cost ~10 s of tracing each;
* on every rank, the base and shift models' dense-cache invariance
  (``core.invariance.verify_dense_invariance``): one set of tensors, the
  same KV slots and SSD heads;
* SSD heads that the model group does not divide: reduced mamba2-1.3b
  with 4 heads on base (1, 4, 2), padded to 8, against the reference's
  single-device run of the same config.

JAX is imported only in this process, inside fixtures and tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (from_jax_params, gather_dense_cache,  # noqa: E402
                                 shard_state)
from repro_torch.core import invariance as INV  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import Groups, Layout  # noqa: E402

ARCHS = ("qwen3-8b", "qwen2-1.5b", "mamba2-1.3b")
CONFIGS = (("base", (2, 2, 2)), ("shift", (2, 2, 2)), ("base", (1, 4, 2)))
B, S, S_MAX = 8, 16, 32
# reduced mamba2-1.3b with SSD heads of 32 wide: 4 heads, which the model
# group of 8 on (1, 4, 2) pads to 8, so model ranks 4-7 hold pad heads only
PAD_HEAD_DIM = 32
PADDED = ("mamba2-pad", "base", (1, 4, 2))


def _pad_cfg(cfg):
    """``cfg`` (the port's or the reference's) with 4 SSD heads."""
    import dataclasses
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, head_dim=PAD_HEAD_DIM))


# ---------------------------------------------------------------------------
# the port's side: one job on eight ranks
# ---------------------------------------------------------------------------
def _run(rank, groups, cfg, state, toks, mode, shape):
    dp, sp, tp = shape
    lay = Layout(dp=dp, sp=sp, tp=tp)
    m = Model(cfg, device="cpu", dtype=torch.float32,
              lay=lay.to_shift() if mode == "shift" else lay, groups=groups)
    m.load_params(shard_state(state, cfg, m.lay, rank))
    m.init_cache(B, S_MAX)
    logits = m.prefill_step(torch.as_tensor(toks),
                            torch.zeros((B,), dtype=torch.int32))
    nxt = m.decode_step(torch.arange(B, dtype=torch.int32) % cfg.vocab_size,
                        torch.full((B,), S, dtype=torch.int32))
    cache = {name: t.numpy().copy() for name, t in m.cache.tensors().items()}
    return {"logits": logits.numpy(), "next": nxt.numpy(), "cache": cache,
            "tp_rank": m.shard.tp_rank, "dp_rank": m.shard.dp_rank}


def _invariance(rank, groups, cfg):
    """A base and a shift model of (2, 2, 2), the shift one adopting the
    base one's dense cache, as an engine's views do."""
    lay = Layout(dp=2, sp=2, tp=2)
    base, shift = (Model(cfg, device="cpu", dtype=torch.float32, lay=la,
                         groups=groups) for la in (lay, lay.to_shift()))
    base.init_cache(B, S_MAX)
    shift.adopt_cache(base)
    own = Model(cfg, device="cpu", dtype=torch.float32, lay=lay.to_shift(),
                groups=groups)
    own.init_cache(B, S_MAX)
    return {"holds": INV.verify_dense_invariance(base, shift, rank),
            "own_cache_fails": not INV.verify_dense_invariance(base, own,
                                                               rank),
            "slots": (list(INV.kv_slots(base, rank)),
                      list(INV.ssd_heads(base, rank)))}


def _job(rank, groups, inputs):
    grids = {(2, 2, 2): groups, (1, 4, 2): Groups(4, 2)}
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        state, toks = inputs[arch]["state"], inputs[arch]["toks"]
        for mode, shape in CONFIGS:
            out[(arch, mode, shape)] = _run(rank, grids[shape], cfg, state,
                                            toks, mode, shape)
        out[(arch, "invariance")] = _invariance(rank, groups, cfg)
    arch, mode, shape = PADDED
    out[PADDED] = _run(rank, grids[shape], _pad_cfg(
        get_config("mamba2-1.3b").reduced()), inputs[arch]["state"],
        inputs[arch]["toks"], mode, shape)
    return out


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
def _ref_run(cfg, mesh_shape, mode):
    """``tests/test_equivalence.py``'s ``_run``: the serialized prefill and
    decode on the dense cache, of one layout."""
    import jax
    import jax.numpy as jnp
    from conftest import make_mesh
    from repro.models import build_model
    from repro.models.model import Model as JaxModel
    from repro.parallel import Layout as JaxLayout
    if mesh_shape is None:
        m = build_model(cfg, dtype=jnp.float32)
    else:
        mesh = make_mesh(mesh_shape)
        lay = JaxLayout.from_mesh(mesh, dp=("data",), sp=("sp",), tp=("tp",))
        if mode == "shift":
            lay = lay.to_shift()
        m = JaxModel(cfg=cfg, lay=lay, mesh=mesh, dtype=jnp.float32)
    params = m.init_params(jax.random.key(0))
    toks = jax.random.randint(jax.random.key(1), (B, S), 0, cfg.vocab_size)
    cache = m.init_cache(B, S_MAX)
    logits, cache = m.prefill_fn()(params, cache, toks,
                                   jnp.zeros((B,), jnp.int32))
    nxt, cache = m.decode_fn()(params, cache,
                               jnp.arange(B, dtype=jnp.int32) % cfg.vocab_size,
                               jnp.full((B,), S, jnp.int32))
    body = jax.tree.map(np.asarray, cache)["body"]["s0"]
    return {"logits": np.asarray(logits), "next": np.asarray(nxt),
            "cache": body, "params": params, "toks": np.asarray(toks)}


# the layouts whose reference run on the mesh is compared directly
MESH_RUNS = (("qwen3-8b", "base", (1, 4, 2)),
             ("mamba2-1.3b", "shift", (2, 2, 2)))


@pytest.fixture(scope="module")
def reference():
    """Every arch's single-device run, and the ``MESH_RUNS``."""
    import jax
    from conftest import reduced_cfg
    out = {}
    for arch in ARCHS:
        single = _ref_run(reduced_cfg(arch), None, "single")
        out[arch] = {"single": single, "state": from_jax_params(
            jax.tree.map(np.asarray, single.pop("params")),
            get_config(arch).reduced())}
    for arch, mode, shape in MESH_RUNS:
        run = _ref_run(reduced_cfg(arch), shape, mode)
        run.pop("params")
        out[arch][(mode, shape)] = run
    single = _ref_run(_pad_cfg(reduced_cfg("mamba2-1.3b")), None, "single")
    out[PADDED[0]] = {"single": single, "state": from_jax_params(
        jax.tree.map(np.asarray, single.pop("params")),
        _pad_cfg(get_config("mamba2-1.3b").reduced()))}
    return out


@pytest.fixture(scope="module")
def ranks(reference):
    inputs = {arch: {"state": reference[arch]["state"],
                     "toks": reference[arch]["single"]["toks"]}
              for arch in ARCHS + PADDED[:1]}
    return mesh.run_ranks(_job, 2, 2, dp=2, device="cpu", backend="gloo",
                          timeout_s=150, args=(inputs,))


def _logits(ranks, key):
    """The global [B, G·v_blk] logits from the ranks' [B/dp, v_blk] parts,
    rows by dp rank and columns by tp rank; ranks holding one part must
    agree bitwise."""
    parts = {}
    for res in ranks:
        r = res[key]
        at = (r["dp_rank"], r["tp_rank"])
        if at in parts:
            np.testing.assert_array_equal(parts[at], r["logits"])
        parts[at] = r["logits"]
    dp = 1 + max(d for d, _ in parts)
    tp = 1 + max(t for _, t in parts)
    return np.concatenate([np.concatenate([parts[(d, t)] for t in range(tp)],
                                          axis=-1) for d in range(dp)])


def _lay(mode, shape):
    lay = Layout(dp=shape[0], sp=shape[1], tp=shape[2])
    return lay.to_shift() if mode == "shift" else lay


def _placed(cache, cfg, lay):
    """The reference's global dense cache on ``lay`` from its trivial-layout
    one: kv slot ``s`` of the plan's ``kv_slots_total`` holds padded kv
    head ``s * h_kv_pad // kv_slots_total`` (``HeadPlan.a2a_send_map``'s
    rule), a pad head zeros; SSD heads take the plan's padded slots (pad
    heads zeros)."""
    from repro_torch.models.attention import get_plan
    from repro_torch.models.ssd import ssd_plan
    out = dict(cache)
    if "k" in cache:
        plan = get_plan(cfg, lay)
        n = plan.kv_slots_total
        orig = [plan.kv_slot_to_orig[s * plan.h_kv_pad // n]
                for s in range(n)]
        for name in ("k", "v"):
            a = cache[name]
            out[name] = np.stack([a[:, :, :, o] if o >= 0 else
                                  np.zeros_like(a[:, :, :, 0])
                                  for o in orig], axis=3)
    if "ssm" in cache:
        pad = ssd_plan(cfg, lay).h_q_pad - ssd_plan(cfg, lay).h_q
        hd = cfg.ssm.head_dim
        out["ssm"] = np.pad(cache["ssm"], [(0, 0)] * 2 + [(0, pad)]
                            + [(0, 0)] * 2)
        out["conv_x"] = np.pad(cache["conv_x"], [(0, 0)] * 3
                               + [(0, pad * hd)])
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,shape", CONFIGS,
                         ids=["base-222", "shift-222", "base-142"])
def test_logits_and_tokens_match_single_device(ranks, reference, arch, mode,
                                               shape):
    key = (arch, mode, shape)
    want = reference[arch]["single"]
    got = _logits(ranks, key)
    V = want["logits"].shape[-1]
    assert got.shape[0] == B and got.shape[1] >= V
    np.testing.assert_allclose(got[:, :V], want["logits"], rtol=3e-4,
                               atol=3e-4, err_msg=f"{key} logits")
    assert np.abs(want["logits"]).max() > 0.1
    for res in ranks:
        np.testing.assert_array_equal(res[key]["next"], want["next"],
                                      err_msg=f"{key} tokens")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,shape", CONFIGS,
                         ids=["base-222", "shift-222", "base-142"])
def test_gathered_cache_matches_reference(ranks, reference, arch, mode,
                                          shape):
    key = (arch, mode, shape)
    cfg = get_config(arch).reduced()
    got = gather_dense_cache([res[key]["cache"] for res in ranks], cfg,
                             _lay(mode, shape))
    want = _placed(reference[arch]["single"]["cache"], cfg, _lay(mode, shape))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, (key, name)
        np.testing.assert_allclose(got[name], w, rtol=3e-4, atol=3e-4,
                                   err_msg=f"{key} cache {name}")
        assert np.abs(w).max() > 0, name     # the steps wrote it


@pytest.mark.parametrize("arch,mode,shape", MESH_RUNS,
                         ids=["qwen3-8b-base-142", "mamba2-1.3b-shift-222"])
def test_gathered_cache_matches_reference_mesh_run(ranks, reference, arch,
                                                   mode, shape):
    """The reference's own run on the mesh: its global cache equals the
    port's gathered one, and ``_placed`` of its single-device cache."""
    key = (arch, mode, shape)
    cfg = get_config(arch).reduced()
    lay = _lay(mode, shape)
    got = gather_dense_cache([res[key]["cache"] for res in ranks], cfg, lay)
    run = reference[arch][(mode, shape)]
    placed = _placed(reference[arch]["single"]["cache"], cfg, lay)
    np.testing.assert_array_equal(run["next"],
                                  reference[arch]["single"]["next"])
    assert set(got) == set(run["cache"])
    for name, w in run["cache"].items():
        np.testing.assert_allclose(got[name], w, rtol=3e-4, atol=3e-4,
                                   err_msg=f"{key} cache {name}")
        np.testing.assert_allclose(placed[name], w, rtol=3e-4, atol=3e-4,
                                   err_msg=f"{key} placed {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_base_cache_equals_shift_cache(ranks, arch):
    """Numerical cache invariance: base and shift on (2, 2, 2) leave the
    same global cache, as the reference's test demands of its own."""
    cfg = get_config(arch).reduced()
    shape = (2, 2, 2)
    a, b = (gather_dense_cache(
        [res[(arch, mode, shape)]["cache"] for res in ranks], cfg,
        _lay(mode, shape)) for mode in ("base", "shift"))
    for name in a:
        np.testing.assert_allclose(a[name], b[name], rtol=3e-4, atol=3e-4,
                                   err_msg=f"{arch} {name}")
    # and the rank's own shard of it is the same tensor in both configs
    for res in ranks:
        for name, t in res[(arch, "base", shape)]["cache"].items():
            np.testing.assert_allclose(
                t, res[(arch, "shift", shape)]["cache"][name], rtol=3e-4,
                atol=3e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_invariance_on_every_rank(ranks, arch):
    order = INV.head_order_base(2, 2)
    cfg = get_config(arch).reduced()
    for r, res in enumerate(ranks):
        inv = res[(arch, "invariance")]
        assert inv["holds"] and inv["own_cache_fails"], f"rank {r}"
        slots, heads = inv["slots"]
        owner = r % 4                  # the rank's position in its row
        if cfg.ssm is None:
            assert heads == []
            assert [order[s] for s in slots] == [owner]
        else:
            # 8 SSD heads over a model group of 4: two heads per rank, in
            # the paper's head order
            assert [order[h // 2] for h in heads] == [owner, owner]


def test_padded_ssd_heads_match_single_device(ranks, reference):
    """SSD heads that the model group does not divide: 4 heads on (1, 4,
    2), padded to 8. The port's pad heads are zeros (the reference's init
    draws them at random, so the reference's padded model is another
    function: ROADMAP Queue 3); a zero head adds nothing, so logits, next
    tokens and the gathered cache equal the reference's single-device
    run's, the pad heads' state zero."""
    from repro_torch.models.ssd import ssd_plan
    arch, mode, shape = PADDED
    cfg = _pad_cfg(get_config("mamba2-1.3b").reduced())
    lay = _lay(mode, shape)
    plan = ssd_plan(cfg, lay)
    assert (plan.h_q, plan.h_q_pad, plan.G) == (4, 8, 8)
    want = reference[arch]["single"]
    V = want["logits"].shape[-1]
    np.testing.assert_allclose(_logits(ranks, PADDED)[:, :V],
                               want["logits"], rtol=3e-4, atol=3e-4)
    assert np.abs(want["logits"]).max() > 0.1
    for res in ranks:
        np.testing.assert_array_equal(res[PADDED]["next"], want["next"])
    got = gather_dense_cache([res[PADDED]["cache"] for res in ranks], cfg,
                             lay)
    placed = _placed(want["cache"], cfg, lay)
    assert set(got) == set(placed)
    for name, w in placed.items():
        np.testing.assert_allclose(got[name], w, rtol=3e-4, atol=3e-4,
                                   err_msg=f"padded cache {name}")
    # model ranks 4-7 hold one pad head each: its state stays zero
    assert not got["ssm"][:, :, 4:].any() and got["ssm"][:, :, :4].any()


def test_layouts_really_shard(ranks):
    """Each layout cut the batch, the heads and the vocabulary: a rank of
    (2, 2, 2) holds 4 of the 8 cache rows and one kv slot of eight."""
    key = ("qwen3-8b", "base", (2, 2, 2))
    k = ranks[0][key]["cache"]["k"]
    assert k.shape[1:] == (4, S_MAX, 1, 16)
    assert ranks[0][key]["logits"].shape == (4, 128)
    assert ranks[0][("mamba2-1.3b", "base", (1, 4, 2))]["cache"]["ssm"] \
        .shape[1:3] == (8, 1)
