"""recurrentgemma-9b on the layouts: the reference's core correctness
property (``tests/test_equivalence.py``) on the port, and the serialized
dense engine on an SPMD grid.

One eight-rank job (``launch.mesh.run_ranks`` over gloo, a module-scoped
fixture) runs reduced recurrentgemma-9b in fp32 (4 query heads and one KV
head, so that (1, 4, 2) pads the query heads to 8 and replicates the KV
head 8 times; an LRU width of 64 in 16 channel blocks, 2 per model rank
there) on base and shift (2, 2, 2) and base (1, 4, 2): the reference's
``_run`` inputs (B 8, S 16, a dense cache of 32 rows, the local layer's
ring of 8 wrapping on the decode step) through ``prefill_step`` and
``decode_step``, every rank its shard (``shard_state``) of the
reference's ``init_params(key(0))`` with random norm scales. The tests
hold, for every layout and against the reference's single-device run only:

* the prefill logits, put together from the ranks' rows and vocabulary
  columns, within 3e-4, and equal next tokens on every rank;
* the ranks' dense caches put together (``convert.gather_dense_cache``:
  the ring's K/V by kv slot, the RG-LRU state by channel, in model-rank
  order) within 3e-4 of the single-device cache placed by the head plan,
  and the base cache equal to the shift cache on (2, 2, 2);
* on every rank, the base and shift models' dense-cache invariance
  (``core.invariance.verify_dense_invariance``): one set of tensors, the
  same KV slots and the same RG-LRU channels;
* the serialized dense engine on (1, 4, 2), its base and shift models
  over one cache (threshold 8, so both configs step), with more requests
  than slots: every rank's streams, config counts and preemptions equal
  the one-rank engine's on the same weights.

JAX is imported only in this process, inside fixtures.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (from_jax_params, gather_dense_cache,  # noqa: E402
                                 shard_state)
from repro_torch.core import invariance as INV  # noqa: E402
from repro_torch.core.policy import ThresholdPolicy  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import Groups, Layout  # noqa: E402

ARCH = "recurrentgemma-9b"
CONFIGS = (("base", (2, 2, 2)), ("shift", (2, 2, 2)), ("base", (1, 4, 2)))
B, S, S_MAX = 8, 16, 32
THRESHOLD = 8
ENGINE_KW = dict(max_slots=4, s_max=64, prefill_chunk=8, paged=False,
                 mixed=False)
PROMPTS = [list(range(3 + 5 * i, 3 + 5 * i + n))
           for i, n in enumerate((11, 19, 14, 23, 9, 17))]
NEW = 10


def _cfg():
    return get_config(ARCH).reduced()


def _lay(mode, shape):
    lay = Layout(dp=shape[0], sp=shape[1], tp=shape[2])
    return lay.to_shift() if mode == "shift" else lay


def _models(cfg, state, lay, groups):
    """This rank's base model on ``lay`` and shift model on its
    ``to_shift()``."""
    out = []
    for la in (lay, lay.to_shift()):
        m = Model(cfg, device="cpu", dtype=torch.float32, lay=la,
                  groups=groups)
        m.load_params(shard_state(state, cfg, la, groups.rank))
        out.append(m)
    return out


def _serve(base, shift=None):
    eng = ShiftEngine(base, EngineConfig(threshold=THRESHOLD, **ENGINE_KW),
                      shift=shift, policy=ThresholdPolicy(THRESHOLD))
    reqs = [Request(i, p, max_new_tokens=NEW) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return {"streams": [list(r.generated) for r in reqs],
            "counts": dict(eng.config_counts), "preempt": eng.preemptions,
            "paged": (eng.paged, eng.mixed)}


# ---------------------------------------------------------------------------
# the port's side: one job on eight ranks
# ---------------------------------------------------------------------------
def _run(rank, groups, cfg, state, toks, mode, shape):
    m = Model(cfg, device="cpu", dtype=torch.float32, lay=_lay(mode, shape),
              groups=groups)
    m.load_params(shard_state(state, cfg, m.lay, rank))
    m.init_cache(B, S_MAX)
    logits = m.prefill_step(torch.as_tensor(toks),
                            torch.zeros((B,), dtype=torch.int32))
    nxt = m.decode_step(torch.arange(B, dtype=torch.int32) % cfg.vocab_size,
                        torch.full((B,), S, dtype=torch.int32))
    cache = {name: t.numpy().copy() for name, t in m.cache.tensors().items()}
    return {"logits": logits.numpy(), "next": nxt.numpy(), "cache": cache,
            "tp_rank": m.shard.tp_rank, "dp_rank": m.shard.dp_rank}


def _job(rank, groups, state, toks):
    cfg = _cfg()
    grids = {(2, 2, 2): groups, (1, 4, 2): Groups(4, 2)}
    out = {}
    for mode, shape in CONFIGS:
        out[(mode, shape)] = _run(rank, grids[shape], cfg, state, toks, mode,
                                  shape)
    base, shift = _models(cfg, state, Layout(dp=2, sp=2, tp=2), groups)
    base.init_cache(B, S_MAX)
    shift.adopt_cache(base)
    out["invariance"] = {
        "holds": INV.verify_dense_invariance(base, shift, rank),
        "channels": list(INV.rglru_channels(base, rank)),
        "slots": list(INV.kv_slots(base, rank))}
    base, shift = _models(cfg, state, Layout(sp=4, tp=2), grids[(1, 4, 2)])
    out["engine"] = _serve(base, shift)
    return out


# ---------------------------------------------------------------------------
# the reference's side and the one-rank engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    """The reference's single-device run (``test_equivalence``'s
    ``_run``), its converted weights, and the port's one-rank engine on
    them."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.models import build_model
    from test_torch_recurrent import _randomize_norms, ref_cache
    jm = build_model(jax_config(ARCH).reduced(), dtype=jnp.float32)
    tree = _randomize_norms(
        jax.tree.map(np.asarray, jm.init_params(jax.random.key(0))),
        np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, tree)
    toks = jax.random.randint(jax.random.key(1), (B, S), 0, jm.cfg.vocab_size)
    cache = jm.init_cache(B, S_MAX)
    logits, cache = jm.prefill_fn()(params, cache, toks,
                                    jnp.zeros((B,), jnp.int32))
    nxt, cache = jm.decode_fn()(
        params, cache, jnp.arange(B, dtype=jnp.int32) % jm.cfg.vocab_size,
        jnp.full((B,), S, jnp.int32))
    cfg = _cfg()
    state = from_jax_params(tree, cfg)
    one = Model(cfg, device="cpu", dtype=torch.float32)
    one.load_params(state)
    return {"logits": np.asarray(logits), "next": np.asarray(nxt),
            "cache": ref_cache(jax.tree.map(np.asarray, cache), cfg),
            "toks": np.asarray(toks), "state": state, "engine": _serve(one)}


@pytest.fixture(scope="module")
def ranks(reference):
    return mesh.run_ranks(_job, 2, 2, dp=2, device="cpu", backend="gloo",
                          timeout_s=300,
                          args=(reference["state"], reference["toks"]))


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


def _placed(cache, cfg, lay):
    """The single-device cache as the layout's global arrays: kv slot ``s``
    of the plan's ``kv_slots_total`` holds padded kv head ``s * h_kv_pad //
    kv_slots_total`` (``HeadPlan.a2a_send_map``'s rule), a pad head zeros;
    the RG-LRU state's channels are not padded."""
    from repro_torch.models.attention import get_plan
    plan = get_plan(cfg, lay)
    n = plan.kv_slots_total
    orig = [plan.kv_slot_to_orig[s * plan.h_kv_pad // n] for s in range(n)]
    out = dict(cache)
    for name in ("ring_k", "ring_v"):
        a = cache[name]
        out[name] = np.stack([a[:, :, :, o] if o >= 0 else
                              np.zeros_like(a[:, :, :, 0]) for o in orig],
                             axis=3)
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,shape", CONFIGS,
                         ids=["base-222", "shift-222", "base-142"])
def test_logits_and_tokens_match_single_device(ranks, reference, mode,
                                               shape):
    key = (mode, shape)
    got = _logits(ranks, key)
    V = reference["logits"].shape[-1]
    assert got.shape[0] == B and got.shape[1] >= V
    np.testing.assert_allclose(got[:, :V], reference["logits"], rtol=3e-4,
                               atol=3e-4, err_msg=f"{key} logits")
    assert np.abs(reference["logits"]).max() > 0.1
    for res in ranks:
        np.testing.assert_array_equal(res[key]["next"], reference["next"],
                                      err_msg=f"{key} tokens")


def test_gathered_caches_match_and_base_equals_shift(ranks, reference):
    cfg = _cfg()
    got = {}
    for mode, shape in CONFIGS:
        key, lay = (mode, shape), _lay(mode, shape)
        got[key] = gather_dense_cache([res[key]["cache"] for res in ranks],
                                      cfg, lay)
        want = _placed(reference["cache"], cfg, lay)
        assert set(got[key]) == set(want) == {"ring_k", "ring_v", "h",
                                              "conv"}
        for name, w in want.items():
            assert got[key][name].shape == w.shape, (key, name)
            np.testing.assert_allclose(got[key][name], w, rtol=3e-4,
                                       atol=3e-4, err_msg=f"{key} {name}")
            assert np.abs(w).max() > 0, name
    # (1, 4, 2): every model rank holds 8 of the 64 channels and one copy
    # of the single kv head
    r0 = ranks[0][("base", (1, 4, 2))]["cache"]
    assert r0["h"].shape[1:] == (B, 8) and r0["ring_k"].shape[3] == 1
    a, b = (got[(mode, (2, 2, 2))] for mode in ("base", "shift"))
    for name in a:
        np.testing.assert_allclose(a[name], b[name], rtol=3e-4, atol=3e-4,
                                   err_msg=name)
    for res in ranks:
        for name, t in res[("base", (2, 2, 2))]["cache"].items():
            np.testing.assert_allclose(
                t, res[("shift", (2, 2, 2))]["cache"][name], rtol=3e-4,
                atol=3e-4)


def test_dense_invariance_on_every_rank(ranks):
    order = INV.head_order_base(2, 2)
    for r, res in enumerate(ranks):
        inv = res["invariance"]
        assert inv["holds"], f"rank {r}"
        owner = r % 4                  # the rank's position in its row
        # 64 channels over a model group of 4, the paper's head order
        g = order.index(owner)
        assert inv["channels"] == list(range(16 * g, 16 * (g + 1)))
        assert [order[s] for s in inv["slots"]] == [owner]


def test_dense_engine_on_142_matches_one_rank(ranks, reference):
    want = reference["engine"]
    assert want["paged"] == (False, False)
    assert all(len(s) == NEW for s in want["streams"])
    assert want["counts"].get("base", 0) and want["counts"].get("shift", 0)
    for r, res in enumerate(ranks):
        got = res["engine"]
        assert got["streams"] == want["streams"], f"rank {r}"
        assert got["counts"] == want["counts"], f"rank {r}"
        assert got["preempt"] == want["preempt"], f"rank {r}"
