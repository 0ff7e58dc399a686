"""Pod-scale expert parallelism across dp rows and MLA on the layouts,
eight CPU ranks over gloo, held to the reference.

One eight-rank job (``launch.mesh.run_ranks(..., dp=2)``, a module-scoped
fixture) runs every port-side case; port rank ``r = d*4 + i*2 + j`` is
the reference's device ``mesh.devices[d, i, j]``. Reduced fp32 configs,
the reference's ``init_params(key(0))`` converted (``from_jax_params``)
and cut per rank (``shard_state``).

* The reference's core property (``tests/test_equivalence.py``) for
  deepseek-v3-671b: its ``_run`` inputs (tokens of ``jax.random.key(1)``,
  B 8, S 16, a dense cache of 8 x 32) through the port's ``prefill_step``
  and ``decode_step`` on base (2, 2, 2), shift (2, 2, 2) and base (1, 4,
  2): the logits, put together from the ranks' rows and vocabulary
  columns, within 3e-4 of the reference's single-device run, equal next
  tokens, the ranks' latent caches put together
  (``convert.gather_dense_cache``) within 3e-4 of the reference's (the
  latent has no heads, so its global cache is the single device's on
  every layout), and base == shift. Its MoE layers are pod-scale: experts
  over ``("data", "sp")`` in the base config of (2, 2, 2) and over
  ``("data",)`` in the shift config, the all-to-all across dp rows.
* The serving engines on (2, 2, 2), base on the grid and shift on its
  ``to_shift()``: reduced llama4-17b-16e on the mixed paged iteration
  under a tight pool and reduced deepseek-v3-671b on the serialized dense
  iteration, against the reference's ``ShiftEngine`` on ``mesh222``:
  every rank's streams, config counts and preemptions equal, and the
  exchange crosses rows (``all_to_all`` traffic on every rank).

Six test functions (the reference's ``tests/test_equivalence.py`` has six):
``--dist loadfile`` with its default reordering queues files by their
test count, so this file runs beside that long one, not ahead of it.

JAX is imported only in this process, inside fixtures and tests.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (from_jax_params, gather_dense_cache,  # noqa: E402
                                 shard_state)
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.parallel import Groups, Layout  # noqa: E402

ARCH = "deepseek-v3-671b"
CONFIGS = (("base", (2, 2, 2)), ("shift", (2, 2, 2)), ("base", (1, 4, 2)))
B, S, S_MAX = 8, 16, 32
N_REQ, MAX_NEW = 6, 8
# (arch, engine config): llama4 on the mixed paged pool with too few blocks
# for every request at once, deepseek on its dense fallback
ENGINES = {"llama4-17b-16e": {"num_blocks": 8, "block_size": 8},
           ARCH: {}}


def _cfg(name, cap=4.0):
    cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cap))


def _prompts():
    return [list(range(1, 20 + 3 * i)) for i in range(N_REQ)]


def _lay(mode, shape):
    lay = Layout(dp=shape[0], sp=shape[1], tp=shape[2])
    return lay.to_shift() if mode == "shift" else lay


# ---------------------------------------------------------------------------
# the port's side: one job on eight ranks
# ---------------------------------------------------------------------------
def _model(cfg, state, lay, groups):
    m = Model(cfg, device="cpu", dtype=torch.float32, lay=lay, groups=groups)
    m.load_params(shard_state(state, cfg, lay, groups.rank))
    return m


def _run(rank, groups, state, toks, mode, shape):
    cfg = _cfg(ARCH)
    m = _model(cfg, state, _lay(mode, shape), groups)
    m.init_cache(B, S_MAX)
    groups.traffic.clear()
    logits = m.prefill_step(torch.as_tensor(toks),
                            torch.zeros((B,), dtype=torch.int32))
    nxt = m.decode_step(torch.arange(B, dtype=torch.int32) % cfg.vocab_size,
                        torch.full((B,), S, dtype=torch.int32))
    ffn = m.params.layers[1].ffn
    return {"logits": logits.numpy(), "next": nxt.numpy(),
            "cache": {"lat": m.cache.lat.numpy().copy()},
            "tp_rank": m.shard.tp_rank, "dp_rank": m.shard.dp_rank,
            "ep": (ffn.ep_axes, ffn.replicated, ffn.E_loc),
            "a2a_bytes": groups.traffic.get("all_to_all_bytes", 0)}


def _engine(groups, name, state):
    cfg = _cfg(name, 1.25)
    lay = Layout(dp=2, sp=2, tp=2)
    base = _model(cfg, state, lay, groups)
    shift = _model(cfg, state, lay.to_shift(), groups)
    groups.traffic.clear()
    eng = ShiftEngine(base, EngineConfig(**ENGINES[name]), shift=shift)
    reqs = [Request(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return {"streams": [r.generated for r in reqs],
            "counts": dict(eng.config_counts),
            "preemptions": eng.preemptions,
            "kind": (eng.paged, eng.mixed, eng.paged_disabled_reason),
            "a2a_bytes": groups.traffic.get("all_to_all_bytes", 0)}


def _job(rank, groups, inputs):
    grids = {(2, 2, 2): groups, (1, 4, 2): Groups(4, 2)}
    out = {(mode, shape): _run(rank, grids[shape], inputs["state"][ARCH],
                               inputs["toks"], mode, shape)
           for mode, shape in CONFIGS}
    for name in ENGINES:
        out[name] = _engine(groups, name, inputs["state"][name])
    return out


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
def _ref_single():
    """``tests/test_equivalence.py``'s ``_run`` on one device, and the
    trivial layout's parameters."""
    import jax
    import jax.numpy as jnp
    from conftest import reduced_cfg
    from repro.models import build_model
    m = build_model(reduced_cfg(ARCH), dtype=jnp.float32)
    params = m.init_params(jax.random.key(0))
    toks = jax.random.randint(jax.random.key(1), (B, S), 0,
                              m.cfg.vocab_size)
    cache = m.init_cache(B, S_MAX)
    logits, cache = m.prefill_fn()(params, cache, toks,
                                   jnp.zeros((B,), jnp.int32))
    nxt, cache = m.decode_fn()(params, cache,
                               jnp.arange(B, dtype=jnp.int32)
                               % m.cfg.vocab_size,
                               jnp.full((B,), S, jnp.int32))
    c = jax.tree.map(np.asarray, cache)
    lat = np.concatenate([c["prefix"]["0"]["lat"][None],
                          c["body"]["s0"]["lat"]])
    return {"logits": np.asarray(logits), "next": np.asarray(nxt),
            "lat": lat, "toks": np.asarray(toks, np.int32),
            "params": jax.tree.map(np.asarray, params)}


def _trivial_tree(name):
    import jax
    import jax.numpy as jnp
    from conftest import reduced_cfg
    from repro.models import build_model
    jm = build_model(reduced_cfg(name), dtype=jnp.float32)
    return jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))


def _ref_engine(mesh, name):
    import jax
    import jax.numpy as jnp
    from conftest import reduced_cfg
    from repro.core.policy import ThresholdPolicy as JaxPolicy
    from repro.engine import EngineConfig as JaxEngineConfig
    from repro.engine import Request as JaxRequest
    from repro.engine import ShiftEngine as JaxEngine
    from repro.models.model import Model as JaxModel
    from repro.parallel import Layout as JaxLayout
    cfg = reduced_cfg(name, 1.25)
    base = JaxLayout.from_mesh(mesh, dp=("data",), sp=("sp",), tp=("tp",))
    mb = JaxModel(cfg=cfg, lay=base, mesh=mesh, dtype=jnp.float32)
    ms = JaxModel(cfg=cfg, lay=base.to_shift(), mesh=mesh,
                  dtype=jnp.float32)
    eng = JaxEngine(mb, ms, mb.init_params(jax.random.key(0)),
                    ms.init_params(jax.random.key(0)),
                    JaxEngineConfig(**ENGINES[name]), policy=JaxPolicy(32))
    reqs = [JaxRequest(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return {"streams": [r.generated for r in reqs],
            "counts": dict(eng.config_counts),
            "preemptions": eng.preemptions,
            "kind": (eng.paged, eng.mixed, eng.paged_disabled_reason)}


@pytest.fixture(scope="module")
def single():
    return _ref_single()


@pytest.fixture(scope="module")
def job(single, mesh222):
    """The one eight-rank job of this module, run in a thread while this
    process runs the reference's engines: (every rank's results, the
    reference's engine results by arch)."""
    state = {ARCH: from_jax_params(single["params"], _cfg(ARCH))}
    for name in ENGINES:
        if name not in state:
            state[name] = from_jax_params(_trivial_tree(name), _cfg(name))
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(mesh.run_ranks, _job, 2, 2, dp=2, device="cpu",
                          backend="gloo", timeout_s=150,
                          args=({"state": state, "toks": single["toks"]},))
        engines = {name: _ref_engine(mesh222, name) for name in ENGINES}
        return fut.result(), engines


@pytest.fixture(scope="module")
def ranks(job):
    return job[0]


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


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,shape", CONFIGS,
                         ids=["base-222", "shift-222", "base-142"])
def test_logits_and_tokens_match_single_device(ranks, single, mode, shape):
    key = (mode, shape)
    got = _logits(ranks, key)
    V = single["logits"].shape[-1]
    assert got.shape[0] == B and got.shape[1] >= V
    np.testing.assert_allclose(got[:, :V], single["logits"], rtol=3e-4,
                               atol=3e-4, err_msg=f"{key} logits")
    assert np.abs(single["logits"]).max() > 0.1
    for res in ranks:
        np.testing.assert_array_equal(res[key]["next"], single["next"],
                                      err_msg=f"{key} tokens")


def test_gathered_latent_matches_reference(ranks, single):
    """On every layout the ranks' latent chunks put together equal the
    reference's cache; on (2, 2, 2) each rank's own chunk is the same in the
    base and the shift config (numerical cache invariance)."""
    for mode, shape in CONFIGS:
        key = (mode, shape)
        got = gather_dense_cache([res[key]["cache"] for res in ranks],
                                 _cfg(ARCH), _lay(mode, shape))
        assert got["lat"].shape == single["lat"].shape
        np.testing.assert_allclose(got["lat"], single["lat"], rtol=3e-4,
                                   atol=3e-4, err_msg=f"{key} latent")
        # a rank holds its sp rank's chunk of its row's slots
        assert ranks[0][key]["cache"]["lat"].shape == (
            3, B // shape[0], S_MAX // shape[1], _cfg(ARCH).mla.cache_dim)
    assert np.abs(single["lat"]).max() > 0
    for res in ranks:
        np.testing.assert_allclose(
            res[("base", (2, 2, 2))]["cache"]["lat"],
            res[("shift", (2, 2, 2))]["cache"]["lat"], rtol=3e-4, atol=3e-4)


def test_pod_scale_ep_spans_dp_rows(ranks, mesh222):
    """The EP group on (2, 2, 2) is the reference's: ``("data", "sp")`` in
    the base config (one expert per rank), ``("data",)`` in the shift
    config (FF over the model group), and the exchange moved bytes on
    every rank; on (1, 4, 2) the data axis has one rank."""
    from repro.models import moe as JM
    from repro.parallel import Layout as JaxLayout
    jl = JaxLayout.from_mesh(mesh222, dp=("data",), sp=("sp",), tp=("tp",))
    assert JM.ep_group(jl, 4, True) == (("data", "sp"), False)
    assert JM.ep_group(jl.to_shift(), 4, True) == (("data",), False)
    want = {("base", (2, 2, 2)): (("data", "sp"), False, 1),
            ("shift", (2, 2, 2)): (("data",), False, 2),
            ("base", (1, 4, 2)): (("sp",), False, 1)}
    for key, ep in want.items():
        for res in ranks:
            assert res[key]["ep"] == ep, key
            assert res[key]["a2a_bytes"] > 0, key
    assert TM.moe_tp_axes(Layout(dp=2, sp=2, tp=2).to_shift(),
                          ("data",)) == ("tp", "sp")


def test_engines_on_mesh222_match_reference(job):
    """llama4-17b-16e (mixed paged, a tight pool) and deepseek-v3-671b (its
    dense fallback) on (2, 2, 2): every rank's streams, config counts,
    preemptions and iteration equal the reference's engine on
    ``mesh222``, and every rank's experts exchanged across the rows."""
    for name in ENGINES:
        ranks, want = job[0], job[1][name]
        for r, res in enumerate(ranks):
            e = res[name]
            assert e["streams"] == want["streams"], f"{name} rank {r}"
            assert e["counts"] == want["counts"], name
            assert e["preemptions"] == want["preemptions"], name
            assert e["kind"] == want["kind"], name
            assert e["a2a_bytes"] > 0, name
        assert want["counts"]["base"] > 0 and want["counts"]["shift"] > 0
        assert all(len(s) == MAX_NEW for s in want["streams"])
        if name == "llama4-17b-16e":
            assert want["preemptions"] > 0
            assert want["kind"][:2] == (True, True)
        else:
            assert want["kind"][:2] == (False, False)
            assert "MLA" in want["kind"][2]
