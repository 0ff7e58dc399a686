"""The port's full (dp, sp, tp) = (2, 2, 2) layout on eight CPU ranks over
gloo, held to the reference on its ``mesh222``.

One eight-rank job (``launch.mesh.run_ranks(..., dp=2)``, a module-scoped
fixture) runs every scenario; port rank ``r = d*4 + i*2 + j`` is compared
with the reference's device ``mesh.devices[d, i, j]``:

* ``_drive_mixed`` of ``tests/test_workprop_attention.py`` (prefill under
  base, decodes alternating shift and base over one pool per row): every
  rank's streams equal the reference's on ``mesh222``;
* the mixed SPMD engine (base on the grid, shift on its ``to_shift()``,
  each rank its row's pool): streams, rows and config counts equal the
  reference ``ShiftEngine``'s on ``mesh222``, on every rank;
* the per-row invariance on written pools: both rows map the same
  row-local blocks, which hold different bytes in each row after a base
  prefill and a shift pass that reads them; the blocks stay bitwise
  unchanged, every table entry is a row-local id, and a table holding
  pool-global ids fails the check.

Weights: the reference's ``init_params(key(0))`` with random norm scales,
as in ``tests/test_torch_layout.py``. JAX is imported only in this
process, inside fixtures and tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.cache import PagedKVCache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params, shard_state  # noqa: E402
from repro_torch.core import invariance as INV  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402

DP, SP, TP = 2, 2, 2
N_REQ, MAX_NEW = 6, 8


def _cfg():
    return get_config("qwen3-8b").reduced()


def _prompts():
    return [list(range(1, 20 + 3 * i)) for i in range(N_REQ)]


# ---------------------------------------------------------------------------
# the port's side: one job on eight ranks
# ---------------------------------------------------------------------------
def _models(state, groups):
    cfg, lay = _cfg(), Layout(dp=DP, sp=SP, tp=TP)
    out = []
    for layout in (lay, lay.to_shift()):
        m = Model(cfg, device="cpu", dtype=torch.float32, lay=layout,
                  groups=groups)
        m.load_params(shard_state(state, cfg, layout, groups.rank))
        out.append(m)
    return out


def _drive(base, shift, toks, steps=3):
    B, bs, nmax = 8, 8, 4
    bt = 1 + np.arange(B * nmax, dtype=np.int32).reshape(B, nmax)
    base.init_paged_cache(B * nmax + 1, bs)
    shift.adopt_paged_cache(base)
    one = np.ones((B,), np.int32)
    t, _ = base.forward_mixed(toks, np.full((B,), 16, np.int32),
                              np.zeros((B,), np.int32), bt)
    stream = [t.numpy()]
    offs = np.full((B,), 16, np.int32)
    for step in range(steps):
        m = shift if step % 2 == 0 else base
        tk = t.numpy().astype(np.int32)[:, None]
        if m is base:                      # the chunk axis covers sp
            tk = np.pad(tk, ((0, 0), (0, SP - 1)))
        t, _ = m.forward_mixed(tk, one, offs, bt)
        stream.append(t.numpy())
        offs = offs + 1
    return stream


def _engine(base, shift, groups):
    groups.traffic.clear()
    eng = ShiftEngine(base, EngineConfig(), shift=shift)
    reqs = [Request(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return {"streams": [r.generated for r in reqs],
            "rows": [r.row for r in reqs], "counts": dict(eng.config_counts),
            "ledger": eng.block_accounting().as_dict(),
            "traffic": dict(groups.traffic)}


def _invariance(base, shift, rank, toks):
    """Slots 0 and 2 (one per row) get row-local blocks 1 and 2 of their
    rows. Base prefills both (different tokens per row); shift runs slots
    1 and 3, which read those blocks through their tables and write blocks
    3 and 4 of their rows."""
    kv = PagedKVCache(9, 8, 4, 4, dp=DP)
    base.init_paged_cache(9, 8)
    shift.adopt_paged_cache(base)
    for s in (0, 2):
        assert kv.ensure(s, 16)
    bt = kv.table.copy()
    base.forward_mixed(toks, [16, 0, 16, 0], [0] * 4, bt)
    before = INV.snapshot_blocks(base.pool, [1, 2])
    for s in (1, 3):
        kv.fork(s - 1, s)
        assert kv.ensure(s, 32)
    bt = kv.table.copy()
    toks2 = np.roll(toks, 1, axis=0)
    shift.forward_mixed(toks2, [0, 16, 0, 16], [16] * 4, bt)
    holds = INV.verify_paged_invariance(base, shift, rank, [1, 2], before,
                                        kv=kv)
    # the teeth: row 1's table in pool-global ids reaches past its pool
    glob = PagedKVCache(9, 8, 4, 4, dp=DP)
    glob.table = kv.table.copy()
    glob.table3[1] = np.where(kv.table3[1] > 0,
                              kv.table3[1] + kv.num_blocks_per_row, 0)
    return {"holds": holds,
            "global_fails": not INV.verify_paged_invariance(
                base, shift, rank, [1, 2], before, kv=glob),
            "tables": kv.table3.tolist(),
            "block1": base.pool.k[:, 1].numpy().copy(),
            "wrote": base.pool.k[:, 3:5].abs().sum().item() > 0,
            "slots": list(INV.kv_slots(base, rank))}


def _job(rank, groups, inputs):
    base, shift = _models(inputs["state"], groups)
    return {"rank": rank, "dp_rank": base.shard.dp_rank,
            "drive": _drive(base, shift, inputs["drive_toks"]),
            "engine": _engine(base, shift, groups),
            "invariance": _invariance(base, shift, rank,
                                      inputs["inv_toks"])}


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
def _randomize_norms(tree, rng):
    return {k: (_randomize_norms(v, rng) if isinstance(v, dict)
                else rng.standard_normal(v.shape).astype(v.dtype)
                if k in ("scale", "q_norm", "k_norm") else v)
            for k, v in tree.items()}


def _ref_params(model):
    import jax
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.key(0)))
    return _randomize_norms(tree, np.random.default_rng(0))


@pytest.fixture(scope="module")
def ref(mesh222):
    import jax.numpy as jnp
    from conftest import reduced_cfg
    from repro.models.model import Model as JaxModel
    from repro.parallel import Layout as JaxLayout
    lay = JaxLayout.from_mesh(mesh222, dp=("data",), sp=("sp",), tp=("tp",))
    cfg = reduced_cfg("qwen3-8b")
    mb = JaxModel(cfg=cfg, lay=lay, mesh=mesh222, dtype=jnp.float32)
    ms = JaxModel(cfg=cfg, lay=lay.to_shift(), mesh=mesh222,
                  dtype=jnp.float32)
    return mb, ms, _ref_params(mb), _ref_params(ms)


@pytest.fixture(scope="module")
def inputs():
    import jax
    import jax.numpy as jnp
    from conftest import reduced_cfg
    from repro.models import build_model
    vocab = _cfg().vocab_size
    jm = build_model(reduced_cfg("qwen3-8b"), dtype=jnp.float32)
    return {"state": from_jax_params(_ref_params(jm), _cfg()),
            "drive_toks": np.asarray(jax.random.randint(
                jax.random.key(1), (8, 16), 0, vocab), np.int32),
            "inv_toks": np.asarray(jax.random.randint(
                jax.random.key(2), (4, 16), 1, vocab), np.int32)}


@pytest.fixture(scope="module")
def ranks(inputs):
    """The one eight-rank job of this module."""
    return mesh.run_ranks(_job, SP, TP, dp=DP, device="cpu", backend="gloo",
                          timeout_s=300, args=(inputs,))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_ranks_sit_where_the_reference_mesh_puts_them(ranks, mesh222):
    for r, res in enumerate(ranks):
        d, local = divmod(r, SP * TP)
        i, j = divmod(local, TP)
        assert int(mesh222.devices[d, i, j].id) == r
        assert res["dp_rank"] == d


def test_drive_mixed_streams_match_reference(ranks, ref, inputs):
    import jax
    import jax.numpy as jnp
    mb, ms, pb, ps = ref
    B, bs, nmax = 8, 8, 4
    bt = jnp.asarray(1 + np.arange(B * nmax).reshape(B, nmax), jnp.int32)
    one = jnp.ones((B,), jnp.int32)
    pool = mb.init_paged_cache(B * nmax + 1, bs)
    fwd_b, fwd_s = jax.jit(mb.forward_fn()), jax.jit(ms.forward_fn())
    pb, ps = jax.tree.map(jnp.asarray, pb), jax.tree.map(jnp.asarray, ps)
    t, pool = fwd_b(pb, pool, jnp.asarray(inputs["drive_toks"]),
                    jnp.full((B,), 16, jnp.int32), jnp.zeros((B,), jnp.int32),
                    bt)
    want = [np.asarray(t)]
    offs = jnp.full((B,), 16, jnp.int32)
    for step in range(3):
        shift = step % 2 == 0
        tk = t.astype(jnp.int32)[:, None]
        if not shift:
            tk = jnp.pad(tk, ((0, 0), (0, SP - 1)))
        t, pool = (fwd_s if shift else fwd_b)(ps if shift else pb, pool, tk,
                                              one, offs, bt)
        want.append(np.asarray(t))
        offs = offs + 1
    for res in ranks:
        assert len(res["drive"]) == len(want)
        for g, w in zip(res["drive"], want):
            np.testing.assert_array_equal(g, w)


def test_engine_matches_reference(ranks, ref):
    import jax
    import jax.numpy as jnp
    from repro.core.policy import ThresholdPolicy as JaxPolicy
    from repro.engine import EngineConfig as JaxEngineConfig
    from repro.engine import Request as JaxRequest
    from repro.engine import ShiftEngine as JaxEngine
    mb, ms, pb, ps = ref
    eng = JaxEngine(mb, ms, jax.tree.map(jnp.asarray, pb),
                    jax.tree.map(jnp.asarray, ps), JaxEngineConfig(),
                    policy=JaxPolicy(32))
    reqs = [JaxRequest(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    want = ([r.generated for r in reqs], [r.row for r in reqs],
            eng.config_counts)
    for r, res in enumerate(ranks):
        e = res["engine"]
        assert (e["streams"], e["rows"], e["counts"]) == want, f"rank {r}"
        assert e["ledger"]["used"] == 0
    e = ranks[0]["engine"]
    assert set(e["rows"]) == {0, 1}
    assert e["counts"]["base"] > 0 and e["counts"]["shift"] > 0
    assert all(len(s) == MAX_NEW for s in e["streams"])
    for kind in ("all_to_all", "all_reduce", "all_gather", "dp_all_gather"):
        assert e["traffic"][kind + "_calls"] > 0, kind


def test_per_row_invariance_on_written_pools(ranks):
    order = INV.head_order_base(SP, TP)            # slot -> owning rank
    for r, res in enumerate(ranks):
        inv = res["invariance"]
        assert inv["holds"], f"rank {r}"
        assert inv["global_fails"], f"rank {r}: a pool-global table passed"
        assert inv["wrote"], f"rank {r}: the shift pass wrote nothing"
        # both rows map the same row-local ids
        assert inv["tables"][0][0][:2] == inv["tables"][1][0][:2] == [1, 2]
        assert [order[s] for s in inv["slots"]] == [r % (SP * TP)]
    # the same row-local block holds different bytes in each row: each
    # row's tokens went to its own pool
    for local in range(SP * TP):
        a = ranks[local]["invariance"]["block1"]
        b = ranks[SP * TP + local]["invariance"]["block1"]
        assert np.abs(a).sum() > 0 and np.abs(b).sum() > 0
        assert not np.array_equal(a, b), f"grid position {local}"
