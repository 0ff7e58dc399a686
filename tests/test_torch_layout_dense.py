"""The serialized iteration on a layout: the port's SPMD engine on
(sp, tp) = (2, 2), four CPU ranks over gloo, held to the reference's same
engine on ``mesh122``.

One four-rank job (``launch.mesh.run_ranks``, a module-scoped fixture)
serves three engines, each with a base model on the grid and a shift
model on its ``to_shift()`` stepping one cache per rank:

* the serialized paged engine (``mixed=False``), reduced qwen3-8b, on a
  tight pool (more requests than slots, preemptions);
* the serialized dense engine (``paged=False, mixed=False``), reduced
  qwen3-8b;
* the dense engine of reduced mamba2-1.3b (its automatic fallback), two
  requests in flight, so that dummy rows advance SSD state as they do in
  the reference.

Each one's streams, config counts (both configs used), preemptions,
``paged_disabled_reason`` and observability dump (under one fake clock
per engine, JSON-equal) equal the reference's ``ShiftEngine`` on
``mesh122`` on every rank. After each dense engine's run, on every rank,
the base and shift views step one dense cache
(``core.invariance.verify_dense_invariance``); so do reduced
deepseek-v3-671b's, whose latent cache every rank holds one chunk of the
sequence of, the chunk the reference's specs place on its device. A snapshot of the mamba2
engine taken mid-stream (its rank's dense cache, SSD state included)
restores into a fresh engine, which finishes with the uninterrupted
streams.

Weights: the reference's ``init_params(key(0))`` with random norm scales
and random SSD ``dt_bias``, ``A_log`` and ``D`` (so that a rank holding
another rank's heads would show), converted and cut per rank
(``shard_state``). JAX is imported only in this process, inside fixtures
and tests.
"""
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params, shard_state  # noqa: E402
from repro_torch.core import invariance as INV  # noqa: E402
from repro_torch.core.policy import ThresholdPolicy  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402

SP, TP = 2, 2
THRESHOLD = 8
KW = dict(max_slots=4, s_max=64, prefill_chunk=8, threshold=THRESHOLD)
# name -> (arch, engine settings, prompts' lengths, new tokens)
CASES = {
    "paged": ("qwen3-8b", dict(KW, mixed=False, block_size=8, num_blocks=9),
              (11, 19, 14, 23, 9, 17), 6),
    "dense": ("qwen3-8b", dict(KW, paged=False, mixed=False),
              (11, 19, 14, 23, 9, 17), 6),
    "mamba": ("mamba2-1.3b", dict(KW), (11, 20), 6),
}
SNAP_AT = 5                      # the mamba2 engine's step of the snapshot
RANDOMIZED = ("scale", "q_norm", "k_norm", "norm", "dt_bias", "A_log", "D")


def _prompts(lengths):
    return [list(range(3 + 5 * i, 3 + 5 * i + n))
            for i, n in enumerate(lengths)]


def _fake_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return [list(r.generated) for r in reqs]


def _outcome(eng, streams):
    return {"streams": streams, "counts": dict(eng.config_counts),
            "preempt": eng.preemptions,
            "reason": eng.paged_disabled_reason,
            "dump": json.loads(json.dumps(eng.obs.dump(), sort_keys=True))}


# ---------------------------------------------------------------------------
# the port's side: one job on four ranks
# ---------------------------------------------------------------------------
def _models(arch, state, groups):
    cfg, lay = get_config(arch).reduced(), Layout(sp=SP, tp=TP)
    out = []
    for layout in (lay, lay.to_shift()):
        m = Model(cfg, device="cpu", dtype=torch.float32, lay=layout,
                  groups=groups)
        m.load_params(shard_state(state, cfg, layout, groups.rank))
        out.append(m)
    return out


def _engine(base, shift, kw):
    kw = dict(kw)
    threshold = kw.pop("threshold")
    return ShiftEngine(base, EngineConfig(threshold=threshold, **kw),
                       shift=shift, policy=ThresholdPolicy(threshold),
                       now=_fake_clock())


def _case(rank, groups, states, name):
    arch, kw, lengths, new = CASES[name]
    base, shift = _models(arch, states[arch], groups)
    eng = _engine(base, shift, kw)
    reqs = [Request(i, p, max_new_tokens=new)
            for i, p in enumerate(_prompts(lengths))]
    out = _outcome(eng, _run(eng, reqs))
    if not eng.paged:
        out["invariance"] = INV.verify_dense_invariance(eng.base, eng.shift,
                                                        rank)
        out["cache_rows"] = eng.base.cache.k.shape[1] \
            if eng.base.cache.k is not None else eng.base.cache.ssm.shape[1]
    else:
        out["free"] = (eng.kv.num_free_blocks, eng.kv.num_blocks)
    return out


def _snapshot_restore(rank, groups, states):
    """The mamba2 engine snapshotted at step ``SNAP_AT``, run on to the
    end, then the snapshot restored into a fresh engine that finishes."""
    arch, kw, lengths, new = CASES["mamba"]
    base, shift = _models(arch, states[arch], groups)
    eng = _engine(base, shift, kw)
    reqs = [Request(i, p, max_new_tokens=new)
            for i, p in enumerate(_prompts(lengths))]
    for r in reqs:
        eng.submit(r)
    for _ in range(SNAP_AT):
        eng.step()
    snap = eng.snapshot()
    mid = [list(r.generated) for r in reqs]
    eng.run_until_idle()
    fresh = _engine(base, shift, kw)
    fresh.restore(snap)
    fresh.run_until_idle()
    return {"mid": mid, "snap_rank": snap["rank"],
            "snap_ssm": tuple(snap["cache"]["ssm"].shape),
            "streams": [list(r.generated) for r in reqs],
            "restored": [fresh.stream(i) for i in range(len(reqs))],
            "invariance": INV.verify_dense_invariance(fresh.base, fresh.shift,
                                                      rank)}


def _latent_invariance(rank, groups):
    """Reduced deepseek-v3-671b's base and shift models on (1, 2, 2), the
    shift one adopting the base one's dense cache: the structural latent
    invariance, and the chunk of the sequence this rank holds."""
    cfg = get_config("deepseek-v3-671b").reduced()
    lay = Layout(sp=SP, tp=TP)
    base, shift, own = (Model(cfg, device="cpu", dtype=torch.float32,
                              lay=la, groups=groups)
                        for la in (lay, lay.to_shift(), lay.to_shift()))
    base.init_cache(8, 32)
    shift.adopt_cache(base)
    own.init_cache(8, 32)
    return {"holds": INV.verify_dense_invariance(base, shift, rank),
            "own_cache_fails": not INV.verify_dense_invariance(base, own,
                                                               rank),
            "chunk": (INV.latent_chunk(base, rank),
                      INV.latent_chunk(shift, rank)),
            "shape": tuple(base.cache.lat.shape)}


def _job(rank, groups, states):
    out = {name: _case(rank, groups, states, name) for name in CASES}
    out["snapshot"] = _snapshot_restore(rank, groups, states)
    out["latent"] = _latent_invariance(rank, groups)
    return out


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
def _randomize(tree, rng):
    return {k: (_randomize(v, rng) if isinstance(v, dict)
                else rng.standard_normal(v.shape).astype(v.dtype)
                if k in RANDOMIZED else v)
            for k, v in tree.items()}


def _ref_params(model):
    import jax
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.key(0)))
    return _randomize(tree, np.random.default_rng(0))


@pytest.fixture(scope="module")
def states():
    import jax.numpy as jnp
    from conftest import reduced_cfg
    from repro.models import build_model
    return {arch: from_jax_params(_ref_params(build_model(
        reduced_cfg(arch), dtype=jnp.float32)), get_config(arch).reduced())
        for arch in ("qwen3-8b", "mamba2-1.3b")}


@pytest.fixture(scope="module")
def ranks(states):
    """The one four-rank job of this module."""
    return mesh.run_ranks(_job, SP, TP, device="cpu", backend="gloo",
                          timeout_s=150, args=(states,))


def _ref_case(mesh122, name):
    import jax
    import jax.numpy as jnp
    from conftest import reduced_cfg
    from repro.core.policy import ThresholdPolicy as JaxPolicy
    from repro.engine import EngineConfig as JaxEngineConfig
    from repro.engine import Request as JaxRequest
    from repro.engine import ShiftEngine as JaxEngine
    from repro.models.model import Model as JaxModel
    from repro.parallel import Layout as JaxLayout
    arch, kw, lengths, new = CASES[name]
    cfg = reduced_cfg(arch)
    lay = JaxLayout.from_mesh(mesh122, dp=("data",), sp=("sp",), tp=("tp",))
    mb = JaxModel(cfg=cfg, lay=lay, mesh=mesh122, dtype=jnp.float32)
    ms = JaxModel(cfg=cfg, lay=lay.to_shift(), mesh=mesh122,
                  dtype=jnp.float32)
    pb, ps = (jax.tree.map(jnp.asarray, _ref_params(m)) for m in (mb, ms))
    kw = dict(kw)
    threshold = kw.pop("threshold")
    eng = JaxEngine(mb, ms, pb, ps, JaxEngineConfig(threshold=threshold,
                                                    **kw),
                    policy=JaxPolicy(threshold), now=_fake_clock())
    reqs = [JaxRequest(i, p, max_new_tokens=new)
            for i, p in enumerate(_prompts(lengths))]
    return _outcome(eng, _run(eng, reqs))


@pytest.fixture(scope="module")
def reference(mesh122):
    return {name: _ref_case(mesh122, name) for name in CASES}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_reference(ranks, reference, name):
    want = reference[name]
    for r, res in enumerate(ranks):
        got = res[name]
        assert got["streams"] == want["streams"], (name, r)
        assert got["counts"] == want["counts"], (name, r)
        assert got["preempt"] == want["preempt"], (name, r)
        assert got["reason"] == want["reason"], (name, r)
    arch, kw, lengths, new = CASES[name]
    assert all(len(s) == new for s in want["streams"])
    assert want["counts"]["base"] > 0 and want["counts"]["shift"] > 0
    if name == "paged":
        assert want["preempt"] > 0 and want["reason"] is None
        assert all(res[name]["free"][0] == res[name]["free"][1] - 1
                   for res in ranks)
    else:
        assert want["reason"] is not None


@pytest.mark.parametrize("name", list(CASES))
def test_dump_matches_reference(ranks, reference, name):
    """Under one fake clock per engine, every rank's observability dump
    equals the reference's."""
    want = json.dumps(reference[name]["dump"], sort_keys=True)
    for r, res in enumerate(ranks):
        assert json.dumps(res[name]["dump"], sort_keys=True) == want, \
            (name, r)


@pytest.mark.parametrize("name", ["dense", "mamba"])
def test_dense_cache_invariance_after_serving(ranks, name):
    """Both configs stepped the one dense cache of every rank, which holds
    the rank's dp row's 4 slots."""
    for r, res in enumerate(ranks):
        assert res[name]["invariance"], (name, r)
        assert res[name]["cache_rows"] == 4


def test_snapshot_restore_mid_stream(ranks, reference):
    """A rank's dense cache with its SSD state (two heads of eight here)
    restores mid-stream into a fresh engine, which finishes with the
    uninterrupted streams, the reference's."""
    want = reference["mamba"]["streams"]
    for r, res in enumerate(ranks):
        snap = res["snapshot"]
        assert snap["snap_rank"] == r
        assert snap["snap_ssm"][1:3] == (4, 2)
        assert any(snap["mid"]) and snap["mid"] != want
        assert snap["streams"] == want and snap["restored"] == want, r
        assert snap["invariance"]


def test_latent_cache_invariance_structural(ranks, mesh122):
    """The counterpart of the reference's structural invariance test for
    deepseek-v3-671b on ``mesh122``: every rank's base and shift models
    step one latent cache, and the chunk of the sequence a rank holds is
    the one the reference's ``mla_cache_specs`` (``P(dp, cache_sp,
    None)``) places on its device, in both configs."""
    from jax.sharding import NamedSharding
    from conftest import reduced_cfg
    from repro.models.model import Model as JaxModel
    from repro.parallel import Layout as JaxLayout
    cfg = reduced_cfg("deepseek-v3-671b")
    lay = JaxLayout.from_mesh(mesh122, dp=("data",), sp=("sp",), tp=("tp",))
    shape = (8, 32, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)
    for la in (lay, lay.to_shift()):
        spec = JaxModel(cfg=cfg, lay=la, mesh=mesh122) \
            .cache_specs()["prefix"]["0"]["lat"]
        where = NamedSharding(mesh122, spec).devices_indices_map(shape)
        for r, res in enumerate(ranks):
            inv = res["latent"]
            assert inv["holds"] and inv["own_cache_fails"], r
            seq = where[mesh122.devices[0, r // TP, r % TP]][1]
            for chunk in inv["chunk"]:
                assert chunk == range(seq.start, seq.stop), r
            assert inv["shape"] == (3, 8, 16, shape[2])
