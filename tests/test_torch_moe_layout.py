"""The port's Mixture-of-Experts layers on the Shift Parallelism layouts,
four CPU ranks over gloo, held to the reference on its ``mesh122``.

One four-rank job (``launch.mesh.run_ranks``, a module fixture) runs every
port-side case; the tests compare with the reference run in this process.
Port rank ``r = i*tp + j`` is compared with the reference's shard on
device ``mesh.devices[0, i, j]``. Reduced qwen-30b-a3b (4 experts, top-2)
and llama4-17b-16e (4 experts, top-1, a shared expert) in fp32, the
reference's weights (``init_params(key(0))``) converted and cut per rank
(``shard_state``).

* ``moe_apply`` on the base config (experts over the sp axis, the a2a
  dispatch, FF over tp), with the plain and the int8 dispatch, and on the
  shift config (experts over the whole model group, tokens replicated):
  every rank's output within 1e-5 of the reference's ``moe_apply`` under
  ``shard_map`` (int8 within 1e-5 of the reference's int8 run), and the
  a2a path really exchanges (``all_to_all`` traffic) where the shift path
  only sums;
* the SPMD engine (base on the grid, shift on its ``to_shift()``, one pool)
  serving the CLI workload under the threshold policy: every rank's
  streams and config counts equal the reference's ``ShiftEngine`` on
  ``mesh122``, for qwen-30b-a3b at capacity factor 4.0 and 1.25 and for
  llama4-17b-16e at 1.25 on the mixed iteration, and for qwen-30b-a3b at
  1.25 on the serialized steps over the paged pool and over the dense
  cache (a decode step sends the rank's rows through the a2a dispatch as
  a one-column sequence);
* ``shard_state``/``unshard_state`` round-trip the MoE leaves bitwise on
  both configs, a sharded model's own init equals the trivial init cut by
  ``shard_state``, and ``ft.elastic.reshard_params`` base -> shift -> base
  gives every rank's weights back bitwise.

JAX is imported only in this process (inside fixtures and tests), so that
the spawned ranks, which import this module to find their job, stay
light.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (from_jax_params, shard_state,  # noqa: E402
                                 unshard_state)
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402

SP, TP = 2, 2
MODELS = ["qwen-30b-a3b", "llama4-17b-16e"]
N_REQ, MAX_NEW = 6, 8
X_SHAPE = (2, 8, 64)            # moe_apply's input: [B, S, d]
# (arch, capacity factor, engine iteration): the mixed paged iteration,
# and the serialized steps on the paged pool and on the dense cache
ITERATIONS = {"mixed": {}, "serial_paged": {"mixed": False},
              "serial_dense": {"paged": False, "mixed": False}}
ENGINES = [("qwen-30b-a3b", 4.0, "mixed"), ("qwen-30b-a3b", 1.25, "mixed"),
           ("llama4-17b-16e", 1.25, "mixed"),
           ("qwen-30b-a3b", 1.25, "serial_paged"),
           ("qwen-30b-a3b", 1.25, "serial_dense")]


def _cfg(name, cap=1.25, dispatch="bf16"):
    cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cap, dispatch_dtype=dispatch))


def _prompts():
    return [list(range(1, 20 + 3 * i)) for i in range(N_REQ)]


# ---------------------------------------------------------------------------
# the port's side: one job on four ranks
# ---------------------------------------------------------------------------
def _model(cfg, state, lay, groups):
    m = Model(cfg, device="cpu", dtype=torch.float32, lay=lay, groups=groups)
    m.load_params(shard_state(state, cfg, lay, groups.rank))
    return m


def _moe_apply(rank, groups, state, x):
    """Layer 0's MoE on this rank's tokens: base (its sp rank's columns) with
    the plain and the int8 dispatch, shift (all columns)."""
    i = rank // TP
    out = {}
    for name, lay, dispatch in (("base", Layout(sp=SP, tp=TP), "bf16"),
                                ("base_int8", Layout(sp=SP, tp=TP), "int8"),
                                ("shift", Layout(sp=SP, tp=TP).to_shift(),
                                 "bf16")):
        cfg = _cfg(state["name"], dispatch=dispatch)
        m = _model(cfg, state["state"], lay, groups)
        ffn = m.params.layers[0].ffn
        xs = x if lay.sp == 1 else x[:, i * 4:(i + 1) * 4]
        groups.traffic.clear()
        y, _ = TM.moe_apply(ffn, torch.from_numpy(np.ascontiguousarray(xs)))
        out[name] = {"y": y.numpy(), "ep_axes": ffn.ep_axes,
                     "replicated": ffn.replicated, "E_loc": ffn.E_loc,
                     "traffic": dict(groups.traffic)}
    return out


def _engine(groups, state, cap, iteration):
    cfg = _cfg(state["name"], cap)
    lay = Layout(sp=SP, tp=TP)
    base = _model(cfg, state["state"], lay, groups)
    shift = _model(cfg, state["state"], lay.to_shift(), groups)
    eng = ShiftEngine(base, EngineConfig(**ITERATIONS[iteration]),
                      shift=shift)
    reqs = [Request(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return {"streams": [r.generated for r in reqs],
            "counts": dict(eng.config_counts),
            "paged": eng.paged, "mixed": eng.mixed,
            "free": eng.kv.num_free_blocks if eng.paged else None,
            "total": eng.kv.num_blocks if eng.paged else None}


def _weights(rank, groups, state):
    """The model's own init against the trivial init cut by
    ``shard_state``, and reshard_params base -> shift -> base."""
    from repro_torch.ft import reshard_params
    cfg = _cfg(state["name"])
    triv = Model(cfg, device="cpu", dtype=torch.float32)
    triv.init_params(torch.Generator().manual_seed(0))
    own = {k: v.numpy() for k, v in triv.params.state_dict().items()}
    lay = Layout(sp=SP, tp=TP)
    out = {}
    for name, layout in (("base", lay), ("shift", lay.to_shift())):
        m = Model(cfg, device="cpu", dtype=torch.float32, lay=layout,
                  groups=groups)
        m.init_params(torch.Generator().manual_seed(0))
        want = shard_state(own, cfg, layout, rank)
        got = m.params.state_dict()
        out[name + "_own_init"] = set(got) == set(want) and all(
            np.array_equal(got[k].numpy(), want[k]) for k in want)
    a = _model(cfg, state["state"], lay, groups)
    shift = reshard_params(a, Model(cfg, device="cpu", dtype=torch.float32,
                                    lay=lay.to_shift(), groups=groups))
    back = reshard_params(shift, Model(cfg, device="cpu",
                                       dtype=torch.float32, lay=lay,
                                       groups=groups))

    def same(m, want):
        sd = m.params.state_dict()
        return all(np.array_equal(sd[k].numpy(), want[k]) for k in want)
    out["reshard_shift"] = same(shift, shard_state(
        state["state"], cfg, lay.to_shift(), rank))
    out["reshard_back"] = same(back, shard_state(state["state"], cfg, lay,
                                                 rank))
    return out


def _job(rank, groups, inputs):
    out = {}
    for name in MODELS:
        st = {"name": name, "state": inputs["state"][name]}
        out[name] = {"moe": _moe_apply(rank, groups, st, inputs["x"]),
                     "weights": _weights(rank, groups, st)}
    out["engine"] = {
        (name, cap, it): _engine(groups, {"name": name,
                                          "state": inputs["state"][name]},
                                 cap, it)
        for name, cap, it in ENGINES}
    return out


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
def _jax_cfg(name, cap=1.25, dispatch="bf16"):
    from conftest import reduced_cfg
    cfg = reduced_cfg(name, cap)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_dtype=dispatch))


def _trivial_tree(name):
    import jax
    import jax.numpy as jnp
    from repro.models import build_model
    jm = build_model(_jax_cfg(name), dtype=jnp.float32)
    return jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))


def _ref_layouts(mesh):
    from repro.parallel import Layout as JaxLayout
    base = JaxLayout.from_mesh(mesh, dp=("data",), sp=("sp",), tp=("tp",))
    return base, base.to_shift()


def _ref_moe(mesh, name, tree, x):
    """The reference's ``moe_apply`` under ``shard_map`` on each config:
    every device's output, by (i, j)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.models import moe as JM
    from repro.parallel.compat import shard_map
    p = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["body"]["s0"]["ffn"])
    base, shift = _ref_layouts(mesh)
    out = {}
    for key, lay, dispatch in (("base", base, "bf16"),
                               ("base_int8", base, "int8"),
                               ("shift", shift, "bf16")):
        cfg = _jax_cfg(name, dispatch=dispatch)
        pod = name in TM.POD_SCALE_ARCHS
        xs = P(None, "sp", None) if lay.sp_axes else P()

        def body(p, x, cfg=cfg, lay=lay, pod=pod):
            return JM.moe_apply(p, x, cfg, lay, pod)[0]
        fn = shard_map(body, mesh=mesh,
                       in_specs=(JM.moe_specs(cfg, lay, pod), xs),
                       out_specs=xs, check_vma=False)
        y = jax.jit(fn)(p, jnp.asarray(x))
        out[key] = {
            (i, j): np.asarray(next(s.data for s in y.addressable_shards
                                    if s.device == mesh.devices[0, i, j]))
            for i in range(SP) for j in range(TP)}
        out[key + "_ep"] = JM.ep_group(lay, cfg.moe.num_experts, pod)
    return out


def _ref_engine(mesh, name, cap, iteration):
    import jax
    import jax.numpy as jnp
    from repro.core.policy import ThresholdPolicy as JaxPolicy
    from repro.engine import EngineConfig as JaxEngineConfig
    from repro.engine import Request as JaxRequest
    from repro.engine import ShiftEngine as JaxEngine
    from repro.models.model import Model as JaxModel
    cfg = _jax_cfg(name, cap)
    base, shift = _ref_layouts(mesh)
    mb = JaxModel(cfg=cfg, lay=base, mesh=mesh, dtype=jnp.float32)
    ms = JaxModel(cfg=cfg, lay=shift, mesh=mesh, dtype=jnp.float32)
    # both draw the trivial layout's canonical weights, placed
    pb = mb.init_params(jax.random.key(0))
    ps = ms.init_params(jax.random.key(0))
    eng = JaxEngine(mb, ms, pb, ps, JaxEngineConfig(**ITERATIONS[iteration]),
                    policy=JaxPolicy(32))
    reqs = [JaxRequest(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return ([r.generated for r in reqs], dict(eng.config_counts),
            (eng.paged, eng.mixed))


@pytest.fixture(scope="module")
def trees():
    return {name: _trivial_tree(name) for name in MODELS}


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(5).standard_normal(X_SHAPE) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def ranks(trees, x):
    """The one four-rank job of this module."""
    state = {name: from_jax_params(trees[name], _cfg(name))
             for name in MODELS}
    return mesh.run_ranks(_job, SP, TP, device="cpu", backend="gloo",
                          timeout_s=120, args=({"state": state, "x": x},))


def _coords():
    return [(r, *divmod(r, TP)) for r in range(SP * TP)]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MODELS)
def test_moe_apply_matches_reference(ranks, trees, x, mesh122, name):
    want = _ref_moe(mesh122, name, trees[name], x)
    for key, ep, replicated, e_loc in (("base", ("sp",), False, 2),
                                       ("base_int8", ("sp",), False, 2),
                                       ("shift", ("tp", "sp"), True, 1)):
        assert want[key + "_ep"] == (ep, replicated)
        for r, i, j in _coords():
            got = ranks[r][name]["moe"][key]
            assert (got["ep_axes"], got["replicated"], got["E_loc"]) == (
                ep, replicated, e_loc), key
            np.testing.assert_allclose(got["y"], want[key][i, j], atol=1e-5,
                                       rtol=1e-5, err_msg=f"{key} rank {r}")
            calls = got["traffic"].get("all_to_all_calls", 0)
            # base: one exchange each way (int8: the values and the
            # scales out); shift: none, one psum
            assert calls == {"base": 2, "base_int8": 3, "shift": 0}[key]
    # the int8 dispatch quantizes: it is not the plain dispatch
    assert not np.array_equal(want["base_int8"][0, 0], want["base"][0, 0])


@pytest.mark.parametrize("name,cap,iteration", [
    pytest.param(*e, id="-".join(map(str, e[:2 if e[2] == "mixed" else 3])))
    for e in ENGINES])
def test_engine_matches_reference(ranks, mesh122, name, cap, iteration):
    streams, counts, kind = _ref_engine(mesh122, name, cap, iteration)
    assert kind == (iteration != "serial_dense", iteration == "mixed")
    for r in range(SP * TP):
        e = ranks[r]["engine"][name, cap, iteration]
        assert e["streams"] == streams, f"rank {r}"
        assert e["counts"] == counts
        assert (e["paged"], e["mixed"]) == kind
        if e["paged"]:
            assert e["free"] == e["total"] - 1
    assert counts["base"] > 0 and counts["shift"] > 0
    assert all(len(s) == MAX_NEW for s in streams)


@pytest.mark.parametrize("name", MODELS)
def test_weights_shard_and_reshard_bitwise(ranks, trees, name):
    cfg = _cfg(name)
    state = from_jax_params(trees[name], cfg)
    lay = Layout(sp=SP, tp=TP)
    for layout in (lay, lay.to_shift()):
        # every model rank's shard in model-rank order
        by_g = sorted(range(SP * TP), key=layout.model_rank)
        shards = [shard_state(state, cfg, layout, r) for r in by_g]
        back = unshard_state(shards, cfg, layout)
        assert set(back) == set(state)
        for k in state:
            assert np.array_equal(back[k], state[k]), k
        moe = [k for k in state if ".ffn." in k]
        assert any(k.endswith("ffn.wi") for k in moe)
        # every rank holds a quarter of each expert stack
        for s in shards:
            assert s["layers.0.ffn.wi"].size * 4 == state[
                "layers.0.ffn.wi"].size
    for r in range(SP * TP):
        w = ranks[r][name]["weights"]
        assert w == {"base_own_init": True, "shift_own_init": True,
                     "reshard_shift": True, "reshard_back": True}, r
