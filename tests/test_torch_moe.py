"""The port's Mixture-of-Experts serving on the CPU against the reference's
(``repro.models.moe``), at world size 1.

Reduced qwen-30b-a3b (4 experts, top-2) and llama4-17b-16e (4 experts,
top-1, a shared expert) in fp32, the reference's weights (``init_params(
key(0))``) converted into the port. Held to the reference's SAME path,
since at capacity factor 1.25 the reference's own mixed and serialized
streams differ (an expert's capacity counts the tokens of the whole padded
step):

* ``ep_group`` and ``moe_tp_axes`` equal the reference's for every layout
  the port runs, E in {4, 16, 128}, pod-scale on and off (``moe_tp_axes``
  up to axes of size 1, which the port's shift of a one-sp grid names
  otherwise); a pod-scale EP group that would span dp rows raises;
* ``moe_apply`` at cf 1.25 and 4.0: the same selected experts, kept mask
  and slots, outputs within 1e-5 and the same ``aux`` under
  ``train=True``; a router with tied columns selects as ``lax.top_k``
  does (the lower expert first);
* the mixed step's logits within 1e-4, at cf 1.25 and 4.0;
* engine streams equal to the reference's for the mixed paged, serialized
  paged and dense paths, and on a pad-sensitive workload (10 random
  prompts, chunk 16, always base): with the padding columns zeroed, as
  the card's kernel wrote them before it computed them, 7 (qwen-30b-a3b)
  and 16 (llama4-17b-16e) of the 100 tokens change.
"""
import dataclasses
import random

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
from repro.models import build_model  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.parallel import Layout as JaxLayout  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402

MODELS = ["qwen-30b-a3b", "llama4-17b-16e"]
# the pad-sensitive workload's tokens that zeroed padding columns change
PAD_SENSITIVE = {"qwen-30b-a3b": 7, "llama4-17b-16e": 16}


class Always:
    """The policy that always answers base (``tests/test_engine.py``)."""

    def __init__(self, b):
        self.b = b

    def use_base(self, n, p=0):
        return self.b


def _port_cfg(name, cap):
    cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cap))


@pytest.fixture(scope="module")
def pairs():
    """(reference model, its params, the port's model) per (name, cf)."""
    out = {}
    for name in MODELS:
        for cap in (1.25, 4.0):
            jm = build_model(reduced_cfg(name, cap), dtype=jnp.float32)
            tree = jax.tree.map(np.asarray,
                                jm.init_params(jax.random.key(0)))
            cfg = _port_cfg(name, cap)
            tm = Model(cfg, device="cpu", dtype=torch.float32)
            tm.load_params(from_jax_params(tree, cfg))
            out[name, cap] = (jm, jax.tree.map(jnp.asarray, tree), tm)
    return out


# ---------------------------------------------------------------------------
# the EP group
# ---------------------------------------------------------------------------
# (dp, sp, tp) grids, each as its base and its shift config
GRIDS = [(1, 1, 1), (1, 2, 2), (1, 4, 1), (1, 1, 4), (1, 1, 2), (1, 2, 1),
         (2, 1, 1), (2, 2, 2), (2, 1, 2)]


def _big(axes, lay):
    return tuple(a for a in axes if lay.axis_sizes[a] > 1)


@pytest.mark.parametrize("E", [4, 16, 128])
@pytest.mark.parametrize("pod", [False, True])
def test_ep_group_matches_reference(E, pod):
    """Each grid's base and shift config against the reference's
    ``Layout.from_mesh(mesh, dp=("data",), sp=("sp",), tp=("tp",))`` on a
    (dp, sp, tp) mesh and its ``to_shift()``."""
    for dp, sp, tp in GRIDS:
        base = Layout(dp=dp, sp=sp, tp=tp)
        jbase = JaxLayout(dp_axes=("data",), sp_axes=("sp",),
                          tp_axes=("tp",),
                          axis_sizes=(("data", dp), ("sp", sp), ("tp", tp)))
        for lay, ref in ((base, jbase), (base.to_shift(), jbase.to_shift())):
            want = JM.ep_group(ref, E, pod)
            got = TM.ep_group(lay, E, pod)
            assert got == want, (lay, E, pod)
            assert _big(TM.moe_tp_axes(lay, got[0]), lay) == _big(
                JM.moe_tp_axes(ref, want[0]), lay), (lay, E, pod)


def test_pod_scale_ep_across_dp_rows_raises():
    """A pod-scale config's EP group on dp rows takes the data axis; its
    MoE layer needs the grid's Groups to build (the eight-rank runs are in
    tests/test_torch_pod_ep.py), and raises without them."""
    cfg = get_config("llama4-17b-16e").reduced()
    assert TM.ep_group(Layout(dp=2), 4, True) == (("data",), False)
    with pytest.raises(ValueError, match="data.*need the grid's Groups"):
        TM.MoE(cfg, Layout(dp=2), torch.float32, "cpu")
    assert not Model(get_config("qwen-30b-a3b").reduced(),
                     device="cpu").pod_scale
    assert Model(cfg, device="cpu").pod_scale


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------
def _ref_route(p, xt, cfg):
    """The reference's routing and capacity assignment on [T, d]."""
    mo = cfg.moe
    logits = (xt @ p["router"].astype(xt.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    w, sel = jax.lax.top_k(probs, mo.top_k)
    T = xt.shape[0]
    C = max(1, int(T * mo.top_k * mo.capacity_factor) // mo.num_experts)
    slot, keep, _ = JM._dispatch_indices(sel, w, T, mo.num_experts, C)
    return np.asarray(sel), np.asarray(keep), np.asarray(slot)


@pytest.mark.parametrize("cap", [1.25, 4.0])
@pytest.mark.parametrize("name", MODELS)
def test_moe_apply_matches_reference(pairs, name, cap):
    jm, params, tm = pairs[name, cap]
    p = jax.tree.map(lambda a: a[0], params["body"]["s0"]["ffn"])
    layer = tm.params.layers[0].ffn
    x = np.random.default_rng(3).standard_normal((4, 8, 64)) \
        .astype(np.float32)
    xt = jnp.asarray(x.reshape(-1, 64))
    sel, keep, slot = _ref_route(p, xt, jm.cfg)
    _, _, tsel, C, tslot, tkeep, _ = TM.route(layer, torch.from_numpy(
        x.reshape(-1, 64)))
    np.testing.assert_array_equal(tsel.numpy(), sel)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    np.testing.assert_array_equal(tslot.numpy(), slot)
    if cap == 1.25:
        assert not keep.all()               # capacity drops some
    want, aux = JM.moe_apply(p, jnp.asarray(x), jm.cfg, JaxLayout(), False,
                             train=True)
    got, taux = TM.moe_apply(layer, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert float(taux) == pytest.approx(float(aux), rel=1e-6)
    assert TM.moe_apply(layer, torch.from_numpy(x))[1] == 0.0


def test_tied_router_selects_as_lax_top_k(pairs):
    """Experts 0/1 and 2/3 have identical router columns, so every token's
    probabilities tie in pairs: ``lax.top_k`` takes the lower expert."""
    jm, params, tm = pairs["qwen-30b-a3b", 1.25]
    layer = tm.params.layers[0].ffn
    router = np.asarray(params["body"]["s0"]["ffn"]["router"][0]).copy()
    router[:, 1], router[:, 3] = router[:, 0], router[:, 2]
    x = np.random.default_rng(4).standard_normal((16, 64)).astype(np.float32)
    p = {"router": jnp.asarray(router)}
    sel, keep, slot = _ref_route(p, jnp.asarray(x), jm.cfg)
    saved = layer.router.clone()
    try:
        layer.router.copy_(torch.from_numpy(router))
        probs, _, tsel, _, tslot, tkeep, _ = TM.route(layer,
                                                      torch.from_numpy(x))
    finally:
        layer.router.copy_(saved)
    top2 = probs.sort(-1, descending=True).values[:, :2]
    assert bool((top2[:, 0] == top2[:, 1]).all())          # every row ties
    np.testing.assert_array_equal(tsel.numpy(), sel)
    assert set(sel[:, 0]) <= {0, 2}
    np.testing.assert_array_equal(tslot.numpy(), slot)
    np.testing.assert_array_equal(tkeep.numpy(), keep)


# ---------------------------------------------------------------------------
# the mixed step
# ---------------------------------------------------------------------------
BS, NB = 4, 9
BT = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0], [7, 8, 0]], np.int32)
STEPS = [([8, 6, 0, 0], [0, 0, 0, 0]), ([1, 4, 0, 5], [8, 6, 0, 0])]


@pytest.mark.parametrize("cap", [1.25, 4.0])
@pytest.mark.parametrize("name", MODELS)
def test_mixed_step_matches_reference(pairs, name, cap):
    """Logits within 1e-4 over a prefill row, a decode row, a padding row
    and a chunk whose padding overhangs the table (``test_torch_model``'s
    steps)."""
    jm, params, tm = pairs[name, cap]
    fwd = jax.jit(jm.forward_fn(paged=True, sample=False))
    pool = jm.init_paged_cache(NB, BS)
    tm.init_paged_cache(NB, BS)
    rng = np.random.default_rng(1)
    for ql, off in STEPS:
        args = (rng.integers(1, 256, (4, 8)).astype(np.int32),
                np.array(ql, np.int32), np.array(off, np.int32), BT)
        want, pool = fwd(params, pool, *map(jnp.asarray, args))
        got, _ = tm.forward_mixed(*args, sample=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------
def _pad_prompts(seed=0):
    rnd = random.Random(seed)
    return [[rnd.randrange(1, 250) for _ in range(rnd.randrange(2, 40))]
            for _ in range(10)]


def _cli_prompts():
    return [list(range(1, 20 + 3 * i)) for i in range(6)]


WORKLOADS = {
    # Motivation's pad-sensitive run: 10 prompts, 10 new tokens, always base
    "pad": (dict(max_slots=8, s_max=128, prefill_chunk=16), _pad_prompts,
            10, lambda: Always(True)),
    # the serve CLI's workload under the threshold policy
    "cli": ({}, _cli_prompts, 8, None),
}


def _ref_streams(jm, params, ekw, prompts, n_new, policy):
    eng = JaxEngine(jm, jm, params, params, JaxEngineConfig(**ekw),
                    policy=policy or JaxPolicy(32))
    reqs = [JaxRequest(i, p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return [list(r.generated) for r in reqs], eng.config_counts


def _port_streams(tm, ekw, prompts, n_new, policy):
    eng = ShiftEngine(tm, EngineConfig(**ekw), policy=policy)
    reqs = [Request(i, p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert all(r.finish_reason == "ok" for r in reqs)
    if eng.kv is not None:
        assert eng.kv.num_free_blocks == eng.kv.num_blocks - 1
    return [list(r.generated) for r in reqs], eng.config_counts


def _zeroed_padding(monkeypatch):
    """Zero the ragged attention's padding columns, as the card's kernel
    wrote them without ``pad_cols``."""
    attend = K.paged_ragged_attend

    def zeroed(q, *args, **kw):
        out = attend(q, *args, **kw)
        live = torch.arange(q.shape[1])[None, :] < args[3][:, None]
        return torch.where(live[:, :, None, None], out, 0.0)
    monkeypatch.setattr(K, "paged_ragged_attend", zeroed)


@pytest.mark.parametrize("path", [
    ("pad", {}, 1.25), ("cli", {}, 4.0), ("cli", {"mixed": False}, 1.25),
    ("cli", {"paged": False, "mixed": False}, 1.25)],
    ids=["mixed-pad-sensitive", "mixed-cf4", "serialized", "dense"])
@pytest.mark.parametrize("name", MODELS)
def test_engine_matches_reference(pairs, name, path, monkeypatch):
    work, kw, cap = path
    ekw, prompts, n_new, policy = WORKLOADS[work]
    jm, params, tm = pairs[name, cap]
    ekw = dict(ekw, **kw)
    want = _ref_streams(jm, params, ekw, prompts(), n_new,
                        policy and policy())
    got = _port_streams(tm, ekw, prompts(), n_new, policy and policy())
    assert got == want
    assert all(len(s) == n_new for s in got[0])
    if work == "pad":
        _zeroed_padding(monkeypatch)
        zeroed, _ = _port_streams(tm, ekw, prompts(), n_new, policy())
        changed = sum(a != b for x, y in zip(zeroed, want[0])
                      for a, b in zip(x, y))
        assert changed == PAD_SENSITIVE[name]
