"""MoE training of the port at world size 1, held to the reference on the
CPU: reduced qwen-30b-a3b (top-2 of 4 experts, q/k norms), llama4-17b-16e
(top-1 with shared experts) and llama4-maverick-400b-a17b (the interleaved
``("attn", "moe")`` stack with shared experts), in fp32 at capacity factor
1.25, the reference's ``init_params(key(0))`` through
``from_jax_params``, tokens from a numpy seed.

Per arch (one case each):

* the routing of every MoE layer equals the reference's on the same
  tokens (the smallest top-k gap is printed, so that a flip of a near-tie
  reads as a flip);
* ``Model.loss_fn`` (remat on and off) equals the reference's loss with
  the aux loss; the aux alone (the loss less the loss at
  ``router_aux_coef`` 0) equals the reference's, and is positive;
* every gradient, the router's and the experts' included, equals
  ``jax.grad``'s;
* three ``Trainer`` steps (microbatch 2, remat) equal the reference
  Trainer's, params and moments; with int8 compression they are bitwise
  the uncompressed ones (one rank: the reference's trivial layout has no
  axes to compress over).

And ``check_trainable`` admits the three (and, since items 4.2 and 4.3,
deepseek-v3-671b and mamba2-1.3b) and still refuses the RG-LRU, encoder
and frontend configs; and ZeRO-1 cuts every leaf of the
three on dp rows at the reference's dim (the expert stacks that a
pod-scale EP group spreads over ``"data"`` not at all), against the
reference's ``_zero1_dim`` on its meshes.

Tolerances in ``moe_train_common``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import moe_train_common as C  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (from_jax_opt_state,  # noqa: E402
                                 from_jax_params)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import Trainer  # noqa: E402

ARCHS = ["qwen-30b-a3b", "llama4-17b-16e", "llama4-maverick-400b-a17b"]


def _reference(arch):
    import jax
    import jax.numpy as jnp
    from repro.models import build_model
    from repro.training import Trainer as JaxTrainer
    from repro.training.optimizer import AdamWConfig as JaxAdamW
    cfg = C.ref_cfg(arch)
    model = build_model(cfg, dtype=jnp.float32)
    no_aux = build_model(C.ref_cfg(arch, router_aux_coef=0.0),
                         dtype=jnp.float32)
    params = model.init_params(jax.random.key(0))
    toks, labels = (jnp.asarray(a) for a in C.batch())
    out = {"params": C.np_tree(params)}
    out["loss"] = float(model.loss_fn()(params, toks, labels))
    out["loss_no_aux"] = float(no_aux.loss_fn()(params, toks, labels))
    out["grads"] = C.np_tree(jax.grad(model.loss_fn())(params, toks, labels))
    lf = model.loss_fn()
    g0 = [jax.grad(lf)(params, toks[i * 4:(i + 1) * 4],
                       labels[i * 4:(i + 1) * 4]) for i in range(2)]
    out["grad_step1"] = C.np_tree(jax.tree.map(lambda a, b: (a + b) / 2,
                                               *g0))
    tr = JaxTrainer(model, JaxAdamW(lr=C.LR), microbatch=2, remat=True)
    step = jax.jit(tr.wrapped(tr.opt_specs(jax.eval_shape(lambda: params))))
    p, o, losses = params, tr.init_opt_state(params), []
    for _ in range(C.STEPS):
        p, o, loss = step(p, o, toks, labels)
        losses.append(float(loss))
    out["trained"] = {"params": C.np_tree(p), "opt": C.np_tree(o),
                      "losses": losses}
    return out


def _model(arch, params_tree, **moe):
    cfg = C.port_cfg(arch, **moe)
    m = Model(cfg, device="cpu", dtype=torch.float32)
    m.load_params(from_jax_params(params_tree, cfg))
    return m


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_training_matches_reference(arch):
    ref = _reference(arch)
    cfg = C.port_cfg(arch)
    m = _model(arch, ref["params"])
    toks, labels = C.batch()
    # routing, on a forward without remat (no recomputation)
    with C.routes_logged() as log, torch.no_grad():
        loss_plain = float(m.loss_fn(remat=False)(toks, labels))
    n_moe = sum(k == "moe" for k in cfg.layer_kinds)
    assert len(log) == n_moe
    gap = C.check_routes(log, C.ref_cfg(arch))
    # the loss with aux, and the aux alone
    loss, grads = C.loss_and_grads(m, remat=True)
    assert abs(loss - ref["loss"]) <= C.LOSS_TOL, (loss, ref["loss"], gap)
    assert abs(loss_plain - ref["loss"]) <= C.LOSS_TOL
    with torch.no_grad():
        loss0 = float(_model(arch, ref["params"], router_aux_coef=0.0)
                      .loss_fn()(toks, labels))
    aux, ref_aux = loss - loss0, ref["loss"] - ref["loss_no_aux"]
    assert ref_aux > 0 and aux > 0
    assert ref_aux > 100 * C.LOSS_TOL      # the loss check sees the aux
    assert abs(aux - ref_aux) <= C.AUX_TOL, (aux, ref_aux)
    # every gradient
    want = from_jax_params(ref["grads"], cfg)
    assert set(grads) == set(want)
    assert any(k.endswith("ffn.router") for k in grads)
    for name, g in grads.items():
        scale = float(np.abs(want[name]).max())
        assert scale > 0, name                 # every leaf gets a gradient
        C.close(g, want[name], C.GRAD_TOL * scale,
                (name, f"smallest top-k gap {gap}"))
    # three Trainer steps, plain and int8
    runs = {comp: C.trained(_model(arch, ref["params"]), comp)
            for comp in ("none", "int8")}
    got, tref = runs["none"], ref["trained"]
    np.testing.assert_allclose(got["losses"], tref["losses"], rtol=0,
                               atol=C.LOSS_TOL * 10)
    assert tref["losses"][-1] < tref["losses"][0]
    g1 = from_jax_params(ref["grad_step1"], cfg)
    want_p = from_jax_params(tref["params"], cfg)
    want_o = from_jax_opt_state(tref["opt"], cfg)
    assert got["step"] == want_o["step"] == C.STEPS
    for name, p in got["params"].items():
        tiny = np.abs(g1[name]) < C.TINY
        C.close(p, want_p[name], C.STEP_TOL, name, tiny)
        for tree in ("m", "v"):
            C.close(got[tree][name], want_o[tree][name], C.STEP_TOL,
                    f"{tree}|{name}", tiny)
    assert runs["int8"]["losses"] == got["losses"]
    for tree in ("params", "m", "v"):
        for name, a in got[tree].items():
            assert np.array_equal(runs["int8"][tree][name], a), (tree, name)


def test_check_trainable_admits_moe_and_refuses_the_rest():
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        T.check_trainable(cfg)
        Trainer(Model(cfg, device="cpu", dtype=torch.float32))
    refused = {"recurrentgemma-9b": "item 4.4", "whisper-small": "item 4.5",
               "internvl2-2b": "item 4.5"}
    for arch, item in refused.items():
        m = Model(get_config(arch).reduced(), device="cpu",
                  dtype=torch.float32)
        with pytest.raises(NotImplementedError, match=item):
            m.loss_fn()
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            Trainer(m)
    # MLA with the mtp head (item 4.2) and the SSD (item 4.3) train now, and
    # so does a MoE stack of GQA attention with an mtp head
    for arch in ("deepseek-v3-671b", "mamba2-1.3b"):
        T.check_trainable(get_config(arch).reduced())
    cfg = dataclasses.replace(get_config("qwen-30b-a3b").reduced(),
                              mtp_depth=1)
    T.check_trainable(cfg)


def _ref_leaf(name, cfg):
    """The reference's leaf of the port's parameter ``name``, and whether
    it stacks the body's repeats on a leading axis."""
    parts = name.split(".")
    if parts[0] != "layers":
        return name, False
    i, rest = int(parts[1]), ".".join(parts[2:])
    npre, pat = len(cfg.prefix_layers), len(cfg.layer_pattern)
    body = cfg.pattern_repeats * pat
    if i < npre:
        return f"prefix.{i}.{rest}", False
    if i >= npre + body:
        return f"suffix.{i - npre - body}.{rest}", False
    return f"body.s{(i - npre) % pat}.{rest}", True


ZERO1_CASES = [("qwen-30b-a3b", (2, 1, 1)), ("qwen-30b-a3b", (2, 2, 2)),
               ("llama4-17b-16e", (2, 2, 2)),
               ("llama4-maverick-400b-a17b", (2, 1, 1))]


def test_zero1_dims_match_reference():
    """ZeRO-1's dim of every leaf of the MoE configs on dp rows is the
    reference's ``_zero1_dim`` (``opt_state_specs``): the expert stacks'
    spec names the EP axes on the experts' dim and the TP axes outside
    them on the FF dim, and a stack whose EP group takes ``"data"`` (the
    pod-scale configs) gets none; the layers that the body stacks are cut
    by whole repeats."""
    for arch, mesh_shape in ZERO1_CASES:
        _check_zero1_dims(arch, mesh_shape)


def _check_zero1_dims(arch, mesh_shape):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from conftest import make_mesh
    from repro.models.model import Model as JaxModel
    from repro.parallel import Layout as JaxLayout
    from repro.training.optimizer import _zero1_dim
    from repro_torch.convert import is_expert_leaf, shard_tensor, spans_dp
    from repro_torch.parallel import Layout
    from repro_torch.training.optimizer import zero1_slice
    mesh_ = make_mesh(mesh_shape)
    jlay = JaxLayout.from_mesh(mesh_, dp=("data",), sp=("sp",), tp=("tp",))
    jm = JaxModel(cfg=C.ref_cfg(arch), lay=jlay, mesh=mesh_,
                  dtype=jnp.float32)

    def flat(tree, is_leaf=None):
        return {".".join(str(k.key) for k in path): v for path, v in
                jax.tree_util.tree_flatten_with_path(tree, is_leaf)[0]}
    shapes = flat(jm.abstract_params())
    specs = flat(jm.param_specs(), lambda x: isinstance(x, P))
    cfg, lay = C.port_cfg(arch), Layout(*mesh_shape)
    full = T.Transformer(cfg, Layout(), torch.float32, "meta").state_dict()
    kinds = set()
    for name, t in full.items():
        zs = zero1_slice(name, shard_tensor(name, t, cfg, lay, 0).shape, cfg,
                         lay)
        leaf, stacked = _ref_leaf(name, cfg)
        want = _zero1_dim(specs[leaf], shapes[leaf].shape, lay.dp,
                          ("data",))
        got = (None if zs.kind == "whole" else 0 if zs.kind == "layer"
               else zs.dim + stacked)
        assert got == want, (arch, mesh_shape, name, zs, want)
        if is_expert_leaf(name, cfg):
            kinds.add((spans_dp(name, cfg, lay), zs.kind))
    pod = arch != "qwen-30b-a3b"
    assert kinds == {(True, "whole")} if pod else not any(
        k[0] or k[1] == "whole" for k in kinds), (arch, kinds)
