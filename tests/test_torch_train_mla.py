"""MLA training with DeepSeek-V3's MTP head at world size 1, held to the
reference on the CPU: reduced deepseek-v3-671b (MLA attention, a dense
prefix layer and two MoE layers with shared experts, and the ``mtp`` head:
``proj``, an MLA ``attn`` block with the dense MLP, ``norm``), in fp32 at
capacity factor 1.25, the reference's ``init_params(key(0))`` through
``from_jax_params``, tokens from a numpy seed.

* ``from_jax_params`` converts ``mtp.*`` under its own names, and the
  port's own init draws the same tree; the loss equals the reference's
  ``loss_body``, and so do its three parts: the nll, 0.3 times the MTP
  term (the loss less the loss of the tree without ``mtp``) and the aux
  (the loss less the loss at ``router_aux_coef`` 0); every gradient, the
  MTP head's included, equals ``jax.grad``'s;
* three ``Trainer`` steps (microbatch 2, remat) equal the reference
  Trainer's, params and moments; with int8 compression they are bitwise
  the uncompressed ones (one rank: the reference's trivial layout has no
  axes to compress over);
* a checkpoint round trip restores the trained params and moments
  bitwise, the MTP head's included;
* ``check_trainable`` admits MLA, the MTP head and SSD, and still refuses
  the RG-LRU and local attention (ROADMAP Queue 1 item 4.4) and the
  encoder and frontends (4.5);
* ZeRO-1 cuts every leaf of deepseek-v3-671b (the MLA and MTP leaves
  included) and of mamba2-1.3b (the SSD mixer's) on dp rows at the
  reference's ``_zero1_dim`` on its meshes.

Tolerances in ``moe_train_common`` (loss 1e-5; gradients 1e-4 of each
leaf's largest entry; params and moments after three steps 5e-4).
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

ARCH = "deepseek-v3-671b"


@pytest.fixture(scope="module")
def reference():
    import jax
    import jax.numpy as jnp
    from repro.models import build_model
    from repro.training import Trainer as JaxTrainer
    from repro.training.optimizer import AdamWConfig as JaxAdamW
    cfg = C.ref_cfg(ARCH)
    model = build_model(cfg, dtype=jnp.float32)
    no_aux = build_model(C.ref_cfg(ARCH, router_aux_coef=0.0),
                         dtype=jnp.float32)
    params = model.init_params(jax.random.key(0))
    toks, labels = (jnp.asarray(a) for a in C.batch())
    lf = model.loss_fn()
    out = {"params": C.np_tree(params)}
    out["loss"] = float(lf(params, toks, labels))
    out["loss_no_aux"] = float(no_aux.loss_fn()(params, toks, labels))
    no_mtp = {k: v for k, v in params.items() if k != "mtp"}
    out["loss_no_mtp"] = float(lf(no_mtp, toks, labels))
    out["grads"] = C.np_tree(jax.grad(lf)(params, toks, labels))
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


def _model(params_tree, cfg=None):
    cfg = cfg or C.port_cfg(ARCH)
    m = Model(cfg, device="cpu", dtype=torch.float32)
    state = from_jax_params(params_tree, C.port_cfg(ARCH))
    if not cfg.mtp_depth:
        state = {k: v for k, v in state.items() if not k.startswith("mtp.")}
    m.load_params(state)
    return m


@pytest.fixture(scope="module")
def port_trained(reference, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("mla") / "ck")
    runs = {comp: C.trained(_model(reference["params"]), comp,
                            ckpt=ck if comp == "none" else None)
            for comp in ("none", "int8")}
    return runs, ck


def test_mtp_converts_and_loss_and_gradients_match(reference):
    cfg = C.port_cfg(ARCH)
    tree = reference["params"]
    st = from_jax_params(tree, cfg)
    mtp = {k for k in st if k.startswith("mtp.")}
    assert {"mtp.proj", "mtp.norm.scale", "mtp.block.attn.wkv_a",
            "mtp.block.ffn.wi"} <= mtp
    np.testing.assert_array_equal(st["mtp.proj"], tree["mtp"]["proj"])
    np.testing.assert_array_equal(st["mtp.block.attn.wq_b"],
                                  tree["mtp"]["block"]["attn"]["wq_b"])
    own = Model(cfg, device="cpu", dtype=torch.float32)
    own.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.params.state_dict().items()} \
        == {k: v.shape for k, v in st.items()}
    # the loss and its three parts
    m = _model(tree)
    loss, grads = C.loss_and_grads(m, remat=True)
    with torch.no_grad():
        plain = float(m.loss_fn(remat=False)(*C.batch()))
        no_mtp = float(_model(tree, dataclasses.replace(cfg, mtp_depth=0))
                       .loss_fn()(*C.batch()))
        no_aux = float(_model(tree, C.port_cfg(ARCH, router_aux_coef=0.0))
                       .loss_fn()(*C.batch()))
    assert abs(loss - reference["loss"]) <= C.LOSS_TOL
    assert abs(plain - reference["loss"]) <= C.LOSS_TOL
    mtp_term, ref_mtp = loss - no_mtp, reference["loss"] - reference[
        "loss_no_mtp"]
    assert ref_mtp > 100 * C.LOSS_TOL       # the loss check sees the term
    assert abs(mtp_term - ref_mtp) <= C.LOSS_TOL, (mtp_term, ref_mtp)
    aux, ref_aux = loss - no_aux, reference["loss"] - reference[
        "loss_no_aux"]
    assert ref_aux > 0 and abs(aux - ref_aux) <= C.AUX_TOL, (aux, ref_aux)
    want = from_jax_params(reference["grads"], cfg)
    assert set(grads) == set(want) and mtp <= set(grads)
    for name, g in grads.items():
        scale = float(np.abs(want[name]).max())
        assert scale > 0, name                 # every leaf gets a gradient
        C.close(g, want[name], C.GRAD_TOL * scale, name)


def test_trainer_steps_match_reference(reference, port_trained):
    runs, _ = port_trained
    cfg = C.port_cfg(ARCH)
    got, tref = runs["none"], reference["trained"]
    np.testing.assert_allclose(got["losses"], tref["losses"], rtol=0,
                               atol=C.LOSS_TOL * 10)
    assert tref["losses"][-1] < tref["losses"][0]
    g1 = from_jax_params(reference["grad_step1"], cfg)
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


def test_checkpoint_roundtrip(port_trained):
    from repro_torch.training.checkpoint import read_checkpoint
    runs, ck = port_trained
    step, trees, _ = read_checkpoint(ck)
    assert step == C.STEPS and "mtp.proj" in trees["params"]
    back = C.loaded(Model(C.port_cfg(ARCH), device="cpu",
                          dtype=torch.float32), ck)
    assert back["step"] == C.STEPS
    for tree in ("params", "m", "v"):
        for name, a in runs["none"][tree].items():
            assert np.array_equal(back[tree][name], a), (tree, name)


def test_check_trainable_refuses_only_items_4_4_and_4_5():
    for arch in ("deepseek-v3-671b", "mamba2-1.3b", "qwen3-8b",
                 "qwen-30b-a3b", "llama4-maverick-400b-a17b"):
        m = Model(get_config(arch).reduced(), device="cpu",
                  dtype=torch.float32)
        T.check_trainable(m.cfg)
        m.loss_fn()
        Trainer(m)
    refused = {"recurrentgemma-9b": "item 4.4", "whisper-small": "item 4.5",
               "internvl2-2b": "item 4.5"}
    for arch, item in refused.items():
        m = Model(get_config(arch).reduced(), device="cpu",
                  dtype=torch.float32)
        with pytest.raises(NotImplementedError, match=item):
            m.loss_fn()
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            Trainer(m)
    # a soft cap alone is item 4.4's
    capped = dataclasses.replace(get_config("qwen3-8b").reduced(),
                                 logits_soft_cap=30.0)
    with pytest.raises(NotImplementedError, match="item 4.4"):
        T.check_trainable(capped)


def test_zero1_dims_match_reference():
    """ZeRO-1's dim of every leaf on dp rows is the reference's
    ``_zero1_dim`` of its spec: the MLA up projections' columns and O's
    rows name ``mla_tp_axes``, the SSD projections name tp and the per-head
    leaves the model group (``head_spec_entry``), the MTP head's proj
    nothing."""
    for arch in ("deepseek-v3-671b", "mamba2-1.3b"):
        for mesh_shape in ((2, 1, 1), (2, 2, 2)):
            _check_zero1_dims(arch, mesh_shape)


def _check_zero1_dims(arch, mesh_shape):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from conftest import make_mesh
    from repro.models.model import Model as JaxModel
    from repro.parallel import Layout as JaxLayout
    from repro.training.optimizer import _zero1_dim
    from repro_torch.convert import shard_tensor
    from repro_torch.parallel import Layout
    from repro_torch.training.optimizer import stack_index, zero1_slice
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
    npre, pat = len(cfg.prefix_layers), len(cfg.layer_pattern)
    cut = set()
    for name, t in full.items():
        zs = zero1_slice(name, shard_tensor(name, t, cfg, lay, 0).shape, cfg,
                         lay)
        parts = name.split(".")
        stacked = stack_index(name, cfg) is not None
        if parts[0] != "layers":
            leaf = name
        elif int(parts[1]) < npre:
            leaf = f"prefix.{parts[1]}.{'.'.join(parts[2:])}"
        else:
            leaf = f"body.s{(int(parts[1]) - npre) % pat}." \
                   + ".".join(parts[2:])
        want = _zero1_dim(specs[leaf], shapes[leaf].shape, lay.dp,
                          ("data",))
        got = (None if zs.kind == "whole" else 0 if zs.kind == "layer"
               else zs.dim + stacked)
        assert got == want, (arch, mesh_shape, name, zs, want)
        cut.add(zs.kind)
    assert cut - {"whole"}, (arch, mesh_shape, cut)
