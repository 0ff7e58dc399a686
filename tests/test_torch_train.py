"""Training of the port at world size 1, held to the reference on the CPU:
reduced qwen3-8b in fp32, the reference's ``init_params(key(0))``
through ``from_jax_params``, tokens from a numpy seed.

* the plain backward versions of the two kernels on the training path
  (flash attention, RMSNorm and the q/k pair) equal autograd through their
  plain forwards and ``jax.vjp`` of the reference's ``attend`` and
  ``layers.rmsnorm``;
* ``Model.loss_fn`` equals the reference's, with and without remat, and
  its gradients equal ``jax.grad``'s;
* three ``Trainer`` steps (microbatch 2, remat) equal the reference
  Trainer's, params and moments; with ``grad_compression="int8"`` the
  port's steps are bitwise the uncompressed ones (one rank: the reference's
  ``int8_compress_psum`` over no axes passes the gradient through);
* a checkpoint round-trips, and a reference checkpoint saved after two
  steps resumes in the port, whose next step equals the reference's;
* every other layer kind, frontend and head raises, naming the ROADMAP
  item (MoE trains since: ``tests/test_torch_train_moe*.py``).

Tolerances (fp32): loss 1e-5; gradients 1e-4 of each leaf's largest
entry; params and moments after three steps 5e-4 absolute, leaving out
the entries whose first-step gradient in the reference is below 1e-7
(Adam's first step there is lr·sign(g), which rounding can flip). JAX is
imported only inside fixtures and tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_opt_state, from_jax_params  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as FAB  # noqa: E402
from repro_torch.kernels import rmsnorm as RMS  # noqa: E402
from repro_torch.kernels import rmsnorm_bwd as RMSB  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training import Trainer  # noqa: E402
from repro_torch.training.checkpoint import (load_checkpoint, load_state,  # noqa: E402
                                             save_checkpoint)
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402

ARCH = "qwen3-8b"
B, S = 8, 16
LR = 1e-3
STEPS = 3
LOSS_TOL, GRAD_TOL, STEP_TOL, TINY = 1e-5, 1e-4, 5e-4, 1e-7


def _batch():
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:2, -1] = -1                 # uncounted positions
    return toks, labels


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from conftest import reduced_cfg
    from repro.models import build_model
    from repro.training import Trainer as JaxTrainer
    from repro.training import save_checkpoint as jax_save
    from repro.training.optimizer import AdamWConfig as JaxAdamW
    cfg = reduced_cfg(ARCH)
    model = build_model(cfg, dtype=jnp.float32)
    params = model.init_params(jax.random.key(0))
    toks, labels = (jnp.asarray(a) for a in _batch())
    out = {"params": _np_tree(params)}
    for remat in (True, False):
        out[f"loss_{remat}"] = float(model.loss_fn(remat=remat)(
            params, toks, labels))
    out["grads"] = _np_tree(jax.grad(model.loss_fn(remat=True))(
        params, toks, labels))
    # the first step's gradient: the mean of the two microbatches'
    lf = model.loss_fn(remat=True)
    g0 = [jax.grad(lf)(params, toks[i * 4:(i + 1) * 4],
                       labels[i * 4:(i + 1) * 4]) for i in range(2)]
    out["grad_step1"] = _np_tree(jax.tree.map(lambda a, b: (a + b) / 2,
                                              *g0))
    tr = JaxTrainer(model, JaxAdamW(lr=LR), microbatch=2, remat=True)
    opt = tr.init_opt_state(params)
    step = jax.jit(tr.wrapped(tr.opt_specs(jax.eval_shape(lambda: params))))
    p, o = params, opt
    losses = []
    for i in range(STEPS):
        p, o, loss = step(p, o, toks, labels)
        losses.append(float(loss))
        if i == STEPS - 2:
            ck = str(tmp_path_factory.mktemp("refck") / "ck")
            jax_save(ck, i + 1, p, o)
            from repro.training import load_checkpoint as jax_load
            _, pl, ol, _ = jax_load(ck, p, o)
            out["ck"] = {"params": _np_tree(pl), "opt": _np_tree(ol),
                         "step": i + 1}
    out["trained"] = {"params": _np_tree(p), "opt": _np_tree(o),
                      "losses": losses}
    return out


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------
def _cfg():
    return get_config(ARCH).reduced()


def _model(params_tree):
    m = Model(_cfg(), device="cpu", dtype=torch.float32)
    m.load_params(from_jax_params(params_tree, _cfg()))
    return m


def _close(got, want, tol, what, skip=None):
    """|got - want| <= tol everywhere (outside ``skip``); returns the
    number of entries left out."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    keep = np.ones(want.shape, bool) if skip is None else ~skip
    err = np.abs(got - want)[keep]
    assert err.size == 0 or err.max() <= tol, (what, float(err.max()), tol)
    return int((~keep).sum())


@pytest.fixture(scope="module")
def port_trained(reference):
    """Three port Trainer steps from the reference's weights, plain and
    int8, with the loss of each step."""
    out = {}
    for comp in ("none", "int8"):
        m = _model(reference["params"])
        tr = Trainer(m, AdamWConfig(lr=LR), microbatch=2, remat=True,
                     grad_compression=comp)
        opt = tr.init_opt_state()
        toks, labels = _batch()
        losses = []
        for _ in range(STEPS):
            opt, loss = tr.step(opt, toks, labels)
            losses.append(float(loss))
        out[comp] = {"params": {k: v.clone() for k, v in
                                m.params.state_dict().items()},
                     "opt": opt, "losses": losses}
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,sq,skv", [(True, 24, 24), (False, 9, 17)])
def test_flash_backward_plain_matches_autograd_and_jax(causal, sq, skv):
    import jax
    import jax.numpy as jnp
    from repro.models.attention_math import attend
    rng = np.random.default_rng(2)
    Bq, Hq, Hkv, D = 2, 4, 2, 16
    q, do = (rng.standard_normal((Bq, sq, Hq, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((Bq, skv, Hkv, D)).astype(np.float32)
            for _ in range(2))
    off = torch.zeros(Bq, dtype=torch.int32)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out, lse = FA.flash_attention_plain(tq, tk, tv, off, causal=causal,
                                        return_lse=True)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do))
    got = FAB.flash_attention_bwd_plain(tq.detach(), tk.detach(),
                                        tv.detach(), out.detach(), lse.detach(),
                                        torch.tensor(do), off, causal=causal)
    qpos = jnp.broadcast_to(jnp.arange(sq), (Bq, sq))
    _, vjp = jax.vjp(lambda a, b, c: attend(a, b, c, qpos, jnp.arange(skv),
                                            causal=causal), q, k, v)
    ref = vjp(jnp.asarray(do))
    for g, a, r, name in zip(got, auto, ref, "qkv"):
        scale = float(np.abs(np.asarray(r)).max())
        _close(g.numpy(), a.numpy(), GRAD_TOL * scale, f"d{name} vs autograd")
        _close(g.numpy(), np.asarray(r), GRAD_TOL * scale, f"d{name} vs jax")


@pytest.mark.parametrize("case", ["rows", "grouped", "pair"])
def test_rmsnorm_backward_plain_matches_autograd_and_jax(case):
    import jax
    import jax.numpy as jnp
    from repro.models.layers import rmsnorm as jax_rmsnorm
    rng = np.random.default_rng(3)
    shapes = {"rows": ((6, 5, 32), (32,)), "grouped": ((6, 5, 4, 16), (4, 16)),
              "pair": ((6, 5, 16), (16,))}
    xs, ss = shapes[case]
    x, dy = (rng.standard_normal(xs).astype(np.float32) for _ in range(2))
    s = rng.standard_normal(ss).astype(np.float32)
    if case == "pair":
        k, dk = (rng.standard_normal((6, 5, 2, 16)).astype(np.float32)
                 for _ in range(2))
        ks = rng.standard_normal((16,)).astype(np.float32)
        got = RMSB.rmsnorm_pair_bwd_plain(*map(torch.tensor, (x, s, dy, k,
                                                             ks, dk)))
        ins = [torch.tensor(a, requires_grad=True) for a in (x, s, k, ks)]
        yq, yk = RMS.rmsnorm_pair_plain(*ins)
        auto = torch.autograd.grad((yq, yk), ins,
                                   (torch.tensor(dy), torch.tensor(dk)))
        refs = []
        for a, sc, g in ((x, s, dy), (k, ks, dk)):
            _, vjp = jax.vjp(lambda a_, s_: jax_rmsnorm({"scale": s_}, a_),
                             a, sc)
            refs += list(vjp(jnp.asarray(g)))
    else:
        got = RMSB.rmsnorm_bwd_plain(torch.tensor(x), torch.tensor(s),
                                     torch.tensor(dy))
        ins = [torch.tensor(a, requires_grad=True) for a in (x, s)]
        auto = torch.autograd.grad(RMS.rmsnorm_plain(*ins), ins,
                                   torch.tensor(dy))
        _, vjp = jax.vjp(lambda a_, s_: jax_rmsnorm({"scale": s_}, a_), x, s)
        refs = list(vjp(jnp.asarray(dy)))
    for g, a, r in zip(got, auto, refs):
        scale = float(np.abs(np.asarray(r)).max())
        _close(g.numpy(), a.numpy(), GRAD_TOL * scale, f"{case} autograd")
        _close(g.numpy(), np.asarray(r), GRAD_TOL * scale, f"{case} jax")


@pytest.mark.parametrize("remat", [True, False])
def test_loss_matches_reference(reference, remat):
    m = _model(reference["params"])
    loss = m.loss_fn(remat=remat)(*_batch())
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - reference[f"loss_{remat}"]) <= LOSS_TOL


def test_gradients_match_reference(reference):
    m = _model(reference["params"])
    want = from_jax_params(reference["grads"], _cfg())
    with m.trainable() as named:
        m.loss_fn(remat=True)(*_batch()).backward()
        got = {k: p.grad.clone() for k, p in named.items()}
    assert all(not p.requires_grad and p.grad is None
               for p in m.params.parameters())
    assert set(got) == set(want)
    for name, g in got.items():
        scale = float(np.abs(want[name]).max())
        _close(g.numpy(), want[name], GRAD_TOL * max(scale, 1e-30), name)


def test_trainer_matches_reference(reference, port_trained):
    """Three steps with microbatch 2 and remat: params, moments and the
    step count equal the reference's; the losses too, and they fall."""
    cfg = _cfg()
    ref = reference["trained"]
    g1 = from_jax_params(reference["grad_step1"], cfg)
    want_p = from_jax_params(ref["params"], cfg)
    want_o = from_jax_opt_state(ref["opt"], cfg)
    got = port_trained["none"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0,
                               atol=LOSS_TOL * 10)
    assert ref["losses"][-1] < ref["losses"][0]
    assert got["opt"]["step"] == want_o["step"] == STEPS
    skipped = 0
    for name, p in got["params"].items():
        tiny = np.abs(g1[name]) < TINY
        skipped += _close(p.numpy(), want_p[name], STEP_TOL, name, tiny)
        for tree in ("m", "v"):
            _close(got["opt"][tree][name].numpy(), want_o[tree][name],
                   STEP_TOL, f"{tree}|{name}", tiny)
    total = sum(a.size for a in g1.values())
    # the embedding rows of tokens absent from the batch get no gradient
    print(f"entries left out (first-step |g| < {TINY}): {skipped} of {total}")


def test_int8_world_one_is_bitwise_uncompressed(port_trained):
    """On one rank the compression has no axes: the gradient passes
    through in fp32 and the error feedback stays zero, so the steps are
    bitwise the uncompressed ones."""
    a, b = port_trained["none"], port_trained["int8"]
    assert a["losses"] == b["losses"]
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
        assert torch.equal(a["opt"]["m"][name], b["opt"]["m"][name]), name
        assert not b["opt"]["err"][name].any()


def test_checkpoint_roundtrip(reference, port_trained, tmp_path):
    src = port_trained["int8"]
    m = _model(reference["params"])
    m.load_params(src["params"])
    path = save_checkpoint(str(tmp_path / "ck"), STEPS, m, src["opt"],
                           extra={"note": "x"})
    fresh = _model(reference["params"])
    step, opt, extra = load_checkpoint(path, fresh)
    assert step == STEPS and extra == {"note": "x"}
    for name, p in fresh.params.state_dict().items():
        assert torch.equal(p, src["params"][name]), name
        for tree in ("m", "v", "err"):
            assert torch.equal(opt[tree][name], src["opt"][tree][name]), \
                (tree, name)


def test_reference_checkpoint_resumes(reference):
    """The reference's checkpoint after two steps, converted
    (``from_jax_params``, ``from_jax_opt_state``), resumes in the port:
    its third step equals the reference's."""
    cfg = _cfg()
    ck = reference["ck"]
    trees = {"params": from_jax_params(ck["params"], cfg),
             **from_jax_opt_state(ck["opt"], cfg)}
    m = Model(cfg, device="cpu", dtype=torch.float32)
    opt = load_state(m, trees, trees.pop("step"))
    assert opt["step"] == ck["step"]
    tr = Trainer(m, AdamWConfig(lr=LR), microbatch=2, remat=True)
    opt, loss = tr.step(opt, *_batch())
    ref = reference["trained"]
    assert abs(float(loss) - ref["losses"][-1]) <= LOSS_TOL * 10
    want = from_jax_params(ref["params"], cfg)
    g1 = from_jax_params(reference["grad_step1"], cfg)
    for name, p in m.params.state_dict().items():
        _close(p.numpy(), want[name], STEP_TOL, name,
               np.abs(g1[name]) < TINY)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "deepseek-v3-671b",
                                  "recurrentgemma-9b", "whisper-small",
                                  "internvl2-2b"])
def test_other_stacks_raise_naming_the_roadmap(arch):
    """The stacks whose training is not ported raise, naming ROADMAP Queue
    1 item 4; mamba2-1.3b (item 4.3) and deepseek-v3-671b (item 4.2) train
    now (``tests/test_torch_train_ssd*.py``, ``test_torch_train_mla*.py``)
    and build their loss and Trainer."""
    m = Model(get_config(arch).reduced(), device="cpu", dtype=torch.float32)
    if arch in ("mamba2-1.3b", "deepseek-v3-671b"):
        assert callable(m.loss_fn())
        Trainer(m)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
        m.loss_fn()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(m)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internlm2-1.8b"])
def test_other_dense_stacks_train(arch):
    """qwen2-1.5b (qkv bias, tied head) and internlm2-1.8b: the loss of
    the port equals the reference's and one step lowers it."""
    import jax
    import jax.numpy as jnp
    from conftest import reduced_cfg
    from repro.models import build_model
    jm = build_model(reduced_cfg(arch), dtype=jnp.float32)
    params = jm.init_params(jax.random.key(0))
    toks, labels = _batch()
    want = float(jm.loss_fn()(params, jnp.asarray(toks), jnp.asarray(labels)))
    cfg = get_config(arch).reduced()
    m = Model(cfg, device="cpu", dtype=torch.float32)
    m.load_params(from_jax_params(_np_tree(params), cfg))
    assert abs(float(m.loss_fn()(toks, labels)) - want) <= LOSS_TOL
    tr = Trainer(m, AdamWConfig(lr=LR))
    opt = tr.init_opt_state()
    opt, l0 = tr.step(opt, toks, labels)
    opt, l1 = tr.step(opt, toks, labels)
    assert float(l1) < float(l0)
