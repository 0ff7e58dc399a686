"""mamba2's SSD training at world size 1, held to the reference on the CPU:
reduced mamba2-1.3b (SSD layers alone, the embedding tied to the head), in
fp32, the reference's ``init_params(key(0))`` through ``from_jax_params``,
tokens from a numpy seed.

* ``ssd_chunk_bwd_plain`` (the backward kernel's plain version) equals
  autograd through ``ssd_chunk_plain`` in fp64 within 1e-10 of each
  gradient's largest entry: b and c one group shared by the heads, over
  several chunks and over one chunk shorter than L; and ``ops.ssd_chunk``
  while autograd records (``SSDChunk``) gives the same gradients;
* the loss equals the reference's ``loss_body`` and every gradient its
  ``jax.grad``'s, the tied table's (embedding and head) included;
* three ``Trainer`` steps (microbatch 2, remat) equal the reference
  Trainer's, params and moments, the first step's gradients as the
  per-parameter hooks summed them (the tied table's once per backward);
  with int8 compression they are bitwise the uncompressed ones (one
  rank);
* a checkpoint round trip restores the trained params and moments
  bitwise, and a tied tree holds no ``lm_head``.

Tolerances in ``moe_train_common`` (loss 1e-5; gradients 1e-4 of each
leaf's largest entry; params and moments after three steps 5e-4); the
fp64 check is 1e-10 of each gradient's largest entry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import moe_train_common as C  # noqa: E402
from repro_torch.convert import (from_jax_opt_state,  # noqa: E402
                                 from_jax_params)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels.ssd_chunk_bwd import ssd_chunk_bwd_plain  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ARCH = "mamba2-1.3b"


@pytest.mark.parametrize("B,S,H,hd,ds,L", [(2, 24, 3, 8, 12, 8),
                                           (1, 5, 2, 16, 8, 5)],
                         ids=["chunks", "short"])
def test_ssd_chunk_bwd_plain_matches_fp64_autograd(B, S, H, hd, ds, L):
    f64 = torch.float64
    rng = np.random.default_rng(S)
    x, b, c = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((B, S, H, hd), (B, S, ds), (B, S, ds)))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((B, S, H)))))
    A = torch.from_numpy(np.exp(rng.standard_normal(H)))
    cum = (-dt * A).reshape(B, S // L, L, H).cumsum(2).reshape(B, S, H)
    dt, cum = dt.requires_grad_(), cum.detach().requires_grad_()
    ins = (x, b, c, dt, cum)
    per_head = [t[:, :, None].expand(B, S, H, ds) for t in (b, c)]
    outs = SSD.ssd_chunk_plain(x, *per_head, dt, cum, L)
    cots = [torch.from_numpy(rng.standard_normal(o.shape)) for o in outs]
    assert all(o.dtype == f64 for o in outs)
    want = torch.autograd.grad(outs, ins, cots)
    got = ssd_chunk_bwd_plain(*(t.detach() for t in ins), *cots, L)
    fun = torch.autograd.grad(ops.ssd_chunk(*ins, L), ins, cots)
    for name, w, g, h in zip(("x", "b", "c", "dt", "cum"), want, got, fun):
        assert g.shape == w.shape and g.dtype == f64, name
        scale = float(w.abs().max())
        assert scale > 0, name
        assert float((g - w).abs().max()) <= 1e-10 * scale, name
        assert float((h - w).abs().max()) <= 1e-10 * scale, name


@pytest.fixture(scope="module")
def reference():
    import jax
    import jax.numpy as jnp
    from repro.models import build_model
    from repro.training import Trainer as JaxTrainer
    from repro.training.optimizer import AdamWConfig as JaxAdamW
    model = build_model(C.ref_cfg(ARCH), dtype=jnp.float32)
    params = model.init_params(jax.random.key(0))
    toks, labels = (jnp.asarray(a) for a in C.batch())
    lf = model.loss_fn()
    out = {"params": C.np_tree(params)}
    out["loss"] = float(lf(params, toks, labels))
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


def _model(params_tree):
    cfg = C.port_cfg(ARCH)
    m = Model(cfg, device="cpu", dtype=torch.float32)
    m.load_params(from_jax_params(params_tree, cfg))
    return m


@pytest.fixture(scope="module")
def port_trained(reference, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ssd") / "ck")
    runs = {comp: C.trained(_model(reference["params"]), comp,
                            ckpt=ck if comp == "none" else None)
            for comp in ("none", "int8")}
    return runs, ck


def test_loss_and_gradients_match_reference(reference):
    cfg = C.port_cfg(ARCH)
    assert cfg.tie_embeddings and set(cfg.layer_kinds) == {"ssd"}
    m = _model(reference["params"])
    assert not hasattr(m.params, "lm_head")
    loss, grads = C.loss_and_grads(m, remat=True)
    with torch.no_grad():
        plain = float(m.loss_fn(remat=False)(*C.batch()))
    assert abs(loss - reference["loss"]) <= C.LOSS_TOL
    assert abs(plain - reference["loss"]) <= C.LOSS_TOL
    want = from_jax_params(reference["grads"], cfg)
    assert set(grads) == set(want)
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
    # the hooks' sums: the tied table's gradient as embedding and as head,
    # each microbatch's once
    for name, g in got["grad_step1"].items():
        scale = float(np.abs(g1[name]).max())
        C.close(g, g1[name], C.GRAD_TOL * scale, ("grad_step1", name))
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
    assert step == C.STEPS and "embed.table" in trees["params"]
    assert not any(k.startswith("lm_head") for k in trees["params"])
    back = C.loaded(Model(C.port_cfg(ARCH), device="cpu",
                          dtype=torch.float32), ck)
    assert back["step"] == C.STEPS
    for tree in ("params", "m", "v"):
        for name, a in runs["none"][tree].items():
            assert np.array_equal(back[tree][name], a), (tree, name)
