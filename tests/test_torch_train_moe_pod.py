"""MoE training of the port at pod scale: reduced llama4-17b-16e (top-1 of
4 experts, shared experts) on (dp, sp, tp) = (2, 2, 2), its EP group over
``("data", "sp")`` so that each rank holds one expert's FF block and the
dispatch all-to-all runs across dp rows. Eight CPU ranks over gloo, one
job, held to the reference's ``shard_map`` on ``mesh222`` device by
device, in fp32 at capacity factor 1.25.

* every rank's routing equals the reference's on the same tokens, its
  loss (remat on and off) and its gradients equal its device's;
* three ``Trainer`` steps (microbatch 2, remat), with and without int8
  gradient compression: every rank's params and ZeRO-1 moment slices
  equal its device's. The expert stacks, already sharded over
  ``"data"``, get no ZeRO dim (``training.optimizer.zero1_slice``, the
  reference's ``_zero1_dim`` rule): each rank keeps their whole moments,
  while the other leaves are cut over the dp rows;
* a checkpoint saved after the three steps holds the expert stacks put
  together from every rank of the world (``convert.unshard_ranks``); it
  loads back on (2, 2, 2) and, resharded, on one rank; and
  ``reshard_params`` moves the trained weights onto the shift config.

llama4-17b-16e has no q/k norms, and on this layout its fp32 gradients
lie up to 1.85e-4 of a leaf's largest entry from the reference's (the
router's; 1.1e-4 elsewhere): they are held at ``NOISY_GRAD_TOL`` (3e-4)
of it, and the int8 reduction's ties with them. With both packages' fp32
casts made fp64 (``tools/moe_fp64_check.py``), every rank's gradients
agree within 1.2e-13 of each leaf's largest entry, and the int8 Trainer's
params after three steps within 4.4e-16: the fp32 gap is rounding, not a
fault (ROADMAP Queue 3). The other tolerances are ``moe_train_common``'s.
JAX is imported only in this process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import moe_train_common as C  # noqa: E402
from repro_torch.convert import (is_expert_leaf, shard_state,  # noqa: E402
                                 unshard_ranks)
from repro_torch.ft.elastic import reshard_params  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.moe import expert_axes  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402
from repro_torch.training.optimizer import (moment_slice,  # noqa: E402
                                            stack_index, zero1_slice)

ARCH = "llama4-17b-16e"
DP, SP, TP = 2, 2, 2
COMPRESSION = ("none", "int8")


def _lay():
    return Layout(dp=DP, sp=SP, tp=TP)


def _job(rank, groups, state, ckpt):
    cfg, lay = C.port_cfg(ARCH), _lay()

    def model():
        m = Model(cfg, device="cpu", dtype=torch.float32, lay=lay,
                  groups=groups)
        m.load_params(shard_state(state, cfg, lay, rank))
        return m
    m, out = model(), {}
    with C.routes_logged() as log, torch.no_grad():
        m.loss_fn(remat=False)(*C.batch())
    out["routes"] = log
    out["loss_False"], _ = C.loss_and_grads(m, remat=False)
    out["loss_True"], out["grads"] = C.loss_and_grads(m, remat=True)
    for comp in COMPRESSION:
        m = model()
        out[comp] = C.trained(m, comp, ckpt=ckpt if comp == "none" else None)
        if comp == "none":
            # the trained weights moved live onto the shift config, whose
            # EP group is ("data",)
            shift = Model(cfg, device="cpu", dtype=torch.float32,
                          lay=lay.to_shift(), groups=groups)
            out["resharded"] = C.np_dict(dict(
                reshard_params(m, shift).params.named_parameters()))
    fresh = Model(cfg, device="cpu", dtype=torch.float32, lay=lay,
                  groups=groups)
    out["loaded"] = C.loaded(fresh, ckpt)
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return str(tmp_path_factory.mktemp("moe_pod") / "ck")


@pytest.fixture(scope="module")
def ranks(ckpt):
    """The one eight-rank job of this module."""
    return mesh.run_ranks(_job, SP, TP, dp=DP, device="cpu", backend="gloo",
                          timeout_s=300, args=(C.ref_state(ARCH), ckpt))


@pytest.fixture(scope="module")
def reference(mesh222):
    return C.ref_on_mesh(ARCH, mesh222, COMPRESSION,
                         grad_tol=C.NOISY_GRAD_TOL)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _ref_moment(tree, name, skip, rank):
    """A device's moment of parameter ``name`` (the reference's per-device
    tree) as the port holds it on ``rank`` (its ZeRO-1 slice, or None), and
    ``skip`` cut the same way."""
    cfg, lay = C.port_cfg(ARCH), _lay()
    zs = zero1_slice(name, skip.shape, cfg, lay)
    d = lay.dp_rank(rank)
    part = moment_slice(name, torch.from_numpy(skip), zs, lay, d)
    skip = None if part is None else part.numpy()
    flat = _flat(tree)
    i = stack_index(name, cfg)
    if i is None:
        return flat[name], skip
    k = (int(name.split(".")[1]) - len(cfg.prefix_layers)) \
        % len(cfg.layer_pattern)
    local = flat[f"body.s{k}." + name.split(".", 2)[2]]
    if zs.kind == "layer":
        blk = cfg.pattern_repeats // DP
        j = i - d * blk
        return (local[j] if 0 <= j < blk else None), skip
    return local[i], skip


def test_routing_loss_and_gradients_per_rank(ranks, reference):
    cfg = C.port_cfg(ARCH)
    assert expert_axes(cfg, _lay()) == ("data", "sp")
    gap = np.inf
    for res in ranks:
        gap = min(gap, C.check_routes(res["routes"], C.ref_cfg(ARCH)))
    C.check_loss_per_rank(ranks, reference)
    C.check_grads_per_rank(ranks, reference, cfg, gap=gap,
                           tol=C.NOISY_GRAD_TOL)


@pytest.mark.parametrize("comp", COMPRESSION)
def test_trainer_steps_and_zero1_slices(ranks, reference, comp):
    cfg, lay = C.port_cfg(ARCH), _lay()
    if comp == "int8":
        C.check_int8_first_step(ranks, reference, cfg,
                                tol=C.NOISY_GRAD_TOL)
    left, total = C.check_steps_per_rank(ranks, reference, cfg, comp,
                                         ref_moment=_ref_moment)
    assert left < total // 5
    held = ranks[0][comp]
    for name, p in held["params"].items():
        zs = zero1_slice(name, p.shape, cfg, lay)
        if is_expert_leaf(name, cfg):
            # already over "data": no ZeRO dim, the whole local moment
            assert zs.kind == "whole", name
            assert held["m"][name].shape == p.shape, name
        elif name.startswith("layers."):
            # the two stacked layers' moments: one a dp row
            assert zs.kind == "layer", name
    assert held["m"]["layers.1.attn.wq"] is None
    assert ranks[SP * TP][comp]["m"]["layers.0.attn.wq"] is None
    assert held["m"]["final_norm.scale"].shape == (cfg.d_model // DP,)


def test_checkpoint_roundtrip_with_reshard(ranks, ckpt):
    """And ``ft.elastic.reshard_params`` moves the trained weights onto
    the shift config (2, 1, 4), gathering the expert stacks over the whole
    world: each rank then holds the checkpoint's shard on that layout,
    bitwise."""
    from repro_torch.training.checkpoint import read_checkpoint
    cfg, lay = C.port_cfg(ARCH), _lay()
    assert unshard_ranks("layers.0.ffn.wi", cfg, lay) == list(range(8))
    one = C.check_checkpoint(ranks, ckpt, cfg, lay)
    shift = lay.to_shift()
    assert expert_axes(cfg, shift) == ("data",)
    _, trees, _ = read_checkpoint(ckpt)
    for r, res in enumerate(ranks):
        want = shard_state(trees["params"], cfg, shift, r)
        for name, a in res["resharded"].items():
            np.testing.assert_array_equal(a, want[name], err_msg=f"{r} {name}")
    # the one-rank expert stack holds every rank's block
    w = one["layers.0.ffn.wi"]
    assert w.shape == (cfg.moe.num_experts, cfg.d_model,
                       cfg.moe.d_ff_expert)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(
            shard_state({"layers.0.ffn.wi": w}, cfg, lay, r)[
                "layers.0.ffn.wi"], res["none"]["params"]["layers.0.ffn.wi"])
