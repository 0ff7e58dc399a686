"""MLA training with DeepSeek-V3's MTP head on (sp, tp) = (2, 2): reduced
deepseek-v3-671b in fp32 at capacity factor 1.25, four CPU ranks over gloo
in one job, held to the reference's ``shard_map`` on ``mesh122`` device by
device. On the base config the MLA latent of a rank's columns is
all-gathered over SP (``all_gather_axis``, whose backward is the
reduce-scatter), the heads are cut over the grid's tp.

* every rank's loss (remat on and off) and gradients, the MTP head's
  included, equal its device's;
* the MTP label shift is local: the reference shifts the labels inside the
  rank's segment of columns, so each sp segment's last column is not
  counted. The MTP term (the loss less the loss of the tree without
  ``mtp``) of every rank equals its device's and differs from the term on
  one rank, where only the sequence's last column drops (ROADMAP Queue 3,
  behaviours of the reference that the port copies);
* three ``Trainer`` steps (microbatch 2, remat), plain and with int8
  gradient compression: every rank's params and moments equal its
  device's;
* a checkpoint saved after the steps (the MLA heads put back together from
  the grid's tp ranks, the pad heads dropped) loads back on (1, 2, 2) and,
  resharded, on one rank;
* ``reshard_params`` moves the MLA weights (and every other leaf) bitwise
  from the base config to its shift config and to (1, 4), and back.

Tolerances in ``moe_train_common``. JAX is imported only in this process.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import moe_train_common as C  # noqa: E402
from repro_torch.convert import shard_state  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402

ARCH = "deepseek-v3-671b"
SP, TP = 2, 2
COMPRESSION = ("none", "int8")
# With int8 compression this stack's first reduction rounds 9 to 17 entries
# a rank apart at a tie (FLIPS, 8, holds the MoE stacks), and after three
# steps 8 to 12 weights a rank lie more than STEP_TOL (at most 2 lr) from
# the reference's, the many others within it moving the later losses by up
# to 1.9e-4: the steps are held with twice FLIPS and the losses with the
# first-order drift of the params' differences (``check_steps_per_rank``'s
# ``flip_drift``). In an fp64 copy of both packages the params after the
# three int8 steps agree within 2.2e-16 (``tools/moe_fp64_check.py --arch
# deepseek-v3-671b --mesh 1 2 2``): the fp32 gap is rounding.
INT8_FLIPS = 2 * C.FLIPS


def _model(state, groups, lay=None, cfg=None):
    cfg, lay = cfg or C.port_cfg(ARCH), lay or Layout(sp=SP, tp=TP)
    m = Model(cfg, device="cpu", dtype=torch.float32, lay=lay, groups=groups)
    if not cfg.mtp_depth:
        state = {k: v for k, v in state.items() if not k.startswith("mtp.")}
    m.load_params(shard_state(state, cfg, lay, groups.rank))
    return m


def _state_np(m):
    return {k: v.numpy().copy() for k, v in m.params.state_dict().items()}


def _job(rank, groups, state, ckpt):
    from repro_torch.ft import reshard_params
    from repro_torch.parallel import Groups
    groups14 = Groups(1, 4)
    out = {}
    m = _model(state, groups)
    for remat in (True, False):
        out[f"loss_{remat}"], g = C.loss_and_grads(m, remat=remat)
        if remat:
            out["grads"] = g
    with torch.no_grad():
        no_mtp = dataclasses.replace(C.port_cfg(ARCH), mtp_depth=0)
        out["loss_no_mtp"] = float(_model(state, groups, cfg=no_mtp)
                                   .loss_fn()(*C.batch()))
    for comp in COMPRESSION:
        out[comp] = C.trained(_model(state, groups), comp,
                              ckpt=ckpt if comp == "none" else None)
    out["loaded"] = C.loaded(Model(
        C.port_cfg(ARCH), device="cpu", dtype=torch.float32,
        lay=Layout(sp=SP, tp=TP), groups=groups), ckpt)
    # reshard: base -> shift -> base, base -> (1, 4) -> base
    cfg, lay = C.port_cfg(ARCH), Layout(sp=SP, tp=TP)
    a = _model(state, groups)

    def fresh(lay_, groups_):
        return Model(cfg, device="cpu", dtype=torch.float32, lay=lay_,
                     groups=groups_)
    shift = reshard_params(a, fresh(lay.to_shift(), groups))
    wide = reshard_params(a, fresh(Layout(tp=4), groups14))
    out["reshard"] = {
        "shift": _state_np(shift), "wide": _state_np(wide),
        "back": _state_np(reshard_params(shift, fresh(lay, groups))),
        "back_wide": _state_np(reshard_params(wide, fresh(lay, groups))),
        "base": _state_np(a)}
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mla_layout") / "ck")


@pytest.fixture(scope="module")
def state():
    return C.ref_state(ARCH)


@pytest.fixture(scope="module")
def ranks(state, ckpt):
    """The one four-rank job of this module."""
    return mesh.run_ranks(_job, SP, TP, device="cpu", backend="gloo",
                          timeout_s=400, args=(state, ckpt))


@pytest.fixture(scope="module")
def reference(mesh122):
    return C.ref_on_mesh(ARCH, mesh122, COMPRESSION, no_mtp=True)


def test_loss_gradients_and_local_mtp_shift_per_rank(ranks, reference,
                                                      state):
    cfg = C.port_cfg(ARCH)
    C.check_loss_per_rank(ranks, reference)
    C.check_grads_per_rank(ranks, reference, cfg)
    assert any(k.startswith("mtp.") for k in ranks[0]["grads"])
    # the MTP term: each rank's is its device's, and differs from one
    # rank's, whose shift drops only the sequence's last column
    one = Model(cfg, device="cpu", dtype=torch.float32)
    one.load_params(state)
    no = Model(dataclasses.replace(cfg, mtp_depth=0), device="cpu",
               dtype=torch.float32)
    no.load_params({k: v for k, v in state.items()
                    if not k.startswith("mtp.")})
    with torch.no_grad():
        term_one = float(one.loss_fn()(*C.batch())) \
            - float(no.loss_fn()(*C.batch()))
    for r, res in enumerate(ranks):
        term = res["loss_True"] - res["loss_no_mtp"]
        want = reference["loss_True"][r] - reference["loss_no_mtp"][r]
        assert abs(term - want) <= C.LOSS_TOL, (r, term, want)
        assert abs(term - term_one) > 100 * C.LOSS_TOL, (r, term, term_one)


@pytest.mark.parametrize("comp", COMPRESSION)
def test_trainer_steps_per_rank(ranks, reference, comp):
    cfg = C.port_cfg(ARCH)
    kw = {}
    if comp == "int8":
        C.check_int8_first_step(ranks, reference, cfg)
        kw = {"flips_max": INT8_FLIPS, "flip_drift": True}
    left, total = C.check_steps_per_rank(ranks, reference, cfg, comp, **kw)
    assert left < total // 5


def test_checkpoint_roundtrip_with_reshard(ranks, ckpt):
    C.check_checkpoint(ranks, ckpt, C.port_cfg(ARCH), Layout(sp=SP, tp=TP))


def test_reshard_params_moves_mla_weights(ranks, state):
    """Each rank's weights after a reshard are its shard of the new
    layout, bitwise, and a reshard back gives the base weights again."""
    cfg, lay = C.port_cfg(ARCH), Layout(sp=SP, tp=TP)
    for r, res in enumerate(ranks):
        rs = res["reshard"]
        for key, new in (("shift", lay.to_shift()), ("wide", Layout(tp=4))):
            want = shard_state(state, cfg, new, r)
            for name, a in rs[key].items():
                assert np.array_equal(a, want[name]), (r, key, name)
        for key in ("back", "back_wide"):
            for name, a in rs[key].items():
                assert np.array_equal(a, rs["base"][name]), (r, key, name)
        assert any(".attn.wq_b" in n for n in rs["base"])
