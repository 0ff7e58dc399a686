"""MoE training of the port on (sp, tp) = (1, 2), the replicated path:
reduced qwen-30b-a3b's 4 experts over ``"tp"`` (2 a rank, each whole),
every rank routing the same tokens, slicing its experts from the dispatch
buffer and combining by a psum over the model group. Two CPU ranks over
gloo, one job, held to the reference's ``shard_map`` on ``make_mesh((1,
1, 2))`` device by device, in fp32 at capacity factor 1.25.

* every rank's routing equals the reference's on the same tokens, and its
  loss (remat on and off) equals its device's;
* every rank's gradients, the router's and the experts' included, equal
  its device's (the psum's transpose is a psum, so each rank's router
  gradient is the reference device's, not the single-device one);
* three ``Trainer`` steps (microbatch 2, remat), with and without int8
  gradient compression: every rank's params and moments equal its
  device's. The (dp, sp) group is one rank, but the reference's mesh
  names its axes, and it quantizes (with error feedback) where its psum
  over them is the identity: the port's int8 steps do the same, and differ
  from the uncompressed ones.

Tolerances in ``moe_train_common``. JAX is imported only in this process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import moe_train_common as C  # noqa: E402
from conftest import make_mesh  # noqa: E402
from repro_torch.convert import shard_state  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.moe import ep_group  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402

ARCH = "qwen-30b-a3b"
SP, TP = 1, 2
COMPRESSION = ("none", "int8")


def _job(rank, groups, state):
    cfg, lay = C.port_cfg(ARCH), Layout(sp=SP, tp=TP)

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
    before = dict(groups.traffic)
    out["loss_True"], out["grads"] = C.loss_and_grads(m, remat=True)
    out["a2a_calls"] = groups.traffic["all_to_all_calls"] \
        - before.get("all_to_all_calls", 0)
    for comp in COMPRESSION:
        out[comp] = C.trained(model(), comp)
    return out


@pytest.fixture(scope="module")
def ranks():
    """The one two-rank job of this module."""
    return mesh.run_ranks(_job, SP, TP, device="cpu", backend="gloo",
                          timeout_s=240, args=(C.ref_state(ARCH),))


@pytest.fixture(scope="module")
def reference():
    return C.ref_on_mesh(ARCH, make_mesh((1, SP, TP)), COMPRESSION)


def test_routing_loss_and_gradients_per_rank(ranks, reference):
    cfg = C.port_cfg(ARCH)
    assert ep_group(Layout(sp=SP, tp=TP), cfg.moe.num_experts, False) \
        == (("tp",), True)
    gap = np.inf
    for res in ranks:
        gap = min(gap, C.check_routes(res["routes"], C.ref_cfg(ARCH)))
        assert res["a2a_calls"] == 0          # no exchange on this path
    C.check_loss_per_rank(ranks, reference)
    C.check_grads_per_rank(ranks, reference, cfg, gap=gap)
    # each rank routes every token, and its router gradient is its
    # device's: the two ranks' differ
    r0, r1 = (res["grads"]["layers.0.ffn.router"] for res in ranks)
    assert not np.allclose(r0, r1)


@pytest.mark.parametrize("comp", COMPRESSION)
def test_trainer_steps_per_rank(ranks, reference, comp):
    cfg = C.port_cfg(ARCH)
    if comp == "int8":
        C.check_int8_first_step(ranks, reference, cfg)
        for res in ranks:
            assert not np.array_equal(res["int8"]["params"]["lm_head.w"],
                                      res["none"]["params"]["lm_head.w"])
    left, total = C.check_steps_per_rank(ranks, reference, cfg, comp)
    assert left < total // 5
