"""MoE training of the port on (sp, tp) = (2, 2), the a2a path: reduced
qwen-30b-a3b's 4 experts over ``"sp"`` (2 a rank) and their FF dim over
``"tp"``, the dispatch and the return exchanged by tiled all-to-alls over
the SP group. Four CPU ranks over gloo, one job, held to the reference's
``shard_map`` on ``mesh122`` device by device, in fp32 at capacity factor
1.25.

* every rank's routing equals the reference's on the same tokens, and
  every rank's loss (remat on and off; the aux summed over sp and halved,
  as the reference's) equals its device's;
* every rank's gradients, the router's and the experts' included, equal
  its device's, with the plain dispatch and with the int8 dispatch (whose
  tokens get a gradient only through the per-row scale: ``round`` and the
  cast to int8 pass none, in JAX as in torch); remat recomputes every
  layer's exchanges in the backward;
* three ``Trainer`` steps (microbatch 2, remat), with and without int8
  gradient compression: every rank's params and moments equal its
  device's;
* the reference's (dp, sp) gradient sum adds the gradients of different
  experts: an sp rank's expert stack holds experts 2i and 2i+1, and after
  the sum rank (0, j)'s gradient of its experts 0-1 is its own plus rank
  (1, j)'s gradient of experts 2-3. The port's Trainer sums the same
  (ROADMAP Queue 3, behaviours of the reference that the port copies);
* a checkpoint saved after the three steps (the expert stacks put
  together from every model rank) loads back on (1, 2, 2) and, resharded,
  on one rank.

Tolerances in ``moe_train_common``. JAX is imported only in this process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import moe_train_common as C  # noqa: E402
from repro_torch.convert import from_jax_params, shard_state  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.moe import expert_grid  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402

ARCH = "qwen-30b-a3b"
SP, TP = 2, 2
COMPRESSION = ("none", "int8")
EXPERT_LEAVES = ("ffn.wi", "ffn.wg", "ffn.wo")


def _model(state, groups, **moe):
    cfg, lay = C.port_cfg(ARCH, **moe), Layout(sp=SP, tp=TP)
    m = Model(cfg, device="cpu", dtype=torch.float32, lay=lay, groups=groups)
    m.load_params(shard_state(state, cfg, lay, groups.rank))
    return m


def _job(rank, groups, state, ckpt):
    out = {}
    m = _model(state, groups)
    with C.routes_logged() as log, torch.no_grad():
        m.loss_fn(remat=False)(*C.batch())
    out["routes"] = log
    for remat in (True, False):
        before = groups.traffic["all_to_all_calls"]
        out[f"loss_{remat}"], g = C.loss_and_grads(m, remat=remat)
        out[f"a2a_calls_{remat}"] = groups.traffic["all_to_all_calls"] \
            - before
        if remat:
            out["grads"] = g
    out["loss_int8"], out["grads_int8"] = C.loss_and_grads(
        _model(state, groups, dispatch_dtype="int8"))
    for comp in COMPRESSION:
        out[comp] = C.trained(_model(state, groups), comp,
                              ckpt=ckpt if comp == "none" else None)
    out["loaded"] = C.loaded(Model(
        C.port_cfg(ARCH), device="cpu", dtype=torch.float32,
        lay=Layout(sp=SP, tp=TP), groups=groups), ckpt)
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return str(tmp_path_factory.mktemp("moe_a2a") / "ck")


@pytest.fixture(scope="module")
def ranks(ckpt):
    """The one four-rank job of this module."""
    return mesh.run_ranks(_job, SP, TP, device="cpu", backend="gloo",
                          timeout_s=300, args=(C.ref_state(ARCH), ckpt))


@pytest.fixture(scope="module")
def reference(mesh122):
    out = C.ref_on_mesh(ARCH, mesh122, COMPRESSION)
    int8 = C.ref_on_mesh(ARCH, mesh122, (), dispatch_dtype="int8")
    out["loss_int8"] = int8["loss_True"]
    out["grads_int8"] = int8["grads"]
    return out


def test_routing_loss_and_gradients_per_rank(ranks, reference):
    """Plain and int8 dispatch. Per layer the forward's two exchanges, again
    in the recomputation, and the two of the backward, plus the
    attention's Ulysses exchanges (two forward, two backward, two
    recomputed)."""
    cfg = C.port_cfg(ARCH)
    gap = np.inf
    for r, res in enumerate(ranks):
        assert len(res["routes"]) == cfg.num_layers, r
        gap = min(gap, C.check_routes(res["routes"], C.ref_cfg(ARCH)))
    C.check_loss_per_rank(ranks, reference,
                          ("loss_True", "loss_False", "loss_int8"))
    # the int8 dispatch quantizes: another loss
    assert ranks[0]["loss_int8"] != ranks[0]["loss_True"]
    C.check_grads_per_rank(ranks, reference, cfg, gap=gap)
    C.check_grads_per_rank(ranks, reference, cfg, key="grads_int8", gap=gap)
    L = cfg.num_layers
    for res in ranks:
        assert res["a2a_calls_False"] == 4 * L + 4 * L
        assert res["a2a_calls_True"] == 6 * L + 6 * L
        # the int8 dispatch's token gradient flows through the scales alone,
        # so the experts' and the router's gradients differ from the plain
        # dispatch's, and the tokens still reach the layers below
        for name in ("layers.0.ffn.wi", "layers.0.attn.wq"):
            assert not np.allclose(res["grads_int8"][name],
                                   res["grads"][name]), name


@pytest.mark.parametrize("comp", COMPRESSION)
def test_trainer_steps_per_rank(ranks, reference, comp):
    """With int8 compression the first step's reduced gradients equal the
    reference's but for entries rounded apart at a tie (one quantum each);
    on this seed two such ties on the sp ranks of tp rank 0 move one
    weight each by ~lr after three steps (the test prints them)."""
    cfg = C.port_cfg(ARCH)
    if comp == "int8":
        C.check_int8_first_step(ranks, reference, cfg)
    left, total = C.check_steps_per_rank(ranks, reference, cfg, comp)
    assert left < total // 5


def test_reference_sums_different_experts_over_sp(ranks, reference):
    """On (1, 2, 2) the reference's Trainer psums every leaf over
    ``("data", "sp")``, the expert stacks that EP shards over ``"sp"``
    included: rank (0, j) holds experts 0-1 and rank (1, j) experts 2-3 of
    the same FF block, and each ends up with the sum of both ranks' local
    gradients. The port's Trainer hands ``adamw_update`` the same sum."""
    cfg, lay = C.port_cfg(ARCH), Layout(sp=SP, tp=TP)
    local = reference["grad_step1_local"]
    summed = reference["grad_step1"]
    for r in range(SP * TP):
        partner = (r + TP) % (SP * TP)             # the other sp rank
        ep, e, tpr, t = expert_grid(cfg, lay, r)
        assert (ep, tpr) == (SP, TP)
        assert expert_grid(cfg, lay, partner)[1:] == (1 - e, tpr, t)
        own = from_jax_params(local[r], cfg)
        other = from_jax_params(local[partner], cfg)
        want = from_jax_params(summed[r], cfg)
        port = ranks[r]["none"]["grad_step1"]
        for name in want:
            if not name.endswith(EXPERT_LEAVES):
                continue
            scale = float(np.abs(want[name]).max())
            # the sum is this rank's experts' gradient plus the partner's
            # gradient of other experts, which is not small
            C.close(want[name], own[name] + other[name], 1e-6 * scale, name)
            assert np.abs(other[name]).max() > 0.1 * np.abs(own[name]).max()
            C.close(port[name], want[name], C.GRAD_TOL * scale, (r, name))


def test_checkpoint_roundtrip_with_reshard(ranks, ckpt):
    C.check_checkpoint(ranks, ckpt, C.port_cfg(ARCH), Layout(sp=SP, tp=TP))
