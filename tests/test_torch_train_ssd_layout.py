"""mamba2's SSD training on (sp, tp) = (2, 2): reduced mamba2-1.3b (8 heads,
2 a rank after the exchange; the model group of 4 divides them, so no
head is padded) in fp32, four CPU ranks over gloo in one job, held to the
reference's ``shard_map`` on ``mesh122`` device by device. The mixer's
projections are cut over tp, its per-head leaves (``dt_bias``, ``A_log``,
``D``, ``conv_x``, ``norm``) over the model group, and the Ulysses
all-to-all exchanges the sequence for the heads, forward and backward.

* every rank's loss (remat on and off) and gradients, the tied table's
  included, equal its device's;
* the reference's (dp, sp) gradient sum adds the gradients of different
  heads: the per-head leaves are cut over the model group (sp·tp), so
  rank (0, j)'s sum is its own heads' gradient plus rank (1, j)'s gradient
  of its other heads. The port's Trainer hands ``adamw_update`` the same
  sum (ROADMAP Queue 3, behaviours of the reference that the port
  copies);
* three ``Trainer`` steps (microbatch 2, remat), plain and with int8
  gradient compression: every rank's params and moments equal its
  device's.

Tolerances in ``moe_train_common``; the gradients are held within
NOISY_GRAD_TOL (3e-4) of each leaf's largest entry and within GRAD_TOL
(1e-4) of its norm: in fp32 the mixer's wbc lies 1.12e-4 of its largest
entry from the reference's, where an fp64 copy of both packages agrees
within 1.4e-13 (``tools/moe_fp64_check.py --arch mamba2-1.3b --mesh 1 2
2``). JAX is imported only in this process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import moe_train_common as C  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    from_jax_params, is_model_group_leaf, shard_state)
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402

ARCH = "mamba2-1.3b"
SP, TP = 2, 2
COMPRESSION = ("none", "int8")


def _model(state, groups):
    cfg, lay = C.port_cfg(ARCH), Layout(sp=SP, tp=TP)
    m = Model(cfg, device="cpu", dtype=torch.float32, lay=lay, groups=groups)
    m.load_params(shard_state(state, cfg, lay, groups.rank))
    return m


def _job(rank, groups, state):
    out = {}
    m = _model(state, groups)
    for remat in (True, False):
        before = groups.traffic["all_to_all_calls"]
        out[f"loss_{remat}"], g = C.loss_and_grads(m, remat=remat)
        out[f"a2a_calls_{remat}"] = groups.traffic["all_to_all_calls"] \
            - before
        if remat:
            out["grads"] = g
    for comp in COMPRESSION:
        out[comp] = C.trained(_model(state, groups), comp)
    return out


@pytest.fixture(scope="module")
def ranks():
    """The one four-rank job of this module."""
    return mesh.run_ranks(_job, SP, TP, device="cpu", backend="gloo",
                          timeout_s=300, args=(C.ref_state(ARCH),))


@pytest.fixture(scope="module")
def reference(mesh122):
    return C.ref_on_mesh(ARCH, mesh122, COMPRESSION)


def test_loss_and_gradients_per_rank(ranks, reference):
    """Per layer the forward's two exchanges (the heads out, then back),
    again in the recomputation, and the two of the backward."""
    cfg = C.port_cfg(ARCH)
    C.check_loss_per_rank(ranks, reference)
    C.check_grads_per_rank(ranks, reference, cfg, tol=C.NOISY_GRAD_TOL,
                           norm_tol=C.GRAD_TOL)
    L = cfg.num_layers
    for res in ranks:
        assert "embed.table" in res["grads"] and not any(
            k.startswith("lm_head") for k in res["grads"])
        assert res["a2a_calls_False"] == 4 * L
        assert res["a2a_calls_True"] == 6 * L


def test_reference_sums_different_heads_over_sp(ranks, reference):
    """On (1, 2, 2) the reference's Trainer psums every leaf over
    ``("data", "sp")``, the per-head leaves that the model group cuts
    included: rank (0, j) holds heads of model rank 2j and rank (1, j)
    those of model rank 2j + 1, and each ends up with the sum of both
    ranks' local gradients. The port's Trainer hands ``adamw_update`` the
    same sum."""
    cfg, lay = C.port_cfg(ARCH), Layout(sp=SP, tp=TP)
    local = reference["grad_step1_local"]
    summed = reference["grad_step1"]
    seen = 0
    for r in range(SP * TP):
        partner = (r + TP) % (SP * TP)             # the other sp rank
        assert lay.model_rank(partner) != lay.model_rank(r)
        own = from_jax_params(local[r], cfg)
        other = from_jax_params(local[partner], cfg)
        want = from_jax_params(summed[r], cfg)
        port = ranks[r]["none"]["grad_step1"]
        for name in want:
            if not is_model_group_leaf(name, cfg):
                continue
            seen += 1
            scale = float(np.abs(want[name]).max())
            # the sum is this rank's heads' gradient plus the partner's
            # gradient of other heads, which is not small
            C.close(want[name], own[name] + other[name], 1e-6 * scale, name)
            assert np.abs(other[name]).max() > 0.1 * np.abs(own[name]).max()
            C.close(port[name], want[name], C.GRAD_TOL * scale, (r, name))
    assert seen == SP * TP * cfg.num_layers * 5


@pytest.mark.parametrize("comp", COMPRESSION)
def test_trainer_steps_per_rank(ranks, reference, comp):
    cfg = C.port_cfg(ARCH)
    if comp == "int8":
        C.check_int8_first_step(ranks, reference, cfg)
    left, total = C.check_steps_per_rank(ranks, reference, cfg, comp)
    assert left < total // 5
