"""Training of the port on (sp, tp) = (2, 2): four CPU ranks over gloo, one
job (``launch.mesh.run_ranks``, a module-scoped fixture), held to the
reference's ``shard_map`` on ``mesh122`` device by device.

The reference differentiates inside ``shard_map(check_vma=False)``, where
JAX transposes ``psum`` to ``psum``, a tiled ``all_to_all`` to the reverse
one and ``pmax_sg`` to nothing; so a device's gradients are not the
single-device gradients (the sharded leaves come out 4x here, the norm
scales by other factors), and a leaf that every tp rank holds whole (the
norm scales) gets a different gradient on each tp rank, which no psum over
tp joins: each rank's AdamW moves its own copy. The port's differentiable
collectives give the same per-rank gradients (ROADMAP Queue 3).

* every rank's loss (remat on and off) equals the reference's;
* every rank's gradients equal its device's in the reference (read per
  device from the ``shard_map``'s outputs), and the scale factors and the
  tp ranks' differing norm-scale gradients are the reference's;
* three ``Trainer`` steps (microbatch 2, remat), with and without int8
  compression: every rank's params and moments equal its device's.

Tolerances as in ``tests/test_torch_train.py``: loss 1e-5, gradients 1e-4
of each leaf's largest entry, params and moments 5e-4 absolute outside the
entries whose first-step gradient (the device's, after the (dp, sp) sum)
is below 1e-7. JAX is imported only in this process, inside fixtures.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params, shard_state  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402
from repro_torch.training import Trainer  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402

ARCH = "qwen3-8b"
SP, TP = 2, 2
B, S = 8, 16
LR = 1e-3
STEPS = 3
LOSS_TOL, GRAD_TOL, STEP_TOL, TINY = 1e-5, 1e-4, 5e-4, 1e-7
COMPRESSION = ("none", "int8")


def _batch():
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:2, -1] = -1
    return toks, labels


# ---------------------------------------------------------------------------
# the port's side: one job on four ranks
# ---------------------------------------------------------------------------
def _model(state, groups):
    cfg = get_config(ARCH).reduced()
    lay = Layout(sp=SP, tp=TP)
    m = Model(cfg, device="cpu", dtype=torch.float32, lay=lay, groups=groups)
    m.load_params(shard_state(state, cfg, lay, groups.rank))
    return m


def _np(d):
    return {k: (None if v is None else v.detach().numpy().copy())
            for k, v in d.items()}


def _job(rank, groups, state):
    toks, labels = _batch()
    out = {}
    m = _model(state, groups)
    for remat in (True, False):
        before = dict(groups.traffic)
        with m.trainable() as named:
            loss = m.loss_fn(remat=remat)(toks, labels)
            loss.backward()
            out[f"loss_{remat}"] = float(loss)
            out[f"grads_{remat}"] = _np({k: p.grad for k, p in named.items()})
        out[f"a2a_calls_{remat}"] = (groups.traffic["all_to_all_calls"]
                                     - before.get("all_to_all_calls", 0))
    for comp in COMPRESSION:
        m = _model(state, groups)
        tr = Trainer(m, AdamWConfig(lr=LR), microbatch=2, remat=True,
                     grad_compression=comp)
        opt = tr.init_opt_state()
        losses = []
        for _ in range(STEPS):
            opt, loss = tr.step(opt, toks, labels)
            losses.append(float(loss))
        out[comp] = {"losses": losses, "step": opt["step"],
                     "params": _np(dict(m.params.named_parameters())),
                     "m": _np(opt["m"]), "v": _np(opt["v"])}
    return out


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
def _per_device(tree, mesh_):
    """Every device's own buffer of every leaf, as one tree per device in
    process-rank order (``mesh.devices`` flattened)."""
    import jax
    devs = list(mesh_.devices.flat)

    def one(a):
        by = {s.device: np.asarray(s.data) for s in a.addressable_shards}
        return [by[d] for d in devs]
    leaves, treedef = jax.tree.flatten(tree)
    cols = [one(a) for a in leaves]
    return [jax.tree.unflatten(treedef, [c[r] for c in cols])
            for r in range(len(devs))]


@pytest.fixture(scope="module")
def ref_state():
    import jax
    import jax.numpy as jnp
    from conftest import reduced_cfg
    from repro.models import build_model
    m = build_model(reduced_cfg(ARCH), dtype=jnp.float32)
    return from_jax_params(jax.tree.map(
        np.asarray, m.init_params(jax.random.key(0))),
        get_config(ARCH).reduced())


@pytest.fixture(scope="module")
def ranks(ref_state):
    """The one four-rank job of this module."""
    return mesh.run_ranks(_job, SP, TP, device="cpu", backend="gloo",
                          timeout_s=240, args=(ref_state,))


@pytest.fixture(scope="module")
def reference(mesh122):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from conftest import reduced_cfg
    from repro.models import build_model
    from repro.models import transformer as JT
    from repro.models.model import Model as JaxModel
    from repro.parallel import Layout as JaxLayout
    from repro.parallel.compat import shard_map
    from repro.training import Trainer as JaxTrainer
    from repro.training.optimizer import AdamWConfig as JaxAdamW
    cfg = reduced_cfg(ARCH)
    lay = JaxLayout.from_mesh(mesh122, dp=("data",), sp=("sp",), tp=("tp",))
    jm = JaxModel(cfg=cfg, lay=lay, mesh=mesh122, dtype=jnp.float32)
    params = jm.init_params(jax.random.key(0))
    toks, labels = (jnp.asarray(a) for a in _batch())
    pspec = jm.param_specs()
    io = P(None, "sp")
    out = {}

    def local(p, t, lab, remat=True):
        return JT.loss_body(p, t, lab, cfg, lay, False, None, None,
                            remat=remat)

    for remat in (True, False):
        f = jax.jit(shard_map(lambda p, t, lab: local(p, t, lab, remat),
                              mesh=mesh122, in_specs=(pspec, io, io),
                              out_specs=P(), check_vma=False))
        out[f"loss_{remat}"] = [float(x) for x in
                                _per_device(f(params, toks, labels),
                                            mesh122)]
    g = jax.jit(shard_map(lambda p, t, lab: jax.grad(local)(p, t, lab),
                          mesh=mesh122, in_specs=(pspec, io, io),
                          out_specs=pspec, check_vma=False))
    out["grads"] = _per_device(g(params, toks, labels), mesh122)

    def step1(p, t, lab):
        # the Trainer's first gradient: two microbatches, averaged, summed
        # over sp
        gs = [jax.grad(local)(p, t[i * 4:(i + 1) * 4], lab[i * 4:(i + 1) * 4])
              for i in range(2)]
        return jax.tree.map(lambda a, b: jax.lax.psum((a + b) / 2, "sp"),
                            *gs)
    g1 = jax.jit(shard_map(step1, mesh=mesh122, in_specs=(pspec, io, io),
                           out_specs=pspec, check_vma=False))
    out["grad_step1"] = _per_device(g1(params, toks, labels), mesh122)
    # the single-device gradient, for the scale factors
    m1 = build_model(cfg, dtype=jnp.float32)
    out["single"] = jax.tree.map(np.asarray, jax.grad(m1.loss_fn())(
        m1.init_params(jax.random.key(0)), toks, labels))
    for comp in COMPRESSION:
        tr = JaxTrainer(jm, JaxAdamW(lr=LR), microbatch=2, remat=True,
                        grad_compression=comp)
        opt = tr.init_opt_state(params)
        step = jax.jit(tr.wrapped(tr.opt_specs(
            jax.eval_shape(lambda: params))))
        p, o, losses = params, opt, []
        for _ in range(STEPS):
            p, o, loss = step(p, o, toks, labels)
            losses.append(float(loss))
        out[comp] = {"losses": losses, "params": _per_device(p, mesh122),
                     "m": _per_device(o["m"], mesh122),
                     "v": _per_device(o["v"], mesh122)}
    return out


def _close(got, want, tol, what, skip=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    keep = np.ones(want.shape, bool) if skip is None else ~skip
    err = np.abs(got - want)[keep]
    assert err.size == 0 or err.max() <= tol, (what, float(err.max()), tol)


def _cfg():
    return get_config(ARCH).reduced()


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_loss_on_every_rank(ranks, reference):
    """Remat on and off: every device's loss is the same, and every rank's
    equals it."""
    for remat in (True, False):
        want = reference[f"loss_{remat}"]
        assert len(set(want)) == 1
        for r, res in enumerate(ranks):
            assert abs(res[f"loss_{remat}"] - want[r]) <= LOSS_TOL, \
                (r, remat)


def test_gradients_per_rank(ranks, reference):
    """Each rank's gradients are its device's in the reference (with remat
    and without: the same); the tp ranks' gradients of a replicated norm
    scale differ, as the reference's devices' do."""
    cfg = _cfg()
    for r, res in enumerate(ranks):
        want = from_jax_params(reference["grads"][r], cfg)
        for remat in (True, False):
            got = res[f"grads_{remat}"]
            assert set(got) == set(want)
            for name, g in got.items():
                scale = float(np.abs(want[name]).max())
                _close(g, want[name], GRAD_TOL * max(scale, 1e-30),
                       (r, remat, name))
    fn = "final_norm.scale"
    diff = np.abs(ranks[0]["grads_True"][fn] - ranks[1]["grads_True"][fn])
    want = np.abs(reference["grads"][0]["final_norm"]["scale"]
                  - reference["grads"][1]["final_norm"]["scale"])
    assert diff.max() > 1e-3 and abs(diff.max() - want.max()) <= 1e-5


def test_gradient_scale_against_one_device(ranks, reference):
    """The Trainer's (dp, sp) sum of the ranks' gradients against the
    single-device gradient, projected: 4.0 for every tp-sharded leaf on
    (1, 2, 2), and between 1 and 4 for the norm scales (the reference's
    numbers, ROADMAP Queue 3)."""
    cfg, lay = _cfg(), Layout(sp=SP, tp=TP)
    single = from_jax_params(reference["single"], cfg)
    for j in range(TP):
        # the sum over sp of tp rank j's gradients, against its shard of
        # the single-device gradient
        summed = {k: ranks[j]["grads_True"][k] + ranks[TP + j]["grads_True"][k]
                  for k in single}
        shard = shard_state(single, cfg, lay, j)
        for name, g in summed.items():
            w = shard[name].ravel().astype(np.float64)
            f = float(g.ravel() @ w / (w @ w))
            if name.split(".")[-1] in ("wq", "wk", "wv", "wo", "wi", "wg"):
                assert abs(f - 4.0) < 1e-3, (name, f)
            elif name.endswith("scale") or name.endswith("_norm"):
                assert 0.9 < f < 4.1, (name, f)


@pytest.mark.parametrize("comp", COMPRESSION)
def test_trainer_steps_per_rank(ranks, reference, comp):
    """With int8 the layers that the reference stacks into one array share
    one quantization scale (``train_step.reference_leaves``): a scale per
    layer rounds other values."""
    cfg = _cfg()
    ref = reference[comp]
    left = total = 0
    for r, res in enumerate(ranks):
        got = res[comp]
        assert abs(got["losses"][0] - ref["losses"][0]) <= LOSS_TOL, r
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0,
                                   atol=LOSS_TOL * 10)
        assert got["step"] == STEPS
        g1 = from_jax_params(reference["grad_step1"][r], cfg)
        for tree in ("params", "m", "v"):
            want = from_jax_params(ref[tree][r], cfg)
            for name, a in got[tree].items():
                skip = np.abs(g1[name]) < TINY
                _close(a, want[name], STEP_TOL, (r, comp, tree, name), skip)
                if tree == "params":
                    left, total = left + int(skip.sum()), total + skip.size
    print(f"{comp}: entries left out {left} of {total}")
    assert left < total // 5
    assert ref["losses"][-1] < ref["losses"][0]


def test_remat_recomputes_the_exchange(ranks):
    """Remat recomputes every layer's forward in the backward, its
    all-to-alls included, in the same order on every rank: per layer the
    forward's two exchanges, again in the recomputation, and the two of
    the backward (with remat 3 x 2 x layers, without 2 x 2 x layers)."""
    L = _cfg().num_layers
    for res in ranks:
        assert res["a2a_calls_False"] == 4 * L
        assert res["a2a_calls_True"] == 6 * L
