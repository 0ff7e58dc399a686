"""Training of the port with data-parallel rows: (dp, sp, tp) = (2, 2, 2),
eight CPU ranks over gloo in one job, held to the reference's Trainer on
``mesh222`` device by device; and checkpoints across layouts.

With two dp rows the reference shards AdamW's moments over ``"data"`` on
top of each leaf's TP sharding (ZeRO-1): its body stacks the 2 layers of
reduced qwen3-8b over a leading axis, so dp row d holds the moments of
layer d whole; the table's ``v_loc`` rows, the head's ``d`` rows and the
final norm's scale are cut in halves. Each rank of the port holds exactly
its device's slices (``training.optimizer.zero1_slice``) and all-gathers
the update over dp.

* three Trainer steps (microbatch 2, remat): every rank's loss, params and
  moment slices equal its device's (params and moments within 5e-4,
  leaving out the entries whose first-step gradient, the device's after
  the (dp, sp) sum, is below 1e-7);
* a checkpoint saved by a (1, 2, 2) job after one step (global logical
  arrays) loads on (2, 2, 2), where every rank holds the (1, 2, 2) rank's
  shards at its grid position (and its ZeRO slice of the moments), and on
  one rank, where it is the saved arrays themselves.

JAX is imported only in this process, inside fixtures.
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
from repro_torch.training.checkpoint import (load_checkpoint,  # noqa: E402
                                             read_checkpoint, save_checkpoint)
from repro_torch.training.optimizer import (AdamWConfig, moment_slice,  # noqa: E402
                                            stack_index, zero1_slice)

ARCH = "qwen3-8b"
DP, SP, TP = 2, 2, 2
B, S = 8, 16
LR = 1e-3
STEPS = 3
LOSS_TOL, STEP_TOL, TINY = 1e-5, 5e-4, 1e-7


def _batch():
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:2, -1] = -1
    return toks, labels


def _cfg():
    return get_config(ARCH).reduced()


def _np(d):
    return {k: (None if v is None else v.detach().numpy().copy())
            for k, v in d.items()}


def _model(lay, groups):
    return Model(_cfg(), device="cpu", dtype=torch.float32, lay=lay,
                 groups=groups)


# ---------------------------------------------------------------------------
# the port's side: a (1, 2, 2) job that saves, an eight-rank job
# ---------------------------------------------------------------------------
def _save_job(rank, groups, state, path):
    lay = Layout(sp=SP, tp=TP)
    m = _model(lay, groups)
    m.load_params(shard_state(state, _cfg(), lay, rank))
    tr = Trainer(m, AdamWConfig(lr=LR), microbatch=2, remat=True)
    opt, _ = tr.step(tr.init_opt_state(), *_batch())
    save_checkpoint(path, 1, m, opt, extra={"layout": "1x2x2"})
    return {"params": _np(dict(m.params.named_parameters())),
            "m": _np(opt["m"]), "v": _np(opt["v"])}


def _job(rank, groups, state, path):
    lay = Layout(dp=DP, sp=SP, tp=TP)
    m = _model(lay, groups)
    m.load_params(shard_state(state, _cfg(), lay, rank))
    tr = Trainer(m, AdamWConfig(lr=LR), microbatch=2, remat=True)
    opt = tr.init_opt_state()
    losses = []
    for _ in range(STEPS):
        opt, loss = tr.step(opt, *_batch())
        losses.append(float(loss))
    out = {"losses": losses, "params": _np(dict(m.params.named_parameters())),
           "m": _np(opt["m"]), "v": _np(opt["v"])}
    fresh = _model(lay, groups)
    step, ck_opt, extra = load_checkpoint(path, fresh)
    out["ck"] = {"step": step, "extra": extra,
                 "params": _np(dict(fresh.params.named_parameters())),
                 "m": _np(ck_opt["m"]), "v": _np(ck_opt["v"])}
    # the loaded state trains on
    opt2, loss = Trainer(fresh, AdamWConfig(lr=LR)).step(ck_opt, *_batch())
    out["ck"]["next_loss"], out["ck"]["next_step"] = float(loss), opt2["step"]
    return out


@pytest.fixture(scope="module")
def ref_state():
    import jax
    import jax.numpy as jnp
    from conftest import reduced_cfg
    from repro.models import build_model
    m = build_model(reduced_cfg(ARCH), dtype=jnp.float32)
    return from_jax_params(jax.tree.map(
        np.asarray, m.init_params(jax.random.key(0))), _cfg())


@pytest.fixture(scope="module")
def jobs(ref_state, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ck122") / "ck")
    saved = mesh.run_ranks(_save_job, SP, TP, device="cpu", backend="gloo",
                           timeout_s=240, args=(ref_state, path))
    ranks = mesh.run_ranks(_job, SP, TP, dp=DP, device="cpu",
                           backend="gloo", timeout_s=240,
                           args=(ref_state, path))
    return {"path": path, "saved": saved, "ranks": ranks}


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
def _per_device(tree, mesh_):
    import jax
    devs = list(mesh_.devices.flat)

    def one(a):
        by = {s.device: np.asarray(s.data) for s in a.addressable_shards}
        return [by[d] for d in devs]
    leaves, treedef = jax.tree.flatten(tree)
    cols = [one(a) for a in leaves]
    return [jax.tree.unflatten(treedef, [c[r] for c in cols])
            for r in range(len(devs))]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def reference(mesh222):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from conftest import reduced_cfg
    from repro.models import transformer as JT
    from repro.models.model import Model as JaxModel
    from repro.parallel import Layout as JaxLayout
    from repro.parallel.compat import shard_map
    from repro.training import Trainer as JaxTrainer
    from repro.training.optimizer import AdamWConfig as JaxAdamW
    cfg = reduced_cfg(ARCH)
    lay = JaxLayout.from_mesh(mesh222, dp=("data",), sp=("sp",), tp=("tp",))
    jm = JaxModel(cfg=cfg, lay=lay, mesh=mesh222, dtype=jnp.float32)
    params = jm.init_params(jax.random.key(0))
    toks, labels = (jnp.asarray(a) for a in _batch())
    pspec = jm.param_specs()

    def step1(p, t, lab):
        def local(p_, t_, l_):
            return JT.loss_body(p_, t_, l_, cfg, lay, False, None, None)
        gs = [jax.grad(local)(p, t[i * 2:(i + 1) * 2], lab[i * 2:(i + 1) * 2])
              for i in range(2)]
        return jax.tree.map(
            lambda a, b: jax.lax.psum((a + b) / 2, ("data", "sp")), *gs)
    g1 = jax.jit(shard_map(step1, mesh=mesh222,
                           in_specs=(pspec, P("data", "sp"), P("data", "sp")),
                           out_specs=pspec, check_vma=False))
    out = {"grad_step1": _per_device(g1(params, toks, labels), mesh222)}
    tr = JaxTrainer(jm, JaxAdamW(lr=LR), microbatch=2, remat=True)
    opt = tr.init_opt_state(params)
    step = jax.jit(tr.wrapped(tr.opt_specs(jax.eval_shape(lambda: params))))
    p, o, losses = params, opt, []
    for _ in range(STEPS):
        p, o, loss = step(p, o, toks, labels)
        losses.append(float(loss))
    out.update(losses=losses, params=_per_device(p, mesh222),
               m=_per_device(o["m"], mesh222), v=_per_device(o["v"], mesh222))
    return out


def _ref_moment(flat, name, shape, rank):
    """A device's local moment of the reference (its flattened tree) in
    the port's representation of parameter ``name`` (None where the rank
    holds none of it)."""
    cfg, lay = _cfg(), Layout(dp=DP, sp=SP, tp=TP)
    zs = zero1_slice(name, shape, cfg, lay)
    r = stack_index(name, cfg)
    if r is None:
        return flat[name]
    local = flat["body.s0." + name.split(".", 2)[2]]
    if zs.kind == "layer":
        blk = cfg.pattern_repeats // DP
        i = r - lay.dp_rank(rank) * blk
        return local[i] if 0 <= i < blk else None
    return local[r]


def _close(got, want, tol, what, skip=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    keep = np.ones(want.shape, bool) if skip is None else ~skip
    err = np.abs(got - want)[keep]
    assert err.size == 0 or err.max() <= tol, (what, float(err.max()), tol)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_loss_and_params_after_three_steps(jobs, reference):
    """Every rank's first loss within 1e-5 of the reference's (the later
    ones, after updates, within 1e-4), its params within 5e-4."""
    cfg = _cfg()
    assert reference["losses"][-1] < reference["losses"][0]
    left = total = 0
    for r, res in enumerate(jobs["ranks"]):
        assert abs(res["losses"][0] - reference["losses"][0]) <= LOSS_TOL, r
        np.testing.assert_allclose(res["losses"], reference["losses"], rtol=0,
                                   atol=LOSS_TOL * 10)
        g1 = from_jax_params(reference["grad_step1"][r], cfg)
        want = from_jax_params(reference["params"][r], cfg)
        for name, a in res["params"].items():
            skip = np.abs(g1[name]) < TINY
            _close(a, want[name], STEP_TOL, (r, name), skip)
            left, total = left + int(skip.sum()), total + skip.size
    print(f"entries left out (first-step |g| < {TINY}): {left} of {total}")


def test_zero1_moment_slices(jobs, reference):
    """Every rank holds its device's moment slices: whole layers by dp row
    (layer d on row d), halves of the table's and the head's rows and of
    the final norm, and they equal the device's values."""
    cfg, lay = _cfg(), Layout(dp=DP, sp=SP, tp=TP)
    held = {}
    for r, res in enumerate(jobs["ranks"]):
        g1 = from_jax_params(reference["grad_step1"][r], cfg)
        for tree in ("m", "v"):
            flat = _flat(reference[tree][r])
            for name, a in res[tree].items():
                shape = res["params"][name].shape
                want = _ref_moment(flat, name, shape, r)
                assert (a is None) == (want is None), (r, tree, name)
                if a is None:
                    continue
                held[(r, name)] = a.shape
                skip = moment_slice(name, torch.from_numpy(
                    np.abs(g1[name]) < TINY), zero1_slice(
                    name, shape, cfg, lay), lay, lay.dp_rank(r)).numpy()
                _close(a, want, STEP_TOL, (r, tree, name), skip)
    assert (0, "layers.0.attn.wq") in held and (0, "layers.1.attn.wq") \
        not in held
    assert (4, "layers.1.attn.wq") in held and (4, "layers.0.attn.wq") \
        not in held
    assert held[(0, "final_norm.scale")] == (cfg.d_model // DP,)
    assert held[(0, "embed.table")] == (2, cfg.vocab_size // 4 // DP,
                                        cfg.d_model)


def test_checkpoint_from_122_loads_on_222(jobs):
    """Each (2, 2, 2) rank holds the shards of the (1, 2, 2) rank at its
    grid position: bitwise for every leaf that rank holds alone; a norm
    scale from tp rank 0 and a replicated kv head from its first copy (the
    global logical array keeps one); its moments are the ZeRO slices of
    the saved moments."""
    cfg, lay = _cfg(), Layout(dp=DP, sp=SP, tp=TP)
    _, trees, _ = read_checkpoint(jobs["path"])
    for r, res in enumerate(jobs["ranks"]):
        ck = res["ck"]
        assert ck["step"] == 1 and ck["extra"] == {"layout": "1x2x2"}
        assert ck["next_step"] == 2 and np.isfinite(ck["next_loss"])
        want = shard_state(trees["params"], cfg, lay, r)
        src = jobs["saved"][r % (SP * TP)]
        for name, a in ck["params"].items():
            np.testing.assert_array_equal(a, want[name])
            if name.split(".")[-1] in ("wq", "wo", "wi", "wg") \
                    or name in ("embed.table", "lm_head.w") \
                    or (name.endswith("scale") and r % TP == 0):
                np.testing.assert_array_equal(a, src["params"][name])
        for tree in ("m", "v"):
            full = shard_state(trees[tree], cfg, lay, r)
            for name, a in ck[tree].items():
                zs = zero1_slice(name, full[name].shape, cfg, lay)
                part = moment_slice(name, torch.from_numpy(full[name]), zs,
                                    lay, lay.dp_rank(r))
                assert (a is None) == (part is None), (r, tree, name)
                if a is not None:
                    np.testing.assert_array_equal(a, part.numpy())


def test_checkpoint_from_122_loads_on_one_rank(jobs):
    cfg = _cfg()
    _, trees, _ = read_checkpoint(jobs["path"])
    m = Model(cfg, device="cpu", dtype=torch.float32)
    step, opt, _ = load_checkpoint(jobs["path"], m)
    assert step == 1 and opt["step"] == 1
    for name, p in m.params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      trees["params"][name])
        np.testing.assert_array_equal(opt["m"][name].numpy(), trees["m"][name])
    # tp rank 0's copy of a replicated scale; tp rank 0's columns of wq
    saved = jobs["saved"]
    np.testing.assert_array_equal(trees["params"]["final_norm.scale"],
                                  saved[0]["params"]["final_norm.scale"])
    w = trees["params"]["layers.0.ffn.wi"]
    np.testing.assert_array_equal(w[:, :w.shape[1] // TP],
                                  saved[0]["params"]["layers.0.ffn.wi"])
