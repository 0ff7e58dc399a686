"""Shared pieces of the MoE training tests
(``tests/test_torch_train_moe*.py``): the batch, the reduced configs at
capacity factor 1.25 (so that capacity drops assignments), the reference's
weights under the port's names, every device's buffers of a
``shard_map``'s outputs, the closeness checks, and the routing check that
tells a flip of a near-tie from a gradient error.

Tolerances (fp32) as in ``tests/test_torch_train.py``: loss 1e-5,
gradients 1e-4 of each leaf's largest entry, params and moments after three
Trainer steps 5e-4, leaving out the entries whose first-step gradient in
the reference is below 1e-7. JAX is imported only inside functions.
"""
import dataclasses
from contextlib import contextmanager

import numpy as np
import torch

from repro_torch.configs import get_config

B, S = 8, 16
LR = 1e-3
STEPS = 3
CAP = 1.25
LOSS_TOL, GRAD_TOL, STEP_TOL, TINY = 1e-5, 1e-4, 5e-4, 1e-7
AUX_TOL = 1e-6      # the aux alone, as a difference of two fp32 losses
# llama4's stacks have no q/k norms, and on the (2, 2, 2) layout their fp32
# gradients lie up to 1.85e-4 of a leaf's largest entry from the
# reference's (the router's), where an fp64 copy of both packages agrees
# within 1.2e-13 (``tools/moe_fp64_check.py``, ROADMAP Queue 3): they are
# held at this tolerance
NOISY_GRAD_TOL = 3e-4
# int8 gradient compression rounds g / scale half to even, the scale being
# 1/127 of the largest |g| over the group: a value within the gradients'
# tolerance (of the leaf's largest entry) of a tie, 127 times that in
# quanta, may round apart in the two packages (one quantum); the flipped
# entry's Adam step then differs by up to lr, so up to FLIPS entries a rank
# may differ by up to 2 lr after three steps
FLIPS = 8


def batch():
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:2, -1] = -1                 # uncounted positions
    return toks, labels


def port_cfg(arch, **moe):
    """The port's reduced config (capacity factor 1.25), its MoE config
    replaced by ``moe``'s fields (a config without MoE as it is)."""
    cfg = get_config(arch).reduced()
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CAP, **moe))


def ref_cfg(arch, **moe):
    """The reference's reduced config at the same capacity factor, its MoE
    config replaced by ``moe``'s fields (a config without MoE as it
    is)."""
    from conftest import reduced_cfg
    cfg = reduced_cfg(arch, cap=CAP)
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


def np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def ref_state(arch):
    """The reference's ``init_params(key(0))`` on the trivial layout, under
    the port's names."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model
    from repro_torch.convert import from_jax_params
    m = build_model(ref_cfg(arch), dtype=jnp.float32)
    return from_jax_params(np_tree(m.init_params(jax.random.key(0))),
                           port_cfg(arch))


def per_device(tree, mesh_):
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


def close(got, want, tol, what, skip=None):
    """|got - want| <= tol everywhere (outside ``skip``); returns the number
    of entries left out."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    keep = np.ones(want.shape, bool) if skip is None else ~skip
    err = np.abs(got - want)[keep]
    assert err.size == 0 or err.max() <= tol, (what, float(err.max()), tol)
    return int((~keep).sum())


def np_dict(d):
    return {k: (None if v is None else v.detach().cpu().numpy().copy())
            for k, v in d.items()}


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
@contextmanager
def routes_logged():
    """Record every ``models.moe.route`` call of the block: the layer's
    tokens [T, d], its router, and the port's top-k selection and kept
    mask, as numpy arrays."""
    from repro_torch.models import moe as MOE
    route, log = MOE.route, []

    def logged(p, xt):
        out = route(p, xt)
        log.append({"xt": xt.detach().cpu().numpy().copy(),
                    "router": p.router.detach().cpu().numpy().copy(),
                    "sel": out[2].cpu().numpy(), "keep": out[5].cpu().numpy()})
        return out
    MOE.route = logged
    try:
        yield log
    finally:
        MOE.route = route


def check_routes(log, cfg) -> float:
    """Each logged call's selection and kept mask equal the reference's
    routing (``lax.top_k`` and ``_dispatch_indices``) on the same tokens
    and router. Returns the smallest gap between a token's k-th and
    (k+1)-th probability over every call: a difference between the ports'
    activations of that size or more can flip a choice, which would then
    read as a gradient error."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as JM
    mo = cfg.moe
    gap = np.inf
    for i, rec in enumerate(log):
        xt = jnp.asarray(rec["xt"])
        logits = (xt @ jnp.asarray(rec["router"]).astype(xt.dtype)) \
            .astype(jnp.float32)
        probs = jax.nn.softmax(logits, axis=-1)
        w, sel = jax.lax.top_k(probs, mo.top_k)
        T = xt.shape[0]
        C = max(1, int(T * mo.top_k * mo.capacity_factor) // mo.num_experts)
        _, keep, _ = JM._dispatch_indices(sel, w, T, mo.num_experts, C)
        srt = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
        if mo.top_k < mo.num_experts:
            gap = min(gap, float((srt[:, mo.top_k - 1]
                                  - srt[:, mo.top_k]).min()))
        assert np.array_equal(rec["sel"], np.asarray(sel)), \
            (f"call {i}: top-k differs from the reference's; smallest "
             f"top-k gap {gap}")
        assert np.array_equal(rec["keep"], np.asarray(keep)), \
            (f"call {i}: kept mask differs from the reference's; smallest "
             f"top-k gap {gap}")
    print(f"routing equal in {len(log)} calls; smallest top-k gap {gap}")
    return gap


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------
def loss_and_grads(model, remat=True):
    """(loss, {name: gradient}) of one ``loss_fn`` call on ``batch()``."""
    with model.trainable() as named:
        loss = model.loss_fn(remat=remat)(*batch())
        loss.backward()
        grads = np_dict({k: p.grad for k, p in named.items()})
    return float(loss.detach()), grads


def trained(model, comp, steps=STEPS, ckpt=None):
    """``steps`` Trainer steps (microbatch 2, remat, lr 1e-3) on
    ``batch()``: the losses, params and moments (this rank's slices), and
    the first step's gradients after the (dp, sp) reduction, as
    ``adamw_update`` receives them (``grad_step1``). With ``ckpt``, a
    checkpoint of the trained state is saved there (every rank calls)."""
    from repro_torch.training import Trainer
    from repro_torch.training import train_step
    from repro_torch.training.optimizer import AdamWConfig
    tr = Trainer(model, AdamWConfig(lr=LR), microbatch=2, remat=True,
                 grad_compression=comp)
    opt, losses, seen = tr.init_opt_state(), [], []
    update = train_step.adamw_update

    def recorded(model_, grads, *args):
        if not seen:
            seen.append(np_dict(grads))
        return update(model_, grads, *args)
    train_step.adamw_update = recorded
    try:
        for _ in range(steps):
            opt, loss = tr.step(opt, *batch())
            losses.append(float(loss))
    finally:
        train_step.adamw_update = update
    if ckpt is not None:
        from repro_torch.training.checkpoint import save_checkpoint
        save_checkpoint(ckpt, steps, model, opt)
    return {"losses": losses, "step": opt["step"], "grad_step1": seen[0],
            "params": np_dict(dict(model.params.named_parameters())),
            "m": np_dict(opt["m"]), "v": np_dict(opt["v"])}


# ---------------------------------------------------------------------------
# the reference's side on a mesh
# ---------------------------------------------------------------------------
def ref_on_mesh(arch, mesh_, comps=("none", "int8"), grad_tol=GRAD_TOL,
                no_mtp=False, **moe):
    """The reference on ``mesh_`` (axes data, sp, tp), device by device:
    the loss (remat on and off) and the gradients (remat on); with
    ``comps``, also the Trainer's first gradient (the two microbatches'
    mean) before and after the (dp, sp) sum, and three Trainer steps
    (microbatch 2, remat) with each compression of ``comps``: losses,
    params and moments. With int8, also the first step's int8-reduced
    gradient, the entries within ``grad_tol`` (of the leaf's largest
    entry) of a rounding tie on a device of the group, and the quantum.
    With ``no_mtp``, also the loss (remat on) of the tree without its
    ``mtp`` head (``loss_no_mtp``), which the reference's ``loss_body``
    then leaves out."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.models import transformer as JT
    from repro.models.model import Model as JaxModel
    from repro.parallel import Layout as JaxLayout
    from repro.parallel.compat import shard_map
    from repro.training import Trainer as JaxTrainer
    from repro.training.optimizer import AdamWConfig as JaxAdamW
    cfg = ref_cfg(arch, **moe)
    lay = JaxLayout.from_mesh(mesh_, dp=("data",), sp=("sp",), tp=("tp",))
    jm = JaxModel(cfg=cfg, lay=lay, mesh=mesh_, dtype=jnp.float32)
    pod = jm.pod_scale
    params = jm.init_params(jax.random.key(0))
    toks, labels = (jnp.asarray(a) for a in batch())
    pspec = jm.param_specs()
    io = P("data", "sp")
    reduce_axes = ("data", "sp")
    out = {}

    def local(p, t, lab, remat=True):
        return JT.loss_body(p, t, lab, cfg, lay, pod, None, None,
                            remat=remat)

    for remat in (True, False):
        f = jax.jit(shard_map(lambda p, t, lab: local(p, t, lab, remat),
                              mesh=mesh_, in_specs=(pspec, io, io),
                              out_specs=P(), check_vma=False))
        out[f"loss_{remat}"] = [float(x) for x in
                                per_device(f(params, toks, labels), mesh_)]
    if no_mtp:
        nspec = {k: v for k, v in pspec.items() if k != "mtp"}
        f = jax.jit(shard_map(lambda p, t, lab: local(p, t, lab),
                              mesh=mesh_, in_specs=(nspec, io, io),
                              out_specs=P(), check_vma=False))
        out["loss_no_mtp"] = [float(x) for x in per_device(f(
            {k: v for k, v in params.items() if k != "mtp"}, toks, labels),
            mesh_)]
    g = jax.jit(shard_map(lambda p, t, lab: jax.grad(local)(p, t, lab),
                          mesh=mesh_, in_specs=(pspec, io, io),
                          out_specs=pspec, check_vma=False))
    out["grads"] = per_device(g(params, toks, labels), mesh_)
    if not comps:
        return out

    def step1(p, t, lab):
        # the Trainer's first gradient: two microbatches, averaged; and
        # that summed over (dp, sp)
        h = t.shape[0] // 2
        gs = [jax.grad(local)(p, t[i * h:(i + 1) * h], lab[i * h:(i + 1) * h])
              for i in range(2)]
        mean = jax.tree.map(lambda a, b: (a + b) / 2, *gs)
        return mean, jax.tree.map(lambda a: jax.lax.psum(a, reduce_axes),
                                  mean)
    g1 = jax.jit(shard_map(step1, mesh=mesh_, in_specs=(pspec, io, io),
                           out_specs=(pspec, pspec), check_vma=False))
    local1, summed1 = g1(params, toks, labels)
    out["grad_step1_local"] = per_device(local1, mesh_)
    out["grad_step1"] = per_device(summed1, mesh_)
    if "int8" in comps:
        # the first step's int8 reduction of every leaf, where a device of
        # the group held a value within 127 grad_tol quanta of a rounding
        # tie, and the leaf's quantum
        from repro.training.compress import int8_compress_psum

        def int8(g):
            amax = jax.lax.pmax(jnp.max(jnp.abs(g)), reduce_axes)
            t = g / (jnp.maximum(amax, 1e-12) / 127.0)
            tie = jnp.abs(jnp.abs(t - jnp.floor(t)) - 0.5) < 127 * grad_tol
            tie = jax.lax.psum(tie.astype(jnp.int32), reduce_axes) > 0
            red, _ = int8_compress_psum(g, jnp.zeros_like(g), reduce_axes)
            return red, tie, jnp.full_like(g, jnp.maximum(amax, 1e-12)
                                           / 127.0)

        def step1_int8(p, t, lab):
            mean, _ = step1(p, t, lab)
            pairs = jax.tree.map(int8, mean)
            is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
            return tuple(jax.tree.map(lambda x: x[i], pairs,
                                      is_leaf=is_pair) for i in range(3))
        f8 = jax.jit(shard_map(step1_int8, mesh=mesh_,
                               in_specs=(pspec, io, io),
                               out_specs=(pspec,) * 3, check_vma=False))
        for key, tree in zip(("grad", "ties", "quantum"),
                             f8(params, toks, labels)):
            out[f"{key}_step1_int8"] = per_device(tree, mesh_)
    for comp in comps:
        tr = JaxTrainer(jm, JaxAdamW(lr=LR), microbatch=2, remat=True,
                        grad_compression=comp)
        opt = tr.init_opt_state(params)
        step = jax.jit(tr.wrapped(tr.opt_specs(
            jax.eval_shape(lambda: params))))
        p, o, losses = params, opt, []
        for _ in range(STEPS):
            p, o, loss = step(p, o, toks, labels)
            losses.append(float(loss))
        out[comp] = {"losses": losses, "params": per_device(p, mesh_),
                     "m": per_device(o["m"], mesh_),
                     "v": per_device(o["v"], mesh_)}
    return out


def check_loss_per_rank(ranks, ref, keys=("loss_True", "loss_False")):
    """Every device's loss is the same, and every rank's equals it."""
    for key in keys:
        want = ref[key]
        assert max(want) - min(want) <= 1e-6, (key, want)
        for r, res in enumerate(ranks):
            assert abs(res[key] - want[r]) <= LOSS_TOL, (r, key, res[key],
                                                         want[r])


def check_grads_per_rank(ranks, ref, cfg, key="grads", gap=None,
                         tol=GRAD_TOL, norm_tol=None):
    """Each rank's gradients are its device's in the reference, within
    ``tol`` of each leaf's largest entry; with ``norm_tol``, also the
    error's norm within ``norm_tol`` of the leaf's norm. Prints the worst
    such errors."""
    from repro_torch.convert import from_jax_params
    worst = worst_norm = 0.0
    for r, res in enumerate(ranks):
        want = from_jax_params(ref[key][r], cfg)
        got = res[key]
        assert set(got) == set(want)
        for name, g in got.items():
            scale = float(np.abs(want[name]).max())
            worst = max(worst, float(np.abs(g - want[name]).max())
                        / max(scale, 1e-30))
            close(g, want[name], tol * max(scale, 1e-30),
                  (r, key, name, f"smallest top-k gap {gap}"))
            if norm_tol is not None:
                rel = float(np.linalg.norm(g - want[name])
                            / max(np.linalg.norm(want[name]), 1e-30))
                worst_norm = max(worst_norm, rel)
                assert rel <= norm_tol, (r, key, name, rel, norm_tol)
    print(f"{key}: worst error of a leaf against its largest entry {worst}"
          + (f", of its norm against the leaf's {worst_norm}"
             if norm_tol is not None else ""))


def check_int8_first_step(ranks, ref, cfg, tol=GRAD_TOL):
    """The first step's int8-reduced gradients of every rank equal its
    device's: within ``tol`` of each leaf's largest entry, except at the
    entries where a device of the (dp, sp) group held a value within that
    of a rounding tie (``ref_on_mesh``'s ``grad_tol``), which may differ
    by one quantum. Returns the number of entries that differ there, by
    rank."""
    from repro_torch.convert import from_jax_params
    flipped = []
    for r, res in enumerate(ranks):
        got = res["int8"]["grad_step1"]
        want = from_jax_params(ref["grad_step1_int8"][r], cfg)
        ties = from_jax_params(ref["ties_step1_int8"][r], cfg)
        quanta = from_jax_params(ref["quantum_step1_int8"][r], cfg)
        n = 0
        for name, g in got.items():
            w, tie = want[name], ties[name].astype(bool)
            scale = float(np.abs(w).max())
            close(g, w, tol * max(scale, 1e-30), (r, "int8", name),
                  skip=tie)
            d = np.abs(g - w)[tie]
            q = float(quanta[name].max())
            assert d.size == 0 or d.max() <= q * (1 + 1e-2), (r, name, d, q)
            n += int((d > tol * scale).sum())
        flipped.append(n)
    print(f"int8 first step: entries rounded apart at a tie, by rank "
          f"{flipped}")
    return flipped


def check_steps_per_rank(ranks, ref, cfg, comp, ref_moment=None,
                         flips_max=FLIPS, flip_drift=False):
    """Three Trainer steps: every rank's losses, params and moments equal
    its device's, outside the entries whose first-step gradient (the
    device's, after the (dp, sp) sum) is below 1e-7. With int8
    compression, up to FLIPS params a rank may differ by up to 2 lr (an
    entry rounded apart at a tie, ``check_int8_first_step``), and they are
    printed; ``flips_max`` replaces FLIPS for a stack with more ties. With
    ``flip_drift`` the losses after the first may also differ by twice the
    first-order change that the params' differences make, ``Σ |Δw|·|g|``
    with g the first-step gradient (the first loss, before any update,
    keeps LOSS_TOL): the params themselves are held as above.
    ``ref_moment(flat, name, shape, rank)`` maps a device's
    moment to the port's slice (the device's own tree where it is None).
    Returns (left out, total)."""
    from repro_torch.convert import from_jax_params
    want_ref = ref[comp]
    left = total = 0
    for r, res in enumerate(ranks):
        flips = []
        got = res[comp]
        assert abs(got["losses"][0] - want_ref["losses"][0]) <= LOSS_TOL, r
        assert got["step"] == STEPS
        g1 = from_jax_params(ref["grad_step1"][r], cfg)
        want_p = from_jax_params(want_ref["params"][r], cfg)
        drift = 0.0
        for name, a in got["params"].items():
            skip = np.abs(g1[name]) < TINY
            if comp == "int8":
                d = np.abs(a - want_p[name])
                far = (d > STEP_TOL) & ~skip
                flips += [(name, float(e)) for e in d[far]]
                drift += 2 * float((d * np.abs(g1[name])).sum())
                skip = skip | far
                assert d[far].size == 0 or d[far].max() <= 2 * LR, (r, name)
            close(a, want_p[name], STEP_TOL, (r, comp, "params", name), skip)
            left, total = left + int(skip.sum()), total + skip.size
        np.testing.assert_allclose(
            got["losses"], want_ref["losses"], rtol=0,
            atol=LOSS_TOL * 10 + (drift if flip_drift else 0.0))
        if comp == "int8":
            print(f"rank {r}: params more than {STEP_TOL} from the "
                  f"reference's (rounded apart at a tie): {flips}; their "
                  f"loss drift bound {drift}")
            assert len(flips) <= flips_max, (r, flips)
        for tree in ("m", "v"):
            if ref_moment is None:
                want = from_jax_params(want_ref[tree][r], cfg)
            for name, a in got[tree].items():
                skip = np.abs(g1[name]) < TINY
                if ref_moment is None:
                    w = want[name]
                else:
                    w, skip = ref_moment(want_ref[tree][r], name, skip, r)
                assert (a is None) == (w is None), (r, tree, name)
                if a is not None:
                    close(a, w, STEP_TOL, (r, comp, tree, name), skip)
    assert want_ref["losses"][-1] < want_ref["losses"][0]
    print(f"{comp}: entries left out {left} of {total}")
    return left, total


def loaded(model, ckpt):
    """The checkpoint at ``ckpt`` loaded onto ``model`` (resharded to its
    layout): the step, the params and the moments (this rank's slices)."""
    from repro_torch.training.checkpoint import load_checkpoint
    step, opt, _ = load_checkpoint(ckpt, model)
    return {"step": step,
            "params": np_dict(dict(model.params.named_parameters())),
            "m": np_dict(opt["m"]), "v": np_dict(opt["v"])}


def check_checkpoint(ranks, ckpt, cfg, lay, comp="none"):
    """The checkpoint that every rank saved after its ``comp`` steps, and
    that each rank loaded back on ``lay`` (``ranks[r]["loaded"]``):

    * on ``lay`` each rank holds its trained params and moment slices
      again, bitwise, but for a leaf that every tp rank holds whole (a norm
      scale, the router), whose copy on tp rank 0 is saved;
    * on one rank (reshard-on-load) the checkpoint's arrays are the
      ranks' shards put together: each rank's shard of them is its trained
      shard (the expert stacks from every rank that holds a part).
    Returns the one-rank model's params."""
    from repro_torch.convert import is_expert_leaf, shard_state
    from repro_torch.models import Model
    from repro_torch.training.checkpoint import read_checkpoint
    step, trees, _ = read_checkpoint(ckpt)
    assert step == STEPS
    one = Model(cfg, device="cpu", dtype=torch.float32)
    back = loaded(one, ckpt)
    for name, a in back["params"].items():
        assert np.array_equal(a, trees["params"][name]), name
    for r, res in enumerate(ranks):
        want = shard_state(trees["params"], cfg, lay, r)
        got, src = res["loaded"], res[comp]
        assert got["step"] == STEPS
        for name, a in got["params"].items():
            assert np.array_equal(a, want[name]), (r, name)
            whole = want[name].shape == trees["params"][name].shape \
                and not is_expert_leaf(name, cfg)
            if lay.tp_rank(r) == 0 or not whole:
                assert np.array_equal(a, src["params"][name]), (r, name)
        for tree in ("m", "v"):
            for name, a in got[tree].items():
                b = src[tree][name]
                assert (a is None) == (b is None), (r, tree, name)
                whole = got["params"][name].shape == trees["params"][
                    name].shape and not is_expert_leaf(name, cfg)
                if a is not None and (lay.tp_rank(r) == 0 or not whole):
                    assert np.array_equal(a, b), (r, tree, name)
    return back["params"]
