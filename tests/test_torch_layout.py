"""The port's Shift Parallelism layouts on four CPU ranks over gloo, held to
the reference on its ``mesh122`` (and a (1, 4, 1) mesh for sp 4).

One four-rank job (``launch.mesh.run_ranks``, a module-scoped fixture) runs
every port-side scenario and returns numpy results; the tests compare them
with the reference run in this process. Port rank ``r = i*tp + j`` is
compared with the reference's shard on device ``mesh.devices[0, i, j]``.
Weights: the reference's ``init_params(key(0))`` on the trivial layout
with random norm scales, converted (``from_jax_params``) and cut per rank
(``shard_state``); the reference's base and shift models draw the same
canonical weights.

* Ulysses: ``expand_kv_for_send``, ``ulysses_scatter_heads`` (q, k and v
  with different head counts and widths in one call) and
  ``ulysses_gather_heads`` equal the reference under ``shard_map``
  bitwise; so does ``shard_state`` on the base and the shift layout, and a
  sharded model's own init equals the trivial init cut by ``shard_state``.
* The mixed step's logits, base and shift, on (sp, tp) = (2, 2) and (4, 1)
  and on a padded head plan (6 q heads, G 4: 8 slots), within 1e-4 of the
  reference's ``forward_fn(sample=False)``; the token streams of
  ``_drive_mixed`` (prefill under base, decodes alternating shift and base
  over one pool) equal the reference's.
* Invariance with data: blocks prefilled under base stay bitwise unchanged
  by a shift pass that reads them, on every rank, and each kv slot is owned
  by the rank the paper's head order names.
* The SPMD engine with a base and a shift model, with and without pool
  pressure: streams, config counts, preemptions and free blocks equal the
  reference's ``ShiftEngine`` on ``mesh122`` and the port's one-rank
  engine, and all four ranks' streams are equal.
* The SPMD engine with the prefix cache and speculation (``k=4``) on a
  shared 16-token prefix and repetitive prompts: streams, config counts,
  prefix stats and spec counts equal the reference's on ``mesh122`` and
  the one-rank port engine's, on every rank.
* ``Layout`` against the reference's; ep above 1 raises, and so does
  ``graphed=True`` above world size 1.
* ``ft.elastic.reshard_params`` at the world size of four: (1, 2, 2) ->
  (1, 1, 4) -> (1, 2, 2) gives every rank's weights back bitwise and the
  (1, 1, 4) ones equal ``shard_state``'s; base -> shift expands wk/wv as
  the reference's ``reshard_params`` on ``mesh122`` does for key-0
  weights, while for other weights the port derives them from the
  gathered weights and the reference re-draws them from key 0 (a
  difference by design, ROADMAP Queue 3); the resharded models' logits
  equal the base model's within 3e-4.

JAX is imported only in this process (inside the fixtures), so that the
spawned ranks, which import this module to find their job, stay light.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params, shard_state  # noqa: E402
from repro_torch.core import invariance as INV  # noqa: E402
from repro_torch.core.ulysses import (expand_kv_for_send,  # noqa: E402
                                      ulysses_gather_heads,
                                      ulysses_scatter_heads)
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.engine.deployment import Deployment  # noqa: E402
from repro_torch.launch import mesh, serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import Groups, Layout, plan_heads  # noqa: E402

SP, TP = 2, 2
N_REQ, MAX_NEW = 6, 8
TIGHT = {"num_blocks": 9, "block_size": 8}
# the Ulysses case: B 2, S 8 (4 per sp rank), the padded plan's heads
# (q 6 -> 8 slots, kv 2, G 4, tp 2: 4 q and 1 kv slot per tp rank)
U_B, U_S, U_C = 2, 8, 16
U_PLAN = plan_heads(6, 2, SP * TP, TP)
# one mixed step's inputs: prefill chunks, then decode rows and a chunk
STEP_BT = (np.arange(1, 17, dtype=np.int32).reshape(4, 4))
STEPS = [([8, 5, 8, 0], [0, 0, 0, 0]), ([1, 1, 3, 8], [8, 5, 8, 0])]


def _cfg(padded=False):
    cfg = get_config("qwen3-8b").reduced()
    return dataclasses.replace(cfg, num_heads=6) if padded else cfg


def _prompts():
    return [list(range(1, 20 + 3 * i)) for i in range(N_REQ)]


# ---------------------------------------------------------------------------
# the port's side: one job on four ranks
# ---------------------------------------------------------------------------
def _models(cfg, state, lay, groups):
    """This rank's base and shift models (fp32, CPU) with ``state`` cut by
    ``shard_state``; the shift model adopts the base model's pool."""
    out = []
    for layout in (lay, lay.to_shift()):
        m = Model(cfg, device="cpu", dtype=torch.float32, lay=layout,
                  groups=groups)
        m.load_params(shard_state(state, cfg, layout, groups.rank))
        out.append(m)
    return out


def _fresh_pool(base, shift, num_blocks, bs):
    base.init_paged_cache(num_blocks, bs)
    shift.adopt_paged_cache(base)


def _ulysses(rank, groups, u):
    i, j = divmod(rank, TP)
    lay = Layout(sp=SP, tp=TP)
    sp_group = groups.sp_of(lay)
    blk = slice(i * U_S // SP, (i + 1) * U_S // SP)
    q = torch.from_numpy(u["q"][:, blk, 4 * j:4 * (j + 1)])
    k = torch.from_numpy(u["k"][:, blk, j:j + 1])
    v = torch.from_numpy(u["v"][:, blk, j:j + 1])
    ke = expand_kv_for_send(k, U_PLAN, SP, lay.tp_rank(rank))
    ve = expand_kv_for_send(v, U_PLAN, SP, lay.tp_rank(rank))
    qs, ks, vs = ulysses_scatter_heads([q, ke, ve[..., :8]], sp_group)
    g0, g1 = ulysses_gather_heads([qs, ks[..., :8]], sp_group)
    return {name: t.numpy() for name, t in zip(
        ("ke", "ve", "qs", "ks", "vs", "g0", "g1"),
        (ke, ve, qs, ks, vs, g0, g1))}


def _logits(rank, groups, state, cfg, sp, tp):
    """Both configs' step logits (this rank's vocabulary columns) over
    ``STEPS``, each config on a fresh pool."""
    base, shift = _models(cfg, state, Layout(sp=sp, tp=tp), groups)
    rng = np.random.default_rng(1)
    toks = [rng.integers(1, cfg.vocab_size, (4, 8)).astype(np.int32)
            for _ in STEPS]
    out = {}
    for name, m in (("base", base), ("shift", shift)):
        _fresh_pool(base, shift, 17, 4)
        out[name] = [m.forward_mixed(t, ql, off, STEP_BT, sample=False)[0]
                     .numpy() for t, (ql, off) in zip(toks, STEPS)]
        out[name + "_tp_rank"] = m.shard.tp_rank
    return out


def _drive(rank, groups, state, cfg, toks, sp, tp, steps=3):
    """``tests/test_workprop_attention.py``'s ``_drive_mixed`` on the port:
    prefill under base, then decodes alternating shift and base over the
    same pool."""
    base, shift = _models(cfg, state, Layout(sp=sp, tp=tp), groups)
    B, bs, nmax = 8, 8, 4
    bt = 1 + np.arange(B * nmax, dtype=np.int32).reshape(B, nmax)
    _fresh_pool(base, shift, B * nmax + 1, bs)
    one = np.ones((B,), np.int32)
    t, _ = base.forward_mixed(toks, np.full((B,), 16, np.int32),
                              np.zeros((B,), np.int32), bt)
    stream = [t.numpy()]
    offs = np.full((B,), 16, np.int32)
    for step in range(steps):
        m = shift if step % 2 == 0 else base
        tk = t.numpy().astype(np.int32)[:, None]
        if m is base:                      # the chunk axis covers sp
            tk = np.pad(tk, ((0, 0), (0, sp - 1)))
        t, _ = m.forward_mixed(tk, one, offs, bt)
        stream.append(t.numpy())
        offs = offs + 1
    return stream


def _invariance(rank, groups, state, cfg, toks):
    """Base prefills row 0 into blocks 1 and 2; shift runs row 1, which
    reads them through its table and writes blocks 3 and 4."""
    base, shift = _models(cfg, state, Layout(sp=SP, tp=TP), groups)
    B, bs, nmax = 2, 8, 4
    _fresh_pool(base, shift, B * nmax + 1, bs)
    bt = np.zeros((B, nmax), np.int32)
    bt[0, :2] = (1, 2)
    base.forward_mixed(toks, [16, 0], [0, 0], bt)
    before = INV.snapshot_blocks(base.pool, [1, 2])
    bt2 = np.zeros((B, nmax), np.int32)
    bt2[1] = (1, 2, 3, 4)
    toks2 = np.where(np.arange(B)[:, None] == 1, toks, 0).astype(np.int32)
    fresh = base.pool.k[:, 3:5].abs().sum().item()
    shift.forward_mixed(toks2, [0, 16], [16, 16], bt2)
    return {"holds": INV.verify_paged_invariance(base, shift, rank, [1, 2],
                                                 before),
            # blocks 3 and 4 were empty and the shift pass wrote them
            "wrote": fresh == 0 < base.pool.k[:, 3:5].abs().sum().item(),
            "slots": (list(INV.kv_slots(base, rank)),
                      list(INV.kv_slots(shift, rank)))}


def _engine(rank, groups, state, cfg, kw):
    base, shift = _models(cfg, state, Layout(sp=SP, tp=TP), groups)
    groups.traffic.clear()
    eng = ShiftEngine(base, EngineConfig(**kw), shift=shift)
    reqs = [Request(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        serve.print_summary(eng)
    return {"streams": [r.generated for r in reqs],
            "counts": dict(eng.config_counts), "preempt": eng.preemptions,
            "free": eng.kv.num_free_blocks, "total": eng.kv.num_blocks,
            "shared_pool": eng.base.pool is eng.shift.pool,
            "traffic": dict(groups.traffic), "summary": text.getvalue()}


# the prefix + spec engine: 4 slots, chunk 8, blocks of 8, threshold 4, a
# shared 16-token prefix before repetitive prompts, 10 new tokens
PS_KW = dict(max_slots=4, s_max=64, prefill_chunk=8, block_size=8)
PS_PROMPTS = [list(range(1000, 1016)) + ([2, 3, 4] * 4)[:9 + i]
              for i in range(4)]
PS_NEW = 10


def _prefix_spec_port(eng, make=Request):
    """Serve the prefix + spec workload on ``eng`` (the port's, or the
    reference's with its ``Request``); the spec counts come from either
    engine's obs counters."""
    reqs = [make(i, list(p), max_new_tokens=PS_NEW)
            for i, p in enumerate(PS_PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return {"streams": [r.generated for r in reqs],
            "cached": [r.cached_tokens for r in reqs],
            "counts": dict(eng.config_counts),
            "stats": eng.prefix_stats.as_dict(),
            "spec": (eng.obs.registry.counter_total("spec_proposed_total"),
                     eng.obs.registry.counter_total("spec_accepted_total")),
            "used": eng.block_accounting().used,
            "pinned": eng.block_accounting().pinned}


def _prefix_spec_config():
    from repro_torch.engine.api import PrefixConfig
    from repro_torch.spec import SpecConfig
    return EngineConfig(prefix=PrefixConfig(enabled=True),
                        spec=SpecConfig(k=4), threshold=4, **PS_KW)


def _engine_prefix_spec(rank, groups, state, cfg):
    base, shift = _models(cfg, state, Layout(sp=SP, tp=TP), groups)
    return _prefix_spec_port(ShiftEngine(base, _prefix_spec_config(),
                                         shift=shift))


def _graphed_refused(groups, cfg, state):
    base, shift = _models(cfg, state, Layout(sp=SP, tp=TP), groups)
    _fresh_pool(base, shift, 9, 8)
    try:
        Deployment.build(base, shift, mixed=True, paged=True, graphed=True)
    except ValueError as e:
        return str(e)
    return None


def _own_init(rank, groups, cfg):
    """A sharded model's own draw against the trivial model's, cut."""
    triv = Model(cfg, device="cpu", dtype=torch.float32)
    triv.init_params(torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in triv.params.state_dict().items()}
    ok = []
    for lay in (Layout(sp=SP, tp=TP), Layout(sp=SP, tp=TP).to_shift()):
        m = Model(cfg, device="cpu", dtype=torch.float32, lay=lay,
                  groups=groups)
        m.init_params(torch.Generator().manual_seed(0))
        want = shard_state(state, cfg, lay, rank)
        got = m.params.state_dict()
        ok.append(set(got) == set(want) and all(
            np.array_equal(got[k].numpy(), want[k]) for k in want))
    return ok


def _reshard_params(rank, groups, groups14, inputs, cfg):
    """``reshard_params`` between the base (2, 2) grid, its shift config
    and (1, 1, 4) on the grid (1, 4), for the key-0 state and a key-1 one;
    each model's state as numpy, and its logits over ``STEPS``."""
    from repro_torch.ft import reshard_params
    lay = Layout(sp=SP, tp=TP)

    def model(layout, g, state=None):
        m = Model(cfg, device="cpu", dtype=torch.float32, lay=layout,
                  groups=g)
        if state is not None:
            m.load_params(shard_state(state, cfg, layout, rank))
        return m

    def sd(m):
        return {k: v.numpy().copy() for k, v in m.params.state_dict().items()}

    def equal(a, b):
        return set(a) == set(b) and all(
            a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
            for k in a)

    groups.traffic.clear()
    a = model(lay, groups, inputs["state"])
    wide = reshard_params(a, model(Layout(tp=4), groups14))
    back = reshard_params(wide, model(lay, groups))
    shift = reshard_params(a, model(lay.to_shift(), groups))
    shift1 = reshard_params(model(lay, groups, inputs["state_k1"]),
                            model(lay.to_shift(), groups))
    out = {"wide": equal(sd(wide), shard_state(inputs["state"], cfg,
                                               Layout(tp=4), rank)),
           "round_trip": equal(sd(back), sd(a)),
           "shift": sd(shift), "shift1": sd(shift1),
           "shift1_own": equal(sd(shift1), shard_state(
               inputs["state_k1"], cfg, lay.to_shift(), rank)),
           "weights_calls": groups.traffic["reshard_weights_calls"]}
    rng = np.random.default_rng(1)
    toks = [rng.integers(1, cfg.vocab_size, (4, 8)).astype(np.int32)
            for _ in STEPS]
    logits = {}
    for name, m in (("base", a), ("shift", shift), ("wide", wide)):
        m.init_paged_cache(17, 4)
        logits[name] = [m.forward_mixed(t, ql, off, STEP_BT, sample=False)[0]
                        .numpy() for t, (ql, off) in zip(toks, STEPS)]
        logits[name + "_tp_rank"] = m.shard.tp_rank
    out["logits"] = logits
    return out


def _job(rank, groups, inputs):
    cfg, padded = _cfg(), _cfg(padded=True)
    state, pstate = inputs["state"], inputs["padded_state"]
    out = {"rank": rank, "ulysses": _ulysses(rank, groups, inputs["u"]),
           "own_init": _own_init(rank, groups, cfg)}
    out["shard_state"] = {
        name: shard_state(state, cfg, lay, rank) for name, lay in (
            ("base", Layout(sp=SP, tp=TP)),
            ("shift", Layout(sp=SP, tp=TP).to_shift()))}
    out["logits22"] = _logits(rank, groups, state, cfg, SP, TP)
    out["logits_padded"] = _logits(rank, groups, pstate, padded, SP, TP)
    groups41 = Groups(4, 1)
    out["logits41"] = _logits(rank, groups41, state, cfg, 4, 1)
    out["drive22"] = _drive(rank, groups, state, cfg, inputs["drive_toks"],
                            SP, TP)
    out["drive41"] = _drive(rank, groups41, state, cfg, inputs["drive_toks"],
                            4, 1)
    out["invariance"] = _invariance(rank, groups, state, cfg,
                                    inputs["inv_toks"])
    out["engine"] = {name: _engine(rank, groups, state, cfg, kw)
                     for name, kw in (("free", {}), ("tight", TIGHT))}
    out["prefix_spec"] = _engine_prefix_spec(rank, groups, state, cfg)
    out["graphed"] = _graphed_refused(groups, cfg, state)
    out["reshard"] = _reshard_params(rank, groups, Groups(1, 4), inputs, cfg)
    out["reshard_logits"] = out["reshard"].pop("logits")
    return out


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
def _randomize_norms(tree, rng):
    return {k: (_randomize_norms(v, rng) if isinstance(v, dict)
                else rng.standard_normal(v.shape).astype(v.dtype)
                if k in ("scale", "q_norm", "k_norm") else v)
            for k, v in tree.items()}


def _jax_cfg(padded=False):
    from conftest import reduced_cfg
    cfg = reduced_cfg("qwen3-8b")
    return dataclasses.replace(cfg, num_heads=6) if padded else cfg


def _ref_params(model, key=0):
    import jax
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.key(key)))
    return _randomize_norms(tree, np.random.default_rng(0))


class Reference:
    """The reference's models on a (1, sp, tp) mesh, base and shift, with
    their params (norms randomized as in the port's state)."""

    def __init__(self, mesh, padded=False):
        import jax.numpy as jnp
        from repro.models.model import Model as JaxModel
        from repro.parallel import Layout as JaxLayout
        cfg = _jax_cfg(padded)
        self.mesh = mesh
        self.lay = JaxLayout.from_mesh(mesh, dp=("data",), sp=("sp",),
                                       tp=("tp",))
        self.mb = JaxModel(cfg=cfg, lay=self.lay, mesh=mesh,
                           dtype=jnp.float32)
        self.ms = JaxModel(cfg=cfg, lay=self.lay.to_shift(), mesh=mesh,
                           dtype=jnp.float32)
        self.pb, self.ps = _ref_params(self.mb), _ref_params(self.ms)


def _trivial_state(padded=False, key=0):
    from repro.models import build_model
    import jax.numpy as jnp
    jm = build_model(_jax_cfg(padded), dtype=jnp.float32)
    return from_jax_params(_ref_params(jm, key), _cfg(padded))


def _device_shard(arr, dev):
    return np.asarray(next(s.data for s in arr.addressable_shards
                           if s.device == dev))


def _ref_ulysses(mesh, u):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.core.ulysses import (expand_kv_for_send as jexpand,
                                    ulysses_gather_heads as jgather,
                                    ulysses_scatter_heads as jscatter)
    from repro.parallel import Layout as JaxLayout
    from repro.parallel.compat import shard_map
    lay = JaxLayout.from_mesh(mesh, dp=("data",), sp=("sp",), tp=("tp",))

    def body(q, k, v):
        j = jax.lax.axis_index("tp")
        ke = jexpand(k, U_PLAN, SP, j)
        ve = jexpand(v, U_PLAN, SP, j)
        qs, ks, vs = jscatter([q, ke, ve[..., :8]], lay)
        g0, g1 = jgather([qs, ks[..., :8]], lay)
        return ke, ve, qs, ks, vs, g0, g1

    seq_heads = P(None, "sp", "tp", None)
    heads = P(None, None, ("tp", "sp"), None)
    fn = shard_map(body, mesh=mesh, in_specs=(seq_heads,) * 3,
                   out_specs=(seq_heads, seq_heads, heads, heads, heads,
                              seq_heads, seq_heads), check_vma=False)
    outs = jax.jit(fn)(*(jnp.asarray(u[n]) for n in ("q", "k", "v")))
    names = ("ke", "ve", "qs", "ks", "vs", "g0", "g1")
    return {(i, j): {n: _device_shard(o, mesh.devices[0, i, j])
                     for n, o in zip(names, outs)}
            for i in range(SP) for j in range(TP)}


def _ref_logits(ref):
    """Global logits [B, G·v_loc] of each config over ``STEPS``, each on a
    fresh pool, with the port's tokens."""
    import jax
    import jax.numpy as jnp
    cfg = ref.mb.cfg
    rng = np.random.default_rng(1)
    toks = [rng.integers(1, cfg.vocab_size, (4, 8)).astype(np.int32)
            for _ in STEPS]
    out = {}
    for name, m, p in (("base", ref.mb, ref.pb), ("shift", ref.ms, ref.ps)):
        fwd = jax.jit(m.forward_fn(sample=False))
        pool = m.init_paged_cache(17, 4)
        out[name] = []
        for t, (ql, off) in zip(toks, STEPS):
            lg, pool = fwd(p, pool, jnp.asarray(t), jnp.asarray(ql, jnp.int32),
                           jnp.asarray(off, jnp.int32), jnp.asarray(STEP_BT))
            out[name].append(np.asarray(lg))
    return out


def _ref_drive(ref, toks, steps=3):
    """``_drive_mixed`` of ``tests/test_workprop_attention.py``, with the
    base config's decode chunk padded to its sp degree."""
    import jax
    import jax.numpy as jnp
    B, bs, nmax = 8, 8, 4
    bt = jnp.asarray(1 + np.arange(B * nmax).reshape(B, nmax), jnp.int32)
    offs = jnp.zeros((B,), jnp.int32)
    ql = jnp.full((B,), 16, jnp.int32)
    one = jnp.ones((B,), jnp.int32)
    pool = ref.mb.init_paged_cache(B * nmax + 1, bs)
    fwd_b, fwd_s = jax.jit(ref.mb.forward_fn()), jax.jit(ref.ms.forward_fn())
    t, pool = fwd_b(ref.pb, pool, jnp.asarray(toks), ql, offs, bt)
    stream = [np.asarray(t)]
    offs = jnp.full((B,), 16, jnp.int32)
    for step in range(steps):
        shift = step % 2 == 0
        tk = t.astype(jnp.int32)[:, None]
        if not shift:
            tk = jnp.pad(tk, ((0, 0), (0, ref.lay.sp - 1)))
        t, pool = (fwd_s if shift else fwd_b)(ref.ps if shift else ref.pb,
                                              pool, tk, one, offs, bt)
        stream.append(np.asarray(t))
        offs = offs + 1
    return stream


def _ref_engine(ref, kw):
    import jax
    import jax.numpy as jnp
    from repro.core.policy import ThresholdPolicy as JaxPolicy
    from repro.engine import EngineConfig as JaxEngineConfig
    from repro.engine import Request as JaxRequest
    from repro.engine import ShiftEngine as JaxEngine
    pb = jax.tree.map(jnp.asarray, ref.pb)
    ps = jax.tree.map(jnp.asarray, ref.ps)
    eng = JaxEngine(ref.mb, ref.ms, pb, ps, JaxEngineConfig(**kw),
                    policy=JaxPolicy(32))
    reqs = [JaxRequest(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return ([r.generated for r in reqs], eng.config_counts, eng.preemptions,
            eng.kv.num_free_blocks)


def _ref_prefix_spec(ref):
    import jax
    import jax.numpy as jnp
    from repro.core.policy import ThresholdPolicy as JaxPolicy
    from repro.engine import EngineConfig as JaxEngineConfig
    from repro.engine import PrefixConfig as JaxPrefixConfig
    from repro.engine import Request as JaxRequest
    from repro.engine import ShiftEngine as JaxEngine
    from repro.spec import SpecConfig as JaxSpecConfig
    eng = JaxEngine(ref.mb, ref.ms, jax.tree.map(jnp.asarray, ref.pb),
                    jax.tree.map(jnp.asarray, ref.ps),
                    JaxEngineConfig(prefix=JaxPrefixConfig(enabled=True),
                                    spec=JaxSpecConfig(k=4), **PS_KW),
                    policy=JaxPolicy(4))
    return _prefix_spec_port(eng, JaxRequest)


def _one_rank_engine(state, kw):
    model = Model(_cfg(), device="cpu", dtype=torch.float32)
    model.load_params(state)
    eng = ShiftEngine(model, EngineConfig(**kw))
    reqs = [Request(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return ([r.generated for r in reqs], eng.config_counts, eng.preemptions,
            eng.kv.num_free_blocks)


@pytest.fixture(scope="module")
def inputs():
    import jax
    rng = np.random.default_rng(0)
    u = {"q": rng.standard_normal((U_B, U_S, 8, U_C)).astype(np.float32),
         "k": rng.standard_normal((U_B, U_S, 2, U_C)).astype(np.float32),
         "v": rng.standard_normal((U_B, U_S, 2, U_C)).astype(np.float32)}
    vocab = _cfg().vocab_size
    return {"state": _trivial_state(), "padded_state": _trivial_state(True),
            "state_k1": _trivial_state(key=1), "u": u,
            "drive_toks": np.asarray(jax.random.randint(
                jax.random.key(1), (8, 16), 0, vocab), np.int32),
            "inv_toks": np.asarray(jax.random.randint(
                jax.random.key(1), (2, 16), 1, vocab), np.int32)}


@pytest.fixture(scope="module")
def ranks(inputs):
    """The one four-rank job of this module."""
    return mesh.run_ranks(_job, SP, TP, device="cpu", backend="gloo",
                          timeout_s=120, args=(inputs,))


@pytest.fixture(scope="module")
def ref22(mesh122):
    return Reference(mesh122)


def _coords():
    return [(r, *divmod(r, TP)) for r in range(SP * TP)]


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_layout_matches_reference(mesh122):
    from repro.parallel import Layout as JaxLayout
    ref = JaxLayout.from_mesh(mesh122, dp=("data",), sp=("sp",), tp=("tp",))
    lay = Layout(sp=SP, tp=TP)
    for mine, theirs in ((lay, ref), (lay.to_shift(), ref.to_shift())):
        assert mine.signature == theirs.signature
        assert mine.describe() == theirs.describe()
        assert mine.G == theirs.G == 4
    assert lay.to_shift().signature == (1, 1, 4, 1)
    assert lay.to_shift().grid == lay.grid == (2, 2)
    # rank r = i*tp + j: model rank j*sp + i in both configs, the paper's
    # head order
    assert [lay.model_rank(r) for r in range(4)] == [0, 2, 1, 3]
    assert [lay.to_shift().tp_rank(r) for r in range(4)] == [0, 2, 1, 3]
    assert INV.head_order_base(SP, TP) == [0, 2, 1, 3]
    assert INV.head_order_base(3, 2) == [0, 2, 4, 1, 3, 5]
    # dp rows build (tests/test_torch_dp.py holds them); an ep degree
    # raises: EP follows models.moe.ep_group over the named axes
    assert Layout(dp=2, sp=SP, tp=TP).world == 8
    with pytest.raises(ValueError, match="ep=2.*ep_group"):
        Layout(ep=2)
    with pytest.raises(ValueError):
        Layout(sp=2, tp=1, grid=(2, 2))


def test_head_plan_maps_match_reference():
    from repro.parallel.heads import plan_heads as jplan
    for hq, hkv, G, tp in ((4, 2, 4, 2), (6, 2, 4, 2), (32, 8, 4, 2),
                           (4, 2, 4, 1), (4, 2, 4, 4), (28, 4, 8, 2)):
        mine, theirs = plan_heads(hq, hkv, G, tp), jplan(hq, hkv, G, tp)
        assert mine.h_kv_exp_base == theirs.h_kv_exp_base
        assert mine.h_kv_exp_shift == theirs.h_kv_exp_shift
        for sp in (s for s in (1, 2, 4) if G % s == 0 and G // s == tp):
            np.testing.assert_array_equal(mine.a2a_send_map(sp),
                                          theirs.a2a_send_map(sp))
        np.testing.assert_array_equal(mine.kv_expand_map(2 * hkv),
                                      theirs.kv_expand_map(2 * hkv))


def test_ulysses_bitwise(ranks, inputs, mesh122):
    want = _ref_ulysses(mesh122, inputs["u"])
    for r, i, j in _coords():
        got = ranks[r]["ulysses"]
        for name, w in want[(i, j)].items():
            assert got[name].shape == w.shape, name
            np.testing.assert_array_equal(_bits(got[name]), _bits(w),
                                          err_msg=f"rank {r} {name}")
    # the scatter really exchanged: sp rank i's q slots differ by rank
    assert not np.array_equal(ranks[0]["ulysses"]["qs"],
                              ranks[2]["ulysses"]["qs"])


def test_shard_state_bitwise(ranks, ref22):
    import jax
    for name, m, p in (("base", ref22.mb, ref22.pb),
                       ("shift", ref22.ms, ref22.ps)):
        placed = jax.device_put(p, m.shardings(m.param_specs()))
        for r, i, j in _coords():
            dev = ref22.mesh.devices[0, i, j]
            want = from_jax_params(jax.tree.map(
                lambda a: _device_shard(a, dev), placed), _cfg())
            got = ranks[r]["shard_state"][name]
            assert set(got) == set(want)
            for k in want:
                assert got[k].shape == want[k].shape, (name, r, k)
                np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                              err_msg=f"{name} rank {r} {k}")


def test_sharded_init_equals_trivial_init_cut(ranks):
    assert all(all(res["own_init"]) for res in ranks)


def _assemble(ranks, key, config, G):
    """Global logits of one config from the ranks' vocabulary columns,
    placed by tp rank; replicas of one tp rank must agree bitwise."""
    by_tp = {}
    for res in ranks:
        lg = res[key][config]
        tpr = res[key][config + "_tp_rank"]
        if tpr in by_tp:
            for a, b in zip(by_tp[tpr], lg):
                np.testing.assert_array_equal(_bits(a), _bits(b))
        by_tp[tpr] = lg
    n = len(by_tp)
    return [np.concatenate([by_tp[t][s] for t in range(n)], axis=-1)
            for s in range(len(STEPS))]


@pytest.mark.parametrize("key,shape,padded", [
    ("logits22", (1, 2, 2), False), ("logits41", (1, 4, 1), False),
    ("logits_padded", (1, 2, 2), True)],
    ids=["sp2-tp2", "sp4-tp1", "padded-heads"])
def test_mixed_logits_match_reference(ranks, key, shape, padded):
    from conftest import make_mesh
    ref = Reference(make_mesh(shape), padded=padded)
    want = _ref_logits(ref)
    for config in ("base", "shift"):
        got = _assemble(ranks, key, config, 4)
        for g, w in zip(got, want[config]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                       err_msg=f"{key} {config}")
            assert np.abs(w).max() > 0.1      # real logits, not zeros
    if padded:
        assert plan_heads(6, 2, 4, 2).h_q_pad == 8     # pad slots masked


@pytest.mark.parametrize("key,shape", [("drive22", (1, 2, 2)),
                                       ("drive41", (1, 4, 1))],
                         ids=["sp2-tp2", "sp4-tp1"])
def test_drive_mixed_streams_match_reference(ranks, inputs, key, shape):
    from conftest import make_mesh
    want = _ref_drive(Reference(make_mesh(shape)), inputs["drive_toks"])
    for res in ranks:
        assert len(res[key]) == len(want)
        for g, w in zip(res[key], want):
            np.testing.assert_array_equal(g, w)


def test_invariance_holds_on_written_pools(ranks):
    order = INV.head_order_base(SP, TP)            # slot -> owning rank
    for r, res in enumerate(ranks):
        inv = res["invariance"]
        assert inv["holds"], f"rank {r}"
        assert inv["wrote"], f"rank {r}: the shift pass wrote nothing"
        base_slots, shift_slots = inv["slots"]
        assert base_slots == shift_slots
        assert [order[s] for s in base_slots] == [r]


@pytest.mark.parametrize("name,kw", [("free", {}), ("tight", TIGHT)],
                         ids=["no-pressure", "tight-pool"])
def test_engine_matches_reference(ranks, ref22, inputs, name, kw):
    want = _ref_engine(ref22, kw)
    one = _one_rank_engine(inputs["state"], kw)
    for r, res in enumerate(ranks):
        e = res["engine"][name]
        got = (e["streams"], e["counts"], e["preempt"], e["free"])
        assert got == want, f"rank {r}"
        assert e["free"] == e["total"] - 1
        assert e["shared_pool"]
    assert one == want
    e = ranks[0]["engine"][name]
    assert e["counts"]["base"] > 0 and e["counts"]["shift"] > 0
    assert all(len(s) == MAX_NEW for s in e["streams"])
    if kw:
        assert e["preempt"] > 0
    assert e["traffic"]["all_to_all_calls"] > 0
    assert e["traffic"]["all_reduce_calls"] > 0
    assert "dp1·sp2·tp2" in e["summary"] and "gloo" in e["summary"]
    assert "eager steps" in e["summary"] and "dp1·sp1·tp4" in e["summary"]


def test_prefix_spec_engine_matches_reference(ranks, ref22, inputs):
    """The SPMD engine with the prefix cache and k=4 on (2, 2): every
    rank's streams, cached tokens, config counts, prefix stats and spec
    counts equal the reference's on mesh122 and the one-rank engine's."""
    want = _ref_prefix_spec(ref22)
    model = Model(_cfg(), device="cpu", dtype=torch.float32)
    model.load_params(inputs["state"])
    one = _prefix_spec_port(ShiftEngine(model, _prefix_spec_config()))
    assert one == want
    for r, res in enumerate(ranks):
        assert res["prefix_spec"] == want, f"rank {r}"
    assert want["stats"]["hits"] > 0 and want["cached"][-1] >= 16
    assert 0 < want["spec"][1] < want["spec"][0]
    assert want["counts"]["base"] > 0 and want["counts"]["shift"] > 0
    assert want["used"] == want["pinned"] == want["stats"]["entries"]


def _ref_shards(ref, tree, model):
    """The reference's ``tree``, placed by ``model``'s specs on ``ref``'s
    mesh, as each port rank's state."""
    import jax
    placed = jax.device_put(tree, model.shardings(model.param_specs()))
    return {r: from_jax_params(jax.tree.map(
        lambda a: _device_shard(a, ref.mesh.devices[0, i, j]), placed),
        _cfg()) for r, i, j in _coords()}


def test_reshard_params_round_trip_bitwise(ranks):
    """(1, 2, 2) -> (1, 1, 4) -> (1, 2, 2) at the world size of four (the
    reference's round trip is (1, 2, 2) <-> (1, 4, 2): the port's reshard
    keeps its processes): every rank's weights come back bitwise, the wide
    ones are ``shard_state``'s, and the weights went through the gathers."""
    for r, res in enumerate(ranks):
        rs = res["reshard"]
        assert rs["wide"] and rs["round_trip"], f"rank {r}"
        assert rs["weights_calls"] > 0


def test_reshard_params_expands_like_the_reference(ranks, ref22):
    """Base -> shift materializes KV replication: wk/wv change shape. With
    the key-0 weights every leaf equals the reference's ``reshard_params``
    bitwise. With key-1 weights the port derives the expanded leaves from
    the gathered weights (``shard_state`` of them), while the reference
    re-draws them from ``init_params(key(0))``: those leaves differ, every
    other leaf is equal (ROADMAP Queue 3, a difference by design)."""
    import jax
    from repro.ft import reshard_params as jax_reshard
    out = jax_reshard(ref22.pb, ref22.mb, ref22.ms)
    want = _ref_shards(ref22, out, ref22.ms)
    # the leaves whose global shape the shift layout's KV replication
    # changes
    glob = [from_jax_params(jax.tree.map(np.asarray, t), _cfg())
            for t in (ref22.pb, out)]
    expanded = sorted(k for k, v in glob[0].items()
                      if v.shape != glob[1][k].shape)
    assert len(expanded) >= 2 and all(
        k.endswith(("attn.wk", "attn.wv")) for k in expanded)
    k1 = _randomize_norms(jax.tree.map(np.asarray, ref22.mb.init_params(
        jax.random.key(1))), np.random.default_rng(0))
    want1 = _ref_shards(ref22, jax_reshard(k1, ref22.mb, ref22.ms),
                        ref22.ms)
    for r, res in enumerate(ranks):
        rs = res["reshard"]
        assert set(rs["shift"]) == set(want[r])
        for k, v in want[r].items():
            np.testing.assert_array_equal(_bits(rs["shift"][k]), _bits(v),
                                          err_msg=f"rank {r} {k}")
        assert rs["shift1_own"]
        for k, v in want1[r].items():
            same = np.array_equal(_bits(rs["shift1"][k]), _bits(v))
            assert same == (k not in expanded), f"rank {r} {k}"
            if k in expanded:        # the reference's key-0 re-draw
                np.testing.assert_array_equal(_bits(v),
                                              _bits(rs["shift"][k]))


@pytest.mark.parametrize("config", ["shift", "wide"])
def test_resharded_params_produce_same_logits(ranks, config):
    """The resharded shift model, and the (1, 1, 4) one, compute the base
    model's logits (3e-4, as ``tests/test_ft_elastic.py`` and
    ``tests/test_system.py`` hold them)."""
    base = _assemble(ranks, "reshard_logits", "base", 4)
    got = _assemble(ranks, "reshard_logits", config, 4)
    for g, b in zip(got, base):
        assert g.shape == b.shape
        np.testing.assert_allclose(g, b, rtol=3e-4, atol=3e-4)
        assert np.abs(b).max() > 0.1


def test_graphed_above_world_size_one_raises(ranks):
    for res in ranks:
        assert res["graphed"] and "graphed=True" in res["graphed"]


def test_run_ranks_takes_the_backend_as_given():
    """No default and no fallback: NCCL without a card per rank raises
    before anything is spawned, and so does an unknown backend."""
    with pytest.raises(RuntimeError, match="one card per rank"):
        mesh.run_ranks(_job, SP, TP, device="cpu", backend="nccl",
                       timeout_s=10)
    with pytest.raises(ValueError, match="backend"):
        mesh.run_ranks(_job, SP, TP, device="cpu", backend="mpi",
                       timeout_s=10)
