"""whisper-small and internvl2-2b on the layouts: the reference's core
correctness property (``tests/test_equivalence.py``) on the port.

One eight-rank job (``launch.mesh.run_ranks`` over gloo, a module-scoped
fixture) runs reduced whisper-small in fp32 (2 encoder and 2 decoder
layers over 16 frames, 4 query heads over 2 KV heads, so that (1, 4, 2)
pads the query heads to 8 and replicates each KV head 4 times, the cross
projections with them) on base and shift (2, 2, 2) and base (1, 4, 2):
the reference's ``_run`` inputs (B 8, S 16, frames of 0.01, a dense cache
of 32 rows) through ``prefill_step`` and ``decode_step``, every rank its
shard (``shard_state``) of the reference's ``init_params(key(0))`` with
random norm scales and biases. The encoder's frames are cut over sp, as
the reference's ``P(dp, seq, None)`` cuts them. The tests hold, against
the reference's single-device run only:

* the prefill logits, put together from the ranks' rows and vocabulary
  columns, within 3e-4, equal next tokens on every rank, and the logits of
  a second decode step whose positions differ row by row within a rank's
  segment (whisper's sinusoid reads the segment's) within 3e-4;
* the ranks' dense caches put together (``convert.gather_dense_cache``:
  the self and the cross K/V by kv slot) within 3e-4 of their largest
  magnitude of the single-device cache placed by the head plan, and the
  base cache equal to the shift cache on (2, 2, 2);
* on every rank, the base and shift models' dense-cache invariance
  (``core.invariance.verify_dense_invariance``), the cross cache
  included;
* reduced internvl2-2b's prefill and decode with random image embeddings
  on base (2, 2, 2): each sp rank embeds its own columns at their global
  positions, so the stub replaces the right ones (logits within 3e-4,
  equal tokens).

JAX is imported only in this process, inside fixtures.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (from_jax_params, gather_dense_cache,  # noqa: E402
                                 shard_state)
from repro_torch.core import invariance as INV  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import Groups, Layout  # noqa: E402

WHISPER, VLM = "whisper-small", "internvl2-2b"
CONFIGS = (("base", (2, 2, 2)), ("shift", (2, 2, 2)), ("base", (1, 4, 2)))
B, S, S_MAX = 8, 16, 32
# a second decode step's positions, another one for each row of a rank's
# segment (``tests/test_torch_encdec.py``'s ``LENS2``)
LENS2 = (S + 1 + np.arange(B) % 4).astype(np.int32)


def _lay(mode, shape):
    lay = Layout(dp=shape[0], sp=shape[1], tp=shape[2])
    return lay.to_shift() if mode == "shift" else lay


def _step(rank, groups, cfg, state, toks, lay, fe=None, ef=None):
    """This rank's prefill and decode of the reference's ``_run``."""
    m = Model(cfg, device="cpu", dtype=torch.float32, lay=lay,
              groups=groups)
    m.load_params(shard_state(state, cfg, lay, rank))
    m.init_cache(B, S_MAX)
    as_t = (lambda a: None if a is None else torch.as_tensor(a))
    logits = m.prefill_step(torch.as_tensor(toks),
                            torch.zeros((B,), dtype=torch.int32),
                            frontend_embeds=as_t(fe), enc_frames=as_t(ef))
    nxt = m.decode_step(torch.arange(B, dtype=torch.int32) % cfg.vocab_size,
                        torch.full((B,), S, dtype=torch.int32))
    cache = {name: t.numpy().copy() for name, t in m.cache.tensors().items()}
    logits2 = m.decode_step(nxt.int(), torch.as_tensor(LENS2), sample=False)
    return {"logits": logits.numpy(), "next": nxt.numpy(),
            "logits2": logits2.numpy(), "cache": cache,
            "tp_rank": m.shard.tp_rank, "dp_rank": m.shard.dp_rank,
            "sp_rank": m.shard.sp_rank}


def _job(rank, groups, whisper, vlm):
    grids = {(2, 2, 2): groups, (1, 4, 2): Groups(4, 2)}
    cfg = get_config(WHISPER).reduced()
    out = {}
    for mode, shape in CONFIGS:
        out[(mode, shape)] = _step(rank, grids[shape], cfg, whisper["state"],
                                   whisper["toks"], _lay(mode, shape),
                                   ef=whisper["ef"])
    models = []
    for la in (Layout(dp=2, sp=2, tp=2), Layout(dp=2, sp=2, tp=2).to_shift()):
        m = Model(cfg, device="cpu", dtype=torch.float32, lay=la,
                  groups=groups)
        m.load_params(shard_state(whisper["state"], cfg, la, rank))
        models.append(m)
    base, shift = models
    base.init_cache(B, S_MAX)
    shift.adopt_cache(base)
    out["invariance"] = {
        "holds": INV.verify_dense_invariance(base, shift, rank),
        "slots": list(INV.kv_slots(base, rank)),
        "cross_shape": tuple(base.cache.cross_k.shape)}
    out["vlm"] = _step(rank, groups, get_config(VLM).reduced(), vlm["state"],
                       vlm["toks"], Layout(dp=2, sp=2, tp=2), fe=vlm["fe"])
    return out


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    """The reference's single-device runs of both archs and their converted
    weights."""
    from test_torch_encdec import extras, ref_model, ref_run
    from repro_torch.convert import from_jax_cache
    out = {}
    for arch in (WHISPER, VLM):
        jm, tree = ref_model(arch)
        fe, ef = extras(jm.cfg, np.random.default_rng(7))
        run = ref_run(jm, tree, fe, ef)
        cfg = get_config(arch).reduced()
        out[arch] = {"state": from_jax_params(tree, cfg), "fe": fe, "ef": ef,
                     "toks": run["toks"], "logits": run["logits"],
                     "next": run["next"], "logits2": run["logits2"],
                     "cache": {k: v.numpy() for k, v in from_jax_cache(
                         run["cache"], cfg, paged=False).items()}}
    return out


@pytest.fixture(scope="module")
def ranks(reference):
    return mesh.run_ranks(_job, 2, 2, dp=2, device="cpu", backend="gloo",
                          timeout_s=300,
                          args=(reference[WHISPER], reference[VLM]))


def _logits(ranks, key):
    """The global [B, G·v_blk] logits from the ranks' [B/dp, v_blk] parts,
    rows by dp rank and columns by tp rank; ranks holding one part must
    agree bitwise."""
    parts = {}
    for res in ranks:
        r = res[key]
        at = (r["dp_rank"], r["tp_rank"])
        if at in parts:
            np.testing.assert_array_equal(parts[at], r["logits"])
        parts[at] = r["logits"]
    dp = 1 + max(d for d, _ in parts)
    tp = 1 + max(t for _, t in parts)
    return np.concatenate([np.concatenate([parts[(d, t)] for t in range(tp)],
                                          axis=-1) for d in range(dp)])


def _decode_logits(ranks, key):
    """The second decode step's global [B, G·v_blk] logits from the ranks'
    [B/(dp·sp), v_blk] segments: rows by dp rank then sp rank, columns by
    tp rank."""
    parts = {}
    for res in ranks:
        r = res[key]
        parts[(r["dp_rank"], r["sp_rank"], r["tp_rank"])] = r["logits2"]
    dp, sp, tp = (1 + max(k[i] for k in parts) for i in range(3))
    return np.concatenate([
        np.concatenate([parts[(d, i, t)] for t in range(tp)], axis=-1)
        for d in range(dp) for i in range(sp)])


def _placed(cache, cfg, lay):
    """The single-device cache as the layout's global arrays: kv slot ``s``
    of the plan's ``kv_slots_total`` holds padded kv head ``s * h_kv_pad //
    kv_slots_total`` (``HeadPlan.a2a_send_map``'s rule), a pad head
    zeros; the self and the cross caches alike."""
    from repro_torch.models.attention import get_plan
    plan = get_plan(cfg, lay)
    n = plan.kv_slots_total
    orig = [plan.kv_slot_to_orig[s * plan.h_kv_pad // n] for s in range(n)]
    return {name: np.stack([a[:, :, :, o] if o >= 0 else
                            np.zeros_like(a[:, :, :, 0]) for o in orig],
                           axis=3)
            for name, a in cache.items()}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,shape", CONFIGS,
                         ids=["base-222", "shift-222", "base-142"])
def test_whisper_logits_and_tokens_match_single_device(ranks, reference,
                                                       mode, shape):
    want = reference[WHISPER]
    key = (mode, shape)
    got = _logits(ranks, key)
    V = want["logits"].shape[-1]
    assert got.shape[0] == B and got.shape[1] >= V
    np.testing.assert_allclose(got[:, :V], want["logits"], rtol=3e-4,
                               atol=3e-4, err_msg=f"{key} logits")
    assert np.abs(want["logits"]).max() > 0.1
    for res in ranks:
        np.testing.assert_array_equal(res[key]["next"], want["next"],
                                      err_msg=f"{key} tokens")
    np.testing.assert_allclose(_decode_logits(ranks, key)[:, :V],
                               want["logits2"], rtol=3e-4, atol=3e-4,
                               err_msg=f"{key} second decode's logits")



def test_whisper_gathered_caches_match_and_base_equals_shift(ranks,
                                                             reference):
    cfg = get_config(WHISPER).reduced()
    got = {}
    for mode, shape in CONFIGS:
        key, lay = (mode, shape), _lay(mode, shape)
        got[key] = gather_dense_cache([res[key]["cache"] for res in ranks],
                                      cfg, lay)
        want = _placed(reference[WHISPER]["cache"], cfg, lay)
        assert set(got[key]) == set(want) == {"k", "v", "cross_k",
                                              "cross_v"}
        for name, w in want.items():
            assert got[key][name].shape == w.shape, (key, name)
            scale = np.abs(w).max()
            assert scale > 1, name
            np.testing.assert_allclose(got[key][name], w, rtol=3e-4,
                                       atol=3e-4 * scale,
                                       err_msg=f"{key} {name}")
    # (1, 4, 2): 8 kv slots, each model rank one copy of a kv head, over
    # all 16 frames
    r0 = ranks[0][("base", (1, 4, 2))]["cache"]
    assert r0["cross_k"].shape == (2, B, 16, 1, 16)
    a, b = (got[(mode, (2, 2, 2))] for mode in ("base", "shift"))
    for name in a:
        np.testing.assert_allclose(a[name], b[name], rtol=3e-4, atol=3e-4,
                                   err_msg=name)


def test_whisper_dense_invariance_on_every_rank(ranks):
    order = INV.head_order_base(2, 2)
    for r, res in enumerate(ranks):
        inv = res["invariance"]
        assert inv["holds"], f"rank {r}"
        # one kv slot per model rank, the paper's head order; the cross
        # cache holds the dp row's 4 slots of all 16 frames at that slot
        assert [order[s] for s in inv["slots"]] == [r % 4]
        assert inv["cross_shape"] == (2, B // 2, 16, 1, 16)


def test_internvl2_frontend_embeds_on_base_222(ranks, reference):
    want = reference[VLM]
    assert want["fe"] is not None and want["fe"].shape[1] == 8
    got = _logits(ranks, "vlm")
    V = want["logits"].shape[-1]
    np.testing.assert_allclose(got[:, :V], want["logits"], rtol=3e-4,
                               atol=3e-4)
    for res in ranks:
        np.testing.assert_array_equal(res["vlm"]["next"], want["next"])
    np.testing.assert_allclose(_decode_logits(ranks, "vlm")[:, :V],
                               want["logits2"], rtol=3e-4, atol=3e-4)
