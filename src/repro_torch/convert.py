"""Convert the reference's parameter tree to the port's state.

``from_jax_params`` takes the tree of a ``repro`` ``Model`` built on the
trivial ``Layout()``, as nested dicts of numpy arrays (``jax.tree.map(
np.asarray, params)``, done by the caller), and returns ``{name: array}``
for ``Model.load_params``; ``shard_state`` cuts that state into one rank's
shard of a wider layout, and ``unshard_state`` puts the shards back together
(``ft.elastic.reshard_params`` moves live weights through the pair,
parameter by parameter, with their tensor forms). ``from_jax_cache`` is the
state counterpart: it turns the reference's cache tree (the ``cache`` of its
engine's snapshot) into the port's cache tensors, as
``ShiftEngine.snapshot`` holds them, so that a snapshot the reference took
restores into the port; ``gather_dense_cache`` puts the ranks' dense
caches of a layout together into the reference's global arrays.
``from_jax_opt_state`` converts the reference's optimizer state (AdamW's
``m`` and ``v`` and the int8 compression's ``err``, each a tree of the
parameters' structure), so that a reference checkpoint resumes in the
port. It imports neither jax nor repro.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.attention import attn_layout
from repro_torch.models.layers import shard_of, vocab_shard
from repro_torch.models.mla import mla_layout, mla_unlayout
from repro_torch.models.moe import expert_axes, expert_grid, expert_shard
from repro_torch.models.recurrent import (GROUP_LEAVES, rglru_layout,
                                          rglru_unlayout)
from repro_torch.models.ssd import HEAD_LEAVES, ssd_layout, ssd_unlayout


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + ".")
        else:
            yield name, np.asarray(v)


def _layer_index(name: str, cfg):
    """The port's layer indices of a reference leaf of the layer stack,
    with the rest of its name: ``prefix.{i}.*`` is layer i, ``body.s{k}.*``
    (stacked over the pattern's repeats on axis 0) holds layer ``npre +
    r·len(pattern) + k`` of every repeat r, ``suffix.{i}.*`` is layer
    ``npre + reps·len(pattern) + i``. None for a leaf outside the stack."""
    part, _, rest = name.partition(".")
    npre = len(cfg.prefix_layers)
    body = npre + cfg.pattern_repeats * len(cfg.layer_pattern)
    if part in ("prefix", "suffix"):
        i, _, rest = rest.partition(".")
        if not i.isdigit():
            return None
        return int(i) + (body if part == "suffix" else 0), rest, False
    if part == "body":
        s, _, rest = rest.partition(".")
        if not (s[:1] == "s" and s[1:].isdigit()):
            return None
        return npre + int(s[1:]), rest, True
    return None


def _expected_names(cfg):
    """The port's parameter names for ``cfg`` (a model on the meta
    device, which allocates nothing)."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import Layout
    return set(T.Transformer(cfg, Layout(), torch.float32, "meta")
               .state_dict())


def from_jax_params(tree, cfg) -> Dict[str, np.ndarray]:
    """* the layer stack -> ``layers.{i}.*``, i in the order of
      ``cfg.layer_kinds``: ``prefix.{i}.*``, ``body.s{k}.*`` (stacked over
      the pattern's repeats on axis 0; ``s{k}`` is the pattern's k-th
      kind) and ``suffix.{i}.*``, for an attention block (``ln1``,
      ``attn``, ``ln2``, ``ffn``; an MLA ``attn``'s ``wq_a``, ``q_norm``,
      ``wq_b``, ``wkv_a``, ``kv_norm``, ``wk_b``, ``wv_b``, ``wo``), a MoE
      block (the same, its ``ffn`` the ``router``, the ``wi``/``wg``/
      ``wo`` expert stacks and ``shared.*``), a local block (as an
      attention block), an RG-LRU block (``ln1``, ``mix``, ``ln2``,
      ``ffn``), an SSD block (``ln1``, ``mix``) and a decoder block
      (``ln1``, ``attn``, ``lnx``, ``cross``, ``ln2``, ``ffn``) alike; a
      LayerNorm's ``scale`` and ``bias``, a plain GELU MLP's ``wi`` and
      ``wo``;
    * the encoder's stack ``encoder.*`` (stacked over its layers on axis
      0) -> ``encoder.{e}.*``; ``enc_norm.*`` keeps its name;
    * ``embed.table`` [G, v_loc, d] -> [G*v_loc, d];
    * ``lm_head.w`` [G, d, v_loc] -> [d, G*v_loc] (a tied tree has none:
      the port's tied head reads the table);
    * ``mtp.*``, DeepSeek-V3's multi-token prediction head (``proj``,
      the ``block``'s leaves as an attention block's, ``norm``), keeps its
      names: training reads it, serving does not;
    * ``final_norm.*`` keeps its name.
    Any other leaf, a missing one, or a stack of another depth raises. The
    SSD mixer's ``wbc`` must be the trivial layout's single group, [d,
    2·d_state]; a tree built for TP replicates it and raises."""
    reps, pat = cfg.pattern_repeats, len(cfg.layer_pattern)
    out = {}
    for name, a in _flatten(tree):
        if name.startswith("encoder."):
            if a.shape[0] != cfg.encoder_layers:
                raise ValueError(f"{name}: {a.shape[0]} stacked layers, "
                                 f"config has {cfg.encoder_layers} encoder "
                                 "layers")
            rest = name[len("encoder."):]
            for e in range(cfg.encoder_layers):
                out[f"encoder.{e}.{rest}"] = a[e]
            continue
        at = _layer_index(name, cfg)
        if at is not None:
            first, rest, stacked = at
            if stacked and a.shape[0] != reps:
                raise ValueError(f"{name}: {a.shape[0]} stacked layers, "
                                 f"config has {reps} repeats")
            if rest == "mix.wbc" and a.shape[-2:] != (cfg.d_model,
                                                      2 * cfg.ssm.d_state):
                raise ValueError(
                    f"{name}: shape {a.shape[-2:]}, want the trivial "
                    f"layout's [{cfg.d_model}, {2 * cfg.ssm.d_state}] "
                    "(kexp 1)")
            if stacked:
                for r in range(reps):
                    out[f"layers.{first + r * pat}.{rest}"] = a[r]
            else:
                out[f"layers.{first}.{rest}"] = a
        elif name == "embed.table":
            out[name] = a.reshape(-1, a.shape[-1])
        elif name == "lm_head.w":
            out[name] = a.transpose(1, 0, 2).reshape(a.shape[1], -1)
        else:
            out[name] = a
    want = _expected_names(cfg)
    if set(out) != want:
        extra, missing = sorted(set(out) - want), sorted(want - set(out))
        raise ValueError(f"{cfg.name}: leaves the port has no parameter "
                         f"for {extra[:4]}, parameters missing "
                         f"{missing[:4]}")
    return out


def from_jax_opt_state(tree, cfg) -> dict:
    """The reference's optimizer state of a model on the trivial layout
    (``Trainer.init_opt_state``'s tree, as nested dicts of numpy arrays):
    ``m``, ``v`` and, with int8 compression, ``err`` have the parameters'
    structure and convert as ``from_jax_params`` converts them; ``step``
    becomes an int. Returns ``{"m": {name: array}, "v": ..., ["err":
    ...,] "step": int}``, the global logical trees that
    ``training.checkpoint.load_state`` takes."""
    out = {"step": int(np.asarray(tree["step"]))}
    for key in ("m", "v", "err"):
        if key in tree:
            out[key] = from_jax_params(tree[key], cfg)
    return out


def shard_state(state, cfg, lay, rank: int) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s shard of every parameter of ``state``, the trivial
    layout's (``from_jax_params``), on layout ``lay``, placed as the
    reference's specs place it: the attention's q/k/v columns and its O
    rows over TP after the head plan's padding and KV replication
    (``attn_specs``), the MLP's ``wi``/``wg`` columns and ``wo`` rows over
    TP (a decoder layer's ``cross`` attention as its ``attn``), the
    embedding's rows and the LM head's columns over TP, ``G/tp``
    shards of ``ceil(V/G)`` each (``embed_specs``, ``lmhead_specs``), a
    MoE layer's expert stacks over its EP axes and their FF dim over the
    TP axes outside them (``moe_specs``' ``P(ep, None, tpr)``), its shared
    experts as the MLP and its router whole, an MLA layer's up projections
    and O over the grid's tp alone after padding the heads (``mla_specs``,
    ``models.mla.mla_layout``), an SSD mixer's projections over TP and its
    per-head leaves over the model group after padding the heads
    (``ssd_specs``, ``models.ssd.ssd_layout``), an RG-LRU mixer's x/y
    projections' columns and out projection's rows over TP and its conv,
    gates and Λ over the model group (``rglru_specs``,
    ``models.recurrent.rglru_layout``), and the norms' scales and biases
    whole.
    On a layout with dp rows the rank gets the shard of its grid position
    ``(i, j)``, the same in every row (the reference replicates the
    parameters over ``"data"``), except a pod-scale config's expert stacks,
    whose EP axes may take ``"data"`` (over ``("data", "sp")`` on the base
    config of (2, 2, 2))."""
    return {name: shard_tensor(name, torch.from_numpy(
                np.ascontiguousarray(a)), cfg, lay, rank).contiguous().numpy()
            for name, a in state.items()}


def _mix_kind(name: str, cfg):
    """The layer kind of a mixer leaf ``layers.{i}.mix.*`` (``"ssd"`` or
    ``"rglru"``), None for any other leaf."""
    p = name.split(".")
    if len(p) == 4 and p[0] == "layers" and p[2] == "mix":
        return cfg.layer_kinds[int(p[1])]
    return None


def is_model_group_leaf(name: str, cfg) -> bool:
    """True for the leaves cut over the whole model group (not over TP
    alone): a MoE layer's expert stacks, an SSD mixer's per-head leaves
    and an RG-LRU mixer's conv, gates and Λ. Putting one back together
    takes every model rank's part."""
    leaf = name.split(".")[-1]
    kind = _mix_kind(name, cfg)
    return is_expert_leaf(name, cfg) or (
        kind == "ssd" and leaf in HEAD_LEAVES) or (
        kind == "rglru" and leaf in GROUP_LEAVES)


def is_expert_leaf(name: str, cfg) -> bool:
    """True for a MoE layer's ``ffn.wi``/``wg``/``wo`` expert stack, the
    leaves sharded over the model group's EP and FF axes (not over TP
    alone)."""
    p = name.split(".")
    return (len(p) == 4 and p[0] == "layers" and p[2] == "ffn"
            and p[3] in ("wi", "wg", "wo")
            and cfg.layer_kinds[int(p[1])] == "moe")


def _ff_dim(name: str) -> int:
    return 1 if name.endswith(".wo") else 2


_HEADS = {"wq": "q", "bq": "q", "wo": "q", "wk": "kv", "wv": "kv",
          "bk": "kv", "bv": "kv"}


def _canon_shape(name: str, t: torch.Tensor, h: int, cfg) -> torch.Tensor:
    """Attention parameter ``name`` of ``h`` heads with the heads on axis
    -2: wq/wk/wv [d, h, dh], wo [h, dh·d], biases [h, dh]."""
    d, dh = cfg.d_model, cfg.head_dim
    return (t.reshape(h, dh * d) if name == "wo" else
            t.reshape(d, h, dh) if name[0] == "w" else t.reshape(h, dh))


def shard_tensor(name: str, t: torch.Tensor, cfg, lay,
                 rank: int) -> torch.Tensor:
    """``shard_state`` of one parameter, as a tensor (a view where the
    shard is a slice): process ``rank``'s part of the trivial layout's
    ``t`` on ``lay`` (its tp rank's, or for an expert stack its grid
    position's), in any type and on any device."""
    if is_expert_leaf(name, cfg):
        return expert_shard(t, _ff_dim(name), cfg, lay, rank)
    tp_rank = lay.tp_rank(rank)
    parts = name.split(".")
    if cfg.mla is not None and parts[-2] == "attn":
        return mla_layout(parts[-1], t, cfg, lay, rank)
    if name == "embed.table":
        return vocab_shard(t, 0, lay, tp_rank)
    if name == "lm_head.w":
        return vocab_shard(t, 1, lay, tp_rank)
    if parts[-2] in ("attn", "cross") and parts[-1] in _HEADS:
        h = cfg.num_heads if _HEADS[parts[-1]] == "q" else cfg.num_kv_heads
        return attn_layout(parts[-1], _canon_shape(parts[-1], t, h, cfg),
                           cfg, lay, tp_rank)
    if parts[-2] in ("ffn", "shared") and parts[-1] in ("wi", "wg", "wo"):
        return shard_of(t, 0 if parts[-1] == "wo" else 1, max(lay.tp, 1),
                        tp_rank)
    if _mix_kind(name, cfg) == "rglru":
        return rglru_layout(parts[-1], t, cfg, lay, rank)
    if parts[-2] == "mix":
        return ssd_layout(parts[-1], t, cfg, lay, rank)
    return t


def _row_rank(lay, g: int) -> int:
    """The process rank of model rank ``g`` in dp row 0 of ``lay``."""
    sp, tp = lay.grid
    return (g % sp) * tp + g // sp


def spans_dp(name: str, cfg, lay) -> bool:
    """True for an expert stack whose EP group on ``lay`` takes the
    ``"data"`` axis (a pod-scale config's with dp rows): its parts lie on
    the ranks of every dp row."""
    return is_expert_leaf(name, cfg) and "data" in expert_axes(cfg, lay)


def unshard_ranks(name: str, cfg, lay) -> list:
    """The process ranks whose parts ``unshard_tensor`` takes for ``name``
    on ``lay``, in the order it takes them: every rank of the world, in
    process-rank order, for an expert stack that spans dp rows
    (``spans_dp``); dp row 0's model ranks, in model-rank order, for
    another model-group leaf; else dp row 0's sp rank 0's tp ranks, in tp
    rank order (a leaf that every tp rank holds whole is taken from tp
    rank 0, the copy the reference's ``device_get`` reads)."""
    if spans_dp(name, cfg, lay):
        return list(range(lay.world))
    if is_model_group_leaf(name, cfg):
        return [_row_rank(lay, g) for g in range(max(lay.G, 1))]
    return [r for _, r in sorted((lay.tp_rank(r), r)
                                 for r in range(max(lay.G, 1))
                                 if lay.sp_rank(r) == 0)]


def _unshard_experts(name, parts, cfg, lay) -> torch.Tensor:
    """An expert stack from its blocks: the FF blocks of each EP index
    side by side, then the EP blocks. ``parts`` are every model rank's
    (model-rank order), or every rank's of the world (process-rank order)
    for a stack that spans dp rows."""
    world = spans_dp(name, cfg, lay)
    want = lay.world if world else max(lay.G, 1)
    if len(parts) != want:
        raise ValueError(f"{name}: {len(parts)} shards, want one per "
                         f"{'rank of the world' if world else 'model rank'}"
                         f" ({want})")
    blocks = {}
    for i, part in enumerate(parts):
        ep, e, tpr, t = expert_grid(cfg, lay, i if world
                                    else _row_rank(lay, i))
        blocks.setdefault((e, t), part)
    return torch.cat([torch.cat([blocks[(e, t)] for t in range(tpr)],
                                _ff_dim(name)) for e in range(ep)], 0)


def unshard_tensor(name: str, parts, cfg, lay) -> torch.Tensor:
    """The inverse of ``shard_tensor``: the trivial layout's parameter
    ``name`` from ``parts``, the shards of the ranks ``unshard_ranks``
    names, in its order: every tp rank's shard on ``lay`` in tp rank
    order, or every model rank's (``G`` of them) in model-rank order,
    which a model-group leaf (``is_model_group_leaf``) needs, or every
    rank's of the world, which an expert stack that spans dp rows needs.
    An MLA leaf takes the parts of the grid's tp ranks (``mla_unlayout``).
    The pad slots of the head plan go; of a kv head that KV replication
    repeats, the first copy is taken (every copy is the same head).
    Bitwise: ``shard_tensor`` of the result gives each part back."""
    p = name.split(".")
    tp, G = max(lay.tp, 1), max(lay.G, 1)
    if cfg.mla is not None and p[-2] == "attn":
        return mla_unlayout(p[-1], parts, cfg, lay)
    if is_expert_leaf(name, cfg):
        return _unshard_experts(name, parts, cfg, lay)
    if is_model_group_leaf(name, cfg):
        if len(parts) != G:
            raise ValueError(f"{name}: {len(parts)} shards, want one per "
                             f"model rank ({G})")
        if _mix_kind(name, cfg) == "rglru":
            return rglru_unlayout(p[-1], parts)
        if p[-2] == "mix":
            return ssd_unlayout(p[-1], parts, cfg, lay)
    if len(parts) == G != tp:
        # every model rank's: keep the first of each tp rank's
        by_tp = {}
        for g, part in enumerate(parts):
            by_tp.setdefault(lay.tp_rank(_row_rank(lay, g)), part)
        parts = [by_tp[k] for k in range(tp)]
    if len(parts) != tp:
        raise ValueError(f"{name}: {len(parts)} shards for tp={tp}")
    if name in ("embed.table", "lm_head.w"):
        dim = 0 if name == "embed.table" else 1
        return torch.cat(list(parts), dim).narrow(dim, 0, cfg.vocab_size)
    if p[-2] in ("attn", "cross") and p[-1] in _HEADS:
        from repro_torch.models.attention import get_plan, kv_exp_slots
        plan = get_plan(cfg, lay)
        axis = 0 if p[-1] == "wo" else (1 if p[-1][0] == "w" else 0)
        full = torch.cat(list(parts), axis)
        if _HEADS[p[-1]] == "q":
            slots, h = plan.q_slot_to_orig, cfg.num_heads
            place = list(slots)
            n = len(slots)
        else:
            # expanded slot e holds padded slot e // r (repeat_interleave)
            n = kv_exp_slots(plan, lay)
            r = n // plan.h_kv_pad
            place = [plan.kv_slot_to_orig[e // r] for e in range(n)]
            h = cfg.num_kv_heads
        canon = _canon_shape(p[-1], full, n, cfg)
        first = [place.index(i) for i in range(h)]
        out = canon.index_select(canon.dim() - 2, torch.as_tensor(
            first, device=canon.device))
        return out.reshape(-1, cfg.d_model) if p[-1] == "wo" else \
            out.reshape(out.shape[0], -1) if p[-1][0] == "w" else \
            out.reshape(-1)
    if p[-2] in ("ffn", "shared") and p[-1] in ("wi", "wg", "wo"):
        return torch.cat(list(parts), 0 if p[-1] == "wo" else 1)
    if _mix_kind(name, cfg) == "rglru":
        return rglru_unlayout(p[-1], parts)
    if p[-2] == "mix":
        return ssd_unlayout(p[-1], parts, cfg, lay)
    return parts[0]


def unshard_state(shards, cfg, lay) -> Dict[str, np.ndarray]:
    """The inverse of ``shard_state``: the trivial layout's state from
    ``shards``, one state per tp rank of ``lay`` in tp rank order (on a
    base config with sp > 1 the sp ranks of one tp rank hold the same
    shard: pass one of them), or one per model rank in model-rank order,
    which a state with MoE expert stacks or SSD layers needs. Bitwise: ``shard_state`` of
    the result on ``lay`` gives each shard back."""
    return {name: unshard_tensor(name, [torch.from_numpy(
                np.ascontiguousarray(s[name])) for s in shards], cfg, lay)
            .contiguous().numpy() for name in shards[0]}


def _tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor; bfloat16 (a numpy extension type)
    goes through its bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def from_jax_cache(tree, cfg, paged: bool) -> Dict[str, torch.Tensor]:
    """The reference's cache tree of a ``Model`` on the trivial layout, as
    nested dicts of numpy arrays, as the port's cache tensors by name (the
    ``cache`` entry of ``ShiftEngine.snapshot``):

    * paged (``init_paged_cache``): ``body.s0.k``/``v`` ``[L, num_blocks,
      bs, kv_slots, Dh]``, the layers stacked on axis 0 as the port's
      ``PagedPool`` stacks them, -> ``k``/``v``;
    * dense (``init_cache``): attention ``body.s0.k``/``v`` ``[L, B,
      s_max, kv_slots, Dh]`` -> ``k``/``v``, SSD ``body.s0.ssm``/
      ``conv_x``/``conv_bc`` -> the ``DenseCache`` fields of those names,
      a decoder stack's ``body.s0.self.k``/``v`` -> ``k``/``v`` and
      ``body.s0.cross.k``/``v`` [L, B, S_enc, kv_slots, Dh] ->
      ``cross_k``/``cross_v``.

    Only a stack of one repeated block kind converts, as for the
    parameters."""
    if tree.get("prefix") or tree.get("suffix") \
            or set(tree.get("body", {})) != {"s0"} \
            or len(cfg.layer_pattern) != 1:
        raise ValueError("only a stack of one repeated block converts")
    body = dict(_flatten(tree["body"]["s0"]))
    kind = cfg.layer_pattern[0]
    want = ({"k": "k", "v": "v"} if paged or kind in ("attn", "moe") else
            {"self.k": "k", "self.v": "v", "cross.k": "cross_k",
             "cross.v": "cross_v"} if kind == "dec" else
            {n: n for n in ("ssm", "conv_x", "conv_bc")})
    if set(body) != set(want):
        raise ValueError(f"cache leaves {sorted(body)}, want {list(want)} "
                         f"for a {'paged' if paged else 'dense'} "
                         f"{kind} stack")
    out = {}
    for name, field in want.items():
        a = body[name]
        if a.shape[0] != cfg.num_layers:
            raise ValueError(f"body.s0.{name}: {a.shape[0]} stacked layers, "
                             f"config has {cfg.num_layers}")
        out[field] = _tensor(a)
    return out


def gather_dense_cache(caches, cfg, lay) -> Dict[str, np.ndarray]:
    """The reference's global dense cache arrays (``init_cache``'s leaves,
    its ``cache_specs`` undone) from ``caches``, every rank's dense cache
    tensors by name (``ShiftEngine._cache_tensors()`` or the fields of a
    ``DenseCache``), in process-rank order over the world of ``lay``. The
    batch axis takes the dp rows in order; the head axis of ``k``/``v``
    [L, B, s_max, kv_slots, Dh], of a decoder layer's cross cache
    ``cross_k``/``cross_v`` [L, B, S_enc, kv_slots, Dh], of a local
    layer's ring ``ring_k``/
    ``ring_v`` [L, B, rows, kv_slots, Dh] and of ``ssm`` [L, B, H, hd,
    ds], and the channels of ``conv_x`` [L, B, cw-1, H·hd] and of an
    RG-LRU layer's ``h`` [L, B, w] and ``conv`` [L, B, cw-1, w] take the
    model ranks in model-rank order (the reference's
    ``head_spec_entry``); ``conv_bc``
    [L, B, cw-1, 2·ds], whole on every rank of a row, comes from each
    row's first rank; an MLA latent ``lat`` [L, B, s_max/cache_sp, C]
    takes the grid's sp ranks in order along the sequence (the ranks of
    tp rank 0; the others hold the same chunks)."""
    G, dp = max(lay.G, 1), max(lay.dp, 1)
    if len(caches) != G * dp:
        raise ValueError(f"{len(caches)} ranks' caches for a world of "
                         f"{G * dp}")

    def arr(t):
        return t.detach().cpu().float().numpy() if isinstance(
            t, torch.Tensor) else np.asarray(t)

    axis = {"k": 3, "v": 3, "ring_k": 3, "ring_v": 3, "ssm": 2, "conv_x": 3,
            "h": 2, "conv": 3, "cross_k": 3, "cross_v": 3}
    out = {}
    for name in caches[0]:
        rows = []
        for d in range(dp):
            row = [caches[d * G + m] for m in range(G)]
            if name == "conv_bc":
                rows.append(arr(row[0][name]))
                continue
            if name == "lat":
                sp, tp = lay.grid
                rows.append(np.concatenate([arr(row[i * tp][name])
                                            for i in range(sp)], axis=2))
                continue
            by_model = sorted(range(G),
                              key=lambda m: lay.model_rank(d * G + m))
            rows.append(np.concatenate([arr(row[m][name]) for m in by_model],
                                       axis=axis[name]))
        out[name] = np.concatenate(rows, axis=1)
    return out
