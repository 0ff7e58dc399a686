"""Convert the reference's parameter tree to the port's state.

``from_jax_params`` takes the tree of a ``repro`` ``Model`` built on the
trivial ``Layout()``, as nested dicts of numpy arrays (``jax.tree.map(
np.asarray, params)``, done by the caller), and returns ``{name: array}``
for ``Model.load_params``; ``shard_state`` cuts that state into one rank's
shard of a wider layout. It imports neither jax nor repro.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.attention import attn_layout
from repro_torch.models.layers import shard_of, vocab_shard


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + ".")
        else:
            yield name, np.asarray(v)


def from_jax_params(tree, cfg) -> Dict[str, np.ndarray]:
    """* ``body.s0.*`` (stacked over layers on axis 0) -> ``layers.{i}.*``,
      for an attention block (``ln1``, ``attn``, ``ln2``, ``ffn``) and for
      an SSD block (``ln1``, ``mix``) alike;
    * ``embed.table`` [G, v_loc, d] -> [G*v_loc, d];
    * ``lm_head.w`` [G, d, v_loc] -> [d, G*v_loc] (a tied tree has none:
      the port's tied head reads the table);
    * everything else keeps its dotted name.
    Only a stack of one repeated block kind, without prefix or suffix
    layers, converts. The SSD mixer's ``wbc`` must be the trivial layout's
    single group, [d, 2·d_state]; a tree built for TP replicates it and
    raises."""
    if tree.get("prefix") or tree.get("suffix") \
            or set(tree.get("body", {})) != {"s0"} \
            or len(cfg.layer_pattern) != 1:
        raise ValueError("only a stack of one repeated block converts")
    out = {}
    for name, a in _flatten(tree):
        if name.startswith("body.s0."):
            if a.shape[0] != cfg.num_layers:
                raise ValueError(f"{name}: {a.shape[0]} stacked layers, "
                                 f"config has {cfg.num_layers}")
            rest = name[len("body.s0."):]
            if rest == "mix.wbc" and a.shape[1:] != (cfg.d_model,
                                                     2 * cfg.ssm.d_state):
                raise ValueError(
                    f"{name}: shape {a.shape[1:]}, want the trivial layout's "
                    f"[{cfg.d_model}, {2 * cfg.ssm.d_state}] (kexp 1)")
            for i in range(cfg.num_layers):
                out[f"layers.{i}.{rest}"] = a[i]
        elif name == "embed.table":
            out[name] = a.reshape(-1, a.shape[-1])
        elif name == "lm_head.w":
            out[name] = a.transpose(1, 0, 2).reshape(a.shape[1], -1)
        else:
            out[name] = a
    return out


def shard_state(state, cfg, lay, rank: int) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s shard of every parameter of ``state``, the trivial
    layout's (``from_jax_params``), on layout ``lay``, placed as the
    reference's specs place it: the attention's q/k/v columns and its O
    rows over TP after the head plan's padding and KV replication
    (``attn_specs``), the MLP's ``wi``/``wg`` columns and ``wo`` rows over
    TP, the embedding's rows and the LM head's columns over TP, ``G/tp``
    shards of ``ceil(V/G)`` each (``embed_specs``, ``lmhead_specs``), and
    the norm scales whole. On a layout with dp rows the rank gets the
    shard of its grid position ``(i, j)``, the same in every row (the
    reference replicates the parameters over ``"data"``). Attention and MLP
    weights only: SSD layers run only the trivial layout."""
    k, tp = lay.tp_rank(rank), max(lay.tp, 1)
    d, dh = cfg.d_model, cfg.head_dim
    heads = {"wq": cfg.num_heads, "bq": cfg.num_heads, "wo": cfg.num_heads,
             "wk": cfg.num_kv_heads, "wv": cfg.num_kv_heads,
             "bk": cfg.num_kv_heads, "bv": cfg.num_kv_heads}
    out = {}
    for name, a in state.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        parts = name.split(".")
        if name == "embed.table":
            t = vocab_shard(t, 0, lay, k)
        elif name == "lm_head.w":
            t = vocab_shard(t, 1, lay, k)
        elif parts[-2] == "attn" and parts[-1] in heads:
            h = heads[parts[-1]]
            canon = (t.reshape(h, dh * d) if parts[-1] == "wo" else
                     t.reshape(d, h, dh) if parts[-1][0] == "w" else
                     t.reshape(h, dh))
            t = attn_layout(parts[-1], canon, cfg, lay, k)
        elif parts[-2] == "ffn":
            t = shard_of(t, 0 if parts[-1] == "wo" else 1, tp, k)
        elif parts[-2] == "mix" and lay.world > 1:
            raise NotImplementedError(f"{name}: SSD layers run only the "
                                      "trivial layout")
        out[name] = t.contiguous().numpy()
    return out
