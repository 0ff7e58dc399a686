"""Convert the reference's parameter tree to the port's state.

``from_jax_params`` takes the tree of a ``repro`` ``Model`` built on the
trivial ``Layout()``, as nested dicts of numpy arrays (``jax.tree.map(
np.asarray, params)``, done by the caller), and returns ``{name: array}``
for ``Model.load_params``. It imports neither jax nor repro.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


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
