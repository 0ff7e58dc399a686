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
    """* ``body.s0.*`` (stacked over layers on axis 0) -> ``layers.{i}.*``;
    * ``embed.table`` [G, v_loc, d] -> [G*v_loc, d];
    * ``lm_head.w`` [G, d, v_loc] -> [d, G*v_loc];
    * everything else keeps its dotted name.
    Only the dense single-pattern stack of the port's configs converts."""
    if tree.get("prefix") or tree.get("suffix") \
            or set(tree.get("body", {})) != {"s0"}:
        raise ValueError("only a stack of one repeated 'attn' block converts")
    out = {}
    for name, a in _flatten(tree):
        if name.startswith("body.s0."):
            if a.shape[0] != cfg.num_layers:
                raise ValueError(f"{name}: {a.shape[0]} stacked layers, "
                                 f"config has {cfg.num_layers}")
            rest = name[len("body.s0."):]
            for i in range(cfg.num_layers):
                out[f"layers.{i}.{rest}"] = a[i]
        elif name == "embed.table":
            out[name] = a.reshape(-1, a.shape[-1])
        elif name == "lm_head.w":
            out[name] = a.transpose(1, 0, 2).reshape(a.shape[1], -1)
        else:
            out[name] = a
    return out
