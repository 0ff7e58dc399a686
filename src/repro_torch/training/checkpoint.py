"""Checkpoint save and restore with reshard-on-load (counterpart of
``repro.training.checkpoint``).

Format: one ``arrays.npz`` of *global logical* arrays, the trivial
layout's (``convert.unshard_tensor`` of the shards of the ranks that
``convert.unshard_ranks`` names, the ZeRO-1 moment slices put together
first: a MoE layer's expert stacks from every model rank, a pod-scale
config's from every rank of the world), keyed ``params|{name}``, ``m|{name}``,
``v|{name}`` and ``err|{name}`` with the port's parameter names, and a
``manifest.json`` (step, extra, keys) committed by ``os.replace``. So a
checkpoint written on one (dp, sp, tp) layout restores on any other
(``convert.shard_state``): the mechanism behind elastic rescaling. A
leaf that every tp rank holds whole (a norm's scale, whose replicas drift
apart in training, as the reference's do) is saved from tp rank 0, the
copy the reference's ``device_get`` reads (its device 0). Of a kv head
that the layout replicates over model ranks, the first copy is saved
(``convert.unshard_tensor``)."""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import shard_state, unshard_ranks, unshard_tensor
from .optimizer import gather_moment, moment_slice, zero1_slice

_TREES = ("m", "v", "err")


def _local_state(model, opt_state):
    """This rank's full local tensors by tree, as fp32 numpy arrays: the
    parameters, each moment put together over dp, the error feedback."""
    lay, sh = model.lay, model.shard
    out = {"params": {}}
    for tree in _TREES:
        if opt_state is not None and tree in opt_state:
            out[tree] = {}
    for name, p in model.params.named_parameters():
        out["params"][name] = p.detach().float().cpu().numpy()
        zs = zero1_slice(name, p.shape, model.cfg, lay)
        for tree in ("m", "v"):
            if tree in out:
                part = opt_state[tree][name]
                full = gather_moment(name, None if part is None
                                     else part.float(), zs, p.shape, lay,
                                     sh.dp_group, p.device, torch.float32)
                out[tree][name] = full.cpu().numpy()
        if "err" in out:
            out["err"][name] = opt_state["err"][name].cpu().numpy()
    return out


def save_checkpoint(path: str, step: int, model, opt_state=None,
                    extra=None) -> str:
    """Write ``model``'s parameters (and ``opt_state``'s moments and error
    feedback) as global logical arrays. Every rank of the layout calls it;
    rank 0 writes. Returns ``path``."""
    local = _local_state(model, opt_state)
    lay, sh = model.lay, model.shard
    world = sh.groups.all_ranks() if sh.groups is not None else None
    if world is not None:
        states = [None] * world.size
        dist.all_gather_object(states, local, group=world.pg)
    else:
        states = [local]
    if sh.rank == 0:
        blobs = {}
        for tree in local:
            for name in local[tree]:
                parts = [torch.from_numpy(states[r][tree][name])
                         for r in unshard_ranks(name, model.cfg, lay)]
                blobs[f"{tree}|{name}"] = unshard_tensor(
                    name, parts, model.cfg, lay).contiguous().numpy()
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "arrays.npz"), **blobs)
        manifest = {"step": int(step), "extra": extra or {},
                    "keys": sorted(blobs)}
        tmp = os.path.join(path, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(path, "manifest.json"))  # atomic commit
    if world is not None:
        dist.barrier(group=world.pg)
    return path


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "manifest.json"))


def read_checkpoint(path: str):
    """The manifest and the global logical arrays of a checkpoint:
    (step, {tree: {name: array}}, extra)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    trees = {}
    for key in manifest["keys"]:
        tree, name = key.split("|", 1)
        trees.setdefault(tree, {})[name] = data[key]
    return manifest["step"], trees, manifest["extra"]


def load_state(model, trees: dict, step: int, state_dtype=torch.float32):
    """Load global logical arrays (``read_checkpoint``'s trees, or
    ``convert.from_jax_params``/``from_jax_opt_state`` of a reference
    checkpoint) into ``model`` on its layout: the parameters cut for this
    rank (``convert.shard_state``), and an optimizer state with this
    rank's ZeRO-1 moment slices (None when the trees hold no moments)."""
    lay, sh = model.lay, model.shard
    model.load_params(shard_state(trees["params"], model.cfg, lay, sh.rank))
    if "m" not in trees:
        return None
    opt = {"step": int(step)}
    for tree in _TREES:
        if tree not in trees:
            continue
        shards = shard_state(trees[tree], model.cfg, lay, sh.rank)
        opt[tree] = {}
        for name, p in model.params.named_parameters():
            t = torch.from_numpy(np.ascontiguousarray(shards[name])).to(
                device=p.device, dtype=torch.float32)
            if tree == "err":
                opt[tree][name] = t
                continue
            zs = zero1_slice(name, p.shape, model.cfg, lay)
            part = moment_slice(name, t, zs, lay, sh.dp_rank)
            opt[tree][name] = (None if part is None
                               else part.contiguous().to(state_dtype))
    return opt


def load_checkpoint(path: str, model, state_dtype=torch.float32):
    """Restore a checkpoint onto ``model``'s layout (any layout: the
    arrays are resharded on load). Returns (step, optimizer state or None,
    extra)."""
    step, trees, extra = read_checkpoint(path)
    return step, load_state(model, trees, step, state_dtype), extra
