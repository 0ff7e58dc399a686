"""Int8 gradient compression with error feedback for the DP all-reduce
(counterpart of ``repro.training.compress``).

The cross-replica gradient reduction quantizes to int8 with one shared
per-tensor scale (a single ``pmax``) before the sum and dequantizes after;
the quantized values are summed as int32, so the sum dequantizes exactly.
The quantization residual is carried in an error-feedback buffer so that
the compression bias vanishes over steps (Karimireddy et al., "Error
Feedback Fixes SignSGD"). Rounding is half to even, as ``jnp.round``'s.
Cuts DP gradient traffic 4x against fp32 (the int32 sum here is the
reference's ``psum`` of int32 too)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.parallel.collectives import Group, pmax_if, psum_if


def int8_compress_psum(g, err, group: Optional[Group],
                       named: Optional[bool] = None):
    """g: the local gradient; err: the error-feedback buffer (g's shape,
    fp32); ``group`` the (dp, sp) group, None for a group of one rank.
    ``named`` says whether the reference's ``axes`` are named (by default,
    whether there is a group): on a mesh they are, whatever their size,
    and the reference quantizes even where its psum over them is the
    identity ((dp, sp) = (1, 1) on a mesh); on its trivial layout they are
    empty and g passes through in fp32, err as it is. Returns (the reduced
    gradient in fp32, the new err). ``g`` and ``err`` may be lists of the
    parts of one reference leaf (the layers its body stacks into one
    array): the parts then share one scale, the max over all of them, as
    the reference's one tensor does, and lists come back."""
    if named is None:
        named = group is not None
    if not isinstance(g, (list, tuple)):
        out, new_err = int8_compress_psum([g], [err], group, named)
        return out[0], new_err[0]
    if not named:
        return [t.float() for t in g], list(err)
    gf = [t.float() + e for t, e in zip(g, err)]
    amax = pmax_if(torch.stack([t.abs().max() for t in gf]).max(), group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    outs, errs = [], []
    for t in gf:
        q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
        errs.append(t - q.float() * scale)
        outs.append(psum_if(q.to(torch.int32), group).float() * scale)
    return outs, errs


def plain_psum(g, err, group: Optional[Group]):
    """The uncompressed reduction: g in fp32 summed over ``group``."""
    if group is None:
        return g.float(), err
    return psum_if(g.float(), group), err
