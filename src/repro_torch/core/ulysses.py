"""Ulysses sequence parallelism for inference (counterpart of
``repro.core.ulysses``; paper §3.2, Algorithm 1).

The fused all-to-all: q, k and v, with their different head counts, travel
in ONE ``all_to_all_single`` per direction, and KV head slots are
replicated inside the send buffer when the model group is wider than the
KV heads (``expand_kv_for_send``).

Tensors are ``[B, S_loc, H_tp, C]`` before the scatter (this rank's
sequence columns, its tp rank's heads) and ``[B, S_full, H_rank, C]`` after
(every column, this rank's heads). ``all_to_all_single`` splits and fills
axis 0, so each direction packs its tensors into one buffer with the
destination rank leading, ``[n, B, S, K]``, and unpacks the received
buffer, whose leading axis is the source rank. A call copies each tensor
twice: once into the send buffer (one ``torch.cat``) and once out of the
received one (one ``contiguous`` per tensor), so every result is
contiguous, as the CUDA kernels require.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.parallel import HeadPlan
from repro_torch.parallel.collectives import Group, all_to_all


def expand_kv_for_send(kv, plan: HeadPlan, sp: int, tp_rank: int):
    """Replicate KV head slots inside the send buffer (paper §3.2.1).
    kv: [B, S_loc, n_loc, C], this tp rank's kv slots (``n_loc =
    h_kv_exp_base / tp``). Returns ``[B, S_loc, sp*kv_per_rank, C]``,
    arranged so that after the scatter sp rank ``i`` holds exactly the kv
    slots aligned with its q slots."""
    idx = torch.as_tensor(plan.a2a_send_map(sp)[tp_rank], device=kv.device,
                          dtype=torch.long)
    return kv.index_select(2, idx)


def ulysses_scatter_heads(ts: Sequence[torch.Tensor],
                          group: Optional[Group]) -> List[torch.Tensor]:
    """Sequence-sharded, heads per tp rank -> every column, heads split
    over the SP group: one fused all-to-all for the whole list. A no-op
    without an SP group (the shift config)."""
    if group is None:
        return list(ts)
    n = group.size
    metas, cols = [], []
    for t in ts:
        b, s, h, c = t.shape
        if h % n:
            raise ValueError(f"head dim {h} not divisible by sp {n}")
        # destination-major head chunks, destination leading
        cols.append(t.reshape(b, s, n, (h // n) * c).permute(2, 0, 1, 3))
        metas.append((h // n, c))
    out = all_to_all(torch.cat(cols, dim=-1), group)     # [n(src), B, S, K]
    b, s = out.shape[1:3]
    res, off = [], 0
    for hp, c in metas:
        # the source rank's columns come in source order
        part = out[..., off:off + hp * c].permute(1, 0, 2, 3).contiguous()
        res.append(part.view(b, n * s, hp, c))
        off += hp * c
    return res


def ulysses_gather_heads(ts: Sequence[torch.Tensor],
                         group: Optional[Group]) -> List[torch.Tensor]:
    """The inverse: every column, heads split -> this rank's columns, the
    tp rank's heads in global order."""
    if group is None:
        return list(ts)
    n = group.size
    metas, cols = [], []
    for t in ts:
        b, s, hp, c = t.shape
        if s % n:
            raise ValueError(f"seq {s} not divisible by sp {n}")
        # destination-major sequence chunks, destination leading
        cols.append(t.reshape(b, n, s // n, hp * c).permute(1, 0, 2, 3))
        metas.append((hp, c))
    out = all_to_all(torch.cat(cols, dim=-1), group)     # [n(src), B, S/n, K]
    b, s_loc = out.shape[1:3]
    res, off = [], 0
    for hp, c in metas:
        # heads in global order: the source rank's block, then its heads
        part = out[..., off:off + hp * c].reshape(n, b, s_loc, hp, c)
        res.append(part.permute(1, 2, 0, 3, 4).contiguous()
                   .view(b, s_loc, n * hp, c))
        off += hp * c
    return res
