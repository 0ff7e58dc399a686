"""Attention-head layout planner (numpy only; the port's copy of
``repro.parallel.heads``).

Pads query heads so they divide the model-group degree G = SP·TP, pads KV
heads up to a divisor (or multiple) of G, and keeps GQA group alignment:
the q-head slots a rank receives map to the kv-head slots that same rank
receives. On the trivial layout (G = 1) the plan is the identity: no pad
slots and no replication.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _smallest_divisor_geq(n: int, x: int) -> int:
    for d in range(x, n + 1):
        if n % d == 0:
            return d
    return n


@dataclass(frozen=True)
class HeadPlan:
    G: int                      # model-group degree (SP*TP)
    tp: int                     # weight-column shard degree (base config)
    h_q: int
    h_kv: int
    h_q_pad: int                # multiple of G
    h_kv_pad: int               # divisor of G (if < G) else multiple of G
    repl: int                   # kv replication factor G / h_kv_pad
    q_per_rank: int             # query head slots per device
    kv_per_rank: int            # kv head slots per device
    q_per_kv_pad: int           # padded GQA group size
    q_slot_to_orig: Tuple[int, ...]   # padded q slot -> original head (-1 = pad)
    kv_slot_to_orig: Tuple[int, ...]  # padded kv slot -> original head (-1 = pad)

    @property
    def kv_slots_total(self) -> int:
        """Global kv slot count incl. replication: the head extent of the
        KV pool."""
        return self.G * self.kv_per_rank

    @property
    def h_kv_exp_base(self) -> int:
        """KV slots materialized in the base config's weights: replication
        is applied only at the TP (weight) level; the SP-level replication
        happens in the all-to-all's send buffer."""
        return max(self.h_kv_pad, self.tp)

    @property
    def h_kv_exp_shift(self) -> int:
        """KV slots materialized in the shift config's weights (TP = G)."""
        return self.kv_slots_total

    def q_mask(self) -> np.ndarray:
        """[h_q_pad] 1.0 for real head slots, 0.0 for padding."""
        return (np.asarray(self.q_slot_to_orig) >= 0).astype(np.float32)

    def kv_expand_map(self, n_slots: int) -> np.ndarray:
        """Map from ``n_slots`` expanded slots back to padded kv slots
        (``slot // (n_slots // h_kv_pad)``)."""
        r = n_slots // self.h_kv_pad
        return np.arange(n_slots) // r

    def a2a_send_map(self, sp: int) -> np.ndarray:
        """[tp, sp * kv_per_rank]: for base-config tp rank j, the local
        indices (into its ``h_kv_exp_base / tp`` weight slots) of the kv
        slots to place in the all-to-all's send buffer, so that sp rank i
        receives the kv slots aligned with its q slots (the paper's
        replication within the send buffers)."""
        tp = self.G // sp
        exp = max(self.h_kv_pad, tp)          # slots materialized in weights
        per_tp = exp // tp                    # local kv slots per tp rank
        w2p = self.kv_expand_map(exp)         # expanded slot -> padded slot
        out = np.zeros((tp, sp * self.kv_per_rank), dtype=np.int32)
        for j in range(tp):
            local = [w2p[j * per_tp + c] for c in range(per_tp)]
            for i in range(sp):
                g = j * sp + i                # model rank (tp-major)
                for c in range(self.kv_per_rank):
                    want = ((g * self.kv_per_rank + c) * self.h_kv_pad
                            // self.kv_slots_total)
                    out[j, i * self.kv_per_rank + c] = local.index(want)
        return out


def plan_heads(h_q: int, h_kv: int, G: int, tp: int = 1) -> HeadPlan:
    if h_q % h_kv:
        raise ValueError(f"GQA requires h_kv | h_q, got {h_q}/{h_kv}")
    q_per_kv = h_q // h_kv
    if h_kv >= G:
        h_kv_pad = _round_up(h_kv, G)
        kv_per_rank = h_kv_pad // G
        repl = 1
        q_per_kv_pad = q_per_kv
        h_q_pad = h_kv_pad * q_per_kv_pad
        q_per_rank = h_q_pad // G
    else:
        h_kv_pad = _smallest_divisor_geq(G, h_kv)
        repl = G // h_kv_pad
        kv_per_rank = 1
        q_per_rank = math.ceil(h_q / G)
        q_per_kv_pad = q_per_rank * repl
        h_q_pad = h_kv_pad * q_per_kv_pad
    q_map = [k * q_per_kv + j if (k < h_kv and j < q_per_kv) else -1
             for k in range(h_kv_pad) for j in range(q_per_kv_pad)]
    kv_map = [k if k < h_kv else -1 for k in range(h_kv_pad)]
    return HeadPlan(
        G=G, tp=tp, h_q=h_q, h_kv=h_kv, h_q_pad=h_q_pad, h_kv_pad=h_kv_pad,
        repl=repl, q_per_rank=q_per_rank, kv_per_rank=kv_per_rank,
        q_per_kv_pad=q_per_kv_pad,
        q_slot_to_orig=tuple(q_map), kv_slot_to_orig=tuple(kv_map),
    )
