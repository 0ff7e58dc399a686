"""Exactly-once token delivery across crash recovery (the port's copy of
``repro.ft.recovery``, pure Python).

An engine crash loses everything after the last durable snapshot; a
``recover()`` replays from that snapshot and *regenerates* the lost
suffix. The tokens generated between the snapshot and the crash were
already streamed to clients, so the delivery layer — not the engine —
owns exactly-once semantics: :class:`DeliveryLog` keeps a per-request
cursor of tokens already handed out and only releases the new suffix,
while asserting that the replayed prefix is bit-identical to what was
delivered (greedy decoding from identical state makes it so; a mismatch
means the recovery path corrupted engine state and must fail loudly
rather than stream divergent tokens)."""
from __future__ import annotations

from typing import Dict, Iterable, List


class ReplayDivergence(Exception):
    """Replayed tokens disagree with tokens already delivered — the
    recovery produced a different stream than the original run."""


class DeliveryLog:
    def __init__(self):
        self.streams: Dict[int, List[int]] = {}

    def poll(self, requests: Iterable) -> Dict[int, List[int]]:
        """Release each request's undelivered suffix. The already-delivered
        prefix must match ``generated`` bit-for-bit (replay check); returns
        {rid: newly delivered tokens} for rids with new tokens. A suffix
        may be SEVERAL tokens even between adjacent polls: a speculative
        verify step delivers 1 + accepted tokens per row, so nothing here
        (or in any consumer) may assume one sampled token per step."""
        out: Dict[int, List[int]] = {}
        for r in requests:
            stream = self.streams.setdefault(r.rid, [])
            gen = list(r.generated)
            # after recompute-preemption or a post-snapshot replay the
            # engine may hold FEWER tokens than were delivered; the
            # overlap that does exist must agree exactly
            n = min(len(stream), len(gen))
            if stream[:n] != gen[:n]:
                raise ReplayDivergence(
                    f"rid {r.rid}: delivered {stream[:n]} != replayed "
                    f"{gen[:n]}")
            if len(gen) > len(stream):
                new = gen[len(stream):]
                stream.extend(new)
                out[r.rid] = new
        return out

    def delivered(self, rid: int) -> List[int]:
        return list(self.streams.get(rid, []))
