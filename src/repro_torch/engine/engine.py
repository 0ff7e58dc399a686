"""Shift-parallelism serving engine, mixed paged path (counterpart of
``repro.engine.engine.ShiftEngine`` with one data-parallel row).

Sequences map to fixed-size blocks of one shared physical pool through a
block table (``repro_torch.cache``). Each iteration packs up to
``prefill_chunk`` prompt tokens per prefilling row plus every ready decode
row into ONE forward pass, after the shift policy has picked the config
from the batched token count (paper Algorithm 2). On one card both
configs are the trivial layout and run the same program; the engine still
makes and counts the choice, as the reference does. Admission holds a
request in the queue until its prompt fits in the free blocks, and block
exhaustion preempts the least-recently scheduled request back to the queue
(recompute), which bounds memory while guaranteeing progress.

Not in this slice: prefix caching, speculative decoding, fault injection,
observability, dp rows and reshard.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from repro_torch.cache import PagedKVCache, blocks_for_tokens, pow2_bucket
from repro_torch.core.policy import DEFAULT_SHIFT_THRESHOLD, ThresholdPolicy
from repro_torch.models.model import Model
from .request import FinishReason, Request


class EngineConfig:
    def __init__(self, max_slots: int = 8, s_max: int = 256,
                 prefill_chunk: int = 64,
                 threshold: int = DEFAULT_SHIFT_THRESHOLD,
                 eos_id: int = -1, block_size: int = 16,
                 # physical blocks incl. the null block; 0 = auto-size so
                 # max_slots x s_max fits
                 num_blocks: int = 0):
        self.max_slots = max_slots
        self.s_max = s_max
        self.prefill_chunk = prefill_chunk
        self.threshold = threshold
        self.eos_id = eos_id
        self.block_size = block_size
        self.num_blocks = num_blocks


class ShiftEngine:
    def __init__(self, model: Model, cfg: Optional[EngineConfig] = None):
        self.model = model
        self.mcfg = model.cfg
        self.cfg = cfg = cfg or EngineConfig()
        self.policy = ThresholdPolicy(cfg.threshold)
        nmax = blocks_for_tokens(cfg.s_max, cfg.block_size)
        num_blocks = cfg.num_blocks or cfg.max_slots * nmax + 1
        self.kv = PagedKVCache(num_blocks, cfg.block_size, cfg.max_slots, nmax)
        model.init_paged_cache(num_blocks, cfg.block_size)
        # persistent host mirror of the block tables; only rows the
        # PagedKVCache marks dirty are re-copied
        self._bt_host = np.zeros((cfg.max_slots, nmax), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * cfg.max_slots
        # every unfinished request, admitted or not, in arrival order
        self.queue: List[Request] = []
        self.step_count = 0
        self.preemptions = 0
        self.config_counts = {"base": 0, "shift": 0}

    # ---------------------------------------------------------------- admin
    def submit(self, req: Request) -> int:
        """Queue ``req``; raises if it can never be served."""
        worst = len(req.prompt) + req.max_new_tokens
        if worst > self.cfg.s_max:
            raise ValueError(f"request {req.rid} exceeds s_max={self.cfg.s_max}")
        need = blocks_for_tokens(worst, self.cfg.block_size)
        if need > self.kv.num_blocks - 1:
            raise ValueError(
                f"request {req.rid} can never fit: needs {need} blocks, the "
                f"pool has {self.kv.num_blocks - 1}")
        self.queue.append(req)
        return req.rid

    @property
    def active(self) -> List[Request]:
        return [r for r in self.slot_req if r is not None]

    def _admit(self):
        """Assign free slots FCFS. A request is admitted only when its whole
        (re)prompt plus one decode token fits in the free blocks."""
        for req in list(self.queue):
            if req.slot is not None:
                continue
            slot = next((s for s, owner in enumerate(self.slot_req)
                         if owner is None), None)
            if slot is None or not self.kv.can_allocate(req.total_tokens + 1):
                break                       # FCFS
            if not self.kv.ensure(slot, req.total_tokens + 1):
                break
            req.slot = slot
            self.slot_req[slot] = req

    # ----------------------------------------------------- memory pressure
    def _preempt(self, victim: Request):
        """Evict a running request back to the queue, freeing its blocks.
        Recompute-style: its prompt+generated re-prefills on re-admission."""
        self.kv.free_seq(victim.slot)
        self.slot_req[victim.slot] = None
        victim.slot = None
        victim.prefilled = 0
        victim.num_preemptions += 1
        self.preemptions += 1

    def _reserve(self, req: Request, n_tokens: int, protect) -> bool:
        """Grow req's block table to cover n_tokens, LRU-preempting other
        active requests outside ``protect`` while the free list runs dry.
        Returns False when nothing can be evicted."""
        while not self.kv.ensure(req.slot, n_tokens):
            victims = [a for a in self.active
                       if a is not req and a not in protect]
            if not victims:
                return False
            self._preempt(min(victims,
                              key=lambda a: (a.last_used, -a.arrival)))
        return True

    # ---------------------------------------------------------------- steps
    def _choose(self, n_tokens: int, n_prefill: int) -> str:
        """The config of this iteration (Algorithm 2)."""
        return "base" if self.policy.use_base(n_tokens, n_prefill) \
            else "shift"

    def _prefill_done(self, r: Request) -> bool:
        return r.prefilled >= r.pos

    def _finish_token(self, r: Request, tok: int, t: float):
        """Append a sampled token and retire the request if it is done."""
        r.generated.append(tok)
        # the forward wrote this step's input tokens through position
        # r.pos-1, so the cache covers everything before the new last token
        r.prefilled = r.pos
        if r.first_token_time is None:
            r.first_token_time = t
        if r.done or (self.cfg.eos_id >= 0
                      and r.generated[-1] == self.cfg.eos_id):
            r.finish_time = t
            r.finish_reason = FinishReason.OK
            self.kv.free_seq(r.slot)
            self.slot_req[r.slot] = None
            self.queue = [q for q in self.queue if q is not r]

    def _refresh_block_tables(self):
        for s in self.kv.take_dirty():
            self._bt_host[s] = self.kv.table[s]

    def _run_mixed(self) -> bool:
        """One fused iteration: every ready decode row PLUS a prefill chunk
        for every row still swallowing its (re)prompt, in a single forward
        pass. Decode rows reserve blocks first, so a prompt burst can
        shrink the prefill side but never starve in-flight decodes. A
        prefill row whose chunk reaches its last known token samples its
        next token in the same pass."""
        C = self.cfg.prefill_chunk
        ready = [r for r in self.active if self._prefill_done(r)
                 and not r.done]
        rows = []                          # (req, off, q_len, produces)
        protect = set()
        for r in ready:
            if r.slot is None:
                continue                   # preempted by an earlier reserve
            # coverage for the token written this step (position r.pos)
            if self._reserve(r, r.total_tokens, protect):
                rows.append((r, r.pos, 1, True))
                protect.add(r)
        n_decode = len(rows)
        n_prefill_tok = 0
        for r in list(self.active):
            if r.slot is None or r.done or self._prefill_done(r):
                continue
            off = r.prefilled
            end = min(off + C, r.total_tokens)
            if end <= off or not self._reserve(r, end, protect):
                continue
            rows.append((r, off, end - off, end == r.total_tokens))
            protect.add(r)
            n_prefill_tok += end - off
        if not rows:
            return False

        mode = self._choose(n_prefill_tok + n_decode, n_prefill_tok)
        self.config_counts[mode] += 1
        # compact to active rows and bucket every axis to a power of two,
        # as the reference does for its compiled-shape reuse
        Rb = pow2_bucket(len(rows))
        Cb = pow2_bucket(max(ql for _, _, ql, _ in rows))
        self._refresh_block_tables()
        # slice the table batch to the occupied prefix: attention work
        # scales with actual cache occupancy, not s_max
        nb = max(int(max(self.kv.n_mapped[r.slot] for r, _, _, _ in rows)), 1)
        nbb = min(pow2_bucket(nb), self.kv.max_blocks_per_seq)
        toks = np.zeros((Rb, Cb), np.int32)
        qlen = np.zeros((Rb,), np.int32)
        offs = np.zeros((Rb,), np.int32)
        bt = np.zeros((Rb, nbb), np.int32)
        for i, (r, off, ql, _) in enumerate(rows):
            if ql == 1 and off == r.pos:       # decode row: the last token
                toks[i, 0] = r.generated[-1] if r.generated else r.prompt[-1]
            else:
                toks[i, :ql] = r.all_tokens()[off:off + ql]
            qlen[i] = ql
            offs[i] = off
            bt[i] = self._bt_host[r.slot, :nbb]
        nxt, _ = self.model.forward_mixed(toks, qlen, offs, bt)
        nxt = nxt.cpu().numpy()
        t = time.monotonic()
        for i, (r, off, ql, produces) in enumerate(rows):
            r.last_used = self.step_count
            r.prefilled = off + ql
            if produces:
                self._finish_token(r, int(nxt[i]), t)
        return True

    def step(self) -> bool:
        """One engine iteration. Returns False when idle."""
        self._admit()
        progressed = self._run_mixed()
        self.step_count += 1
        return progressed

    def run_until_idle(self, max_steps: int = 10000):
        for _ in range(max_steps):
            if not self.step():
                if not self.queue and not self.active:
                    break
        return self
