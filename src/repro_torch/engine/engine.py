"""Shift-parallelism serving engine (counterpart of
``repro.engine.engine.ShiftEngine`` with one data-parallel row).

Two iterations, as in the reference. The **mixed** one (the default with
the paged cache) packs up to ``prefill_chunk`` prompt tokens per
prefilling row plus every ready decode row into ONE forward pass. The
**serialized** one (``mixed=False``) runs a chunked-prefill step over the
full ``max_slots`` batch while any row still swallows its prompt, and a
decode step otherwise. The shift policy picks the config of each step from
its batched token count (paper Algorithm 2), and that config's entry of
the ``Deployment``'s step table runs the step: on the card a CUDA graph
captured once per bucketed shape and replayed, on the CPU (and above world
size 1) the eager step. On the trivial layout both configs share one
program, but the engine still makes and counts the choice, as the
reference does. Given a ``shift`` model (the base model's layout
``to_shift()``), the configs are two programs over one paged pool: the
shift model adopts the base model's pool.

Above world size 1 the engine is SPMD: every rank runs the same engine on
the same requests, one process per rank, and the greedy token is
all-gathered over TP, so every rank takes the same scheduling decisions.
Such an engine runs the mixed paged iteration only.

KV lives in one of two caches. The paged pool (``paged``, the default
for configs whose layers all page)
maps sequences to fixed-size blocks through a block table
(``repro_torch.cache``): admission holds a request in the queue until its
prompt fits in the free blocks, and block exhaustion preempts the
least-recently scheduled request back to the queue (recompute), which
bounds memory while guaranteeing progress. The dense contiguous cache
(``paged=False``, and the automatic fallback for mamba2, whose SSD layers
keep recurrent state per slot) gives each slot a ``[s_max]`` row; it
serves only the serialized iteration and admits FCFS by free slot.

As in the reference, a serialized step always runs all ``max_slots``
rows, and nothing resets a slot's SSD state on admission: the dummy rows
of slots outside the step (zero tokens) and the zero padding after a
short last chunk advance that state. Streams of an SSD model therefore
depend on what else is in flight; the port copies this behaviour so that
its streams equal the reference's.

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
from .deployment import Deployment
from .request import FinishReason, Request


class EngineConfig:
    def __init__(self, max_slots: int = 8, s_max: int = 256,
                 prefill_chunk: int = 64,
                 threshold: int = DEFAULT_SHIFT_THRESHOLD,
                 eos_id: int = -1, block_size: int = 16,
                 # physical blocks incl. the null block; 0 = auto-size so
                 # max_slots x s_max fits
                 num_blocks: int = 0,
                 # None = auto: paged when every layer pages, and mixed
                 # when paged
                 paged: Optional[bool] = None,
                 mixed: Optional[bool] = None):
        self.max_slots = max_slots
        self.s_max = s_max
        self.prefill_chunk = prefill_chunk
        self.threshold = threshold
        self.eos_id = eos_id
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.paged = paged
        self.mixed = mixed


class ShiftEngine:
    def __init__(self, model: Model, cfg: Optional[EngineConfig] = None,
                 shift: Optional[Model] = None):
        self.model = model
        self.mcfg = model.cfg
        self.cfg = cfg = cfg or EngineConfig()
        self.policy = ThresholdPolicy(cfg.threshold)
        # paging needs every layer to page (an SSD layer keeps recurrent
        # state per sequence); one card has one dp row, so that is the
        # only architectural reason. Auto falls back to the dense cache,
        # a forced paged=True raises; the reason is kept, as the reference
        # keeps it, because the dense cache also rules out the mixed
        # iteration
        reason = None
        if not model.supports_paged:
            reason = (f"architecture {self.mcfg.name} has non-pageable layer "
                      "kinds (MLA latents / ring buffers / recurrent state "
                      "keep the contiguous cache)")
        if cfg.paged and reason is not None:
            raise ValueError(f"config {self.mcfg.name} cannot use a paged KV "
                             f"cache: {reason}")
        self.paged = reason is None if cfg.paged is None else cfg.paged
        if not self.paged and reason is None:
            reason = "paged=False in EngineConfig"
        self.paged_disabled_reason = None if self.paged else reason
        self.mixed = self.paged if cfg.mixed is None else cfg.mixed
        if self.mixed and not self.paged:
            raise ValueError(
                "mixed-batch stepping requires the paged KV cache (ragged "
                "rows scatter through the block table's null block)")
        if model.lay.world > 1 and not self.mixed:
            raise NotImplementedError(
                f"{model.lay.describe()}: above world size 1 the engine runs "
                "the mixed paged iteration only (ROADMAP Queue 1 item 2)")
        if self.paged:
            nmax = blocks_for_tokens(cfg.s_max, cfg.block_size)
            num_blocks = cfg.num_blocks or cfg.max_slots * nmax + 1
            self.kv = PagedKVCache(num_blocks, cfg.block_size, cfg.max_slots,
                                   nmax)
            model.init_paged_cache(num_blocks, cfg.block_size)
            if shift is not None:
                shift.adopt_paged_cache(model)
            # persistent host mirror of the block tables; only rows the
            # PagedKVCache marks dirty are re-copied
            self._bt_host = np.zeros((cfg.max_slots, nmax), np.int32)
        else:
            self.kv = None
            model.init_cache(cfg.max_slots, cfg.s_max)
        # per-slot cache length: positions already written
        self.lens = np.zeros((cfg.max_slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * cfg.max_slots
        # every unfinished request, admitted or not, in arrival order
        self.queue: List[Request] = []
        self.step_count = 0
        self.preemptions = 0
        self.config_counts = {"base": 0, "shift": 0}
        # the base and shift views and their step tables, built over the
        # caches initialised above
        self.deploy = Deployment.build(model, shift or model,
                                       mixed=self.mixed, paged=self.paged)

    # ------------------------------------------- deployment (read-through)
    @property
    def base(self) -> Model:
        return self.deploy.base

    @property
    def shift(self) -> Model:
        return self.deploy.shift

    @property
    def dp(self) -> int:
        return self.deploy.dp

    # ---------------------------------------------------------------- admin
    def submit(self, req: Request) -> int:
        """Queue ``req``; raises if it can never be served."""
        worst = len(req.prompt) + req.max_new_tokens
        if worst > self.cfg.s_max:
            raise ValueError(f"request {req.rid} exceeds s_max={self.cfg.s_max}")
        need = blocks_for_tokens(worst, self.cfg.block_size)
        if self.paged and need > self.kv.num_blocks - 1:
            raise ValueError(
                f"request {req.rid} can never fit: needs {need} blocks, the "
                f"pool has {self.kv.num_blocks - 1}")
        self.queue.append(req)
        return req.rid

    @property
    def active(self) -> List[Request]:
        return [r for r in self.slot_req if r is not None]

    def _admit(self):
        """Assign free slots FCFS. Paged: a request is admitted only when
        its whole (re)prompt plus one decode token fits in the free
        blocks."""
        for req in list(self.queue):
            if req.slot is not None:
                continue
            slot = next((s for s, owner in enumerate(self.slot_req)
                         if owner is None), None)
            if slot is None:
                break                       # FCFS
            if self.paged and not (self.kv.can_allocate(req.total_tokens + 1)
                                   and self.kv.ensure(slot,
                                                      req.total_tokens + 1)):
                break
            req.slot = slot
            self.slot_req[slot] = req
            self.lens[slot] = req.prefilled

    # ----------------------------------------------------- memory pressure
    def _preempt(self, victim: Request):
        """Evict a running request back to the queue, freeing its blocks.
        Recompute-style: its prompt+generated re-prefills on re-admission."""
        self.kv.free_seq(victim.slot)
        self.slot_req[victim.slot] = None
        self.lens[victim.slot] = 0
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
        self.lens[r.slot] = r.pos
        if r.done or (self.cfg.eos_id >= 0
                      and r.generated[-1] == self.cfg.eos_id):
            r.finish_time = t
            r.finish_reason = FinishReason.OK
            if self.paged:
                self.kv.free_seq(r.slot)
            self.slot_req[r.slot] = None
            self.queue = [q for q in self.queue if q is not r]

    def _refresh_block_tables(self):
        for s in self.kv.take_dirty():
            self._bt_host[s] = self.kv.table[s]

    def _block_tables(self, rows: List[Request]) -> np.ndarray:
        """Block-table batch of the serialized path: all ``max_slots`` rows
        at the full ``nmax``; rows outside this batch stay all-null so their
        (garbage) writes land in the null block."""
        self._refresh_block_tables()
        bt = np.zeros((self.cfg.max_slots, self.kv.max_blocks_per_seq),
                      np.int32)
        idx = [r.slot for r in rows]
        bt[idx] = self._bt_host[idx]
        return bt

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
        # as the reference does for its compiled-shape reuse; the chunk
        # axis splits over the chosen config's SP degree (a decode-only
        # batch on the base config is [R, sp])
        Rb = pow2_bucket(len(rows))
        Cb = max(pow2_bucket(max(ql for _, _, ql, _ in rows)),
                 (self.base if mode == "base" else self.shift).lay.sp)
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
        nxt = self.deploy.forward_at(mode)(toks, qlen, offs, bt).cpu().numpy()
        t = time.monotonic()
        for i, (r, off, ql, produces) in enumerate(rows):
            r.last_used = self.step_count
            r.prefilled = off + ql
            if produces:
                self._finish_token(r, int(nxt[i]), t)
        return True

    # --------------------------------------------------- serialized stepping
    def _run_prefill(self) -> bool:
        """One chunked-prefill step over the slots that still need their
        (re)prompt, batched at the full ``max_slots``; the last known token
        of each row is left for the decode step. Dummy rows sit at offset
        ``s_max - C`` on the dense cache (their writes must not land on
        live positions) and at 0 on the paged pool (their all-null tables
        route the writes to the null block, and a zero context keeps the
        ragged kernel from walking null blocks)."""
        C = self.cfg.prefill_chunk
        todo = [r for r in self.active if not self._prefill_done(r)]
        if not todo:
            return False
        toks = np.zeros((self.cfg.max_slots, C), np.int32)
        offs = np.full((self.cfg.max_slots,),
                       0 if self.paged else max(self.cfg.s_max - C, 0),
                       np.int32)
        rows = []                          # (req, chunk length)
        for r in todo:
            if r.slot is None:
                continue                   # preempted by an earlier reserve
            off = r.prefilled
            seq = r.all_tokens()
            chunk = seq[off:min(off + C, len(seq) - 1)]
            if not chunk:
                continue
            if self.paged and not self._reserve(
                    r, off + len(chunk), protect={rr for rr, _ in rows}):
                continue
            toks[r.slot, :len(chunk)] = chunk
            offs[r.slot] = off
            rows.append((r, len(chunk)))
        if not rows:
            return False
        n_tok = sum(n for _, n in rows)
        mode = self._choose(n_tok, n_tok)
        self.config_counts[mode] += 1
        bt = self._block_tables([r for r, _ in rows]) if self.paged else None
        self.deploy.prefill[mode](toks, offs, bt)
        for r, n in rows:
            r.prefilled += n
            r.last_used = self.step_count
            self.lens[r.slot] = r.prefilled
        return True

    def _run_decode(self) -> bool:
        """One decode step over every ready row, batched at the full
        ``max_slots``; each writes its last known token at ``r.pos``."""
        ready = [r for r in self.active
                 if self._prefill_done(r) and not r.done]
        if self.paged:
            kept = []
            for r in ready:
                if r.slot is None:
                    continue               # preempted by an earlier reserve
                # coverage for the token written this step (position r.pos)
                if self._reserve(r, r.total_tokens, protect=set(kept)):
                    kept.append(r)
            ready = kept
        if not ready:
            return False
        mode = self._choose(len(ready), 0)
        self.config_counts[mode] += 1
        toks = np.zeros((self.cfg.max_slots,), np.int32)
        lens = np.zeros((self.cfg.max_slots,), np.int32)
        for r in ready:
            toks[r.slot] = r.generated[-1] if r.generated else r.prompt[-1]
            lens[r.slot] = r.pos           # write position of this token
        bt = self._block_tables(ready) if self.paged else None
        nxt = self.deploy.decode[mode](toks, lens, bt).cpu().numpy()
        t = time.monotonic()
        for r in ready:
            r.last_used = self.step_count
            r.prefilled = r.pos + 1        # this step wrote position r.pos
            self._finish_token(r, int(nxt[r.slot]), t)
        return True

    def step(self) -> bool:
        """One engine iteration. Returns False when idle."""
        self._admit()
        if self.mixed:
            # fused prefill+decode batch: no iteration-granularity
            # interference between a prompt burst and in-flight decodes
            progressed = self._run_mixed()
        else:
            # prefill first, chunk by chunk; decode otherwise
            progressed = self._run_prefill() or self._run_decode()
        self.step_count += 1
        return progressed

    def run_until_idle(self, max_steps: int = 10000):
        for _ in range(max_steps):
            if not self.step():
                if not self.queue and not self.active:
                    break
        return self
