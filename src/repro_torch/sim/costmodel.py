"""Roofline-based per-iteration cost model for the serving simulator and
the adaptive shift policy (the port's copy of ``repro.sim.costmodel``).

The same three terms as §Roofline (compute / HBM / interconnect), evaluated
per engine iteration for a given parallelism strategy. It prices at the
H100 data sheet's constants (``roofline.H100``) unless given other
hardware; with the paper's H200 constants it reproduces the paper's
latency/throughput comparisons.

Strategies over an N-chip group:
  dp    — N independent replicas (full weights each, no collectives)
  tp    — weights and attention split N ways; 2 all-reduces per layer
  sp    — Ulysses: sequence split N ways; fused a2a per layer (1/N volume)
  shift — per-iteration argmin(tp, sp)   (paper Algorithm 2)
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.cache import pow2_bucket as _pow2
from repro_torch.roofline.terms import H100, Hardware


@dataclass(frozen=True)
class Strategy:
    kind: str          # dp | tp | sp | shift
    n: int = 8         # chips in the group


@dataclass
class CostModel:
    cfg: object                       # ModelConfig
    hw: Hardware = H100
    # model parameters with the reference's values, not measurements on a
    # card: engine/runtime overhead per iteration, and the fractions of
    # peak FLOP/s, HBM bandwidth and interconnect bandwidth a step achieves
    overhead_s: float = 0.004
    mfu: float = 0.6
    bw_eff: float = 0.8
    ici_eff: float = 0.7
    # attention pricing. True (the shipped engine): the ragged paged kernel
    # streams each row's ACTUAL context, so attention compute + KV reads
    # scale with the batch's summed occupancy. False prices the retired
    # materialized-gather path for A/B: every row pays the pow2-bucketed
    # MAX context (the engine's sliced table width), and the gather's
    # materialize-then-attend doubles the KV bytes moved.
    attn_work_prop: bool = True
    GATHER_COPY_FACTOR = 2.0          # gather writes + re-reads the padded view

    # ------------------------------------------------------------ primitives
    def _flops(self, n_tokens: int, ctx: int) -> float:
        c = self.cfg
        f = 2.0 * c.active_params() * n_tokens
        # attention reads the KV context
        n_attn = sum(1 for k in c.layer_kinds if k in
                     ("attn", "moe", "dec", "enc"))
        n_loc = sum(1 for k in c.layer_kinds if k == "local")
        dh = c.head_dim
        f += 4.0 * n_tokens * ctx * c.num_heads * dh * n_attn
        f += 4.0 * n_tokens * min(ctx, c.local_window or ctx) \
            * c.num_heads * dh * n_loc
        return f

    def _weight_bytes(self) -> float:
        return 2.0 * self.cfg.active_params()

    def _kv_bytes_per_tok(self) -> float:
        c = self.cfg
        if c.mla is not None:
            per = c.mla.cache_dim
        else:
            per = 2 * c.num_kv_heads * c.head_dim
        n_cached = sum(1 for k in c.layer_kinds
                       if k in ("attn", "local", "moe", "dec"))
        return 2.0 * per * n_cached

    def kv_bytes_per_block(self, block_size: int = 16) -> float:
        """HBM bytes one paged KV block commits across all cached layers.
        The paged engine allocates at this granularity; partially filled
        tail blocks are the fragmentation the simulator charges.

        With prefix caching a multi-ref (shared) block commits these bytes
        ONCE no matter how many sequences map it — the simulator charges
        shared blocks through the per-replica resident set, and the saved
        prefill work shows up as fewer ``n_prefill`` tokens in
        ``iteration_time`` (a prefix hit shrinks the compute term, not the
        model: cached tokens are simply never batched)."""
        return self._kv_bytes_per_tok() * block_size

    def _comm_bytes(self, n_tokens: int, strat: Strategy) -> float:
        """Per-device collective bytes for one iteration (paper Table 2)."""
        c = self.cfg
        n = strat.n
        L = c.num_layers
        d = c.d_model
        tok_bytes = n_tokens * d * 2
        if strat.kind == "dp" or n == 1:
            return 0.0
        if strat.kind == "tp":
            # 2 ring all-reduces per layer over the full activations
            return L * 2 * 2 * tok_bytes * (n - 1) / n
        if strat.kind == "sp":
            # fused qkv a2a + inverse: each device exchanges its local shard
            return L * 2 * (tok_bytes / n) * (n - 1) / n * \
                (1 + 2 * c.num_kv_heads / max(c.num_heads, 1))
        raise ValueError(strat.kind)

    # ------------------------------------------------------------ iterations
    COLL_LATENCY = 5e-6               # per-collective launch/hop latency

    def attn_ctx_eff(self, ctx: int, ctx_lens=None) -> float:
        """Effective per-row context the attention path touches, given the
        ACTUAL per-row context lengths of the iteration (``ctx_lens``).

        Work-proportional (the ragged kernel): a row costs its own context
        — the effective mean is ``sum(ctx_lens) / rows``. Gather pricing:
        every row is materialized (and its scores computed) to the
        pow2-bucketed MAX context — the engine sliced the table batch to
        one shared bucket — the O(B·S_max) curve the kernel retires.
        Without ``ctx_lens`` the caller's mean ``ctx`` stands in (and
        gather pricing buckets it). This is a CONTEXT LENGTH: it scales
        attention FLOPs and KV reads alike; the gather's extra
        write+re-read of the materialized view is bytes only and is
        applied separately (``_attn_copy_factor``)."""
        if ctx_lens:
            rows = len(ctx_lens)
            if self.attn_work_prop:
                return sum(ctx_lens) / rows
            return float(_pow2(max(ctx_lens)))
        return float(ctx) if self.attn_work_prop else float(_pow2(int(ctx)))

    @property
    def _attn_copy_factor(self) -> float:
        """HBM-bytes multiplier for the gather's materialize-then-attend
        (the padded view is written and re-read); 1.0 on the kernel path.
        Applies to memory traffic only — never to FLOPs."""
        return 1.0 if self.attn_work_prop else self.GATHER_COPY_FACTOR

    def iteration_time(self, n_prefill: int, n_decode: int, ctx: int,
                       strat: Strategy, *, ctx_lens=None,
                       n_spec: int = 0) -> float:
        """One engine iteration with n_prefill chunk tokens + n_decode
        decode tokens against average context ctx. A call with both terms
        nonzero prices a *mixed* batch (the engine's fused
        prefill+decode pass): the weights stream from HBM once for the
        combined batch and the collectives run once, which is exactly the
        advantage the mixed schedule has over running the same tokens as
        two serialized iterations.

        ``ctx_lens`` (optional) are the batch rows' ACTUAL context
        lengths; with them the attention terms price what the
        work-proportional kernel really touches (see ``attn_ctx_eff``) —
        the sum of occupancies, not rows × S_max. ``ctx`` remains the
        coarse fallback for callers that only know a mean.

        The strategy asymmetries follow the paper (Tables 1-2):
          tp — weights sharded n ways; all-reduce on the critical path
          sp — tokens sharded n ways but weights REPLICATED (DP-like decode:
               every rank streams the full weights); a2a volume ~1/n of TP;
               small batches pad to a multiple of n (§3.2.1)
          dp — per-replica: no sharding at all.

        ``n_spec`` of the decode tokens are speculative draft queries
        (verify-in-one-pass): they pay weight-side compute and comms like
        any token but SHARE their row's KV read — the attention kernel
        streams each row's context once regardless of how many query
        tokens ride it. This is the verify-vs-decode asymmetry the
        acceptance-aware shift policy prices."""
        n = strat.n
        tokens = n_prefill + n_decode
        if tokens == 0:
            return 0.0
        if strat.kind == "dp":
            tok_shard, w_shard = 1, 1
        elif strat.kind == "sp":
            tokens = -(-tokens // n) * n          # load-balance padding
            tok_shard, w_shard = n, 1             # weights replicated!
        else:                                     # tp
            tok_shard, w_shard = n, n

        ctx_eff = self.attn_ctx_eff(ctx, ctx_lens)
        f = self._flops(n_prefill, ctx_eff) + self._flops(n_decode, ctx_eff)
        t_c = f / tok_shard / (self.hw.peak_flops * self.mfu)
        per_dev_tokens = max(tokens / tok_shard, 1)
        util = min(1.0, per_dev_tokens / 128.0) ** 0.25

        # weights stream once per iteration; KV cache sharded by heads
        # (invariant layout) in both tp and sp -> /n
        kv_shard = 1 if strat.kind == "dp" else n
        w = self._weight_bytes() / w_shard
        # draft queries share their row's context read: KV streams once
        # per decode ROW (n_decode - n_spec), not once per query token
        kv_rows = max(n_decode - n_spec, 0)
        kv_read = self._kv_bytes_per_tok() * ctx_eff * self._attn_copy_factor \
            / kv_shard * (kv_rows + 0.5 * (1 if n_prefill else 0))
        t_m = (w + kv_read) / (self.hw.hbm_bw * self.bw_eff)

        x = self._comm_bytes(tokens, strat)
        t_x = x / (self.hw.ici_bw * self.ici_eff)
        n_coll = 0 if strat.kind == "dp" or n == 1 else 2 * self.cfg.num_layers
        t_x += n_coll * self.COLL_LATENCY
        # collectives sit on the critical path between layers (not
        # overlapped) — the paper's TP throughput penalty
        return max(t_c / util, t_m) + t_x + self.overhead_s

    def verify_speedup(self, k: int, accepted: float, ctx: int,
                       strat: Strategy, *, ctx_lens=None) -> float:
        """Modeled delivered-token throughput of a k-draft verify row over
        plain one-token decode, given the observed mean accepted drafts
        per row (0 <= accepted <= k). Each verify iteration delivers
        ``1 + accepted`` tokens and costs one (1 + k)-query pass whose k
        draft queries share the row's KV read; the ratio > 1 means
        speculation pays at this context/strategy, < 1 means the extra
        verify compute outruns the iterations it saves — the
        verify-vs-decode price the ROADMAP's acceptance-aware policy
        item calls for."""
        if k <= 0:
            return 1.0
        t_plain = self.iteration_time(0, 1, ctx, strat, ctx_lens=ctx_lens)
        t_verify = self.iteration_time(0, 1 + k, ctx, strat,
                                       ctx_lens=ctx_lens, n_spec=k)
        return (1.0 + min(max(accepted, 0.0), k)) * t_plain / t_verify

    def attn_hbm_bytes(self, ctx_lens) -> float:
        """Modeled KV bytes one forward pass reads for the given per-row
        contexts under the configured attention pricing — the deterministic
        number the ``attn.work_prop_*`` benchmarks gate on."""
        if not ctx_lens:
            return 0.0
        per_row = self.attn_ctx_eff(0, ctx_lens) * self._attn_copy_factor
        return self._kv_bytes_per_tok() * per_row * len(ctx_lens)

    def best_config(self, n_prefill: int, n_decode: int, ctx: int, n: int,
                    ctx_lens=None, n_spec: int = 0):
        """Shift decision = argmin over {sp, tp} (AdaptivePolicy)."""
        t_sp = self.iteration_time(n_prefill, n_decode, ctx, Strategy("sp", n),
                                   ctx_lens=ctx_lens, n_spec=n_spec)
        t_tp = self.iteration_time(n_prefill, n_decode, ctx, Strategy("tp", n),
                                   ctx_lens=ctx_lens, n_spec=n_spec)
        return ("sp", t_sp) if t_sp <= t_tp else ("tp", t_tp)
